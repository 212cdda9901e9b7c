"""Bytes the store took during the window (chunks and metadata, counted
by ``portbench.store.CountingStore``) over the cells committed, in MB."""


def read(run):
    return run.stored_bytes / len(run.cycles) / 1e6
