"""The one generator of the benchmark's traffic: a notebook user who
prompts a batch, generates, looks, undoes and regenerates.

A mix file (``mixes/<traffic>.json``) gives ``batch`` sequences of
``prompt`` tokens, ``gen`` greedy tokens a generation, the ``store`` the
session commits to (``memory`` or ``sqlite``), how many window cycles the
correctness check replays (``check_cycles``) and how many a traced run
profiles (``trace_cycles``).  Everything else comes from the seed: the
weights, the prompts, a new flavor each cycle (a shift of the fed tokens,
so no two cycles write the same chunks) and the cycles the check draws.
Every seed gets the same sizes; only values differ.
"""
from __future__ import annotations

import hashlib
from dataclasses import dataclass
from typing import List

import torch

MIX_KEYS = {"batch", "prompt", "gen", "store", "check_cycles",
            "trace_cycles"}
STORES = ("memory", "sqlite")
MAX_CYCLES = 4096


def sub_seed(seed: int, tag: str) -> int:
    """A 63-bit seed for one use of the run's seed."""
    h = hashlib.sha256(f"{int(seed)}:{tag}".encode()).digest()
    return int.from_bytes(h[:8], "little") >> 1


def check_mix(mix: dict) -> dict:
    if set(mix) != MIX_KEYS:
        raise ValueError(f"mix keys {sorted(mix)}, want {sorted(MIX_KEYS)}")
    if mix["store"] not in STORES:
        raise ValueError(f"store {mix['store']!r} not in {STORES}")
    for k in MIX_KEYS - {"store"}:
        if not isinstance(mix[k], int) or mix[k] < 1:
            raise ValueError(f"{k} must be a positive whole number")
    return mix


@dataclass
class Traffic:
    prompts: torch.Tensor            # [batch, prompt] int32 on the device
    flavors: List[int]               # one a cycle, all different


def make(mix: dict, vocab: int, seed: int, device) -> Traffic:
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed,
                                                              "prompts"))
    prompts = torch.randint(0, vocab, (mix["batch"], mix["prompt"]),
                            dtype=torch.int32, device=device, generator=gen)
    g = torch.Generator().manual_seed(sub_seed(seed, "flavors"))
    n = min(MAX_CYCLES, vocab - 1)
    flavors = (torch.randperm(vocab - 1, generator=g)[:n] + 1).tolist()
    return Traffic(prompts, flavors)


def check_sample(n_cycles: int, k: int, seed: int) -> List[int]:
    """The window cycles the correctness check replays: ``k`` of
    ``n_cycles`` drawn from the seed (all where there are fewer)."""
    g = torch.Generator().manual_seed(sub_seed(seed, "check"))
    return sorted(torch.randperm(n_cycles, generator=g)[:k].tolist())
