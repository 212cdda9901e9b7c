"""Plain float32 references of the benchmark's model families, one file a
family (``<family>.py``, named by a configuration file's ``family``).

Each module gives ``layout(model)`` (the parameter leaves, their shapes,
dtypes and initialisers, under the names the port serves) and
``logits(model, params, tokens, keep, quant=None)``.  They import nothing
of the program.
"""
import importlib


def family(name: str):
    """The reference module of family ``name``."""
    return importlib.import_module(f"portbench.reference.{name}")
