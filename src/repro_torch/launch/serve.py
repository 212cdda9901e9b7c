"""Batched serving launcher: prefill + greedy decode with KV, MLA latent or
SSM caches, on a CUDA card (or the CPU, when asked).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-780m \
        --batch 8 --prompt-len 512 --gen 64
    PYTHONPATH=src python -m repro_torch.launch.serve --reduced \
        --device cpu

The flags are those of ``python -m repro.launch.serve``, plus ``--device``;
the default architecture is the JAX launcher's, ``mamba2-780m``.  As
there, the prompt is teacher-forced through the decode loop (one token
per step fills the caches ``lm.init_caches`` built: KV for attention
layers, the compressed latent for MLA layers, conv and state for SSM
layers), then ``--gen`` tokens are generated greedily, and the same line
is printed.  An enc-dec model first encodes ``--prompt-len`` frames of
seeded embeddings into the caches' ``enc_out``; the vision frontend's
model decodes from embeddings (its token's row of the embedding table).
Every registered architecture runs: ``mamba2-780m``, ``stablelm-12b``,
``smollm-360m``, ``mistral-nemo-12b``, ``qwen3-1.7b``,
``jamba-1.5-large-398b``, ``whisper-large-v3``, ``phi3.5-moe-42b-a6.6b``,
``deepseek-v3-671b`` and ``qwen2-vl-72b`` (the ones over ~30 B
parameters fit one card only ``--reduced``).  Weights are random, drawn
from seed 0; prompts from seed 1, encoder frames from seed 2.
"""
from __future__ import annotations

import argparse
import time
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.core.session import resolve_device
from repro_torch.models import layers, lm
from repro_torch.models.config import get_config
from repro_torch.models.testing import reduced as reduce_cfg
from repro_torch.train import step as step_lib


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="mamba2-780m")
    ap.add_argument("--reduced", action="store_true",
                    help="CPU-sized config of the same family")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduce_cfg(cfg)
    device = resolve_device(args.device)
    params = lm.init_params(
        cfg, torch.Generator(device=device).manual_seed(0))
    # the counterpart of the JAX launcher's jax.jit: a CUDA graph on the
    # card, the eager step on the CPU
    decode = step_lib.GraphedDecodeStep(cfg)

    b, plen = args.batch, args.prompt_len
    total = plen + args.gen
    prompts = torch.randint(0, cfg.vocab_size, (b, plen), dtype=torch.int32,
                            generator=torch.Generator().manual_seed(1)
                            ).to(device)
    caches = lm.init_caches(cfg, b, total, device=device,
                            enc_seq=plen if cfg.enc_dec else 0)
    if cfg.enc_dec:
        enc = torch.randn((b, plen, cfg.d_model),
                          generator=torch.Generator().manual_seed(2))
        with torch.no_grad():
            caches["enc_out"] = lm.encode(cfg, params, {"enc_embeds": enc})

    # prefill via decode loop (teacher-forcing the prompt)
    t0 = time.monotonic()
    tok = prompts[:, :1]
    out_tokens = [tok]
    for t in range(total - 1):
        batch = {"tokens": tok, "index": t}
        if cfg.frontend == "vision":
            batch = {"embeds": layers.embed_lookup(params["embed"],
                                                   tok[:, 0])[:, None, :],
                     "index": t}
        nxt, caches = decode(params, caches, batch)
        tok = prompts[:, t + 1:t + 2] if t + 1 < plen else nxt
        out_tokens.append(tok)
    gen = torch.cat(out_tokens, dim=1).cpu()
    dt = time.monotonic() - t0
    print(f"arch={cfg.name} batch={b} generated {args.gen} tokens/seq "
          f"in {dt:.2f}s ({b*total/dt:.1f} tok/s incl prefill)")
    print("sample:", np.asarray(gen[0, plen:plen + 12]))


if __name__ == "__main__":
    main()
