"""The comparison that decides ``correct``: the tokens the window served,
replayed through the plain float32 reference.

For each sampled cycle the reference reads the prompt and the tokens the
program fed (the prefix's last token and each generated token, shifted by
the cycle's flavor) and gives its logits at every served position: the
prefix's last token and the cycle's generated tokens.  A served token's
gap is how far its reference logit lies below the reference's best; the
widest gap is compared.  The control puts the reference computed from
float8 e4m3 operands in the program's place and reads the gap of the
token it ranks first.
"""
from __future__ import annotations

from typing import List, Tuple

import torch

from portbench.reference.common import strict_float32


def fed_tokens(prompts: torch.Tensor, last: torch.Tensor,
               cycles: List[Tuple[int, torch.Tensor]], vocab: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(the token sequences the program read [n*B, P+G], the tokens it
    served at their last G+1 positions [n*B, G+1])."""
    seqs, served = [], []
    for flavor, gen in cycles:
        fed = torch.cat([last, gen[:, :-1]], dim=1).long()
        seqs.append(torch.cat([prompts.long(), (fed + flavor) % vocab], 1))
        served.append(torch.cat([last, gen], dim=1).long())
    return torch.cat(seqs), torch.cat(served)


def _ref_logits(ref, model, params, seqs, keep, quant=None, rows=16):
    strict_float32()
    with torch.no_grad():
        return torch.cat([ref.logits(model, params, seqs[i:i + rows], keep,
                                     quant)
                          for i in range(0, seqs.shape[0], rows)])


def served_gap(ref, model: dict, params: dict, prompts: torch.Tensor,
               last: torch.Tensor, cycles: List[Tuple[int, torch.Tensor]]
               ) -> float:
    """The widest gap of a served token below the reference's best."""
    seqs, served = fed_tokens(prompts, last, cycles, model["vocab_size"])
    lg = _ref_logits(ref, model, params, seqs, served.shape[1])
    gap = lg.amax(-1) - lg.gather(-1, served[..., None])[..., 0]
    return float(gap.max())


def control_gap(ref, model: dict, params: dict, prompts: torch.Tensor,
                last: torch.Tensor, cycles: List[Tuple[int, torch.Tensor]],
                quant: str = "fp8") -> float:
    """The widest gap, below the float32 reference's best, of the token
    that the ``quant`` reference ranks first, at the served positions."""
    seqs, served = fed_tokens(prompts, last, cycles, model["vocab_size"])
    keep = served.shape[1]
    lg = _ref_logits(ref, model, params, seqs, keep)
    lq = _ref_logits(ref, model, params, seqs, keep, quant)
    ctl = lg.amax(-1) - lg.gather(-1, lq.argmax(-1)[..., None])[..., 0]
    return float(ctl.max())
