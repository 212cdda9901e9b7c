"""The port's ``granite-4.0-h-small`` on the CPU: a hybrid stack of Mamba-2
and NoPE GQA layers with an MoE (and a shared expert) on every layer, and
Granite's four multipliers.

A tiny copy keeps the published period (five Mamba-2 layers, one attention
layer, four Mamba-2), NoPE, the multipliers, the shared expert's two
experts' width and a dropless capacity factor (experts / top-k), at
float32 and seeded weights (``portbench.weights`` drawing the benchmark's
own layout).  The port is held to the benchmark's plain reference
(``portbench/reference/granite_hybrid.py``): the full forward, and the
decode step through the caches, teacher-forced over the prompt and the
generated positions alike, as the benchmark's prefill is.

Tolerances: the logits of the tiny model are a few 1e-3 in size (the
layout's embedding std is 0.002 and the logits are divided by 16), so
they are compared relative to their largest magnitude, at 1e-4 of it: the
port and the reference sum their float32 products in different orders
(the chunked SSD against the token-by-token recurrence, the capacity
dispatch against one expert at a time), which leaves under 1e-6 of it.
"""
import dataclasses
import json
import math
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench import weights  # noqa: E402
from portbench.reference import granite_hybrid as ref  # noqa: E402
from portbench.reference.common import strict_float32  # noqa: E402

from repro_torch.models import lm, moe  # noqa: E402
from repro_torch.models.config import (PORT_ONLY_FIELDS,  # noqa: E402
                                       ArchConfig, MoEConfig, SSMConfig,
                                       get_config)
from repro_torch.models.testing import reduced  # noqa: E402

ARCH = "granite-4.0-h-small"
B, PROMPT, GEN = 2, 8, 8
REL = 1e-4


def _tiny() -> ArchConfig:
    return reduced(get_config(ARCH), n_layers=10).replace(
        moe=MoEConfig(n_experts=8, top_k=3, d_ff_expert=32,
                      n_shared_experts=2, capacity_factor=8 / 3))


def _model(cfg: ArchConfig) -> dict:
    return json.loads(json.dumps(dataclasses.asdict(cfg)))


def _setup(seed=2**31 + 5):
    cfg = _tiny()
    m = _model(cfg)
    params = weights.make(ref.layout(m), seed, "cpu")
    toks = torch.randint(0, cfg.vocab_size, (B, PROMPT + GEN),
                         generator=torch.Generator().manual_seed(seed))
    strict_float32()
    with torch.no_grad():
        want = ref.logits(m, params, toks, PROMPT + GEN)
    return cfg, params, toks, want


def _close(got, want):
    got = got[..., :want.shape[-1]]
    scale = want.abs().max()
    assert scale > 1e-4            # the logits are not all but zero
    err = (got - want).abs().max()
    assert err <= REL * scale, (float(err), float(scale))


def test_forward_matches_the_reference():
    cfg, params, toks, want = _setup()
    with torch.no_grad():
        got = lm.forward(cfg, params, {"tokens": toks.int()})
    _close(got, want)


def test_decode_through_the_caches_matches_the_reference():
    cfg, params, toks, want = _setup(2**31 + 9)
    caches = lm.init_caches(cfg, B, PROMPT + GEN, device="cpu")
    got = []
    with torch.no_grad():
        for t in range(PROMPT + GEN):
            lg, caches = lm.decode_step(cfg, params, caches,
                                        {"tokens": toks[:, t:t + 1].int(),
                                         "index": t})
            got.append(lg)
    _close(torch.cat(got, dim=1), want)
    kv = caches["stages"]["stage_0"]["sub_5"]["attn"]
    assert kv["index"].tolist() == [PROMPT + GEN]          # one unit
    assert set(caches["stages"]["stage_0"]["sub_0"]) == {"ssm"}


def test_the_multipliers_change_what_they_scale():
    """Each of the four, set back to neutral, changes the logits: none is
    dropped on the way."""
    cfg, params, toks, want = _setup()
    with torch.no_grad():
        for k, v in PORT_ONLY_FIELDS.items():
            got = lm.forward(cfg.replace(**{k: v}), params,
                             {"tokens": toks.int()})[..., :cfg.vocab_size]
            assert (got - want).abs().max() > 10 * REL * want.abs().max(), k


def test_replace_takes_json_values():
    cfg = get_config("smollm-360m").replace(
        moe={"n_experts": 4, "top_k": 2}, ssm={"d_state": 16},
        mla={"kv_lora_rank": 8}, hybrid_pattern=["attn", "ssm"],
        mrope_sections=[2, 3, 3])
    assert cfg.moe == MoEConfig(n_experts=4, top_k=2)
    assert cfg.ssm == SSMConfig(d_state=16)
    assert cfg.mla.kv_lora_rank == 8
    assert cfg.hybrid_pattern == ("attn", "ssm")
    assert cfg.mrope_sections == (2, 3, 3)
    # dataclasses and tuples pass through as they are
    assert cfg.replace(moe=cfg.moe, hybrid_pattern=("ssm",)).hybrid_pattern \
        == ("ssm",)


def test_registered_config_is_the_benchmarks_file():
    f = json.loads((ROOT / "portbench" / "configs" / f"{ARCH}.json")
                   .read_text())
    cfg = get_config(ARCH)
    assert cfg.replace(**f["model"]) == cfg
    assert f["reduced"] == []
    assert cfg.param_counts() == {"total": 32_206_734_336,
                                  "active": 8_802_518_016}
    assert cfg.layer_kinds.count("attn") == 4
    assert [i for i, k in enumerate(cfg.layer_kinds) if k == "attn"] == \
        [5, 15, 25, 35]
    # the published config beside the program's numbers
    assert (f["hidden_size"], f["num_hidden_layers"], f["num_local_experts"],
            f["num_experts_per_tok"], f["shared_intermediate_size"]) == \
        (cfg.d_model, cfg.n_layers, cfg.moe.n_experts, cfg.moe.top_k,
         cfg.moe.d_ff_expert * cfg.moe.n_shared_experts)
    assert (f["embedding_multiplier"], f["attention_multiplier"],
            f["residual_multiplier"], f["logits_scaling"]) == \
        (cfg.embedding_multiplier, cfg.attention_multiplier,
         cfg.residual_multiplier, cfg.logits_scaling)
    assert [{"mamba": "ssm", "attention": "attn"}[k]
            for k in f["layer_types"]] == list(cfg.layer_kinds)


@pytest.mark.parametrize("tokens", [1, 8, 13, 8 * 512])
def test_no_assignment_drops_at_the_published_capacity(tokens):
    m = get_config(ARCH).moe
    cap = moe.capacity(tokens, m)
    assert cap >= tokens           # an expert takes each token at most once
    g = torch.Generator().manual_seed(tokens)
    top_e = torch.stack([torch.randperm(m.n_experts, generator=g)[:m.top_k]
                         for _ in range(tokens)]).int()
    # the worst case too: every token picks the same ten experts
    for routing in (top_e, top_e[:1].expand(tokens, -1)):
        _, valid = moe.dispatch_indices(routing, m.n_experts, cap)
        assert bool(valid.all())


class _Ops(torch.overrides.TorchFunctionMode):
    """The names of the torch functions a call runs, in order."""

    def __init__(self):
        super().__init__()
        self.names = []

    def __torch_function__(self, func, types, args=(), kwargs=None):
        self.names.append(getattr(func, "__name__", str(func)))
        return func(*args, **(kwargs or {}))


def _ops(cfg, params, caches=None):
    toks = torch.zeros((1, 4), dtype=torch.int32)
    with torch.no_grad(), _Ops() as ops:
        if caches is None:
            lm.forward(cfg, params, {"tokens": toks})
        else:
            lm.decode_step(cfg, params, caches,
                           {"tokens": toks[:, :1], "index": 0})
    return ops.names


@pytest.mark.parametrize("decode", [False, True])
def test_neutral_multipliers_add_no_operation(decode):
    """At the neutral defaults an existing architecture runs exactly the
    operations it ran; set, the multipliers add one embedding scale, one
    scale a residual branch and one logits division, and the softmax
    scale changes no operation."""
    cfg = reduced(get_config("smollm-360m"))
    params = lm.init_params(cfg, torch.Generator().manual_seed(0))

    def run(c):
        caches = lm.init_caches(c, 1, 4, device="cpu") if decode else None
        return _ops(c, params, caches)
    run(cfg)                       # fills the step's caches (a RoPE table)
    base = run(cfg)
    scaled = run(cfg.replace(embedding_multiplier=2.0,
                             residual_multiplier=0.5, logits_scaling=4.0))
    assert len(scaled) == len(base) + 1 + 2 * cfg.n_layers + 1
    assert run(cfg.replace(attention_multiplier=1 / math.sqrt(16))) == base
