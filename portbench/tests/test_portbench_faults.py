"""A run with the timed path broken underneath must come out not
correct; a sound run correct.  The harness's look for a card is skipped:
the rest of a run is driven on the CPU at a tiny size of each family,
with the tiny cell's own limit."""
import pytest
import torch

import pb_env

from portbench import harness

FAMILIES = ("llama", "mamba2")


def _run(family, **faults):
    spec = pb_env.tiny_spec(family)
    return harness.run_cell(spec, 2**31 + 77, 0.5, False, device="cpu",
                            **faults)


def _generating(batch, prompt=16):
    return int(batch["index"]) >= prompt


def unchanged_state(step):
    """A step that leaves its caches as they were (it decodes on a copy)."""
    def faulty(params, caches, batch):
        if _generating(batch):
            from repro_torch.optim.adamw import tree_map
            return step(params, tree_map(torch.clone, caches), batch)[0], \
                caches
        return step(params, caches, batch)
    return faulty


def half_batch(step):
    """The second half of the batch gets the first half's answers."""
    def faulty(params, caches, batch):
        nxt, caches = step(params, caches, batch)
        if _generating(batch):
            h = nxt.shape[0] // 2
            nxt = torch.cat([nxt[:h], nxt[:h]])
        return nxt, caches
    return faulty


def altered_token(step):
    """One token changed where the step produces it."""
    def faulty(params, caches, batch):
        nxt, caches = step(params, caches, batch)
        if _generating(batch):
            nxt = nxt.clone()
            nxt[0, 0] = (nxt[0, 0] + 1) % 500
        return nxt, caches
    return faulty


def no_undo(sess):
    """A checkout that restores nothing."""
    from repro_torch.core.checkout import CheckoutStats
    return lambda cid: CheckoutStats()


@pytest.mark.parametrize("family", FAMILIES)
def test_sound_run_is_correct(family):
    out = _run(family)
    assert out["correct"], out["checks"]


@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("fault", [unchanged_state, half_batch,
                                   altered_token])
def test_broken_step_is_not_correct(family, fault):
    out = _run(family, step_wrapper=fault)
    assert not out["correct"]
    assert out["checks"]["logit_gap"]["value"] \
        > out["checks"]["logit_gap"]["limit"], out["checks"]


@pytest.mark.parametrize("family", FAMILIES)
def test_undo_that_restores_nothing_is_not_correct(family):
    out = _run(family, checkout_wrapper=no_undo)
    assert not out["correct"]
    assert out["checks"]["undo_diff"]["value"] > 0
