"""The port's FusedLAMB (apex_tpu_torch.optimizers.fused_lamb) against the
JAX package's, one update and 10 chained updates, in every mode: AdamW
and L2 decay, weight decay 0 with and without NVLAMB, active gradient
clipping, no bias correction, no gradient averaging.  The tree holds a
stacked [L, ...] leaf, so the per-leaf trust ratio spans its layers as
in JAX.

Both sides compute in fp32 from the same numpy inputs, in another order
(norms and sums), so the tolerance is 2e-6 relative to each leaf's
largest element after 10 steps."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.optimizers import fused_lamb as j_lamb
from apex_tpu.optimizers import apply_updates as j_apply
from apex_tpu_torch.optimizers import (
    FusedLAMB, FusedMixedPrecisionLamb, LambState, apply_updates,
    fused_lamb, fused_mixed_precision_lamb)

TOL = 2e-6

MODES = {
    "adamw": dict(),
    "l2": dict(adam_w_mode=False),
    "wd0": dict(weight_decay=0.0),
    "wd0_nvlamb": dict(weight_decay=0.0, use_nvlamb=True),
    "clip": dict(max_grad_norm=0.05),
    "no_bias_correction": dict(bias_correction=False, weight_decay=0.1),
    "no_grad_averaging": dict(grad_averaging=False, adam_w_mode=False),
}


def _tree(rng):
    return {
        "layers": {"kernel": rng.randn(3, 8, 12).astype(np.float32) * 0.2,
                   "bias": np.zeros((3, 12), np.float32)},
        "head": rng.randn(12, 5).astype(np.float32),
    }


def _grads(rng, scale=1.0):
    g = _tree(rng)
    return {k: ({kk: vv * scale for kk, vv in v.items()}
                if isinstance(v, dict) else v * scale)
            for k, v in g.items()}


def _to_jax(tree):
    return {k: _to_jax(v) if isinstance(v, dict) else jnp.asarray(v)
            for k, v in tree.items()}


def _to_torch(tree):
    return {k: _to_torch(v) if isinstance(v, dict) else torch.from_numpy(
        np.array(v)) for k, v in tree.items()}


def _leaves(tree):
    out = []
    for _, v in sorted(tree.items()):
        out += _leaves(v) if isinstance(v, dict) else [np.asarray(v)]
    return out


def _run(kw, steps):
    rng = np.random.RandomState(0)
    p0 = _tree(rng)
    grads = [_grads(rng, scale=3.0) for _ in range(steps)]
    jtx, ttx = j_lamb(lr=1e-2, **kw), fused_lamb(lr=1e-2, **kw)
    jp, tp = _to_jax(p0), _to_torch(p0)
    js, ts = jtx.init(jp), ttx.init(tp)
    for g in grads:
        ju, js = jtx.update(_to_jax(g), js, jp)
        jp = j_apply(jp, ju)
        tu, ts = ttx.update(_to_torch(g), ts, tp)
        tp = apply_updates(tp, tu)
    return (jp, js), (tp, ts)


@pytest.mark.parametrize("steps", [1, 10])
@pytest.mark.parametrize("mode", sorted(MODES))
def test_lamb_matches_jax(mode, steps):
    (jp, js), (tp, ts) = _run(MODES[mode], steps)
    assert isinstance(ts, LambState) and int(ts.step) == int(js.step)
    pairs = [(jp, tp), (js.exp_avg, ts.exp_avg),
             (js.exp_avg_sq, ts.exp_avg_sq)]
    for want_tree, got_tree in pairs:
        for want, got in zip(_leaves(want_tree), _leaves(got_tree)):
            assert got.dtype == np.float32
            err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-12)
            assert err <= TOL, (mode, steps, err)


def test_trust_ratio_is_per_stacked_leaf():
    """One ratio for the whole [L, ...] leaf: scaling one layer's weights
    changes every layer's update."""
    rng = np.random.RandomState(1)
    p = _to_torch(_tree(rng))
    g = _to_torch(_grads(rng))
    tx = fused_lamb(lr=1e-2)
    u1, _ = tx.update(g, tx.init(p), p)
    p2 = {**p, "layers": {**p["layers"],
                          "kernel": p["layers"]["kernel"].clone()}}
    p2["layers"]["kernel"][0] *= 4.0
    u2, _ = tx.update(g, tx.init(p2), p2)
    assert not torch.allclose(u1["layers"]["kernel"][2],
                              u2["layers"]["kernel"][2])


def test_aliases_and_refusals():
    """The aliases; norm_telemetry=True carries JAX's norms in the state;
    update without params raises."""
    from apex_tpu.optimizers._common import latest_norms as j_latest
    from apex_tpu_torch.optimizers._common import (
        NormTelemetryState, latest_norms)

    assert FusedLAMB is fused_lamb
    assert fused_mixed_precision_lamb is fused_lamb
    assert FusedMixedPrecisionLamb is fused_lamb
    rng = np.random.RandomState(3)
    p0, g = _tree(rng), _grads(rng, scale=3.0)
    jtx = j_lamb(lr=1e-2, norm_telemetry=True)
    ttx = fused_lamb(lr=1e-2, norm_telemetry=True)
    _, js = jtx.update(_to_jax(g), jtx.init(_to_jax(p0)), _to_jax(p0))
    _, ts = ttx.update(_to_torch(g), ttx.init(_to_torch(p0)), _to_torch(p0))
    assert isinstance(ts, NormTelemetryState)
    want, got = j_latest(js), latest_norms(ts)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=1e-5), k
    tx = fused_lamb()
    p = _to_torch(_tree(np.random.RandomState(2)))
    with pytest.raises(ValueError):
        tx.update(p, tx.init(p))
