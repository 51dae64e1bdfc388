"""The port's LayerNorm / RMSNorm forward (apex_tpu_torch.ops.layer_norm)
against the JAX package's, with its Pallas kernel run in interpret mode.
Tolerance 1e-5 at fp32 (tests/test_layer_norm.py), 2e-2 at bf16."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.ops import layer_norm as jln
from apex_tpu_torch.ops import layer_norm as tln

TOL = {"float32": 1e-5, "bfloat16": 2e-2}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _inputs(shape, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(*shape).astype(np.float32) * 2 + 0.5
    w = (1.0 + 0.1 * rng.randn(shape[-1])).astype(np.float32)
    b = (0.1 * rng.randn(shape[-1])).astype(np.float32)
    return x, w, b


def _np(t):
    return t.float().numpy()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("affine", [True, False])
def test_layer_norm_matches_jax_kernel(monkeypatch, dtype, affine):
    monkeypatch.setenv("APEX_TPU_PALLAS_INTERPRET", "1")
    x, w, b = _inputs((3, 5, 256))
    jw, jb = (jnp.asarray(w), jnp.asarray(b)) if affine else (None, None)
    tw, tb = (torch.from_numpy(w), torch.from_numpy(b)) if affine \
        else (None, None)
    want = jln.fused_layer_norm(jnp.asarray(x, JDT[dtype]), jw, jb)
    got = tln.fused_layer_norm(torch.from_numpy(x).to(TDT[dtype]), tw, tb)
    assert got.dtype == TDT[dtype]
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32),
                               atol=TOL[dtype], rtol=TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm_matches_jax_kernel(monkeypatch, dtype):
    monkeypatch.setenv("APEX_TPU_PALLAS_INTERPRET", "1")
    x, w, _ = _inputs((4, 128), seed=1)
    want = jln.fused_rms_norm(jnp.asarray(x, JDT[dtype]), jnp.asarray(w))
    got = tln.fused_rms_norm(torch.from_numpy(x).to(TDT[dtype]),
                             torch.from_numpy(w))
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32),
                               atol=TOL[dtype], rtol=TOL[dtype])


@pytest.mark.parametrize("rms", [False, True])
def test_stats_match_jax_kernel_residuals(monkeypatch, rms):
    """mu and rstd, the fp32 residuals a backward will read, equal the
    Pallas forward's."""
    monkeypatch.setenv("APEX_TPU_PALLAS_INTERPRET", "1")
    x, w, b = _inputs((16, 128), seed=2)
    _, jmu, jrs = jln._ln_fwd_pallas(jnp.asarray(x), jnp.asarray(w),
                                     None if rms else jnp.asarray(b),
                                     1e-5, rms)
    _, mu, rs = tln.layer_norm_fwd_stats(
        torch.from_numpy(x), torch.from_numpy(w),
        None if rms else torch.from_numpy(b), rms=rms)
    np.testing.assert_allclose(mu.numpy(), np.asarray(jmu)[:, 0], atol=1e-5)
    np.testing.assert_allclose(rs.numpy(), np.asarray(jrs)[:, 0], rtol=1e-5)


def test_reference_backend_and_bad_backend():
    x, w, b = _inputs((2, 64), seed=3)
    tx = torch.from_numpy(x)
    ref = tln.fused_layer_norm(tx, torch.from_numpy(w), torch.from_numpy(b),
                               backend="reference")
    got = tln.fused_layer_norm(tx, torch.from_numpy(w), torch.from_numpy(b))
    assert torch.equal(ref, got)
    with pytest.raises(ValueError, match="backend"):
        tln.fused_layer_norm(tx, backend="kernel")


# (rows, hidden, element size, aligned) -> (vectors, warps, grid) on 132 SMs
LN_PLAN_CASES = {
    "generate decode": (8, 768, 2, True, (3, 1, 8)),
    "engine decode": (32, 768, 2, True, (3, 1, 32)),
    "one row": (1, 1024, 2, True, (4, 1, 1)),
    "just past the SMs": (133, 768, 2, True, (3, 4, 34)),
    "moe step": (4096, 768, 2, True, (3, 4, 396)),
    "gpt step": (16384, 768, 2, True, (3, 4, 396)),
    "bert step": (4096, 1024, 2, True, (4, 4, 396)),
    "bf16 h2048": (300, 2048, 2, True, (8, 4, 75)),
    "fp32 h768": (300, 768, 4, True, (6, 4, 75)),
    "fp32 h1024": (300, 1024, 4, True, (8, 4, 75)),
    "fp32 h100": (300, 100, 4, True, (1, 4, 75)),
    "bf16 h100 scalar": (300, 100, 2, True, (0, 0, 0)),
    "bf16 h4096 scalar": (300, 4096, 2, True, (0, 0, 0)),
    "fp32 h2048 scalar": (300, 2048, 4, True, (0, 0, 0)),
    "unaligned scalar": (4096, 768, 2, False, (0, 0, 0)),
}


@pytest.mark.parametrize("case", sorted(LN_PLAN_CASES))
def test_ln_plan_picks_the_variant(case):
    """K1's variant, vectors a lane, warps a CTA and grid are a pure
    function of rows, width, element size and alignment: up to one row
    per SM a 1-warp CTA each, more rows persistent 4-warp CTAs whose
    warps together cover every row."""
    rows, hidden, itemsize, aligned, want = LN_PLAN_CASES[case]
    plan = tln.ln_plan(rows, hidden, itemsize, aligned, 132)
    assert tuple(plan) == want
    if plan.vectors:
        nvec = hidden // (16 // itemsize)
        assert 32 * (plan.vectors - 1) < nvec <= 32 * plan.vectors
        assert plan.grid <= tln.LN_CTAS_PER_SM * 132
        rows_per_warp = -(-rows // (plan.warps * plan.grid))
        assert rows_per_warp * plan.warps * plan.grid >= rows
        assert (rows_per_warp - 1) * plan.warps * plan.grid < rows
