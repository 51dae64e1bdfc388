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
