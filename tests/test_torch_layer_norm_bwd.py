"""The port's LayerNorm / RMSNorm gradients (apex_tpu_torch.ops.layer_norm,
the plain backward on the CPU) against jax.vjp of the JAX package's
fused_layer_norm / fused_rms_norm: once through its XLA backward, once
with APEX_TPU_PALLAS_INTERPRET=1 and a hidden size that is a multiple of
128, so that the Pallas _ln_bwd_kernel runs in interpret mode.

Scales and biases are fp16 (the O2 parameter dtype), so dγ and dβ come
back in fp16 from both packages.  Tolerances, relative to each
gradient's largest element: dx 1e-5 at fp32 and 1e-2 at bf16 (one bf16
rounding); dγ/dβ 2e-3 (one fp16 rounding of sums taken in another
order)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.ops import layer_norm as jln
from apex_tpu_torch.ops import layer_norm as tln

JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
DX_TOL = {"float32": 1e-5, "bfloat16": 1e-2}
PARAM_TOL = 2e-3


def _inputs(rows, hidden, seed):
    rng = np.random.RandomState(seed)
    x = rng.randn(rows, hidden).astype(np.float32) * 2 + 0.5
    dy = rng.randn(rows, hidden).astype(np.float32)
    w = (1.0 + 0.1 * rng.randn(hidden)).astype(np.float16)
    b = (0.1 * rng.randn(hidden)).astype(np.float16)
    return x, dy, w, b


def _rel(got, want):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-6))


def _grads(dtype, rms, x, dy, w, b):
    """(JAX grads, port grads) of sum(norm(x, w, b) * dy)."""
    xj = jnp.asarray(x, JDT[dtype])
    if rms:
        fj = lambda x_, w_: jln.fused_rms_norm(x_, w_)          # noqa: E731
        args = (xj, jnp.asarray(w))
    else:
        fj = lambda x_, w_, b_: jln.fused_layer_norm(x_, w_, b_)  # noqa
        args = (xj, jnp.asarray(w), jnp.asarray(b))
    y, vjp = jax.vjp(fj, *args)
    want = vjp(jnp.asarray(dy, y.dtype))

    xt = torch.from_numpy(x).to(TDT[dtype]).requires_grad_()
    wt = torch.from_numpy(w).requires_grad_()
    bt = torch.from_numpy(b).requires_grad_()
    out = (tln.fused_rms_norm(xt, wt) if rms
           else tln.fused_layer_norm(xt, wt, bt))
    out.backward(torch.from_numpy(dy).to(out.dtype))
    got = (xt.grad, wt.grad) if rms else (xt.grad, wt.grad, bt.grad)
    return want, got


@pytest.mark.parametrize("route", ["xla", "pallas_interpret"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rms", [False, True], ids=["layernorm", "rmsnorm"])
def test_grads_match_jax(monkeypatch, route, dtype, rms):
    if route == "pallas_interpret":
        monkeypatch.setenv("APEX_TPU_PALLAS_INTERPRET", "1")
        rows, hidden = 24, 256          # lane-aligned: the Pallas route
    else:
        rows, hidden = 20, 96
    x, dy, w, b = _inputs(rows, hidden, seed=hidden)
    want, got = _grads(dtype, rms, x, dy, w, b)
    assert got[0].dtype == TDT[dtype]
    assert all(g.dtype == torch.float16 for g in got[1:])
    assert _rel(got[0].float().numpy(), want[0]) <= DX_TOL[dtype]
    for g, e in zip(got[1:], want[1:]):
        assert e.dtype == jnp.float16
        assert _rel(g.float().numpy(), e) <= PARAM_TOL


def test_stats_feed_the_backward():
    """layer_norm_bwd from the forward's saved mu/rstd equals autograd
    through the plain forward formula."""
    x, dy, w, b = _inputs(7, 48, seed=3)
    xt, wt, bt = (torch.from_numpy(a).float().requires_grad_()
                  for a in (x, w, b))
    y = tln.layer_norm_ref(xt, wt, bt)
    y.backward(torch.from_numpy(dy))
    _, mu, rs = tln.layer_norm_fwd_stats(xt.detach(), wt.detach(),
                                         bt.detach())
    dx, dw, db = tln.layer_norm_bwd(torch.from_numpy(dy), xt.detach(),
                                    wt.detach(), mu, rs)
    torch.testing.assert_close(dx, xt.grad, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(dw, wt.grad, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(db, bt.grad, atol=1e-5, rtol=1e-5)


def test_memory_efficient_raises():
    x = torch.zeros(2, 8)
    with pytest.raises(NotImplementedError, match="memory_efficient"):
        tln.fused_layer_norm(x, memory_efficient=True)
    with pytest.raises(NotImplementedError, match="memory_efficient"):
        tln.fused_rms_norm(x, memory_efficient=True)
