"""The port's grouped matmul gradient and int8-slab form (the plain
versions of kernel row 9's backward and int8 branch) against the JAX
package, on seeded numpy inputs at the adversarial offsets of
tests/torch_gmm_cases.py and a small MoE layout, fp32 and bf16:

- dx (the routed primitive on ``(g, w[g]^T)``) and dw (masked segment
  outer products) against ``jax.vjp`` of the JAX ``grouped_matmul`` on
  its reference route and on its Pallas kernel in interpret mode;
- ``quantize_group_weights`` bit for bit;
- the plain ``grouped_matmul_quantized`` against the JAX reference route
  and the Pallas ``_gmm_kernel`` with ``scale=`` in interpret mode, and
  its dx against ``jax.vjp``.

Tolerances are tests/test_torch_grouped_matmul.py's: fp32 1e-5; bf16 one
bf16 rounding apart (2**-8 relative, 1e-3 absolute near zero).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.ops import grouped_matmul as jgm
from apex_tpu_torch.ops import grouped_matmul as tgm
from torch_gmm_cases import ADVERSARIAL, offsets_case

TOL = {"float32": (1e-5, 1e-5), "bfloat16": (2 ** -8, 1e-3)}


def _inputs(case, k, p, dtype, seed=0):
    n, g, off = offsets_case(case)
    rng = np.random.RandomState(seed)
    x = rng.randn(n, k).astype(np.float32)
    w = (rng.randn(g, k, p) * 0.1).astype(np.float32)
    cot = rng.randn(n, p).astype(np.float32)
    jx, jw = jnp.asarray(x, dtype), jnp.asarray(w, dtype)
    tdt = getattr(torch, dtype)
    tx = torch.from_numpy(x).to(tdt)
    tw = torch.from_numpy(w).to(tdt)
    return ((jx, jw, jnp.asarray(off)), (tx, tw, torch.from_numpy(off)), off,
            cot)


def _np(a):
    return np.asarray(a, np.float32) if not isinstance(a, torch.Tensor) \
        else a.detach().float().numpy()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("backend", ["reference", "kernel"])
@pytest.mark.parametrize("case", ADVERSARIAL + ("moe_small",))
def test_autograd_matches_jax_vjp(case, backend, dtype):
    """dx (the routed primitive on (g, w[g]^T)) and dw (masked segment
    outer products) against ``jax.vjp`` of the JAX ``grouped_matmul`` on
    its reference route and its Pallas kernel in interpret mode; the
    port's CPU tensors take the plain version."""
    (jx, jw, joff), (tx, tw, toff), off, cot = _inputs(case, 16, 24, dtype,
                                                       3)
    jdt = jnp.dtype(dtype)
    out, vjp = jax.vjp(
        lambda a, b: jgm.grouped_matmul(a, b, joff, backend=backend), jx, jw)
    jdx, jdw = vjp(jnp.asarray(cot, jdt))
    tx.requires_grad_(True)
    tw.requires_grad_(True)
    got = tgm.grouped_matmul(tx, tw, toff)
    got.backward(torch.from_numpy(cot).to(getattr(torch, dtype)))
    rtol, atol = TOL[dtype]
    assert tx.grad.dtype == tx.dtype and tw.grad.dtype == tw.dtype
    np.testing.assert_allclose(_np(got), _np(out), rtol=rtol,
                               atol=atol)
    np.testing.assert_allclose(_np(tx.grad), _np(jdx), rtol=rtol, atol=atol)
    np.testing.assert_allclose(_np(tw.grad), _np(jdw), rtol=rtol, atol=atol)
    # rows outside the window get no gradient
    assert (_np(tx.grad)[:off[0]] == 0).all()
    assert (_np(tx.grad)[off[-1]:] == 0).all()


def test_reference_pin_covers_the_backward():
    _, (tx, tw, toff), _, cot = _inputs("window", 8, 16, "float32", 4)
    grads = []
    for backend in (None, "reference"):
        xa = tx.clone().requires_grad_(True)
        wa = tw.clone().requires_grad_(True)
        tgm.grouped_matmul(xa, wa, toff, backend=backend).backward(
            torch.from_numpy(cot))
        grads.append((xa.grad, wa.grad))
    torch.testing.assert_close(grads[0], grads[1], rtol=0, atol=0)


@pytest.mark.parametrize("block", [None, 16, 12, 3])
def test_quantize_group_weights_bit_for_bit(block):
    rng = np.random.RandomState(5)
    w = (rng.randn(3, 48, 20) * 0.2).astype(np.float32)
    w[1, :16, 3] = 0.0                          # an all-zero block: scale 1
    want = jgm.quantize_group_weights(jnp.asarray(w), block)
    got = tgm.quantize_group_weights(torch.from_numpy(w), block)
    np.testing.assert_array_equal(got["wire"].numpy(),
                                  np.asarray(want["wire"]))
    np.testing.assert_array_equal(got["scale"].numpy(),
                                  np.asarray(want["scale"]))
    assert got["wire"].dtype == torch.int8
    np.testing.assert_array_equal(
        tgm._dequantize_group(got["wire"], got["scale"]).numpy(),
        np.asarray(jgm._dequantize_group(want["wire"], want["scale"])))
    with pytest.raises(ValueError, match="does not tile"):
        tgm._check_group_slab(got["wire"], got["scale"][:, :, :5])


def _q_inputs(case, k, p, dtype, seed, block=16):
    (jx, jw, joff), (tx, tw, toff), off, _ = _inputs(case, k, p,
                                                     "float32", seed)
    jq = jgm.quantize_group_weights(jw, block)
    tq = tgm.quantize_group_weights(tw, block)
    return ((jx.astype(jnp.dtype(dtype)), jq, joff),
            (tx.to(getattr(torch, dtype)), tq, toff), off)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", ["window", "empty_groups", "ragged_300",
                                  "moe_small"])
def test_quantized_plain_matches_jax(case, dtype):
    """grouped_matmul_quantized's plain version against the JAX reference
    route and the Pallas ``_gmm_kernel`` with ``scale=`` in interpret
    mode (``_gmm_pallas``); output in x's dtype."""
    (jx, jq, joff), (tx, tq, toff), off = _q_inputs(case, 32, 24, dtype, 6)
    got = tgm.grouped_matmul_quantized(tx, tq["wire"], tq["scale"], toff)
    assert got.dtype == tx.dtype
    rtol, atol = TOL[dtype]
    ref = jgm.grouped_matmul_quantized(jx, jq["wire"], jq["scale"], joff,
                                       backend="reference")
    np.testing.assert_allclose(_np(got), _np(ref), rtol=rtol, atol=atol)
    kern = jgm._gmm_pallas(jx, jq["wire"], joff, interpret=True,
                           scale=jq["scale"])
    np.testing.assert_allclose(_np(got), _np(kern), rtol=rtol, atol=atol)
    assert (_np(got)[:off[0]] == 0).all() and (_np(got)[off[-1]:] == 0).all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantized_dx_matches_jax_vjp(dtype):
    """_gmmq_bwd: dx over the fp32-dequantized slab with g in fp32, cast
    to x's dtype; zeros for the scales, nothing for the wire."""
    (jx, jq, joff), (tx, tq, toff), off = _q_inputs("window", 32, 24,
                                                    dtype, 7)
    cot = np.random.RandomState(8).randn(tx.shape[0], 24).astype(np.float32)
    _, vjp = jax.vjp(lambda a, s: jgm.grouped_matmul_quantized(
        a, jq["wire"], s, joff, backend="reference"), jx, jq["scale"])
    jdx, jds = vjp(jnp.asarray(cot, jnp.dtype(dtype)))
    xa = tx.clone().requires_grad_(True)
    sa = tq["scale"].clone().requires_grad_(True)
    out = tgm.grouped_matmul_quantized(xa, tq["wire"], sa, toff)
    out.backward(torch.from_numpy(cot).to(out.dtype))
    rtol, atol = TOL[dtype]
    assert xa.grad.dtype == xa.dtype
    np.testing.assert_allclose(_np(xa.grad), _np(jdx), rtol=rtol, atol=atol)
    assert float(sa.grad.abs().sum()) == 0.0 == float(jnp.abs(jds).sum())


def test_quantized_checks():
    w = torch.zeros(2, 8, 4, dtype=torch.int8)
    s = torch.ones(2, 2, 4)
    off = torch.tensor([0, 1, 3], dtype=torch.int32)
    with pytest.raises(ValueError, match="offsets length"):
        tgm.grouped_matmul_quantized(torch.zeros(3, 8), w, s, off[:2])
    with pytest.raises(ValueError, match="contraction"):
        tgm.grouped_matmul_quantized(torch.zeros(3, 7), w, s, off)
    with pytest.raises(ValueError, match="does not tile"):
        tgm.grouped_matmul_quantized(torch.zeros(3, 8), w,
                                     torch.ones(2, 3, 4), off)
    out = tgm.grouped_matmul_quantized(torch.zeros(0, 8), w, s, off)
    assert out.shape == (0, 4)
