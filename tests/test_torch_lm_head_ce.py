"""The port's chunked LM-head cross-entropy (apex_tpu_torch.ops.lm_head_ce)
and softmax cross-entropy (ops.xentropy) against the JAX package's:
per-token losses and the gradients of their sum, with ignore_index=-1
rows, label smoothing, and a chunk that does not divide the token count.

Tolerances relative to the largest element: 1e-5 for fp32 inputs; 1e-2
for bf16 inputs, whose dlogits are rounded to bf16 before the two
backward products in both packages."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.ops.lm_head_ce import lm_head_cross_entropy as j_ce
from apex_tpu.ops.xentropy import softmax_cross_entropy_loss as j_xent
from apex_tpu_torch.ops.lm_head_ce import lm_head_cross_entropy as t_ce
from apex_tpu_torch.ops.xentropy import softmax_cross_entropy_loss as t_xent

JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
TOL = {"float32": 1e-5, "bfloat16": 1e-2}


def _rel(got, want):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-6))


def _inputs(n, h, v, seed=0):
    rng = np.random.RandomState(seed)
    hidden = rng.randn(2, n // 2, h).astype(np.float32)
    head = (0.3 * rng.randn(v, h)).astype(np.float32)
    labels = rng.randint(0, v, (2, n // 2)).astype(np.int32)
    labels[0, :3] = -1
    gl = rng.randn(2, n // 2).astype(np.float32)   # loss cotangents
    return hidden, head, labels, gl


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("chunk, smoothing", [(7, 0.0), (16, 0.1), (64, 0.0)])
def test_lm_head_ce_matches_jax(dtype, chunk, smoothing):
    hidden, head, labels, gl = _inputs(30, 24, 40)
    jh, jw = (jnp.asarray(a, JDT[dtype]) for a in (hidden, head))
    losses_j, vjp = jax.vjp(lambda h_, w_: j_ce(
        h_, w_, jnp.asarray(labels), smoothing=smoothing, chunk=chunk,
        ignore_index=-1), jh, jw)
    dh_j, dw_j = vjp(jnp.asarray(gl))

    th, tw = (torch.from_numpy(a).to(TDT[dtype]).requires_grad_()
              for a in (hidden, head))
    losses_t = t_ce(th, tw, torch.from_numpy(labels), smoothing=smoothing,
                    chunk=chunk, ignore_index=-1)
    losses_t.backward(torch.from_numpy(gl))
    assert losses_t.dtype == torch.float32 and losses_t.shape == (2, 15)
    assert (losses_t[0, :3] == 0).all()
    assert _rel(losses_t.detach().numpy(), losses_j) <= TOL[dtype]
    assert th.grad.dtype == TDT[dtype] and tw.grad.dtype == TDT[dtype]
    assert (th.grad[0, :3] == 0).all()
    assert _rel(th.grad.float().numpy(), dh_j) <= TOL[dtype]
    assert _rel(tw.grad.float().numpy(), dw_j) <= TOL[dtype]


@pytest.mark.parametrize("smoothing, padding_idx", [(0.0, 0), (0.2, None),
                                                    (0.1, 3)])
def test_xentropy_matches_jax(smoothing, padding_idx):
    rng = np.random.RandomState(1)
    logits = rng.randn(12, 17).astype(np.float32) * 3
    labels = rng.randint(0, 17, 12).astype(np.int32)
    labels[:2] = 3
    gl = rng.randn(12).astype(np.float32)
    lj, vjp = jax.vjp(lambda x: j_xent(x, jnp.asarray(labels), smoothing,
                                       padding_idx), jnp.asarray(logits))
    (dj,) = vjp(jnp.asarray(gl))
    x = torch.from_numpy(logits).requires_grad_()
    lt = t_xent(x, torch.from_numpy(labels), smoothing, padding_idx)
    lt.backward(torch.from_numpy(gl))
    assert _rel(lt.detach().numpy(), lj) <= 1e-5
    assert _rel(x.grad.numpy(), dj) <= 1e-5


def test_fused_equals_unfused_loss():
    """The chunked head + CE equals xentropy over the full fp32 logits."""
    hidden, head, labels, _ = _inputs(20, 16, 33, seed=2)
    th, tw = torch.from_numpy(hidden), torch.from_numpy(head)
    lab = torch.from_numpy(labels).long()
    fused = t_ce(th, tw, lab, chunk=6, ignore_index=-1)
    logits = th @ tw.t()
    plain = t_xent(logits.reshape(-1, 33), lab.reshape(-1).clamp(min=0),
                   padding_idx=None).reshape(lab.shape)
    plain = torch.where(lab == -1, 0.0, plain)
    torch.testing.assert_close(fused, plain, atol=1e-5, rtol=1e-5)
