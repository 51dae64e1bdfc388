"""The port's attention gradients (apex_tpu_torch.ops.flash_attention, the
plain backward flash_attention_bwd_ref on the CPU) against jax.vjp of
the JAX package's flash_attention, whose Pallas backward runs in
interpret mode: both of its routes, APEX_TPU_FLASH_BWD=split (the
dq + dk/dv pair K6 and K7 port) and =fused (the single pass), for
causal, key padding, GQA g=2 and a fully masked batch row.

Inputs are fp32 and the tolerance 1e-5 relative to each gradient's
largest element: both sides compute in fp32, in another order."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.ops.flash_attention import flash_attention as j_flash
from apex_tpu_torch.ops import flash_attention as tfa

TOL = 1e-5

CASES = {
    # name: (b, s, n, g, d, causal, key lengths or None)
    "causal": (2, 24, 4, 4, 16, True, None),
    "causal_padded": (2, 24, 4, 4, 16, True, [24, 13]),
    "padded": (2, 20, 4, 4, 16, False, [20, 9]),
    "gqa_g2": (1, 33, 4, 2, 32, True, [30]),
    "fully_masked_row": (2, 16, 4, 4, 16, True, [16, 0]),
}


def _inputs(b, s, n, g, d, lens, seed=0):
    rng = np.random.RandomState(seed)
    q = rng.randn(b, s, n, d).astype(np.float32)
    k = rng.randn(b, s, g, d).astype(np.float32)
    v = rng.randn(b, s, g, d).astype(np.float32)
    do = rng.randn(b, s, n, d).astype(np.float32)
    kpm = None if lens is None else np.arange(s)[None] >= np.asarray(
        lens)[:, None]
    return q, k, v, do, kpm


def _rel(got, want):
    want = np.asarray(want)
    return float(np.abs(np.asarray(got) - want).max()
                 / max(np.abs(want).max(), 1e-6))


@pytest.mark.parametrize("mode", ["split", "fused"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_grads_match_jax(monkeypatch, mode, case):
    monkeypatch.setenv("APEX_TPU_FLASH_BWD", mode)
    b, s, n, g, d, causal, lens = CASES[case]
    q, k, v, do, kpm = _inputs(b, s, n, g, d, lens)
    jkpm = None if kpm is None else jnp.asarray(kpm)
    _, vjp = jax.vjp(lambda q_, k_, v_: j_flash(
        q_, k_, v_, causal=causal, key_padding_mask=jkpm),
        *(jnp.asarray(a) for a in (q, k, v)))
    want = vjp(jnp.asarray(do))

    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    out = tfa.flash_attention(
        *leaves, causal=causal,
        key_padding_mask=None if kpm is None else torch.from_numpy(kpm))
    out.backward(torch.from_numpy(do))
    for t, e, name in zip(leaves, want, ("dq", "dk", "dv")):
        assert t.grad.shape == e.shape, name
        assert _rel(t.grad.numpy(), e) <= TOL, name
    if case == "fully_masked_row":
        assert all(torch.count_nonzero(t.grad[1]) == 0 for t in leaves)


def test_reference_bwd_matches_autograd_of_the_materialized_softmax():
    """flash_attention_bwd_ref (from lse and delta) equals autograd
    through mha_reference's softmax, bf16 inputs included."""
    q, k, v, do, kpm = _inputs(2, 18, 6, 3, 16, [18, 11], seed=1)
    for dtype, tol in ((torch.float32, 1e-5), (torch.bfloat16, 2e-2)):
        tq, tk, tv = (torch.from_numpy(a).to(dtype).requires_grad_()
                      for a in (q, k, v))
        tdo = torch.from_numpy(do).to(dtype)
        tkpm = torch.from_numpy(kpm)
        tfa.mha_reference(tq, tk, tv, causal=True,
                          key_padding_mask=tkpm).backward(tdo)
        o, lse = tfa.flash_attention_fwd_ref(tq.detach(), tk.detach(),
                                             tv.detach(), causal=True,
                                             key_padding_mask=tkpm)
        got = tfa.flash_attention_bwd_ref(tq.detach(), tk.detach(),
                                          tv.detach(), o, lse, tdo,
                                          causal=True, key_padding_mask=tkpm)
        for a, t in zip(got, (tq, tk, tv)):
            assert a.dtype == dtype
            assert _rel(a.float().numpy(), t.grad.float().numpy()) <= tol


def test_lse_layout_and_sentinel():
    q, k, v, _, kpm = _inputs(2, 8, 2, 2, 16, [8, 0])
    o, lse = tfa.flash_attention_fwd_ref(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal=True, key_padding_mask=torch.from_numpy(kpm))
    assert lse.shape == (2 * 2, 8) and lse.dtype == torch.float32
    assert (lse[2:] == -1e30).all() and torch.isfinite(lse[:2]).all()
    assert torch.count_nonzero(o[1]) == 0
