"""The port's attention gradients (apex_tpu_torch.ops.flash_attention, the
plain backward flash_attention_bwd_ref on the CPU) against jax.vjp of
the JAX package's flash_attention, whose Pallas backward runs in
interpret mode: both of its routes, APEX_TPU_FLASH_BWD=split (the
dq + dk/dv pair K6 and K7 port) and =fused (the single pass row 5
ports), for causal, key padding, GQA g=2 and a fully masked batch row;
and the short-key class (keys up to 512) under the default auto route,
which sends it to the single pass as the port sends it to row 5.

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


SHORT_CASES = {
    # BERT's pattern: bidirectional, ragged key padding, one batch row
    # fully masked; then GQA and causal variants
    "padded": (3, 40, 4, 4, 16, False, [40, 23, 0]),
    "gqa_g2_padded": (2, 64, 4, 2, 32, False, [51, 64]),
    "causal_padded": (2, 48, 4, 4, 16, True, [48, 0]),
    "gqa_g1_causal": (1, 33, 4, 1, 16, True, None),
}


class TestShortKeys:
    """The default (auto) route, which takes the single-pass backward
    for padded key lengths up to 512."""

    @pytest.mark.parametrize("case", sorted(SHORT_CASES))
    def test_grads_match_jax_auto_route(self, monkeypatch, case):
        monkeypatch.delenv("APEX_TPU_FLASH_BWD", raising=False)
        monkeypatch.delenv("APEX_TPU_FLASH_BWD_FUSED_MAX", raising=False)
        b, s, n, g, d, causal, lens = SHORT_CASES[case]
        assert s <= tfa.SHORT_KEYS_MAX
        q, k, v, do, kpm = _inputs(b, s, n, g, d, lens, seed=2)
        jkpm = None if kpm is None else jnp.asarray(kpm)
        _, vjp = jax.vjp(lambda q_, k_, v_: j_flash(
            q_, k_, v_, causal=causal, key_padding_mask=jkpm),
            *(jnp.asarray(a) for a in (q, k, v)))
        want = vjp(jnp.asarray(do))
        leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
        tfa.flash_attention(
            *leaves, causal=causal,
            key_padding_mask=None if kpm is None else torch.from_numpy(kpm)
        ).backward(torch.from_numpy(do))
        for t, e, name in zip(leaves, want, ("dq", "dk", "dv")):
            assert t.grad.shape == e.shape, name
            assert _rel(t.grad.numpy(), e) <= TOL, name
        if lens is not None and 0 in lens:
            row = lens.index(0)
            assert all(torch.count_nonzero(t.grad[row]) == 0
                       for t in leaves)


@pytest.mark.parametrize("mode", ["split", "fused"])
@pytest.mark.parametrize("d", [40, 80, 96])
@pytest.mark.parametrize("dtype, tol", [("float32", TOL), ("bfloat16", 3e-2)])
@pytest.mark.parametrize("causal, lens", [(True, None), (True, [24, 13]),
                                          (False, [24, 0])])
def test_grads_match_jax_head_dims(monkeypatch, mode, d, dtype, tol, causal,
                                   lens):
    """The plain backward against jax.vjp of the JAX flash_attention at
    head sizes that are not a tile width, both JAX routes, fp32 and bf16
    (bf16 relative to each gradient's largest element)."""
    monkeypatch.setenv("APEX_TPU_FLASH_BWD", mode)
    b, s, n, g = 2, 24, 4, 2
    q, k, v, do, kpm = _inputs(b, s, n, g, d, lens, seed=d)
    jkpm = None if kpm is None else jnp.asarray(kpm)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    _, vjp = jax.vjp(lambda q_, k_, v_: j_flash(
        q_, k_, v_, causal=causal, key_padding_mask=jkpm),
        *(jnp.asarray(a, jdt) for a in (q, k, v)))
    want = vjp(jnp.asarray(do, jdt))
    leaves = [torch.from_numpy(a).to(tdt).requires_grad_()
              for a in (q, k, v)]
    tfa.flash_attention(
        *leaves, causal=causal,
        key_padding_mask=None if kpm is None else torch.from_numpy(kpm)
    ).backward(torch.from_numpy(do).to(tdt))
    for t, e, name in zip(leaves, want, ("dq", "dk", "dv")):
        assert t.grad.shape == e.shape and t.grad.dtype == tdt, name
        assert _rel(t.grad.float().numpy(), np.asarray(e, np.float32)) \
            <= tol, name


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


@pytest.mark.parametrize("sk, d, plan", [
    (1, 64, (1, 64)), (77, 128, (1, 32)), (128, 64, (1, 64)),
    (129, 64, (2, 64)), (200, 32, (2, 64)), (300, 128, (3, 32)),
    (384, 64, (3, 64)), (512, 64, (4, 64)), (640, 64, (5, 64)),
    (1000, 128, (8, 32)), (1024, 64, (8, 64)), (512, 80, (4, 32)),
    (512, 40, (4, 64)), (300, 96, (3, 32))])
def test_short_cluster(sk, d, plan):
    """Row 5's 16-bit cluster: one rank per 128 keys (BERT's and the MoE
    steps' 512 keys are 4 ranks), query tiles of 64 rows, 32 at d = 128."""
    assert tfa.short_cluster(sk, d) == plan


@pytest.mark.parametrize("sk", [0, 1025, 4096])
def test_short_cluster_bounds(sk):
    """The largest portable cluster (8 ranks) holds 1024 keys; longer
    keys are refused (flash_attention_bwd sends them to K6 + K7)."""
    with pytest.raises(ValueError):
        tfa.short_cluster(sk, 64)


@pytest.mark.parametrize("sq, sk, n, g, d, causal, steps", [
    (512, 512, 16, 16, 64, False, [[8, 8]] * 4),     # BERT-large
    (512, 512, 12, 12, 64, True,                     # the MoE steps
     [[8, 1], [7, 2], [6, 3], [5, 4]]),
    (512, 512, 16, 4, 64, False, [[32, 32]] * 4),    # GQA: 4 heads a group
    (130, 130, 4, 4, 64, True, [[3, 0], [2, 1]]),
    (300, 300, 4, 2, 128, True, [[20, 0], [16, 4], [12, 8]]),
    (100, 300, 4, 4, 64, True, [[2, 0], [1, 0], [0, 0]])])  # keys past sq
def test_short_rank_steps(sq, sk, n, g, d, causal, steps):
    """The (head, query tile) steps each rank's two warpgroups run
    products for: all of them without causality; with it, those from the
    warpgroup's first key on, key tiles r and 2R - 1 - r paired on rank r
    so that every rank's work is about the same."""
    assert tfa.short_rank_steps(sq, sk, n, g, d, causal) == steps
