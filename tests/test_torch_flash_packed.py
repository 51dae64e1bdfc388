"""Segment ids and packed (THD) sequences in the port's flash attention
(apex_tpu_torch.ops.flash_attention: the plain forward and backward on
the CPU) against the JAX package's, whose Pallas kernels run in interpret
mode: the mirror of tests/test_flash_attention.py's TestPackedSegments,
TestTHDIntegration, the GQA test_segment_ids_grads and the fused-against-
split segment routing.  Inputs are fp32, made with numpy; the tolerance
is 1e-5 relative to each output's largest element (the tolerance of
tests/test_torch_flash_attention_bwd.py; both sides compute in fp32 in
another order), 3e-5 absolute where JAX's own test compares per-sequence
composites.  Also: the port's tile-skip ranges (segment_ranges) against
a brute-force overlap test."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.ops.flash_attention import (
    flash_attention as j_flash, flash_attention_packed as j_packed,
    segment_ids_from_cu_seqlens as j_seg_ids)
from apex_tpu.ops.rope import fused_apply_rotary_pos_emb_thd as j_rope_thd
from apex_tpu_torch.ops import flash_attention as tfa
from apex_tpu_torch.ops import rope as trope

TOL = 1e-5


def _rel(got, want):
    want = np.asarray(want, np.float64)
    return float(np.abs(np.asarray(got, np.float64) - want).max()
                 / max(np.abs(want).max(), 1e-6))


def _packed(lengths, n=2, g=2, d=32, seed=20, total=None):
    total = total if total is not None else sum(lengths)
    rng = np.random.RandomState(seed)
    q = rng.randn(total, n, d).astype(np.float32) * 0.5
    k = rng.randn(total, g, d).astype(np.float32) * 0.5
    v = rng.randn(total, g, d).astype(np.float32) * 0.5
    do = rng.randn(total, n, d).astype(np.float32)
    cu = np.cumsum([0] + list(lengths)).astype(np.int32)
    return q, k, v, do, cu


def test_cu_seqlens_helper_matches_jax():
    cu = np.asarray([0, 3, 3, 7], np.int32)        # an empty document
    got = tfa.segment_ids_from_cu_seqlens(torch.from_numpy(cu), 9)
    assert got.tolist() == [0, 0, 0, 2, 2, 2, 2, -1, -1]
    assert np.array_equal(got.numpy(), np.asarray(j_seg_ids(
        jnp.asarray(cu), 9)))


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("lengths, total, g", [
    ([20, 30, 26], None, 2), ([25, 35], 72, 1)])   # padding tail, MQA
def test_packed_forward_and_grads_match_jax(causal, lengths, total, g):
    q, k, v, do, cu = _packed(lengths, n=4, g=g, total=total)
    o, vjp = jax.vjp(lambda *a: j_packed(*a, jnp.asarray(cu), causal=causal),
                     *(jnp.asarray(a) for a in (q, k, v)))
    want = vjp(jnp.asarray(do))
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    out = tfa.flash_attention_packed(*leaves, torch.from_numpy(cu),
                                     causal=causal)
    out.backward(torch.from_numpy(do))
    assert _rel(out.detach().numpy(), o) <= TOL
    for t, e, name in zip(leaves, want, ("dq", "dk", "dv")):
        assert _rel(t.grad.numpy(), e) <= TOL, name
    end = int(cu[-1])
    if end < q.shape[0]:   # padding rows: no output, no gradient
        assert torch.count_nonzero(out[end:]) == 0
        assert all(torch.count_nonzero(t.grad[end:]) == 0 for t in leaves)


@pytest.mark.parametrize("causal", [False, True])
def test_matches_per_sequence(causal):
    """TestPackedSegments.test_matches_per_sequence: each document of the
    packed call equals mha_reference on that document alone."""
    lengths = [30, 50, 48]
    q, k, v, _, cu = _packed(lengths)
    out = tfa.flash_attention_packed(*map(torch.from_numpy, (q, k, v)),
                                     torch.from_numpy(cu), causal=causal)
    start = 0
    for L in lengths:
        sl = slice(start, start + L)
        want = tfa.mha_reference(*(torch.from_numpy(a[sl])[None]
                                   for a in (q, k, v)), causal=causal)[0]
        torch.testing.assert_close(out[sl], want, atol=3e-5, rtol=3e-5)
        start += L


def test_padding_tail_isolated():
    lengths = [25, 35]
    q, k, v, _, cu = _packed(lengths, total=80)
    t = [torch.from_numpy(a) for a in (q, k, v)]
    out = tfa.flash_attention_packed(*t, torch.from_numpy(cu))
    want = tfa.flash_attention_packed(*(a[:60] for a in t),
                                      torch.from_numpy(cu))
    torch.testing.assert_close(out[:60], want, atol=3e-5, rtol=3e-5)


def test_grads_match_per_sequence():
    lengths = [20, 44]
    q, k, v, _, cu = _packed(lengths)
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    (tfa.flash_attention_packed(*leaves, torch.from_numpy(cu),
                                causal=True) ** 2).sum().backward()
    start = 0
    for L in lengths:
        sl = slice(start, start + L)
        parts = [torch.from_numpy(a[sl]).requires_grad_() for a in (q, k, v)]
        (tfa.mha_reference(*(p[None] for p in parts),
                           causal=True)[0] ** 2).sum().backward()
        for leaf, part in zip(leaves, parts):
            torch.testing.assert_close(leaf.grad[sl], part.grad, atol=5e-5,
                                       rtol=5e-5)
        start += L


@pytest.mark.parametrize("mode", ["split", "fused"])
@pytest.mark.parametrize("g, causal, dropout", [(2, True, False),
                                                (4, False, False),
                                                (1, True, True)])
def test_segment_ids_batched_grads_match_jax(monkeypatch, mode, g, causal,
                                             dropout):
    """[b, s] segment ids on the 4-D API: GQA test_segment_ids_grads and
    the fused-against-split routing (both JAX backward routes), with key
    padding, and with dropout."""
    monkeypatch.setenv("APEX_TPU_FLASH_BWD", mode)
    b, s, n, d = 2, 48, 4, 16
    rng = np.random.RandomState(21 + g)
    q = rng.randn(b, s, n, d).astype(np.float32) * 0.5
    k = rng.randn(b, s, g, d).astype(np.float32) * 0.5
    v = rng.randn(b, s, g, d).astype(np.float32) * 0.5
    do = rng.randn(b, s, n, d).astype(np.float32)
    seg = np.zeros((b, s), np.int32)
    seg[0, 20:] = 1
    seg[0, 44:] = -1
    seg[1] = np.repeat(np.arange(4), 12)
    kpm = np.arange(s)[None] >= np.asarray([48, 40])[:, None]
    key = jax.random.PRNGKey(g)
    jkw = dict(causal=causal, segment_ids=jnp.asarray(seg),
               key_padding_mask=jnp.asarray(kpm))
    tkw = dict(causal=causal, segment_ids=torch.from_numpy(seg),
               key_padding_mask=torch.from_numpy(kpm))
    if dropout:
        jkw.update(dropout_p=0.25, dropout_rng=key)
        tkw.update(dropout_p=0.25, dropout_rng=torch.from_numpy(np.asarray(
            jax.random.key_data(key)).astype(np.int64)))
    o, vjp = jax.vjp(lambda *a: j_flash(*a, **jkw),
                     *(jnp.asarray(a) for a in (q, k, v)))
    want = vjp(jnp.asarray(do))
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    out = tfa.flash_attention(*leaves, **tkw)
    out.backward(torch.from_numpy(do))
    assert _rel(out.detach().numpy(), o) <= TOL
    for t, e, name in zip(leaves, want, ("dq", "dk", "dv")):
        assert _rel(t.grad.numpy(), e) <= TOL, name


def test_segment_pair_runs_the_composition():
    """A (seg_q, seg_k) pair (cross-attention shapes) runs mha_reference,
    as JAX's XLA route does."""
    rng = np.random.RandomState(5)
    q = rng.randn(1, 12, 2, 16).astype(np.float32)
    k = rng.randn(1, 20, 2, 16).astype(np.float32)
    v = rng.randn(1, 20, 2, 16).astype(np.float32)
    sq_ids = np.repeat(np.arange(2), 6)[None].astype(np.int32)
    sk_ids = np.repeat(np.arange(2), 10)[None].astype(np.int32)
    want = j_flash(*(jnp.asarray(a) for a in (q, k, v)),
                   segment_ids=(jnp.asarray(sq_ids), jnp.asarray(sk_ids)))
    got = tfa.flash_attention(*map(torch.from_numpy, (q, k, v)),
                              segment_ids=(torch.from_numpy(sq_ids),
                                           torch.from_numpy(sk_ids)))
    assert _rel(got.numpy(), want) <= TOL
    with pytest.raises(ValueError, match="sq == sk"):
        tfa.flash_attention(*map(torch.from_numpy, (q, k, v)),
                            segment_ids=torch.from_numpy(sq_ids))


def test_thd_rope_matches_jax_and_feeds_packed_attention():
    """TestTHDIntegration: the THD rotary layout restarts positions per
    document (equal to JAX's), and packed attention over it equals the
    per-sequence composition."""
    n, d = 2, 32
    lengths = [24, 40]
    total = sum(lengths)
    rng = np.random.RandomState(30)
    t = rng.randn(total, n, d).astype(np.float32) * 0.5
    v = rng.randn(total, n, d).astype(np.float32) * 0.5
    cu = np.cumsum([0] + lengths).astype(np.int32)
    freqs = (rng.randn(max(lengths), 1, 1, d) * 0.1).astype(np.float32)
    q_thd = trope.fused_apply_rotary_pos_emb_thd(
        torch.from_numpy(t), torch.from_numpy(cu), torch.from_numpy(freqs))
    want_thd = j_rope_thd(jnp.asarray(t), jnp.asarray(cu),
                          jnp.asarray(freqs))
    np.testing.assert_allclose(q_thd.numpy(), np.asarray(want_thd),
                               atol=1e-6, rtol=1e-6)
    out = tfa.flash_attention_packed(q_thd, q_thd, torch.from_numpy(v),
                                     torch.from_numpy(cu), causal=True)
    start = 0
    for L in lengths:
        sl = slice(start, start + L)
        q_seq = trope.fused_apply_rotary_pos_emb(
            torch.from_numpy(t[sl])[:, None],
            torch.from_numpy(freqs[:L]))[:, 0]
        want = tfa.mha_reference(q_seq[None], q_seq[None],
                                 torch.from_numpy(v[sl])[None],
                                 causal=True)[0]
        torch.testing.assert_close(out[sl], want, atol=5e-5, rtol=5e-5)
        start += L


@pytest.mark.parametrize("seed", range(4))
def test_segment_ranges_skip_only_disjoint_tiles(seed):
    """segment_ranges' overlap test never skips a tile pair that holds a
    visible (query, key) pair, and its uniform ids never call a pair with
    a closed element open, at the kernels' tile sizes."""
    rng = np.random.RandomState(seed)
    s = 200
    ids = np.sort(rng.randint(0, 6, s)).astype(np.int32)
    ids[rng.rand(s) < 0.1 * (seed % 2)] = -1
    seg = torch.from_numpy(ids)[None]
    rng_t = tfa.segment_ranges(seg)[0].numpy()
    assert rng_t.shape == (-(-s // 32), 4)
    for bq, bk in ((128, 128), (128, 64), (32, 128), (64, 64), (32, 32)):
        for q0 in range(0, s, bq):
            for k0 in range(0, s, bk):
                qi, ki = ids[q0:q0 + bq], ids[k0:k0 + bk]
                opened = (qi[:, None] == ki[None]) & (ki[None] >= 0)
                gq = rng_t[q0 // 32:-(-min(q0 + bq, s) // 32)]
                gk = rng_t[k0 // 32:-(-min(k0 + bk, s) // 32)]
                lo_q, hi_q = gq[:, 0].min(), gq[:, 1].max()
                lo_k, hi_k = gk[:, 0].min(), gk[:, 1].max()
                live = lo_q <= hi_k and lo_k <= hi_q
                assert live or not opened.any()
                # one id throughout both tiles: every pair open
                uni = set(gq[:, 2]) | set(gk[:, 2])
                if len(uni) == 1 and min(uni) >= 0:
                    assert opened.all()


@pytest.mark.parametrize("causal, dropout, segments", [
    (True, 0.1, True), (False, 0.2, True), (True, 0.0, False)])
def test_plain_in_query_blocks_equals_the_whole_call(causal, dropout,
                                                     segments):
    """The plain forward and backward computed over blocks of query rows
    (``q_offset``: global rows for the causal mask and the dropout hash,
    ``(seg_q, seg_k)`` for the block's ids) give the whole call's o, lse
    and dq block by block, and dk, dv as the sum over the blocks."""
    lengths = [21, 40, 35]
    q, k, v, do, cu = _packed(lengths, n=4, g=2)
    total = q.shape[0]
    q, k, v, do = (torch.from_numpy(a)[None] for a in (q, k, v, do))
    seg = tfa.segment_ids_from_cu_seqlens(torch.from_numpy(cu), total)[None]
    kw = dict(causal=causal, dropout_p=dropout,
              seed=tfa.seed_from_key([7, 2024]) if dropout else None)
    if segments:
        kw["segment_ids"] = seg
    o, lse = tfa.flash_attention_fwd_ref(q, k, v, **kw)
    dq, dk, dv = tfa.flash_attention_bwd_ref(q, k, v, o, lse, do, **kw)
    lse3 = lse.reshape(1, 4, total)
    dk_sum, dv_sum = torch.zeros_like(dk), torch.zeros_like(dv)
    for r0 in range(0, total, 32):
        r1 = min(total, r0 + 32)
        bkw = dict(kw, q_offset=r0)
        if segments:
            bkw["segment_ids"] = (seg[:, r0:r1], seg)
        ob, lb = tfa.flash_attention_fwd_ref(q[:, r0:r1], k, v, **bkw)
        assert _rel(ob.numpy(), o[:, r0:r1].numpy()) <= TOL
        assert _rel(lb.reshape(1, 4, -1).numpy(),
                    lse3[:, :, r0:r1].numpy()) <= TOL
        gq, gk, gv = tfa.flash_attention_bwd_ref(
            q[:, r0:r1], k, v, o[:, r0:r1],
            lse3[:, :, r0:r1].reshape(4, -1), do[:, r0:r1], **bkw)
        assert _rel(gq.numpy(), dq[:, r0:r1].numpy()) <= TOL
        dk_sum += gk
        dv_sum += gv
    assert _rel(dk_sum.numpy(), dk.numpy()) <= TOL
    assert _rel(dv_sum.numpy(), dv.numpy()) <= TOL
