"""The port's scaled-softmax family (apex_tpu_torch.ops.softmax, its plain
forward on the CPU) and FusedScaleMaskSoftmax against the JAX package's,
forward and backward (jax.vjp against autograd), plus the plain forward
against the Pallas _softmax_fwd_pallas in interpret mode.

Every side computes the softmax in fp32, in another order: fp32 outputs
agree within 1e-6 absolute (probabilities are at most 1), gradients
within 1e-6 relative to their largest element, and bf16 outputs, rounded
once from fp32 on both sides, within one bf16 step at 1 (2**-8)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.ops import softmax as jsm
from apex_tpu.transformer.enums import AttnMaskType as JMaskType
from apex_tpu.transformer.functional import (
    FusedScaleMaskSoftmax as JFused)
from apex_tpu_torch.ops import softmax as tsm
from apex_tpu_torch.transformer.enums import AttnMaskType
from apex_tpu_torch.transformer.functional import FusedScaleMaskSoftmax

ATOL = 1e-6
GRAD_TOL = 1e-6
BF16_ATOL = 2.0 ** -8

B, N, SQ, SK = 2, 3, 24, 40


def _x(shape, seed=0, scale=3.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(
        np.float32)


def _masks(seed=1):
    """name -> mask for x [B, N, SQ, SK]: broadcast key padding (batch
    row 1 fully masked), broadcast per-query and full-shape masks."""
    rng = np.random.RandomState(seed)
    kpm = np.zeros((B, 1, 1, SK), bool)
    kpm[0, ..., 29:] = True
    kpm[1] = True
    per_query = rng.rand(B, 1, SQ, SK) < 0.3
    per_query[0, 0, 5] = True                  # one fully masked row
    full = rng.rand(B, N, SQ, SK) < 0.5
    return {"key_padding": kpm, "per_query": per_query, "full": full}


CASES = ["softmax", "key_padding", "per_query", "full", "causal"]


def _call(lib, case, x, scale, masks):
    if case == "softmax":
        return lib.scaled_softmax(x, scale)
    if case == "causal":
        return lib.scaled_upper_triang_masked_softmax(x, scale)
    m = masks[case]
    m = jnp.asarray(m) if lib is jsm else torch.from_numpy(m)
    fn = (lib.generic_scaled_masked_softmax if case == "full"
          else lib.scaled_masked_softmax)
    return fn(x, m, scale)


def _shape(case):
    return (B, N, SK, SK) if case == "causal" else (B, N, SQ, SK)


@pytest.mark.parametrize("scale", [1.0, 0.125])
@pytest.mark.parametrize("case", CASES)
def test_forward_and_backward_match_jax(case, scale):
    masks = _masks()
    x = _x(_shape(case))
    dy = _x(x.shape, seed=2, scale=1.0)
    jy, vjp = jax.vjp(lambda a: _call(jsm, case, a, scale, masks),
                      jnp.asarray(x))
    (jdx,) = vjp(jnp.asarray(dy))
    tx = torch.from_numpy(x).requires_grad_()
    ty = _call(tsm, case, tx, scale, masks)
    ty.backward(torch.from_numpy(dy))
    assert ty.dtype == torch.float32 and ty.shape == x.shape
    np.testing.assert_allclose(ty.detach().numpy(), np.asarray(jy), rtol=0,
                               atol=ATOL)
    jdx = np.asarray(jdx)
    err = np.abs(tx.grad.numpy() - jdx).max() / np.abs(jdx).max()
    assert err <= GRAD_TOL
    if case == "key_padding":      # batch row 1 is fully masked
        assert torch.count_nonzero(ty[1]) == 0
        assert torch.count_nonzero(tx.grad[1]) == 0


@pytest.mark.parametrize("case", CASES)
def test_bf16_matches_jax(case):
    masks = _masks()
    x = _x(_shape(case), seed=3)
    jy = _call(jsm, case, jnp.asarray(x).astype(jnp.bfloat16), 0.5, masks)
    ty = _call(tsm, case, torch.from_numpy(x).bfloat16(), 0.5, masks)
    assert ty.dtype == torch.bfloat16
    np.testing.assert_allclose(ty.float().numpy(),
                               np.asarray(jy.astype(jnp.float32)), rtol=0,
                               atol=BF16_ATOL)


@pytest.mark.parametrize("causal", [False, True])
def test_plain_forward_matches_pallas_interpret(causal):
    """The plain forward against the TPU kernel itself, run in interpret
    mode (sk a multiple of 128, a full-shape mask or the causal
    triangle)."""
    x = _x((2, 2, 128, 128), seed=4)
    mask = None
    if not causal:
        mask = np.random.RandomState(5).rand(*x.shape) < 0.25
        mask[1, 1, 7] = True                  # one fully masked row
    want = jsm._softmax_fwd_pallas(
        jnp.asarray(x), 0.5, None if mask is None else jnp.asarray(mask),
        causal)
    got = tsm._softmax_fwd_ref(torch.from_numpy(x), 0.5,
                               None if mask is None
                               else torch.from_numpy(mask), causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=ATOL)


FUSED_CASES = {
    # name: (attn_mask_type, x shape, mask name or None, mask_func)
    "padding": ("padding", (B, N, SQ, SK), "key_padding", False),
    "padding_no_mask": ("padding", (B, N, SQ, SK), None, False),
    "mask_func": ("padding", (B, N, SQ, SK), "per_query", True),
    "causal_square": ("causal", (B, N, SK, SK), None, False),
    "causal_rect": ("causal", (B, N, SQ, SK), None, False),
}


@pytest.mark.parametrize("case", sorted(FUSED_CASES))
def test_fused_scale_mask_softmax_matches_jax(case):
    kind, shape, mname, use_func = FUSED_CASES[case]
    masks = _masks()
    x = _x(shape, seed=6)

    def jfunc(a, m):
        return jnp.where(m, -1e4, a)

    def tfunc(a, m):
        return torch.where(m, -1e4, a)

    jmod = JFused(attn_mask_type=getattr(JMaskType, kind),
                  mask_func=jfunc if use_func else None, scale=0.25)
    tmod = FusedScaleMaskSoftmax(attn_mask_type=getattr(AttnMaskType, kind),
                                 mask_func=tfunc if use_func else None,
                                 scale=0.25)
    m = None if mname is None else masks[mname]
    jy = jmod(jnp.asarray(x), None if m is None else jnp.asarray(m))
    ty = tmod(torch.from_numpy(x), None if m is None
              else torch.from_numpy(m))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=0,
                               atol=ATOL)


def test_refusals():
    with pytest.raises(ValueError):
        tsm.scaled_upper_triang_masked_softmax(torch.zeros(2, 3, 4))
    with pytest.raises(ValueError):
        FusedScaleMaskSoftmax(softmax_in_fp32=False, scale=0.5)
    with pytest.raises(ValueError):
        tsm.scaled_softmax(torch.zeros(2, 4), backend="triton")


@pytest.mark.parametrize("mname", ["key_padding", "per_query", "full",
                                   "rank2", "rank5"])
def test_kernel_mask_view_indexes_the_broadcast_mask(mname):
    """row 11 reads mask[i0*s0 + i1*s1 + i2*s2 + c*s3] for row r = (i0*d1
    + i1)*sq + i2 of x viewed [rows, sk]; the view the wrapper hands it
    must give back the broadcast mask at every (row, column)."""
    masks = _masks()
    shape = (B, N, SQ, SK)
    if mname == "rank2":
        mask, shape = masks["per_query"][0, 0], (SQ, SK)
    elif mname == "rank5":
        shape = (2,) + shape
        mask = np.random.RandomState(7).rand(2, 1, N, 1, SK) < 0.5
    else:
        mask = masks[mname]
    m = tsm._mask_view(torch.from_numpy(mask), shape)
    assert m.ndim == 4
    if mname == "key_padding":
        assert m.stride()[1] == 0 and m.stride()[2] == 0
    flat = torch.as_strided(m, (m.untyped_storage().nbytes(),), (1,), 0)
    d1, sq, sk = m.shape[1], shape[-2], shape[-1]
    rows = int(np.prod(shape)) // sk
    r = torch.arange(rows)[:, None]
    c = torch.arange(sk)[None]
    i2, t = r % sq, r // sq
    i1, i0 = t % d1, t // d1
    s0, s1, s2, s3 = m.stride()
    base = m.storage_offset() + i0 * s0 + i1 * s1 + i2 * s2
    got = flat[base + c * s3]
    want = torch.from_numpy(np.ascontiguousarray(
        np.broadcast_to(mask, shape).reshape(rows, sk)))
    assert torch.equal(got, want)
    # the vector reads: where the plan reads the mask in steps of vec
    # bytes (fp32 4, 16-bit 8), a step's bytes at base + c0 .. c0 + vec - 1
    # (c0 a multiple of vec, base a multiple of vec) are the step's mask
    # elements
    for itemsize in (4, 2):
        plan = tsm.softmax_plan(sk, itemsize, 0, 0, m.data_ptr(),
                                m.stride())
        assert plan.mask == tsm.MASK_VECTOR
        vec = plan.vec
        assert vec == 16 // itemsize and sk % vec == 0
        assert bool(((flat.data_ptr() + base) % vec == 0).all())
        c0 = torch.arange(0, sk, vec)[None, :, None]
        j = torch.arange(vec)[None, None]
        steps = flat[base[:, :, None] + c0 + j]
        assert torch.equal(steps.reshape(rows, sk), want)


# (sk, element size, x offset in bytes) -> (lanes, vectors, step)
PLAN_CASES = {
    "fp32 sk1": (1, 4, 0, (0, 0, 1)),
    "fp32 sk31": (31, 4, 0, (0, 0, 1)),
    "fp32 sk32 quarter warp": (32, 4, 0, (8, 1, 4)),
    "fp32 sk40 half warp": (40, 4, 0, (16, 1, 4)),
    "fp32 sk64 half warp": (64, 4, 0, (16, 1, 4)),
    "fp32 sk68 warp": (68, 4, 0, (32, 1, 4)),
    "fp32 sk512 bert": (512, 4, 0, (32, 4, 4)),
    "fp32 sk1024": (1024, 4, 0, (32, 8, 4)),
    "fp32 sk1025": (1025, 4, 0, (0, 0, 1)),
    "fp32 sk2048 loop vector": (2048, 4, 0, (0, 0, 4)),
    "fp32 sk512 unaligned": (512, 4, 4, (0, 0, 1)),
    "bf16 sk512": (512, 2, 0, (32, 2, 8)),
    "bf16 sk1100": (1100, 2, 0, (0, 0, 1)),
    "bf16 sk2048": (2048, 2, 0, (32, 8, 8)),
    "bf16 sk2049": (2049, 2, 0, (0, 0, 1)),
    "bf16 sk4096 loop vector": (4096, 2, 0, (0, 0, 8)),
    "bf16 sk512 unaligned": (512, 2, 2, (0, 0, 1)),
}


@pytest.mark.parametrize("case", sorted(PLAN_CASES))
def test_softmax_plan_picks_the_variant(case):
    """Row 11's variant is a pure function of the row length, the element
    size and the alignment: rows of at most 8 16-byte vectors a lane that
    start aligned are read once by 8, 16 or 32 lanes; others loop, in
    vectors where aligned."""
    sk, itemsize, off, want = PLAN_CASES[case]
    plan = tsm.softmax_plan(sk, itemsize, 4096 + off, 8192)
    assert (plan.lanes, plan.vectors, plan.vec) == want
    assert plan.mask == tsm.MASK_NONE
    if plan.lanes:
        nvec = sk // plan.vec
        assert plan.lanes * plan.vectors >= nvec
        assert plan.vectors == 1 or plan.lanes * plan.vectors < 2 * nvec
        assert plan.vectors <= tsm.ROW_MAX_VECTORS


@pytest.mark.parametrize("strides, ptr, sk, itemsize, want", [
    ((512, 0, 0, 1), 0, 512, 4, "vector"),       # [b, 1, 1, sk]
    ((512 * 512, 0, 512, 1), 64, 512, 2, "vector"),  # [b, 1, sq, sk]
    ((512, 0, 0, 1), 2, 512, 4, "strided"),      # rows not 4-aligned
    ((516, 0, 0, 1), 0, 512, 2, "strided"),      # 516 % 8 != 0
    ((512, 0, 1, 512), 0, 512, 4, "strided"),    # transposed mask
    ((1, 0, 0, 0), 0, 512, 4, "strided"),        # broadcast along sk
    ((1100, 0, 0, 1), 3, 1100, 2, "vector"),     # looped one at a time
])
def test_softmax_plan_reads_the_mask_in_vectors_where_it_can(
        strides, ptr, sk, itemsize, want):
    plan = tsm.softmax_plan(sk, itemsize, 0, 0, ptr, strides)
    assert plan.mask == {"vector": tsm.MASK_VECTOR,
                         "strided": tsm.MASK_STRIDED}[want]


ATTN_CASES = {
    # name: (attn_mask_type, kv groups, key lengths or None,
    #        softmax_in_fp32, dtype)
    "padding": ("padding", 4, [24, 9], True, "fp32"),
    "padding_gqa": ("padding", 2, [24, 0], True, "fp32"),
    "causal": ("causal", 4, None, True, "fp32"),
    "causal_padded": ("causal", 4, [24, 13], True, "fp32"),
    "bf16_softmax_in_bf16": ("padding", 4, [24, 17], False, "bf16"),
}


@pytest.mark.parametrize("case", sorted(ATTN_CASES))
def test_core_attention_fused_softmax_matches_jax(case):
    """The fused_softmax branch of models/transformer_lm._core_attention
    against the JAX one: key padding broadcast to [b, 1, 1, sk], combined
    with the causal triangle, GQA broadcast, scores in q's dtype when
    softmax_in_fp32=False.  fp32 within ATOL; bf16 within a bf16 step of
    the largest output."""
    from apex_tpu.models.config import TransformerConfig as JCfg
    from apex_tpu.models.transformer_lm import _core_attention as j_core
    from apex_tpu_torch.models.config import TransformerConfig as TCfg
    from apex_tpu_torch.models.transformer_lm import _core_attention as t_core

    kind, g, lens, in_fp32, dt = ATTN_CASES[case]
    b, s, n, d = 2, 24, 4, 16
    kw = dict(num_layers=1, hidden_size=n * d, num_attention_heads=n,
              num_query_groups=None if g == n else g, attn_mask_type=kind,
              attention_backend="fused_softmax", softmax_in_fp32=in_fp32)
    rng = np.random.RandomState(8)
    q = rng.randn(b, s, n, d).astype(np.float32)
    k = rng.randn(b, s, g, d).astype(np.float32)
    v = rng.randn(b, s, g, d).astype(np.float32)
    kpm = None if lens is None else np.arange(s)[None] >= np.asarray(
        lens)[:, None]
    jdt, tdt = ((jnp.float32, torch.float32) if dt == "fp32"
                else (jnp.bfloat16, torch.bfloat16))
    want = j_core(JCfg(**kw), *(jnp.asarray(a).astype(jdt)
                                for a in (q, k, v)),
                  None if kpm is None else jnp.asarray(kpm), None)
    got = t_core(TCfg(**kw), *(torch.from_numpy(a).to(tdt)
                               for a in (q, k, v)),
                 None if kpm is None else torch.from_numpy(kpm))
    assert got.dtype == tdt and got.shape == (b, s, n, d)
    want = np.asarray(want.astype(jnp.float32))
    tol = ATOL if dt == "fp32" else 2.0 ** -8 * np.abs(want).max()
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0, atol=tol)
