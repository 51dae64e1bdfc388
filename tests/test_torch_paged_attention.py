"""Kernel row 6 (ragged paged attention) and K3's int8 branch: the port's
plain versions against the JAX Pallas kernels in interpret mode on the
CPU — tail lengths with ``len % block_size`` in {0, 1, block_size - 1},
MHA, GQA and wide groups (12 query heads on one kv group at dh 64, 16 at
dh 128), lengths at the split-key kernel's chunk edges, native and int8
pools, sentinel table tails and an empty lane whose table holds only
sentinels.  fp32 within 1e-5; bf16 within 2e-2 (the plain version rounds
the probabilities to bf16 before the PV product, the Pallas kernel keeps
them fp32).  Then the split-key kernel's planner (``paged_plan``) and a
torch emulation of its split and chunk-order combine
(``csrc/paged_tile.cuh``) held against the plain version."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.ops import decode_step as jds
from apex_tpu.ops import paged_attention as jpa
from apex_tpu.serving.paged_cache import quantize_kv as j_quantize_kv
from apex_tpu_torch.ops import decode_step as tds
from apex_tpu_torch.ops import paged_attention as tpa

TOL = {np.float32: 1e-5, "bf16": 2e-2}


def _case(seed, nh, g, bs, lens, quant, dh=16, mb=5):
    rng = np.random.RandomState(seed)
    b = len(lens)
    nb = b * mb + 3
    q = rng.randn(b, nh, dh).astype(np.float32)
    kp = rng.randn(nb, bs, g, dh).astype(np.float32)
    vp = rng.randn(nb, bs, g, dh).astype(np.float32)
    tables = rng.permutation(nb)[:b * mb].reshape(b, mb).astype(np.int32)
    for i, n in enumerate(lens):
        tables[i, -(-n // bs):] = nb + 2 * i      # unmapped sentinel tail
    out = dict(q=q, kp=kp, vp=vp, tables=tables,
               lens=np.asarray(lens, np.int32))
    if quant:
        for name in ("kp", "vp"):
            w, s = j_quantize_kv(jnp.asarray(out[name]))
            out[name] = np.asarray(w)
            out[name[0] + "s"] = np.asarray(s)
    return out


def _torch_args(c, dtype, quant):
    tdt = torch.float32 if dtype is np.float32 else torch.bfloat16
    tq = torch.from_numpy(c["q"]).to(tdt)
    tk, tv = torch.from_numpy(c["kp"]), torch.from_numpy(c["vp"])
    if not quant:
        tk, tv = tk.to(tdt), tv.to(tdt)
    sc = {}
    if quant:
        sc = dict(k_scale=torch.from_numpy(c["ks"]),
                  v_scale=torch.from_numpy(c["vs"]))
    return (tq, tk, tv, torch.from_numpy(c["tables"]),
            torch.from_numpy(c["lens"])), sc


def _jax_args(c, dtype, quant):
    jdt = jnp.float32 if dtype is np.float32 else jnp.bfloat16
    jq = jnp.asarray(c["q"]).astype(jdt)
    jk, jv = jnp.asarray(c["kp"]), jnp.asarray(c["vp"])
    if not quant:
        jk, jv = jk.astype(jdt), jv.astype(jdt)
    sc = {}
    if quant:
        sc = dict(k_scale=jnp.asarray(c["ks"]), v_scale=jnp.asarray(c["vs"]))
    return (jq, jk, jv, jnp.asarray(c["tables"]),
            jnp.asarray(c["lens"])), sc


# wide kv groups the split-key kernel takes (the old loop refused rep > 8
# and rep * dh > 1024): MQA on gpt_125m's 12 heads at dh 64, 16 query heads
# a group at dh 128; lanes at the plan's chunk edges, one across three
# chunks, and an empty lane whose table holds only sentinels
WIDE = [(12, 1, 64), (16, 1, 128)]
EDGE_BS, EDGE_MB = 16, 12
SMS = 132                       # the H100's SMs: the plans the card runs


def _edge_lens(nh, g, dh, itemsize, b=5):
    plan = tpa.paged_plan(b, g, nh // g, dh, EDGE_BS * EDGE_MB, itemsize,
                          SMS)
    c = plan.chunk
    lens = [c - 1, c, c + 1, min(3 * c - 5, EDGE_BS * EDGE_MB), 0]
    return plan, lens


def _lens(bs):
    # tails with len % bs in {0, 1, bs - 1}, a one-token lane, empty lane
    return [2 * bs, 2 * bs + 1, 3 * bs - 1, 1, 0]


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("nh, g", [(4, 4), (4, 2), (8, 1)])
@pytest.mark.parametrize("bs", [4, 8])
@pytest.mark.parametrize("dtype", [np.float32, "bf16"])
def test_ragged_paged_attention_matches_jax_kernel(quant, nh, g, bs, dtype):
    c = _case(bs + nh + g, nh, g, bs, _lens(bs), quant)
    jdt = jnp.float32 if dtype is np.float32 else jnp.bfloat16
    tdt = torch.float32 if dtype is np.float32 else torch.bfloat16
    jq = jnp.asarray(c["q"]).astype(jdt)
    jk, jv = jnp.asarray(c["kp"]), jnp.asarray(c["vp"])
    tq = torch.from_numpy(c["q"]).to(tdt)
    tk, tv = torch.from_numpy(c["kp"]), torch.from_numpy(c["vp"])
    if not quant:
        jk, jv = jk.astype(jdt), jv.astype(jdt)
        tk, tv = tk.to(tdt), tv.to(tdt)
    jsc = tsc = {}
    if quant:
        jsc = dict(k_scale=jnp.asarray(c["ks"]), v_scale=jnp.asarray(c["vs"]))
        tsc = dict(k_scale=torch.from_numpy(c["ks"]),
                   v_scale=torch.from_numpy(c["vs"]))
    want = jpa.ragged_paged_attention(
        jq, jk, jv, jnp.asarray(c["tables"]), jnp.asarray(c["lens"]),
        backend="kernel", **jsc)
    got = tpa.ragged_paged_attention(
        tq, tk, tv, torch.from_numpy(c["tables"]),
        torch.from_numpy(c["lens"]), **tsc)
    assert got.dtype == tdt and tuple(got.shape) == tuple(want.shape)
    tol = TOL[dtype]
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               atol=tol, rtol=tol)
    # the empty lane gives exact zeros, not NaN
    assert bool((got[-1] == 0).all())


def test_reference_route_equals_default_on_cpu():
    c = _case(0, 4, 2, 4, [5, 8], True)
    args = [torch.from_numpy(c[k]) for k in ("q", "kp", "vp", "tables",
                                             "lens")]
    sc = dict(k_scale=torch.from_numpy(c["ks"]),
              v_scale=torch.from_numpy(c["vs"]))
    assert torch.equal(tpa.ragged_paged_attention(*args, **sc),
                       tpa.ragged_paged_attention(*args, backend="reference",
                                                  **sc))


def test_shape_checks():
    c = _case(1, 4, 2, 4, [5, 8], True)
    args = [torch.from_numpy(c[k]) for k in ("q", "kp", "vp", "tables",
                                             "lens")]
    with pytest.raises(ValueError, match="k_scale"):
        tpa.ragged_paged_attention(*args)
    with pytest.raises(ValueError, match="scales"):
        tpa.ragged_paged_attention(*args, k_scale=torch.ones(2),
                                   v_scale=torch.ones(2))


@pytest.mark.parametrize("nh, g, rope", [(4, 4, False), (4, 2, True)])
@pytest.mark.parametrize("dtype", [np.float32, "bf16"])
def test_fused_decode_layer_int8_matches_jax_kernel(nh, g, rope, dtype):
    """K3's int8 branch: rope + dequantizing paged attention + projection,
    against the JAX fused kernel (interpret mode) on an int8 pool."""
    bs, dh, h_out = 4, 16, 24
    c = _case(11 + nh, nh, g, bs, _lens(bs), True, dh=dh)
    rng = np.random.RandomState(3)
    w = (rng.randn(nh * dh, h_out) * 0.2).astype(np.float32)
    b = len(c["lens"])
    cos = sin = None
    if rope:
        ang = rng.rand(b, dh // 2).astype(np.float32) * 6
        ang = np.concatenate([ang, ang], -1)
        cos, sin = np.cos(ang), np.sin(ang)
    jdt = jnp.float32 if dtype is np.float32 else jnp.bfloat16
    tdt = torch.float32 if dtype is np.float32 else torch.bfloat16
    want = jds.fused_decode_layer(
        jnp.asarray(c["q"]).astype(jdt), jnp.asarray(c["kp"]),
        jnp.asarray(c["vp"]), jnp.asarray(c["tables"]),
        jnp.asarray(c["lens"]), jnp.asarray(w),
        rope_cos=None if cos is None else jnp.asarray(cos),
        rope_sin=None if sin is None else jnp.asarray(sin),
        backend="kernel", k_scale=jnp.asarray(c["ks"]),
        v_scale=jnp.asarray(c["vs"]))
    got = tds.fused_decode_layer(
        torch.from_numpy(c["q"]).to(tdt), torch.from_numpy(c["kp"]),
        torch.from_numpy(c["vp"]), torch.from_numpy(c["tables"]),
        torch.from_numpy(c["lens"]), torch.from_numpy(w),
        rope_cos=None if cos is None else torch.from_numpy(cos),
        rope_sin=None if sin is None else torch.from_numpy(sin),
        k_scale=torch.from_numpy(c["ks"]), v_scale=torch.from_numpy(c["vs"]))
    tol = TOL[dtype]
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("nh, g, dh", WIDE)
@pytest.mark.parametrize("dtype", [np.float32, "bf16"])
def test_wide_groups_at_chunk_edges_match_jax_kernel(quant, nh, g, dh,
                                                     dtype):
    """rep 12 at dh 64 and rep 16 at dh 128 (geometries the kernel takes
    since the split-key redesign), lengths at the plan's chunk - 1, chunk
    and chunk + 1, a lane over three chunks and an all-sentinel empty
    lane, against the JAX Pallas kernel (interpret mode)."""
    itemsize = 1 if quant else (4 if dtype is np.float32 else 2)
    plan, lens = _edge_lens(nh, g, dh, itemsize)
    assert plan.splits >= 3 and lens[2] == plan.chunk + 1
    c = _case(3 * nh + dh, nh, g, EDGE_BS, lens, quant, dh=dh, mb=EDGE_MB)
    assert (c["tables"][-1] >= c["kp"].shape[0]).all()
    jargs, jsc = _jax_args(c, dtype, quant)
    targs, tsc = _torch_args(c, dtype, quant)
    want = jpa.ragged_paged_attention(*jargs, backend="kernel", **jsc)
    got = tpa.ragged_paged_attention(*targs, **tsc)
    tol = TOL[dtype]
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               atol=tol, rtol=tol)
    assert bool((got[-1] == 0).all())


# ---- the split-key kernel's planner (ops/paged_attention.paged_plan) ----

def _plan_invariants(plan, b, g, rep, dh, reach, itemsize):
    step = tpa.WARPS * plan.tile
    assert 1 <= plan.splits <= tpa.MAX_SPLITS
    assert plan.chunk % step == 0
    assert plan.splits * plan.chunk >= reach > (plan.splits - 1) * plan.chunk
    assert plan.heads in tpa.HEAD_CAPACITIES and plan.rc <= plan.heads
    assert plan.rc * plan.head_chunks >= rep > plan.rc * (plan.head_chunks
                                                          - 1)
    assert plan.epl in tpa.LANE_DIMS
    dn_max = min(dh, 32 * plan.epl)
    assert dn_max * plan.dim_chunks >= dh > dn_max * (plan.dim_chunks - 1)
    assert 2 <= plan.stages <= 4 and plan.tile & (plan.tile - 1) == 0
    assert plan.smem == tpa.paged_smem(dh, itemsize, plan.rc, dn_max,
                                       plan.tile, plan.stages)
    assert plan.smem <= tpa.SMEM_MAX


# (reach, splits, chunk) on a full card (b32 x g12: chunks of 128 tokens,
# two warp tiles a warp, or 256 once that grid passes 16 CTAs an SM) and
# for one sequence (chunks of 64, one warp tile a warp, to spread it over
# more SMs), up to the 32-chunk limit
PLAN_SPLITS = {
    (32, 12): [(16, 1, 64), (64, 1, 64), (100, 1, 128), (128, 1, 128),
               (129, 2, 128), (576, 5, 128), (1024, 4, 256), (1025, 5, 256),
               (2048, 8, 256), (4096, 16, 256)],
    (1, 1): [(16, 1, 64), (64, 1, 64), (100, 2, 64), (128, 2, 64),
             (129, 3, 64), (576, 9, 64), (1024, 16, 64), (1025, 17, 64),
             (2048, 32, 64), (4096, 32, 128)]}


@pytest.mark.parametrize("b, g, reach, splits, chunk", [
    (*bg, *row) for bg, rows in PLAN_SPLITS.items() for row in rows])
def test_paged_plan_splits_by_reach(b, g, reach, splits, chunk):
    plan = tpa.paged_plan(b, g, 1, 64, reach, 2, SMS)
    _plan_invariants(plan, b, g, 1, 64, reach, 2)
    assert (plan.splits, plan.chunk) == (splits, chunk)
    # a warp's ring deepens past two tiles only for chunks of more than
    # four tiles a warp
    assert plan.stages == min(4, max(2, chunk // (tpa.WARPS * plan.tile)
                                     // 2))


def test_paged_plan_main_paths():
    """The plans of the smoke's shapes: row 6 at the engine's decode (b32,
    g12, reach 64 x 16), K3 at generate's (b8, g12, reach 36 x 16), MQA."""
    assert tpa.paged_plan(32, 12, 1, 64, 1024, 2, SMS) == tpa.PagedPlan(
        4, 256, 1, 1, 1, 2, 1, 16, 2, 37376)
    assert tpa.paged_plan(32, 12, 1, 64, 1024, 1, SMS)[:9] == (
        4, 256, 1, 1, 1, 2, 1, 16, 2)
    assert tpa.paged_plan(8, 12, 1, 64, 576, 2, SMS)[:3] == (5, 128, 1)
    mqa = tpa.paged_plan(8, 1, 12, 64, 576, 2, SMS)
    assert (mqa.heads, mqa.rc, mqa.head_chunks) == (16, 12, 1)


@pytest.mark.parametrize("reach", [1 << 13, 1 << 16, 100003])
def test_paged_plan_split_limit(reach):
    """However long the reach, a (sequence, group) takes at most 32 chunks
    (the partials a lane's combine adds): the chunks grow instead, and
    their warps' rings deepen up to four tiles."""
    plan = tpa.paged_plan(4, 2, 2, 64, reach, 2, SMS)
    _plan_invariants(plan, 4, 2, 2, 64, reach, 2)
    assert plan.splits == tpa.MAX_SPLITS
    assert plan.chunk >= reach // tpa.MAX_SPLITS
    assert plan.stages == min(4, plan.chunk // (tpa.WARPS * plan.tile) // 2)


@pytest.mark.parametrize("rep, heads, head_chunks, rc", [
    (1, 1, 1, 1), (2, 4, 1, 2), (3, 4, 1, 3), (4, 4, 1, 4), (5, 16, 1, 5),
    (12, 16, 1, 12), (16, 16, 1, 16), (17, 16, 2, 9), (32, 16, 2, 16),
    (48, 16, 3, 16)])
def test_paged_plan_heads(rep, heads, head_chunks, rc):
    plan = tpa.paged_plan(8, 1, rep, 128, 576, 2, SMS)
    _plan_invariants(plan, 8, 1, rep, 128, 576, 2)
    assert (plan.heads, plan.head_chunks, plan.rc) == (heads, head_chunks,
                                                       rc)


@pytest.mark.parametrize("dh, itemsize, heads", [
    (64, 2, 1), (128, 2, 1), (64, 1, 1), (128, 1, 1), (64, 4, 1),
    (128, 4, 4), (256, 2, 4), (8, 2, 1)])
def test_paged_plan_one_head_variant(dh, itemsize, heads):
    """MHA takes the one-head variant (a lane's share of the query and of
    P V in registers: at most 8 vectors of 16 bytes, two lanes a token)
    where the row fits, else the 4-head one."""
    plan = tpa.paged_plan(8, 8, 1, dh, 576, itemsize, SMS)
    _plan_invariants(plan, 8, 8, 1, dh, 576, itemsize)
    assert plan.heads == heads


@pytest.mark.parametrize("dh, itemsize, epl, dim_chunks", [
    (8, 2, 2, 1), (16, 1, 2, 1), (4, 4, 2, 1), (40, 2, 2, 1), (64, 2, 2, 1),
    (64, 1, 2, 1), (72, 2, 4, 1), (128, 2, 4, 1), (256, 2, 4, 2),
    (264, 2, 4, 3), (1024, 4, 4, 8), (2048, 2, 4, 16)])
def test_paged_plan_dims(dh, itemsize, epl, dim_chunks):
    plan = tpa.paged_plan(4, 4, 2, dh, 512, itemsize, SMS)
    _plan_invariants(plan, 4, 4, 2, dh, 512, itemsize)
    assert (plan.epl, plan.dim_chunks) == (epl, dim_chunks)
    # rows too wide for two tiles of 16 tokens a warp within the budget
    # take shorter warp tiles
    assert plan.tile == 16 or tpa.paged_smem(
        dh, itemsize, plan.rc, min(dh, 32 * epl), 2 * plan.tile, 2) > \
        96 * 1024


def test_paged_plan_refuses_rows_past_shared_memory():
    with pytest.raises(ValueError, match="does not fit"):
        tpa.paged_plan(1, 1, 1, 16384, 64, 2, SMS)
    with pytest.raises(ValueError, match="positive"):
        tpa.paged_plan(1, 1, 1, 64, 0, 2, SMS)


def test_kernel_geometry_takes_any_group_and_aligned_dh():
    """Only dh's 16-byte alignment is refused now: any group, and a pool in
    any float dtype whatever q's (the engine's ``cache_dtype``)."""
    for nh, g, dh in [(12, 1, 64), (32, 1, 128), (64, 2, 256), (8, 8, 8)]:
        tpa.check_kernel_geometry("t", torch.zeros(2, nh, dh,
                                                   dtype=torch.bfloat16),
                                  torch.zeros(3, 4, g, dh,
                                              dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="16-byte"):
        tpa.check_kernel_geometry("t", torch.zeros(2, 4, 12),
                                  torch.zeros(3, 4, 4, 12,
                                              dtype=torch.int8))
    for q_dt, pool_dt in [(torch.float32, torch.bfloat16),
                          (torch.bfloat16, torch.float32),
                          (torch.float16, torch.bfloat16)]:
        tpa.check_kernel_geometry("t", torch.zeros(2, 4, 16, dtype=q_dt),
                                  torch.zeros(3, 4, 4, 16, dtype=pool_dt))
    with pytest.raises(ValueError, match="16-byte"):
        tpa.check_kernel_geometry("t", torch.zeros(2, 4, 12),
                                  torch.zeros(3, 4, 4, 12,
                                              dtype=torch.bfloat16))
    assert [tpa.pool_code(d) for d in (torch.float32, torch.bfloat16,
                                       torch.float16, torch.int8)] == [
        0, 1, 2, 3]


# ---- the split and its chunk-order combine, emulated in torch ----------

_LOG2E = 1.4426950408889634


def _emulate_split(q, kp, vp, tables, lens, plan, scale, ks=None, vs=None):
    """csrc/paged_tile.cuh's arithmetic on the CPU in fp32: each live
    chunk's warps run an online softmax (base 2, scale folded in) over
    their round-robin warp tiles, the warps' (max, sum, acc) combine in
    warp order, then the live chunks' in chunk order (the second pass);
    chunks at or past the length are never formed, an empty lane is
    exact zeros."""
    b, nh, dh = q.shape
    nb, bs, g, _ = kp.shape
    mb = tables.shape[1]
    rep = nh // g
    wt, step = plan.tile, tpa.WARPS * plan.tile
    out = torch.zeros(b, nh, dh)
    for i in range(b):
        n = max(0, min(int(lens[i]), mb * bs))
        toks = torch.arange(n)
        blk = tables[i, toks // bs].long().clamp(0, nb - 1)
        k = kp[blk, toks % bs].float()                  # [n, g, dh]
        v = vp[blk, toks % bs].float()
        if ks is not None:
            k = k * ks[blk, toks % bs][..., None]
            v = v * vs[blk, toks % bs][..., None]
        n_live = -(-n // plan.chunk)
        for grp in range(g):
            qg = q[i, grp * rep:(grp + 1) * rep].float()      # [rep, dh]
            chunks = []
            for c in range(n_live):
                lo, hi = c * plan.chunk, min(n, (c + 1) * plan.chunk)
                warps = []
                for w in range(tpa.WARPS):
                    m = torch.full((rep,), -1e30)
                    l = torch.zeros(rep)
                    acc = torch.zeros(rep, dh)
                    for t0 in range(lo + w * wt, hi, step):
                        sl = slice(t0, min(t0 + wt, hi))
                        s = (qg @ k[sl, grp].T) * (scale * _LOG2E)
                        m_new = torch.maximum(m, s.amax(-1))
                        alpha = torch.exp2(m - m_new)
                        p = torch.exp2(s - m_new[:, None])
                        l = l * alpha + p.sum(-1)
                        acc = acc * alpha[:, None] + p @ v[sl, grp]
                        m = m_new
                    warps.append((m, l, acc))
                chunks.append(_combine(warps))
            if chunks:
                m, l, acc = _combine(chunks)
                out[i, grp * rep:(grp + 1) * rep] = acc / l[:, None]
    return out


def _combine(parts):
    """(max, sum, acc) partials added in list order."""
    mx = torch.stack([m for m, _, _ in parts]).amax(0)
    l = torch.zeros_like(mx)
    acc = torch.zeros_like(parts[0][2])
    for m, pl, pa in parts:
        f = torch.exp2(m - mx)
        l = l + pl * f
        acc = acc + pa * f[:, None]
    return mx, l, acc


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("nh, g, dh, bs, mb", [
    (12, 1, 64, 16, 12), (4, 2, 16, 4, 40), (16, 1, 128, 16, 12),
    (2, 2, 32, 8, 130)])
def test_split_combine_emulation_matches_reference(quant, nh, g, dh, bs, mb):
    """The split-key arithmetic (chunks of the card's plan, warp tiles
    dealt round robin, warp- then chunk-order combines) equals the plain
    gather-and-softmax within 1e-5 at fp32, on lanes of one to all the
    plan's chunks, at chunk edges, of one token and empty (all
    sentinels)."""
    reach = bs * mb
    plan = tpa.paged_plan(6, g, nh // g, dh, reach, 1 if quant else 4, SMS)
    ch = plan.chunk
    lens = [ch - 1, ch + 1, 1, reach, min(reach, 3 * ch), 0]
    c = _case(nh + dh + mb, nh, g, bs, lens, quant, dh=dh, mb=mb)
    (q, kp, vp, tables, ln), sc = _torch_args(c, np.float32, quant)
    want = tpa.paged_attention_reference(q, kp, vp, tables, ln, **sc)
    got = _emulate_split(q, kp, vp, tables, ln, plan, 1.0 / dh ** 0.5,
                         sc.get("k_scale"), sc.get("v_scale"))
    assert -(-reach // ch) == plan.splits
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5,
                               rtol=1e-5)
    assert bool((got[-1] == 0).all())


@pytest.mark.parametrize("nh, g, dh", WIDE)
def test_fused_decode_layer_int8_wide_groups_match_jax_kernel(nh, g, dh):
    """K3's int8 branch at rep 12 (dh 64) and rep 16 (dh 128), lengths at
    the plan's chunk edges and an all-sentinel empty lane, rope over the
    full head, fp32: the JAX fused kernel in interpret mode."""
    plan, lens = _edge_lens(nh, g, dh, 1)
    c = _case(nh + 7, nh, g, EDGE_BS, lens, True, dh=dh, mb=EDGE_MB)
    rng = np.random.RandomState(4)
    h_out = 32
    w = (rng.randn(nh * dh, h_out) * 0.05).astype(np.float32)
    ang = rng.rand(len(lens), dh // 2).astype(np.float32) * 6
    ang = np.concatenate([ang, ang], -1)
    cos, sin = np.cos(ang), np.sin(ang)
    jargs, jsc = _jax_args(c, np.float32, True)
    targs, tsc = _torch_args(c, np.float32, True)
    want = jds.fused_decode_layer(*jargs, jnp.asarray(w),
                                  rope_cos=jnp.asarray(cos),
                                  rope_sin=jnp.asarray(sin),
                                  backend="kernel", **jsc)
    got = tds.fused_decode_layer(*targs, torch.from_numpy(w),
                                 rope_cos=torch.from_numpy(cos),
                                 rope_sin=torch.from_numpy(sin), **tsc)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL[
        np.float32], rtol=TOL[np.float32])
    assert bool((got[-1] == 0).all())
