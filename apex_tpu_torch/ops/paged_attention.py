"""Ragged paged decode attention (``apex_tpu/ops/paged_attention.py``).

For CUDA tensors :func:`ragged_paged_attention` is one call of kernel
row 6 (``csrc/paged_attention.cu``): the keys of each sequence are split
into chunks, one CTA a (sequence, kv group, chunk) (``csrc/
paged_tile.cuh``).  Each CTA walks its share of the sequence's block
table, folds the group's query heads against the group's single K/V
with an online softmax, never reads a position at or past the length,
and dequantizes an int8 pool by its per-(token, group) scales as it
loads; a second launch adds the partial softmax states of a lane's
chunks in chunk order.  :func:`paged_plan`, a pure function of the
shapes, chooses the chunks and the kernel variant; the launch grid
depends on the table's reach, never on the device-side lengths, so a
call captures in a CUDA graph.  For CPU tensors, and under
``backend="reference"``, it is :func:`paged_attention_reference`, the
gather-based oracle.

Layout: ``q`` ``[b, num_heads, dh]`` (one query token per sequence),
pools ``[num_blocks, block_size, kv_groups, dh]`` in any float dtype
(fp32, bf16 or fp16, whatever q's: an engine's ``cache_dtype``), or
int8 with ``k_scale``/``v_scale`` ``[num_blocks, block_size,
kv_groups]`` fp32 (``cache_wire="int8"``), ``block_tables``
``[b, max_blocks]`` (entries ``>= num_blocks`` unmapped), ``lengths``
``[b]`` live tokens (query included).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

from apex_tpu_torch.ops import _kernel_utils as ku
from apex_tpu_torch.utils.registry import check_backend, on_cuda

__all__ = ["ragged_paged_attention", "paged_attention_reference",
           "_check_paged_shapes", "check_kernel_geometry", "pool_code",
           "PagedPlan", "paged_plan", "paged_smem", "plan_for", "partials",
           "plan_args", "kernel_attributes"]

_NEG_INF = -1e30

PAGED_ATTENTION = ku.register(ku.Kernel(
    "ragged_paged_attention", "paged_attention.cu", "apex_paged_attention",
    [ctypes.c_void_p] * 9 + [ctypes.c_int] * 7
    + [ctypes.c_float] + [ctypes.c_int] * 12,
    replaces="apex_tpu/ops/paged_attention.py:160"))

# csrc/paged_tile.cuh: warps a CTA, tokens a warp tile at most, key
# chunks of one sequence at most, the kernel variants' head capacities and
# P V dims a lane, the shared-memory limit
WARPS = 4
TILE = 16
MAX_SPLITS = 32
HEAD_CAPACITIES = (1, 4, 16)
LANE_DIMS = (2, 4)
SMEM_MAX = 232448
# the int8 pool's element code (csrc/paged_tile.cuh kPoolInt8); float pools
# pass ku.DTYPE_CODES
POOL_INT8 = 3
_SMEM_BUDGET = 96 * 1024     # a plan's target: two CTAs an SM or more


class PagedPlan(NamedTuple):
    """One launch of the split-key loop (``csrc/paged_tile.cuh``)."""
    splits: int       # key chunks of one (sequence, group)
    chunk: int        # tokens a chunk (a multiple of WARPS * tile)
    heads: int        # the kernel variant's head capacity (1, 4 or 16)
    rc: int           # query heads a CTA
    head_chunks: int  # CTAs sharing one kv group's heads
    epl: int          # P V dims a lane (2 or 4): 32 * epl dims a CTA
    dim_chunks: int   # CTAs sharing one head's dims
    tile: int         # tokens of a warp tile (a power of two <= 16)
    stages: int       # cp.async ring depth of a warp
    smem: int         # dynamic shared memory bytes


def _align16(x: int) -> int:
    return (x + 15) & ~15


def paged_smem(dh: int, itemsize: int, rc: int, dn_max: int, tile: int,
               stages: int) -> int:
    """Dynamic shared memory of one CTA (``paged_tile.cuh`` ``layout``):
    the fp32 query, then either what the loop uses (every warp's K and V
    rings in the pool's dtype, rows padded 16 bytes, an int8 pool's
    scales, the probabilities) or, after it in the same bytes, the warps'
    partials."""
    slots = WARPS * stages * tile
    quant = itemsize == 1
    loop = (_align16(slots * (dh * itemsize + 16))
            + _align16(slots * (dn_max * itemsize + 16))
            + (2 * _align16(slots * 4) if quant else 0)
            + _align16(WARPS * rc * tile * 4))
    partials = _align16(WARPS * rc * (dn_max + 2) * 4)
    return _align16(rc * dh * 4) + max(loop, partials)


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def paged_plan(b: int, g: int, rep: int, dh: int, reach: int,
               itemsize: int, sms: int) -> PagedPlan:
    """The launch of the split-key loop for ``b`` sequences of ``g`` kv
    groups of ``rep`` query heads, head dim ``dh``, a table reach of
    ``reach`` tokens (max_blocks * block_size) and pool elements of
    ``itemsize`` bytes on a card of ``sms`` SMs: a pure function.

    A CTA takes one query head (MHA: the kernel variant whose lanes keep
    their share of the query and of P V in registers, where the row fits:
    dh up to 128 for 16-bit and int8 pools, 64 for fp32), up to 4, or up
    to 16 when rep > 4 (a larger group is shared by ``head_chunks``
    CTAs); and 64 dims of P V when dh <= 64, else 128 (``dim_chunks`` CTAs
    share a wider head).  Keys are cut into
    chunks of two warp tiles a warp (128 tokens: both in flight at once),
    one (64) when the grid would not fill the card, four (256) when it
    would be more than 16 CTAs an SM (most of them past their lane's
    length, each one a launch and a length read); at most 32 chunks, so a
    longer reach takes longer chunks.  A warp's ring holds two tiles, up
    to four for chunks of more than four tiles a warp, and its tile
    shrinks below 16 tokens only when a CTA's shared memory would pass its
    budget."""
    if min(b, g, rep, dh, reach, itemsize, sms) < 1:
        raise ValueError(
            f"paged_plan needs positive shapes, got b={b} g={g} rep={rep} "
            f"dh={dh} reach={reach} itemsize={itemsize} sms={sms}")
    epl = LANE_DIMS[0] if dh <= 32 * LANE_DIMS[0] else LANE_DIMS[1]
    dn_max = min(dh, 32 * epl)
    dim_chunks = _cdiv(dh, dn_max)
    # the one-head variant holds a lane's share of a row in registers:
    # min(epl * itemsize, 8) vectors of 16 bytes, two lanes a token
    one_head = (rep == 1 and dim_chunks == 1
                and dh * itemsize // 16 <= 2 * min(epl * itemsize, 8))
    heads = 1 if one_head else next(
        (h for h in HEAD_CAPACITIES[1:] if rep <= h), HEAD_CAPACITIES[-1])
    head_chunks = _cdiv(rep, heads)
    rc = _cdiv(rep, head_chunks)
    tile = TILE
    while tile > 1 and paged_smem(dh, itemsize, rc, dn_max, tile,
                                  2) > _SMEM_BUDGET:
        tile //= 2
    if paged_smem(dh, itemsize, rc, dn_max, tile, 2) > SMEM_MAX:
        raise ValueError(
            f"a K/V row of {dh * itemsize} bytes does not fit the kernel's "
            f"shared memory (dh={dh})")
    step = WARPS * tile
    pairs = b * g * head_chunks * dim_chunks
    unit = 2 * step
    if pairs * _cdiv(reach, unit) < sms:
        unit = step
    elif pairs * _cdiv(reach, unit) > 16 * sms:
        unit = 4 * step
    splits = max(1, min(MAX_SPLITS, _cdiv(reach, unit)))
    chunk = _cdiv(_cdiv(reach, splits), step) * step
    splits = _cdiv(reach, chunk)
    per_warp = chunk // step
    stages = 2
    while (stages < min(4, per_warp // 2) and paged_smem(
            dh, itemsize, rc, dn_max, tile, stages + 1) <= _SMEM_BUDGET):
        stages += 1
    return PagedPlan(splits, chunk, heads, rc, head_chunks, epl, dim_chunks,
                     tile, stages,
                     paged_smem(dh, itemsize, rc, dn_max, tile, stages))


def plan_for(q, k_pool, block_tables) -> PagedPlan:
    """:func:`paged_plan` for these operands on their card."""
    b, nh, dh = q.shape
    _, bs, g, _ = k_pool.shape
    return paged_plan(b, g, nh // g, dh, block_tables.shape[1] * bs,
                      k_pool.element_size(), ku.sm_count(q.device))


def pool_code(dtype: torch.dtype) -> int:
    """The C entries' code of a pool element type: a float dtype's
    ``ku.DTYPE_CODES`` entry, or :data:`POOL_INT8`."""
    if dtype == torch.int8:
        return POOL_INT8
    return ku.dtype_code(torch.empty((), dtype=dtype))


def kernel_attributes(dtype: torch.dtype, pool_dtype: torch.dtype,
                      plan: PagedPlan) -> dict:
    """What the CUDA runtime reports of row 6's kernel variant for a
    ``dtype`` query over a ``pool_dtype`` pool under ``plan``
    (``{"registers", "smem_bytes", "ctas_per_sm", "spill_bytes"}``).
    Needs the card."""
    code = ku.dtype_code(torch.empty((), dtype=dtype))
    return ku.hopper_attrs(PAGED_ATTENTION.source,
                           "apex_paged_attention_attrs", code,
                           pool_code(pool_dtype), plan.heads, plan.epl,
                           plan.smem)


def _check_paged_shapes(q, k_pool, v_pool, block_tables, lengths,
                        k_scale=None, v_scale=None):
    if q.ndim != 3:
        raise ValueError(
            f"expected q [b, num_heads, dh] (one decode token per "
            f"sequence), got {tuple(q.shape)}")
    if k_pool.ndim != 4 or v_pool.shape != k_pool.shape:
        raise ValueError(
            f"expected k/v pools [num_blocks, block_size, kv_groups, dh], "
            f"got k {tuple(k_pool.shape)} v {tuple(v_pool.shape)}")
    b, nh, dh = q.shape
    if k_pool.shape[-1] != dh:
        raise ValueError(
            f"head dim mismatch: q has {dh}, pool has {k_pool.shape[-1]}")
    g = k_pool.shape[2]
    if nh % g:
        raise ValueError(
            f"query heads ({nh}) must be a multiple of the pool's kv group "
            f"count ({g})")
    if block_tables.ndim != 2 or block_tables.shape[0] != b:
        raise ValueError(
            f"expected block_tables [b={b}, max_blocks], got "
            f"{tuple(block_tables.shape)}")
    if tuple(lengths.shape) != (b,):
        raise ValueError(f"expected lengths [b={b}], got "
                         f"{tuple(lengths.shape)}")
    quant = k_pool.dtype == torch.int8
    if quant and (k_scale is None or v_scale is None):
        raise ValueError(
            "int8 pools need k_scale/v_scale [num_blocks, block_size, "
            "kv_groups] (the block-scaled at-rest form of "
            "serving/paged_cache.py)")
    if not quant and (k_scale is not None or v_scale is not None):
        raise ValueError(
            f"k_scale/v_scale only apply to int8 pools, got pool dtype "
            f"{k_pool.dtype}")
    if quant:
        want = tuple(k_pool.shape[:3])
        if tuple(k_scale.shape) != want or tuple(v_scale.shape) != want:
            raise ValueError(
                f"expected scales {want}, got k {tuple(k_scale.shape)} "
                f"v {tuple(v_scale.shape)}")


def paged_attention_reference(q, k_pool, v_pool, block_tables, lengths, *,
                              scale: Optional[float] = None,
                              k_scale=None, v_scale=None):
    """Gather the listed blocks (an int8 pool also gathers and multiplies
    its scales, in fp32), then dense masked decode attention: fp32
    scores, positions ``>= lengths[i]`` masked, probabilities rounded to
    the gathered values' dtype before the PV product (the JAX
    reference's edges).  Unmapped table entries clamp to the last block;
    their positions lie past the length by contract and the mask hides
    them.  A lane of length 0 gives exact zeros, as the kernels do."""
    _check_paged_shapes(q, k_pool, v_pool, block_tables, lengths,
                        k_scale, v_scale)
    b, nh, dh = q.shape
    nb, bs, g, _ = k_pool.shape
    mb = block_tables.shape[1]
    scale = (1.0 / dh ** 0.5) if scale is None else float(scale)
    tbl = block_tables.long().clamp(0, nb - 1)
    k = k_pool[tbl].reshape(b, mb * bs, g, dh)
    v = v_pool[tbl].reshape(b, mb * bs, g, dh)
    if k_scale is not None:
        k = k.float() * k_scale[tbl].reshape(b, mb * bs, g)[..., None]
        v = v.float() * v_scale[tbl].reshape(b, mb * bs, g)[..., None]
    qg = q.reshape(b, g, nh // g, dh)
    s = torch.einsum("bgrd,btgd->bgrt", qg.float(), k.float()) * scale
    live = (torch.arange(mb * bs, device=q.device)[None]
            < lengths.long()[:, None])[:, None, None, :]
    s = torch.where(live, s, _NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bgrt,btgd->bgrd", p.to(v.dtype).float(), v.float())
    o = torch.where((lengths > 0)[:, None, None, None], o, 0.0)
    return o.reshape(b, nh, dh).to(q.dtype)


def check_kernel_geometry(name: str, q, k_pool) -> None:
    """What the split-key loop (``csrc/paged_tile.cuh``) takes: any
    ``num_heads`` a multiple of ``kv_groups`` (checked with the shapes)
    and ``dh`` a multiple of 16 bytes of pool elements; the pool in any
    float dtype or int8, whatever q's dtype."""
    dh = q.shape[-1]
    vec = 16 // k_pool.element_size()
    if dh % vec:
        raise ValueError(
            f"{name}: the kernel reads K/V rows in 16-byte vectors, so dh "
            f"must be a multiple of {vec} for a {k_pool.dtype} pool; got "
            f"dh={dh}")


def partials(q, k_pool, plan: PagedPlan) -> Optional[torch.Tensor]:
    """The per-call fp32 scratch of the chunks' partials (``None`` for one
    chunk): ``splits`` x ``rc`` x (dims + 2) floats for each sequence and
    (kv group, head chunk, dim chunk) block."""
    if plan.splits == 1:
        return None
    b, _, dh = q.shape
    blocks = k_pool.shape[2] * plan.head_chunks * plan.dim_chunks
    dn_max = min(dh, 32 * plan.epl)
    return torch.empty(b * blocks * plan.splits * plan.rc * (dn_max + 2),
                       dtype=torch.float32, device=q.device)


def plan_args(plan: PagedPlan) -> tuple:
    """The plan as the C entries take it."""
    return (plan.splits, plan.chunk, plan.heads, plan.rc, plan.head_chunks,
            plan.epl, plan.dim_chunks, plan.tile, plan.stages, plan.smem)


def _paged_kernel(q, k_pool, v_pool, block_tables, lengths, scale,
                  k_scale, v_scale):
    b, nh, dh = q.shape
    nb, bs, g, _ = k_pool.shape
    mb = block_tables.shape[1]
    check_kernel_geometry("ragged_paged_attention", q, k_pool)
    plan = plan_for(q, k_pool, block_tables)
    q = q.contiguous()
    tables = block_tables.to(torch.int32).contiguous()
    lens = lengths.to(torch.int32).contiguous()
    ku.check_cuda_operands("ragged_paged_attention", q, k_pool, v_pool,
                           k_scale, v_scale, tables, lens)
    ku.check_aligned("ragged_paged_attention", k_pool, v_pool)
    out = torch.empty_like(q)
    part = partials(q, k_pool, plan)   # held until the launch (K3's note)
    PAGED_ATTENTION(q.device, ku.ptr(q), ku.ptr(k_pool), ku.ptr(v_pool),
                    ku.ptr(k_scale), ku.ptr(v_scale), ku.ptr(tables),
                    ku.ptr(lens), ku.ptr(out),
                    ku.ptr(part), b, nh, dh, nb, bs, g,
                    mb,
                    scale, ku.dtype_code(q), pool_code(k_pool.dtype),
                    *plan_args(plan))
    return out


def ragged_paged_attention(q, k_pool, v_pool, block_tables, lengths, *,
                           scale: Optional[float] = None,
                           backend: Optional[str] = None,
                           k_scale=None, v_scale=None) -> torch.Tensor:
    """One decode token per sequence attends over its paged KV blocks →
    context ``[b, num_heads, dh]`` in q's dtype; kernel row 6 on the
    card.  Inference only."""
    _check_paged_shapes(q, k_pool, v_pool, block_tables, lengths,
                        k_scale, v_scale)
    dh = q.shape[-1]
    scale = (1.0 / dh ** 0.5) if scale is None else float(scale)
    if check_backend(backend) is None and on_cuda(q):
        return _paged_kernel(q, k_pool, v_pool, block_tables, lengths,
                             scale, k_scale, v_scale)
    return paged_attention_reference(q, k_pool, v_pool, block_tables,
                                     lengths, scale=scale, k_scale=k_scale,
                                     v_scale=v_scale)
