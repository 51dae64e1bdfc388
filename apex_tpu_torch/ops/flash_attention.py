"""Flash attention over BSND tensors, forward and backward
(``apex_tpu/ops/flash_attention.py``).

:func:`flash_attention` is a ``torch.autograd.Function`` that saves
``q, k, v, o`` and the forward's ``lse``.  For CUDA tensors the forward
is kernel K2 (``csrc/flash_attention.cu``: online softmax, causal, an
additive or boolean key-padding mask, grouped K/V, attention dropout and
segment ids; bf16 and fp16 on a Hopper kernel of TMA loads and ``wgmma``
products, fp32 on CUDA cores).
The backward, after ``delta = rowsum(do·o)`` in fp32 (XLA in JAX, a
torch op here), routes by the key length as the JAX ``auto`` route does:
up to
:data:`SHORT_KEYS_MAX` (512) keys it is row 5, the one-pass dq/dk/dv of
``csrc/flash_attention_bwd_short.cu`` (for bf16 and fp16 one Hopper
thread-block cluster per batch row and K/V group, :func:`short_cluster`,
that sums dq in the cluster's shared memory); above, the split pair K6
(dq) and K7 (dk/dv) of ``csrc/flash_attention_bwd.cu`` (Hopper kernels
for bf16 and fp16, as K2).  The route depends on the shape only (no
environment variable).
For CPU tensors, and under ``backend="reference"``, the forward is
:func:`flash_attention_fwd_ref` (the materialized softmax of
:func:`mha_reference`, plus its lse) and the backward
:func:`flash_attention_bwd_ref` (``p = exp(s − lse)``,
``ds = p·(dp − delta)·scale``).

Head sizes: the Hopper and fp32 kernels run on tiles 32, 64 or 128
columns wide (:func:`head_panel`); a head size that is a multiple of 8 up
to 128 is read with its real row stride, the tile's columns past it
zero-filled (by TMA for 16 bits, by guarded loads for fp32), and only
its own columns are stored; any other size up to 128 runs on a copy
zero-padded to the next multiple of 8.  Above 128 (:func:`wide_head`)
every dtype runs the wide kernels of ``csrc/flash_attention_wide.cu``
(CUDA cores, the head looped in panels of 64 columns, the output in
chunks of 256 columns a CTA), counted as branches of rows 3, 4a and 4b
of their own: the forward, and a backward that always takes the split
pair (dq, then dk/dv), whatever the key length.

Attention dropout and segment ids run in every kernel, as the JAX
kernels' ``dropout_p`` and ``has_seg`` branches do.  The keep mask is
JAX's counter hash :func:`keep_mask` of (seed, batch·heads + query head,
query row, key column), the seed :func:`seed_from_key` of the caller's
key words (a ``[2]`` tensor of ``jax.random.key_data``'s bits), kept on
the device: the kernels read it there, so a captured call replays with
new words.  The forward's row sums take the un-dropped probabilities,
the accumulator ``keep ? p/(1−p) : 0``; the backward drops dp the same
way and dv takes the dropped p.  Segment ids ``[b, s]`` (self-attention,
``sq == sk``) let a query see a key only when their ids are equal and
the key's is not negative; a tile pair whose non-negative id ranges are
disjoint is skipped (:func:`segment_ranges`, per 32 rows).

A call with a generic ``mask=`` or ``bias=``, or a ``(seg_q, seg_k)``
pair, runs :func:`mha_reference`, a torch composition that autograd
differentiates, on every device, CUDA included: the JAX package runs
its XLA composition for these calls on every device and never a Pallas
kernel, so this is the function, not a fallback from a kernel.  Its
dropout draws from the caller's key through the same counter hash.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from apex_tpu_torch.amp.patch import unpatched
from apex_tpu_torch.ops import _kernel_utils as ku
from apex_tpu_torch.utils.registry import check_backend, on_cuda

__all__ = ["flash_attention", "flash_attention_fwd", "flash_attention_bwd",
           "flash_attention_packed", "segment_ids_from_cu_seqlens",
           "flash_bwd_operands", "flash_bwd_dq", "flash_bwd_dkv",
           "flash_bwd_fused", "SHORT_KEYS_MAX", "SHORT_CLUSTER_KEYS",
           "short_cluster", "short_rank_steps", "short_resident_clusters",
           "hopper_attributes", "MAX_HEAD_DIM", "head_panel",
           "check_head_dim", "wide_head", "wide_attributes", "keep_mask",
           "keep_threshold", "dropout_keep",
           "seed_from_key", "key_words", "segment_ranges",
           "flash_attention_fwd_ref", "flash_attention_bwd_ref",
           "mha_reference"]

_NEG_INF = -1e30
_M32 = 0xFFFFFFFF

# after every entry's own arguments: the dropout seed ([1] int32 on the
# device, or NULL), the keep threshold, 1 / (1 - p), the segment ids
# ([b, s] int32, or NULL) and their per-32-row ranges
_EXTRA_ARGS = [ctypes.c_void_p, ctypes.c_uint32, ctypes.c_float,
               ctypes.c_void_p, ctypes.c_void_p]
_FWD_ARGS = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 6
             + [ctypes.c_float, ctypes.c_int, ctypes.c_int] + _EXTRA_ARGS)
_BWD_ARGS = ([ctypes.c_int] * 6 + [ctypes.c_float, ctypes.c_int,
                                   ctypes.c_int] + _EXTRA_ARGS)

FLASH_FWD = ku.register(ku.Kernel(
    "flash_attention_fwd", "flash_attention.cu", "apex_flash_fwd",
    _FWD_ARGS, replaces="apex_tpu/ops/flash_attention.py:191"))

FLASH_BWD_DQ = ku.register(ku.Kernel(
    "flash_attention_bwd_dq", "flash_attention_bwd.cu", "apex_flash_bwd_dq",
    [ctypes.c_void_p] * 8 + _BWD_ARGS,
    replaces="apex_tpu/ops/flash_attention.py:375"))

FLASH_BWD_DKV = ku.register(ku.Kernel(
    "flash_attention_bwd_dkv", "flash_attention_bwd.cu", "apex_flash_bwd_dkv",
    [ctypes.c_void_p] * 9 + _BWD_ARGS,
    replaces="apex_tpu/ops/flash_attention.py:452"))

FLASH_BWD_SHORT = ku.register(ku.Kernel(
    "flash_attention_bwd_short", "flash_attention_bwd_short.cu",
    "apex_flash_bwd_short", [ctypes.c_void_p] * 11 + _BWD_ARGS,
    replaces="apex_tpu/ops/flash_attention.py:551"))

# head sizes above MAX_HEAD_DIM: branches of rows 3, 4a and 4b
FLASH_FWD_WIDE = ku.register(ku.Kernel(
    "flash_attention_fwd_wide", "flash_attention_wide.cu",
    "apex_flash_fwd_wide", _FWD_ARGS,
    replaces="apex_tpu/ops/flash_attention.py:191"))

FLASH_BWD_DQ_WIDE = ku.register(ku.Kernel(
    "flash_attention_bwd_dq_wide", "flash_attention_wide.cu",
    "apex_flash_bwd_dq_wide", [ctypes.c_void_p] * 8 + _BWD_ARGS,
    replaces="apex_tpu/ops/flash_attention.py:375"))

FLASH_BWD_DKV_WIDE = ku.register(ku.Kernel(
    "flash_attention_bwd_dkv_wide", "flash_attention_wide.cu",
    "apex_flash_bwd_dkv_wide", [ctypes.c_void_p] * 9 + _BWD_ARGS,
    replaces="apex_tpu/ops/flash_attention.py:452"))

# the JAX auto route's crossover (APEX_TPU_FLASH_BWD_FUSED_MAX default)
SHORT_KEYS_MAX = 512
# row 5's 16-bit kernel: keys per cluster rank, and the most keys its
# largest (portable) cluster of 8 ranks holds
_SHORT_RANK_KEYS = 128
SHORT_CLUSTER_KEYS = 8 * _SHORT_RANK_KEYS


# the largest head size the tiled kernels take: their tiles are 32, 64 or
# 128 columns wide (HEAD_PANELS), a head padded up to the next one; wider
# heads run the wide kernels
MAX_HEAD_DIM = 128
HEAD_PANELS = (32, 64, 128)
# granule of segment_ranges (every kernel tile is a multiple of it)
SEG_GRANULE = 32


def wide_head(d: int) -> bool:
    """Whether head size ``d`` runs the wide kernels (above
    :data:`MAX_HEAD_DIM`)."""
    return d > MAX_HEAD_DIM


def head_panel(d: int) -> int:
    """The tile width the tiled kernels run head size ``d`` on: the
    smallest of :data:`HEAD_PANELS` that holds it (``sm90::head_panel``);
    columns past ``d`` are zeros the kernels never store.  Raises above
    :data:`MAX_HEAD_DIM`: those heads run the wide kernels."""
    check_head_dim(d)
    if wide_head(d):
        raise ValueError(
            f"head dim {d}: the tiles are 1 to {MAX_HEAD_DIM} columns wide; "
            "wider heads run the wide kernels (flash_attention_wide.cu)")
    return next(p for p in HEAD_PANELS if d <= p)


def check_head_dim(d: int) -> None:
    """Raises for a head size no kernel takes (below 1)."""
    if d < 1:
        raise ValueError(f"flash kernel head dim {d}: expected at least 1")


def short_cluster(sk: int, d: int) -> Tuple[int, int]:
    """``(cluster ranks, query tile rows)`` of row 5's 16-bit kernel: one
    rank per 128 keys (two consumer warpgroups of 64 keys each), query
    tiles of 64 rows, or 32 on 128-column tiles (``d`` above 64) where the
    fp32 dK and dV accumulators of 64 keys take 128 registers a thread.
    Causality changes neither (:func:`short_rank_steps`)."""
    if not 0 < sk <= SHORT_CLUSTER_KEYS:
        raise ValueError(f"row 5's cluster holds 1 to {SHORT_CLUSTER_KEYS} "
                         f"keys, got {sk}")
    return -(-sk // _SHORT_RANK_KEYS), 32 if head_panel(d) == 128 else 64


def short_rank_steps(sq: int, sk: int, n: int, g: int, d: int,
                     causal: bool) -> list:
    """Per cluster rank of row 5's 16-bit kernel, ``[warpgroup 0,
    warpgroup 1]``: the (head, query tile) steps whose products each runs.
    The keys come in ``2R`` tiles of 64; rank ``r``'s warpgroup 0 holds
    tile ``r`` and warpgroup 1 tile ``2R - 1 - r``, so that under
    causality (a key tile sees the query tiles from its first key on)
    every rank has one early and one late tile and the ranks' work evens
    out.  Every rank takes part in all ``n / g · ceil(sq / tile)`` steps'
    dq sums."""
    ranks, bq = short_cluster(sk, d)
    nqt = -(-sq // bq)
    half = _SHORT_RANK_KEYS // 2

    def seen(tile):
        return nqt - (min(tile * half // bq, nqt) if causal else 0)

    return [[(n // g) * seen(r), (n // g) * seen(2 * ranks - 1 - r)]
            for r in range(ranks)]


def hopper_attributes(dtype: torch.dtype = torch.bfloat16, d: int = 64,
                      extras: bool = False) -> dict:
    """What the driver reports for the 16-bit Hopper kernels of K2, K6,
    K7 and row 5 at head size ``d``, the instantiation without (or, with
    ``extras``, with) segment ids or dropout: ``{kernel: {"registers",
    "smem_bytes", "ctas_per_sm", "spill_bytes"}}`` (registers per thread
    at launch, dynamic plus static shared memory per CTA, resident CTAs
    per SM, local memory per thread).  Needs the card."""
    code = ku.dtype_code(torch.empty((), dtype=dtype))
    return {kern.name: ku.hopper_attrs(kern.source, symbol, *lead, code, d,
                                       int(extras))
            for kern, symbol, lead in (
                (FLASH_FWD, "apex_flash_fwd_attrs", ()),
                (FLASH_BWD_DQ, "apex_flash_bwd_attrs", (0,)),
                (FLASH_BWD_DKV, "apex_flash_bwd_attrs", (1,)),
                (FLASH_BWD_SHORT, "apex_flash_bwd_short_attrs", ()))}


def wide_attributes(dtype: torch.dtype = torch.bfloat16) -> dict:
    """``{kernel: {"registers", "smem_bytes", "ctas_per_sm",
    "spill_bytes"}}`` of the three wide kernels for ``dtype``.  Needs the
    card."""
    code = ku.dtype_code(torch.empty((), dtype=dtype))
    return {kern.name: ku.hopper_attrs(kern.source, "apex_flash_wide_attrs",
                                       which, code)
            for which, kern in enumerate((FLASH_FWD_WIDE, FLASH_BWD_DQ_WIDE,
                                          FLASH_BWD_DKV_WIDE))}


def short_resident_clusters(sk: int, d: int,
                            dtype: torch.dtype = torch.bfloat16) -> int:
    """How many of row 5's clusters (:func:`short_cluster` ranks for
    ``sk`` keys) the card holds at once, as the CUDA runtime reports: the
    width of one wave of the launch.  Needs the card."""
    ranks, _ = short_cluster(sk, d)
    out = ctypes.c_int(0)
    err = ku.library(FLASH_BWD_SHORT.source).apex_flash_bwd_short_clusters(
        ctypes.c_int(ku.dtype_code(torch.empty((), dtype=dtype))),
        ctypes.c_int(d), ctypes.c_int(ranks), ctypes.byref(out))
    if err != 0:
        raise RuntimeError(f"apex_flash_bwd_short_clusters: cudaError {err}")
    return out.value


# ---------------------------------------------------------------------------
# the dropout hash and its seed (flash_attention.py:102-122, :988-995)
# ---------------------------------------------------------------------------


def keep_threshold(dropout_p: float) -> int:
    """The uint32 a hash is kept under: ``min(round(keep·2³²), 2³²−1)``
    with ``keep = 1 − dropout_p``, as the JAX ``_keep_mask`` computes it
    (Python's ``round`` on a float64)."""
    keep_prob = 1.0 - float(dropout_p)
    return min(int(round(keep_prob * 4294967296.0)), 4294967295)


def _i32(c: int) -> int:
    """A uint32 constant as the int32 of the same bits."""
    return c - (1 << 32) if c >= 1 << 31 else c


def _shr(h, n: int):
    """Logical right shift of int32 tensors holding uint32 bits."""
    return (h >> n) & ((1 << (32 - n)) - 1)


def keep_mask(seed, bh, row, col, dropout_p: float):
    """The JAX ``_keep_mask`` counter hash, operation for operation in
    uint32 arithmetic (int32 tensors: products wrap to their low 32 bits
    as uint32 products do, shifts are made logical and the threshold
    compare unsigned): ``seed`` an int32 tensor (its bits), ``bh``, ``row``
    and ``col`` integer tensors or ints that broadcast (batch·heads +
    query head, the global query row and key column) → bool, True =
    kept.  The terms of ``bh`` and ``row`` are mixed before ``col``
    broadcasts them out, so the full-size work is the last seven
    operations."""
    s = torch.as_tensor(seed).to(torch.int32)

    def i32(x):
        return torch.as_tensor(x, device=s.device).to(torch.int32)

    bh, row, col = (i32(x) for x in (bh, row, col))
    h = s + bh * _i32(0x9E3779B1)
    h = h ^ (row * _i32(0x85EBCA77))
    h = h ^ _shr(h, 16)
    h = h * _i32(0x7FEB352D)
    h = h ^ (col * _i32(0xC2B2AE3D))
    h = h ^ _shr(h, 16)
    h = h * _i32(0x85EBCA6B)
    h = h ^ _shr(h, 13)
    h = h * _i32(0xC2B2AE35)
    h = h ^ _shr(h, 16)
    # unsigned h < threshold as a signed compare with both sign bits flipped
    return (h ^ _i32(0x80000000)) < keep_threshold(dropout_p) - (1 << 31)


def key_words(rng, device) -> torch.Tensor:
    """A key's data words (``jax.random.key_data``'s uint32 bits: a
    sequence, a numpy array or a tensor of any integer dtype) → an int64
    tensor of uint32 values on ``device``; a tensor stays where it is
    when it is on ``device`` already (no host read)."""
    if torch.is_tensor(rng):
        w = rng.to(device=device)
    else:
        w = torch.as_tensor(np.asarray(rng).astype(np.int64), device=device)
    return w.reshape(-1).to(torch.int64) & _M32


def seed_from_key(rng, device=None) -> torch.Tensor:
    """``_seed_from_rng``: the key's last word XOR its second-to-last
    times 0x9E3779B1 (uint32) → a ``[1]`` int32 tensor (its bits), on the
    device of ``rng`` (or ``device``)."""
    if device is None:
        device = rng.device if torch.is_tensor(rng) else "cpu"
    w = key_words(rng, device)
    w = torch.where(w >= 1 << 31, w - (1 << 32), w).to(torch.int32)
    seed = w[-1:]
    if w.shape[0] > 1:
        seed = seed ^ (w[-2:-1] * _i32(0x9E3779B1))
    return seed


def dropout_keep(shape, seed, dropout_p: float, device, row0: int = 0):
    """The keep mask of a tensor of ``shape`` viewed as ``[B, R, C]`` (the
    leading axes flattened, then the last two), keyed by ``seed`` (the
    ``[1]`` int32 of :func:`seed_from_key`): :func:`keep_mask` of (seed,
    the flat leading index, ``row0 +`` the row, the column).  For scores
    ``[b, n, sq, sk]`` these are the kernels' coordinates (``bh = batch·n
    + head``, global query rows from ``row0`` and key columns); the train
    steps' hidden and drop-path masks use the same layout."""
    shape = tuple(shape)
    bh = torch.arange(math.prod(shape[:-2]), device=device)[:, None, None]
    row = torch.arange(row0, row0 + shape[-2], device=device)[None, :, None]
    col = torch.arange(shape[-1], device=device)[None, None, :]
    return keep_mask(torch.as_tensor(seed).to(device), bh, row, col,
                     dropout_p).reshape(shape)


# ---------------------------------------------------------------------------
# segment ids
# ---------------------------------------------------------------------------


def segment_ids_from_cu_seqlens(cu_seqlens, total: int) -> torch.Tensor:
    """``[b+1]`` cumulative sequence starts → ``[total]`` int32 segment
    ids; positions at or past ``cu_seqlens[-1]`` get −1 (padding, masked
    as keys)."""
    cu = torch.as_tensor(cu_seqlens).to(torch.int32)
    pos = torch.arange(total, dtype=torch.int32, device=cu.device)
    seg = torch.searchsorted(cu, pos, right=True).to(torch.int32) - 1
    n_seq = cu.shape[0] - 1
    return torch.where(seg >= n_seq, -1, seg).to(torch.int32)


def segment_ranges(seg: torch.Tensor) -> torch.Tensor:
    """``[b, s]`` int32 ids → ``[b, ceil(s / 32), 4]`` int32: each 32-row
    granule's least and greatest non-negative id ((2³¹−1, −2³¹) when it
    has none), the id all its rows hold (−1 unless one non-negative id),
    and 0.  A query tile and a key tile share a visible pair only if their
    ranges overlap, so the kernels skip the pair otherwise (the
    block-sparse skip of ``flash_attention.py:261-270``); a pair whose
    granules all hold one id is open throughout, so they skip the
    per-element test."""
    b, s = seg.shape
    gcount = -(-s // SEG_GRANULE)
    x = F.pad(seg.to(torch.int32), (0, gcount * SEG_GRANULE - s),
              value=-1).reshape(b, gcount, SEG_GRANULE)
    in_row = (torch.arange(gcount * SEG_GRANULE, device=seg.device)
              < s).reshape(gcount, SEG_GRANULE)
    valid = x >= 0
    big = torch.full((), 2 ** 31 - 1, dtype=torch.int32, device=seg.device)
    small = torch.full((), -2 ** 31, dtype=torch.int32, device=seg.device)
    lo = torch.where(valid, x, big).amin(-1)
    hi = torch.where(valid, x, small).amax(-1)
    mixed = (lo != hi) | (~valid & in_row).any(-1)
    uni = torch.where(mixed, torch.full_like(lo, -1), lo)
    return torch.stack([lo, hi, uni, torch.zeros_like(lo)], -1).contiguous()


def _seg_pair(segment_ids):
    """``segment_ids`` → ``(seg_q, seg_k)`` int32."""
    if isinstance(segment_ids, tuple):
        return tuple(torch.as_tensor(x).to(torch.int32)
                     for x in segment_ids)
    seg = torch.as_tensor(segment_ids).to(torch.int32)
    return seg, seg


# ---------------------------------------------------------------------------
# the plain versions
# ---------------------------------------------------------------------------


def _additive_kpm(key_padding_mask: torch.Tensor) -> torch.Tensor:
    """bool (True = masked) → additive fp32 -1e30 / 0, as the JAX wrapper
    feeds its kernel."""
    if key_padding_mask.dtype == torch.bool:
        zero = torch.zeros((), dtype=torch.float32,
                           device=key_padding_mask.device)
        return torch.where(key_padding_mask, _NEG_INF, zero)
    return key_padding_mask.float()


def _repeat_kv(q, k, v):
    if k.shape[2] != q.shape[2]:
        rep = q.shape[2] // k.shape[2]
        k = k.repeat_interleave(rep, dim=2)
        v = v.repeat_interleave(rep, dim=2)
    return k, v


def _scores(q, k, *, causal, key_padding_mask, mask, bias, scale,
            segment_ids=None, q_offset=0):
    """Masked fp32 scores ``[b, n, sq, sk]`` (k already at q's heads; the
    query rows at global positions ``q_offset`` on)."""
    sq, sk = q.shape[1], k.shape[1]
    s = torch.einsum("bsnd,btnd->bnst", q.float(), k.float()) * scale
    if bias is not None:
        s = s + bias.float()
    if mask is not None:
        s = s.masked_fill(mask, _NEG_INF)
    if segment_ids is not None:
        seg_q, seg_k = (x.to(q.device) for x in _seg_pair(segment_ids))
        blocked = (seg_q[:, None, :, None] != seg_k[:, None, None, :]) | (
            seg_k < 0)[:, None, None, :]
        s = s.masked_fill(blocked, _NEG_INF)
    if key_padding_mask is not None:
        if key_padding_mask.dtype == torch.bool:
            s = s.masked_fill(key_padding_mask[:, None, None, :], _NEG_INF)
        else:
            s = s + key_padding_mask[:, None, None, :].float()
    if causal:
        row = torch.arange(q_offset, q_offset + sq, device=q.device)[:, None]
        col = torch.arange(sk, device=q.device)[None]
        s = s.masked_fill((col > row)[None, None], _NEG_INF)
    return s


def _fwd_plain(q, k, v, *, causal, key_padding_mask, mask, bias, scale,
               segment_ids=None, dropout_p=0.0, seed=None, q_offset=0):
    b, sq, n, _ = q.shape
    k, v = _repeat_kv(q, k, v)
    s = _scores(q, k, causal=causal, key_padding_mask=key_padding_mask,
                mask=mask, bias=bias, scale=scale, segment_ids=segment_ids,
                q_offset=q_offset)
    p = torch.softmax(s, dim=-1)
    any_open = torch.amax(s, dim=-1, keepdim=True) > _NEG_INF / 2
    p = torch.where(any_open, p, 0.0)
    if seed is not None:
        keep = dropout_keep((b, n, sq, k.shape[1]), seed, dropout_p,
                            q.device, q_offset)
        p = torch.where(keep, p / (1.0 - dropout_p), 0.0)
    o = torch.einsum("bnst,btnd->bsnd", p.to(v.dtype).float(), v.float())
    lse = torch.where(any_open, torch.logsumexp(s, dim=-1, keepdim=True),
                      _NEG_INF)
    return o.to(q.dtype), lse


def mha_reference(q, k, v, *, causal: bool = False, key_padding_mask=None,
                  mask=None, bias=None, scale: Optional[float] = None,
                  dropout_p: float = 0.0, dropout_rng=None,
                  segment_ids=None):
    """Materialized softmax(QK^T)V in fp32 with the kernel's masks and
    sentinels: grouped K/V broadcast up to the query heads, scores in
    fp32, fully masked rows give 0, probabilities rounded to V's dtype
    before the PV product.  ``segment_ids`` is ``[b, s]`` or a ``(seg_q,
    seg_k)`` pair; dropout (with ``dropout_rng``, a key's words) keeps a
    probability where :func:`keep_mask` of the key's seed does, scaled by
    ``1/(1-p)``."""
    scale = (1.0 / q.shape[-1] ** 0.5) if scale is None else scale
    seed = (seed_from_key(dropout_rng, q.device)
            if dropout_p > 0.0 and dropout_rng is not None else None)
    return _fwd_plain(q, k, v, causal=causal,
                      key_padding_mask=key_padding_mask, mask=mask,
                      bias=bias, scale=scale, segment_ids=segment_ids,
                      dropout_p=dropout_p, seed=seed)[0]


def flash_attention_fwd_ref(q, k, v, *, causal: bool = False,
                            key_padding_mask=None,
                            scale: Optional[float] = None,
                            dropout_p: float = 0.0, seed=None,
                            segment_ids=None, q_offset: int = 0
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`mha_reference` plus its lse ``[b·n, sq]`` fp32 (-1e30 on
    fully masked rows): the plain version of :func:`flash_attention_fwd`
    (``seed`` the ``[1]`` int32 of :func:`seed_from_key`, or None).
    ``q`` may be a block of a call's query rows that starts at row
    ``q_offset`` (``segment_ids`` then a ``(seg_q, seg_k)`` pair): the
    causal mask and the dropout hash take global rows, so the blocks of a
    call give its rows, for a plain version computed in pieces."""
    b, sq, n, d = q.shape
    scale = (1.0 / d ** 0.5) if scale is None else float(scale)
    o, lse = _fwd_plain(q, k, v, causal=causal,
                        key_padding_mask=key_padding_mask, mask=None,
                        bias=None, scale=scale, segment_ids=segment_ids,
                        dropout_p=dropout_p, seed=seed, q_offset=q_offset)
    return o, lse.reshape(b * n, sq)


def flash_attention_bwd_ref(q, k, v, o, lse, do, *, causal: bool = False,
                            key_padding_mask=None,
                            scale: Optional[float] = None,
                            dropout_p: float = 0.0, seed=None,
                            segment_ids=None, q_offset: int = 0):
    """Materialized backward from the saved lse, in fp32: ``p = exp(s −
    lse)`` (0 where masked or on -1e30 rows), ``ds = p·(dp − delta)·
    scale`` with ``delta = rowsum(do·o)``; under dropout dp and the p of
    dv are dropped and scaled as the JAX kernels do; grouped dk/dv summed
    over each group's heads.  Returns ``(dq, dk, dv)`` in the inputs'
    dtypes.  A block of query rows from ``q_offset`` (with its o, lse and
    do) gives that block's dq and its part of dk and dv, as in
    :func:`flash_attention_fwd_ref`."""
    b, sq, n, d = q.shape
    g = k.shape[2]
    scale = (1.0 / d ** 0.5) if scale is None else float(scale)
    kf, vf = _repeat_kv(q, k.float(), v.float())
    s = _scores(q, kf, causal=causal, key_padding_mask=key_padding_mask,
                mask=None, bias=None, scale=scale, segment_ids=segment_ids,
                q_offset=q_offset)
    lse4 = lse.reshape(b, n, sq, 1)
    open_ = (s > _NEG_INF / 2) & (lse4 > _NEG_INF / 2)
    p = torch.where(open_, torch.exp(s - lse4), 0.0)
    dof = do.float()
    dp = torch.einsum("bsnd,btnd->bnst", dof, vf)
    p_acc = p
    if seed is not None:
        keep = dropout_keep((b, n, sq, kf.shape[1]), seed, dropout_p,
                            q.device, q_offset)
        inv = 1.0 / (1.0 - dropout_p)
        p_acc = torch.where(keep, p * inv, 0.0)
        dp = torch.where(keep, dp * inv, 0.0)
    delta = (dof * o.float()).sum(-1).permute(0, 2, 1)[..., None]
    ds = p * (dp - delta) * scale
    dq = torch.einsum("bnst,btnd->bsnd", ds, kf)
    dk = torch.einsum("bnst,bsnd->btnd", ds, q.float())
    dv = torch.einsum("bnst,bsnd->btnd", p_acc, dof)
    if g != n:
        sk = k.shape[1]
        dk = dk.reshape(b, sk, g, n // g, d).sum(3)
        dv = dv.reshape(b, sk, g, n // g, d).sum(3)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


# ---------------------------------------------------------------------------
# the kernels
# ---------------------------------------------------------------------------


def _check(q, k, v):
    if q.ndim != 4:
        raise ValueError(f"expected [b, s, n, d], got {tuple(q.shape)}")
    if v.shape != k.shape:
        raise ValueError(
            f"K/V shapes differ: {tuple(k.shape)} vs {tuple(v.shape)}")
    if q.shape[2] % k.shape[2]:
        raise ValueError(
            f"query heads ({q.shape[2]}) must be a multiple of the K/V "
            f"group count ({k.shape[2]})")


def _kernel_operands(q, k, v, key_padding_mask, scale):
    """Checks shared by K2, K6, K7 and row 5; returns (kpm, scale), the
    scale 1/sqrt(d) of the real head size ``d``."""
    _check(q, k, v)
    b, sq, n, d = q.shape
    sk = k.shape[1]
    check_head_dim(d)
    if k.dtype != q.dtype:
        raise TypeError(f"q is {q.dtype} but K/V are {k.dtype}")
    scale = (1.0 / d ** 0.5) if scale is None else float(scale)
    kpm = (None if key_padding_mask is None
           else _additive_kpm(key_padding_mask).contiguous())
    if kpm is not None and kpm.shape != (b, sk):
        raise ValueError(f"key_padding_mask {tuple(kpm.shape)}, want "
                         f"{(b, sk)}")
    return kpm, scale


def _extras(q, k, dropout_p, seed, segment_ids) -> dict:
    """The kernels' trailing arguments: the seed tensor, the keep
    threshold and 1/(1-p) (dropout off: no seed), and the segment ids
    with their :func:`segment_ranges`."""
    b, sq = q.shape[0], q.shape[1]
    ex = dict(seed=None, threshold=0, inv_keep=1.0, seg=None, ranges=None)
    if seed is not None and dropout_p > 0.0:
        ex.update(seed=seed.to(torch.int32).contiguous(),
                  threshold=keep_threshold(dropout_p),
                  inv_keep=1.0 / (1.0 - dropout_p))
    if segment_ids is not None:
        seg = torch.as_tensor(segment_ids).to(torch.int32).contiguous()
        if seg.shape != (b, sq) or k.shape[1] != sq:
            raise ValueError(
                f"segment_ids {tuple(seg.shape)}: the kernels take [b, s] "
                f"= {(b, sq)} ids of self-attention (sq == sk)")
        ex.update(seg=seg, ranges=segment_ranges(seg))
    return ex


def _extra_args(ex: dict) -> tuple:
    return (ku.ptr(ex["seed"]), ctypes.c_uint32(ex["threshold"]),
            ctypes.c_float(ex["inv_keep"]), ku.ptr(ex["seg"]),
            ku.ptr(ex["ranges"]))


def _pad_head(*ts):
    """The operands with their head dim zero-padded to a multiple of 8
    (a TMA row stride is a multiple of 16 bytes): a copy only where ``d``
    is not one already.  Zero columns add nothing to a score, and the
    output's extra columns are sliced off."""
    d = ts[0].shape[-1]
    pad = -d % 8
    return tuple(None if t is None
                 else F.pad(t, (0, pad)) if pad else t.contiguous()
                 for t in ts)


def flash_attention_fwd(q, k, v, *, causal: bool = False,
                        key_padding_mask=None,
                        scale: Optional[float] = None,
                        dropout_p: float = 0.0, seed=None, segment_ids=None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel K2 on CUDA tensors (the wide branch above
    :data:`MAX_HEAD_DIM`) → ``(o [b, sq, n, d] in q's dtype, lse [b·n,
    sq] fp32)``; fully masked rows get o = 0, lse = -1e30.  ``seed`` (a
    ``[1]`` int32 device tensor) turns dropout on at ``dropout_p``;
    ``segment_ids`` ``[b, s]`` int32."""
    kpm, scale = _kernel_operands(q, k, v, key_padding_mask, scale)
    b, sq, n, d = q.shape
    sk, g = k.shape[1], k.shape[2]
    ex = _extras(q, k, dropout_p, seed, segment_ids)
    wide = wide_head(d)
    q, k, v = (t.contiguous() for t in (q, k, v)) if wide \
        else _pad_head(q, k, v)
    ku.check_cuda_operands("flash_attention", q, k, v, kpm, ex["seed"],
                           ex["seg"], ex["ranges"])
    ku.check_aligned("flash_attention", q, k, v)
    o = torch.empty_like(q)
    lse = torch.empty(b * n, sq, dtype=torch.float32, device=q.device)
    kernel = FLASH_FWD_WIDE if wide else FLASH_FWD
    kernel(q.device, ku.ptr(q), ku.ptr(k), ku.ptr(v), ku.ptr(kpm),
           ku.ptr(o), ku.ptr(lse), b, sq, sk, n, g, q.shape[-1], scale,
           int(causal), ku.dtype_code(q), *_extra_args(ex))
    return o[..., :d], lse


def flash_bwd_operands(q, k, v, o, lse, do, *, key_padding_mask=None,
                       scale: Optional[float] = None,
                       dropout_p: float = 0.0, seed=None,
                       segment_ids=None) -> dict:
    """Checked, contiguous operands of K6, K7 and row 5 (and the wide
    pair), with ``delta = rowsum(do·o)`` ``[b·n, sq]`` fp32 (XLA in JAX,
    a torch op here); a head size up to 128 that is not a multiple of 8
    is zero-padded to one (``d`` keeps the real size, and the gradients
    are sliced back to it)."""
    kpm, scale = _kernel_operands(q, k, v, key_padding_mask, scale)
    b, sq, n, d = q.shape
    do = do.to(q.dtype)
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2).reshape(
        b * n, sq).contiguous()
    ex = _extras(q, k, dropout_p, seed, segment_ids)
    if wide_head(d):
        q, k, v, do = (t.contiguous() for t in (q, k, v, do))
    else:
        q, k, v, do = _pad_head(q, k, v, do)
    lse = lse.contiguous()
    ku.check_cuda_operands("flash_attention backward", q, k, v, do, lse,
                           delta, kpm, ex["seed"], ex["seg"], ex["ranges"])
    ku.check_aligned("flash_attention backward", q, k, v, do)
    if lse.shape != (b * n, sq) or lse.dtype != torch.float32:
        raise ValueError(f"lse {tuple(lse.shape)} {lse.dtype}, want "
                         f"{(b * n, sq)} float32")
    return dict(q=q, k=k, v=v, do=do, lse=lse, delta=delta, kpm=kpm,
                scale=scale, d=d, extras=ex)


def _bwd_tail(ops, causal):
    q, k = ops["q"], ops["k"]
    b, sq, n, d = q.shape
    return (b, sq, k.shape[1], n, k.shape[2], d, ops["scale"], int(causal),
            ku.dtype_code(q), *_extra_args(ops["extras"]))


def flash_bwd_dq(ops: dict, *, causal: bool) -> torch.Tensor:
    """Kernel K6 (the wide branch above :data:`MAX_HEAD_DIM`) on
    :func:`flash_bwd_operands` → dq like q."""
    dq = torch.empty_like(ops["q"])
    kernel = FLASH_BWD_DQ_WIDE if wide_head(ops["d"]) else FLASH_BWD_DQ
    kernel(dq.device, *(ku.ptr(ops[n]) for n in (
        "q", "k", "v", "do", "lse", "delta", "kpm")), ku.ptr(dq),
        *_bwd_tail(ops, causal))
    return dq[..., :ops["d"]]


def flash_bwd_dkv(ops: dict, *, causal: bool):
    """Kernel K7 (the wide branch above :data:`MAX_HEAD_DIM`) on
    :func:`flash_bwd_operands` → (dk, dv) like k, each group's query
    heads summed into its row."""
    dk, dv = torch.empty_like(ops["k"]), torch.empty_like(ops["v"])
    kernel = FLASH_BWD_DKV_WIDE if wide_head(ops["d"]) else FLASH_BWD_DKV
    kernel(dk.device, *(ku.ptr(ops[n]) for n in (
        "q", "k", "v", "do", "lse", "delta", "kpm")), ku.ptr(dk), ku.ptr(dv),
        *_bwd_tail(ops, causal))
    return dk[..., :ops["d"]], dv[..., :ops["d"]]


def flash_bwd_fused(ops: dict, *, causal: bool):
    """Kernel row 5 on :func:`flash_bwd_operands` → ``(dq, dk, dv)``: one
    pass over the (key tile, query tile) pairs.  bf16/fp16: one launch of
    the cluster kernel (up to :data:`SHORT_CLUSTER_KEYS` keys), dq summed
    across the cluster in shared memory.  fp32: dq summed from fp32
    per-key-tile partials in a second fixed-order pass."""
    q, k = ops["q"], ops["k"]
    b, sq, n, d = q.shape
    part = None
    if q.dtype == torch.float32:
        # one fp32 dq partial per 64-key tile (the kernel's tile rows), as
        # wide as the kernel's tiles
        nkt, sqp = -(-k.shape[1] // 64), -(-sq // 64) * 64
        part = torch.empty(nkt, b * n, sqp, head_panel(d),
                           dtype=torch.float32, device=q.device)
    else:
        short_cluster(k.shape[1], d)   # raises past the largest cluster
    dq = torch.empty_like(q)
    dk, dv = torch.empty_like(k), torch.empty_like(ops["v"])
    FLASH_BWD_SHORT(dq.device, *(ku.ptr(ops[name]) for name in (
        "q", "k", "v", "do", "lse", "delta", "kpm")), ku.ptr(part),
        ku.ptr(dq), ku.ptr(dk), ku.ptr(dv), *_bwd_tail(ops, causal))
    d = ops["d"]
    return dq[..., :d], dk[..., :d], dv[..., :d]


def flash_attention_bwd(q, k, v, o, lse, do, *, causal: bool = False,
                        key_padding_mask=None,
                        scale: Optional[float] = None,
                        dropout_p: float = 0.0, seed=None, segment_ids=None):
    """The backward on CUDA tensors, from K2's ``o`` and ``lse [b·n,
    sq]`` → ``(dq, dk, dv)`` in the inputs' dtypes: above
    :data:`MAX_HEAD_DIM` the wide pair (dq, then dk/dv); else row 5 for
    key lengths up to :data:`SHORT_KEYS_MAX`, K6 (dq) and K7 (dk, dv)
    above."""
    ops = flash_bwd_operands(q, k, v, o, lse, do,
                             key_padding_mask=key_padding_mask, scale=scale,
                             dropout_p=dropout_p, seed=seed,
                             segment_ids=segment_ids)
    if not wide_head(q.shape[-1]) and k.shape[1] <= SHORT_KEYS_MAX:
        return flash_bwd_fused(ops, causal=causal)
    return (flash_bwd_dq(ops, causal=causal),
            *flash_bwd_dkv(ops, causal=causal))


class _Flash(torch.autograd.Function):
    """Attention saving ``(q, k, v, o, lse)``; the key-padding row, the
    segment ids and the seed are constants (no gradient), as the JAX
    wrapper stop-gradients them."""

    @staticmethod
    def forward(ctx, q, k, v, kpm, seg, seed, causal, scale, dropout_p,
                plain):
        fwd = flash_attention_fwd_ref if plain else flash_attention_fwd
        o, lse = fwd(q, k, v, causal=causal, key_padding_mask=kpm,
                     scale=scale, dropout_p=dropout_p, seed=seed,
                     segment_ids=seg)
        ctx.save_for_backward(q, k, v, o, lse, kpm, seg, seed)
        ctx.causal, ctx.scale, ctx.plain = causal, scale, plain
        ctx.dropout_p = dropout_p
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse, kpm, seg, seed = ctx.saved_tensors
        bwd = flash_attention_bwd_ref if ctx.plain else flash_attention_bwd
        dq, dk, dv = bwd(q, k, v, o, lse, do, causal=ctx.causal,
                         key_padding_mask=kpm, scale=ctx.scale,
                         dropout_p=ctx.dropout_p, seed=seed,
                         segment_ids=seg)
        return dq, dk, dv, None, None, None, None, None, None, None


@unpatched
def flash_attention(q, k, v, *, causal: bool = False,
                    key_padding_mask=None, mask=None, bias=None,
                    scale: Optional[float] = None, dropout_p: float = 0.0,
                    dropout_rng=None, segment_ids=None,
                    backend: Optional[str] = None) -> torch.Tensor:
    """Differentiable attention over ``[b, s, n, d]`` tensors;
    ``key_padding_mask`` ``[b, sk]`` is bool (True = masked) or additive
    float.  K/V may carry fewer heads than Q (GQA), read by index, never
    repeated.  ``dropout_p`` with ``dropout_rng`` (a key's data words,
    ``[2]``) drops attention probabilities in-kernel; ``segment_ids``
    ``[b, s]`` int (sq == sk) keeps attention within each segment,
    negative ids matching nothing.  With ``mask=``, ``bias=`` or a
    ``(seg_q, seg_k)`` pair the call runs the torch composition
    :func:`mha_reference` on any device, as the JAX package runs its XLA
    composition."""
    _check(q, k, v)
    seg_pair = isinstance(segment_ids, tuple)
    if segment_ids is not None and not seg_pair and q.shape[1] != k.shape[1]:
        raise ValueError(
            "a single segment_ids array requires sq == sk (packed "
            "self-attention rows); pass a (seg_q, seg_k) pair for "
            "cross-attention shapes")
    plain = check_backend(backend) is not None or not on_cuda(q)
    use_dropout = dropout_p > 0.0 and dropout_rng is not None
    if mask is not None or bias is not None or seg_pair:
        # the JAX package's route on every device (flash_attention.py:
        # 1050-1062): the materialized composition, never a kernel
        return mha_reference(q, k, v, causal=causal,
                             key_padding_mask=key_padding_mask, mask=mask,
                             bias=bias, scale=scale,
                             dropout_p=dropout_p if use_dropout else 0.0,
                             dropout_rng=dropout_rng,
                             segment_ids=segment_ids)
    scale = (1.0 / q.shape[-1] ** 0.5) if scale is None else float(scale)
    kpm = (None if key_padding_mask is None
           else _additive_kpm(key_padding_mask))
    seg = (None if segment_ids is None else
           torch.as_tensor(segment_ids, device=q.device).to(torch.int32))
    seed = seed_from_key(dropout_rng, q.device) if use_dropout else None
    return _Flash.apply(q, k, v, kpm, seg, seed, causal, scale,
                        float(dropout_p) if use_dropout else 0.0, plain)


def flash_attention_packed(q, k, v, cu_seqlens, *, causal: bool = False,
                           scale: Optional[float] = None,
                           dropout_p: float = 0.0, dropout_rng=None,
                           backend: Optional[str] = None) -> torch.Tensor:
    """Varlen (THD) attention over ``[total, n, d]`` packed tensors:
    ``cu_seqlens`` ``[docs + 1]`` int32 cumulative starts (on q's device)
    describe both sides; positions past ``cu_seqlens[-1]`` are padding.
    Runs :func:`flash_attention` with the segment ids of
    :func:`segment_ids_from_cu_seqlens` on a ``[1, total, n, d]`` view;
    tile pairs of different documents are skipped."""
    if q.ndim != 3:
        raise ValueError(f"expected packed [total, n, d], got "
                         f"{tuple(q.shape)}")
    seg = segment_ids_from_cu_seqlens(
        torch.as_tensor(cu_seqlens, device=q.device), q.shape[0])
    out = flash_attention(q[None], k[None], v[None], causal=causal,
                          segment_ids=seg[None], scale=scale,
                          dropout_p=dropout_p, dropout_rng=dropout_rng,
                          backend=backend)
    return out[0]
