"""Grouped (segment) matmul (``apex_tpu/ops/grouped_matmul.py``):
``out[r] = x[r] @ w[g]`` for rows ``r`` in group ``g``'s span
``[offsets[g], offsets[g+1])`` of ``x`` sorted by group, its gradient,
and the int8-slab form.

Rows outside ``[offsets[0], offsets[-1])`` come back exactly zero: the
LoRA path (``models/lora.py``) packs its no-adapter rows before
``offsets[0]``, where their delta is 0 without a zero-weight group.

For CUDA tensors each call is one launch of kernel row 9
(``csrc/grouped_matmul.cu``), which reads the offsets on the device (no
host read, so the launch can sit in a CUDA graph) and cuts the rows into
tiles of one group each.  It has four branches, each with its own
launch count:

- fp32 operands (LoRA's slabs), and 16-bit operands of a shape the
  tensor-core tile does not take: :data:`GROUPED_MATMUL`, fp32 FMA on
  the CUDA cores over tiles of 4 or 16 rows, the contraction split
  across the CTAs of one thread-block cluster when the tiles are few
  (:func:`fp32_tiles`), their partials added in rank order in the
  cluster's shared memory: one launch per call;
- bf16/fp16 operands with ``k`` and ``p`` multiples of 8 (the MoE
  experts): :data:`GROUPED_MATMUL_MMA`, the Hopper GEMM
  (``csrc/sm90_gemm.cuh``: persistent CTAs, a TMA ring, ``wgmma`` into
  fp32 registers) over tiles of 128 rows of one group and 128 or 256
  columns (:func:`mma_column_tile`);
  :data:`GROUPED_MATMUL_MMA_T` counts the same GEMM reading each group's
  weight transposed in place, the backward's ``g @ w[g]ᵀ``;
- an int8 slab with fp32 scales (:func:`grouped_matmul_quantized`):
  :data:`GROUPED_MATMUL_INT8`, the same GEMM with each int8 tile widened
  to x's 16-bit type in shared memory and each scale block's partial
  scaled in registers (row 10's tensor-core route is this kernel with one
  group);
- an int8 slab the GEMM does not take (fp32 x, a scale block that is not a
  multiple of 32, ``p`` not a multiple of 16, more than
  :data:`MAX_TILE_GROUPS` groups): :data:`GROUPED_MATMUL_INT8_SIMT`, the
  fp32 branch's kernel reading the int8 wire and scaling each weight by
  its block's scale as it loads it (``_dequantize_group``'s weight, with
  no fp32 slab in device memory): one launch per call.

For CPU tensors, and under ``backend="reference"``, the plain version
:func:`grouped_matmul_reference` runs: one masked fp32 product per group,
the JAX reference route.

The gradient follows ``_gmm_fwd``/``_gmm_bwd``: dx re-enters the routed
primitive on ``(g, w[g]ᵀ)`` (on the card the transposed read, never a
transposed copy of the slab), dw is :func:`_grouped_dw`, masked segment
outer products in fp32 (XLA in the JAX package, a torch composition
here).  The int8 form's backward is ``_gmmq_bwd``: dx over the
fp32-dequantized slab, no gradient for the wire, zeros for the scales.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from apex_tpu_torch.amp.patch import unpatched
from apex_tpu_torch.ops import _kernel_utils as ku
from apex_tpu_torch.ops.dense import int8_column_tile, quantize_weight
from apex_tpu_torch.utils.registry import check_backend, on_cuda

__all__ = ["group_ids", "grouped_matmul", "grouped_matmul_quantized",
           "grouped_matmul_reference", "quantize_group_weights",
           "hopper_attributes", "mma_column_tile", "fp32_tiles",
           "int8_gemm_takes", "MAX_TILE_GROUPS"]

_REPLACES = "apex_tpu/ops/grouped_matmul.py:113"

GROUPED_MATMUL = ku.register(ku.Kernel(
    "grouped_matmul", "grouped_matmul.cu", "apex_grouped_matmul",
    [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7, replaces=_REPLACES))

_MMA_ARGS = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
GROUPED_MATMUL_MMA = ku.register(ku.Kernel(
    "grouped_matmul_mma", "grouped_matmul.cu", "apex_grouped_matmul_mma",
    _MMA_ARGS, replaces=_REPLACES))
# the same entry with trans = 1, counted apart: the backward's dx
GROUPED_MATMUL_MMA_T = ku.register(ku.Kernel(
    "grouped_matmul_mma_t", "grouped_matmul.cu", "apex_grouped_matmul_mma",
    _MMA_ARGS, replaces=_REPLACES))

GROUPED_MATMUL_INT8 = ku.register(ku.Kernel(
    "grouped_matmul_int8", "grouped_matmul.cu", "apex_grouped_matmul_int8",
    [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7, replaces=_REPLACES))

GROUPED_MATMUL_INT8_SIMT = ku.register(ku.Kernel(
    "grouped_matmul_int8_simt", "grouped_matmul.cu",
    "apex_grouped_matmul_int8_simt", [ctypes.c_void_p] * 5
    + [ctypes.c_int] * 8, replaces=_REPLACES))

# csrc/grouped_matmul.cu's fp32-branch CTA width and largest cluster, and
# the H100's SM count
_THREADS, _MAX_SPLITS, _SMS = 256, 8, 132
_HALF = (torch.bfloat16, torch.float16)
# the tensor-core GEMM keeps its segment table in shared memory
MAX_TILE_GROUPS = 2048


def group_ids(offsets: torch.Tensor, n_rows: int, n_groups: int):
    """Group index per row: ``[n_rows]`` int32 in ``[0, n_groups]``; rows
    outside the ``[offsets[0], offsets[-1])`` window get ``n_groups``."""
    off = offsets.to(torch.int32)
    r = torch.arange(n_rows, dtype=torch.int32, device=off.device)
    g = torch.searchsorted(off, r, right=True).to(torch.int32) - 1
    valid = (r >= off[0]) & (r < off[-1])
    return torch.where(valid, g.clamp(0, n_groups - 1),
                       torch.full_like(g, n_groups))


def _check(x, w, offsets):
    if x.ndim != 2 or w.ndim != 3 or offsets.ndim != 1:
        raise ValueError(
            f"grouped_matmul: expected x [N, k], w [G, k, p], offsets "
            f"[G+1]; got {tuple(x.shape)}, {tuple(w.shape)}, "
            f"{tuple(offsets.shape)}")
    if w.shape[0] + 1 != offsets.shape[0]:
        raise ValueError(
            f"grouped_matmul: offsets length {offsets.shape[0]} != "
            f"G + 1 = {w.shape[0] + 1}")
    if x.shape[1] != w.shape[1]:
        raise ValueError(
            f"grouped_matmul: contraction mismatch — x [..., {x.shape[1]}]"
            f" vs w [., {w.shape[1]}, .]")


def grouped_matmul_reference(x, w, offsets):
    """Plain version of kernel row 9: one masked fp32 product per group,
    zero outside every span, in ``promote_types(x, w)``."""
    _check(x, w, offsets)
    n = x.shape[0]
    off = offsets.to(torch.int32)
    rows = torch.arange(n, dtype=torch.int32, device=x.device)
    xf = x.float()
    out = torch.zeros(n, w.shape[-1], dtype=torch.float32, device=x.device)
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    for g in range(w.shape[0]):
        mask = ((rows >= off[g]) & (rows < off[g + 1]))[:, None]
        xg = torch.where(mask, xf, zero)
        out = out + torch.where(mask, xg @ w[g].float(), zero)
    return out.to(torch.promote_types(x.dtype, w.dtype))


def _column_tile(p: int) -> int:
    bn = 1
    while bn < p and bn < _THREADS:
        bn *= 2
    return bn


def fp32_tiles(n: int, k: int, p: int, g: int,
               rows: Optional[int] = None) -> Tuple[int, int]:
    """``(row tile, cluster size)`` of row 9's fp32 branch for ``n`` rows
    and a ``[g, k, p]`` slab.  Rows: 16 when the contraction is short
    (``k`` < 256, the LoRA B side: a CTA's weights are a few rows of its
    columns, re-read by every row tile) and the rows average 16 or more
    per segment (``g`` groups and the two outer segments: an adapter
    prefill); else 4 (a decode batch holds one or two rows per group, and
    the A side's long contraction wants more CTAs).  Cluster: 1 when the
    tiles fill the card's 132 SMs, else enough CTAs for ~2 per SM, each
    keeping at least 768 ``k`` rows, at most 8 (the LoRA A side at
    decode: 4 for k = 3072, 1 for 768).  ``rows`` pins the row tile."""
    if rows is None:
        rows = 16 if k < 256 and n >= 16 * (g + 2) else 4
    ctas = (-(-n // rows) + g + 2) * -(-p // _column_tile(p))
    if ctas >= _SMS:
        return rows, 1
    return rows, max(1, min(_MAX_SPLITS, -(-k // 768), -(-2 * _SMS // ctas)))


def _gmm_fp32_kernel(x, w, offsets, splits: Optional[int] = None,
                     rows: Optional[int] = None):
    """Row 9's fp32 branch (any float dtype, widened on load); ``splits``
    (the cluster size) and ``rows`` (4 or 16) override
    :func:`fp32_tiles`."""
    dtype = torch.promote_types(x.dtype, w.dtype)
    x = x.to(dtype).contiguous()
    w = w.to(dtype).contiguous()
    off = offsets.to(torch.int32).contiguous()
    ku.check_cuda_operands("grouped_matmul", x, w, off)
    n, k = x.shape
    g, _, p = w.shape
    out = torch.empty(n, p, dtype=dtype, device=x.device)
    plan_rows, plan_splits = fp32_tiles(n, k, p, g)
    GROUPED_MATMUL(x.device, ku.ptr(x), ku.ptr(w), ku.ptr(off), ku.ptr(out),
                   n, k, p, g, splits or plan_splits, rows or plan_rows,
                   ku.dtype_code(x))
    return out


def _mma_takes(dtype, n: int, k: int, p: int, g: int) -> bool:
    """The 16-bit tensor-core GEMM: bf16/fp16 operands whose rows its TMA
    maps describe (``k`` and ``p`` multiples of 8) and at most
    :data:`MAX_TILE_GROUPS` groups."""
    return (dtype in _HALF and g <= MAX_TILE_GROUPS
            and ku.tma_strides_ok((n, k), 2)
            and ku.tma_strides_ok((g, k, p), 2))


def mma_column_tile(n: int, p: int, g: int) -> int:
    """Columns of the 16-bit GEMM's tiles for ``n`` rows over ``g``
    groups: 256 (each warpgroup m64n256, half the re-reads of x) when the
    tiles so cut fit in one wave of the H100's 132 persistent CTAs, else
    128, whose smaller tiles fill the last of several waves better.  Row
    tiles are counted as ``ceil(n / 128) + g``: at most one partial tile
    per group (the outer segments' zero tiles cost no products)."""
    rows = -(-n // 128) + g
    return 256 if rows * -(-p // 256) <= _SMS else 128


def _gmm_kernel(x, w, offsets, *, trans: bool = False,
                cols: Optional[int] = None):
    """Row 9 on the card: ``w`` is ``[G, k, p]``, or with ``trans``
    ``[G, p, k]`` read as its per-group transpose.  16-bit operands of a
    shape the tile takes launch the tensor-core branch (``cols``, 128 or
    256, overrides :func:`mma_column_tile`); everything else the fp32
    branch (a transposed weight then as a contiguous copy: only off the
    MoE training path)."""
    dtype = torch.promote_types(x.dtype, w.dtype)
    n, k = x.shape
    g = w.shape[0]
    p = w.shape[1] if trans else w.shape[2]
    if not _mma_takes(dtype, n, k, p, g):
        if trans:
            w = w.transpose(1, 2)
        return _gmm_fp32_kernel(x, w, offsets)
    x = ku.aligned(x.to(dtype))
    w = ku.aligned(w.to(dtype))
    off = offsets.to(torch.int32).contiguous()
    ku.check_cuda_operands("grouped_matmul", x, w, off)
    out = torch.empty(n, p, dtype=dtype, device=x.device)
    kernel = GROUPED_MATMUL_MMA_T if trans else GROUPED_MATMUL_MMA
    kernel(x.device, ku.ptr(x), ku.ptr(w), ku.ptr(off), ku.ptr(out), n, k, p,
           g, int(trans), int((cols or mma_column_tile(n, p, g)) == 256),
           ku.dtype_code(x))
    return out


def hopper_attributes(dtype: torch.dtype = torch.bfloat16) -> dict:
    """What the CUDA runtime reports for row 9's Hopper GEMM in each
    tensor-core branch: the 16-bit ones at both column tiles, the int8
    slab at both stage depths and at 64 columns (the segment table sized
    for 8 groups); and for the fp32 branch's cluster kernel at both row
    tiles, in fp32 (LoRA's slabs): ``{name: {"registers", "smem_bytes",
    "ctas_per_sm", "spill_bytes"}}``.  Needs the card."""
    code = ku.dtype_code(torch.empty((), dtype=dtype))
    mma, mma_t = GROUPED_MATMUL_MMA.name, GROUPED_MATMUL_MMA_T.name
    q = GROUPED_MATMUL_INT8.name
    names = (mma, mma_t, q, q + " k32", mma + " n256", mma_t + " n256",
             q + " n64")
    attrs = {name: ku.hopper_attrs(GROUPED_MATMUL_MMA.source,
                                   "apex_grouped_matmul_attrs", mode, code)
             for mode, name in enumerate(names)}
    f32 = ku.dtype_code(torch.empty((), dtype=torch.float32))
    for rows in (4, 16):
        attrs[f"{GROUPED_MATMUL.name} fp32 r{rows}"] = ku.hopper_attrs(
            GROUPED_MATMUL.source, "apex_grouped_matmul_fp32_attrs", rows,
            f32)
    return attrs


def _gmm_route(x, w, offsets, reference: bool, trans: bool = False):
    """``_gmm_impl``: the kernel for CUDA tensors, the plain version for
    CPU tensors or under ``reference``; no rows or columns give zeros."""
    p = w.shape[1] if trans else w.shape[2]
    if x.shape[0] == 0 or p == 0:
        return torch.zeros(x.shape[0], p, device=x.device,
                           dtype=torch.promote_types(x.dtype, w.dtype))
    if reference or not on_cuda(x):
        return grouped_matmul_reference(
            x, w.transpose(1, 2) if trans else w, offsets)
    return _gmm_kernel(x, w, offsets, trans=trans)


def _grouped_dw(x, g, offsets):
    """``dw[e] = x_seg(e)ᵀ @ g_seg(e)``: one masked full-N outer product
    per group, fp32 sums, ``[G, k, p]`` fp32 (the JAX ``_grouped_dw``).
    16-bit CUDA operands of one dtype multiply as they are with an fp32
    result (a product of two 16-bit floats is exact in fp32, so it is the
    same function up to summation order); other operands are widened to
    fp32 first, as the plain version does."""
    n = x.shape[0]
    off = offsets.to(torch.int32)
    rows = torch.arange(n, dtype=torch.int32, device=x.device)
    half = on_cuda(x) and x.dtype in _HALF and g.dtype == x.dtype
    xs, gs = (x, g) if half else (x.float(), g.float())
    # masking either operand gives the same products: mask the narrower
    mask_x = xs.shape[1] <= gs.shape[1]
    zero = torch.zeros((), dtype=xs.dtype, device=x.device)
    parts = []
    for e in range(off.shape[0] - 1):
        mask = ((rows >= off[e]) & (rows < off[e + 1]))[:, None]
        a = torch.where(mask, xs, zero) if mask_x else xs
        b = gs if mask_x else torch.where(mask, gs, zero)
        parts.append(torch.mm(a.t(), b, out_dtype=torch.float32) if half
                     else a.t() @ b)
    return torch.stack(parts)


class _GroupedMatmul(torch.autograd.Function):
    """``_gmm`` with ``_gmm_fwd``/``_gmm_bwd``; offsets get no gradient."""

    @staticmethod
    def forward(ctx, x, w, offsets, reference):
        ctx.save_for_backward(x, w, offsets)
        ctx.reference = reference
        return _gmm_route(x, w, offsets, reference)

    @staticmethod
    def backward(ctx, g):
        x, w, offsets = ctx.saved_tensors
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = _gmm_route(g, w.to(g.dtype), offsets, ctx.reference,
                            trans=True).to(x.dtype)
        if ctx.needs_input_grad[1]:
            dw = _grouped_dw(x, g, offsets).to(w.dtype)
        return dx, dw, None, None


@unpatched
def grouped_matmul(x, w, offsets, *, backend: Optional[str] = None):
    """``out[r] = x[r] @ w[g]`` for rows ``r`` in group ``g``'s span
    ``[offsets[g], offsets[g+1])``; rows outside every span (including
    outside a window: ``offsets[0] > 0`` or ``offsets[-1] < N``) come back
    exactly zero.

    ``x`` ``[N, k]`` sorted by group, ``w`` ``[G, k, p]``, ``offsets``
    ``[G+1]`` non-decreasing integers on ``x``'s device.  fp32
    accumulation, output in ``promote_types(x, w)``.  Differentiable in
    ``x`` and ``w``: dx runs the same routed primitive with the weights
    transposed, dw masked segment outer products.  ``backend=
    "reference"`` pins the plain version, backward included."""
    _check(x, w, offsets)
    reference = check_backend(backend) == "reference"
    return _GroupedMatmul.apply(x, w, offsets, reference)


# ---------------------------------------------------------------------------
# the int8-slab form
# ---------------------------------------------------------------------------


def quantize_group_weights(w, block: Optional[int] = None) -> dict:
    """An expert slab ``[G, k, p]`` → ``{"wire": int8 [G, k, p],
    "scale": fp32 [G, k/kb, p]}``: per expert exactly
    :func:`~apex_tpu_torch.ops.dense.quantize_weight` (the JAX package
    ``vmap``s it over the experts; one call over the ``[k, G, p]`` view
    does the same arithmetic per column, bit for bit)."""
    if w.ndim != 3:
        raise ValueError(
            f"quantize_group_weights expects [G, k, p] slabs, got "
            f"{tuple(w.shape)}")
    q = quantize_weight(w.permute(1, 0, 2), block)
    return {"wire": q["wire"].permute(1, 0, 2).contiguous(),
            "scale": q["scale"].permute(1, 0, 2).contiguous()}


def _check_group_slab(wire, scale) -> None:
    g_n, k, p = wire.shape
    if (scale.ndim != 3 or scale.shape[0] != g_n
            or scale.shape[2] != p or not scale.shape[1]
            or k % scale.shape[1]):
        raise ValueError(
            f"scale {tuple(scale.shape)} does not tile slab "
            f"{tuple(wire.shape)}")


def _dequantize_group(wire, scale):
    """fp32 ``[G, k, p]`` weights of a quantized expert slab."""
    _check_group_slab(wire, scale)
    g_n, k, p = wire.shape
    nkb = scale.shape[1]
    wf = wire.float().reshape(g_n, nkb, k // nkb, p)
    return (wf * scale[:, :, None, :]).reshape(g_n, k, p)


def int8_gemm_takes(dtype, k: int, p: int, g: int, kb: int) -> bool:
    """Whether row 9's int8 tensor-core GEMM takes a slab: 16-bit x, the
    scale block a multiple of 32, ``p`` a multiple of 16 (the wire's TMA
    row stride) and at most :data:`MAX_TILE_GROUPS` groups; every other
    geometry takes the CUDA-core int8 branch."""
    return (dtype in _HALF and kb % 32 == 0 and g <= MAX_TILE_GROUPS
            and ku.tma_strides_ok((g, k, p), 1))


def _gmmq_simt(x, wire, scale, offsets):
    """Row 9's CUDA-core int8 branch: the fp32 branch's tiles
    (:func:`fp32_tiles`, 16 rows whenever the rows average 16 or more a
    segment: its slabs are the MoE experts', not LoRA's short A side) over
    the int8 wire, scaled as loaded."""
    n, k = x.shape
    g, _, p = wire.shape
    kb = k // scale.shape[1]
    x = x.contiguous()
    wire = wire.contiguous()
    scale = scale.float().contiguous()
    off = offsets.to(torch.int32).contiguous()
    ku.check_cuda_operands("grouped_matmul_quantized", x, wire, scale, off)
    out = torch.empty(n, p, dtype=x.dtype, device=x.device)
    rows, splits = fp32_tiles(n, k, p, g,
                              16 if n >= 16 * (g + 2) else None)
    GROUPED_MATMUL_INT8_SIMT(x.device, ku.ptr(x), ku.ptr(wire),
                             ku.ptr(scale), ku.ptr(off), ku.ptr(out), n, k,
                             p, g, kb, splits, rows, ku.dtype_code(x))
    return out


def _gmmq_kernel(x, wire, scale, offsets):
    n, k = x.shape
    g, _, p = wire.shape
    kb = k // scale.shape[1]
    if not int8_gemm_takes(x.dtype, k, p, g, kb):
        return _gmmq_simt(x, wire, scale, offsets)
    x = ku.aligned(x)
    wire = ku.aligned(wire)
    scale = scale.float().contiguous()
    off = offsets.to(torch.int32).contiguous()
    ku.check_cuda_operands("grouped_matmul_quantized", x, wire, scale, off)
    out = torch.empty(n, p, dtype=x.dtype, device=x.device)
    narrow = int8_column_tile(-(-n // 128) + g, p, kb) == 64
    GROUPED_MATMUL_INT8(x.device, ku.ptr(x), ku.ptr(wire), ku.ptr(scale),
                        ku.ptr(off), ku.ptr(out), n, k, p, g, kb, int(narrow),
                        ku.dtype_code(x))
    return out


def _gmmq_route(x, wire, scale, offsets, reference: bool):
    if x.shape[0] == 0:
        return torch.zeros(0, wire.shape[-1], dtype=x.dtype, device=x.device)
    if reference or not on_cuda(x):
        return grouped_matmul_reference(
            x, _dequantize_group(wire, scale), offsets).to(x.dtype)
    return _gmmq_kernel(x, wire, scale, offsets)


class _GroupedMatmulQ(torch.autograd.Function):
    """``_gmmq`` with ``_gmmq_bwd``: dx through the routed float
    primitive over the fp32-dequantized slab, so no requantization error
    enters the cotangent; the wire gets none, the scales zeros (frozen
    serving constants)."""

    @staticmethod
    def forward(ctx, x, wire, scale, offsets, reference):
        ctx.save_for_backward(wire, scale, offsets)
        ctx.reference, ctx.x_dtype = reference, x.dtype
        return _gmmq_route(x, wire, scale, offsets, reference)

    @staticmethod
    def backward(ctx, g):
        wire, scale, offsets = ctx.saved_tensors
        dx = dscale = None
        if ctx.needs_input_grad[0]:
            # off the training path (a quantized tree serves): the fp32
            # transposed slab as a contiguous copy, the fp32 branch
            deq_t = _dequantize_group(wire, scale).transpose(1, 2)
            dx = _gmm_route(g.float(), deq_t.contiguous(), offsets,
                            ctx.reference).to(ctx.x_dtype)
        if ctx.needs_input_grad[2]:
            dscale = torch.zeros_like(scale)
        return dx, None, dscale, None, None


@unpatched
def grouped_matmul_quantized(x, wire, scale, offsets, *,
                             backend: Optional[str] = None):
    """:func:`grouped_matmul` off a quantized expert slab
    (:func:`quantize_group_weights`): ``out[r] = x[r] @ deq(w[g])`` for
    rows in group ``g``'s span, rows outside every span exactly zero,
    output in ``x.dtype`` with fp32 accumulation.  On the card the int8
    branch of row 9 (the weight read is the int8 bytes); the plain
    version dequantizes the whole slab.  Backward: dx against the fp32
    dequantized weights; wire and scales frozen."""
    if x.ndim != 2 or wire.ndim != 3 or offsets.ndim != 1:
        raise ValueError(
            f"grouped_matmul_quantized: expected x [N, k], wire "
            f"[G, k, p], offsets [G+1]; got {tuple(x.shape)}, "
            f"{tuple(wire.shape)}, {tuple(offsets.shape)}")
    if wire.shape[0] + 1 != offsets.shape[0]:
        raise ValueError(
            f"grouped_matmul_quantized: offsets length "
            f"{offsets.shape[0]} != G + 1 = {wire.shape[0] + 1}")
    if x.shape[1] != wire.shape[1]:
        raise ValueError(
            f"grouped_matmul_quantized: contraction mismatch — x "
            f"[..., {x.shape[1]}] vs wire [., {wire.shape[1]}, .]")
    _check_group_slab(wire, scale)
    reference = check_backend(backend) == "reference"
    return _GroupedMatmulQ.apply(x, wire, scale, offsets, reference)
