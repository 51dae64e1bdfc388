"""Weight-only int8 quantized matmul (``apex_tpu/ops/dense.py``, the
serving half: ``quantize_weight`` … ``quantized_matmul``).

:func:`quantize_weight` turns a ``[in, *out]`` kernel into
``{"wire": int8 [in, *out], "scale": fp32 [in/kb, *out]}`` with one
symmetric scale per (contraction block of ``kb`` rows, output column),
bit for bit the JAX package's wire and scales.  :func:`dense_quantized`
computes ``x @ (wire · scale)`` in fp32 and returns ``x``'s dtype.

For CUDA tensors it is one launch of kernel row 10
(``csrc/dense_int8.cu``), by one of three routes (:func:`dense_route`),
each with its own launch count:

- bf16/fp16 activations above 64 rows (prefill): :data:`DENSE_INT8`, the
  Hopper GEMM row 9's int8 branch runs (``csrc/sm90_gemm.cuh``: TMA ring,
  each int8 tile widened to 16 bits in shared memory, which is exact for
  |q| <= 127, ``wgmma`` into an fp32 partial per scale block, multiplied
  by that block's scale row into an fp32 accumulator; tiles of 128 or 64
  columns, :func:`int8_column_tile`);
- the same at 64 rows or fewer (decode): :data:`DENSE_INT8_DECODE`, the
  roles swapped (``yᵀ = Wᵀ xᵀ``, the weight's columns fill ``wgmma``'s
  64 rows) and the contraction split into whole scale blocks across the
  CTAs of one thread-block cluster (:func:`decode_splits`), whose fp32
  partials are added in rank order in shared memory;
- fp32 activations and the shapes the tiles do not take (the scale block
  not a multiple of 32, an operand row not a multiple of 16 bytes):
  :data:`DENSE_INT8_SIMT`, the CUDA cores.

For CPU tensors, and under ``backend="reference"``, it is
:func:`dense_quantized_reference`: the whole slab dequantized to fp32,
then one fp32 matmul (the JAX reference route).

The gradient is the JAX package's ``_dqmm_bwd`` as a
``torch.autograd.Function``: dx against the fp32-dequantized weight, no
gradient for the wire or the scales (weight-only quantization is a
serving conversion).
"""

from __future__ import annotations

import ctypes
import warnings
from typing import Optional

import torch

from apex_tpu_torch.ops import _kernel_utils as ku
from apex_tpu_torch.utils.registry import check_backend, on_cuda

__all__ = ["QUANT_BLOCK", "pick_quant_block", "is_quantized",
           "quantize_weight", "dequantize_weight", "dense_quantized",
           "dense_quantized_reference", "quantized_matmul", "dense_route",
           "decode_splits", "int8_column_tile", "hopper_attributes"]

QUANT_BLOCK = 128
_INT8_MAX = 127.0

_REPLACES = "apex_tpu/ops/dense.py:212"
_ARGS = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4
DENSE_INT8 = ku.register(ku.Kernel(
    "dense_int8", "dense_int8.cu", "apex_dense_int8",
    _ARGS + [ctypes.c_int] * 2, replaces=_REPLACES))
DENSE_INT8_DECODE = ku.register(ku.Kernel(
    "dense_int8_decode", "dense_int8.cu", "apex_dense_int8_decode",
    _ARGS + [ctypes.c_int] * 2, replaces=_REPLACES))
DENSE_INT8_SIMT = ku.register(ku.Kernel(
    "dense_int8_simt", "dense_int8.cu", "apex_dense_int8_simt",
    _ARGS + [ctypes.c_int], replaces=_REPLACES))

# the decode route: at most this many rows, 64 weight columns per CTA, a
# portable cluster of at most 8 CTAs, and ~2 CTAs for each of the H100's
# 132 SMs
DECODE_ROWS = 64
_DECODE_COLS = 64
MAX_CLUSTER = 8
_SMS = 132
_TARGET_CTAS = 2 * _SMS
_HALF = (torch.bfloat16, torch.float16)


def pick_quant_block(in_dim: int, block: Optional[int] = None) -> int:
    """Largest divisor of ``in_dim`` that is ``<= block`` (default 128):
    the quantization block tiles the contraction axis exactly."""
    block = QUANT_BLOCK if block is None else int(block)
    if block < 1:
        raise ValueError(f"block={block} must be positive")
    for b in range(min(block, in_dim), 0, -1):
        if in_dim % b == 0:
            return b
    return 1


def is_quantized(leaf) -> bool:
    """True for a quantized-weight leaf (the dict :func:`quantize_weight`
    emits)."""
    return isinstance(leaf, dict) and "wire" in leaf and "scale" in leaf


def quantize_weight(w: torch.Tensor, block: Optional[int] = None) -> dict:
    """Symmetric round-half-to-even int8 along axis 0 (the contraction
    axis): one fp32 scale ``amax / 127`` per (k-block, output column),
    scale 1 for an all-zero column block, a NaN weight poisoning its
    scale — the JAX package's arithmetic, so wire and scale agree bit
    for bit."""
    if w.ndim < 2:
        raise ValueError(
            f"quantize_weight expects [in, *out] kernels, got "
            f"{tuple(w.shape)}")
    in_dim = w.shape[0]
    kb = pick_quant_block(in_dim, block)
    if kb <= 4 and in_dim > kb:
        warnings.warn(
            f"quantize_weight: in_dim {in_dim} has no block divisor <= "
            f"{block or QUANT_BLOCK} larger than {kb}; at {4 / kb:.1f} "
            "scale bytes/element the int8 form saves nothing over bf16",
            stacklevel=2)
    out_shape = tuple(w.shape[1:])
    wf = w.float().reshape((in_dim // kb, kb) + out_shape)
    amax = wf.abs().amax(dim=1)
    scale = torch.where(amax == 0, torch.ones_like(amax), amax / _INT8_MAX)
    q = torch.round(wf / scale[:, None])
    wire = q.clamp(-_INT8_MAX, _INT8_MAX).to(torch.int8)
    return {"wire": wire.reshape(w.shape), "scale": scale}


def _quant_block_of(wire, scale) -> int:
    in_dim, nkb = wire.shape[0], scale.shape[0]
    if nkb < 1 or in_dim % nkb:
        raise ValueError(
            f"scale blocks ({nkb}) do not tile the contraction axis "
            f"({in_dim})")
    if tuple(wire.shape[1:]) != tuple(scale.shape[1:]):
        raise ValueError(
            f"wire {tuple(wire.shape)} / scale {tuple(scale.shape)}: "
            "output axes must match")
    return in_dim // nkb


def dequantize_weight(wire: torch.Tensor, scale: torch.Tensor):
    """fp32 weights from a quantized slab."""
    kb = _quant_block_of(wire, scale)
    nkb = scale.shape[0]
    wf = wire.float().reshape((nkb, kb) + tuple(wire.shape[1:]))
    return (wf * scale[:, None]).reshape(wire.shape)


def dense_quantized_reference(x2, wire2, scale2):
    """Plain version of kernel row 10: ``x`` in fp32 against the whole
    dequantized slab, one fp32 product, cast back to ``x``'s dtype."""
    return (x2.float() @ dequantize_weight(wire2, scale2)).to(x2.dtype)


def dense_route(m: int, k: int, n: int, kb: int, dtype) -> str:
    """Row 10's kernel for a CUDA call: ``"tiles"`` (16-bit ``x`` above
    :data:`DECODE_ROWS` rows), ``"decode"`` (the same at fewer rows) or
    ``"simt"`` (fp32 ``x``, a scale block that is not a multiple of 32,
    or an operand whose rows a TMA map cannot describe)."""
    if (dtype not in _HALF or kb % 32 or k % kb
            or not ku.tma_strides_ok((m, k), 2)
            or not ku.tma_strides_ok((k, n), 1)):
        return "simt"
    return "decode" if m <= DECODE_ROWS else "tiles"


def int8_column_tile(row_tiles: int, n: int, kb: int) -> int:
    """Columns of the int8 GEMM's tiles (rows 9 and 10) over
    ``row_tiles`` tiles of 128 rows: 64 when twice as many tiles still
    fit one wave of the H100's 132 persistent CTAs (a 64-column tile
    takes ~0.7 of a 128-column one's time, so narrower tiles pay only
    where wider ones leave SMs idle) and the scale block allows stages
    of 64 k rows; else 128."""
    tiles = row_tiles * -(-n // 128)
    return 64 if kb % 64 == 0 and 2 * tiles <= _SMS else 128


def decode_splits(k: int, n: int, kb: int) -> int:
    """CTAs of one cluster on the decode route: each takes whole scale
    blocks of the contraction, at most :data:`MAX_CLUSTER` and the block
    count, enough for ~2 CTAs per SM over the 64-column tiles."""
    cols = -(-n // _DECODE_COLS)
    return max(1, min(MAX_CLUSTER, k // kb, -(-_TARGET_CTAS // cols)))


def _dq_kernel(x2, wire2, scale2, splits: Optional[int] = None):
    """Row 10 on the card by :func:`dense_route`; ``splits`` overrides
    :func:`decode_splits` on the decode route."""
    m, k = x2.shape
    n = wire2.shape[1]
    kb = _quant_block_of(wire2, scale2)
    x2 = ku.aligned(x2)
    wire2 = ku.aligned(wire2)
    scale2 = scale2.float().contiguous()
    ku.check_cuda_operands("dense_quantized", x2, wire2, scale2)
    out = torch.empty(m, n, dtype=x2.dtype, device=x2.device)
    args = (ku.ptr(x2), ku.ptr(wire2), ku.ptr(scale2), ku.ptr(out), m, k, n,
            kb)
    route = dense_route(m, k, n, kb, x2.dtype)
    if route == "simt":
        DENSE_INT8_SIMT(x2.device, *args, ku.dtype_code(x2))
    elif route == "decode":
        DENSE_INT8_DECODE(x2.device, *args,
                          splits or decode_splits(k, n, kb),
                          ku.dtype_code(x2))
    else:
        narrow = int8_column_tile(-(-m // 128), n, kb) == 64
        DENSE_INT8(x2.device, *args, int(narrow), ku.dtype_code(x2))
    return out


def hopper_attributes(dtype: torch.dtype = torch.bfloat16) -> dict:
    """What the CUDA runtime reports for row 10's Hopper kernels: the
    tensor-core route (stages of 64 and 32 k rows, 64 columns), and the
    decode route at n = 16, 32 and 64 with chunks of 128 and of 32 k rows
    (``{name: {"registers", "smem_bytes", "ctas_per_sm",
    "spill_bytes"}}``).  Needs the card."""
    code = ku.dtype_code(torch.empty((), dtype=dtype))
    decode = [(f"dense_int8_decode n{mp} k{kc}", route, mp)
              for route, kc in ((1, 128), (2, 32)) for mp in (16, 32, 64)]
    return {name: ku.hopper_attrs(DENSE_INT8.source, "apex_dense_int8_attrs",
                                  route, code, mp)
            for name, route, mp in [("dense_int8", 0, 0),
                                    ("dense_int8 k32", 3, 0),
                                    ("dense_int8 n64", 4, 0)] + decode}


class _DQMatmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x2, wire2, scale2, reference):
        ctx.save_for_backward(wire2, scale2)
        if reference or not on_cuda(x2):
            return dense_quantized_reference(x2, wire2, scale2)
        return _dq_kernel(x2, wire2, scale2)

    @staticmethod
    def backward(ctx, g):
        wire2, scale2 = ctx.saved_tensors
        deq = dequantize_weight(wire2, scale2)
        dx = (g.float() @ deq.t()).to(g.dtype)
        return dx, None, None, None


def dense_quantized(x, wire, scale, *, backend: Optional[str] = None):
    """``x [..., in] @ W`` off a quantized slab → ``[..., *out]`` in
    ``x``'s dtype (fp32 accumulation).  Trailing weight axes flatten for
    the product and come back on the output (the swiglu ``[h, 2, f]``
    kernel works unchanged)."""
    reference = check_backend(backend) == "reference"
    _quant_block_of(wire, scale)
    in_dim = wire.shape[0]
    if x.shape[-1] != in_dim:
        raise ValueError(
            f"contraction mismatch: x [..., {x.shape[-1]}] vs wire "
            f"[{in_dim}, ...]")
    out_shape = tuple(wire.shape[1:])
    p = 1
    for d in out_shape:
        p *= d
    x2 = x.reshape(-1, in_dim)
    if x2.shape[0] == 0:
        out = x2.new_zeros((0, p))
    else:
        out = _DQMatmul.apply(x2, wire.reshape(in_dim, p),
                              scale.reshape(scale.shape[0], p), reference)
    return out.reshape(tuple(x.shape[:-1]) + out_shape)


def quantized_matmul(x, leaf, *, backend: Optional[str] = None):
    """The one matmul-site helper: a plain kernel is cast to ``x``'s
    dtype and multiplied as before; a quantized dict runs the int8 slab
    path."""
    if is_quantized(leaf):
        return dense_quantized(x, leaf["wire"], leaf["scale"],
                               backend=backend)
    return x @ leaf.to(x.dtype)
