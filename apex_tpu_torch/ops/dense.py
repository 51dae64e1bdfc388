"""Weight-only int8 quantized matmul (``apex_tpu/ops/dense.py``, the
serving half: ``quantize_weight`` … ``quantized_matmul``).

:func:`quantize_weight` turns a ``[in, *out]`` kernel into
``{"wire": int8 [in, *out], "scale": fp32 [in/kb, *out]}`` with one
symmetric scale per (contraction block of ``kb`` rows, output column),
bit for bit the JAX package's wire and scales.  :func:`dense_quantized`
computes ``x @ (wire · scale)`` in fp32 and returns ``x``'s dtype.

For CUDA tensors it is one launch of kernel row 10
(``csrc/dense_int8.cu``): 16-bit activations take a tensor-core path
(each int8 weight converted to bf16/fp16 in shared memory, which is
exact for |q| <= 127, one ``mma.sync`` product per 128-row scale block
in fp32, multiplied by that block's scale row into an fp32
accumulator; when the output has few 64×64 tiles, as at decode, the
contraction axis splits into whole scale blocks across CTAs and a
second pass adds the fp32 partials in order); fp32 activations take a
CUDA-core path.  For CPU tensors,
and under ``backend="reference"``, it is :func:`dense_quantized_reference`:
the whole slab dequantized to fp32, then one fp32 matmul (the JAX
reference route).

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
           "dense_quantized_reference", "quantized_matmul"]

QUANT_BLOCK = 128
_INT8_MAX = 127.0

DENSE_INT8 = ku.register(ku.Kernel(
    "dense_int8", "dense_int8.cu", "apex_dense_int8",
    [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6,
    replaces="apex_tpu/ops/dense.py:212"))

# the tensor-core path's CTA tile, and the CTAs that fill the H100's 132
# SMs twice over
_TILE = 64
_TARGET_CTAS = 264


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


def _splits(m, k, n, kb, dtype) -> int:
    """Contraction splits of the tensor-core path: whole scale blocks,
    enough to give ~_TARGET_CTAS CTAs when the output tiles are few (the
    decode shapes); 1 on the CUDA-core path."""
    if dtype == torch.float32 or kb % 32 or n % 16:
        return 1
    tiles = -(-m // _TILE) * -(-n // _TILE)
    return max(1, min(k // kb, -(-_TARGET_CTAS // tiles)))


def _dq_kernel(x2, wire2, scale2):
    m, k = x2.shape
    n = wire2.shape[1]
    kb = _quant_block_of(wire2, scale2)
    x2 = ku.aligned(x2)
    wire2 = wire2.contiguous()
    scale2 = scale2.float().contiguous()
    ku.check_cuda_operands("dense_quantized", x2, wire2, scale2)
    ku.check_aligned("dense_quantized", x2, wire2)
    out = torch.empty(m, n, dtype=x2.dtype, device=x2.device)
    splits = _splits(m, k, n, kb, x2.dtype)
    partial = (None if splits == 1 else
               torch.empty(splits, m, n, dtype=torch.float32,
                           device=x2.device))
    DENSE_INT8(x2.device, ku.ptr(x2), ku.ptr(wire2), ku.ptr(scale2),
               ku.ptr(out), ku.ptr(partial), m, k, n, kb, splits,
               ku.dtype_code(x2))
    return out


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
