"""O1/O4 per-op casts (``apex_tpu/amp/patch.py``): ``amp_patch_scope``.

The JAX package patches the matmul-class entry points of ``jax.numpy``
(``matmul``, ``dot``, ``einsum``, ``tensordot``, ``vdot``, ``inner``,
``outer``) to cast fp32 inputs to the compute dtype, and the
reduction/transcendental class (``jax.nn.softmax``, ``log_softmax``,
``gelu``, ``sigmoid``, ``softplus``, ``logsumexp``; ``jnp.exp``,
``expm1``, ``log``, ``log1p``, ``logaddexp``, ``cumsum``, ``cumprod``)
to cast fp16/bf16 inputs up to fp32, while the AMP step traces the loss.
In PyTorch's idiom the scope is a ``torch.overrides.TorchFunctionMode``
over the same classes (:data:`PATCHED_COMPUTE`, which adds ``F.linear``,
``torch.mm`` and ``torch.bmm``, and :data:`PATCHED_FP32`): module
functions only, as in JAX, where ``x @ w`` is not patched (``@`` and
tensor methods reach the mode as ``Tensor.matmul`` and friends, which
pass through).

Where the JAX call is ``jnp.einsum(..., preferred_element_type=
float32)`` the port's model computes the products in fp32 by upcasting
its operands first; those sites are :func:`compute_site` functions,
which take the JAX call's operands as they are and cast them as the
patch would before the upcast.  The port's ops (``fused_layer_norm``,
``flash_attention``, the fused head, the grouped matmul, swiglu, the
softmax family, the cross entropy) run their insides unpatched
(:func:`unpatched`), as JAX's Pallas kernels and ``lax`` primitives are;
the ctypes kernel launches are no torch functions and pass through
untouched.  JAX's XLA-composed ops (the fused head's forward
``jnp.einsum``) do see the patch; that changes their products only for
fp32 operands, i.e. under a model config whose ``compute_dtype`` is fp32,
where the port's ops keep their fp32 products.

The scope acts on the thread that entered it only (a mode and a depth
per thread, as JAX's thread-local activation flag), is re-entrant (the
innermost dtype wins; the mode leaves when the outermost scope does) and
exception-safe.  The AMP step enters it around the forward only and
leaves before ``torch.autograd.grad``: the backward is then the
transpose of the cast forward, as in JAX, where the patch acts only
while the loss traces.  A layer under ``remat`` recomputes its forward in
the backward; :func:`checkpoint_contexts` re-enters the scope there.
"""

from __future__ import annotations

import contextlib
import functools
import threading

import torch
import torch.nn.functional as F
from torch.overrides import TorchFunctionMode

__all__ = ["amp_patch_scope", "PATCHED_COMPUTE", "PATCHED_FP32",
           "active_dtype", "compute_site", "unpatched",
           "checkpoint_contexts"]

PATCHED_COMPUTE = frozenset([
    torch.matmul, torch.dot, torch.einsum, torch.tensordot, torch.vdot,
    torch.inner, torch.outer, F.linear, torch.mm, torch.bmm])

PATCHED_FP32 = frozenset([
    torch.softmax, F.softmax, torch.log_softmax, F.log_softmax, F.gelu,
    torch.sigmoid, F.softplus, torch.logsumexp, torch.exp, torch.expm1,
    torch.log, torch.log1p, torch.logaddexp, torch.cumsum, torch.cumprod])

_LOW = (torch.float16, torch.bfloat16)
_tls = threading.local()   # .dtypes (stack), .mode, .exempt: per thread


def active_dtype():
    """The calling thread's compute dtype inside a scope (and outside the
    port's ops), else None."""
    dtypes = getattr(_tls, "dtypes", None)
    if not dtypes or getattr(_tls, "exempt", 0):
        return None
    return dtypes[-1]


def _cast(tree, pred, dtype):
    if torch.is_tensor(tree):
        return tree.to(dtype) if pred(tree) else tree
    if isinstance(tree, (list, tuple)):
        return type(tree)(_cast(v, pred, dtype) for v in tree)
    if isinstance(tree, dict):
        return {k: _cast(v, pred, dtype) for k, v in tree.items()}
    return tree


def _is_f32(t) -> bool:
    return t.dtype == torch.float32


def _is_low(t) -> bool:
    return t.dtype in _LOW


class _AmpMode(TorchFunctionMode):
    """Casts the inputs of the listed torch functions per the thread's
    active dtype (:func:`active_dtype`); every other call passes."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        dtype = active_dtype()
        if dtype is not None:
            if func in PATCHED_COMPUTE:
                args, kwargs = _cast((args, kwargs), _is_f32, dtype)
            elif func in PATCHED_FP32:
                args, kwargs = _cast((args, kwargs), _is_low, torch.float32)
        return func(*args, **kwargs)


@contextlib.contextmanager
def amp_patch_scope(compute_dtype=torch.bfloat16):
    """Cast per the O1 lists for the duration of the block, on this
    thread (module docstring)."""
    dtypes = getattr(_tls, "dtypes", None)
    if dtypes is None:
        dtypes = _tls.dtypes = []
    outer = not dtypes
    dtypes.append(compute_dtype)
    try:
        if outer:
            with _AmpMode():
                yield
        else:
            yield
    finally:
        dtypes.pop()


def compute_site(fn):
    """Mark ``fn`` as the port's form of a patched JAX matmul-class call
    whose products run in fp32 (``preferred_element_type``): inside a
    scope its fp32 tensor arguments are cast to the compute dtype before
    ``fn`` runs; outside, ``fn`` runs as it is."""

    @functools.wraps(fn)
    def site(*args, **kwargs):
        dtype = active_dtype()
        if dtype is not None:
            args, kwargs = _cast((args, kwargs), _is_f32, dtype)
        return fn(*args, **kwargs)

    return site


def unpatched(fn):
    """Run ``fn`` (an op of the port) with the scope's casts off inside
    it, as JAX's kernels and ``lax`` primitives run unpatched."""

    @functools.wraps(fn)
    def op(*args, **kwargs):
        if not getattr(_tls, "dtypes", None):
            return fn(*args, **kwargs)
        _tls.exempt = getattr(_tls, "exempt", 0) + 1
        try:
            return fn(*args, **kwargs)
        finally:
            _tls.exempt -= 1

    return op


def checkpoint_contexts():
    """``context_fn`` for ``torch.utils.checkpoint.checkpoint``: the
    forward runs as it is, the recompute (in the backward, outside any
    scope) inside the scope that was active at the forward."""
    dtype = active_dtype()
    return (contextlib.nullcontext(),
            amp_patch_scope(dtype) if dtype is not None
            else contextlib.nullcontext())
