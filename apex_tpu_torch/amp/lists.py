"""Cast lists and per-function cast decorators (``apex_tpu/amp/lists.py``).

``FP16_FUNCS`` (matmul/conv class: the compute dtype), ``FP32_FUNCS``
(reductions and transcendentals: fp32) and ``CASTS`` (promote mixed
inputs to the widest) are the JAX package's lists of op names, as they
are; :mod:`apex_tpu_torch.amp.patch` acts on the torch functions of the
first two classes.  The decorators wrap a user function with casts of
its floating tensor arguments, nested lists, tuples and dicts included
(the reference's registration decorators).  ``half_function`` casts to
fp16: the JAX package maps fp16 to bf16 on a TPU only, so on the card
and on the CPU it is fp16.
"""

from __future__ import annotations

import functools

import torch

__all__ = ["FP16_FUNCS", "FP32_FUNCS", "CASTS", "half_function",
           "bfloat16_function", "float_function", "promote_function"]

FP16_FUNCS = [
    "conv1d", "conv2d", "conv3d", "conv_transpose1d", "conv_transpose2d",
    "conv_transpose3d", "linear", "matmul", "dot", "dot_general", "bmm",
    "mm", "mv", "addmm", "addbmm", "baddbmm", "conv_general_dilated",
    "prelu", "einsum",
]

FP32_FUNCS = [
    "softmax", "log_softmax", "layer_norm", "group_norm", "batch_norm",
    "instance_norm", "normalize", "cross_entropy", "nll_loss", "l1_loss",
    "mse_loss", "kl_div", "exp", "expm1", "log", "log10", "log1p", "log2",
    "pow", "erf", "erfc", "erfinv", "cosh", "sinh", "tan", "acos", "asin",
    "atan", "reciprocal", "rsqrt", "cumprod", "cumsum", "prod", "sum",
    "norm", "mean", "var", "std", "logsumexp", "sigmoid", "softplus",
    "gelu",
]

CASTS = [
    "add", "sub", "mul", "div", "addcdiv", "addcmul", "atan2", "cat",
    "stack", "equal", "cross", "bilinear", "dist", "where",
]


def _map_floats(tree, fn):
    if torch.is_tensor(tree):
        return fn(tree) if tree.is_floating_point() else tree
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_floats(v, fn) for v in tree)
    if isinstance(tree, dict):
        return {k: _map_floats(v, fn) for k, v in tree.items()}
    return tree


def _floats(tree):
    out = []
    _map_floats(tree, lambda t: out.append(t) or t)
    return out


def _cast_wrapper(fn, dtype):
    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        args, kwargs = _map_floats((args, kwargs), lambda t: t.to(dtype))
        return fn(*args, **kwargs)

    return wrapped


def half_function(fn):
    """Run ``fn`` with its float tensor inputs cast to fp16."""
    return _cast_wrapper(fn, torch.float16)


def bfloat16_function(fn):
    """Run ``fn`` with its float tensor inputs cast to bf16."""
    return _cast_wrapper(fn, torch.bfloat16)


def float_function(fn):
    """Run ``fn`` with its float tensor inputs cast to fp32."""
    return _cast_wrapper(fn, torch.float32)


def promote_function(fn):
    """Promote mixed float tensor inputs to the widest dtype among them
    (``torch.promote_types``, JAX's ``result_type`` on floats)."""

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        floats = _floats((args, kwargs))
        if floats:
            widest = functools.reduce(torch.promote_types,
                                      [t.dtype for t in floats])
            args, kwargs = _map_floats((args, kwargs),
                                       lambda t: t.to(widest))
        return fn(*args, **kwargs)

    return wrapped
