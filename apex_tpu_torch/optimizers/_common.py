"""Shared plumbing of the optimizers (``apex_tpu/optimizers/_common.py``).

Each optimizer is an optax-style ``GradientTransformation`` over a tree
of tensors (nested dicts, tuples and named tuples, as the JAX package's
pytrees)::

    tx = fused_adam(lr=1e-3)
    state = tx.init(params)
    updates, state = tx.update(grads, state, params)
    params = apply_updates(params, updates)      # p + u

The update is out of place: it returns new tensors and leaves its inputs
as they were, so a train step stays a pure function of its state.
Hyperparameters may be Python floats or 0-d tensors, or a schedule
``lr(step)``; ``step`` lives on the device.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple, Union

import torch

Scalar = Union[float, torch.Tensor]
ScheduleOrScalar = Union[float, torch.Tensor, Callable[[torch.Tensor], Any]]

__all__ = ["Scalar", "ScheduleOrScalar", "GradientTransformation",
           "apply_updates", "is_float_leaf", "tree_map", "tree_leaves",
           "tree_map_float", "tree_zeros_like_f32", "global_norm",
           "resolve_lr"]


class GradientTransformation(NamedTuple):
    """Minimal optax-style pair."""

    init: Callable[[Any], Any]
    update: Callable[..., Any]


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` (and the matching leaves of
    ``rest``); dicts, lists, tuples and named tuples are containers,
    ``None`` stays ``None``, everything else is a leaf."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map(fn, v, *(r[i] for r in rest))
                            for i, v in enumerate(tree)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    if tree is None:
        return None
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    """The leaves of ``tree`` in :func:`tree_map`'s order."""
    out = []
    tree_map(out.append, tree)
    return out


def is_float_leaf(x) -> bool:
    return torch.is_tensor(x) and x.is_floating_point()


def tree_map_float(fn, *trees):
    """Map over float leaves; pass non-float leaves through unchanged."""
    return tree_map(lambda x, *rest: fn(x, *rest) if is_float_leaf(x) else x,
                    *trees)


def tree_zeros_like_f32(params):
    """fp32 optimizer-state slots whatever the parameter dtype."""
    return tree_map_float(
        lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
        params)


def apply_updates(params, updates):
    return tree_map(lambda p, u: p + u.to(p.dtype) if u is not None else p,
                    params, updates)


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every float leaf, in fp32."""
    leaves = [x for x in tree_leaves(tree) if is_float_leaf(x)]
    if not leaves:
        return torch.zeros((), dtype=torch.float32)
    return torch.sqrt(sum(torch.sum(torch.square(x.float())) for x in leaves))


def resolve_lr(lr: ScheduleOrScalar, step: torch.Tensor) -> torch.Tensor:
    """A constant or a schedule ``lr(step)``, as a 0-d fp32 tensor on
    ``step``'s device."""
    value = lr(step) if callable(lr) else lr
    return torch.as_tensor(value, dtype=torch.float32, device=step.device)
