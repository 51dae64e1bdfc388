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

An optimizer with a multi-tensor kernel (FusedAdam, FusedLAMB) also
carries ``fused_apply``, the AMP step's optimizer tail in one pass: the
update, ``p + u``, the overflow select and the model-dtype copy
(``multi_tensor.multi_tensor_adam``/``_lamb`` in apply mode).  The others
leave it ``None`` and the step applies their updates leaf by leaf.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional, Union

import torch

from apex_tpu_torch.multi_tensor.multi_tensor_apply import (
    as_f32, multi_tensor_l2norm)

Scalar = Union[float, torch.Tensor]
ScheduleOrScalar = Union[float, torch.Tensor, Callable[[torch.Tensor], Any]]

__all__ = ["Scalar", "ScheduleOrScalar", "GradientTransformation",
           "apply_updates", "apply_or_keep", "is_float_leaf", "tree_map", "tree_leaves",
           "tree_map_float", "tree_zeros_like_f32", "global_norm",
           "resolve_lr", "norm_metrics", "NormTelemetryState",
           "with_norm_telemetry", "latest_norms", "record_opt_norms",
           "float_leaves", "rebuild", "bias_corrections"]


class GradientTransformation(NamedTuple):
    """Minimal optax-style pair, plus the optional fused tail:
    ``fused_apply(grads, state, params, *, overflow, model_like,
    update_norm, backend) -> (new_params, new_state, new_model,
    update_sq)`` applies the update to ``params`` (keeping params and
    state where the 0-d bool ``overflow`` is set), returns the copies of
    the new params in ``model_like``'s dtypes (``None`` without it) and,
    with ``update_norm``, the updates' sum of squares."""

    init: Callable[[Any], Any]
    update: Callable[..., Any]
    fused_apply: Optional[Callable[..., Any]] = None


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


def apply_or_keep(params, updates, opt_state, old_opt_state,
                  overflow: Optional[torch.Tensor]):
    """The AMP step's per-leaf tail: ``(apply_updates(params, updates),
    opt_state)``, and where the 0-d bool ``overflow`` is set (``None``:
    never) the old ``params`` and ``old_opt_state`` in their place.  The
    tail of every optimizer without a multi-tensor kernel, and the plain
    version of M3's and M4's apply mode."""
    new_params = apply_updates(params, updates)
    if overflow is None:
        return new_params, opt_state

    def select(new, old):
        return tree_map(lambda n, o: torch.where(overflow, o, n), new, old)

    return select(new_params, params), select(opt_state, old_opt_state)


def float_leaves(tree) -> list:
    """The float leaves of ``tree`` in :func:`tree_map`'s order."""
    return [x for x in tree_leaves(tree) if is_float_leaf(x)]


def rebuild(tree, values):
    """``tree`` with its float leaves replaced, in order, by ``values``."""
    it = iter(values)
    return tree_map_float(lambda _: next(it), tree)


def global_norm(tree, *, backend: Optional[str] = None) -> torch.Tensor:
    """sqrt of the sum of squares of every float leaf, in fp32
    (``multi_tensor_l2norm``: one M2 call on the card)."""
    leaves = float_leaves(tree)
    if not leaves:
        return torch.zeros((), dtype=torch.float32)
    return multi_tensor_l2norm(leaves, backend=backend)[0]


def bias_corrections(step: torch.Tensor, beta1: float, beta2: float,
                     enabled: bool):
    """``(1 - beta1**step, 1 - beta2**step)`` as 0-d fp32 tensors on the
    step's device, or ``(None, None)`` when bias correction is off."""
    if not enabled:
        return None, None
    t = step.float()
    return (1.0 - torch.pow(torch.full_like(t, beta1), t),
            1.0 - torch.pow(torch.full_like(t, beta2), t))


_NORM_KEYS = ("grad_norm", "update_norm", "param_norm",
              "update_to_param_ratio")


def _ratio(update_norm, param_norm):
    return update_norm / torch.clamp(param_norm, min=1e-12)


def norm_metrics(grads, updates=None, params=None, *,
                 backend: Optional[str] = None) -> dict:
    """Global-norm telemetry of a step, 0-d fp32 tensors: ``grad_norm``
    always; ``update_norm`` / ``param_norm`` when their trees are given;
    ``update_to_param_ratio`` when both are.  Each is a full-tree
    reduction (one M2 call on the card), so callers turn it on
    explicitly (``norm_telemetry=``)."""
    out = {"grad_norm": global_norm(grads, backend=backend)}
    if updates is not None:
        out["update_norm"] = global_norm(updates, backend=backend)
    if params is not None:
        out["param_norm"] = global_norm(params, backend=backend)
    if updates is not None and params is not None:
        out["update_to_param_ratio"] = _ratio(out["update_norm"],
                                              out["param_norm"])
    return out


class NormTelemetryState(NamedTuple):
    """Optimizer state carrying the last update's norms beside the
    wrapped optimizer's own state."""

    inner: Any
    norms: Any


def with_norm_telemetry(tx: GradientTransformation) -> GradientTransformation:
    """Wrap a transformation so every update also computes
    :func:`norm_metrics` and carries them in the state; read them after
    the step with :func:`latest_norms` / :func:`record_opt_norms`.  The
    wrapped update must receive ``params`` so the state keeps one
    structure.  A fused tail of the wrapped optimizer stays fused: the
    update norm then comes from the kernel's own partial sums."""

    def init(params):
        leaves = float_leaves(params)
        dev = leaves[0].device if leaves else None
        zeros = {k: torch.zeros((), dtype=torch.float32, device=dev)
                 for k in _NORM_KEYS}
        return NormTelemetryState(tx.init(params), zeros)

    def update(grads, state: NormTelemetryState, params=None):
        updates, inner = tx.update(grads, state.inner, params)
        norms = norm_metrics(grads, updates, params)
        for k in _NORM_KEYS:   # one structure even without params
            norms.setdefault(k, torch.zeros((), dtype=torch.float32))
        return updates, NormTelemetryState(inner, norms)

    fused_apply = None
    if tx.fused_apply is not None:
        def fused_apply(grads, state: NormTelemetryState, params, *,
                        overflow=None, model_like=None, update_norm=False,
                        backend=None):
            new_p, inner, model, usq = tx.fused_apply(
                grads, state.inner, params, overflow=overflow,
                model_like=model_like, update_norm=True, backend=backend)
            norms = {"grad_norm": global_norm(grads, backend=backend),
                     "update_norm": torch.sqrt(usq),
                     "param_norm": global_norm(params, backend=backend)}
            norms["update_to_param_ratio"] = _ratio(norms["update_norm"],
                                                    norms["param_norm"])
            if overflow is not None:
                norms = {k: torch.where(overflow, state.norms[k], v)
                         for k, v in norms.items()}
            return (new_p, NormTelemetryState(inner, norms), model,
                    usq if update_norm else None)

    return GradientTransformation(init, update, fused_apply)


def latest_norms(opt_state):
    """Host copies of the norms a ``with_norm_telemetry`` state carries
    (a dict of floats), or None for other states."""
    if isinstance(opt_state, NormTelemetryState):
        return {k: float(v) for k, v in opt_state.norms.items()}
    return None


def record_opt_norms(opt_state, prefix: str = "optim") -> None:
    """Record :func:`latest_norms` as ``<prefix>.<key>`` gauges of the
    port's metrics registry; nothing when telemetry is off or the state
    carries no norms."""
    from apex_tpu_torch.observability import metrics as _telemetry

    reg = _telemetry.registry()
    if reg is None:
        return
    norms = latest_norms(opt_state)
    if norms:
        for k, v in norms.items():
            reg.gauge(f"{prefix}.{k}").set(v)


def resolve_lr(lr: ScheduleOrScalar, step: torch.Tensor) -> torch.Tensor:
    """A constant or a schedule ``lr(step)``, as a 0-d fp32 tensor on
    ``step``'s device (a number is filled there: no host-to-device
    copy)."""
    return as_f32(lr(step) if callable(lr) else lr, step.device)
