"""Data-parallel training (``apex_tpu/parallel/distributed.py``), the
apex DDP equivalent over ``torch.distributed``.

- :func:`allreduce_gradients` — average (or sum) a gradient tree over a
  group, with the reference's ``allreduce_always_fp32``,
  ``gradient_predivide_factor`` and ``gradient_average``
  (apex/parallel/distributed.py:129), or through ``comm``'s compressed
  collectives under ``grad_comm=``;
- :class:`DistributedDataParallel` — wraps a loss so that its gradients
  come back reduced (a backward hook on the parameters' gradients: the
  forward is untouched);
- :class:`Reducer` — the manual reduction (distributed.py:89);
- :func:`make_ddp_train_step` — the whole AMP step over a mesh's ``dp``
  axis: every rank takes the same global batch, keeps its dp shard, and
  reduces its gradients; the found-inf flag is AND-ed and the float
  metrics averaged over dp.  With error feedback the state carries this
  rank's own residuals (``TrainState.comm_state``).

Parameters are replicated: every rank initialises them from the same
seed (``parallel.mesh.replicate`` broadcasts a tree when they might
differ).
"""

from __future__ import annotations

from typing import Any, Callable, Optional

import torch

from apex_tpu_torch.amp.frontend import make_train_step, resolve_group
from apex_tpu_torch.optimizers._common import is_float_leaf, tree_map
from apex_tpu_torch.parallel.mesh import Mesh, create_mesh, shard_batch
from apex_tpu_torch.transformer import parallel_state
from apex_tpu_torch.utils.collectives import all_reduce, group_size
from apex_tpu_torch.utils.registry import resolve_device

__all__ = ["DistributedDataParallel", "Reducer", "allreduce_gradients",
           "make_ddp_train_step"]


def allreduce_gradients(grads: Any, axis_name="dp", *,
                        allreduce_always_fp32: bool = False,
                        gradient_average: bool = True,
                        gradient_predivide_factor: Optional[float] = None,
                        grad_comm=None) -> Any:
    """apex DDP's ``allreduce_bucket`` semantics (distributed.py:426-470)
    as one function over ``axis_name`` (a mesh axis of the installed
    mesh, or a group).  ``grad_comm`` (``"bf16"``, ``"int8"``, a
    ``comm.GradCommConfig``) routes through the compressed collectives
    without error feedback (this entry keeps no state between calls)."""
    group = resolve_group(axis_name)
    if grad_comm is not None:
        from apex_tpu_torch import comm as comm_lib

        cfg = comm_lib.resolve(grad_comm)
        if cfg is not None and cfg.compresses:
            reduced, _ = comm_lib.reduce_gradients(
                grads, group, cfg, average=gradient_average,
                predivide=gradient_predivide_factor)
            return reduced
    n = group_size(group)

    def red(g):
        if not is_float_leaf(g):
            return g
        orig = g.dtype
        if allreduce_always_fp32:
            g = g.float()
        if gradient_predivide_factor:
            g = g / gradient_predivide_factor
        g = all_reduce(g, group)
        if gradient_average:
            g = g / (n / gradient_predivide_factor
                     if gradient_predivide_factor else n)
        return g.to(orig)

    return tree_map(red, grads)


class DistributedDataParallel:
    """``fn(params, *batch)`` whose parameter gradients come back reduced
    over ``axis_name``: the call registers a hook on every float
    parameter that requires a gradient, reducing the gradient that
    autograd hands it (the reference's grad hooks), so
    ``torch.autograd.grad(ddp(params, *batch), leaves)`` is already
    averaged.  Options as :func:`allreduce_gradients` (compression here
    runs leaf by leaf, without buckets)."""

    def __init__(self, fn: Callable, axis_name="dp",
                 allreduce_always_fp32: bool = False,
                 gradient_average: bool = True,
                 gradient_predivide_factor: Optional[float] = None,
                 grad_comm=None):
        self.fn = fn
        self.axis_name = axis_name
        self.opts = dict(allreduce_always_fp32=allreduce_always_fp32,
                         gradient_average=gradient_average,
                         gradient_predivide_factor=gradient_predivide_factor,
                         grad_comm=grad_comm)

    def _hooked(self, params):
        def hook(g):
            return allreduce_gradients(g, self.axis_name, **self.opts)

        def leaf(p):
            if is_float_leaf(p) and p.requires_grad:
                p = p.view_as(p)
                p.register_hook(hook)
            return p

        return tree_map(leaf, params)

    def __call__(self, params, *batch):
        return self.fn(self._hooked(params), *batch)


class Reducer:
    """The manual-reduction variant (reference ``Reducer``,
    distributed.py:89): ``reduce(grads)`` when accumulation is done;
    every :func:`allreduce_gradients` option passes through."""

    def __init__(self, axis_name="dp", **opts):
        self.axis_name = axis_name
        self.opts = opts

    def reduce(self, grads):
        return allreduce_gradients(grads, self.axis_name, **self.opts)


def make_ddp_train_step(loss_fn: Callable, optimizer, policy_or_amp="O0",
                        mesh: Optional[Mesh] = None, *, batch_axes: int = 1,
                        grad_comm=None, device=None,
                        backend: Optional[str] = None, **step_opts):
    """Whole-step DDP → ``(init_fn, step_fn)``: the AMP step of
    ``amp.make_train_step(axis_name=<the dp group>, grad_comm=)``.
    ``step_fn(state, *batch)`` takes the global batch (the same on every
    rank, as the JAX step's signature does): the first ``batch_axes``
    arguments are cut along their leading dimension into the dp size's
    equal parts, this rank keeping its own (``shard_batch``); the rest
    pass whole.  Float metrics come back averaged over dp; the overflow
    flag is the world's.  Installs ``mesh`` (default: every rank on dp)
    for ``parallel_state``.  ``step_opts`` go to ``amp.make_train_step``
    (``norm_telemetry``, ``accum_steps``, ...); the batch shards move to
    ``device`` (default ``cuda``)."""
    if mesh is None:
        mesh = create_mesh()
    parallel_state.install_mesh(mesh)
    group = mesh.group("dp")
    init_fn, step = make_train_step(
        loss_fn, optimizer, policy_or_amp, axis_name=group,
        grad_comm=grad_comm, device=device, backend=backend, **step_opts)
    n = mesh.shape["dp"]
    dev = resolve_device(device)

    def step_fn(state, *batch):
        # cut, then move: only this rank's shard crosses to the device
        local = tuple(shard_batch(mesh, torch.as_tensor(x), axis="dp").to(dev)
                      if i < batch_axes else x for i, x in enumerate(batch))
        new_state, metrics = step(state, *local)
        if n > 1:
            metrics = {k: (all_reduce(v, group, kind="pmean") / n
                           if torch.is_tensor(v) and v.is_floating_point()
                           else v)
                       for k, v in metrics.items()}
        return new_state, metrics

    return init_fn, step_fn
