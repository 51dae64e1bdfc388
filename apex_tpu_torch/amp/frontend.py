"""amp.initialize and the single-device AMP train step
(``apex_tpu/amp/frontend.py``).

``make_train_step(loss_fn, optimizer, policy)`` returns ``(init_fn,
step_fn)``.  ``step_fn(state, *batch) -> (state, metrics)`` is a pure
function of its state: it returns a new :class:`TrainState` and leaves
the old one as it was.  In order it

1. differentiates ``loss_scale · loss_fn(policy.cast_params(masters),
   *batch)`` with respect to the fp32 masters (the cast to the
   parameter dtype is inside the graph, so each gradient arrives
   through the same dtype chain as in JAX); with ``accum_steps > 1``
   over that many equal microbatches, their scaled gradients added in
   fp32 (``multi_tensor_axpby``);
2. unscales the gradients to fp32 (divided by ``accum_steps`` in the
   same pass) and checks that all are finite (one ``multi_tensor_scale``
   launch on the card);
3. updates the loss scale (halve on overflow, double after a clean
   window);
4. applies the optimizer update to the masters and casts them to the
   parameter dtype;
5. on overflow keeps the old masters, optimizer state and step.

An optimizer with a multi-tensor kernel (FusedAdam, FusedLAMB) runs 4
and 5 as its fused tail (``GradientTransformation.fused_apply``: one M3
launch, or M2 and M4's two stages), which reads the overflow flag from
device memory and writes the model-dtype copy in the same pass; any
other optimizer's updates are applied leaf by leaf with ``torch.where``
selects.  No value is read back to the host.  ``norm_telemetry=True``
adds ``grad_norm``, ``update_norm``, ``param_norm`` and
``update_to_param_ratio`` to the metrics (``optimizers._common.
norm_metrics``; under a fused tail the update norm comes from the
kernel's partial sums).  ``backend="reference"`` pins the step's
multi-tensor ops (the unscale, the accumulation, the tail) to their
plain versions.  The unscale runs inside ``torch.profiler.
record_function("amp.unscale")`` and steps 4–5 inside
``record_function("amp.optimizer_tail")``, for profiles.

O1 and O4 (``policy.per_op_casts``) cast the params to the compute dtype
at the step boundary (norm parameters kept fp32 by the policy's
predicate) and run ``loss_fn`` inside ``amp/patch.amp_patch_scope``; the
scope is left before ``torch.autograd.grad``, so the backward is the
transpose of the cast forward, as in JAX.  With ``accum_steps > 1`` a
raw JAX key as the last argument (``[2]`` ``torch.uint32`` words: the
model steps' dropout key) is split per microbatch as the JAX step splits it
(``utils/prng``); ``[L, 5, 2]`` dropout key words raise there.
:func:`save_train_state` / :func:`restore_train_state` persist a whole
train state in the JAX package's sharded format (``apex_tpu_torch.
checkpoint``), :func:`state_dict` / :func:`load_state_dict` the scaler.

``axis_name`` names the process group the gradients are reduced over
(``apex_tpu/amp/frontend.py:106``): a ``torch.distributed`` group, or a
mesh axis name (or tuple of names) of the installed mesh
(``transformer/parallel_state``).  After the unscale the gradients are
averaged over it (``utils/collectives.grad_mean``) and the finite flag
AND-ed over it, so every rank takes the same overflow decision.
``grad_comm`` (``"fp32"``, ``"bf16"``, ``"int8"`` or a
``comm.GradCommConfig``; needs ``axis_name``) routes a compressing wire
through ``comm.reduce_gradients``; with error feedback (int8's default)
the state carries this rank's fp32 residuals in ``TrainState.
comm_state``, kept unchanged by an overflowed step.  ``overlap_comm``
(tensor-parallel comm overlap) raises ``NotImplementedError``: it comes
with the tensor-parallel slice.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional, Tuple, Union

import torch
from torch.profiler import record_function

from apex_tpu_torch import comm as comm_lib
from apex_tpu_torch.amp import scaler as scaler_lib
from apex_tpu_torch.amp.patch import amp_patch_scope
from apex_tpu_torch.amp.policy import Policy, _effective, policy_for_opt_level
from apex_tpu_torch.multi_tensor.multi_tensor_apply import multi_tensor_axpby
from apex_tpu_torch.optimizers._common import (
    apply_or_keep, float_leaves, global_norm, is_float_leaf, norm_metrics,
    rebuild, tree_map)
from apex_tpu_torch.utils import prng
from apex_tpu_torch.utils.collectives import flag_and, grad_mean
from apex_tpu_torch.utils.registry import check_backend

__all__ = ["AmpState", "TrainState", "initialize", "make_train_step",
           "resolve_group",
           "state_dict", "load_state_dict", "save_train_state",
           "restore_train_state"]


class AmpState(NamedTuple):
    """What ``amp.initialize`` hands back (policy + scaler)."""

    policy: Policy
    loss_scale_config: scaler_lib.LossScaleConfig
    loss_scale_state: scaler_lib.LossScaleState


def initialize(opt_level: Union[str, Policy] = "O1", num_losses: int = 1, *,
               device=None, **overrides):
    """Resolve an opt level into an :class:`AmpState` whose scaler state
    lives on ``device`` (default ``cuda``); ``num_losses > 1`` returns a
    list of independent states."""
    policy = policy_for_opt_level(opt_level, **overrides)

    def one():
        cfg, state = scaler_lib.init_loss_scale(policy.loss_scale,
                                                device=device)
        return AmpState(policy, cfg, state)

    if num_losses > 1:
        return [one() for _ in range(num_losses)]
    return one()


class TrainState(NamedTuple):
    step: torch.Tensor                # int32 scalar on the device
    params: Any                       # model-dtype params
    master_params: Any                # fp32 masters (== params when disabled)
    opt_state: Any
    loss_scale_state: scaler_lib.LossScaleState
    # this rank's error-feedback residuals when grad_comm compresses with
    # error feedback (comm.init_error_state layout); None otherwise
    comm_state: Any = None


def resolve_group(axis_name):
    """A process group from ``axis_name``: a mesh axis name or tuple of
    names (the installed mesh's group of this rank's line), or a group
    (``torch.distributed`` group, ``collectives.SINGLE``) as it is."""
    if isinstance(axis_name, (str, tuple)):
        from apex_tpu_torch.transformer.parallel_state import get_mesh

        return get_mesh().group(axis_name)
    return axis_name


def _is_key_words(x) -> bool:
    """The dropout key words the model steps take last (``[L, 5, 2]``
    int64, ``transformer_lm.dropout_keys``)."""
    return (torch.is_tensor(x) and x.dtype == torch.int64 and x.dim() == 3
            and tuple(x.shape[1:]) == (5, 2))


def _is_raw_key(x) -> bool:
    """A raw JAX key: ``[2]`` ``torch.uint32`` words (``jax.random.
    key_data``), the layout the JAX step recognizes as a key in the
    trailing argument; an integer tensor of another dtype is batch data,
    so a ``[2]`` int64 label tensor is split, never re-keyed."""
    return (torch.is_tensor(x) and x.dtype == torch.uint32
            and tuple(x.shape) == (2,))


def _microbatches(batch: tuple, n: int) -> list:
    """``n`` equal microbatches of every tensor's leading dimension
    (0-d tensors and other values repeat); ValueError when n does not
    divide a leading dimension.  A raw key as the last argument (the
    dropout key of the model steps) is split instead, microbatch ``i``
    taking ``jax.random.split(key, n)[i]`` (``utils/prng``), as the JAX
    step does; ``[L, 5, 2]`` key words raise (they fix one step's
    masks)."""
    keys = None
    if batch and _is_raw_key(batch[-1]):
        keys = prng.split(batch[-1], n).to(torch.uint32)
        batch = batch[:-1]
    elif batch and _is_key_words(batch[-1]):
        raise NotImplementedError(
            f"accum_steps={n} with [L, 5, 2] dropout key words: they fix "
            "one step's masks; pass the step's raw key ([2] uint32 words), "
            "which is split per microbatch as the JAX step splits it")

    def check(v):
        if torch.is_tensor(v) and v.dim() and v.shape[0] % n:
            raise ValueError(
                f"accum_steps={n} does not divide the leading batch "
                f"dimension {v.shape[0]}; pad or resize the batch so every "
                f"microbatch is equal.")
        return v

    tree_map(check, batch)

    def piece(v, i):
        if torch.is_tensor(v) and v.dim():
            m = v.shape[0] // n
            return v[i * m:(i + 1) * m]
        return v

    out = [tree_map(lambda v: piece(v, i), batch) for i in range(n)]
    if keys is not None:
        out = [mb + (keys[i],) for i, mb in enumerate(out)]
    return out


def make_train_step(loss_fn: Callable, optimizer: Any,
                    policy_or_amp: Union[str, Policy, AmpState] = "O1", *,
                    axis_name: Optional[str] = None, has_aux: bool = False,
                    grad_postprocess: Optional[Callable[[Any], Any]] = None,
                    accum_steps: int = 1, norm_telemetry: bool = False,
                    grad_comm=None, overlap_comm: Optional[bool] = None,
                    device=None, backend: Optional[str] = None
                    ) -> Tuple[Callable, Callable]:
    """Build ``(init_fn, step_fn)`` for the AMP train step (module
    docstring).  ``loss_fn(params, *batch) -> loss`` (or ``(loss, aux)``
    with ``has_aux``; ``aux`` of the last microbatch under
    ``accum_steps``) receives the params cast to the parameter dtype;
    metrics carry ``loss`` (the microbatches' mean), ``overflow``,
    ``loss_scale`` and ``step`` (this step's index) as device tensors,
    and the norms under ``norm_telemetry``."""
    if overlap_comm is not None:
        raise NotImplementedError(
            "overlap_comm (the ring collective-matmul of the tensor-parallel "
            "exits) comes with the tensor-parallel slice of the port")
    check_backend(backend)
    comm_cfg = None
    if grad_comm is not None:
        comm_cfg = comm_lib.resolve(grad_comm)
        if axis_name is None:
            raise ValueError(
                "grad_comm is a cross-rank gradient reduction spec and "
                "needs axis_name= to name the group to reduce over")
    compressing = comm_cfg is not None and comm_cfg.compresses
    use_ef = compressing and comm_cfg.use_error_feedback
    group = resolve_group(axis_name) if axis_name is not None else None
    amp_state = (policy_or_amp if isinstance(policy_or_amp, AmpState)
                 else initialize(policy_or_amp, device=device))
    policy, ls_cfg = amp_state.policy, amp_state.loss_scale_config
    fused = getattr(optimizer, "fused_apply", None)

    def own(tree):
        return tree_map(lambda x: x.detach().clone()
                        if torch.is_tensor(x) else x, tree)

    def init_fn(params) -> TrainState:
        model_params = own(policy.cast_params(params))
        master = (own(policy.cast_master(params)) if policy.master_weights
                  else model_params)
        step = torch.zeros((), dtype=torch.int32,
                           device=amp_state.loss_scale_state.loss_scale.device)
        return TrainState(step=step, params=model_params,
                          master_params=master,
                          opt_state=optimizer.init(master),
                          loss_scale_state=own(amp_state.loss_scale_state),
                          comm_state=(comm_lib.init_error_state(master)
                                      if use_ef else None))

    def scaled_grads(masters, leaves, ls_state, batch):
        """(one gradient per float master, loss, aux) of one (micro)batch."""
        with torch.enable_grad():
            params = policy.cast_params(masters)
            if policy.per_op_casts:
                # O1/O4: params in the compute dtype (norms kept fp32 by
                # the policy's predicate) and the per-op casts while the
                # forward runs; the backward runs after the scope
                params = policy.cast_to_compute(params, respect_norms=True)
                with amp_patch_scope(_effective(policy.compute_dtype)):
                    out = loss_fn(params, *batch)
            else:
                out = loss_fn(params, *batch)
            loss, aux = out if has_aux else (out, None)
            got = torch.autograd.grad(scaler_lib.scale_loss(loss, ls_state),
                                      leaves, allow_unused=True)
        return ([torch.zeros_like(p) if g is None else g
                 for p, g in zip(leaves, got)], loss.detach(), aux)

    def step_fn(state: TrainState, *batch):
        ls_state = state.loss_scale_state
        masters = tree_map(lambda p: p.detach().requires_grad_(True)
                           if is_float_leaf(p) else p, state.master_params)
        leaves = float_leaves(masters)
        if accum_steps <= 1:
            got, loss, aux = scaled_grads(masters, leaves, ls_state, batch)
        else:
            # fp32 main-grad accumulation over equal microbatches; the
            # unscale divides the sum by the count
            losses, got = [], None
            for mb in _microbatches(batch, accum_steps):
                g, mb_loss, aux = scaled_grads(masters, leaves, ls_state, mb)
                losses.append(mb_loss)
                got = g if got is None else multi_tensor_axpby(
                    got, g, 1.0, 1.0, out_dtypes=[torch.float32] * len(g),
                    backend=backend)[0]
            loss = torch.stack(losses).mean()
        grads = rebuild(masters, got)
        del got     # the unscale writes new fp32 gradients: free these
        with record_function("amp.unscale"):
            grads, finite = scaler_lib.unscale_grads(
                grads, ls_state, divide_by=max(accum_steps, 1),
                backend=backend)
        new_comm_state = state.comm_state
        if group is not None:
            with torch.no_grad(), record_function("amp.grad_reduce"):
                if compressing:
                    # residuals in unscaled fp32 units: a loss-scale
                    # change between steps leaves the carried error valid
                    grads, new_comm_state = comm_lib.reduce_gradients(
                        grads, group, comm_cfg,
                        residuals=state.comm_state if use_ef else None)
                else:
                    # the unscaled gradients are the step's own: reduce
                    # in place (no second gradient tree on the device)
                    grads = grad_mean(grads, group, inplace=True)
                finite = flag_and(finite, group)
        if grad_postprocess is not None:
            grads = grad_postprocess(grads)
        new_ls_state, overflow = scaler_lib.update_loss_scale(
            ls_cfg, ls_state, ~finite)
        if use_ef:
            # an overflowed step's residuals are garbage: keep the old
            new_comm_state = tuple(
                torch.where(overflow, old, new)
                for new, old in zip(new_comm_state, state.comm_state))

        old_master = state.master_params
        with torch.no_grad(), record_function("amp.optimizer_tail"):
            if fused is not None:
                new_master, new_opt_state, new_model, usq = fused(
                    grads, state.opt_state, old_master, overflow=overflow,
                    model_like=(state.params if policy.master_weights
                                else None),
                    update_norm=norm_telemetry, backend=backend)
                new_params = (new_model if policy.master_weights
                              else new_master)
                update_norm = torch.sqrt(usq) if norm_telemetry else None
            else:
                updates, new_opt_state = optimizer.update(
                    grads, state.opt_state, old_master)
                # overflow ⇒ keep the old masters and optimizer state
                new_master, new_opt_state = apply_or_keep(
                    old_master, updates, new_opt_state, state.opt_state,
                    overflow)
                new_params = policy.cast_params(new_master)
                update_norm = (global_norm(updates, backend=backend)
                               if norm_telemetry else None)
            new_state = TrainState(
                step=state.step + torch.where(overflow, 0, 1).to(torch.int32),
                params=new_params,
                master_params=(new_master if policy.master_weights
                               else new_params),
                opt_state=new_opt_state,
                loss_scale_state=new_ls_state,
                comm_state=new_comm_state)
        metrics = {"loss": loss, "overflow": overflow,
                   "loss_scale": new_ls_state.loss_scale,
                   "step": state.step}
        if norm_telemetry:
            with torch.no_grad():
                norms = norm_metrics(grads, params=old_master,
                                     backend=backend)
                norms["update_norm"] = update_norm
                norms["update_to_param_ratio"] = update_norm / torch.clamp(
                    norms["param_norm"], min=1e-12)
            metrics.update(norms)
        if aux is not None:
            metrics["aux"] = aux
        return new_state, metrics

    return init_fn, step_fn


# ---- checkpoint hooks (the reference's amp.state_dict / load_state_dict,
# and the full train state through apex_tpu_torch.checkpoint) -------------


def state_dict(amp_or_train_state) -> dict:
    """The loss scaler as ``{"loss_scaler0": {"loss_scale", "unskipped"}}``
    (host values), from a :class:`TrainState`, an :class:`AmpState` or a
    ``LossScaleState``."""
    ls = getattr(amp_or_train_state, "loss_scale_state", amp_or_train_state)
    return {"loss_scaler0": {"loss_scale": float(ls.loss_scale),
                             "unskipped": int(ls.unskipped)}}


def load_state_dict(d: dict, *, device=None) -> scaler_lib.LossScaleState:
    """The ``LossScaleState`` of a :func:`state_dict`, on ``device``
    (default ``cuda``)."""
    from apex_tpu_torch.utils.registry import resolve_device

    dev = resolve_device(device)
    entry = d["loss_scaler0"]
    return scaler_lib.LossScaleState(
        loss_scale=torch.tensor(float(entry["loss_scale"]),
                                dtype=torch.float32, device=dev),
        unskipped=torch.tensor(int(entry["unskipped"]), dtype=torch.int32,
                               device=dev))


def save_train_state(directory: str, step: int, state: TrainState, *,
                     keep=None, extra=None) -> str:
    """Snapshot a whole :class:`TrainState` (params, masters, optimizer
    moments, the scaler's window, the step) as a committed checkpoint,
    blocking; a training loop prefers ``checkpoint.AsyncCheckpointer``."""
    from apex_tpu_torch.checkpoint import save_sharded

    return save_sharded(directory, step, state, keep=keep, extra=extra)


def restore_train_state(directory: str, state_like: TrainState, *,
                        step=None, reshard: bool = False) -> TrainState:
    """Restore a :class:`TrainState` snapshot into the structure, dtypes
    and devices of ``state_like`` (a fresh ``init_fn`` state), bit for
    bit: the resumed run repeats the unkilled one.  ``reshard`` comes with
    the distributed-training slice."""
    from apex_tpu_torch.checkpoint import restore_sharded

    return restore_sharded(directory, state_like, step=step,
                           reshard=reshard)
