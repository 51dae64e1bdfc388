"""amp.initialize and the single-device AMP train step
(``apex_tpu/amp/frontend.py``).

``make_train_step(loss_fn, optimizer, policy)`` returns ``(init_fn,
step_fn)``.  ``step_fn(state, *batch) -> (state, metrics)`` is a pure
function of its state: it returns a new :class:`TrainState` and leaves
the old one as it was.  In order it

1. differentiates ``loss_scale · loss_fn(policy.cast_params(masters),
   *batch)`` with respect to the fp32 masters (the cast to the
   parameter dtype is inside the graph, so each gradient arrives
   through the same dtype chain as in JAX);
2. unscales the gradients to fp32 and checks that all are finite;
3. updates the loss scale (halve on overflow, double after a clean
   window);
4. applies the optimizer update to the masters;
5. on overflow keeps the old masters, optimizer state and step by a
   device-side ``torch.where`` — no value is read back to the host.

Not in this slice (they raise ``NotImplementedError``): ``axis_name``,
``grad_comm``, ``overlap_comm`` (distributed training), ``accum_steps >
1``, ``norm_telemetry``, and the per-op-cast levels O1/O4.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional, Tuple, Union

import torch

from apex_tpu_torch.amp import scaler as scaler_lib
from apex_tpu_torch.amp.policy import Policy, policy_for_opt_level
from apex_tpu_torch.optimizers._common import (
    is_float_leaf, tree_leaves, tree_map)

__all__ = ["AmpState", "TrainState", "initialize", "make_train_step"]


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


def _later_slice(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} comes with the distributed-training slice of the port")


def make_train_step(loss_fn: Callable, optimizer: Any,
                    policy_or_amp: Union[str, Policy, AmpState] = "O1", *,
                    axis_name: Optional[str] = None, has_aux: bool = False,
                    grad_postprocess: Optional[Callable[[Any], Any]] = None,
                    accum_steps: int = 1, norm_telemetry: bool = False,
                    grad_comm=None, overlap_comm: Optional[bool] = None,
                    device=None) -> Tuple[Callable, Callable]:
    """Build ``(init_fn, step_fn)`` for the AMP train step (module
    docstring).  ``loss_fn(params, *batch) -> loss`` (or ``(loss, aux)``
    with ``has_aux``) receives the params cast to the parameter dtype;
    metrics carry ``loss``, ``overflow``, ``loss_scale`` and ``step``
    (this step's index) as device tensors."""
    if axis_name is not None:
        raise _later_slice("axis_name (data-parallel gradient reduction)")
    if grad_comm is not None:
        raise _later_slice("grad_comm (compressed gradient collectives)")
    if overlap_comm is not None:
        raise _later_slice("overlap_comm (tensor-parallel comm overlap)")
    if accum_steps != 1:
        raise _later_slice("accum_steps > 1 (fp32 main-grad accumulation)")
    if norm_telemetry:
        raise _later_slice("norm_telemetry")
    amp_state = (policy_or_amp if isinstance(policy_or_amp, AmpState)
                 else initialize(policy_or_amp, device=device))
    policy, ls_cfg = amp_state.policy, amp_state.loss_scale_config
    if policy.per_op_casts:
        raise NotImplementedError(
            f"opt level {policy.opt_level} casts per op (the JAX "
            "amp_patch_scope); only the parameter-cast levels O0, O2, O3 "
            "and O5 are ported")

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
                          loss_scale_state=own(amp_state.loss_scale_state))

    def step_fn(state: TrainState, *batch):
        ls_state = state.loss_scale_state
        masters = tree_map(lambda p: p.detach().requires_grad_(True)
                           if is_float_leaf(p) else p, state.master_params)
        leaves = [p for p in tree_leaves(masters) if is_float_leaf(p)]
        with torch.enable_grad():
            out = loss_fn(policy.cast_params(masters), *batch)
            loss, aux = out if has_aux else (out, None)
            got = torch.autograd.grad(scaler_lib.scale_loss(loss, ls_state),
                                      leaves, allow_unused=True)
        by_id = {id(p): (torch.zeros_like(p) if g is None else g)
                 for p, g in zip(leaves, got)}
        grads = tree_map(lambda p: by_id.get(id(p), p), masters)
        grads, finite = scaler_lib.unscale_grads(grads, ls_state)
        if grad_postprocess is not None:
            grads = grad_postprocess(grads)
        new_ls_state, overflow = scaler_lib.update_loss_scale(
            ls_cfg, ls_state, ~finite)

        with torch.no_grad():
            old_master = state.master_params
            updates, new_opt_state = optimizer.update(
                grads, state.opt_state, old_master)
            new_master = tree_map(lambda p, u: p + u.to(p.dtype),
                                  old_master, updates)

            # overflow ⇒ keep the old masters and optimizer state
            def select(new, old):
                return tree_map(lambda n, o: torch.where(overflow, o, n),
                                new, old)

            new_master = select(new_master, old_master)
            new_opt_state = select(new_opt_state, state.opt_state)
            new_params = policy.cast_params(new_master)
            new_state = TrainState(
                step=state.step + torch.where(overflow, 0, 1).to(torch.int32),
                params=new_params,
                master_params=(new_master if policy.master_weights
                               else new_params),
                opt_state=new_opt_state,
                loss_scale_state=new_ls_state)
        metrics = {"loss": loss.detach(), "overflow": overflow,
                   "loss_scale": new_ls_state.loss_scale,
                   "step": state.step}
        if aux is not None:
            metrics["aux"] = aux
        return new_state, metrics

    return init_fn, step_fn
