"""Rollback to the last good checkpoint with a learning-rate re-warm
(``apex_tpu/checkpoint/recovery.py``).

:class:`RecoveryManager` sits at a training loop's step boundary::

    mgr = RecoveryManager(ckpt_dir, save_every=100, keep=3)
    for batch in data:
        state, metrics = step_fn(state, *batch)
        state, rolled_back = mgr.after_step(state, metrics)
        if rolled_back:
            step_fn = rebuild_step(lr=mgr.rewarm_schedule(base_lr))

``after_step`` rolls back when the step's loss is not finite, or when an
anomaly event of a trigger kind (``anomaly.nan_inf``,
``anomaly.loss_spike``, ``anomaly.grad_norm_explosion``) reached the
metrics registry since the last step (the detector bank of
:mod:`~apex_tpu_torch.observability.detectors` fires them from
``record_step_metrics``).  A rollback waits out the save
in flight, restores the newest committed checkpoint bit for bit into the
live state's structure, opens a re-warm window (``lr_scale`` ramps from
``lr_scale_floor`` to 1 over ``rewarm_steps`` steps from the restored
step), and records the incident: counter ``checkpoint.rollbacks``, event
``anomaly.rollback``, a warning on the ``checkpoint`` logger.  Otherwise
it snapshots every ``save_every`` clean steps through its
:class:`~apex_tpu_torch.checkpoint.async_saver.AsyncCheckpointer`.  More
than ``max_rollbacks`` rollbacks raise :class:`RecoveryGivingUp`; a
firing with no committed checkpoint raises ``CheckpointError``.
"""

from __future__ import annotations

import math
from typing import Any, NamedTuple, Optional, Tuple

import torch

from apex_tpu_torch.checkpoint import sharded as _sharded
from apex_tpu_torch.checkpoint.async_saver import AsyncCheckpointer
from apex_tpu_torch.observability import metrics as _telemetry
from apex_tpu_torch.utils.logging import get_logger

__all__ = ["RecoveryManager", "RecoveryGivingUp", "RollbackConfig"]


class RollbackConfig(NamedTuple):
    """Rollback and re-warm policy (the JAX package's fields)."""

    rewarm_steps: int = 100
    lr_scale_floor: float = 0.1
    max_rollbacks: int = 3
    trigger_kinds: Tuple[str, ...] = (
        "nan_inf", "loss_spike", "grad_norm_explosion")


class RecoveryGivingUp(RuntimeError):
    """More than ``max_rollbacks`` rollbacks: the divergence is
    systematic."""


def _scalar(v) -> Optional[float]:
    if v is None:
        return None
    try:
        return float(v.item() if torch.is_tensor(v) else v)
    except (TypeError, ValueError, RuntimeError):
        return None


class RecoveryManager:
    """Periodic snapshots and automatic rollback (module docstring)."""

    def __init__(self, directory: str, *, save_every: int = 100,
                 keep: int = 3, saver: Optional[AsyncCheckpointer] = None,
                 config: RollbackConfig = RollbackConfig()):
        if save_every < 1:
            raise ValueError(f"save_every={save_every} must be >= 1")
        self.directory = directory
        self.save_every = int(save_every)
        self.config = config
        self.saver = saver or AsyncCheckpointer(directory, keep=keep)
        self.rollbacks = 0
        self.last_rollback_step: Optional[int] = None
        self._rewarm_anchor: Optional[int] = None
        self._last_step: Optional[int] = None
        self._last_saved_step: Optional[int] = None
        # the newest event seen: anomalies before this manager existed
        # are history, not triggers
        self._seen_event = self._newest_event()

    def after_step(self, state: Any, metrics: dict) -> Tuple[Any, bool]:
        """Roll back if the step went bad, else maybe snapshot: ``(state,
        rolled_back)``, the restored state when ``rolled_back``."""
        step = self._state_step(state, metrics)
        self._last_step = step
        if self._anomaly_fired(metrics):
            return self._rollback(state, step), True
        # a scaler-skipped step leaves the counter where it was: do not
        # re-save the same step
        if (step is not None and step > 0 and step % self.save_every == 0
                and step != self._last_saved_step):
            self._last_saved_step = step
            self.saver.save(step, state, extra={"rollbacks": self.rollbacks})
        return state, False

    def lr_scale(self, step: Optional[int] = None) -> float:
        """1.0, or after a rollback the linear ramp ``floor → 1`` over
        ``rewarm_steps`` steps from the restored step."""
        if self._rewarm_anchor is None:
            return 1.0
        step = self._last_step if step is None else step
        if step is None:
            return self.config.lr_scale_floor
        frac = min(1.0, max(0.0, (step - self._rewarm_anchor)
                            / max(1, self.config.rewarm_steps)))
        return (self.config.lr_scale_floor
                + (1.0 - self.config.lr_scale_floor) * frac)

    def rewarm_schedule(self, base_lr):
        """A schedule ``lr(step)`` (the optimizers take one): ``base_lr``
        (a number or a schedule) times the re-warm ramp anchored at the
        last rollback, as an fp32 tensor on the step's device."""
        anchor = self._rewarm_anchor
        floor = self.config.lr_scale_floor
        window = max(1, self.config.rewarm_steps)

        def schedule(step):
            base = base_lr(step) if callable(base_lr) else base_lr
            step = torch.as_tensor(step)
            base = torch.as_tensor(base, dtype=torch.float32,
                                   device=step.device)
            if anchor is None:
                return base
            frac = torch.clamp((step.float() - anchor) / window, 0.0, 1.0)
            return base * (floor + (1.0 - floor) * frac)

        return schedule

    @staticmethod
    def _state_step(state: Any, metrics: dict) -> Optional[int]:
        """The state's own step counter (post-increment; scaler-skipped
        steps leave it), else the metrics' ``step``."""
        v = getattr(state, "step", None)
        if v is None:
            v = metrics.get("step")
        s = _scalar(v)
        return None if s is None else int(s)

    @staticmethod
    def _newest_event():
        reg = _telemetry.registry()
        return reg.events[-1] if reg is not None and reg.events else None

    def _trigger_events(self) -> int:
        """Trigger-kind anomaly events since the last look."""
        reg = _telemetry.registry()
        if reg is None:
            return 0
        names = {f"anomaly.{k}" for k in self.config.trigger_kinds}
        fired = 0
        for ev in reversed(reg.events):
            if ev is self._seen_event:
                break
            fired += ev["name"] in names
        self._seen_event = reg.events[-1] if reg.events else None
        return fired

    def _anomaly_fired(self, metrics: dict) -> bool:
        fired = self._trigger_events() > 0
        loss = _scalar(metrics.get("loss"))
        return fired or (loss is not None and not math.isfinite(loss))

    def _rollback(self, state: Any, step: Optional[int]) -> Any:
        self.saver.wait()   # the last pre-anomaly snapshot must be durable
        to_step = _sharded.latest_step(self.directory)
        if to_step is None:
            raise _sharded.CheckpointError(
                "anomaly fired but no committed checkpoint exists to roll "
                f"back to under {self.directory} (save_every="
                f"{self.save_every} never landed a snapshot)")
        self.rollbacks += 1
        if self.rollbacks > self.config.max_rollbacks:
            raise RecoveryGivingUp(
                f"rolled back {self.rollbacks - 1} times already "
                f"(max_rollbacks={self.config.max_rollbacks}); the "
                "divergence is systematic")
        restored = _sharded.restore_sharded(self.directory, state,
                                            step=to_step)
        self.last_rollback_step = to_step
        self._rewarm_anchor = to_step
        self._last_step = to_step
        # do not rewrite the snapshot just restored when the counter
        # passes its step again
        self._last_saved_step = to_step
        _telemetry.counter("checkpoint.rollbacks").inc()
        detail = dict(from_step=step, to_step=to_step,
                      rollback_count=self.rollbacks,
                      rewarm_steps=self.config.rewarm_steps,
                      lr_scale_floor=self.config.lr_scale_floor)
        reg = _telemetry.registry()
        if reg is not None and reg.detectors is not None:
            # fires anomaly.rollback (not a trigger kind) and re-arms the
            # NaN first-seen latch for the next incident
            reg.detectors.record_rollback(from_step=step, to_step=to_step,
                                          detail=detail)
        else:
            _telemetry.event("anomaly.rollback", **detail)
        self._seen_event = self._newest_event()
        get_logger("checkpoint").warning(
            "rollback %d/%d: anomaly at step %s -> restored step %s; LR "
            "re-warm %.2gx -> 1.0x over %d steps", self.rollbacks,
            self.config.max_rollbacks, step, to_step,
            self.config.lr_scale_floor, self.config.rewarm_steps)
        return restored
