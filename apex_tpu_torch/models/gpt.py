"""GPT train step (``apex_tpu/models/gpt.py``): the single-device branch
(``mesh=None``) of :func:`make_gpt_train_step`.

``init(generator)`` draws the parameters (``init_gpt_params``) on the
step's device and builds the :class:`~apex_tpu_torch.amp.frontend.
TrainState`; ``step(state, tokens, labels)`` is the AMP train step of
``amp/frontend.py`` over :func:`~apex_tpu_torch.models.transformer_lm.
gpt_loss`.  Both run on ``device`` (default ``cuda``: they raise without
a card unless the caller passes ``device="cpu"``).  ``backend=
"reference"`` pins every kernel-backed op to its plain version, the
oracle of the kernel path on the card.  The mesh, sequence/context
parallel and FSDP arguments belong to the distributed-training slice.
"""

from __future__ import annotations

from typing import Any, Callable, Optional

import torch

from apex_tpu_torch.amp.frontend import make_train_step
from apex_tpu_torch.models.config import TransformerConfig
from apex_tpu_torch.models.transformer_lm import gpt_loss, init_gpt_params
from apex_tpu_torch.utils.registry import check_backend, resolve_device

__all__ = ["make_gpt_train_step"]


def make_gpt_train_step(cfg: TransformerConfig, optimizer: Any,
                        policy_or_amp="O2", mesh=None, *,
                        seq_axis: Optional[str] = None,
                        context_parallel=False,
                        grad_postprocess: Optional[Callable] = None,
                        fsdp: bool = False, norm_telemetry: bool = False,
                        overlap_comm: Optional[bool] = None, device=None,
                        backend: Optional[str] = None):
    """Single-device AMP train step → ``(init, step)``.

    ``step(state, tokens, labels[, attention_mask])`` — the mask only for
    ``attn_mask_type='padding'`` configs — returns ``(new_state,
    metrics)`` with device-tensor metrics ``loss``, ``overflow``,
    ``loss_scale`` and ``step``."""
    if (mesh is not None or seq_axis is not None or context_parallel
            or fsdp):
        raise NotImplementedError(
            "mesh, seq_axis, context_parallel and fsdp come with the "
            "distributed-training slice of the port")
    check_backend(backend)
    dev = resolve_device(device)
    has_mask = cfg.attn_mask_type == "padding"

    def loss_fn(params, tokens, labels, *rest):
        mask = rest[0] if has_mask else None
        return gpt_loss(params, tokens, labels, cfg, attention_mask=mask,
                        backend=backend)

    init_fn, step_fn = make_train_step(
        loss_fn, optimizer, policy_or_amp, grad_postprocess=grad_postprocess,
        norm_telemetry=norm_telemetry, overlap_comm=overlap_comm,
        device=dev)

    def init(generator: Optional[torch.Generator] = None):
        return init_fn(init_gpt_params(cfg, generator, dev))

    def step(state, tokens, labels, *rest):
        tokens = torch.as_tensor(tokens, device=dev).long()
        labels = torch.as_tensor(labels, device=dev).long()
        rest = tuple(torch.as_tensor(r, device=dev) for r in rest)
        return step_fn(state, tokens, labels, *rest)

    return init, step
