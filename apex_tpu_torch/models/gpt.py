"""GPT train step (``apex_tpu/models/gpt.py``): the single-device branch
(``mesh=None``) of :func:`make_gpt_train_step`.

``init(generator)`` draws the parameters (``init_gpt_params``) on the
step's device and builds the :class:`~apex_tpu_torch.amp.frontend.
TrainState`; ``step(state, tokens, labels[, mask][, rng])`` is the AMP
train step of
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
from apex_tpu_torch.models.transformer_lm import (
    gpt_loss, has_dropout, init_gpt_params, step_dropout_key)
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

    ``step(state, tokens, labels[, attention_mask][, rng])`` — the mask
    only for ``attn_mask_type='padding'`` configs, ``rng`` whenever a
    dropout rate is positive, as the JAX step's trailing key: a raw JAX
    key (``[2]`` words, passed on as ``torch.uint32`` and split per
    microbatch as the JAX step splits it) or the ``[L, 5, 2]`` key words
    of ``transformer_lm.dropout_keys``, best on the step's device — returns
    ``(new_state, metrics)`` with device-tensor metrics ``loss``,
    ``overflow``, ``loss_scale`` and ``step``."""
    if (mesh is not None or seq_axis is not None or context_parallel
            or fsdp):
        raise NotImplementedError(
            "mesh, seq_axis, context_parallel and fsdp come with the "
            "distributed-training slice of the port")
    check_backend(backend)
    dev = resolve_device(device)
    has_mask = cfg.attn_mask_type == "padding"
    drops = has_dropout(cfg)

    def loss_fn(params, tokens, labels, *rest):
        mask = rest[0] if has_mask else None
        rng = rest[int(has_mask)] if drops else None
        return gpt_loss(params, tokens, labels, cfg, attention_mask=mask,
                        dropout_rng=rng, backend=backend)

    init_fn, step_fn = make_train_step(
        loss_fn, optimizer, policy_or_amp, grad_postprocess=grad_postprocess,
        norm_telemetry=norm_telemetry, overlap_comm=overlap_comm,
        device=dev, backend=backend)

    def init(generator: Optional[torch.Generator] = None):
        return init_fn(init_gpt_params(cfg, generator, dev))

    want = int(has_mask) + int(drops)

    def step(state, tokens, labels, *rest):
        if len(rest) != want:
            raise TypeError(
                f"step takes {want} argument(s) after the labels (the "
                f"padding mask for a padding config, then the dropout key "
                f"words when a dropout rate is positive); got {len(rest)}")
        tokens = torch.as_tensor(tokens, device=dev).long()
        labels = torch.as_tensor(labels, device=dev).long()
        rest = [torch.as_tensor(r, device=dev) for r in rest]
        if drops:
            rest[-1] = step_dropout_key(rest[-1], dev)
        return step_fn(state, tokens, labels, *rest)

    return init, step
