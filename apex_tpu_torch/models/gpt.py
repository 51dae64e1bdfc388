"""GPT train step (``apex_tpu/models/gpt.py``): :func:`make_gpt_train_step`
on one device (``mesh=None``) or over a data- and context-parallel mesh.

``init(generator)`` draws the parameters (``init_gpt_params``) on the
step's device and builds the :class:`~apex_tpu_torch.amp.frontend.
TrainState`; ``step(state, tokens, labels[, mask][, rng])`` is the AMP
train step of ``amp/frontend.py`` over :func:`~apex_tpu_torch.models.
transformer_lm.gpt_loss`.  Both run on ``device`` (default ``cuda``: they
raise without a card unless the caller passes ``device="cpu"``).
``backend="reference"`` pins every kernel-backed op to its plain version,
the oracle of the kernel path on the card.

With a ``mesh`` (``parallel/mesh.py``, tp = pp = ep = 1) every rank takes
the same global batch, as the JAX step's signature does, and keeps its
(dp, sp) slice: batch rows over ``dp``, sequence columns over
``seq_axis`` with core attention sequence-sharded (``context_parallel``:
``True``/``"ring"`` or ``"ulysses"``).  The math is GSPMD's: the loss is
the mean over every token of the global batch; the gradients are that
loss's (each rank's share, scaled by the group's size by the loss's
all-reduce and averaged over dp × sp), the same on every rank; the
overflow flag is the world's; the metrics are global.  Every rank
initialises the same parameters from the same generator seed.
"""

from __future__ import annotations

from typing import Any, Callable, Optional

import torch

from apex_tpu_torch.amp.frontend import make_train_step
from apex_tpu_torch.models.config import TransformerConfig
from apex_tpu_torch.models.transformer_lm import (
    gpt_loss, has_dropout, init_gpt_params, mesh_ctx, step_dropout_key)
from apex_tpu_torch.parallel.mesh import shard_batch
from apex_tpu_torch.transformer import parallel_state
from apex_tpu_torch.utils.registry import check_backend, resolve_device

__all__ = ["make_gpt_train_step"]


def _check_mesh(cfg: TransformerConfig, mesh, seq_axis, context_parallel,
                fsdp: bool) -> None:
    """The JAX step's refusals (``apex_tpu/models/gpt.py:111-134``) and
    this slice's: tp, pp, ep and FSDP come later."""
    for axis, what in (("tp", "tensor parallelism (the tensor-parallel "
                               "slice)"),
                       ("pp", "pipeline parallelism (the pipeline slice)"),
                       ("ep", "expert parallelism (the MoE EP island)")):
        if mesh.shape[axis] > 1:
            raise NotImplementedError(
                f"a mesh with {axis}={mesh.shape[axis]}: {what} comes with "
                "a later slice of the port")
    if fsdp:
        raise NotImplementedError(
            "fsdp=True (ZeRO-3 sharded masters and moments) comes with the "
            "FSDP slice of the port")
    if context_parallel:
        if cfg.attn_mask_type == "padding":
            raise ValueError(
                "context_parallel does not support "
                "attn_mask_type='padding': the ring kernels have no "
                "sharded-mask path, so masked configs would silently "
                "gather K/V (O(s_global) memory). Pack sequences with "
                "segment-free causal rows instead.")
        if cfg.attention_dropout > 0:
            raise ValueError(
                "context_parallel does not support attention_dropout "
                "> 0 (the sequence-sharded attention paths run without "
                "in-kernel dropout); set attention_dropout=0 — "
                "hidden_dropout is unaffected.")
        if context_parallel == "ulysses":
            sp_size = mesh.shape.get(seq_axis, 1) if seq_axis else 1
            heads = cfg.num_attention_heads
            if heads % sp_size:
                raise ValueError(
                    f"context_parallel='ulysses' needs num_attention_"
                    f"heads ({heads}) divisible by tp (1) and the per-tp-"
                    f"rank heads ({heads}) divisible by the '{seq_axis}' "
                    f"axis size ({sp_size}); use context_parallel='ring' "
                    "for head counts that don't factor.")


def make_gpt_train_step(cfg: TransformerConfig, optimizer: Any,
                        policy_or_amp="O2", mesh=None, *,
                        seq_axis: Optional[str] = None,
                        context_parallel=False,
                        grad_postprocess: Optional[Callable] = None,
                        fsdp: bool = False, norm_telemetry: bool = False,
                        overlap_comm: Optional[bool] = None, device=None,
                        backend: Optional[str] = None):
    """AMP train step → ``(init, step)`` (module docstring).

    ``step(state, tokens, labels[, attention_mask][, rng])`` — the mask
    only for ``attn_mask_type='padding'`` configs, ``rng`` whenever a
    dropout rate is positive, as the JAX step's trailing key: a raw JAX
    key (``[2]`` words, passed on as ``torch.uint32`` and split per
    microbatch as the JAX step splits it) or the ``[L, 5, 2]`` key words
    of ``transformer_lm.dropout_keys``, best on the step's device — returns
    ``(new_state, metrics)`` with device-tensor metrics ``loss``,
    ``overflow``, ``loss_scale`` and ``step``.  ``mesh``, ``seq_axis``
    and ``context_parallel`` as the JAX step's; a mesh with tp, pp or ep
    above 1, ``fsdp=True`` and ``overlap_comm`` raise
    ``NotImplementedError`` naming their later slice."""
    if overlap_comm is not None:
        raise NotImplementedError(
            "overlap_comm (the ring collective-matmul of the tensor-parallel "
            "exits) comes with the tensor-parallel slice of the port")
    if mesh is None and (seq_axis is not None or context_parallel or fsdp):
        raise ValueError("seq_axis, context_parallel and fsdp need a mesh")
    check_backend(backend)
    dev = resolve_device(device)
    has_mask = cfg.attn_mask_type == "padding"
    drops = has_dropout(cfg)
    ctx, group = None, None
    if mesh is not None:
        _check_mesh(cfg, mesh, seq_axis, context_parallel, fsdp)
        parallel_state.install_mesh(mesh)
        ctx = mesh_ctx(mesh, seq_axis=seq_axis,
                       context_parallel=context_parallel)
        group = ctx.loss_group

    def loss_fn(params, tokens, labels, *rest):
        mask = rest[0] if has_mask else None
        rng = rest[int(has_mask)] if drops else None
        return gpt_loss(params, tokens, labels, cfg, attention_mask=mask,
                        dropout_rng=rng, backend=backend, ctx=ctx)

    init_fn, step_fn = make_train_step(
        loss_fn, optimizer, policy_or_amp, grad_postprocess=grad_postprocess,
        norm_telemetry=norm_telemetry, overlap_comm=overlap_comm,
        device=dev, backend=backend, axis_name=group)

    def init(generator: Optional[torch.Generator] = None):
        return init_fn(init_gpt_params(cfg, generator, dev))

    want = int(has_mask) + int(drops)

    def local(x, seq: bool):
        """This rank's (dp[, sp]) slice of a global batch tensor."""
        x = torch.as_tensor(x)
        if mesh is None:
            return x
        x = shard_batch(mesh, x, axis="dp")
        return shard_batch(mesh, x, axis=seq_axis, dim=1) \
            if seq and seq_axis else x

    def step(state, tokens, labels, *rest):
        if len(rest) != want:
            raise TypeError(
                f"step takes {want} argument(s) after the labels (the "
                f"padding mask for a padding config, then the dropout key "
                f"words when a dropout rate is positive); got {len(rest)}")
        tokens = local(tokens, True).to(dev).long()
        labels = local(labels, True).to(dev).long()
        rest = list(rest)
        if has_mask:
            # the key-padding rows of this rank's batch, every key
            rest[0] = local(rest[0], False).to(dev)
        if drops:
            rest[-1] = step_dropout_key(torch.as_tensor(rest[-1]).to(dev),
                                        dev)
        return step_fn(state, tokens, labels, *rest)

    return init, step
