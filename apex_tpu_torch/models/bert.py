"""BERT: the bidirectional encoder with its MLM and NSP pretraining heads
(``apex_tpu/models/bert.py``), single device.

GPT's parameter layout and decoder stack (``models/transformer_lm.py``,
``attn_mask_type='padding'``) plus token-type embeddings, the embedding
LayerNorm, the Megatron LM head (dense + tanh-gelu + LayerNorm, then the
tied word-embedding decoder + bias) and the NSP head (tanh pooler over
position 0, then a 2-way classifier).  On the card attention runs
kernel K2 forward and row 5 backward (``attention_backend='flash'``,
the default) or kernel row 11 over materialized scores
(``'fused_softmax'``, the reference Apex BERT's path); every norm runs
K1 forward and K5 backward.  The JAX package's casts: the MLM decoder
multiplies compute-dtype operands with fp32 products and sums and adds
the bias in fp32; the pooler and classifier run in fp32.
"""

from __future__ import annotations

from typing import Any, Callable, Optional, Union

import torch
import torch.nn.functional as F

from apex_tpu_torch.amp.frontend import make_train_step
from apex_tpu_torch.models.config import TransformerConfig, bert_large
from apex_tpu_torch.models.transformer_lm import (
    apply_norm, embed_tokens, has_dropout, init_gpt_params,
    step_dropout_key, transformer_backbone)
from apex_tpu_torch.ops.layer_norm import fused_layer_norm
from apex_tpu_torch.ops.xentropy import softmax_cross_entropy_loss
from apex_tpu_torch.utils.registry import check_backend, resolve_device

__all__ = ["init_bert_params", "bert_forward", "bert_pretrain_loss",
           "make_bert_train_step", "bert_large"]


def init_bert_params(cfg: TransformerConfig,
                     generator: Optional[torch.Generator] = None,
                     device: Union[str, torch.device, None] = None,
                     num_tokentypes: int = 2) -> dict:
    """GPT's parameters (:func:`init_gpt_params`) plus BERT's: token-type
    embeddings, the embedding LayerNorm, the MLM head and the NSP
    pooler/classifier, N(0, std) weights drawn on the CPU from
    ``generator`` (default: seed 0) after GPT's, unit scales and zero
    biases, on ``device`` (default ``cuda``)."""
    _check_dense(cfg)
    dev = resolve_device(device)
    gen = generator if generator is not None else \
        torch.Generator().manual_seed(0)
    params = init_gpt_params(cfg, gen, dev)
    h, std, dt = cfg.hidden_size, cfg.init_method_std, cfg.params_dtype

    def nrm(shape):
        return (torch.randn(shape, generator=gen, dtype=torch.float32)
                * std).to(device=dev, dtype=dt)

    def const(shape, value):
        return torch.full(shape, value, dtype=dt, device=dev)

    params["embedding"]["tokentype"] = nrm((num_tokentypes, h))
    params["embedding_ln"] = {"scale": const((h,), 1.0),
                              "bias": const((h,), 0.0)}
    params["lm_head"] = {
        "dense_kernel": nrm((h, h)),
        "dense_bias": const((h,), 0.0),
        "ln_scale": const((h,), 1.0),
        "ln_bias": const((h,), 0.0),
        "decoder_bias": const((cfg.vocab_size,), 0.0),
    }
    params["binary_head"] = {
        "pooler_kernel": nrm((h, h)),
        "pooler_bias": const((h,), 0.0),
        "cls_kernel": nrm((h, 2)),
        "cls_bias": const((2,), 0.0),
    }
    return params


def _check_dense(cfg: TransformerConfig) -> None:
    if cfg.num_experts:
        raise NotImplementedError(
            "BERT is a dense encoder in the port: num_experts is for the "
            "GPT family (models/transformer_lm.py)")


def _padding_mask(attention_mask):
    """``[b, s]`` validity (1 = real token) → ``[b, s]`` bool key-padding
    mask (True = masked)."""
    if attention_mask is None:
        return None
    return attention_mask == 0


def bert_forward(params: dict, tokens, cfg: TransformerConfig, *,
                 tokentype_ids=None, attention_mask=None, dropout_rng=None,
                 backend: Optional[str] = None):
    """→ ``(lm_logits [b, s, v] fp32, binary_logits [b, 2] fp32)``."""
    _check_dense(cfg)
    cd = cfg.compute_dtype
    emb = params["embedding"]
    h = embed_tokens(emb, tokens, cfg)
    if tokentype_ids is not None:
        h = h + emb["tokentype"].to(cd)[tokentype_ids]
    h = fused_layer_norm(h, params["embedding_ln"]["scale"],
                         params["embedding_ln"]["bias"],
                         eps=cfg.layernorm_epsilon, backend=backend)
    h = transformer_backbone(params, h, cfg,
                             attention_mask=_padding_mask(attention_mask),
                             dropout_rng=dropout_rng, backend=backend)

    lm = params["lm_head"]
    # jax.nn.gelu's default is the tanh approximation
    g = F.gelu(h @ lm["dense_kernel"].to(cd) + lm["dense_bias"].to(cd),
               approximate="tanh")
    g = apply_norm(cfg, g, lm["ln_scale"], lm["ln_bias"], backend=backend)
    lm_logits = (g.float() @ emb["word"].to(cd).float().t()
                 + lm["decoder_bias"].float())

    bh = params["binary_head"]
    pooled = torch.tanh(h[:, 0].float() @ bh["pooler_kernel"].float()
                        + bh["pooler_bias"].float())
    binary_logits = (pooled @ bh["cls_kernel"].float()
                     + bh["cls_bias"].float())
    return lm_logits, binary_logits


def bert_pretrain_loss(params: dict, tokens, mlm_labels, nsp_labels,
                       cfg: TransformerConfig, *, tokentype_ids=None,
                       attention_mask=None, dropout_rng=None,
                       backend: Optional[str] = None):
    """MLM cross-entropy over the positions whose label is ≥ 0 (-1 is
    ignored) plus the NSP cross-entropy, an fp32 scalar."""
    lm_logits, bin_logits = bert_forward(
        params, tokens, cfg, tokentype_ids=tokentype_ids,
        attention_mask=attention_mask, dropout_rng=dropout_rng,
        backend=backend)
    v = lm_logits.shape[-1]
    flat_labels = mlm_labels.reshape(-1)
    valid = flat_labels >= 0
    per_tok = softmax_cross_entropy_loss(
        lm_logits.reshape(-1, v), torch.clamp(flat_labels, 0, v - 1),
        padding_idx=None)
    denom = torch.clamp(valid.sum(), min=1)
    mlm_loss = torch.where(valid, per_tok, 0.0).sum() / denom
    nsp_lp = torch.log_softmax(bin_logits, dim=-1)
    nsp_loss = -nsp_lp.gather(1, nsp_labels.long()[:, None]).mean()
    return mlm_loss + nsp_loss


def make_bert_train_step(cfg: TransformerConfig, optimizer: Any,
                         policy_or_amp="O2", mesh=None, *,
                         grad_postprocess: Optional[Callable] = None,
                         device=None, backend: Optional[str] = None):
    """Single-device AMP train step → ``(init, step)``: ``init(generator)``
    draws the parameters on the step's device and builds the
    ``TrainState``; ``step(state, tokens, mlm_labels, nsp_labels,
    tokentype_ids, attention_mask[, rng])`` returns ``(new_state,
    metrics)`` (device-tensor ``loss``, ``overflow``, ``loss_scale``,
    ``step``); ``rng``, a raw JAX key (``[2]`` words, split per
    microbatch under ``accum_steps``) or the ``[L, 5, 2]`` dropout key
    words (``transformer_lm.dropout_keys``), whenever a dropout rate is
    positive, as the JAX step's trailing key.  Runs on ``device``
    (default ``cuda``); ``backend="reference"`` pins every kernel-backed
    op to its plain version.  The mesh belongs to a later slice."""
    if mesh is not None:
        raise NotImplementedError(
            "BERT's mesh comes with a later distributed-training slice of "
            "the port (data/context-parallel training covers GPT)")
    check_backend(backend)
    dev = resolve_device(device)

    drops = has_dropout(cfg)

    def loss_fn(params, tokens, mlm_labels, nsp_labels, tokentype_ids,
                attention_mask, *rng):
        return bert_pretrain_loss(
            params, tokens, mlm_labels, nsp_labels, cfg,
            tokentype_ids=tokentype_ids, attention_mask=attention_mask,
            dropout_rng=rng[0] if drops else None, backend=backend)

    init_fn, step_fn = make_train_step(
        loss_fn, optimizer, policy_or_amp, grad_postprocess=grad_postprocess,
        device=dev, backend=backend)

    def init(generator: Optional[torch.Generator] = None):
        return init_fn(init_bert_params(cfg, generator, dev))

    def step(state, tokens, mlm_labels, nsp_labels, tokentype_ids,
             attention_mask, *rng):
        if len(rng) != int(drops):
            raise TypeError(
                f"step takes {int(drops)} argument(s) after the attention "
                f"mask (the dropout key words when a dropout rate is "
                f"positive); got {len(rng)}")
        batch = [torch.as_tensor(t, device=dev).long()
                 for t in (tokens, mlm_labels, nsp_labels, tokentype_ids)]
        rest = [step_dropout_key(rng[0], dev)] if drops else []
        return step_fn(state, *batch,
                       torch.as_tensor(attention_mask, device=dev), *rest)

    return init, step
