"""GPT transformer (``apex_tpu/models/transformer_lm.py``), the
single-device subset the serving and training paths run.

Parameters are a plain dict with the JAX package's keys; layers are
stacked on a leading ``L`` axis and the decoder loops over them in
Python.  Activations are ``[b, s, h]``; attention runs BSND through
``ops/flash_attention.py`` (kernels K2, K6 and K7 on the card) and every
norm through ``ops/layer_norm.py`` (kernels K1 and K5).  The training
forward (:func:`gpt_loss`) is differentiable with the JAX package's
casts: the word and position tables go to ``cfg.compute_dtype`` before
the lookup, every matmul weight and bias to the activations' dtype, the
gelu runs in fp32, and the norms read their scales in fp32.
"""

from __future__ import annotations

from typing import Optional, Union

import torch
import torch.nn.functional as F

from apex_tpu_torch.models.config import TransformerConfig
from apex_tpu_torch.ops.flash_attention import flash_attention
from apex_tpu_torch.ops.layer_norm import fused_layer_norm, fused_rms_norm
from apex_tpu_torch.ops.lm_head_ce import lm_head_cross_entropy
from apex_tpu_torch.ops.rope import fused_apply_rotary_pos_emb_cached
from apex_tpu_torch.ops.xentropy import softmax_cross_entropy_loss
from apex_tpu_torch.utils.registry import resolve_device

__all__ = ["init_gpt_params", "rope_cos_sin", "apply_norm",
           "split_qkv_gqa", "lm_head_weight", "embed_tokens",
           "transformer_backbone", "gpt_hidden", "gpt_forward",
           "lm_head_logits", "gpt_loss", "lm_cross_entropy"]


def init_gpt_params(cfg: TransformerConfig,
                    generator: Optional[torch.Generator] = None,
                    device: Union[str, torch.device, None] = None) -> dict:
    """Full parameter dict at ``cfg``'s shapes: N(0, std) weights, output
    projections at std/sqrt(2L), unit norm scales, zero biases (the JAX
    package's init).  Values are drawn on the CPU from ``generator``
    (default: seed 0) and moved to ``device`` (default ``cuda``)."""
    dev = resolve_device(device)
    gen = generator if generator is not None else \
        torch.Generator().manual_seed(0)
    h, L = cfg.hidden_size, cfg.num_layers
    p, f = cfg.projection_size, cfg.ffn_hidden_size
    std = cfg.init_method_std
    out_std = std / (2.0 * L) ** 0.5
    dt = cfg.params_dtype

    def nrm(shape, s):
        return (torch.randn(shape, generator=gen, dtype=torch.float32)
                * s).to(device=dev, dtype=dt)

    def const(shape, value):
        return torch.full(shape, value, dtype=dt, device=dev)

    swiglu = cfg.activation == "swiglu"
    fc1_shape = (L, h, 2, f) if swiglu else (L, h, f)
    fc1_bias_shape = (L, 2, f) if swiglu else (L, f)
    if cfg.num_experts:
        raise NotImplementedError("MoE layers are not ported yet")
    word = nrm((cfg.vocab_size, h), std)
    layers = {
        "ln1_scale": const((L, h), 1.0),
        "ln1_bias": const((L, h), 0.0),
        "qkv_kernel": nrm((L, h, p + 2 * cfg.kv_projection_size), std),
        "qkv_bias": const((L, p + 2 * cfg.kv_projection_size), 0.0),
        "proj_kernel": nrm((L, p, h), out_std),
        "proj_bias": const((L, h), 0.0),
        "ln2_scale": const((L, h), 1.0),
        "ln2_bias": const((L, h), 0.0),
        "fc1_kernel": nrm(fc1_shape, std),
        "fc1_bias": const(fc1_bias_shape, 0.0),
        "fc2_kernel": nrm((L, f, h), out_std),
        "fc2_bias": const((L, h), 0.0),
    }
    params = {
        "embedding": {"word": word},
        "layers": layers,
        "final_ln": {"scale": const((h,), 1.0), "bias": const((h,), 0.0)},
    }
    if cfg.position_embedding_type == "learned":
        params["embedding"]["position"] = nrm(
            (cfg.max_position_embeddings, h), std)
    if cfg.untie_embeddings_and_output_weights:
        params["lm_head"] = {"kernel": nrm((cfg.vocab_size, h), std)}
    return params


def rope_cos_sin(seq_len: int, dim: int, base: float = 10000.0, *,
                 device=None):
    """Rotary tables ``[s, dim]`` (fp32), NeoX duplicated halves."""
    inv = 1.0 / base ** (torch.arange(0, dim, 2, dtype=torch.float32,
                                      device=device) / dim)
    ang = torch.outer(torch.arange(seq_len, dtype=torch.float32,
                                   device=device), inv)
    ang = torch.cat([ang, ang], dim=-1)
    return torch.cos(ang), torch.sin(ang)


def apply_norm(cfg: TransformerConfig, x, scale, bias, *,
               backend: Optional[str] = None):
    if cfg.normalization == "rmsnorm":
        return fused_rms_norm(x, scale, eps=cfg.layernorm_epsilon,
                              backend=backend)
    return fused_layer_norm(x, scale, bias, eps=cfg.layernorm_epsilon,
                            backend=backend)


def split_qkv_gqa(cfg: TransformerConfig, qkv, b: int, s: int, nh: int):
    """Split the GQA group-major ``[q x rep | k | v]`` layout into per-head
    q ``[b, s, nh, dh]`` and group-width k/v ``[b, s, g, dh]``; query head
    ``h`` belongs to group ``h // rep``."""
    dh = cfg.kv_channels
    rep = cfg.num_attention_heads // cfg.kv_groups
    g = nh // rep
    blk = qkv.reshape(b, s, g, rep + 2, dh)
    q = blk[..., :rep, :].reshape(b, s, nh, dh)
    return q, blk[..., rep, :], blk[..., rep + 1, :]


def split_qkv(cfg: TransformerConfig, qkv, b: int, s: int):
    """``[b, s, 3p]`` fused projection → (q, k, v): MHA's per-head
    interleaved ``[q|k|v]`` or GQA's group-major layout."""
    nh = cfg.num_attention_heads
    if cfg.is_gqa:
        return split_qkv_gqa(cfg, qkv, b, s, nh)
    q, k, v = qkv.reshape(b, s, nh, 3 * cfg.kv_channels).chunk(3, dim=-1)
    return q, k, v


def lm_head_weight(params: dict, cfg: TransformerConfig):
    """Tied or untied output-head weight ``[v, h]``."""
    return (params["lm_head"]["kernel"]
            if cfg.untie_embeddings_and_output_weights
            else params["embedding"]["word"])


def _core_attention(cfg: TransformerConfig, q, k, v, key_padding_mask,
                    *, backend: Optional[str] = None):
    """softmax(QK^T/sqrt(d))V through the flash path (kernel K2 forward,
    K6/K7 backward on the card); ``key_padding_mask`` ``[b, sk]`` bool,
    True = masked."""
    if cfg.attention_backend != "flash":
        raise NotImplementedError(
            f"attention_backend={cfg.attention_backend!r}: only 'flash' "
            "is ported")
    return flash_attention(q, k, v, causal=cfg.attn_mask_type == "causal",
                           key_padding_mask=key_padding_mask,
                           scale=1.0 / q.shape[-1] ** 0.5, backend=backend)


def _attention(cfg: TransformerConfig, lp: dict, x, key_padding_mask,
               rope, *, return_kv: bool = False,
               backend: Optional[str] = None):
    """Fused QKV projection → split → rope → core attention → output
    projection.  ``return_kv`` also returns the post-rope group-width K/V
    (the prefill cache write)."""
    b, s, _ = x.shape
    qkv = x @ lp["qkv_kernel"].to(x.dtype) + lp["qkv_bias"].to(x.dtype)
    q, k, v = split_qkv(cfg, qkv, b, s)
    if rope is not None:
        cos, sin = rope
        q = fused_apply_rotary_pos_emb_cached(q, cos[None, :, None, :],
                                              sin[None, :, None, :])
        k = fused_apply_rotary_pos_emb_cached(k, cos[None, :, None, :],
                                              sin[None, :, None, :])
    ctxv = _core_attention(cfg, q, k, v, key_padding_mask, backend=backend)
    out = ctxv.reshape(b, s, -1) @ lp["proj_kernel"].to(x.dtype)
    out = out + lp["proj_bias"].to(x.dtype)
    return (out, k, v) if return_kv else out


def _mlp(cfg: TransformerConfig, lp: dict, x):
    """fc1 → bias + activation (gelu / gelu_tanh in fp32, or the paired
    ``[h, 2, f]`` swiglu) → fc2 + bias."""
    w1 = lp["fc1_kernel"].to(x.dtype)
    if cfg.activation == "swiglu":
        y = torch.einsum("bsh,hcf->bscf", x, w1)
        y = y.float() + lp["fc1_bias"].to(x.dtype).float()
        y = (F.silu(y[..., 0, :]) * y[..., 1, :]).to(x.dtype)
    else:
        y = x @ w1 + lp["fc1_bias"].to(x.dtype)
        # PyTorch's gelu computes a 16-bit input in fp32 and rounds once,
        # forward and backward: the JAX package's fp32 round trip, in one
        # pass each way instead of three
        y = F.gelu(y, approximate="tanh" if cfg.activation == "gelu_tanh"
                   else "none")
    return y @ lp["fc2_kernel"].to(x.dtype) + lp["fc2_bias"].to(x.dtype)


def _check_training_cfg(cfg: TransformerConfig) -> None:
    if cfg.remat:
        raise NotImplementedError(
            "remat=True (per-layer activation checkpointing) is not ported "
            "yet; the port keeps every layer's activations")
    if cfg.hidden_dropout > 0 or cfg.attention_dropout > 0 \
            or cfg.drop_path_rate > 0:
        raise NotImplementedError(
            "dropout (hidden, attention — the in-kernel _keep_mask hash — "
            "and drop-path) is not ported yet")
    if cfg.num_experts:
        raise NotImplementedError("MoE layers are not ported yet")


def _layer(cfg: TransformerConfig, lp: dict, x, key_padding_mask, rope, *,
           backend: Optional[str] = None):
    """Pre-LN block: LN → attention → residual → LN → MLP → residual."""
    h = apply_norm(cfg, x, lp["ln1_scale"], lp["ln1_bias"], backend=backend)
    a = _attention(cfg, lp, h, key_padding_mask, rope, backend=backend)
    res = h if cfg.apply_residual_connection_post_layernorm else x
    x = res + a
    h = apply_norm(cfg, x, lp["ln2_scale"], lp["ln2_bias"], backend=backend)
    m = _mlp(cfg, lp, h)
    res = h if cfg.apply_residual_connection_post_layernorm else x
    return res + m


def embed_tokens(emb: dict, tokens, cfg: TransformerConfig):
    """Word lookup + learned positions, both tables cast to the compute
    dtype first (so their gradients scatter in that dtype, as in JAX)."""
    cd = cfg.compute_dtype
    h = emb["word"].to(cd)[tokens]
    if cfg.position_embedding_type == "learned":
        h = h + emb["position"][:tokens.shape[1]].to(cd)[None]
    return h


def transformer_backbone(params: dict, hidden, cfg: TransformerConfig, *,
                         attention_mask=None, apply_final_norm: bool = True,
                         backend: Optional[str] = None):
    """The decoder stack (a Python loop over the stacked layers) + final
    norm.  ``hidden`` ``[b, s, h]``; ``attention_mask`` ``[b, s]`` bool
    (True = masked key) for ``attn_mask_type='padding'`` models."""
    _check_training_cfg(cfg)
    s = hidden.shape[1]
    rope = None
    if cfg.position_embedding_type == "rope":
        rope = rope_cos_sin(s, cfg.kv_channels, device=hidden.device)
    layers = params["layers"]
    n_layers = next(iter(layers.values())).shape[0]
    for i in range(n_layers):
        lp = {k: v[i] for k, v in layers.items()}
        hidden = _layer(cfg, lp, hidden, attention_mask, rope,
                        backend=backend)
    if not apply_final_norm:
        return hidden
    return apply_norm(cfg, hidden, params["final_ln"]["scale"],
                      params["final_ln"]["bias"], backend=backend)


def gpt_hidden(params: dict, tokens, cfg: TransformerConfig, *,
               attention_mask=None, backend: Optional[str] = None):
    """Embed + decoder stack + final norm → hidden ``[b, s, h]``."""
    h = embed_tokens(params["embedding"], tokens, cfg)
    return transformer_backbone(params, h, cfg,
                                attention_mask=attention_mask,
                                backend=backend)


def lm_head_logits(params: dict, hidden, cfg: TransformerConfig):
    """Final hidden → fp32 vocab logits ``[b, s, v]`` (both operands in
    the compute dtype, fp32 products and sums)."""
    head = lm_head_weight(params, cfg).to(cfg.compute_dtype)
    return hidden.float() @ head.float().t()


def gpt_forward(params: dict, tokens, cfg: TransformerConfig, *,
                attention_mask=None, backend: Optional[str] = None):
    """Token ids ``[b, s]`` → fp32 logits ``[b, s, v]``."""
    h = gpt_hidden(params, tokens, cfg, attention_mask=attention_mask,
                   backend=backend)
    return lm_head_logits(params, h, cfg)


def gpt_loss(params: dict, tokens, labels, cfg: TransformerConfig, *,
             attention_mask=None, backend: Optional[str] = None):
    """Mean next-token CE over labels != -1 (fp32 scalar).  With
    ``cfg.fused_head_ce`` the head matmul is chunked into the loss
    (``ops/lm_head_ce.py``); otherwise full logits go through
    :func:`lm_cross_entropy`."""
    if cfg.fused_head_ce:
        h = gpt_hidden(params, tokens, cfg, attention_mask=attention_mask,
                       backend=backend)
        head = lm_head_weight(params, cfg).to(cfg.compute_dtype)
        losses = lm_head_cross_entropy(h, head, labels,
                                       chunk=cfg.head_ce_chunk,
                                       ignore_index=-1)
        n_valid = torch.clamp((labels != -1).sum(), min=1)
        return losses.sum() / n_valid.float()
    logits = gpt_forward(params, tokens, cfg, attention_mask=attention_mask,
                         backend=backend)
    return lm_cross_entropy(logits, labels)


def lm_cross_entropy(logits, labels):
    """Mean token CE; labels of -1 are padding and contribute zero."""
    flat = labels.reshape(-1)
    losses = softmax_cross_entropy_loss(
        logits.reshape(-1, logits.shape[-1]), torch.clamp(flat, min=0),
        padding_idx=None)
    losses = torch.where(flat == -1, 0.0, losses)
    n_valid = torch.clamp((labels != -1).sum(), min=1)
    return losses.sum() / n_valid.float()
