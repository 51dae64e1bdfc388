"""GPT transformer (``apex_tpu/models/transformer_lm.py``), the
single-device subset the serving and training paths run.

Parameters are a plain dict with the JAX package's keys; layers are
stacked on a leading ``L`` axis and the decoder loops over them in
Python.  Activations are ``[b, s, h]``; attention runs BSND through
``ops/flash_attention.py`` (kernels K2, K6 and K7 on the card, and row
5 for keys up to 512) or, under ``attention_backend='fused_softmax'``,
through materialized scores and ``ops/softmax.py`` (row 11), and every
norm through ``ops/layer_norm.py`` (kernels K1 and K5).  The training
forward (:func:`gpt_loss`) is differentiable with the JAX package's
casts: the word and position tables go to ``cfg.compute_dtype`` before
the lookup, every matmul weight and bias to the activations' dtype, the
gelu runs in fp32, and the norms read their scales in fp32.  A
quantized kernel (``models/quantized.quantize_params``) runs the int8
weight-slab matmul at each site (kernel row 10 on the card).  A config
with ``num_experts`` replaces each layer's MLP by the MoE FFN of
``transformer/moe.py`` (capacity or ragged routing; the ragged experts
run kernel row 9, int8 slabs its int8 branch) and adds the summed
load-balance loss, ``moe_aux_loss_coeff · aux / num_layers``, to
:func:`gpt_loss`.

Dropout (``hidden_dropout``, ``attention_dropout``, ``drop_path_rate``)
follows the JAX ``_layer``: attention dropout inside ``flash_attention``
(the kernels' counter hash) or, under ``fused_softmax``, on the
probabilities; hidden dropout on both branch outputs; drop-path on whole
samples, scaled by ``1/keep``.  The keys come from the caller, not from a
port of ``jax.random.split``: ``dropout_rng`` is a ``[L, 5, 2]`` tensor
of key words (the data words of each layer's five keys, the JAX layer's
``r1``…``r5``), drawn by :func:`dropout_keys` from an explicit
``torch.Generator`` or, to reproduce a JAX run, taken from
``jax.random.key_data`` of JAX's own splits.  Every mask is the counter
hash ``ops/flash_attention.keep_mask`` keyed by its site's seed
(``seed_from_key`` of the site's words) over the coordinates (leading
index, row, column) of the tensor viewed as ``[B, R, C]``
(``ops/flash_attention.dropout_keep``, the one helper of that layout): attention
probabilities ``[b, n, sq, sk]`` take the flash kernels' (batch·heads +
head, query, key), so both backends drop the same probabilities.  The
masks are drawn on the device from the words there: no global RNG and no
host read.

Data and context parallelism (``ctx=``, :func:`mesh_ctx`, the
counterpart of the JAX package's ``gspmd_ctx`` for tp = 1): each rank
runs the model on its ``[b_local, s_local]`` shard of the global batch.
Positions (learned or rope) start at ``sp_rank · s_local``; the hidden
and drop-path masks take their slice of the global masks
(``dropout_keep(..., lead0=, row0=)``); core attention runs over the sp
group as ring attention (``parallel/ring_attention.py``; grouped K/V stay
grouped) or Ulysses (``parallel/ulysses.py``; grouped K/V broadcast to the
query heads).  A padding mask or attention dropout falls back to dense
attention over K/V all-gathered across the sp group, with a
once-per-process warning (``APEX_TPU_CP_STRICT=1`` raises instead).
:func:`gpt_loss` under a context returns the global batch's mean token
loss, the same on every rank: each rank's sum over its tokens divided by
the global count, summed over the dp×sp group by an all-reduce whose
backward multiplies by the group's size, so that the mean of the ranks'
gradients over the group (``amp.make_train_step(axis_name=)``) is the
gradient of the global loss.
"""

from __future__ import annotations

import functools
import os
import warnings
from typing import Any, NamedTuple, Optional, Union

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from apex_tpu_torch.amp.patch import checkpoint_contexts, compute_site

from apex_tpu_torch.models.config import TransformerConfig
from apex_tpu_torch.ops.dense import is_quantized, quantized_matmul
from apex_tpu_torch.ops.flash_attention import (
    dropout_keep, flash_attention, key_words, seed_from_key)
from apex_tpu_torch.ops.layer_norm import fused_layer_norm, fused_rms_norm
from apex_tpu_torch.ops.lm_head_ce import lm_head_cross_entropy
from apex_tpu_torch.ops.rope import fused_apply_rotary_pos_emb_cached
from apex_tpu_torch.ops.swiglu import fused_bias_swiglu_paired, mlp_gelu
from apex_tpu_torch.ops.softmax import (
    scaled_masked_softmax, scaled_softmax, scaled_upper_triang_masked_softmax)
from apex_tpu_torch.ops.xentropy import softmax_cross_entropy_loss
from apex_tpu_torch.transformer import moe as _moe
from apex_tpu_torch.utils import collectives as coll
from apex_tpu_torch.utils import prng
from apex_tpu_torch.utils.registry import resolve_device

__all__ = ["init_gpt_params", "rope_cos_sin", "apply_norm",
           "split_qkv_gqa", "lm_head_weight", "embed_tokens",
           "transformer_backbone", "gpt_hidden", "gpt_forward",
           "lm_head_logits", "gpt_loss", "lm_cross_entropy",
           "dropout_keys", "has_dropout", "layer_dropout_words",
           "step_dropout_key", "MeshContext", "mesh_ctx"]


class MeshContext(NamedTuple):
    """Where this rank's shard sits in the mesh (:func:`mesh_ctx`)."""

    cp_group: Any = None     # the sp group under context parallelism
    cp_mode: str = "ring"    # "ring" or "ulysses"
    cp_size: int = 1
    seq_rank: int = 0        # positions start at seq_rank · s_local
    batch_rank: int = 0      # masks' batch rows start at batch_rank · b
    loss_group: Any = None   # the group the loss sums over (dp × sp)


def mesh_ctx(mesh, batch_axis: str = "dp", seq_axis: Optional[str] = None,
             context_parallel: Union[bool, str] = False) -> MeshContext:
    """The rank's context over ``mesh`` (the JAX ``gspmd_ctx``,
    ``transformer_lm.py:138``, for tp = 1): the batch split over
    ``batch_axis``, the sequence over ``seq_axis`` with core attention
    kept sequence-sharded (``context_parallel``: ``True``/``"ring"`` or
    ``"ulysses"``).  A tp axis above 1, or ``seq_axis`` without
    ``context_parallel`` (Megatron sequence parallelism), comes with the
    tensor-parallel slice."""
    if context_parallel and seq_axis is None:
        raise ValueError(
            "context_parallel requires seq_axis (the mesh axis the "
            "sequence is sharded over)")
    if context_parallel not in (False, True, "ring", "ulysses"):
        raise ValueError(
            f"context_parallel={context_parallel!r}: expected "
            "False | True | 'ring' | 'ulysses'")
    if mesh.shape["tp"] > 1:
        raise NotImplementedError(
            "a tp axis above 1 comes with the tensor-parallel slice of the "
            "port (transformer/tensor_parallel, its mappings and contexts)")
    if seq_axis is not None and not context_parallel:
        raise NotImplementedError(
            "seq_axis without context_parallel (Megatron sequence "
            "parallelism) comes with the tensor-parallel slice of the port")
    axes = (batch_axis,) + ((seq_axis,) if seq_axis else ())
    return MeshContext(
        cp_group=mesh.group(seq_axis) if context_parallel else None,
        cp_mode="ulysses" if context_parallel == "ulysses" else "ring",
        cp_size=mesh.axis_size(seq_axis) if context_parallel else 1,
        seq_rank=mesh.coords[seq_axis] if seq_axis else 0,
        batch_rank=mesh.coords[batch_axis],
        loss_group=mesh.group(axes))


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
    }
    if cfg.num_experts:
        E = cfg.num_experts
        # swiglu experts carry the concatenated [gate ‖ up] fc1 (2f)
        f1 = 2 * f if swiglu else f
        layers.update({
            "router_kernel": nrm((L, h, E), std),
            "moe_fc1": nrm((L, E, h, f1), std),
            "moe_fc1_bias": const((L, E, f1), 0.0),
            "moe_fc2": nrm((L, E, f, h), out_std),
            "moe_fc2_bias": const((L, E, h), 0.0),
        })
    else:
        layers.update({
            "fc1_kernel": nrm(fc1_shape, std),
            "fc1_bias": const(fc1_bias_shape, 0.0),
            "fc2_kernel": nrm((L, f, h), out_std),
            "fc2_bias": const((L, h), 0.0),
        })
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


def has_dropout(cfg: TransformerConfig) -> bool:
    """Whether a config drops anything (its train steps then take the
    key words as their last argument)."""
    return (cfg.hidden_dropout > 0 or cfg.attention_dropout > 0
            or cfg.drop_path_rate > 0)


def dropout_keys(cfg: TransformerConfig, generator: torch.Generator,
                 device=None):
    """``[L, 5, 2]`` int64 key words (uint32 values) for one step's
    dropout, drawn on the CPU from ``generator`` and moved to ``device``
    (default ``cuda``): the five keys of each layer, the JAX layer's
    ``r1``…``r5``."""
    words = torch.randint(0, 2 ** 32, (cfg.num_layers, 5, 2),
                          generator=generator, dtype=torch.int64)
    return words.to("cuda" if device is None else device)


def layer_dropout_words(dropout_rng, num_layers: int, device):
    """A step's dropout keys as ``[L, 5, 2]`` int64 words on ``device``:
    the ``[L, 5, 2]`` words of :func:`dropout_keys` as they are, or a raw
    JAX key (``[2]`` uint32 words) split as the JAX backbone splits it,
    ``split(key, L)`` then five keys a layer (``utils/prng``)."""
    w = key_words(dropout_rng, device)
    if w.numel() == 2:
        return prng.layer_words(w, num_layers)
    return w.reshape(-1, 5, 2)


def step_dropout_key(dropout_rng, device) -> torch.Tensor:
    """A train step's trailing dropout argument as ``amp.make_train_step``
    takes it: a raw JAX key as ``[2]`` ``torch.uint32`` words (the dtype
    that marks a key, split per microbatch under ``accum_steps``, as the
    JAX step marks one by ``(2,)`` uint32), else the ``[L, 5, 2]`` int64
    words of :func:`dropout_keys`."""
    w = key_words(dropout_rng, device)
    return w.to(torch.uint32) if w.numel() == 2 else w.reshape(-1, 5, 2)


@compute_site
def _einsum_f32(equation: str, a, b):
    """JAX's ``jnp.einsum(..., preferred_element_type=float32)``: fp32
    products and sums of the given operands."""
    return torch.einsum(equation, a.float(), b.float())


def _dropout(x, rate: float, words, lead0: int = 0, row0: int = 0):
    """``where(keep, x / (1 - rate), 0)`` in x's dtype (the JAX
    ``_dropout``); the identity at rate 0 or without words.  ``lead0`` and
    ``row0``: where a shard's leading index and rows start in the global
    tensor (its slice of the global mask)."""
    if rate == 0.0 or words is None:
        return x
    keep = dropout_keep(x.shape, seed_from_key(words, x.device), rate,
                        x.device, row0=row0, lead0=lead0)
    return torch.where(keep, x / (1.0 - rate), 0).to(x.dtype)


def _drop_path(x, rate: float, words, lead0: int = 0):
    """Stochastic depth: a sample's whole branch kept (scaled by
    ``1/keep``) or dropped, a ``[b, 1, …]`` mask (the JAX ``_drop_path``);
    ``lead0`` the shard's first global sample."""
    if rate == 0.0 or words is None:
        return x
    keep = dropout_keep((x.shape[0],) + (1,) * (x.ndim - 1),
                        seed_from_key(words, x.device), rate, x.device,
                        lead0=lead0)
    return torch.where(keep, x / (1.0 - rate), 0).to(x.dtype)


def _core_attention(cfg: TransformerConfig, q, k, v, attention_mask, *,
                    dropout_rng=None, backend: Optional[str] = None,
                    ctx: Optional[MeshContext] = None):
    """softmax(QK^T/sqrt(d))V, routed as the JAX package's
    ``_core_attention`` (``transformer_lm.py:464-502``).
    ``attention_mask`` is bool, True = masked.  A 2-D ``[b, sk]`` mask is
    key padding: under ``attention_backend='flash'`` it goes to the flash
    path (kernel K2 forward; row 5 backward for key lengths up to 512,
    K6/K7 above), under ``'fused_softmax'`` it is broadcast to ``[b, 1,
    1, sk]``.  Any other mask (``[b, 1, sq, sk]``, ``[b, n, sq, sk]``, ...)
    takes the materialized-score path under both backends, as does
    everything under ``'fused_softmax'``: grouped K/V broadcast to the
    query heads, fp32 scores (``q.dtype`` when ``softmax_in_fp32=
    False``), the mask OR-ed with the causal triangle for causal models,
    the scaled-softmax family (kernel row 11 forward), probabilities
    cast to v's dtype before the context product (fp32 products and
    sums).  ``dropout_rng`` (the attention site's key words) drops
    attention probabilities: in the flash kernels, or on the materialized
    probabilities before that cast.  Under a context-parallel ``ctx`` the
    attention runs over the sp group (:func:`_cp_core_attention`)."""
    scale = 1.0 / q.shape[-1] ** 0.5
    causal = cfg.attn_mask_type == "causal"
    if cfg.attention_backend not in ("flash", "fused_softmax"):
        raise NotImplementedError(
            f"attention_backend={cfg.attention_backend!r}: expected 'flash' "
            "or 'fused_softmax'")
    use_dropout = cfg.attention_dropout > 0 and dropout_rng is not None
    if ctx is not None and ctx.cp_size > 1:
        return _cp_core_attention(cfg, ctx, q, k, v, causal, scale,
                                  attention_mask, dropout_rng, use_dropout,
                                  backend)
    kpm = None
    if attention_mask is not None and attention_mask.ndim == 2:
        kpm, attention_mask = attention_mask, None
    if cfg.attention_backend == "flash" and attention_mask is None:
        return flash_attention(
            q, k, v, causal=causal, key_padding_mask=kpm, scale=scale,
            dropout_p=cfg.attention_dropout if use_dropout else 0.0,
            dropout_rng=dropout_rng if use_dropout else None,
            backend=backend)
    return _materialized_attention(cfg, q, k, v, attention_mask, kpm,
                                   causal, scale, dropout_rng, backend)


def _materialized_attention(cfg, q, k, v, attention_mask, kpm, causal,
                            scale, dropout_rng, backend, q_offset: int = 0,
                            lead0: int = 0):
    """The materialized-score path of :func:`_core_attention`; queries
    from global row ``q_offset`` on and score rows from global index
    ``lead0`` (batch·heads) on, for a shard's slice of the causal
    triangle and of the dropout mask."""
    if k.shape[2] != q.shape[2]:
        rep = q.shape[2] // k.shape[2]
        k = k.repeat_interleave(rep, dim=2)
        v = v.repeat_interleave(rep, dim=2)
    if kpm is not None:
        attention_mask = kpm[:, None, None, :]
    scores = _einsum_f32("bsnd,btnd->bnst", q, k)
    if not cfg.softmax_in_fp32:
        scores = scores.to(q.dtype)
    if causal:
        sq, sk = scores.shape[-2], scores.shape[-1]
        if attention_mask is not None or q_offset or sq != sk:
            row = torch.arange(q_offset, q_offset + sq,
                               device=q.device)[:, None]
            col = torch.arange(sk, device=q.device)[None]
            if attention_mask is None:
                attention_mask = torch.zeros((), dtype=torch.bool,
                                             device=q.device)
            probs = scaled_masked_softmax(
                scores, attention_mask | (col > row)[None, None], scale,
                backend=backend)
        else:
            probs = scaled_upper_triang_masked_softmax(scores, scale,
                                                       backend=backend)
    elif attention_mask is not None:
        probs = scaled_masked_softmax(scores, attention_mask, scale,
                                      backend=backend)
    else:
        probs = scaled_softmax(scores, scale, backend=backend)
    probs = _dropout(probs, cfg.attention_dropout, dropout_rng,
                     lead0=lead0, row0=q_offset)
    return _einsum_f32("bnst,btnd->bsnd", probs.to(v.dtype),
                       v).to(v.dtype)


_cp_fallback_warned = False


def _cp_degraded_fallback(reason: str) -> None:
    """A context-parallel model is about to gather K/V over the sp group
    (dense attention: correct, but the memory context parallelism exists
    to avoid).  Warns once per process; ``APEX_TPU_CP_STRICT=1`` raises
    (``transformer_lm.py:526``)."""
    global _cp_fallback_warned
    msg = (
        f"context parallelism DEGRADED: {reason}, which the ring/Ulysses "
        "kernels do not cover — falling back to dense attention with "
        "K/V all-gathered over the cp axis. At long context this is the "
        "memory blowup cp exists to avoid (OOM or crawl). Drop the mask "
        "/ attention dropout for cp training, or set APEX_TPU_CP_STRICT=1 "
        "to make this an error.")
    if os.environ.get("APEX_TPU_CP_STRICT", "") not in ("", "0"):
        raise ValueError(msg)
    if not _cp_fallback_warned:
        _cp_fallback_warned = True
        warnings.warn(msg, RuntimeWarning, stacklevel=3)


class _GatherSeq(torch.autograd.Function):
    """K or V all-gathered along the sequence over a group; the backward
    sums every rank's gradient of this rank's rows (a reduce-scatter)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return coll.all_gather(x, group, axis=1, tiled=True)

    @staticmethod
    def backward(ctx, g):
        return coll.psum_scatter(g.contiguous(), ctx.group,
                                 scatter_dimension=1, tiled=True), None


def _cp_core_attention(cfg, ctx, q, k, v, causal, scale, attention_mask,
                       dropout_rng, use_dropout, backend):
    """Core attention sequence-sharded over ``ctx.cp_group``
    (``_cp_core_attention``, ``transformer_lm.py:545-595``): ring or
    Ulysses; a mask or attention dropout takes the degraded gathered
    path."""
    if attention_mask is not None or use_dropout:
        _cp_degraded_fallback(
            "attention_mask is set" if attention_mask is not None
            else "attention dropout is active")
        kpm = None
        if attention_mask is not None and attention_mask.ndim == 2:
            kpm, attention_mask = attention_mask, None
        k = _GatherSeq.apply(k, ctx.cp_group)
        v = _GatherSeq.apply(v, ctx.cp_group)
        b, s = q.shape[0], q.shape[1]
        return _materialized_attention(
            cfg, q, k, v, attention_mask, kpm, causal, scale,
            dropout_rng if use_dropout else None, backend,
            q_offset=ctx.seq_rank * s,
            lead0=ctx.batch_rank * b * q.shape[2])
    if ctx.cp_mode == "ulysses":
        from apex_tpu_torch.parallel.ulysses import ulysses_attention

        if k.shape[2] != q.shape[2]:
            # the all-to-all reshards the head axis: broadcast the groups
            rep = q.shape[2] // k.shape[2]
            k = k.repeat_interleave(rep, dim=2)
            v = v.repeat_interleave(rep, dim=2)
        return ulysses_attention(q, k, v, ctx.cp_group, causal=causal,
                                 scale=scale, backend=backend)
    from apex_tpu_torch.parallel.ring_attention import ring_attention

    # grouped K/V ride the ring at group width
    return ring_attention(q, k, v, ctx.cp_group, causal=causal, scale=scale,
                          backend=backend)


def _attention(cfg: TransformerConfig, lp: dict, x, attention_mask,
               rope, *, return_kv: bool = False, dropout_rng=None,
               backend: Optional[str] = None,
               ctx: Optional[MeshContext] = None):
    """Fused QKV projection → split → rope → core attention → output
    projection.  ``return_kv`` also returns the post-rope group-width K/V
    (the prefill cache write)."""
    b, s, _ = x.shape
    qkv = (quantized_matmul(x, lp["qkv_kernel"], backend=backend)
           + lp["qkv_bias"].to(x.dtype))
    q, k, v = split_qkv(cfg, qkv, b, s)
    if rope is not None:
        cos, sin = rope
        q = fused_apply_rotary_pos_emb_cached(q, cos[None, :, None, :],
                                              sin[None, :, None, :])
        k = fused_apply_rotary_pos_emb_cached(k, cos[None, :, None, :],
                                              sin[None, :, None, :])
    ctxv = _core_attention(cfg, q, k, v, attention_mask,
                           dropout_rng=dropout_rng, backend=backend, ctx=ctx)
    out = quantized_matmul(ctxv.reshape(b, s, -1), lp["proj_kernel"],
                           backend=backend)
    out = out + lp["proj_bias"].to(x.dtype)
    return (out, k, v) if return_kv else out


def _mlp(cfg: TransformerConfig, lp: dict, x, *,
         backend: Optional[str] = None):
    """fc1 → bias + activation (gelu / gelu_tanh in fp32, or the paired
    ``[h, 2, f]`` swiglu of ``ops/swiglu.fused_bias_swiglu_paired``) →
    fc2 + bias."""
    w1 = lp["fc1_kernel"]
    if cfg.activation == "swiglu":
        y = (quantized_matmul(x, w1, backend=backend) if is_quantized(w1)
             else torch.einsum("bsh,hcf->bscf", x, w1.to(x.dtype)))
        y = fused_bias_swiglu_paired(y, lp["fc1_bias"].to(x.dtype))
    else:
        y = (quantized_matmul(x, w1, backend=backend)
             + lp["fc1_bias"].to(x.dtype))
        y = mlp_gelu(cfg.activation, y)
    return (quantized_matmul(y, lp["fc2_kernel"], backend=backend)
            + lp["fc2_bias"].to(x.dtype))


def _moe_mlp(cfg: TransformerConfig, lp: dict, x, *,
             backend: Optional[str] = None):
    """The MoE FFN (``transformer/moe.switch_moe_mlp``) in place of the
    dense MLP: ``(out, aux_loss)``."""
    moe_params = {
        "router": lp["router_kernel"],
        "fc1": lp["moe_fc1"],
        "fc1_bias": lp["moe_fc1_bias"],
        "fc2": lp["moe_fc2"],
        "fc2_bias": lp["moe_fc2_bias"],
    }
    o = _moe.switch_moe_mlp(
        moe_params, x, capacity_factor=cfg.moe_capacity_factor,
        top_k=cfg.moe_top_k, ep_axis=cfg.moe_ep_axis,
        activation=cfg.activation, routing=cfg.moe_routing,
        moe_comm=cfg.moe_comm, gmm_backend=backend)
    return o.out, o.aux_loss


def _layer(cfg: TransformerConfig, lp: dict, x, rngs=None, *,
           attention_mask=None, rope=None, backend: Optional[str] = None,
           ctx: Optional[MeshContext] = None):
    """Pre-LN block: LN → attention → residual → LN → MLP (or MoE FFN) →
    residual, with the JAX ``_layer``'s dropout sites when ``rngs`` (the
    layer's ``[5, 2]`` key words r1…r5) is given.  Returns ``(x, aux)``:
    the MoE load-balance loss, ``None`` for a dense layer."""
    r1, r2, r3, r4, r5 = (rngs[0], rngs[1], rngs[2], rngs[3], rngs[4]) \
        if rngs is not None else (None,) * 5
    # a shard's place in the global hidden masks [B, S, h] and [B, 1, 1]:
    # (lead0, row0), none on one device
    at = () if ctx is None else (ctx.batch_rank * x.shape[0],
                                 ctx.seq_rank * x.shape[1])
    h = apply_norm(cfg, x, lp["ln1_scale"], lp["ln1_bias"], backend=backend)
    a = _attention(cfg, lp, h, attention_mask, rope, dropout_rng=r1,
                   backend=backend, ctx=ctx)
    res = h if cfg.apply_residual_connection_post_layernorm else x
    x = res + _drop_path(_dropout(a, cfg.hidden_dropout, r2, *at),
                         cfg.drop_path_rate, r4, *at[:1])
    h = apply_norm(cfg, x, lp["ln2_scale"], lp["ln2_bias"], backend=backend)
    if cfg.num_experts:
        m, aux = _moe_mlp(cfg, lp, h, backend=backend)
    else:
        m, aux = _mlp(cfg, lp, h, backend=backend), None
    res = h if cfg.apply_residual_connection_post_layernorm else x
    return res + _drop_path(_dropout(m, cfg.hidden_dropout, r3, *at),
                            cfg.drop_path_rate, r5, *at[:1]), aux


def embed_tokens(emb: dict, tokens, cfg: TransformerConfig, pos0: int = 0):
    """Word lookup + learned positions (from ``pos0``: a sequence shard's
    first global position), both tables cast to the compute dtype first
    (so their gradients scatter in that dtype, as in JAX)."""
    cd = cfg.compute_dtype
    h = emb["word"].to(cd)[tokens]
    if cfg.position_embedding_type == "learned":
        h = h + emb["position"][pos0:pos0 + tokens.shape[1]].to(cd)[None]
    return h


def transformer_backbone(params: dict, hidden, cfg: TransformerConfig, *,
                         attention_mask=None, dropout_rng=None,
                         apply_final_norm: bool = True,
                         with_aux: bool = False,
                         backend: Optional[str] = None,
                         ctx: Optional[MeshContext] = None):
    """The decoder stack (a Python loop over the stacked layers) + final
    norm.  ``hidden`` ``[b, s, h]``; ``attention_mask`` bool, True =
    masked: ``[b, s]`` key padding or any mask that broadcasts to the
    scores ``[b, n, sq, sk]`` (see :func:`_core_attention`).
    ``with_aux=True`` also returns the per-layer MoE load-balance losses
    summed (an fp32 scalar, 0 for a dense config).  ``dropout_rng``: the
    ``[L, 5, 2]`` key words of :func:`dropout_keys`; dropout runs when it is
    given and a rate is positive.  ``ctx``: this rank's shard of a
    data/context-parallel run (:func:`mesh_ctx`)."""
    s = hidden.shape[1]
    pos0 = ctx.seq_rank * s if ctx is not None else 0
    n_layers = params["layers"]["ln1_scale"].shape[0]
    words = None
    if dropout_rng is not None and has_dropout(cfg):
        words = layer_dropout_words(dropout_rng, n_layers, hidden.device)
    rope = None
    if cfg.position_embedding_type == "rope":
        cos, sin = rope_cos_sin(pos0 + s, cfg.kv_channels,
                                device=hidden.device)
        rope = cos[pos0:], sin[pos0:]
    aux = torch.zeros((), dtype=torch.float32, device=hidden.device)
    layer = functools.partial(_layer, cfg, attention_mask=attention_mask,
                              rope=rope, backend=backend, ctx=ctx)
    for i in range(n_layers):
        lp = _layer_params(params, i)
        rngs = None if words is None else words[i]
        if cfg.remat:
            # jax.checkpoint(body): keep the layer's input, recompute its
            # forward in the backward (bit for bit: the kernels sum in a
            # fixed order and the masks are counter hashes of the words)
            hidden, layer_aux = checkpoint(
                layer, lp, hidden, rngs, use_reentrant=False,
                preserve_rng_state=False, context_fn=checkpoint_contexts)
        else:
            hidden, layer_aux = layer(lp, hidden, rngs)
        if layer_aux is not None:
            aux = aux + layer_aux
    if apply_final_norm:
        hidden = apply_norm(cfg, hidden, params["final_ln"]["scale"],
                            params["final_ln"]["bias"], backend=backend)
    return (hidden, aux) if with_aux else hidden


def _layer_params(params: dict, layer: int) -> dict:
    """Layer ``layer``'s leaves; a quantized slab keeps its dict form."""
    return {k: ({kk: vv[layer] for kk, vv in v.items()}
                if isinstance(v, dict) else v[layer])
            for k, v in params["layers"].items()}


def gpt_hidden(params: dict, tokens, cfg: TransformerConfig, *,
               attention_mask=None, dropout_rng=None, with_aux: bool = False,
               backend: Optional[str] = None,
               ctx: Optional[MeshContext] = None):
    """Embed + decoder stack + final norm → hidden ``[b, s, h]`` (and the
    summed MoE aux loss under ``with_aux``)."""
    pos0 = ctx.seq_rank * tokens.shape[1] if ctx is not None else 0
    h = embed_tokens(params["embedding"], tokens, cfg, pos0)
    return transformer_backbone(params, h, cfg,
                                attention_mask=attention_mask,
                                dropout_rng=dropout_rng,
                                with_aux=with_aux, backend=backend, ctx=ctx)


def lm_head_logits(params: dict, hidden, cfg: TransformerConfig):
    """Final hidden → fp32 vocab logits ``[b, s, v]`` (both operands in
    the compute dtype, fp32 products and sums)."""
    return _head_product(hidden,
                         lm_head_weight(params, cfg).to(cfg.compute_dtype))


@compute_site
def _head_product(hidden, head):
    """JAX's ``jnp.einsum("bsh,vh->bsv", ..., preferred_element_type=
    float32)``: fp32 products and sums of the given operands."""
    return hidden.float() @ head.float().t()


def gpt_forward(params: dict, tokens, cfg: TransformerConfig, *,
                attention_mask=None, dropout_rng=None, with_aux: bool = False,
                backend: Optional[str] = None,
                ctx: Optional[MeshContext] = None):
    """Token ids ``[b, s]`` → fp32 logits ``[b, s, v]`` (and the summed
    MoE aux loss under ``with_aux``)."""
    h, aux = gpt_hidden(params, tokens, cfg, attention_mask=attention_mask,
                        dropout_rng=dropout_rng, with_aux=True,
                        backend=backend, ctx=ctx)
    logits = lm_head_logits(params, h, cfg)
    return (logits, aux) if with_aux else logits


class _SumOverGroup(torch.autograd.Function):
    """A scalar summed over a group whose backward scales by the group's
    size: each rank's gradients are its share times the size, so their
    mean over the group (the AMP step's ``axis_name`` reduction) is the
    sum of the shares, the gradient of the global loss."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.size = coll.group_size(group)
        return coll.all_reduce(x, group, kind=None)

    @staticmethod
    def backward(ctx, g):
        return g * ctx.size, None


def gpt_loss(params: dict, tokens, labels, cfg: TransformerConfig, *,
             attention_mask=None, dropout_rng=None,
             backend: Optional[str] = None,
             ctx: Optional[MeshContext] = None):
    """Mean next-token CE over labels != -1 (fp32 scalar), plus
    ``moe_aux_loss_coeff · aux / num_layers`` for an MoE config.  With
    ``cfg.fused_head_ce`` the head matmul is chunked into the loss
    (``ops/lm_head_ce.py``); otherwise full logits go through
    :func:`lm_cross_entropy`.  Under ``ctx`` (``tokens``/``labels`` this
    rank's shard) the mean is the global batch's (module docstring)."""
    sharded = ctx is not None and ctx.loss_group is not None \
        and ctx.loss_group is not coll.SINGLE
    if sharded and cfg.num_experts:
        raise NotImplementedError(
            "an MoE config over a data/context-parallel mesh comes with the "
            "expert-parallel slice of the port")
    if cfg.fused_head_ce:
        h, aux = gpt_hidden(params, tokens, cfg,
                            attention_mask=attention_mask,
                            dropout_rng=dropout_rng, with_aux=True,
                            backend=backend, ctx=ctx)
        head = lm_head_weight(params, cfg).to(cfg.compute_dtype)
        losses = lm_head_cross_entropy(h, head, labels,
                                       chunk=cfg.head_ce_chunk,
                                       ignore_index=-1)
        total = losses.sum()
    else:
        logits, aux = gpt_forward(params, tokens, cfg,
                                  attention_mask=attention_mask,
                                  dropout_rng=dropout_rng, with_aux=True,
                                  backend=backend, ctx=ctx)
        total = _ce_sum(logits, labels)
    n_valid = (labels != -1).sum().float()
    if sharded:
        n_valid = coll.all_reduce(n_valid, ctx.loss_group, kind=None)
        loss = _SumOverGroup.apply(total / torch.clamp(n_valid, min=1.0),
                                   ctx.loss_group)
    else:
        loss = total / torch.clamp(n_valid, min=1.0)
    if cfg.num_experts:
        # Switch load-balance term, mean over layers
        loss = loss + cfg.moe_aux_loss_coeff * aux / cfg.num_layers
    return loss


def _ce_sum(logits, labels):
    """Summed token CE; labels of -1 are padding and contribute zero."""
    flat = labels.reshape(-1)
    losses = softmax_cross_entropy_loss(
        logits.reshape(-1, logits.shape[-1]), torch.clamp(flat, min=0),
        padding_idx=None)
    return torch.where(flat == -1, 0.0, losses).sum()


def lm_cross_entropy(logits, labels):
    """Mean token CE; labels of -1 are padding and contribute zero."""
    n_valid = torch.clamp((labels != -1).sum(), min=1)
    return _ce_sum(logits, labels) / n_valid.float()
