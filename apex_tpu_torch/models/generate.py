"""Autoregressive GPT inference: batched prefill, ragged decode, sampling
(``apex_tpu/models/generate.py``).

- :func:`prefill` runs the whole prompt through one forward (flash
  attention, kernel K2 on the card) and writes every layer's K/V into the
  cache in one scatter;
- :func:`decode_step` extends each sequence by one token; the paged
  layout runs the fused decode layer (kernel K3: rope, paged attention
  and output projection in one launch), and the contiguous stripe runs
  the same kernel over the stripe viewed as a linear block pool;
- :func:`sample_logits` picks next tokens (kernel K4 when the
  temperature is not a static 0);
- :func:`generate` is prefill plus a Python decode loop that stops when
  every row has emitted ``eos_token_id``.

Ragged batches are left-aligned with ``prompt_lens``: row ``i`` writes
and attends at its own position, finished rows keep stepping with their
position frozen.  Every norm is kernel K1.

The port updates the KV cache in place (the JAX package returns new
buffers); the returned dict holds the same K/V tensors and a new
``pos``.  Not ported in this slice: ``spec=`` (speculative decoding),
``lora=``, ``cache_wire="int8"`` and quantized weight leaves.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from apex_tpu_torch.models.config import TransformerConfig
from apex_tpu_torch.models.transformer_lm import (
    _attention, _mlp, apply_norm, lm_head_logits, rope_cos_sin, split_qkv)
from apex_tpu_torch.ops.decode_step import fused_decode_layer
from apex_tpu_torch.ops.fused_sampling import fused_sample
from apex_tpu_torch.ops.rope import fused_apply_rotary_pos_emb_ragged
from apex_tpu_torch.serving.paged_cache import blocks_for, init_paged_pool
from apex_tpu_torch.utils.registry import check_backend, resolve_device

__all__ = ["init_kv_cache", "prefill", "decode_step", "sample_logits",
           "generate"]

DEFAULT_BLOCK_SIZE = 16


def init_kv_cache(cfg: TransformerConfig, batch: int, max_len: int,
                  cache_dtype: Optional[torch.dtype] = None, *,
                  cache_layout: str = "contiguous",
                  block_size: int = DEFAULT_BLOCK_SIZE,
                  cache_wire: Optional[str] = None, device=None) -> dict:
    """KV cache for ``batch`` sequences of up to ``max_len`` tokens.

    ``"contiguous"``: ``[L, b, max_len, g, dh]`` stripes.  ``"paged"``: a
    pool ``[L, b·mb, block_size, g, dh]`` with linear ``block_tables``
    ``[b, mb]`` (sequence ``i`` owns blocks ``[i·mb, (i+1)·mb)``).  Both
    carry ``pos`` ``[b]`` int32."""
    dev = resolve_device(device)
    dt = cfg.compute_dtype if cache_dtype is None else cache_dtype
    if cache_layout == "contiguous":
        if cache_wire not in (None, "native"):
            raise ValueError(
                f"cache_wire={cache_wire!r} is a paged-pool form; the "
                "contiguous stripe layout stores the cache dtype only")
        shape = (cfg.num_layers, batch, max_len, cfg.kv_groups,
                 cfg.kv_channels)
        return {"k": torch.zeros(shape, dtype=dt, device=dev),
                "v": torch.zeros(shape, dtype=dt, device=dev),
                "pos": torch.zeros(batch, dtype=torch.int32, device=dev)}
    if cache_layout != "paged":
        raise ValueError(
            f"cache_layout={cache_layout!r}: expected 'contiguous' or "
            "'paged'")
    mb = blocks_for(max_len, block_size)
    pool = init_paged_pool(cfg, batch * mb, block_size, cache_dtype=dt,
                           cache_wire=cache_wire, device=dev)
    ar = torch.arange(mb, dtype=torch.int32, device=dev)
    pool["pos"] = torch.zeros(batch, dtype=torch.int32, device=dev)
    pool["block_tables"] = (torch.arange(batch, dtype=torch.int32,
                                         device=dev)[:, None] * mb + ar[None])
    return pool


def _check_sampling_args(temperature: float, top_k: Optional[int]) -> None:
    if temperature < 0:
        raise ValueError(
            f"temperature={temperature}: negative temperatures would "
            "invert the distribution; pass 0 for greedy or a positive value")
    if top_k is not None and top_k < 1:
        raise ValueError(
            f"top_k={top_k}: pass None (not 0) to disable the cutoff")


def _check_decode_cfg(cfg: TransformerConfig) -> None:
    if cfg.num_experts:
        raise ValueError("KV-cache decoding does not support MoE configs")
    if cfg.attn_mask_type != "causal":
        raise ValueError(
            "KV-cache decoding is causal by construction; "
            f"attn_mask_type={cfg.attn_mask_type!r} would decode with the "
            "wrong mask")


def _check_cache(cache: dict) -> None:
    if "k_scale" in cache:
        raise NotImplementedError(
            "int8 caches (cache_wire='int8') come with the serving-engine "
            "slice of the port")
    if cache["pos"].ndim != 1:
        raise ValueError(
            f"cache['pos'] must be a [b] int32 vector, got shape "
            f"{tuple(cache['pos'].shape)}; build caches with init_kv_cache")


def _layer_params(params: dict, layer: int) -> dict:
    lp = {k: v[layer] for k, v in params["layers"].items()}
    for name in ("qkv_kernel", "proj_kernel", "fc1_kernel", "fc2_kernel"):
        if isinstance(params["layers"].get(name), dict):
            raise NotImplementedError(
                "quantized weight leaves come with a later slice of the port")
    return lp


# leaves every layer casts to the compute dtype at each use; K1 reads the
# norm scales and K3 the projection W in fp32, so those stay
_CAST_ONCE = ("qkv_kernel", "qkv_bias", "proj_bias", "fc1_kernel",
              "fc1_bias", "fc2_kernel", "fc2_bias")


def _compute_dtype_params(params: dict, cfg: TransformerConfig) -> dict:
    """``params`` with the weights every step casts to the compute dtype
    cast once: the same values at each use, without a cast per layer per
    step (``generate`` calls this once per call)."""
    cd = cfg.compute_dtype
    layers = dict(params["layers"])
    for name in _CAST_ONCE:
        if name in layers and not isinstance(layers[name], dict):
            layers[name] = layers[name].to(cd)
    out = dict(params, layers=layers,
               embedding={k: v.to(cd)
                          for k, v in params["embedding"].items()})
    if "lm_head" in params:
        out["lm_head"] = {"kernel": params["lm_head"]["kernel"].to(cd)}
    return out


def _embed(params, cfg, tokens, positions):
    cd = cfg.compute_dtype
    x = params["embedding"]["word"][tokens].to(cd)
    if cfg.position_embedding_type == "learned":
        rows = positions.long().clamp(0, cfg.max_position_embeddings - 1)
        x = x + params["embedding"]["position"][rows].to(cd)
    return x


def prefill(params: dict, prompt, cfg: TransformerConfig, *,
            prompt_lens=None, cache: Optional[dict] = None,
            max_len: Optional[int] = None,
            cache_dtype: Optional[torch.dtype] = None, device=None,
            backend: Optional[str] = None):
    """Consume a whole prompt ``[b, s]`` in one forward → (last real
    token's logits ``[b, v]`` fp32, the filled cache).

    ``prompt_lens`` ``[b]`` marks each left-aligned row's real length;
    padding keys are masked in the flash kernel and padding positions
    never reach a paged pool (a contiguous stripe takes them, invisible
    to decode).  ``cache``: fill it in place; otherwise a contiguous one
    of ``max_len`` (default ``s``) is made."""
    _check_decode_cfg(cfg)
    check_backend(backend)
    dev = resolve_device(device)
    prompt = torch.as_tensor(prompt, device=dev).long()
    b, s = prompt.shape
    if cache is None:
        cache = init_kv_cache(cfg, b, max_len if max_len else s,
                              cache_dtype=cache_dtype, device=dev)
    _check_cache(cache)
    paged = "block_tables" in cache
    cache_len = (cache["block_tables"].shape[1] * cache["k"].shape[2]
                 if paged else cache["k"].shape[2])
    if s > cache_len:
        raise ValueError(
            f"prompt length {s} exceeds the cache max_len {cache_len}")
    lens = (torch.full((b,), s, dtype=torch.int32, device=dev)
            if prompt_lens is None
            else torch.as_tensor(prompt_lens, device=dev).to(torch.int32))
    t = torch.arange(s, device=dev)
    kpm = None if prompt_lens is None else t[None] >= lens[:, None]

    x = _embed(params, cfg, prompt, t[None])
    rope = None
    if cfg.position_embedding_type == "rope":
        rope = rope_cos_sin(s, cfg.kv_channels, device=dev)

    if paged:
        tables = cache["block_tables"].long()
        nb, bs = cache["k"].shape[1], cache["k"].shape[2]
        mb = tables.shape[1]
        blk = tables.gather(1, (t // bs).clamp(max=mb - 1)[None].expand(b, s))
        keep = (t[None] < lens[:, None]) & (blk < nb)
        rows, cols = keep.nonzero(as_tuple=True)
        cell_blk, cell_off = blk[rows, cols], cols % bs

    for layer in range(cfg.num_layers):
        lp = _layer_params(params, layer)
        h = apply_norm(cfg, x, lp["ln1_scale"], lp["ln1_bias"],
                       backend=backend)
        a, k, v = _attention(cfg, lp, h, kpm, rope, return_kv=True,
                             backend=backend)
        res = h if cfg.apply_residual_connection_post_layernorm else x
        x = res + a
        h = apply_norm(cfg, x, lp["ln2_scale"], lp["ln2_bias"],
                       backend=backend)
        res = h if cfg.apply_residual_connection_post_layernorm else x
        x = res + _mlp(cfg, lp, h)
        ck, cv = cache["k"][layer], cache["v"][layer]
        if paged:
            ck[cell_blk, cell_off] = k[rows, cols].to(ck.dtype)
            cv[cell_blk, cell_off] = v[rows, cols].to(cv.dtype)
        else:
            ck[:, :s] = k.to(ck.dtype)
            cv[:, :s] = v.to(cv.dtype)

    x = apply_norm(cfg, x, params["final_ln"]["scale"],
                   params["final_ln"]["bias"], backend=backend)
    x_last = x[torch.arange(b, device=dev), (lens.long() - 1).clamp(min=0)]
    out = dict(cache, pos=lens)
    return lm_head_logits(params, x_last, cfg), out


def _stripe_block(total: int) -> int:
    """Largest block size <= 128 dividing a stripe length (a multiple of 8
    where one exists): views ``[b, T, g, dh]`` as a linear pool."""
    cands = [d for d in range(1, min(total, 128) + 1) if total % d == 0]
    mult8 = [d for d in cands if d % 8 == 0]
    return max(mult8 or cands)


def decode_step(params: dict, token, cache: dict, cfg: TransformerConfig,
                *, lora=None, device=None, backend: Optional[str] = None):
    """One decoding step: ``token`` ``[b]`` at positions ``cache['pos']``
    → (logits ``[b, v]`` fp32, the cache with ``pos + 1``).

    A ``block_tables`` entry selects the paged layout: the new K/V append
    to each sequence's tail block; writes past the table's reach or
    through an unmapped entry drop."""
    if lora is not None:
        raise NotImplementedError(
            "lora= (multi-tenant adapters) comes with a later slice")
    _check_decode_cfg(cfg)
    check_backend(backend)
    dev = resolve_device(device)
    _check_cache(cache)
    token = torch.as_tensor(token, device=dev).long()
    b = token.shape[0]
    pos = cache["pos"].long()
    paged = "block_tables" in cache
    x = _embed(params, cfg, token, pos)[:, None]
    if paged:
        tables = cache["block_tables"]
        nb, bs = cache["k"].shape[1], cache["k"].shape[2]
        mb = tables.shape[1]
        max_pos = mb * bs
        blk = tables.long().gather(1, (pos // bs).clamp(max=mb - 1)[:, None])
        blk = torch.where(pos < mb * bs, blk[:, 0], nb)
        off = pos % bs
        ok = blk < nb
    else:
        T = cache["k"].shape[2]
        max_pos = T
        ok = pos < T
        bs = _stripe_block(T)
        nbl = T // bs
        tables = (torch.arange(b, device=dev)[:, None] * nbl
                  + torch.arange(nbl, device=dev)[None])
    # one host sync per step (not per layer): rows whose write drops
    rows = None if bool(ok.all()) else ok.nonzero(as_tuple=True)[0]
    rope_cos = rope_sin = rope = None
    if cfg.position_embedding_type == "rope":
        rope = rope_cos_sin(max_pos, cfg.kv_channels, device=dev)
        r = pos.clamp(0, max_pos - 1)
        rope_cos, rope_sin = rope[0][r], rope[1][r]

    for layer in range(cfg.num_layers):
        lp = _layer_params(params, layer)
        h = apply_norm(cfg, x, lp["ln1_scale"], lp["ln1_bias"],
                       backend=backend)
        qkv = h @ lp["qkv_kernel"].to(x.dtype) + lp["qkv_bias"].to(x.dtype)
        q, k, v = split_qkv(cfg, qkv, b, 1)
        if rope is not None:
            k = fused_apply_rotary_pos_emb_ragged(k, rope[0], rope[1], pos)
        ck, cv = cache["k"][layer], cache["v"][layer]
        if paged:
            sel = slice(None) if rows is None else rows
            ck[blk[sel], off[sel]] = k[sel, 0].to(ck.dtype)
            cv[blk[sel], off[sel]] = v[sel, 0].to(cv.dtype)
            pool_k, pool_v = ck, cv
        else:
            sel = torch.arange(b, device=dev) if rows is None else rows
            ck[sel, pos[sel]] = k[sel, 0].to(ck.dtype)
            cv[sel, pos[sel]] = v[sel, 0].to(cv.dtype)
            g, dh = ck.shape[2], ck.shape[3]
            pool_k = ck.view(b * nbl, bs, g, dh)
            pool_v = cv.view(b * nbl, bs, g, dh)
        a = fused_decode_layer(q[:, 0], pool_k, pool_v, tables, pos + 1,
                               lp["proj_kernel"], rope_cos=rope_cos,
                               rope_sin=rope_sin, backend=backend)
        a = a[:, None] + lp["proj_bias"].to(x.dtype)
        res = h if cfg.apply_residual_connection_post_layernorm else x
        x = res + a
        h = apply_norm(cfg, x, lp["ln2_scale"], lp["ln2_bias"],
                       backend=backend)
        res = h if cfg.apply_residual_connection_post_layernorm else x
        x = res + _mlp(cfg, lp, h)

    x = apply_norm(cfg, x, params["final_ln"]["scale"],
                   params["final_ln"]["bias"], backend=backend)
    new_pos = (pos + 1).to(torch.int32)
    return lm_head_logits(params, x[:, 0], cfg), dict(cache, pos=new_pos)


def sample_logits(logits, generator: Optional[torch.Generator] = None, *,
                  seed_words: Optional[Sequence[int]] = None,
                  temperature: float = 0.0, top_k: Optional[int] = None,
                  top_p: Optional[float] = None,
                  vocab_limit: Optional[int] = None,
                  backend: Optional[str] = None):
    """Next tokens ``[b]`` from ``logits`` ``[b, v]``: argmax at a static
    ``temperature=0``; otherwise the fused sampler (kernel K4), keyed by
    ``seed_words`` or two words drawn from ``generator``.
    ``vocab_limit`` masks padded vocab ids."""
    _check_sampling_args(temperature, top_k)
    return fused_sample(logits, seed_words=seed_words, generator=generator,
                        temperature=temperature, top_k=top_k, top_p=top_p,
                        vocab_limit=vocab_limit, backend=backend)


def generate(params: dict, prompt, cfg: TransformerConfig, *,
             max_new_tokens: int = 32, temperature: float = 0.0,
             top_k: Optional[int] = None, top_p: Optional[float] = None,
             seed: Optional[int] = None,
             generator: Optional[torch.Generator] = None,
             vocab_limit: Optional[int] = None, prompt_lens=None,
             eos_token_id: Optional[int] = None,
             cache_dtype: Optional[torch.dtype] = None,
             cache_layout: str = "contiguous",
             block_size: int = DEFAULT_BLOCK_SIZE,
             cache_wire: Optional[str] = None, spec=None, device=None,
             backend: Optional[str] = None):
    """Decode up to ``max_new_tokens`` past ``prompt`` ``[b, s]`` →
    tokens ``[b, s + max_new_tokens]``.

    Row ``i`` holds its prompt in ``[:lens[i]]`` and its generation in
    ``[lens[i]:lens[i] + n_i]``; untouched padding stays after.  The
    first new token comes from the prefill logits and the last needs no
    decode step behind it, so a run without early stops takes
    ``max_new_tokens - 1`` decode steps.  Sampling draws two key words
    per token from ``generator`` (default: seeded with ``seed``, else
    0)."""
    if spec not in (None, "off"):
        raise NotImplementedError(
            "spec= (speculative decoding) comes with a later slice")
    dev = resolve_device(device)
    prompt = torch.as_tensor(prompt, device=dev).long()
    b, s = prompt.shape
    total = s + max_new_tokens
    if (cfg.position_embedding_type == "learned"
            and total > cfg.max_position_embeddings):
        raise ValueError(
            f"prompt ({s}) + max_new_tokens ({max_new_tokens}) exceeds "
            f"max_position_embeddings ({cfg.max_position_embeddings})")
    _check_sampling_args(temperature, top_k)
    _check_decode_cfg(cfg)
    if generator is None:
        generator = torch.Generator().manual_seed(0 if seed is None
                                                  else int(seed))
    cache = init_kv_cache(cfg, b, total, cache_dtype=cache_dtype,
                          cache_layout=cache_layout, block_size=block_size,
                          cache_wire=cache_wire, device=dev)
    params = _compute_dtype_params(params, cfg)
    lens = (torch.full((b,), s, dtype=torch.long, device=dev)
            if prompt_lens is None
            else torch.as_tensor(prompt_lens, device=dev).long())
    logits, cache = prefill(params, prompt, cfg, prompt_lens=prompt_lens,
                            cache=cache, device=dev, backend=backend)
    tokens = torch.cat(
        [prompt, torch.zeros(b, max_new_tokens, dtype=prompt.dtype,
                             device=dev)], dim=1)
    done = torch.zeros(b, dtype=torch.bool, device=dev)

    def pick(lg):
        return sample_logits(lg, generator, temperature=temperature,
                             top_k=top_k, top_p=top_p,
                             vocab_limit=vocab_limit,
                             backend=backend).long()

    def emit(nxt, step):
        col = (lens + step)[:, None]
        cur = tokens.gather(1, col)[:, 0]
        tokens.scatter_(1, col, torch.where(done, cur, nxt)[:, None])

    step = 0
    while step < max_new_tokens - 1:
        if eos_token_id is not None and bool(done.all()):
            break
        nxt = pick(logits)
        emit(nxt, step)
        if eos_token_id is not None:
            done = done | (nxt == eos_token_id)
        prev = cache["pos"]
        logits, cache = decode_step(params, nxt, cache, cfg, device=dev,
                                    backend=backend)
        cache["pos"] = torch.where(done, prev, cache["pos"])
        step += 1
    if max_new_tokens > 0:
        emit(pick(logits), step)
    return tokens
