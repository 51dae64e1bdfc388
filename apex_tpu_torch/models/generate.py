"""Autoregressive GPT inference: batched prefill, ragged decode, sampling
(``apex_tpu/models/generate.py``).

- :func:`prefill` runs the whole prompt through one forward (flash
  attention, kernel K2 on the card) and writes every layer's K/V into the
  cache in one scatter;
- :func:`decode_step` extends each sequence by one token; the paged
  layout runs the fused decode layer (kernel K3: rope, paged attention
  and output projection in one launch), and the contiguous stripe runs
  the same kernel over the stripe viewed as a linear block pool;
- :func:`decode_verify` appends ``m`` tokens per sequence in one forward
  (dense attention over the gathered cache); the serving engine
  prefills adapter prompts through it;
- :func:`prefill_chunked` consumes a prompt in fixed-size chunks, each
  chunk one :func:`decode_verify` (the serving engine's
  ``chunk_tokens=``);
- :func:`extract_kv` / :func:`inject_kv` read a sequence's per-token
  K/V out of a cache of either layout and write it into another;
- :func:`sample_logits` picks next tokens (kernel K4 when the
  temperature is not a static 0);
- :func:`generate` is prefill plus a Python decode loop that stops when
  every row has emitted ``eos_token_id``.

Ragged batches are left-aligned with ``prompt_lens``: row ``i`` writes
and attends at its own position, finished rows keep stepping with their
position frozen.  Every norm is kernel K1.

The port updates the KV cache in place (the JAX package returns new
buffers); the returned dict holds the same K/V tensors and a new
``pos``.  ``cache_wire="int8"`` pools quantize K/V per (token, group)
at every write (``serving/paged_cache.scatter_kv_quantized``) and the
attention kernels dequantize them as they load.  Quantized weight
leaves (``models/quantized.quantize_params``) run kernel row 10 at every
matmul site; their decode attention is the stand-alone paged kernel
(row 6) followed by the quantized projection, as in JAX, instead of K3.
``lora=`` on ``decode_step`` and ``decode_verify`` adds per-row adapter
deltas at the four target matmuls through the grouped matmul (kernel row
9, ``models/lora.py``) and runs row 6 instead of K3.  ``generate(spec=)``
decodes speculatively (``models/speculative.py``): each round one
:func:`decode_verify` over the pending token and k drafts.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from apex_tpu_torch.models.config import TransformerConfig
from apex_tpu_torch.models.lora import (
    batched_lora_delta, lora_mlp, lora_plan)
from apex_tpu_torch.models.transformer_lm import (
    _attention, _layer_params, _mlp, apply_norm, lm_head_logits,
    rope_cos_sin, split_qkv)
from apex_tpu_torch.observability import metrics as _telemetry
from apex_tpu_torch.ops.decode_step import fused_decode_layer
from apex_tpu_torch.ops.dense import is_quantized, quantized_matmul
from apex_tpu_torch.ops.fused_sampling import fused_sample
from apex_tpu_torch.ops.paged_attention import ragged_paged_attention
from apex_tpu_torch.ops.rope import fused_apply_rotary_pos_emb_ragged
from apex_tpu_torch.serving.paged_cache import (
    blocks_for, dequantize_kv, gather_block_kv, gather_block_scales,
    init_paged_pool, plan_cells, scatter_kv_quantized, write_cells)
from apex_tpu_torch.utils.registry import check_backend, resolve_device

__all__ = ["init_kv_cache", "prefill", "prefill_chunked", "decode_step",
           "decode_verify", "extract_kv", "inject_kv", "sample_logits",
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


def _row_blocks(cache: dict, n: int, row: int, what: str):
    """The first ``blocks_for(n)`` table entries of ``row`` (host ints),
    refusing an unmapped sentinel among them."""
    bs, nb = cache["k"].shape[2], cache["k"].shape[1]
    tables = cache["block_tables"]
    need = blocks_for(int(n), bs)
    if need > tables.shape[1]:
        raise ValueError(f"{what} {n} needs {need} blocks but the table "
                         f"holds {tables.shape[1]}")
    ids = tables[row, :need].cpu().numpy()
    if (ids >= nb).any() or (ids < 0).any():
        raise ValueError(
            f"{what} {n} reaches unmapped table entries for row {row} "
            f"(sentinel >= {nb}); it exceeds the row's mapped blocks")
    return ids


def extract_kv(cache: dict, length: int, *, row: int = 0):
    """Sequence ``row``'s first ``length`` tokens of K/V → ``(k, v)``
    ``[L, length, kv_groups, dh]`` from a cache of either layout: paged
    caches dereference the row's block table (an int8 pool dequantizes
    to fp32), contiguous ones slice the row's stripe.  Inverted by
    :func:`inject_kv`."""
    if length < 1:
        raise ValueError(f"length={length} must be >= 1")
    if "block_tables" in cache:
        ids = _row_blocks(cache, length, row, "length")
        k, v = gather_block_kv(cache["k"], cache["v"], ids)
        if "k_scale" in cache:
            k = dequantize_kv(k, gather_block_scales(cache["k_scale"], ids))
            v = dequantize_kv(v, gather_block_scales(cache["v_scale"], ids))
        return k[:, :length], v[:, :length]
    if length > cache["k"].shape[2]:
        raise ValueError(f"length {length} exceeds the cache max_len "
                         f"{cache['k'].shape[2]}")
    return cache["k"][:, row, :length], cache["v"][:, row, :length]


def inject_kv(cache: dict, k, v, *, row: int = 0) -> dict:
    """Write per-token K/V ``[L, n, kv_groups, dh]`` into positions
    ``[0, n)`` of sequence ``row`` (in place) → the cache with
    ``pos[row] = n``.  Paged caches scatter through the row's table (an
    int8 pool quantizes at the write edge), contiguous ones overwrite the
    stripe head; values are cast to the cache dtype, so a round trip
    between same-dtype caches is exact."""
    dev = cache["k"].device
    k = torch.as_tensor(k, device=dev)
    v = torch.as_tensor(v, device=dev)
    if k.ndim != 4 or k.shape != v.shape:
        raise ValueError(f"expected matching [L, n, g, dh] K/V, got "
                         f"{tuple(k.shape)} / {tuple(v.shape)}")
    n = k.shape[1]
    if "block_tables" in cache:
        _row_blocks(cache, n, row, "handoff tokens")
        bs = cache["k"].shape[2]
        t = torch.arange(n, device=dev)
        idx = (slice(None), cache["block_tables"][row].long()[t // bs],
               t % bs)
        if "k_scale" in cache:
            scatter_kv_quantized(cache["k"], cache["v"], cache["k_scale"],
                                 cache["v_scale"], k, v, idx)
        else:
            write_cells((cache["k"], cache["v"]), (k, v), idx)
    else:
        if n > cache["k"].shape[2]:
            raise ValueError(f"{n} handoff tokens exceed the cache max_len "
                             f"{cache['k'].shape[2]}")
        cache["k"][:, row, :n] = k.to(cache["k"].dtype)
        cache["v"][:, row, :n] = v.to(cache["v"].dtype)
    pos = cache["pos"].clone()
    pos[row] = n
    return dict(cache, pos=pos)


def prefill_chunked(params: dict, prompt, cfg: TransformerConfig, *,
                    chunk_tokens: int, prompt_lens=None,
                    cache: Optional[dict] = None,
                    max_len: Optional[int] = None,
                    cache_dtype: Optional[torch.dtype] = None, device=None,
                    backend: Optional[str] = None):
    """Chunked prefill: a prompt ``[b, s]`` in ``ceil(s / chunk_tokens)``
    forwards, each one :func:`decode_verify` appending the chunk at the
    rows' positions (it attends to the prefix the earlier chunks wrote
    and to itself causally) → (last real token's logits ``[b, v]``
    fp32, the filled cache): :func:`prefill`'s contract.  Rows whose
    prompt ended in an earlier chunk ride later ones parked at their
    length (their writes land past it, where no read looks); their
    logits come from the chunk that held their last token.  ``cache``,
    ``max_len`` and ``cache_dtype`` as in :func:`prefill`."""
    _check_decode_cfg(cfg)
    if chunk_tokens < 1:
        raise ValueError(f"chunk_tokens={chunk_tokens} must be >= 1")
    dev = resolve_device(device)
    prompt = torch.as_tensor(prompt, device=dev).long()
    b, s = prompt.shape
    if cache is None:
        cache = init_kv_cache(cfg, b, max_len if max_len else s,
                              cache_dtype=cache_dtype, device=dev)
    paged = "block_tables" in cache
    cache_len = (cache["block_tables"].shape[1] * cache["k"].shape[2]
                 if paged else cache["k"].shape[2])
    if s > cache_len:
        raise ValueError(
            f"prompt length {s} exceeds the cache max_len {cache_len}")
    lens = (torch.full((b,), s, dtype=torch.int32, device=dev)
            if prompt_lens is None
            else torch.as_tensor(prompt_lens, device=dev).to(torch.int32))
    last = None
    for lo in range(0, s, chunk_tokens):
        hi = min(s, lo + chunk_tokens)
        cache = dict(cache, pos=lens.clamp(max=lo))
        logits, cache = decode_verify(params, prompt[:, lo:hi], cache, cfg,
                                      device=dev, backend=backend)
        take = (lens.long() - 1 - lo).clamp(0, hi - lo - 1)
        lg = logits[torch.arange(b, device=dev), take]
        hit = (lens - 1 >= lo) & (lens - 1 < hi)
        last = lg if last is None else torch.where(hit[:, None], lg, last)
    return last, dict(cache, pos=lens)


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
    if cache["pos"].ndim != 1:
        raise ValueError(
            f"cache['pos'] must be a [b] int32 vector, got shape "
            f"{tuple(cache['pos'].shape)}; build caches with init_kv_cache")


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
    quant = "k_scale" in cache
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
        x = res + _mlp(cfg, lp, h, backend=backend)
        ck, cv = cache["k"][layer], cache["v"][layer]
        if paged and quant:
            scatter_kv_quantized(ck, cv, cache["k_scale"][layer],
                                 cache["v_scale"][layer], k[rows, cols],
                                 v[rows, cols], (cell_blk, cell_off))
        elif paged:
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


def _lora_operands(lora, dev, m: int = 1):
    """The optional LoRA bundle (``{"idx": [b] slot ids, "slabs": {target:
    {"a": [L, G, in, r], "b": [L, G, r, out]}}}``) → (slabs, sort plan
    over the forward's ``b * m`` rows).  A verify block's token (i, j)
    flattens row-major, so each sequence's slot id repeats m times."""
    if lora is None:
        return None, None
    slabs = lora["slabs"]
    n_slots = next(iter(slabs.values()))["a"].shape[1]
    idx = torch.as_tensor(lora["idx"], device=dev).to(torch.int32)
    if m > 1:
        # expand, not repeat_interleave: no output-size read, so a CUDA
        # graph captures it
        idx = idx[:, None].expand(idx.shape[0], m).reshape(-1)
    return slabs, lora_plan(idx, n_slots)


def _layer_lora(slabs, layer: int):
    """Layer ``layer``'s slabs, ``{target: {"a": [G, in, r], "b": [G, r,
    out]}}``, or ``None`` without LoRA."""
    if slabs is None:
        return None
    return {t: {"a": ab["a"][layer], "b": ab["b"][layer]}
            for t, ab in slabs.items()}


def _qkv(cfg, lp, x, ll, plan, backend):
    """ln1 → fused qkv projection (+ its LoRA delta) → (h, q, k, v) before
    rope."""
    b, s = x.shape[0], x.shape[1]
    h = apply_norm(cfg, x, lp["ln1_scale"], lp["ln1_bias"], backend=backend)
    qkv = (quantized_matmul(h, lp["qkv_kernel"], backend=backend)
           + lp["qkv_bias"].to(x.dtype))
    if ll is not None and "qkv" in ll:
        qkv = qkv + batched_lora_delta(h, ll["qkv"]["a"], ll["qkv"]["b"],
                                       plan, backend=backend)
    q, k, v = split_qkv(cfg, qkv, b, s)
    return h, q, k, v


def _out_proj(cfg, lp, ctx_flat, ll, plan, backend):
    """Output projection of the attention context (+ its LoRA delta),
    bias not applied."""
    a = quantized_matmul(ctx_flat, lp["proj_kernel"], backend=backend)
    if ll is not None and "proj" in ll:
        a = a + batched_lora_delta(ctx_flat, ll["proj"]["a"],
                                   ll["proj"]["b"], plan, backend=backend)
    return a


def _out_post(cfg, lp, x, h, a, ll, plan, backend):
    """Projection bias → residual → ln2 → MLP (with its LoRA deltas) →
    residual."""
    a = a + lp["proj_bias"].to(x.dtype)
    res = h if cfg.apply_residual_connection_post_layernorm else x
    x = res + a
    h = apply_norm(cfg, x, lp["ln2_scale"], lp["ln2_bias"], backend=backend)
    if ll is not None and ("fc1" in ll or "fc2" in ll):
        m = lora_mlp(cfg, lp, h, ll, plan, backend=backend)
    else:
        m = _mlp(cfg, lp, h, backend=backend)
    res = h if cfg.apply_residual_connection_post_layernorm else x
    return res + m


def decode_step(params: dict, token, cache: dict, cfg: TransformerConfig,
                *, lora=None, device=None, backend: Optional[str] = None):
    """One decoding step: ``token`` ``[b]`` at positions ``cache['pos']``
    → (logits ``[b, v]`` fp32, the cache with ``pos + 1``).

    A ``block_tables`` entry selects the paged layout: the new K/V append
    to each sequence's tail block; writes past the table's reach or
    through an unmapped entry drop.

    ``lora`` (``{"idx": [b] slot ids, "slabs": stacked factors}``) adds
    each row's low-rank delta at every target matmul through two grouped
    matmuls (kernel row 9); slot-0 rows get none.  LoRA takes the
    unfused route (row 6, then the projection), since K3 owns the
    projection the delta must land on."""
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
    # rows whose write drops are redirected on the device, planned once
    # for every layer (plan_cells): no host sync, so a CUDA graph captures
    # the step
    cell = plan_cells((blk, off) if paged
                      else (torch.arange(b, device=dev), pos), ok)
    rope_cos = rope_sin = rope = None
    if cfg.position_embedding_type == "rope":
        rope = rope_cos_sin(max_pos, cfg.kv_channels, device=dev)
        r = pos.clamp(0, max_pos - 1)
        rope_cos, rope_sin = rope[0][r], rope[1][r]
    slabs, plan = _lora_operands(lora, dev)

    quant = "k_scale" in cache
    for layer in range(cfg.num_layers):
        lp = _layer_params(params, layer)
        ll = _layer_lora(slabs, layer)
        # a quantized projection slab stays unfused (as in JAX): row 6
        # attends, then row 10 projects; so do LoRA lanes
        fuse = ll is None and not is_quantized(lp["proj_kernel"])
        h, q, k, v = _qkv(cfg, lp, x, ll, plan, backend)
        if rope is not None:
            k = fused_apply_rotary_pos_emb_ragged(k, rope[0], rope[1], pos)
            if not fuse:
                q = fused_apply_rotary_pos_emb_ragged(q, rope[0], rope[1],
                                                      pos)
        ck, cv = cache["k"][layer], cache["v"][layer]
        sk = sv = None
        if quant:
            sk, sv = cache["k_scale"][layer], cache["v_scale"][layer]
            scatter_kv_quantized(ck, cv, sk, sv, k[:, 0], v[:, 0], cell)
        else:
            write_cells((ck, cv), (k[:, 0], v[:, 0]), cell)
        if paged:
            pool_k, pool_v = ck, cv
        else:
            g, dh = ck.shape[2], ck.shape[3]
            pool_k = ck.view(b * nbl, bs, g, dh)
            pool_v = cv.view(b * nbl, bs, g, dh)
        if fuse:
            a = fused_decode_layer(q[:, 0], pool_k, pool_v, tables, pos + 1,
                                   lp["proj_kernel"], rope_cos=rope_cos,
                                   rope_sin=rope_sin, backend=backend,
                                   k_scale=sk, v_scale=sv)
        else:
            ctx = ragged_paged_attention(q[:, 0], pool_k, pool_v, tables,
                                         pos + 1, backend=backend,
                                         k_scale=sk, v_scale=sv)
            a = _out_proj(cfg, lp, ctx.to(x.dtype).reshape(b, -1), ll, plan,
                          backend)
        x = _out_post(cfg, lp, x, h, a[:, None], ll, plan, backend)

    x = apply_norm(cfg, x, params["final_ln"]["scale"],
                   params["final_ln"]["bias"], backend=backend)
    new_pos = (pos + 1).to(torch.int32)
    return lm_head_logits(params, x[:, 0], cfg), dict(cache, pos=new_pos)


def _verify_attention(cfg, q, kk, vv, pos):
    """Dense masked attention of ``m`` appended queries ``q`` ``[b, m, nh,
    dh]`` over a cache view ``kk``/``vv`` ``[b, T, g, dh]``: query j of
    sequence i sees positions ``t <= pos[i] + j``.  fp32 products and
    sums of the operands as they are, probabilities rounded to the cache
    dtype before the second product (the JAX einsums)."""
    b, m = q.shape[0], q.shape[1]
    nh, dh, g = cfg.num_attention_heads, cfg.kv_channels, cfg.kv_groups
    rep = nh // g
    qg = q.reshape(b, m, g, rep, dh)
    s = torch.einsum("bqgrd,btgd->bgrqt", qg.float(), kk.float())
    s = s * (1.0 / dh ** 0.5)
    t_idx = torch.arange(kk.shape[1], device=q.device)
    qpos = pos[:, None] + torch.arange(m, device=q.device)[None]
    live = (t_idx[None, None] <= qpos[:, :, None])[:, None, None]
    s = torch.where(live, s, torch.full_like(s, -1e30))
    p = torch.softmax(s, dim=-1)
    ctx = torch.einsum("bgrqt,btgd->bqgrd", p.to(vv.dtype).float(),
                       vv.float())
    return ctx.reshape(b, m, nh * dh)


def decode_verify(params: dict, tokens, cache: dict,
                  cfg: TransformerConfig, *, lora=None, device=None,
                  backend: Optional[str] = None):
    """Verification forward: ``tokens`` ``[b, m]`` appended at each
    sequence's ``cache['pos']`` in ONE pass → (logits ``[b, m, v]`` fp32,
    the cache with ``pos + m``).

    Token (i, j) lands at position ``pos[i] + j``, attends to the cache
    prefix and the block's tokens before it, and its logits predict the
    next position: the gold sequence through this reproduces
    ``decode_step`` run m times.  Writes past the stripe or through an
    unmapped table entry drop; an int8 pool quantizes the new K/V as they
    land and the gathered view dequantizes.  Attention is dense torch
    arithmetic over the whole gathered view (the JAX package's einsums,
    no Pallas kernel).  ``lora``: the ``decode_step`` bundle, each
    sequence's slot id applied to its m rows; the serving engine
    prefills adapter prompts through this."""
    _check_decode_cfg(cfg)
    check_backend(backend)
    dev = resolve_device(device)
    _check_cache(cache)
    tokens = torch.as_tensor(tokens, device=dev).long()
    b, m = tokens.shape
    pos = cache["pos"].long()
    paged = "block_tables" in cache
    quant = "k_scale" in cache
    wpos = pos[:, None] + torch.arange(m, device=dev)[None]      # [b, m]
    x = _embed(params, cfg, tokens, wpos)
    if paged:
        tables = cache["block_tables"].long()
        nb, bs = cache["k"].shape[1], cache["k"].shape[2]
        mb = tables.shape[1]
        max_pos = mb * bs
        blk = tables.gather(1, (wpos // bs).clamp(0, mb - 1))
        blk = torch.where(wpos < max_pos, blk, nb)
        keep = blk < nb
        tbl = tables.clamp(max=nb - 1)
    else:
        max_pos = cache["k"].shape[2]
        keep = wpos < max_pos
    # the b·m cells row-major; dropped ones are redirected on the device,
    # planned once for every layer (plan_cells): no host sync, so a CUDA
    # graph captures the call
    if paged:
        cell = (blk.reshape(-1), (wpos % bs).reshape(-1))
    else:
        cell = (torch.arange(b, device=dev).repeat_interleave(m),
                wpos.reshape(-1))
    cell = plan_cells(cell, keep.reshape(-1))
    rope = None
    if cfg.position_embedding_type == "rope":
        rope = rope_cos_sin(max_pos, cfg.kv_channels, device=dev)
    slabs, plan = _lora_operands(lora, dev, m)

    for layer in range(cfg.num_layers):
        lp = _layer_params(params, layer)
        ll = _layer_lora(slabs, layer)
        h, q, k, v = _qkv(cfg, lp, x, ll, plan, backend)
        if rope is not None:
            q = fused_apply_rotary_pos_emb_ragged(q, rope[0], rope[1], pos)
            k = fused_apply_rotary_pos_emb_ragged(k, rope[0], rope[1], pos)
        ck, cv = cache["k"][layer], cache["v"][layer]
        kf, vf = k.reshape((b * m,) + k.shape[2:]), v.reshape(
            (b * m,) + v.shape[2:])
        if quant:
            sk, sv = cache["k_scale"][layer], cache["v_scale"][layer]
            scatter_kv_quantized(ck, cv, sk, sv, kf, vf, cell)
        else:
            write_cells((ck, cv), (kf, vf), cell)
        if paged:
            g, dh = ck.shape[2], ck.shape[3]
            kk = ck[tbl].reshape(b, mb * bs, g, dh)
            vv = cv[tbl].reshape(b, mb * bs, g, dh)
            if quant:
                kk = dequantize_kv(kk, sk[tbl].reshape(b, mb * bs, g))
                vv = dequantize_kv(vv, sv[tbl].reshape(b, mb * bs, g))
        else:
            kk, vv = ck, cv
        ctx = _verify_attention(cfg, q, kk, vv, pos).to(x.dtype)
        a = _out_proj(cfg, lp, ctx, ll, plan, backend)
        x = _out_post(cfg, lp, x, h, a, ll, plan, backend)

    x = apply_norm(cfg, x, params["final_ln"]["scale"],
                   params["final_ln"]["bias"], backend=backend)
    new_pos = (pos + m).to(torch.int32)
    return lm_head_logits(params, x, cfg), dict(cache, pos=new_pos)


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
    0).

    ``spec`` (``"ngram"``, a ``models.speculative.SpecConfig``, or
    ``None``/``"off"``) decodes speculatively: k drafted tokens verified
    by one :func:`decode_verify` forward a round; greedy output is
    token-identical to ``spec=None`` and sampling distribution-identical;
    with telemetry configured it counts ``generate.prefill_calls`` and
    ``generate.spec.{draft_tokens,accepted_tokens,verify_calls}``."""
    from apex_tpu_torch.models.speculative import resolve_spec, spec_generate

    if resolve_spec(spec) is not None:
        tokens, stats = spec_generate(
            params, prompt, cfg, spec=spec, max_new_tokens=max_new_tokens,
            temperature=temperature, top_k=top_k, top_p=top_p, seed=seed,
            generator=generator, vocab_limit=vocab_limit,
            prompt_lens=prompt_lens, eos_token_id=eos_token_id,
            cache_dtype=cache_dtype, cache_layout=cache_layout,
            block_size=block_size, cache_wire=cache_wire, device=device,
            backend=backend)
        _telemetry.counter("generate.prefill_calls").inc()
        for name, n in stats.items():
            _telemetry.counter(f"generate.spec.{name}").inc(n)
        return tokens
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
