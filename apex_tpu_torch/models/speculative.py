"""Speculative decoding: n-gram self-drafting and batched verification
(``apex_tpu/models/speculative.py``).

Decode reads every weight to emit one token.  A drafter proposes ``k``
tokens, ONE :func:`~apex_tpu_torch.models.generate.decode_verify`
forward scores all of them, and rejection sampling keeps the prefix the
target model agrees with: each round emits 1 to k+1 tokens for one
forward and one host round trip.

The contract is the JAX module's:

- **greedy** (temperature 0): a draft token is accepted iff it equals
  the target argmax, and the correction token is the target argmax at
  the first disagreement, so spec-on output is token-identical to
  spec-off greedy decoding;
- **sampling**: a draft ``d`` proposed with probability ``q(d)`` is
  accepted with probability ``min(1, p(d) / q(d))``; on rejection the
  replacement is drawn from ``norm(max(p - q, 0))``.  The emitted
  marginal is exactly ``p``.  The n-gram drafter is a point mass, so a
  draft is accepted with probability ``p(d)``, else the token is drawn
  from ``p`` with ``d`` removed.

Randomness: JAX draws with threefry, which torch does not reproduce.
Here the accept uniforms and the correction draw (by inverse CDF over
the leftover distribution) come from the counter hash of kernel K4
(``ops/fused_sampling._uniform_bits``), keyed by two words held in a
``[2]`` int64 tensor on the device: :func:`spec_round` makes no host
read, so a CUDA graph captures a round and replays it with new words
copied into that tensor.  Sampled output is distribution-identical to
JAX's, not token-identical.

:func:`ngram_draft` is prompt-lookup decoding: propose the tokens that
followed the most recent earlier occurrence of the current suffix
n-gram.  A draft model plugs in through ``SpecConfig(draft_fn=...)``:
``f(tokens [b, T], lens [b], k) -> (draft [b, k], q_probs [b, k, v] or
None)`` on torch tensors.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from apex_tpu_torch.models.config import TransformerConfig
from apex_tpu_torch.models.generate import (
    _check_decode_cfg, _check_sampling_args, _compute_dtype_params,
    decode_verify, init_kv_cache, prefill, sample_logits)
from apex_tpu_torch.ops.fused_sampling import (
    _M32, _seed_words, _uniform_bits, filter_logits)
from apex_tpu_torch.utils.registry import resolve_device

__all__ = ["SpecConfig", "resolve_spec", "ngram_draft", "spec_round",
           "spec_generate"]

_NEG_INF = -1e30


@dataclasses.dataclass(frozen=True)
class SpecConfig:
    """Speculative-decoding knobs.  ``k``: drafted tokens a round (a round
    emits 1 to k+1 tokens).  ``max_ngram`` / ``min_ngram``: the suffix
    sizes the n-gram drafter tries, longest first.  ``draft_fn``: an
    optional draft-model hook (module doc)."""

    k: int = 8
    max_ngram: int = 3
    min_ngram: int = 1
    draft_fn: Optional[Callable] = None

    def __post_init__(self):
        if self.k < 1:
            raise ValueError(f"spec k={self.k} must be >= 1")
        if not 1 <= self.min_ngram <= self.max_ngram:
            raise ValueError(f"need 1 <= min_ngram ({self.min_ngram}) <= "
                             f"max_ngram ({self.max_ngram})")


def resolve_spec(spec) -> Optional[SpecConfig]:
    """``None``/``"off"`` disable, ``"ngram"`` takes the defaults, a
    :class:`SpecConfig` passes through."""
    if spec is None or spec == "off":
        return None
    if spec == "ngram":
        return SpecConfig()
    if isinstance(spec, SpecConfig):
        return spec
    raise ValueError(
        f"spec={spec!r}: expected None, 'off', 'ngram', or a SpecConfig")


def ngram_draft(tokens: torch.Tensor, lens: torch.Tensor, *, k: int,
                max_ngram: int = 3, min_ngram: int = 1) -> torch.Tensor:
    """Propose the ``k`` tokens that followed the most recent earlier
    occurrence of the current suffix n-gram → int32 ``[b, k]``.

    ``tokens`` ``[b, T]`` is the emitted history (entries at and past
    ``lens[i]`` ignored), ``lens`` ``[b]`` its live length.  Sizes
    ``max_ngram`` down to ``min_ngram`` are tried in turn; the first size
    with a match wins, and within a size the most recent match.  A row
    with no match (or a match at the very end) drafts the clamped
    continuation: reads past ``lens - 1`` repeat the last token.  Integer
    arithmetic only, no host read."""
    b, T = tokens.shape
    dev = tokens.device
    lens = lens.long()
    idx = torch.arange(T, device=dev)
    best_j = (lens - 1).clamp(min=0)
    found = torch.zeros(b, dtype=torch.bool, device=dev)
    for n in range(max_ngram, min_ngram - 1, -1):
        eq = torch.ones(b, T, dtype=torch.bool, device=dev)
        for i in range(n):
            suf = tokens.gather(1, (lens - 1 - i).clamp(min=0)[:, None])
            # the token at j - i aligned under j (wrapped entries at j < i
            # lie outside the window below)
            eq = eq & (torch.roll(tokens, i, dims=1) == suf)
        valid = ((idx[None] >= n - 1) & (idx[None] <= lens[:, None] - 2)
                 & (lens[:, None] >= n))
        jn = torch.where(eq & valid, idx[None], -1).amax(1)
        best_j = torch.where(~found & (jn >= 0), jn, best_j)
        found = found | (jn >= 0)
    gidx = best_j[:, None] + 1 + torch.arange(k, device=dev)[None]
    gidx = torch.minimum(gidx.clamp(min=0),
                         (lens[:, None] - 1).clamp(min=0))
    return tokens.gather(1, gidx).to(torch.int32)


def _one_hot(idx, v: int) -> torch.Tensor:
    """fp32 one-hot rows of ``idx`` over ``v`` classes, by comparison (no
    range check, so no host read)."""
    return (torch.arange(v, device=idx.device) == idx[..., None]).float()


def _spec_probs(logits, temperature, top_k, top_p, vocab_limit,
                token_mask=None):
    """Per-position target distributions ``[b, m, v]``: the sampler's own
    chain (vocab limit, then the token mask, then temperature and
    :func:`~apex_tpu_torch.ops.fused_sampling.filter_logits`), so
    acceptance runs against the distribution a plain step samples from.
    Greedy rows (temperature 0) are one-hot argmax rows.  ``token_mask``
    is bool ``[v]`` or per-row ``[b, v]`` (a row's mask covers its m
    positions)."""
    b, m, v = logits.shape
    flat = logits.float().reshape(b * m, v)
    if vocab_limit is not None:
        over = torch.arange(v, device=flat.device) >= vocab_limit
        flat = torch.where(over[None], _NEG_INF, flat)
    if token_mask is not None:
        mask = (token_mask[None] if token_mask.ndim == 1
                else token_mask[:, None].expand(b, m, v).reshape(b * m, v))
        flat = torch.where(mask, flat, _NEG_INF)
    onehot = _one_hot(flat.argmax(-1), v)
    if isinstance(temperature, torch.Tensor) and temperature.ndim:
        temps = temperature.float()[:, None].expand(b, m).reshape(-1)
        scaled = flat / temps.clamp_min(1e-6)[:, None]
        soft = torch.softmax(filter_logits(scaled, top_k=top_k, top_p=top_p),
                             dim=-1)
        probs = torch.where((temps > 0)[:, None], soft, onehot)
    elif float(temperature) == 0.0:
        probs = onehot
    else:
        probs = torch.softmax(filter_logits(flat / float(temperature),
                                            top_k=top_k, top_p=top_p),
                              dim=-1)
    return probs.reshape(b, m, v)


def _accept(draft, probs, q_probs, words):
    """Rejection sampling over one verify block.

    ``draft`` ``[b, k]``; ``probs`` ``[b, k+1, v]`` target distributions
    (row j for the position draft j sits at, row k the bonus position);
    ``q_probs`` ``[b, k, v]`` proposal distributions or ``None`` (point
    mass); ``words`` the two key words, a ``[2]`` integer tensor.  →
    ``(n_acc [b], y [b])``: the accepted prefix's length and the
    correction token (from ``norm(max(p - q, 0))`` at the first
    rejection) or the bonus token (from ``p`` when all were accepted).
    Uniforms: the counter hash at (row i, column j) for draft j's accept
    test and at column k for row i's draw."""
    b, k = draft.shape
    v = probs.shape[-1]
    dev = draft.device
    words = words.to(device=dev, dtype=torch.int64)
    s0, s1 = words[0] & _M32, words[1] & _M32
    row = torch.arange(b, device=dev)[:, None]
    u = _uniform_bits(torch.arange(k, device=dev)[None], row, s0, s1)
    d = draft.long()
    pd = probs[:, :k].gather(-1, d[..., None])[..., 0]
    if q_probs is None:
        ratio = pd                                   # q(d) = 1
    else:
        qd = q_probs.gather(-1, d[..., None])[..., 0]
        ratio = pd / qd.clamp_min(1e-20)
    accept = (u < ratio).to(torch.int32)
    n_acc = torch.cumprod(accept, dim=1).sum(1).to(torch.int32)
    p_at = probs.gather(1, n_acc.long()[:, None, None].expand(b, 1, v))[:, 0]
    rej_col = n_acc.long().clamp(max=k - 1)
    d_rej = d.gather(1, rej_col[:, None])[:, 0]
    if q_probs is None:
        q_at = _one_hot(d_rej, v)
    else:
        q_at = q_probs.gather(1, rej_col[:, None, None].expand(b, 1, v))[:, 0]
    leftover = (p_at - q_at).clamp_min(0.0)
    z = leftover.sum(-1, keepdim=True)
    rejected = (n_acc < k)[:, None]
    # all-accept rows draw the bonus from p; rejected ones from the
    # leftover (p where its mass underflows: p(d) ~ 1 yet u >= p(d))
    dist = torch.where(rejected & (z > 1e-9), leftover / z.clamp_min(1e-9),
                       p_at)
    uy = _uniform_bits(torch.full((1, 1), k, device=dev), row, s0, s1)
    cdf = torch.cumsum(dist, dim=-1)
    # the first token whose cumulative mass reaches u * total: a token of
    # zero mass is never chosen
    y = (cdf < uy * cdf[:, -1:]).sum(-1).clamp(max=v - 1)
    return n_acc, y.to(torch.int32)


def spec_round(params, cfg: TransformerConfig, cache: dict, nxt, tokens,
               lens, words, *, spec: SpecConfig, temperature,
               top_k: Optional[int] = None, top_p: Optional[float] = None,
               vocab_limit: Optional[int] = None, token_mask=None,
               lora=None, backend: Optional[str] = None):
    """One draft → verify → accept round: the core of ``generate(spec=)``
    and of the serving engine's spec step.

    ``nxt`` ``[b]``: the pending token (emitted, its K/V not yet written;
    ``cache['pos']`` is its position).  ``tokens`` ``[b, T]``: the emitted
    history including ``nxt``; ``lens`` ``[b]`` its live length.
    ``words``: the two key words (``[2]`` integer tensor).  → ``(em,
    n_acc, y, cache, prev_pos)``: ``em`` ``[b, k+1]`` holds the accepted
    drafts then ``y`` at column ``n_acc`` (later columns are dead); the
    cache has all k+1 entries written (in place) and ``pos`` advanced by
    k+1; the caller commits ``pos = prev_pos + n_emit`` after its own EOS
    and budget truncation.  No host read."""
    from apex_tpu_torch.models.generate import decode_verify

    k = spec.k
    if spec.draft_fn is not None:
        draft, q_probs = spec.draft_fn(tokens, lens, k)
        draft = draft.to(torch.int32)
    else:
        draft = ngram_draft(tokens, lens, k=k, max_ngram=spec.max_ngram,
                            min_ngram=spec.min_ngram)
        q_probs = None
    prev_pos = cache["pos"]
    seq = torch.cat([nxt.to(torch.int32)[:, None], draft], dim=1)
    logits, cache = decode_verify(params, seq, cache, cfg, lora=lora,
                                  device=seq.device, backend=backend)
    probs = _spec_probs(logits, temperature, top_k, top_p, vocab_limit,
                        token_mask=token_mask)
    n_acc, y = _accept(draft, probs, q_probs, words)
    em = torch.cat([draft, draft[:, -1:]], dim=1)
    col = torch.arange(k + 1, device=em.device)[None]
    em = torch.where(col == n_acc[:, None], y[:, None], em)
    return em, n_acc, y, cache, prev_pos


def spec_generate(params: dict, prompt, cfg: TransformerConfig, *,
                  spec="ngram", max_new_tokens: int = 32,
                  temperature: float = 0.0, top_k: Optional[int] = None,
                  top_p: Optional[float] = None, seed: Optional[int] = None,
                  generator: Optional[torch.Generator] = None,
                  vocab_limit: Optional[int] = None, prompt_lens=None,
                  eos_token_id: Optional[int] = None,
                  cache_dtype: Optional[torch.dtype] = None,
                  cache_layout: str = "contiguous", block_size: int = 16,
                  cache_wire: Optional[str] = None, device=None,
                  backend: Optional[str] = None):
    """Speculative decoding past ``prompt`` ``[b, s]`` → (tokens ``[b, s +
    max_new_tokens]``, stats ``{"draft_tokens", "accepted_tokens",
    "verify_calls"}``).

    The surface and output of ``generate``: greedy output is
    token-identical to the plain path on both cache layouts and both
    wires, sampling is distribution-identical.  The first token comes
    from the prefill logits as in ``generate`` (the same key words); each
    round then draws two key words from ``generator``.  The cache holds
    k+1 cells of headroom: a verify block may write past the budget
    before its tail is rolled back.  ``verify_calls`` counts per-sequence
    verify passes (a batched round books once per live row)."""
    spec_cfg = resolve_spec(spec)
    if spec_cfg is None:
        raise ValueError("spec_generate needs an enabled spec config; call "
                         "generate() for the plain path")
    _check_sampling_args(temperature, top_k)
    _check_decode_cfg(cfg)
    dev = resolve_device(device)
    prompt = torch.as_tensor(prompt, device=dev).long()
    b, s = prompt.shape
    k = spec_cfg.k
    if (cfg.position_embedding_type == "learned"
            and s + max_new_tokens + k + 1 > cfg.max_position_embeddings):
        raise ValueError(
            f"prompt ({s}) + max_new_tokens ({max_new_tokens}) + "
            f"speculative verify headroom ({k + 1}) exceeds "
            f"max_position_embeddings ({cfg.max_position_embeddings})")
    if cache_layout not in ("contiguous", "paged"):
        raise ValueError(f"cache_layout={cache_layout!r}: expected "
                         "'contiguous' or 'paged'")
    if generator is None:
        generator = torch.Generator().manual_seed(0 if seed is None
                                                  else int(seed))
    total = s + max_new_tokens
    cache = init_kv_cache(cfg, b, total + k + 1, cache_dtype=cache_dtype,
                          cache_layout=cache_layout, block_size=block_size,
                          cache_wire=cache_wire, device=dev)
    params = _compute_dtype_params(params, cfg)
    lens = (torch.full((b,), s, dtype=torch.long, device=dev)
            if prompt_lens is None
            else torch.as_tensor(prompt_lens, device=dev).long())
    logits, cache = prefill(params, prompt, cfg, prompt_lens=prompt_lens,
                            cache=cache, device=dev, backend=backend)
    # one scratch column past the output: masked writes land there
    tokens = torch.cat([prompt, torch.zeros(b, max_new_tokens + 1,
                                            dtype=prompt.dtype, device=dev)],
                       dim=1)
    rows = torch.arange(b, device=dev)[:, None]
    col = torch.arange(k + 1, device=dev)[None]
    nxt = sample_logits(logits, generator, temperature=temperature,
                        top_k=top_k, top_p=top_p, vocab_limit=vocab_limit,
                        backend=backend).long()
    tokens[rows[:, 0], lens] = nxt
    done = (nxt == eos_token_id if eos_token_id is not None
            else torch.zeros(b, dtype=torch.bool, device=dev))
    done = done | (max_new_tokens <= 1)
    emitted = torch.ones(b, dtype=torch.long, device=dev)
    stats = torch.zeros(3, dtype=torch.long, device=dev)
    while not bool(done.all()):
        words = torch.tensor(_seed_words(generator), dtype=torch.int64,
                             device=dev)
        em, n_acc, _y, cache, prev_pos = spec_round(
            params, cfg, cache, nxt, tokens[:, :total], lens + emitted,
            words, spec=spec_cfg, temperature=temperature, top_k=top_k,
            top_p=top_p, vocab_limit=vocab_limit, backend=backend)
        n_acc = n_acc.long()
        n_emit = torch.minimum(n_acc + 1, max_new_tokens - emitted)
        if eos_token_id is not None:
            first = torch.where(em == eos_token_id, col,
                                k + 1).amin(1)
            n_emit = torch.minimum(n_emit, first + 1)
        n_emit = torch.where(done, 0, n_emit)
        wm = col < n_emit[:, None]
        wcols = torch.where(wm, (lens + emitted)[:, None] + col, total)
        tokens[rows, wcols] = em.to(tokens.dtype)
        last = em.gather(1, (n_emit - 1).clamp(min=0)[:, None])[:, 0].long()
        nxt = torch.where(done, nxt, last)
        new_done = done | (emitted + n_emit >= max_new_tokens)
        if eos_token_id is not None:
            new_done = new_done | (wm & (em == eos_token_id)).any(1)
        emitted = emitted + n_emit
        # rollback: keep the committed entries (done rows stay frozen)
        cache["pos"] = torch.where(done, prev_pos, prev_pos + n_emit).to(
            torch.int32)
        live = (~done).long()
        stats += torch.stack([k * live.sum(), (n_acc * live).sum(),
                              live.sum()])
        done = new_done
    st = stats.tolist()
    return tokens[:, :total], {"draft_tokens": st[0],
                               "accepted_tokens": st[1],
                               "verify_calls": st[2]}
