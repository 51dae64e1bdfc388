"""Fused sampling: logits → vocab limit → temperature → top-k/top-p →
draw, one op (``apex_tpu/ops/fused_sampling.py``).

For CUDA tensors :func:`fused_sample` launches kernel K4
(``csrc/fused_sampling.cu``): the cutoffs are found by 64-step value
bisection (no sort) and the draw is Gumbel-max over the counter hash
:func:`_uniform_bits`, seeded by two uint32 key words.  For CPU tensors,
and under ``backend="reference"``, it runs :func:`_sampling_plain`, a
transcription of the same arithmetic: with the same key words both give
the same tokens, and so does the JAX kernel.

K4 spreads each row over a thread-block cluster (:func:`sample_plan`
chooses its size and each CTA's slice), reads the logits in their own
dtype once, finds the greedy token and a histogram of the scaled row in
that pass, bisects over the few candidates the histogram leaves in one
CTA, and draws over the kept ones; any vocabulary width runs.  The key
words and temperatures reach the kernel in device memory: pass
``seed_words`` as a ``[2]`` int64 CUDA tensor and a CUDA graph that
captured the call replays new draws after new words are copied into it.

:func:`sample_reference` is the independent oracle: the sort-based
:func:`filter_logits` and a draw from a ``torch.Generator`` — the same
distribution, other random numbers.

A static ``temperature == 0`` is an argmax with no kernel launch; a
``[b]`` temperature vector mixes greedy rows (0) and sampled ones.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Sequence

import torch

from apex_tpu_torch.ops import _kernel_utils as ku
from apex_tpu_torch.utils.registry import check_backend, on_cuda

__all__ = ["fused_sample", "filter_logits", "sample_reference",
           "apply_token_mask", "sample_plan", "SamplePlan",
           "kernel_attributes"]

_NEG_INF = -1e30
_BISECT_ITERS = 64
_M32 = 0xFFFFFFFF

FUSED_SAMPLE = ku.register(ku.Kernel(
    "fused_sample", "fused_sampling.cu", "apex_fused_sample",
    [ctypes.c_void_p, ctypes.c_longlong] + [ctypes.c_void_p] * 3
    + [ctypes.c_int] * 4 + [ctypes.c_float] + [ctypes.c_int] * 7,
    replaces="apex_tpu/ops/fused_sampling.py:187"))

# K4's geometry (csrc/fused_sampling.cu): threads a CTA, histogram buckets,
# the portable cluster size, the dynamic shared memory a CTA may take and
# the part of it a staged slice (fp32 y, 4 bytes a logit) may
SAMPLE_THREADS = 512
SAMPLE_BINS = 2 * SAMPLE_THREADS
SAMPLE_MAX_CLUSTER = 8
SAMPLE_SMEM = 200 * 1024
SAMPLE_STAGE_MAX = 128 * 1024
# the fewest bytes of logits worth a CTA of their own
SAMPLE_MIN_BYTES = 4096


class SamplePlan(NamedTuple):
    cluster: int   # CTAs a row (a thread-block cluster)
    slice: int     # logits each CTA reads (a multiple of 8)
    staged: bool   # slices kept in shared memory as fp32 y (else re-read)
    cap: int       # candidates rank 0 holds (0: no filter)
    smem: int      # dynamic shared memory of a CTA, bytes


def sample_plan(b: int, V: int, itemsize: int, top_k: int, use_top_p: bool,
                sms: int) -> SamplePlan:
    """K4's launch for ``b`` rows of ``V`` logits of ``itemsize`` bytes
    (``top_k`` 0: no top-k) on a card of ``sms`` SMs: a pure function.
    The cluster is the largest power of two up to 8 with ``b`` clusters
    fitting the card and at least :data:`SAMPLE_MIN_BYTES` of logits a
    CTA; larger if a slice staged as fp32 would pass
    :data:`SAMPLE_STAGE_MAX`, and a slice still larger is re-read from L2
    in each pass.  With a filter the rest of :data:`SAMPLE_SMEM` after
    the slice and the histogram (12 bytes a bucket: a count and a
    fixed-point mass) holds candidates of 12 bytes."""
    fill = max(1, sms // max(1, b))
    per_cta = max(1, SAMPLE_MIN_BYTES // itemsize)
    c = 1
    while 2 * c <= min(fill, SAMPLE_MAX_CLUSTER) and V >= 2 * c * per_cta:
        c *= 2

    def slice_of(c):
        return -(-(-(-V // c)) // 8) * 8

    while c < SAMPLE_MAX_CLUSTER and slice_of(c) * 4 > SAMPLE_STAGE_MAX:
        c *= 2
    sl = slice_of(c)
    staged = sl * 4 <= SAMPLE_STAGE_MAX
    stage = sl * 4 if staged else 0
    if not (top_k > 0 or use_top_p):
        return SamplePlan(c, sl, staged, 0, stage)
    hist = 12 * SAMPLE_BINS
    cap = (SAMPLE_SMEM - stage - hist) // 12
    return SamplePlan(c, sl, staged, cap, stage + hist + 12 * cap)


def kernel_attributes() -> dict:
    """What the CUDA runtime reports of K4's instantiations (fp32, bf16
    and fp16; slices staged or read from L2): ``{name: {"registers",
    "smem_bytes", "ctas_per_sm", "spill_bytes"}}`` (static shared
    memory).  Needs the card."""
    return {f"{str(dt)[6:]} {'staged' if st else 'from L2'}": ku.hopper_attrs(
        FUSED_SAMPLE.source, "apex_fused_sample_attrs",
        ku.DTYPE_CODES[dt], int(st))
        for dt in (torch.float32, torch.bfloat16, torch.float16)
        for st in (True, False)}


def filter_logits(logits, *, top_k: Optional[int] = None,
                  top_p: Optional[float] = None):
    """Top-k / nucleus cutoffs on temperature-scaled ``logits`` ``[b, v]``;
    dropped tokens become -1e30 (the JAX package's sort-based op
    sequence)."""
    if top_p is None:
        if top_k is not None:
            kth = torch.topk(logits, top_k, dim=-1).values[:, -1:]
            logits = torch.where(logits < kth, _NEG_INF, logits)
        return logits
    sorted_l = torch.sort(logits, dim=-1, descending=True).values
    if top_k is not None:
        kth = sorted_l[:, top_k - 1][:, None]
        logits = torch.where(logits < kth, _NEG_INF, logits)
        rank = torch.arange(sorted_l.shape[-1], device=logits.device)[None]
        sorted_l = torch.where(rank >= top_k, _NEG_INF, sorted_l)
    probs = torch.softmax(sorted_l, dim=-1)
    csum = torch.cumsum(probs, dim=-1)
    keep_sorted = (csum - probs) < top_p
    n_keep = keep_sorted.sum(-1).clamp_min(1)
    cutoff = torch.gather(sorted_l, -1, (n_keep - 1)[:, None])
    return torch.where(logits < cutoff, _NEG_INF, logits)


def _mask_vocab(logits, vocab_limit: Optional[int]):
    if vocab_limit is None:
        return logits
    over = torch.arange(logits.shape[-1], device=logits.device) >= vocab_limit
    return torch.where(over[None], _NEG_INF, logits)


def apply_token_mask(logits, token_mask):
    """Constrained decoding: bool ``[v]`` or ``[b, v]`` mask, True =
    allowed; disallowed tokens become -1e30 before every filter."""
    if token_mask is None:
        return logits
    mask = token_mask[None] if token_mask.ndim == 1 else token_mask
    return torch.where(mask, logits, _NEG_INF)


def _temps(temperature, b: int, device) -> torch.Tensor:
    if isinstance(temperature, torch.Tensor) and temperature.ndim:
        return temperature.to(device=device, dtype=torch.float32)
    return torch.full((b,), float(temperature), dtype=torch.float32,
                      device=device)


def _is_static(temperature) -> bool:
    return not (isinstance(temperature, torch.Tensor) and temperature.ndim)


def sample_reference(logits, generator: torch.Generator, *,
                     temperature=0.0, top_k: Optional[int] = None,
                     top_p: Optional[float] = None,
                     vocab_limit: Optional[int] = None, token_mask=None):
    """Sort-based filtering and a categorical draw from ``generator``
    (on ``logits``' device); rows at temperature 0 take the argmax."""
    logits = apply_token_mask(_mask_vocab(logits.float(), vocab_limit),
                              token_mask)
    greedy = torch.argmax(logits, dim=-1).to(torch.int32)
    if _is_static(temperature) and float(temperature) == 0.0:
        return greedy
    temps = _temps(temperature, logits.shape[0], logits.device)
    scaled = filter_logits(logits / temps.clamp_min(1e-6)[:, None],
                           top_k=top_k, top_p=top_p)
    probs = torch.softmax(scaled, dim=-1)
    sampled = torch.multinomial(probs, 1, generator=generator)[:, 0]
    return torch.where(temps > 0, sampled.to(torch.int32), greedy)


def _mul32(a, b: int):
    """``(a * b) mod 2^32`` for int64 tensors holding uint32 values,
    split so no intermediate leaves int64 (CPU torch has no full uint32
    arithmetic)."""
    lo = (a & 0xFFFF) * b
    hi = (((a >> 16) * b) & 0xFFFF) << 16
    return (lo + hi) & _M32


def _uniform_bits(col, row, s0: int, s1: int):
    """Counter hash (``fused_sampling.py:165``) bit for bit: int64
    ``col``/``row`` tensors and two uint32 key words → fp32 uniforms,
    multiples of 2^-24 in [2^-24, 1 - 2^-24]."""
    x = col ^ ((s0 + _mul32(row, 0x9E3779B9)) & _M32)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    x = x ^ (x >> 16)
    x = (x + s1) & _M32
    x = _mul32(x, 0x27D4EB2F)
    x = x ^ (x >> 15)
    u = (x >> 8).to(torch.float32) * (1.0 / (1 << 24))
    return u.clamp_min(1.0 / (1 << 24))


def _bisect(lo, hi, pred_ok):
    for _ in range(_BISECT_ITERS):
        mid = 0.5 * (lo + hi)
        ok = pred_ok(mid)
        lo, hi = torch.where(ok, mid, lo), torch.where(ok, hi, mid)
    return lo


def _sampling_plain(logits, seed_words: Sequence[int], temps,
                    top_k: Optional[int], top_p: Optional[float],
                    vocab_limit: Optional[int]):
    """Kernel K4's arithmetic in plain PyTorch: the same masks, bisection
    cutoffs, hash and Gumbel-max, row by row in parallel → int32 ``[b]``."""
    x = logits.float()
    b, V = x.shape
    n_valid = V if vocab_limit is None else min(int(vocab_limit), V)
    dev = x.device
    col = torch.arange(V, device=dev)[None]
    valid = col < n_valid
    x = torch.where(valid, x, _NEG_INF)
    m = x.amax(-1, keepdim=True)
    greedy = torch.where((x == m) & valid, col, V).amin(-1)
    y = torch.where(valid, x / temps.clamp_min(1e-6)[:, None], _NEG_INF)

    if top_k is not None and min(int(top_k), n_valid) < n_valid:
        k = int(top_k)
        hi0 = y.amax(-1)
        lo0 = torch.where(y > _NEG_INF / 2, y, hi0[:, None]).amin(-1)
        kth = _bisect(lo0, hi0,
                      lambda mid: (y >= mid[:, None]).sum(-1) >= k)
        y = torch.where(y < kth[:, None], _NEG_INF, y)

    if top_p is not None:
        m2 = y.amax(-1, keepdim=True)
        live = y > _NEG_INF / 2
        e = torch.where(live, torch.exp(y - m2), 0.0)
        mass = e.sum(-1)
        target = torch.full_like(mass, top_p) * mass      # fp32 top_p
        lo0 = torch.where(live, y, m2).amin(-1) - 1.0
        theta = _bisect(
            lo0, m2[:, 0],
            lambda mid: torch.where(y > mid[:, None], e, 0.0).sum(-1)
            >= target)
        y = torch.where((y > theta[:, None]) | (col == greedy[:, None]), y,
                        _NEG_INF)

    row = torch.arange(b, device=dev)[:, None]
    u = _uniform_bits(col, row, int(seed_words[0]) & _M32,
                      int(seed_words[1]) & _M32)
    z = y + (-torch.log(-torch.log(u)))
    zm = z.amax(-1, keepdim=True)
    sampled = torch.where(z == zm, col, V).amin(-1)
    return torch.where(temps > 0, sampled, greedy).to(torch.int32)


def _word_buffer(seed_words, device) -> torch.Tensor:
    """The two key words as the ``[2]`` int64 device tensor K4 reads (its
    low 32 bits each): a CUDA tensor passes as it is, so a captured graph
    reads whatever words are copied into it before a replay; Python words
    are written by two fills (a host-to-device copy could not be
    captured)."""
    if isinstance(seed_words, torch.Tensor):
        if seed_words.shape != (2,) or seed_words.is_floating_point():
            raise ValueError(f"seed_words: want 2 integer words, got "
                             f"{seed_words.dtype} {tuple(seed_words.shape)}")
        return seed_words.to(device=device, dtype=torch.int64).contiguous()
    s0, s1 = (int(w) & _M32 for w in seed_words)
    words = torch.full((2,), s0, dtype=torch.int64, device=device)
    words[1:].fill_(s1)
    return words


def _sample_kernel(logits, seed_words, temps, top_k, top_p, vocab_limit):
    b, V = logits.shape
    n_valid = V if vocab_limit is None else min(int(vocab_limit), V)
    x = logits if logits.stride(-1) == 1 else logits.contiguous()
    code = ku.dtype_code(x)
    ld = x.stride(0) if b > 1 else V
    temps = temps.to(device=x.device, dtype=torch.float32).contiguous()
    words = _word_buffer(seed_words, x.device)
    ku.check_cuda_operands("fused_sample", x[:1], temps, words)
    k = 0 if top_k is None or int(top_k) >= n_valid else int(top_k)
    plan = sample_plan(b, V, x.element_size(), k, top_p is not None,
                       ku.sm_count(x.device))
    out = torch.empty(b, dtype=torch.int32, device=x.device)
    FUSED_SAMPLE(x.device, ku.ptr(x), ld, ku.ptr(temps), ku.ptr(words),
                 ku.ptr(out), b, V, n_valid, k, float(top_p or 0.0),
                 int(top_p is not None), plan.cluster, plan.slice,
                 int(plan.staged), plan.cap, plan.smem, code)
    return out


def _seed_words(generator: Optional[torch.Generator]):
    """Two uint32 key words drawn from a CPU ``generator`` (the port's
    stand-in for splitting a JAX key)."""
    w = torch.randint(0, 1 << 32, (2,), generator=generator,
                      dtype=torch.int64)
    return int(w[0]), int(w[1])


def fused_sample(logits, *, seed_words: Optional[Sequence[int]] = None,
                 generator: Optional[torch.Generator] = None,
                 temperature=0.0, top_k: Optional[int] = None,
                 top_p: Optional[float] = None,
                 vocab_limit: Optional[int] = None, token_mask=None,
                 backend: Optional[str] = None) -> torch.Tensor:
    """Next tokens ``[b]`` int32 from ``logits`` ``[b, v]``.

    ``seed_words``: two uint32 key words for the draw (else drawn from
    ``generator``), or a ``[2]`` integer tensor holding them (on the card
    the kernel reads it in place: graph-safe).  ``temperature``: a float
    (0 = greedy, no filter, no launch) or a ``[b]`` tensor of per-row
    temperatures."""
    check_backend(backend)
    if top_k is not None and top_k < 1:
        raise ValueError(
            f"top_k={top_k}: pass None (not 0) to disable the cutoff")
    static = _is_static(temperature)
    if static and float(temperature) < 0:
        raise ValueError(
            f"temperature={temperature}: negative temperatures would "
            "invert the distribution; pass 0 for greedy")
    logits = apply_token_mask(logits, token_mask)
    if static and float(temperature) == 0.0:
        return torch.argmax(_mask_vocab(logits, vocab_limit),
                            dim=-1).to(torch.int32)
    if seed_words is None:
        seed_words = _seed_words(generator)
    temps = _temps(temperature, logits.shape[0], logits.device)
    if on_cuda(logits) and backend is None:
        return _sample_kernel(logits, seed_words, temps, top_k, top_p,
                              vocab_limit)
    if isinstance(seed_words, torch.Tensor):
        seed_words = seed_words.tolist()
    return _sampling_plain(logits, seed_words, temps, top_k, top_p,
                           vocab_limit)
