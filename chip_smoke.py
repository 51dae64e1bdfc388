#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``apex_tpu_torch``) on one NVIDIA H100.

    python3 chip_smoke.py

1. Checks the card (CUDA present, compute capability 9.0) and prints its
   name, count and power limit.
2. Builds the port's CUDA kernels from ``apex_tpu_torch/csrc`` (one
   ``nvcc`` per source, all at once) and prints the build time.
3. Holds each kernel (K1 LayerNorm, K2 flash attention, K3 fused decode
   layer, K4 fused sampler) against its plain PyTorch version at the
   serving path's shapes, and times kernel, plain version and, where one
   exists, a single PyTorch library call computing the same function,
   beside the least time the card could take (the larger of bytes over
   3.35 TB/s and operations over the peak rate of their type).
4. Drives the serving path: ``generate`` on GPT-2 125M (random weights
   from a seeded generator, bf16 compute) for 8 ragged requests, greedy
   and sampled, counting every kernel launch; then replays the greedy
   tokens teacher-forced through the kernel path and the plain path
   (``backend="reference"``) and compares their logits.
5. Holds the backward kernels (K5 LayerNorm backward, K6 flash dq, K7
   flash dK/dV) against autograd of their plain forward at the train
   step's shapes, timed like the others.
6. Drives the training path: the GPT-2 125M AMP-O2 train step
   (``make_gpt_train_step``, ``fused_adam(lr=1e-4)``, fused head+CE) at
   b16 x s1024 on random tokens, counting every kernel launch of one
   step; step time, tokens/s, MFU and the device idle share of one
   profiled step; then 3 steps at b4 x s1024 on the kernel path and on
   the plain path from one state (loss, scaler decisions, grad norm).
7. Prints one JSON line describing every kernel, then the card's name and
   power limit, then ``{"ok": true, "device": {...}}`` as the last line.

Any failed check raises, so the script exits non-zero and prints no
result line; it never falls back to the CPU.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time

import torch
import torch.nn.functional as F

PEAK_BYTES_PER_S = 3.35e12      # H100 SXM HBM3
PEAK_BF16_FLOPS = 989e12        # dense tensor-core bf16
PEAK_FP32_FLOPS = 67e12         # fp32 outside the tensor cores

PROMPT_LENS = [17, 64, 128, 200, 256, 333, 400, 512]
NEW_TOKENS = 64
VOCAB_LIMIT = 50257             # GPT-2's 50257 ids padded to 50304
LOGIT_TOL = 0.1                 # bf16 compute through 12 layers
PREFILL_RUNS = 10
GENERATE_RUNS = 5

TRAIN_BATCH, TRAIN_SEQ = 16, 1024
TRAIN_WARMUP, TRAIN_STEPS = 2, 10
CHECK_BATCH, CHECK_STEPS = 4, 3
TRAIN_LOSS_TOL = 2e-2           # kernel vs plain loss, bf16 through 12 layers
GRAD_NORM_RTOL = 2e-2
# backward errors relative to the largest plain gradient: K5's dx is
# rounded once to the activation dtype; K6/K7 round p and ds to bf16
# before the tensor-core products
LN_BWD_TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}
FLASH_BWD_TOL = 2e-2


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int = 20, reps: int = 3) -> float:
    """Device time of one ``fn()``: ``iters`` calls captured in a CUDA
    graph, replayed ``reps`` times between two CUDA events, so the host's
    launch overhead between calls is not counted.  Inputs stay warm in
    L2 across calls."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (iters * reps)


def bound(nbytes: float, flops: float, peak_flops: float):
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / peak_flops * 1e3
    return (max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations")


def quartiles(xs):
    """(first quartile, median, third quartile) of the samples."""
    t = torch.tensor(xs, dtype=torch.float64)
    return tuple(float(v) for v in torch.quantile(
        t, torch.tensor([0.25, 0.5, 0.75], dtype=torch.float64)))


def max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def wall_ms(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def _category(kernel: str) -> str:
    if "(anonymous namespace)::" in kernel:      # apex_tpu_torch/csrc
        return "hand-written kernels"
    if any(t in kernel.lower() for t in ("gemm", "nvjet", "cutlass")):
        return "cuBLAS matmuls"
    return "other (elementwise, reductions, copies)"


def profile_busy(fn):
    """(wall ms, device busy ms, top kernels, ms by category, top ops) of
    one ``fn()`` under torch.profiler.  Busy time sums the device-side
    kernel events only: a CPU op's self device time repeats the kernels
    it launched (the hand-written kernels would count twice, under their
    own name and under ``_Flash``/``_Norm``).  The top ops are the CPU
    ops ranked by that self device time: which op launched the time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = wall_ms(fn)
    by_name, by_cat, by_op = {}, {}, {}
    for ev in prof.key_averages():
        if not ev.self_device_time_total:
            continue
        ms = ev.self_device_time_total / 1e3
        if ev.device_type != DeviceType.CUDA:
            by_op[ev.key] = by_op.get(ev.key, 0.0) + ms
            continue
        by_name[ev.key[:60]] = by_name.get(ev.key[:60], 0.0) + ms
        cat = _category(ev.key)
        by_cat[cat] = by_cat.get(cat, 0.0) + ms

    def top(d):
        return {k: round(v, 3)
                for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:12]}

    return (t, sum(by_name.values()), top(by_name),
            {k: round(v, 3) for k, v in by_cat.items()}, top(by_op))


def kernel_layer_norm(dev, gen):
    from apex_tpu_torch.ops import layer_norm as tln

    rows, h = 4096, 768
    w = torch.randn(h, device=dev, generator=gen)
    b = torch.randn(h, device=dev, generator=gen)
    errs = {}
    for dtype, tol in ((torch.float32, 1e-5), (torch.bfloat16, 2e-2)):
        x = (torch.randn(rows, h, device=dev, generator=gen) * 2).to(dtype)
        got = tln.fused_layer_norm(x, w, b)
        want = tln.fused_layer_norm(x, w, b, backend="reference")
        errs[str(dtype)] = (max_err(got, want), tol)
        check(errs[str(dtype)][0] <= tol, f"K1 {dtype} error {errs}")
    x = (torch.randn(rows, h, device=dev, generator=gen)).to(torch.bfloat16)
    wb, bb = w.to(torch.bfloat16), b.to(torch.bfloat16)
    nbytes = rows * h * 2 * 2 + 2 * h * 4 + rows * 8
    bms, by = bound(nbytes, rows * h * 8, PEAK_FP32_FLOPS)
    return {
        "err": errs["torch.bfloat16"][0], "tol": 2e-2, "detail": errs,
        "ms": time_ms(lambda: tln.fused_layer_norm(x, w, b)),
        "plain_ms": time_ms(lambda: tln.fused_layer_norm(
            x, w, b, backend="reference")),
        "library_ms": time_ms(lambda: F.layer_norm(x, (h,), wb, bb)),
        "bound_ms": bms, "bound_by": by,
        "shape": f"[{rows}, {h}] bf16 (also fp32 checked)",
    }


def kernel_flash(dev, gen):
    from apex_tpu_torch.ops import flash_attention as tfa

    b, s, n, d = 8, 512, 12, 64
    lens = torch.tensor(PROMPT_LENS, device=dev)
    kpm = torch.arange(s, device=dev)[None] >= lens[:, None]
    errs = {}
    tol = 2e-2
    main = None
    for name, g, causal, pad in (("causal", 12, True, False),
                                 ("causal+pad", 12, True, True),
                                 ("gqa g=4 causal+pad", 4, True, True)):
        q = torch.randn(b, s, n, d, device=dev, generator=gen).bfloat16()
        k = torch.randn(b, s, g, d, device=dev, generator=gen).bfloat16()
        v = torch.randn(b, s, g, d, device=dev, generator=gen).bfloat16()
        m = kpm if pad else None
        got = tfa.flash_attention(q, k, v, causal=causal,
                                  key_padding_mask=m)
        want = tfa.flash_attention(q, k, v, causal=causal,
                                   key_padding_mask=m, backend="reference")
        errs[name] = max_err(got, want)
        check(errs[name] <= tol, f"K2 {name} error {errs[name]}")
        if name == "causal+pad":
            main = (q, k, v, m)
    q, k, v, m = main
    # pairs (query row r, key c) the masks leave open: c <= r and c < len
    r = torch.arange(s, device=dev)
    pairs = int(torch.minimum(r[None] + 1, lens[:, None]).sum()) * n
    nbytes = 4 * b * s * n * d * 2 + b * s * 4 + b * n * s * 4
    bms, by = bound(nbytes, 4 * d * pairs, PEAK_BF16_FLOPS)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    return {
        "err": max(errs.values()), "tol": tol, "detail": errs,
        "ms": time_ms(lambda: tfa.flash_attention(
            q, k, v, causal=True, key_padding_mask=m)),
        "plain_ms": time_ms(lambda: tfa.flash_attention(
            q, k, v, causal=True, key_padding_mask=m, backend="reference"),
            iters=4),
        "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True)),
        "bound_ms": bms, "bound_by": by,
        "shape": f"b={b} s={s} n={n} d={d} bf16 causal, ragged padding",
    }


def kernel_decode(dev, gen):
    from apex_tpu_torch.ops import decode_step as tds

    b, nh, dh, bs, h_out = 8, 12, 64, 16, 768
    lens = torch.tensor([17, 64, 128, 200, 256, 333, 400, 576],
                        device=dev, dtype=torch.int32)
    mb = 36
    errs = {}
    tol = 2e-2
    main = None
    for name, g, rope in (("mha learned", 12, False), ("mha rope", 12, True),
                          ("gqa g=4 rope", 4, True)):
        nb = b * mb + 7
        tables = torch.randperm(nb, device=dev, generator=gen)[:b * mb]
        tables = tables.view(b, mb).to(torch.int32)
        for i in range(b):
            tables[i, -(-int(lens[i]) // bs):] = nb + 1   # unmapped tails
        q = torch.randn(b, nh, dh, device=dev, generator=gen).bfloat16()
        kp = torch.randn(nb, bs, g, dh, device=dev, generator=gen).bfloat16()
        vp = torch.randn(nb, bs, g, dh, device=dev, generator=gen).bfloat16()
        w = torch.randn(nh * dh, h_out, device=dev, generator=gen) * 0.02
        cos = sin = None
        if rope:
            ang = torch.rand(b, dh // 2, device=dev, generator=gen) * 6
            ang = torch.cat([ang, ang], -1)
            cos, sin = ang.cos(), ang.sin()
        args = (q, kp, vp, tables, lens, w)
        got = tds.fused_decode_layer(*args, rope_cos=cos, rope_sin=sin)
        want = tds.fused_decode_layer(*args, rope_cos=cos, rope_sin=sin,
                                      backend="reference")
        errs[name] = max_err(got, want)
        check(errs[name] <= tol, f"K3 {name} error {errs[name]}")
        if main is None:
            main = (args, g)
    args, g = main
    live = int(lens.sum())
    nbytes = (live * g * dh * 2 * 2 + nh * dh * h_out * 4 + b * nh * dh * 2
              + b * h_out * 2 + args[3].numel() * 4)
    flops = 4 * live * nh * dh + 2 * b * nh * dh * h_out
    bms, by = bound(nbytes, flops, PEAK_FP32_FLOPS)
    return {
        "err": max(errs.values()), "tol": tol, "detail": errs,
        "ms": time_ms(lambda: tds.fused_decode_layer(*args)),
        "plain_ms": time_ms(lambda: tds.fused_decode_layer(
            *args, backend="reference")),
        "library_ms": None, "bound_ms": bms, "bound_by": by,
        "shape": f"b={b} nh={nh} dh={dh} block={bs} lengths 17-576 bf16",
    }


def kernel_sampler(dev, gen):
    from apex_tpu_torch.ops import fused_sampling as tfs

    b, V = 8, 50304
    x = torch.randn(b, V, device=dev, generator=gen) * 4
    temps = torch.tensor([0.8, 1.0, 0.0, 0.5, 1.5, 0.8, 0.0, 2.0],
                         device=dev)
    kw = dict(temperature=temps, top_k=50, top_p=0.95,
              vocab_limit=VOCAB_LIMIT)
    mismatches = 0
    for words in ((1, 2), (0xDEADBEEF, 0x12345678), (7, 7)):
        got = tfs.fused_sample(x, seed_words=words, **kw)
        want = tfs._sampling_plain(x, words, temps, 50, 0.95, VOCAB_LIMIT)
        mismatches += int((got != want).sum())
        check(int(got.max()) < VOCAB_LIMIT, "K4 token past the vocab limit")
    check(mismatches == 0, f"K4 differs from _sampling_plain on "
                           f"{mismatches} rows")
    bms, by = bound(b * V * 4 + b * 8, b * V * 4, PEAK_FP32_FLOPS)
    return {
        "err": float(mismatches), "tol": 0.0,
        "detail": {"token_mismatches": mismatches},
        "ms": time_ms(lambda: tfs.fused_sample(x, seed_words=(1, 2), **kw)),
        "plain_ms": time_ms(lambda: tfs._sampling_plain(
            x, (1, 2), temps, 50, 0.95, VOCAB_LIMIT), iters=2),
        "library_ms": None, "bound_ms": bms, "bound_by": by,
        "shape": f"[{b}, {V}] fp32 top_k=50 top_p=0.95",
    }


def slice_phase(dev):
    from apex_tpu_torch.models import generate as tgen
    from apex_tpu_torch.models.config import gpt_125m
    from apex_tpu_torch.models.transformer_lm import init_gpt_params
    from apex_tpu_torch.ops import _kernel_utils as ku

    cfg = gpt_125m()
    t0 = time.perf_counter()
    params = init_gpt_params(cfg, torch.Generator().manual_seed(0), dev)
    torch.cuda.synchronize()
    print(f"params: gpt_125m random init {time.perf_counter() - t0:.2f}s")
    gen = torch.Generator().manual_seed(1)
    b, s = len(PROMPT_LENS), max(PROMPT_LENS)
    prompt = torch.zeros(b, s, dtype=torch.long)
    for i, n in enumerate(PROMPT_LENS):
        prompt[i, :n] = torch.randint(0, VOCAB_LIMIT, (n,), generator=gen)
    prompt = prompt.to(dev)
    lens = torch.tensor(PROMPT_LENS, device=dev)
    kw = dict(max_new_tokens=NEW_TOKENS, prompt_lens=lens,
              cache_layout="paged", block_size=16, device=dev)
    sample_kw = dict(kw, temperature=0.8, top_k=50, top_p=0.95,
                     vocab_limit=VOCAB_LIMIT, seed=1234)

    # warm-up (allocator, library handles) on a short run
    tgen.generate(params, prompt, cfg, **dict(kw, max_new_tokens=2))
    torch.cuda.synchronize()

    # --- the main path: counts reset just before, read just after --------
    ku.reset_launch_counts()
    greedy = tgen.generate(params, prompt, cfg, **kw)
    torch.cuda.synchronize()
    after_greedy = ku.launch_counts()
    sampled = tgen.generate(params, prompt, cfg, **sample_kw)
    torch.cuda.synchronize()
    counts = ku.launch_counts()

    steps = NEW_TOKENS - 1
    L = cfg.num_layers
    want_greedy = {name: 0 for name in ku.KERNELS}
    want_greedy.update({"layer_norm_fwd": (2 * L + 1) * (1 + steps),
                        "flash_attention_fwd": L,
                        "fused_decode_layer": L * steps})
    check(after_greedy == want_greedy,
          f"greedy launches {after_greedy} != {want_greedy}")
    want_total = {k: 2 * v for k, v in want_greedy.items()}
    want_total["fused_sample"] = NEW_TOKENS
    check(counts == want_total, f"launches {counts} != {want_total}")
    print(f"launches (greedy + sampled generate): {counts}")

    # --- outputs: shapes, vocab, determinism ------------------------------
    check(tuple(greedy.shape) == (b, s + NEW_TOKENS), "generate shape")
    for i, n in enumerate(PROMPT_LENS):
        check(torch.equal(greedy[i, :n], prompt[i, :n]), "prompt kept")
        check(int(sampled[i, n:n + NEW_TOKENS].max()) < VOCAB_LIMIT,
              "sampled token past the vocab limit")
    again = tgen.generate(params, prompt, cfg, **sample_kw)
    check(torch.equal(sampled, again), "sampled generate not reproducible")

    # --- teacher-forced: kernel path vs plain path on the same tokens ----
    def forced(backend):
        cache = tgen.init_kv_cache(cfg, b, s + NEW_TOKENS,
                                   cache_layout="paged", block_size=16,
                                   device=dev)
        logits, cache = tgen.prefill(params, prompt, cfg, prompt_lens=lens,
                                     cache=cache, device=dev,
                                     backend=backend)
        out = [logits]
        for j in range(steps):
            tok = greedy[torch.arange(b, device=dev), lens + j]
            logits, cache = tgen.decode_step(params, tok, cache, cfg,
                                             device=dev, backend=backend)
            out.append(logits)
        return torch.stack(out, 1)        # [b, NEW_TOKENS, v]

    lk, lp = forced(None), forced("reference")
    lk, lp = lk[..., :VOCAB_LIMIT], lp[..., :VOCAB_LIMIT]
    logit_err = max_err(lk, lp)
    check(logit_err <= LOGIT_TOL,
          f"kernel vs plain logits differ by {logit_err} > {LOGIT_TOL}")
    gen_tok = torch.stack([greedy[torch.arange(b, device=dev), lens + j]
                           for j in range(NEW_TOKENS)], 1)
    picked = lp.gather(-1, gen_tok[..., None])[..., 0]
    gap = float((lp.amax(-1) - picked).max())
    check(gap <= LOGIT_TOL,
          f"a generated token's plain logit is {gap} below the plain max")
    agree = float((lp.argmax(-1) == gen_tok).float().mean())
    print(f"teacher-forced logits: max |kernel - plain| {logit_err:.5f} "
          f"(tol {LOGIT_TOL}); worst generated-token gap to plain max "
          f"{gap:.5f}; plain argmax == generated on {agree:.4f} of steps")

    # --- timing: prefill alone, then the whole greedy generate -----------
    def do_prefill():
        cache = tgen.init_kv_cache(cfg, b, s + NEW_TOKENS,
                                   cache_layout="paged", block_size=16,
                                   device=dev)
        tgen.prefill(params, prompt, cfg, prompt_lens=lens, cache=cache,
                     device=dev)

    def do_generate():
        tgen.generate(params, prompt, cfg, **kw)

    prefill = quartiles([wall_ms(do_prefill) for _ in range(PREFILL_RUNS)])
    gen_ms = quartiles([wall_ms(do_generate) for _ in range(GENERATE_RUNS)])
    decode_ms = (gen_ms[1] - prefill[1]) / steps

    # --- device busy share of one greedy generate (torch.profiler) -------
    t_prof, busy, top, by_cat, by_op = profile_busy(do_generate)
    return {
        "prefill_ms": prefill[1], "prefill_ms_q1_q3": [prefill[0],
                                                       prefill[2]],
        "generate_ms": gen_ms[1], "generate_ms_q1_q3": [gen_ms[0],
                                                        gen_ms[2]],
        "decode_ms_per_step": decode_ms,
        "tokens_per_s": b * NEW_TOKENS / (gen_ms[1] / 1e3),
        "runs": {"prefill": PREFILL_RUNS, "generate": GENERATE_RUNS},
        "profiled_generate_ms": t_prof,
        "device_busy_ms": busy if busy > 0 else "not measured",
        "device_idle_share": (1 - busy / t_prof) if busy > 0
        else "not measured",
        "device_top_ms": top, "device_ms_by_category": by_cat,
        "device_ms_by_op": by_op,
        "counts": counts, "logit_err": logit_err, "token_gap": gap,
        "argmax_agree": agree,
    }


def rel_err(got, want) -> float:
    """max |got - want| over max |want|."""
    want = want.float()
    return float((got.float() - want).abs().max()
                 / want.abs().max().clamp_min(1e-12))


def kernel_layer_norm_bwd(dev, gen):
    """K5 against autograd of the plain LayerNorm forward, [16384, 768]
    (ln1, ln2 and the final LN of the b16 x s1024 train step)."""
    from apex_tpu_torch.ops import layer_norm as tln

    rows, h = TRAIN_BATCH * TRAIN_SEQ, 768
    w = 1 + 0.1 * torch.randn(h, device=dev, generator=gen)
    b = 0.1 * torch.randn(h, device=dev, generator=gen)
    errs, abs_errs = {}, {}
    for dtype in (torch.float32, torch.bfloat16):
        x = (torch.randn(rows, h, device=dev, generator=gen) * 2).to(dtype)
        dy = torch.randn(rows, h, device=dev, generator=gen).to(dtype)
        _, mu, rs = tln.layer_norm_fwd_stats(x, w, b)
        got = tln.layer_norm_bwd(dy, x, w, mu, rs)
        leaves = [t.detach().requires_grad_() for t in (x, w, b)]
        want = torch.autograd.grad(tln.layer_norm_ref(*leaves), leaves, dy)
        errs[str(dtype)] = max(rel_err(a, e) for a, e in zip(got, want))
        abs_errs[str(dtype)] = max(max_err(a, e) for a, e in zip(got, want))
        check(errs[str(dtype)] <= LN_BWD_TOL[dtype],
              f"K5 {dtype} error {errs}")
    # timed at the train step's bf16 activations
    x = torch.randn(rows, h, device=dev, generator=gen).to(torch.bfloat16)
    dy = torch.randn(rows, h, device=dev, generator=gen).to(torch.bfloat16)
    _, mu, rs = tln.layer_norm_fwd_stats(x, w, b)
    wb, bb = w.to(torch.bfloat16), b.to(torch.bfloat16)
    _, lmean, lrstd = torch.ops.aten.native_layer_norm(x, [h], wb, bb, 1e-5)
    nbytes = 3 * rows * h * 2 + 2 * rows * 4 + 3 * h * 4
    bms, by = bound(nbytes, 13 * rows * h, PEAK_FP32_FLOPS)
    return {
        "err": abs_errs["torch.bfloat16"], "rel_err": max(errs.values()),
        "tol": LN_BWD_TOL[torch.bfloat16], "detail": errs,
        "ms": time_ms(lambda: tln.layer_norm_bwd(dy, x, w, mu, rs)),
        "plain_ms": time_ms(lambda: tln.layer_norm_bwd(
            dy, x, w, mu, rs, backend="reference")),
        "library_ms": time_ms(lambda: torch.ops.aten.native_layer_norm_backward(
            dy, x, [h], lmean, lrstd, wb, bb, [True, True, True])),
        "bound_ms": bms, "bound_by": by,
        "shape": f"[{rows}, {h}] bf16 dx, fp32 dgamma/dbeta (also fp32 "
                 "checked); library = aten native_layer_norm_backward",
    }


def kernel_flash_bwd(dev, gen):
    """K6 and K7 against autograd of mha_reference at b16 s1024 n12 d64
    bf16: causal, causal with key padding, GQA g=4; timed on the causal
    MHA case the train step runs."""
    from apex_tpu_torch.ops import flash_attention as tfa

    b, s, n, d = TRAIN_BATCH, TRAIN_SEQ, 12, 64
    lens = torch.linspace(s, s // 8, b, device=dev).long()
    kpm = torch.arange(s, device=dev)[None] >= lens[:, None]
    errs, abs_err = {}, 0.0
    main = None
    for name, g, pad in (("causal", 12, False), ("causal+pad", 12, True),
                         ("gqa g=4 causal", 4, False)):
        q = torch.randn(b, s, n, d, device=dev, generator=gen).bfloat16()
        k = torch.randn(b, s, g, d, device=dev, generator=gen).bfloat16()
        v = torch.randn(b, s, g, d, device=dev, generator=gen).bfloat16()
        do = torch.randn(b, s, n, d, device=dev, generator=gen).bfloat16()
        m = kpm if pad else None
        o, lse = tfa.flash_attention_fwd(q, k, v, causal=True,
                                         key_padding_mask=m)
        got = tfa.flash_attention_bwd(q, k, v, o, lse, do, causal=True,
                                      key_padding_mask=m)
        leaves = [t.detach().requires_grad_() for t in (q, k, v)]
        want = torch.autograd.grad(tfa.mha_reference(
            *leaves, causal=True, key_padding_mask=m), leaves, do)
        for gname, a, e in zip(("dq", "dk", "dv"), got, want):
            errs[f"{name} {gname}"] = rel_err(a, e)
            abs_err = max(abs_err, max_err(a, e))
        del want, leaves
        check(max(errs.values()) <= FLASH_BWD_TOL,
              f"K6/K7 {name} error {errs}")
        if name == "causal":
            main = (q, k, v, o, lse, do)
    q, k, v, o, lse, do = main
    ops = tfa.flash_bwd_operands(q, k, v, o, lse, do)
    pairs = n * b * s * (s + 1) // 2           # causal, no padding
    io = 2 * b * s * n * d * 2 + 2 * b * s * n * d * 2   # q, do; k, v
    stats = 2 * b * n * s * 4                           # lse, delta
    dq_b, dq_by = bound(io + stats + b * s * n * d * 2, 6 * d * pairs,
                        PEAK_BF16_FLOPS)
    dkv_b, dkv_by = bound(io + stats + 2 * b * s * n * d * 2, 8 * d * pairs,
                          PEAK_BF16_FLOPS)
    plain_ms = time_ms(lambda: tfa.flash_attention_bwd_ref(
        q, k, v, o, lse, do, causal=True), iters=2, reps=2)
    qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_()
                  for t in (q, k, v))
    dot = do.transpose(1, 2)

    def sdpa():
        return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)

    lib_ms = (time_ms(lambda: torch.autograd.grad(sdpa(), (qt, kt, vt), dot))
              - time_ms(sdpa))
    common = {"err": abs_err, "rel_err": max(errs.values()),
              "tol": FLASH_BWD_TOL, "detail": errs,
              "plain_ms": plain_ms, "library_ms": lib_ms}
    shape = (f"b={b} s={s} n={n} d={d} bf16 causal (checked also with "
             "key padding and GQA g=4); plain and library = the whole "
             "backward (dq, dk, dv)")
    return {
        "flash_attention_bwd_dq": dict(
            common, ms=time_ms(lambda: tfa.flash_bwd_dq(ops, causal=True)),
            bound_ms=dq_b, bound_by=dq_by, shape=shape),
        "flash_attention_bwd_dkv": dict(
            common, ms=time_ms(lambda: tfa.flash_bwd_dkv(ops, causal=True)),
            bound_ms=dkv_b, bound_by=dkv_by, shape=shape),
    }


def _train_cfg():
    from apex_tpu_torch.models.config import gpt_125m

    return gpt_125m(max_position_embeddings=TRAIN_SEQ, remat=False,
                    scan_layers=False, fused_head_ce=True)


def _batch(cfg, b, seed, dev):
    gen = torch.Generator().manual_seed(seed)
    tokens = torch.randint(0, cfg.vocab_size, (b, TRAIN_SEQ), generator=gen)
    labels = torch.randint(0, cfg.vocab_size, (b, TRAIN_SEQ), generator=gen)
    return tokens.to(dev), labels.to(dev)


def train_phase(dev):
    """The GPT-2 125M AMP-O2 train step at b16 x s1024 with exact launch
    counts, step time, tokens/s, MFU and the device idle share."""
    from apex_tpu_torch.models.gpt import make_gpt_train_step
    from apex_tpu_torch.ops import _kernel_utils as ku
    from apex_tpu_torch.optimizers import fused_adam
    from apex_tpu_torch.optimizers._common import tree_leaves

    cfg = _train_cfg()
    init, step = make_gpt_train_step(cfg, fused_adam(lr=1e-4), "O2",
                                     device=dev)
    state = init(torch.Generator().manual_seed(0))
    n_params = sum(p.numel() for p in tree_leaves(state.master_params))
    tokens, labels = _batch(cfg, TRAIN_BATCH, 0, dev)
    traj = []

    def one():
        nonlocal state
        state, m = step(state, tokens, labels)
        traj.append(m)

    for _ in range(TRAIN_WARMUP):
        one()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    # --- the main path: counts reset just before, read just after -------
    ku.reset_launch_counts()
    one()
    torch.cuda.synchronize()
    counts = ku.launch_counts()
    L = cfg.num_layers
    want = {name: 0 for name in ku.KERNELS}
    want.update({"layer_norm_fwd": 2 * L + 1, "layer_norm_bwd": 2 * L + 1,
                 "flash_attention_fwd": L, "flash_attention_bwd_dq": L,
                 "flash_attention_bwd_dkv": L})
    check(counts == want, f"train-step launches {counts} != {want}")
    print(f"launches (one train step): {counts}")

    step_ms = [wall_ms(one) for _ in range(TRAIN_STEPS)]
    q1, med, q3 = quartiles(step_ms)
    t_prof, busy, top, by_cat, by_op = profile_busy(one)
    losses = [float(m["loss"]) for m in traj]
    scales = [float(m["loss_scale"]) for m in traj]
    overflow = [bool(m["overflow"]) for m in traj]
    check(all(math.isfinite(x) for x in losses), f"losses {losses}")
    check(not all(overflow), "every train step overflowed")
    tokens_per_s = TRAIN_BATCH * TRAIN_SEQ / (med / 1e3)
    flops_per_tok = 6 * n_params + 12 * L * cfg.hidden_size * TRAIN_SEQ
    return {
        "params": n_params, "batch": TRAIN_BATCH, "seq": TRAIN_SEQ,
        "step_ms": med, "step_ms_q1_q3": [q1, q3], "steps_timed": TRAIN_STEPS,
        "tokens_per_s": tokens_per_s,
        "mfu": tokens_per_s * flops_per_tok / PEAK_BF16_FLOPS,
        "profiled_step_ms": t_prof,
        "device_busy_ms": busy if busy > 0 else "not measured",
        "device_idle_share": (1 - busy / t_prof) if busy > 0
        else "not measured",
        "device_top_ms": top, "device_ms_by_category": by_cat,
        "device_ms_by_op": by_op,
        "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
        "losses": losses, "loss_scales": scales, "overflow": overflow,
        "counts": counts,
    }


def train_check(dev):
    """3 steps at b4 x s1024 from one state on the kernel path and on the
    plain path (backend="reference"): per-step loss, identical scaler
    decisions, global grad norm within GRAD_NORM_RTOL."""
    from apex_tpu_torch.models.gpt import make_gpt_train_step
    from apex_tpu_torch.optimizers import fused_adam, global_norm

    cfg = _train_cfg()
    tokens, labels = _batch(cfg, CHECK_BATCH, 1, dev)
    runs, state0 = {}, None
    for backend in (None, "reference"):
        norms = []

        def post(grads, norms=norms):
            norms.append(global_norm(grads))
            return grads

        init, step = make_gpt_train_step(cfg, fused_adam(lr=1e-4), "O2",
                                         device=dev, backend=backend,
                                         grad_postprocess=post)
        if state0 is None:
            state0 = init(torch.Generator().manual_seed(0))
        state, seq = state0, []
        for _ in range(CHECK_STEPS):
            state, m = step(state, tokens, labels)
            seq.append((float(m["loss"]), bool(m["overflow"]),
                        float(m["loss_scale"])))
        runs["kernel" if backend is None else "plain"] = (
            seq, [float(x) for x in norms])
        del state
    (ks, kn), (ps, pn) = runs["kernel"], runs["plain"]
    loss_err = max(abs(a[0] - b[0]) for a, b in zip(ks, ps))
    check(loss_err <= TRAIN_LOSS_TOL,
          f"kernel vs plain losses {ks} {ps} differ by {loss_err}")
    check([a[1:] for a in ks] == [b[1:] for b in ps],
          f"scaler decisions differ: kernel {ks} plain {ps}")
    norm_err = max(abs(a - b) / b for a, b, s in zip(kn, pn, ks)
                   if not s[1])
    check(norm_err <= GRAD_NORM_RTOL,
          f"grad norms kernel {kn} plain {pn}: {norm_err} > {GRAD_NORM_RTOL}")
    return {"kernel": ks, "plain": ps, "grad_norm_kernel": kn,
            "grad_norm_plain": pn, "loss_err": loss_err,
            "grad_norm_rel_err": norm_err}


def main() -> int:
    check(torch.cuda.is_available(),
          "no CUDA device: chip_smoke.py runs only on the card")
    dev = torch.device("cuda")
    cap = torch.cuda.get_device_capability(0)
    check(cap == (9, 0), f"compute capability {cap}, need (9, 0) (Hopper)")
    name = torch.cuda.get_device_name(0)
    smi = nvidia_smi()
    print(f"device: {name} x{torch.cuda.device_count()} capability {cap}; "
          f"nvidia-smi: {smi}; torch {torch.__version__} "
          f"cuda {torch.version.cuda}")

    from apex_tpu_torch.ops import _kernel_utils as ku
    from apex_tpu_torch.ops import (  # noqa: F401  (register the kernels)
        decode_step, flash_attention, fused_sampling, layer_norm)

    t0 = time.perf_counter()
    built = ku.build_all()
    print(f"build: {time.perf_counter() - t0:.1f}s wall (one nvcc per "
          f"source, in parallel), compiled now: {built}")

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    results = {}

    def report(kname, r):
        results[kname] = r
        lib = r["library_ms"]
        err = (f"max_rel_err {r['rel_err']:.3g} (tol {r['tol']}, relative "
               f"to max |plain|), max_abs_err {r['err']:.3g}"
               if "rel_err" in r else
               f"max_abs_err {r['err']:.3g} (tol {r['tol']})")
        print(f"{kname}: {r['shape']}: {err} {r['detail']}; kernel "
              f"{r['ms']:.4f} ms, "
              f"plain {r['plain_ms']:.4f} ms, library "
              f"{'none' if lib is None else f'{lib:.4f} ms'}, "
              f"bound {r['bound_ms']:.4f} ms ({r['bound_by']})")

    gen = torch.Generator(device="cuda").manual_seed(0)
    with torch.inference_mode():
        for kname, fn in (("layer_norm_fwd", kernel_layer_norm),
                          ("flash_attention_fwd", kernel_flash),
                          ("fused_decode_layer", kernel_decode),
                          ("fused_sample", kernel_sampler)):
            report(kname, fn(dev, gen))
        sl = slice_phase(dev)
    print(f"serving gpt_125m b=8 prompts {PROMPT_LENS} +{NEW_TOKENS} tokens "
          f"paged bf16 on {smi}: prefill median {sl['prefill_ms']:.2f} ms "
          f"(q1-q3 {sl['prefill_ms_q1_q3']}, {PREFILL_RUNS} runs), generate "
          f"median {sl['generate_ms']:.1f} ms (q1-q3 "
          f"{sl['generate_ms_q1_q3']}, {GENERATE_RUNS} runs), decode "
          f"{sl['decode_ms_per_step']:.3f} ms/step, "
          f"{sl['tokens_per_s']:.1f} tokens/s; profiled generate "
          f"{sl['profiled_generate_ms']:.1f} ms, device busy "
          f"{sl['device_busy_ms']} ms, idle share "
          f"{sl['device_idle_share']}; device ms by category "
          f"{sl['device_ms_by_category']}; top device time "
          f"{sl['device_top_ms']}")

    report("layer_norm_bwd", kernel_layer_norm_bwd(dev, gen))
    for kname, r in kernel_flash_bwd(dev, gen).items():
        report(kname, r)
    torch.cuda.empty_cache()
    tr = train_phase(dev)
    print(f"train gpt_125m AMP-O2 fused_adam(lr=1e-4) b{TRAIN_BATCH} x "
          f"s{TRAIN_SEQ} ({tr['params']} params) on {smi}: step median "
          f"{tr['step_ms']:.2f} ms (q1-q3 {tr['step_ms_q1_q3']}, "
          f"{TRAIN_STEPS} steps), {tr['tokens_per_s']:.1f} tokens/s, MFU "
          f"{tr['mfu']:.4f} of 989 TFLOP/s; profiled step "
          f"{tr['profiled_step_ms']:.1f} ms, device busy "
          f"{tr['device_busy_ms']} ms, idle share {tr['device_idle_share']}"
          f"; peak memory {tr['peak_memory_gb']:.2f} GB; losses "
          f"{tr['losses']}; loss scales {tr['loss_scales']}; overflow "
          f"{tr['overflow']}; device ms by category "
          f"{tr['device_ms_by_category']}; top device time "
          f"{tr['device_top_ms']}; by launching op {tr['device_ms_by_op']}")
    torch.cuda.empty_cache()
    tc = train_check(dev)
    print(f"train kernel vs plain, b{CHECK_BATCH} x s{TRAIN_SEQ}, "
          f"{CHECK_STEPS} steps: (loss, overflow, scale) kernel "
          f"{tc['kernel']} plain {tc['plain']}; max loss diff "
          f"{tc['loss_err']:.5f} (tol {TRAIN_LOSS_TOL}); grad norms kernel "
          f"{tc['grad_norm_kernel']} plain {tc['grad_norm_plain']}, max "
          f"rel diff {tc['grad_norm_rel_err']:.5f} (tol {GRAD_NORM_RTOL})")

    paths = {"serving": sl["counts"], "train_step": tr["counts"]}
    line = {"kernels": [
        {"name": k, "route": "cuda", "source": "apex_tpu_torch/csrc/"
         + ku.KERNELS[k].source, "replaces": ku.KERNELS[k].replaces,
         "launches": sum(c[k] for c in paths.values()),
         "launches_by_path": {p: c[k] for p, c in paths.items()},
         "max_abs_err": r["err"], "max_rel_err": r.get("rel_err"),
         "tol": r["tol"],
         "tol_of": "max_rel_err" if "rel_err" in r else "max_abs_err",
         "ms": r["ms"],
         "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
         "bound_by": r["bound_by"], "library_ms": r["library_ms"]}
        for k, r in results.items()],
        "slice": {k: v for k, v in sl.items() if k != "counts"},
        "train": {k: v for k, v in tr.items() if k != "counts"},
        "train_check": tc}
    print(json.dumps(line))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
