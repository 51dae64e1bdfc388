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
5. Prints one JSON line describing every kernel, then the card's name and
   power limit, then ``{"ok": true, "device": {...}}`` as the last line.

Any failed check raises, so the script exits non-zero and prints no
result line; it never falls back to the CPU.
"""

from __future__ import annotations

import json
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
    want_greedy = {"layer_norm_fwd": (2 * L + 1) * (1 + steps),
                   "flash_attention_fwd": L, "fused_decode_layer": L * steps,
                   "fused_sample": 0}
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
    def wall_ms(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

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
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t_prof = wall_ms(do_generate)
    by_name = {}
    for ev in prof.key_averages():
        dev_us = getattr(ev, "self_device_time_total", 0.0)
        if dev_us > 0:
            by_name[ev.key] = by_name.get(ev.key, 0.0) + dev_us / 1e3
    busy = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
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
        "device_top_ms": {k[:60]: round(v, 3) for k, v in top},
        "counts": counts, "logit_err": logit_err, "token_gap": gap,
        "argmax_agree": agree,
    }


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
    with torch.inference_mode():
        gen = torch.Generator(device="cuda").manual_seed(0)
        for kname, fn in (("layer_norm_fwd", kernel_layer_norm),
                          ("flash_attention_fwd", kernel_flash),
                          ("fused_decode_layer", kernel_decode),
                          ("fused_sample", kernel_sampler)):
            r = fn(dev, gen)
            results[kname] = r
            lib = r["library_ms"]
            print(f"{kname}: {r['shape']}: max_abs_err {r['err']:.3g} "
                  f"(tol {r['tol']}) {r['detail']}; kernel {r['ms']:.4f} ms, "
                  f"plain {r['plain_ms']:.4f} ms, library "
                  f"{'none' if lib is None else f'{lib:.4f} ms'}, "
                  f"bound {r['bound_ms']:.4f} ms ({r['bound_by']})")
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
          f"{sl['device_idle_share']}; top device time {sl['device_top_ms']}")

    line = {"kernels": [
        {"name": k, "route": "cuda", "source": "apex_tpu_torch/csrc/"
         + ku.KERNELS[k].source, "replaces": ku.KERNELS[k].replaces,
         "launches": sl["counts"][k], "max_abs_err": r["err"],
         "tol": r["tol"], "ms": r["ms"], "plain_ms": r["plain_ms"],
         "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
         "library_ms": r["library_ms"]}
        for k, r in results.items()],
        "slice": {k: v for k, v in sl.items() if k != "counts"}}
    print(json.dumps(line))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
