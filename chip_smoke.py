#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``apex_tpu_torch``) on one NVIDIA H100.

    python3 chip_smoke.py

1. Checks the card (CUDA present, compute capability 9.0) and prints its
   name, count and power limit.
2. Builds the port's CUDA kernels from ``apex_tpu_torch/csrc`` (one
   ``nvcc`` per source, all at once) and prints the build time; prints
   the registers, shared memory per CTA, CTAs per SM and spill bytes of
   the Hopper kernels of K2, K6, K7 and row 5 (bf16, fp16; d 32/64/128),
   of rows 9 and 10's tensor-core routes, of row 9's fp32 cluster
   kernel, of row 11's and K1's row kernels and of rows 6 and 7's
   split-key kernel (its four variants at the main paths' plans and the
   wide groups'), K3's projection and row 8's cluster sampler (all six
   instantiations, with the cluster and shared memory its plan gives
   every sampler variant; row 5, rows 6, 7, 8, 9 and 10, row 11 and K1
   must not spill), and checks that each kernel of
   HOPPER_SOURCES holds ``HGMMA`` and ``UTMALDG`` instructions in its
   machine code.
3. Holds each kernel (K1 LayerNorm at the five main paths' shapes, from
   decode's [8, 768] to the GPT step's [16384, 768], plus RMSNorm and
   fp32; K2 flash attention, K3 fused decode layer (bf16 and int8 pools,
   each compute dtype over each other float pool dtype, fp32 and bf16 W,
   MHA, GQA, MQA and 16 and 32 query heads a group at dh 128), K4 fused
   sampler (13 variants: b 1, 8 and 32; V 50304,
   152064 and 262144; fp32 and bf16; top-k and/or top-p or neither;
   token-mask holes, all greedy, flat rows (a nucleus of most of the row);
   0 token mismatches each over
   three key-word pairs, one launch a call; bitwise repeats and a
   CUDA-graph replay with new key words), row 6 ragged paged attention (the same
   groups and pools, and the foreign pool dtypes; rows 6 and 7 also as
   bitwise repeats, a CUDA-graph replay with other lengths, length-0
   lanes as exact zeros), row 9
   ragged grouped matmul (LoRA's fp32 branch),
   row 10 int8-weight matmul on each of its three routes: the decode
   kernel at M=32, the tensor-core GEMM at M=1024 and 4096, the CUDA
   cores at fp32) against its plain PyTorch version at the
   serving paths' shapes, and times kernel, plain version and, where one exists, a
   single PyTorch library call computing the same function, beside the
   least time the card could take (the larger of bytes over 3.35 TB/s
   and operations over the peak rate of their type).
4. Drives the serving path: ``generate`` on GPT-2 125M (random weights
   from a seeded generator, bf16 compute) for 8 ragged requests, greedy
   and sampled, counting every kernel launch; then replays the greedy
   tokens teacher-forced through the kernel path and the plain path
   (``backend="reference"``) and compares their logits; profiles one
   greedy and one sampled ``generate`` (device busy ms, K4's share of the
   sampled one: the greedy one launches no K4).  Then a greedy
   ``generate`` of ``gpt_125m(num_query_groups=1)`` (MQA, 12 query heads
   on one kv group), +16 tokens: K3's launches exact, tokens identical to
   the plain run's or bf16 near-ties.
4b. Drives the paged ``ServingEngine`` at GPT-2 125M's widths and
   ENGINE_LAYERS (6) of its 12 layers (32 lanes, 512 blocks of 16
   tokens) under bench.py's long_prompt_starvation mix, with
   float and ``quantize_params`` weights and native and int8 pools: exact
   launch identities from the engine's decode-step and prefill-call
   counts, TTFT/TPOT, first tokens against the same engine on the plain
   path, teacher-forced kernel-vs-plain logits, a profiled run's device
   idle share, and a 64-block run that must preempt and still finish.
4c. Drives the same engine mix through the compiled ladder
   (``compile_cache_dir=``: every ladder entry a CUDA graph over kernel
   libraries kept in the directory), float + native and quantized + int8:
   tokens, finish reasons and launch counts identical to an eager engine
   on the same requests and generator, tokens/s, idle share and decode
   ms a step of both; a fresh process on the primed directory (every
   entry a hit, no nvcc, first decode-step logits bit for bit the
   parent's) and one on an empty directory (the cold start); the chunked
   engine (``chunk_tokens=256``: greedy tokens equal the unchunked
   engine's or are bf16 near-ties, short-request TPOT p95 beside the
   unchunked); a masked run (``token_masks=True``: every token allowed,
   a single-token request emits only it, K4 counted).
4d. Drives multi-tenant LoRA serving on the same engine geometry, at
   GPT-2 125M's widths and 2 of its layers (LORA_LAYERS): 64 rank-8
   adapters through a 24-slot AdapterPool, 64 requests of mixed tenants
   (every 8th on the base model, 8 sampled), on float weights with a
   bf16 pool and on ``quantize_params`` weights with an int8 pool: exact
   launch identities (row 9 at 8 a layer per decode step and adapter
   prefill), a clean block ledger and adapter pool, LRU churn, first
   tokens against the plain engine, teacher-forced kernel-vs-plain
   logits; beside it a merged single-adapter engine on the same requests,
   a profiled run's idle share, and at fp32 (2 layers, full width) each
   tenant's stream against its merged-weights ``generate``.
4e. Drives speculative ``generate`` (``spec=SpecConfig(k=8)``) on GPT-2
   125M at bench_spec_ablation's geometry (b8, prompt 64, +128, paged):
   repetition prompts greedy and random prompts at temperature 1; exact
   launches (K1 2L+1 a round, no paged kernel), greedy tokens equal to
   spec-off greedy on the kernel path (or a near-tie at the first
   difference), accept rate, tokens per verify, decode tokens/s spec
   against off.
4f. Drives the speculative engine (``spec``, k 8) on the engine mix,
   float + native and quantized + int8, eager against the graph engine
   (the round as the captured ``decode`` entry): identical tokens,
   finish reasons, launches and spec counters; a clean ledger; profiled
   eager and graph runs (the verify gathers' device time).
4g. Drives the host-DRAM tier on the starved pool (raw wire, float +
   native, greedy): resumes by page-in, no replay, tokens equal to an
   unstarved engine's bit for bit; page-in ms against the replay's
   prefill ms; the shared-system-prompt trace's digest hits.
4h. Drives fp32 compute over a bf16 pool (``cache_dtype``): ``generate``
   (K3 over the foreign pool, teacher-forced logits kernel vs plain) and
   the engine (K3 every step, tokens against the plain engine).
4i. Drives the cluster tier (``cluster_phase``) on GPT-2 125M at 12
   layers, bf16, paged blocks of 16: a prefill and a decode worker as
   separate processes (``spawn_worker_async``, ``--device cuda``) behind a
   ``Router`` on the raw wire, warmed by two requests, then bench.py's
   bursty open-loop trace of 24 greedy requests (prompts 17-512, +32) on
   them and on one in-process engine from the same seed: tokens equal
   for every request, TTFT and e2e p50/p95 per class, tokens/s, handoff
   bytes, requeues, the decode worker's ``serving_kv_injected_total``
   (scraped from its ``/metrics``), the router's ``/healthz``; 4 sampled
   requests (K4 in both workers); the workers' launch counts from their
   ``stats`` replies (K1, K2, K4 in the prefill worker; K1, K3, K4 in
   the decode worker); the int8 and bf16 wires (first divergence, bytes);
   a mid-flight drain between two decode ``WorkerServer``s in threads on
   the card (migrated tokens equal the undrained run's); a decode worker
   on a compiled-ladder directory this run primed (READY ms).
5. Holds the backward kernels (K5 LayerNorm backward, K6 flash dq, K7
   flash dK/dV) against autograd of their plain forward at the train
   step's shapes, timed like the others; row 5 (the short-key one-pass
   flash backward, one thread-block cluster per batch row and K/V group)
   against its plain version at BERT-large's shape (b8 s512 n16 d64,
   ragged key padding, one fully masked batch row; also causal and GQA)
   and at the GPT-MoE steps' (b8 s512 n12 d64 causal), beside K6 + K7 on
   the same inputs and SDPA's backward, one launch a call, bitwise equal
   repeats, and the row 5 versus K6 + K7 crossover from 256 to 1024 keys;
   row 11 (the scaled masked softmax) at BERT's fused_softmax
   scores [8, 16, 512, 512] fp32 with a [8, 1, 1, 512] mask (also bf16,
   causal, a full-shape mask), and the torch backward composition around
   it; K2 at BERT's forward shape and at the GPT
   step's (b16 s1024 n12 d64 causal, beside SDPA's forward) as variants;
   K6 + K7 also timed as one pair, the backward function, with its own
   bound; K2 and row 5 at head size 80 (b8 s512 n32 causal bf16, beside
   SDPA), and K2 at head size 78 on its zero-padded copy.
5b. Holds the multi-tensor kernels M1-M4 (``csrc/multi_tensor.cu``: the
   unscale/axpby, the L2 norms, Adam, LAMB's two stages) against their
   plain versions at the fp32 master trees of the three train steps
   (GPT-2 125M, BERT-large, GPT-MoE, from each step's init; seeded
   gradients and moments): within 1e-6 of each tensor's largest plain
   value, bitwise over a repeat, one launch a call (the trees hold fewer
   than 320 leaves, one kernel table), timed beside the byte bound and
   the library calls (``torch._amp_foreach_non_finite_check_and_unscale_``,
   ``torch._foreach_norm``, ``torch._fused_adamw_``); an inf planted in
   one gradient sets the flag, halves the scale and keeps every master,
   moment and model copy bit for bit.  A list of 700 tensors takes three
   launches a call of each (one a table of 320) and still matches.
6. Drives the training path: the GPT-2 125M AMP-O2 train step
   (``make_gpt_train_step``, ``fused_adam(lr=1e-4)``, fused head+CE) at
   b16 x s1024 on random tokens, counting every kernel launch of one
   step (the tail: M1 and M3 once each); step time, tokens/s, MFU and the
   device idle share of one profiled step; the device ms of the
   ``amp.unscale`` and ``amp.optimizer_tail`` spans, and of the same step
   with the plain tail (``make_train_step(backend="reference")``); then 3
   steps at b4 x s1024 on the kernel path and on the plain path from one
   state with ``norm_telemetry=True`` (loss, scaler decisions, grad norm,
   the grad/update/param norms), and 3 steps with ``accum_steps=4`` (4 x
   b4) against ``accum_steps=1`` at b16 (losses, scaler decisions).
6b. Drives the BERT-large AMP-O2 pretrain step (``make_bert_train_step``,
   ``fused_lamb(lr=1e-4, weight_decay=0.01)``, h=1024, at BERT_LAYERS
   (12) of its 24 layers) at b8 x s512 on a seeded batch with ragged
   padding and MLM/NSP labels, under both attention backends: exact
   launch counts per step (flash: K1 and K5 2L+3 each, K2 L, row 5 L;
   fused_softmax: K1 and K5 2L+3, row 11 L; both: M1, M2 and M4 once),
   step time, tokens/s, MFU, idle share, peak memory (fused_softmax:
   also row 11's forward and the softmax backward composition's device
   ms in one step); then 3 kernel-vs-plain steps at b4 from one state.
6c. Drives the GPT-MoE AMP-O2 train step of bench.py's bench_gpt_moe (12
   layers, h=768, 8 experts, 520M parameters, ``fused_adam(lr=1e-4)``) at
   b8 x s512 on seeded tokens under ``moe_routing="capacity"`` (the bench
   as configured; no grouped matmul) and ``"ragged"`` (row 9's 16-bit
   branch: 24 forward and 24 transposed dx launches per step; M1 and M3
   once): exact launch counts, step time, tokens/s, MFU over the active parameters,
   device time, peak memory, each layer's expert load, aux loss and
   dropped fraction; then 3 kernel-vs-plain steps at b4 in lockstep, with
   every routing difference between the paths checked to be a near-tie.
   Then ``quantize_params`` of the ragged model and a teacher-forced
   ``gpt_forward`` on the same batch: row 9's int8 branch at the 24
   expert sites and row 10 at the 24 dense ones, kernel vs plain logits,
   the loss against the float forward.  Row 9's 16-bit, transposed and
   int8 branches are then held against the plain version at that step's
   shapes and expert loads (and adversarial offsets), timed beside their
   bounds and ``torch._grouped_mm``; ``_grouped_dw`` is timed per call.
   The ragged step with hidden and attention dropout 0.1: exact launches,
   step ms, and 3 kernel-vs-plain steps at b4 in lockstep.
6d. A [b, 1, s, s] attention mask through ``gpt_forward`` (GPT-2 widths,
   2 layers): the materialized-score path, row 11 once per layer.
6e. Single-device training, complete (``training_slice``): the GPT-2
   350M AMP-O2 step (24 layers, h1024, b8 x s1024, fused head) with and
   without remat from one state, 3 steps bitwise equal (losses, masters,
   moments), exact launches of each (remat: K1 4L+1, K2 2L), median step
   ms, peak memory and a profiled step of each, the remat step against
   the plain path; the long-context row (GPT-2 125M, b2 x s8192, remat):
   two steps' ms and peak memory; O4 and O1 at GPT-2 125M's widths, 4
   layers, b16: launches, kernel vs plain, and an O1 step forced to
   overflow keeping every master bit for bit; ``memory_efficient``
   LayerNorm (K1 + the rebuild + K5) at [16384, 768] and [8192, 1024]
   against the default mode, the rebuild's ms beside K5's, the bytes it
   frees; a swiglu GPT step (4 layers) kernel vs plain, a ragged swiglu
   MoE step (2 layers at bench_gpt_moe's widths: row 9 on the 2f-wide
   fc1, no dropped token) and row 9 at the 2f fc1 against its plain
   version; and the 350M state saved by ``AsyncCheckpointer`` while a
   step runs, restored into a fresh state and stepped on bit for bit
   with the unkilled run.  BERT-large (flash) and the ragged GPT-MoE at
   2 layers, one step each with and without remat: bitwise, K1 +2L and
   K2 twice in the recompute.
7. Prints one JSON line describing every kernel, then the card's name and
   power limit, then ``{"ok": true, "device": {...}}`` as the last line.

Any failed check raises, so the script exits non-zero and prints no
result line; it never falls back to the CPU.

    python3 chip_smoke.py --matmul-times ROOT

times only rows 5, 6, 7 (K3), 8 (K4), 9, 10 and 11, K1 and K2 at head
size 64 of the port under ROOT
(a ``git archive`` of another commit, say) at the main paths' shapes and
prints one JSON line, so that two commits compare in one chip call
(parent, change, change, parent).

    python3 chip_smoke.py --serving-times ROOT

times the eager serving paths of the port under ROOT (another commit's
``git archive``, say): the eager ``ServingEngine`` on the engine mix
(float + native pool, quantized + int8 pool) and a greedy paged
``generate``, with one JSON line, so that two commits compare in one
chip call (parent, change, change, parent).

    python3 chip_smoke.py --train-times ROOT

times the GPT-2 125M, BERT-large flash and GPT-MoE ragged train steps of
the port under ROOT (another commit's ``git archive``, say), with one
JSON line, so that two commits compare in one chip call (parent, change,
change, parent).

    python3 chip_smoke.py --paged-probe

times rows 6 and 7 under forced split counts and uniform lengths (one
JSON line): where their time goes.

    python3 chip_smoke.py --cluster

runs only the cluster phase (4i) and the BERT and MoE remat check after
the kernels' build, with one JSON line.
"""

from __future__ import annotations

import dataclasses
import functools
import gc
import json
import math
import subprocess
import sys
import time
from pathlib import Path

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

# the optimizer tail of one AMP step, whatever the leaf count: the
# unscale (M1) and Adam (M3), or the unscale, LAMB's clip norm (M2) and
# LAMB's two stages (M4)
ADAM_TAIL = {"multi_tensor_scale": 1, "multi_tensor_adam": 1}
LAMB_TAIL = {"multi_tensor_scale": 1, "multi_tensor_l2norm": 1,
             "multi_tensor_lamb": 1}

# BERT-large pretraining at phase 2's length (bench.py:2135-2178)
BERT_BATCH, BERT_SEQ = 8, 512
BERT_LAYERS = 12                # of BERT-large's 24 (see ENGINE_LAYERS)
BERT_BACKENDS = ("flash", "fused_softmax")
# fp32 softmax against its plain version; bf16 results round once from
# fp32 on both sides, so they may differ by one bf16 step at 1
SOFTMAX_TOL = {torch.float32: 1e-6, torch.bfloat16: 2.0 ** -8}


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


def _hand_written_names():
    """The ``__global__`` functions of apex_tpu_torch/csrc."""
    import re

    names = set()
    for src in (Path(__file__).resolve().parent / "apex_tpu_torch"
                / "csrc").glob("*.cu*"):
        names.update(re.findall(
            r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s+)?(\w+)",
            src.read_text()))
    return names


_HAND_WRITTEN = None


def _category(kernel: str) -> str:
    global _HAND_WRITTEN
    if _HAND_WRITTEN is None:
        _HAND_WRITTEN = _hand_written_names()
    # ours live in anonymous namespaces (the shared GEMM in gemm::, the
    # multi-tensor kernels in mt::), as do some of PyTorch's own
    # (indexing_backward_kernel): match the function's name within one of
    # those namespaces
    for ns in ("(anonymous namespace)::", "gemm::", "mt::"):
        tail = kernel.split(ns, 1)
        if (len(tail) == 2
                and tail[1].split("<")[0].split("(")[0] in _HAND_WRITTEN):
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
    t, by_name, by_cat, by_op = _profile(fn)

    def top(d):
        return {k: round(v, 3)
                for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:12]}

    return (t, sum(by_name.values()), top(by_name),
            {k: round(v, 3) for k, v in by_cat.items()}, top(by_op))


def _profile(fn):
    """(wall ms, device ms by kernel name (60 characters), by category,
    by launching CPU op) of one ``fn()`` under torch.profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = wall_ms(fn)
    by_name, by_cat, by_op = {}, {}, {}
    for ev in prof.key_averages():
        # a record_function span's range on the device is no kernel
        if not ev.self_device_time_total or ev.key in SPAN_NAMES:
            continue
        ms = ev.self_device_time_total / 1e3
        if ev.device_type != DeviceType.CUDA:
            by_op[ev.key] = by_op.get(ev.key, 0.0) + ms
            continue
        by_name[ev.key[:60]] = by_name.get(ev.key[:60], 0.0) + ms
        cat = _category(ev.key)
        by_cat[cat] = by_cat.get(cat, 0.0) + ms
    return t, by_name, by_cat, by_op


def profile_spans(fn, kernels, ops):
    """Device ms of parts of one ``fn()`` under torch.profiler: for each
    ``kernels`` label, the summed time of the device kernels whose name
    holds its needle; for each ``ops`` label, the device time of the CPU
    op whose name ends with its needle, its children's kernels included
    (the autograd engine's ``evaluate_function: <Node>`` wraps the node's
    own event, so the larger of the two is the node's)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    out = dict.fromkeys([*kernels, *ops], 0.0)
    for ev in prof.key_averages():
        on_device = ev.device_type == DeviceType.CUDA
        for label, needle in kernels.items():
            if on_device and needle in ev.key:
                out[label] += ev.self_device_time_total / 1e3
        for label, needle in ops.items():
            if not on_device and ev.key.endswith(needle):
                out[label] = max(out[label], ev.device_time_total / 1e3)
    return {k: (v if v > 0 else "not measured") for k, v in out.items()}


# the AMP step's record_function spans (amp/frontend.py)
TAIL_SPANS = {"unscale_device_ms": "amp.unscale",
              "tail_device_ms": "amp.optimizer_tail"}
SPAN_NAMES = frozenset(TAIL_SPANS.values())


def profile_tail(fn):
    """Device ms of one ``fn()``'s AMP unscale and optimizer tail: the
    kernels whose device time lies inside each span's range on the device
    (the profiler's device-side range of a ``record_function``), summed,
    and the range's own length (``*_span_ms``: from its first kernel's
    start to its last one's end, the device's waits for the host
    included)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    evs = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    kernels = [e for e in evs if e.name not in SPAN_NAMES]
    out = {}
    for label, name in TAIL_SPANS.items():
        spans = [(e.time_range.start, e.time_range.end) for e in evs
                 if e.name == name]
        span_label = label.replace("device_ms", "span_ms")
        if not spans:
            out[label] = out[span_label] = "not measured"
            continue
        out[label] = sum(
            (k.time_range.end - k.time_range.start) / 1e3 for k in kernels
            if any(a <= k.time_range.start and k.time_range.end <= b
                   for a, b in spans))
        out[span_label] = sum(b - a for a, b in spans) / 1e3
    return out


# K1 at every main path's shape (PERF.md §6 launches): generate's decode,
# the engine and LoRA engine's decode, the MoE steps / quantized MoE
# forward / prefill, the GPT-2 125M O2 step (b16 x s1024), BERT-large
LN_SHAPES = (("generate decode", 8, 768), ("engine decode", 32, 768),
             ("moe step, prefill", 4096, 768), ("gpt step", 16384, 768),
             ("bert step", 4096, 1024))
LN_MAIN = "moe step, prefill"
# K1's tolerances (tests/test_torch_kernels.py): y within tol + tol * |plain|
# (one bf16 step is 2**-5 at |y| in [4, 8), which the larger shapes
# reach), mu and rstd within 1e-5 + 1e-5 * |plain|; the main row
# ([4096, 768] bf16) keeps its absolute 2e-2 besides
LN_TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
LN_STATS_TOL = 1e-5


def _ln_case(dev, gen, rows, h, dtype, rms):
    """K1 on one [rows, h] input against its plain version (y, mu and
    rstd), timed beside the plain version, one PyTorch call
    (``F.layer_norm``, ``F.rms_norm``; 16-bit inputs with 16-bit γ/β, as
    the library takes them) and the bound."""
    from apex_tpu_torch.ops import layer_norm as tln

    w = torch.randn(h, device=dev, generator=gen)
    b = None if rms else torch.randn(h, device=dev, generator=gen)
    x = (torch.randn(rows, h, device=dev, generator=gen) * 2).to(dtype)
    got = tln.layer_norm_fwd_stats(x, w, b, rms=rms)
    want = tln.layer_norm_fwd_stats(x, w, b, rms=rms, backend="reference")
    err = max_err(got[0], want[0])
    rel_err, stats_err = (
        float(((g.float() - r.float()).abs() / (1 + r.float().abs())).max())
        for g, r in ((got[0], want[0]), (torch.cat(got[1:]),
                                         torch.cat(want[1:]))))
    check(rel_err <= LN_TOL[dtype] and stats_err <= LN_STATS_TOL,
          f"K1 [{rows}, {h}] {dtype} rms={rms}: y error {err} ({rel_err} "
          f"of 1 + |plain|), mu/rstd error {stats_err}")
    if rms:
        def kern():
            return tln.fused_rms_norm(x, w)

        def plain():
            return tln.fused_rms_norm(x, w, backend="reference")
        wl = w.to(dtype)

        def lib():
            return F.rms_norm(x, (h,), wl, eps=1e-5)
    else:
        def kern():
            return tln.fused_layer_norm(x, w, b)

        def plain():
            return tln.fused_layer_norm(x, w, b, backend="reference")
        wl, bl = w.to(dtype), b.to(dtype)

        def lib():
            return F.layer_norm(x, (h,), wl, bl)
    nbytes = (rows * h * x.element_size() * 2 + (1 if rms else 2) * h * 4
              + rows * 8)
    bms, by = bound(nbytes, rows * h * 8, PEAK_FP32_FLOPS)
    plan = tln.ln_plan(rows, h, x.element_size(), True,
                       torch.cuda.get_device_properties(dev)
                       .multi_processor_count)
    return {"err": err, "err_of_1_plus_plain": rel_err,
            "stats_err": stats_err, "tol": LN_TOL[dtype],
            "ms": time_ms(kern), "plain_ms": time_ms(plain),
            "library_ms": time_ms(lib), "bound_ms": bms, "bound_by": by,
            "plan": plan._asdict()}


def kernel_layer_norm(dev, gen):
    """K1 against its plain version at the five main paths' shapes, bf16 x
    with fp32 γ/β (LN_SHAPES; the MoE/prefill shape [4096, 768] is the
    main row, the others its variants), and RMSNorm and fp32 x at [4096,
    768] once for the record."""
    cases = {f"[{rows}, {h}] bf16 ({name})": (rows, h, torch.bfloat16,
                                              False)
             for name, rows, h in LN_SHAPES}
    cases["[4096, 768] bf16 RMSNorm"] = (4096, 768, torch.bfloat16, True)
    cases["[4096, 768] fp32"] = (4096, 768, torch.float32, False)
    runs = {name: _ln_case(dev, gen, *c) for name, c in cases.items()}
    main_name = next(n for n in runs if LN_MAIN in n)
    main = runs.pop(main_name)
    check(main["err"] <= LN_TOL[torch.bfloat16],
          f"K1 {main_name}: y error {main['err']}")
    detail = {n: (r["err"], r["err_of_1_plus_plain"], r["stats_err"],
                  r["tol"])
              for n, r in [(main_name, main), *runs.items()]}
    return dict(main, detail=detail, variants=runs,
                shape=f"{main_name} (also the other main-path shapes, "
                      "RMSNorm and fp32 as variants; y within tol of 1 + "
                      f"|plain| (the main row also absolutely), mu/rstd "
                      f"within {LN_STATS_TOL} of 1 + |plain|)")


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
    bert = kernel_flash_bert_shape(dev, gen)
    errs.update(bert.pop("errs"))
    gpt = kernel_flash_gpt_shape(dev, gen)
    errs.update(gpt.pop("errs"))
    check(max(errs.values()) <= tol, f"K2 error {errs}")
    return {
        "variants": {"bert b8 s512 n16 d64 non-causal, ragged padding":
                     bert,
                     f"gpt step b{TRAIN_BATCH} s{TRAIN_SEQ} n12 d64 causal":
                     gpt},
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


def bert_lens(b, s, gen):
    """BERT batch rows' valid lengths: drawn from 3/4 s .. s, row 0 full."""
    lens = torch.randint(s * 3 // 4, s + 1, (b,), generator=gen)
    lens[0] = s
    return lens


def kernel_flash_bert_shape(dev, gen):
    """K2 at BERT-large's forward shape: b8 s512 n16 d64 bf16,
    non-causal, ragged key padding with one fully masked batch row."""
    from apex_tpu_torch.ops import flash_attention as tfa

    b, s, n, d = BERT_BATCH, BERT_SEQ, 16, 64
    lens = bert_lens(b, s, torch.Generator().manual_seed(3)).to(dev)
    lens[-1] = 0
    kpm = torch.arange(s, device=dev)[None] >= lens[:, None]
    q, k, v = (torch.randn(b, s, n, d, device=dev, generator=gen).bfloat16()
               for _ in range(3))
    got = tfa.flash_attention(q, k, v, key_padding_mask=kpm)
    want = tfa.flash_attention(q, k, v, key_padding_mask=kpm,
                               backend="reference")
    err = max_err(got, want)
    pairs = int(lens.sum()) * s * n
    nbytes = 4 * b * s * n * d * 2 + b * s * 4 + b * n * s * 4
    bms, by = bound(nbytes, 4 * d * pairs, PEAK_BF16_FLOPS)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    add = torch.where(kpm, -1e30, 0.0).bfloat16()[:, None, None, :]
    return {
        "errs": {"bert non-causal+pad": err},
        "ms": time_ms(lambda: tfa.flash_attention(q, k, v,
                                                  key_padding_mask=kpm)),
        "plain_ms": time_ms(lambda: tfa.flash_attention(
            q, k, v, key_padding_mask=kpm, backend="reference"), iters=4),
        "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=add)),
        "bound_ms": bms, "bound_by": by,
    }


def kernel_flash_gpt_shape(dev, gen):
    """K2 at the GPT O2 step's forward shape: b16 s1024 n12 d64 bf16
    causal, no padding (12 launches a step), beside SDPA's forward."""
    from apex_tpu_torch.ops import flash_attention as tfa

    b, s, n, d = TRAIN_BATCH, TRAIN_SEQ, 12, 64
    q, k, v = (torch.randn(b, s, n, d, device=dev, generator=gen).bfloat16()
               for _ in range(3))
    got = tfa.flash_attention(q, k, v, causal=True)
    want = tfa.flash_attention(q, k, v, causal=True, backend="reference")
    err = max_err(got, want)
    del want
    pairs = n * b * s * (s + 1) // 2
    nbytes = 4 * b * s * n * d * 2 + b * n * s * 4
    bms, by = bound(nbytes, 4 * d * pairs, PEAK_BF16_FLOPS)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    return {
        "errs": {"gpt step causal": err},
        "ms": time_ms(lambda: tfa.flash_attention(q, k, v, causal=True)),
        "plain_ms": time_ms(lambda: tfa.flash_attention(
            q, k, v, causal=True, backend="reference"), iters=2, reps=2),
        "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True)),
        "bound_ms": bms, "bound_by": by,
    }


# csrc sources of the Hopper kernels and how many instantiations each
# holds, each in bf16 and fp16: K2, K6/K7 and row 5 at 3 head sizes,
# without and with segment ids or dropout; row 9's
# GEMM (forward and transposed read at 128 and 256 columns, the int8
# slab at stages of 64 and 32 k rows and at 64 columns); row 10's (the
# same three int8 GEMMs, the decode kernel at n = 16, 32, 64 x chunks of
# 128 or 32 k rows)
# local memory a thread (the runtime's localSizeBytes) that the flash
# extras instantiations and the wide-head kernels may not pass: these
# sources build to 0-184 and 0-32 bytes (nvcc 12.8), so growth past that
# shows
EXTRAS_SPILL_MAX = 192
WIDE_SPILL_MAX = 64
HOPPER_SOURCES = {"flash_attention.cu": 12, "flash_attention_bwd.cu": 24,
                  "flash_attention_bwd_short.cu": 12,
                  "grouped_matmul.cu": 14, "dense_int8.cu": 18}


def hopper_kernels():
    """The Hopper kernels as built and as the CUDA runtime sees them:
    registers, shared memory per CTA, CTAs per SM and spill bytes of each
    (bf16 and fp16; K2, K6, K7 and row 5 at d 32/64/128; the wide-head
    kernels of rows 3, 4a and 4b in fp32, bf16 and fp16; rows 9 and 10's
    tensor-core routes and row 9's fp32 cluster kernel; row 11's one-read
    and looped kernels and K1's register and scalar kernels, fp32 and
    bf16; rows 6 and 7's split-key kernel at PAGED_PLANS and K3's
    projection), and the HGMMA (wgmma) and UTMALDG (TMA load) instructions
    in the machine code of each kernel of HOPPER_SOURCES, which must both
    be there.  K2, K6, K7 and row 5 (their instantiations without segment
    ids or dropout), rows 6, 7, 9 and 10, row 11 and K1 must not spill;
    the flash extras stay within EXTRAS_SPILL_MAX local bytes a thread and
    the wide-head kernels within WIDE_SPILL_MAX."""
    import re

    from apex_tpu_torch.ops import _kernel_utils as ku
    from apex_tpu_torch.ops import dense as td
    from apex_tpu_torch.ops import flash_attention as tfa
    from apex_tpu_torch.ops import grouped_matmul as tgm

    attrs = {f"{str(dt)[6:]} d{d}{' extras' if ext else ''}":
             tfa.hopper_attributes(dt, d, ext)
             for dt in (torch.bfloat16, torch.float16)
             for d in (32, 64, 128) for ext in (False, True)}
    # K2, K6, K7 and row 5 without segment ids or dropout (the
    # dropout-free main paths') must not spill; the extras instantiations
    # (the dropout steps' and packed rows') and the wide-head kernels are
    # held under a ceiling of local memory a thread
    plain = {f"{k} {name}": a for k, kern in attrs.items()
             if not k.endswith("extras") for name, a in kern.items()}
    check(all(a["spill_bytes"] == 0 for a in plain.values()),
          f"a flash kernel without extras spills: {plain}")
    extras = {f"{k} {name}": a["spill_bytes"] for k, kern in attrs.items()
              if k.endswith("extras") for name, a in kern.items()}
    check(max(extras.values()) <= EXTRAS_SPILL_MAX,
          f"flash extras above {EXTRAS_SPILL_MAX} local bytes: {extras}")
    attrs["wide heads"] = {str(dt)[6:]: tfa.wide_attributes(dt)
                           for dt in (torch.float32, torch.bfloat16,
                                      torch.float16)}
    wide = {f"{k} {name}": a["spill_bytes"]
            for k, kern in attrs["wide heads"].items()
            for name, a in kern.items()}
    check(max(wide.values()) <= WIDE_SPILL_MAX,
          f"wide-head kernels above {WIDE_SPILL_MAX} local bytes: {wide}")
    for dt in (torch.bfloat16, torch.float16):
        rows = {**tgm.hopper_attributes(dt), **td.hopper_attributes(dt)}
        check(all(a["spill_bytes"] == 0 for a in rows.values()),
              f"rows 9 and 10 spill: {rows}")
        attrs[f"{str(dt)[6:]} rows 9, 10"] = rows
    # row 11 and K1: no wgmma or TMA (so not in HOPPER_SOURCES), no spills
    from apex_tpu_torch.ops import layer_norm as tln
    from apex_tpu_torch.ops import softmax as tsm

    row_kernels = {
        **{f"row 11 {str(dt)[6:]}": tsm.kernel_attributes(dt)
           for dt in (torch.float32, torch.bfloat16)},
        "K1 bfloat16": tln.kernel_attributes(torch.bfloat16, (3, 4, 8)),
        "K1 float32": tln.kernel_attributes(torch.float32, (6, 8))}
    check(all(a["spill_bytes"] == 0 for k in row_kernels.values()
              for a in k.values()), f"row 11 or K1 spills: {row_kernels}")
    attrs.update(row_kernels)
    # rows 6 and 7 (K3): no wgmma or TMA either; the split-key kernel's
    # variants at the plans of the main paths' shapes and the wide groups,
    # every compute dtype over every pool dtype, and K3's projection
    paged = paged_kernel_attributes()
    check(all(a["spill_bytes"] == 0 for a in paged.values()),
          f"row 6 or K3 spills: {paged}")
    attrs["rows 6, 7"] = paged
    # row 8 (K4): no wgmma or TMA either; every instantiation, no spills,
    # and the cluster and dynamic shared memory the plan gives each shape
    from apex_tpu_torch.ops import fused_sampling as tfs

    k4 = tfs.kernel_attributes()
    check(all(a["spill_bytes"] == 0 for a in k4.values()),
          f"K4 spills: {k4}")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    k4["plans (cluster, dynamic smem bytes)"] = {
        name: [p.cluster, p.smem] for name, p in (
            (name, tfs.sample_plan(b, V, torch.empty((), dtype=dt)
                                   .element_size(), top_k or 0,
                                   top_p is not None, sms))
            for name, (b, V, dt, top_k, top_p, _) in
            SAMPLER_VARIANTS.items())}
    attrs["row 8 (K4)"] = k4
    # M1-M4 (csrc/multi_tensor.cu): CUDA-core streaming kernels, no spills
    from apex_tpu_torch.multi_tensor import multi_tensor_apply as mta

    mt = mta.kernel_attributes()
    check(all(a["spill_bytes"] == 0 for a in mt.values()),
          f"a multi-tensor kernel spills: {mt}")
    attrs["M1-M4 (multi-tensor)"] = mt
    sass = {}
    for src, n in HOPPER_SOURCES.items():
        counts = {k: c
                  for k, c in ku.sass_counts(ku.lib_path(src)).items()
                  if "sm90_kernel" in k}
        found = {}
        for k, name in ku.demangle(sorted(counts)).items():
            m = re.search(r"(\w+_sm90_kernel<[^>]*>)", name)
            found[f"{src}: {m.group(1) if m else name}"] = counts[k]
        check(len(found) == n, f"expected {n} Hopper kernels in {src}, "
              f"found {sorted(found)}")
        sass.update(found)
    check(all(c["HGMMA"] > 0 and c["UTMALDG"] > 0 for c in sass.values()),
          f"a Hopper kernel without wgmma or TMA loads: {sass}")
    return attrs, sass


def _mapped_tokens(tables, nb, bs):
    """Tokens each lane's table maps (entries below nb), [b] on the card."""
    return (tables < nb).sum(1) * bs


def repeat_and_replay(call, lens, mapped, what):
    """Five more calls give the first call's bits (the rank-order combine),
    and the call captured in a CUDA graph, replayed after other lengths
    are written into the captured lengths tensor, equals an eager call on
    those lengths: the launch grid follows the tables' reach, not the
    lengths.  The lengths are put back after."""
    first = call()
    for _ in range(5):
        check(torch.equal(call(), first), f"{what}: a repeat differs")
    saved = lens.clone()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = call()
    new = (saved.long() * 7 + 13) % (mapped.long() + 1)
    lens.copy_(torch.where(saved > 0, new, 0).to(lens.dtype))
    graph.replay()
    eager = call()
    torch.cuda.synchronize()
    check(torch.equal(captured, eager),
          f"{what}: a graph replay with other lengths differs from an eager "
          "call")
    check(not torch.equal(captured, first), f"{what}: the replay ignored "
          "the new lengths")
    lens.copy_(saved)
    del graph
    return True


# K3 at generate's decode shape (b8, lengths 17-576, 36 blocks of 16 a
# lane): MHA with learned positions is the main row; rope, GQA g=4, an int8
# pool and a bf16 W beside it; the wide groups the split-key kernel takes
# (MQA on gpt_125m's 12 heads, 16 and 32 query heads a group at dh 128)
# with bf16 and int8 pools, and in those variants a 9th lane of length 0
# whose table holds only sentinels.  (name, nh, g, dh, rope, int8 pool,
# W dtype, empty lane)
DECODE_LENS = [17, 64, 128, 200, 256, 333, 400, 576]
DECODE_VARIANTS = (
    ("mha learned", 12, 12, 64, False, False, torch.float32, False),
    ("mha rope", 12, 12, 64, True, False, torch.float32, False),
    ("gqa g=4 rope", 12, 4, 64, True, False, torch.float32, False),
    ("int8 pool", 12, 12, 64, False, True, torch.float32, False),
    ("bf16 W", 12, 12, 64, False, False, torch.bfloat16, False),
    ("mqa rope", 12, 1, 64, True, False, torch.float32, True),
    ("mqa rope, int8 pool", 12, 1, 64, True, True, torch.float32, True),
    ("mqa rope, bf16 W", 12, 1, 64, True, False, torch.bfloat16, True),
    ("rep 16 dh 128", 16, 1, 128, True, False, torch.float32, True),
    ("rep 16 dh 128, int8 pool", 16, 1, 128, True, True, torch.bfloat16,
     True),
    ("rep 32 dh 128", 32, 1, 128, True, False, torch.float32, True),
    ("rep 32 dh 128, int8 pool", 32, 1, 128, True, True, torch.float32,
     True))
DECODE_TOL = 2e-2                # bf16 compute
# rows 6 and 7 over a pool whose dtype differs from the compute dtype (an
# engine's or generate's cache_dtype): every (q dtype, pool dtype) pair of
# two different float dtypes, at the MHA main rows' shapes
FLOATS = (torch.float32, torch.bfloat16, torch.float16)
FOREIGN_POOLS = tuple((qd, pd) for qd in FLOATS for pd in FLOATS
                      if qd != pd)


def _dt(d: torch.dtype) -> str:
    return str(d)[6:]


def _decode_inputs(dev, gen, nh, g, dh, rope, quant, w_dtype, empty,
                   bs=16, mb=36, h_out=768, q_dtype=torch.bfloat16,
                   pool_dtype=torch.bfloat16):
    from apex_tpu_torch.serving.paged_cache import quantize_kv

    lens_l = DECODE_LENS + ([0] if empty else [])
    b = len(lens_l)
    lens = torch.tensor(lens_l, device=dev, dtype=torch.int32)
    nb = b * mb + 7
    tables = torch.randperm(nb, device=dev, generator=gen)[:b * mb]
    tables = tables.view(b, mb).to(torch.int32)
    for i, n in enumerate(lens_l):
        tables[i, -(-n // bs):] = nb + 1 + i              # sentinel tails
    q = torch.randn(b, nh, dh, device=dev, generator=gen).to(q_dtype)
    kp = torch.randn(nb, bs, g, dh, device=dev, generator=gen)
    vp = torch.randn(nb, bs, g, dh, device=dev, generator=gen)
    sc = {}
    if quant:
        kp, ks = quantize_kv(kp)
        vp, vs = quantize_kv(vp)
        sc = dict(k_scale=ks, v_scale=vs)
    else:
        kp, vp = kp.to(pool_dtype), vp.to(pool_dtype)
    w = (torch.randn(nh * dh, h_out, device=dev, generator=gen)
         * 0.02).to(w_dtype)
    if rope:
        ang = torch.rand(b, dh // 2, device=dev, generator=gen) * 6
        ang = torch.cat([ang, ang], -1)
        sc.update(rope_cos=ang.cos(), rope_sin=ang.sin())
    return (q, kp, vp, tables, lens, w), sc


# (b, nh, g, dh, reach) of the plans whose kernels the Hopper line reports:
# the engine's and generate's decode (MHA), MHA at dh 128, GQA rep 3 and
# rep 4 at dh 128, MQA, 16 and 32 query heads a group at dh 128 (the six
# kernel variants)
PAGED_PLANS = {"engine b32 mha": (32, 12, 12, 64, 1024),
               "generate b8 mha": (8, 12, 12, 64, 576),
               "mha dh 128": (8, 8, 8, 128, 576),
               "gqa g=4 rep 3": (8, 12, 4, 64, 576),
               "rep 4 dh 128": (8, 8, 2, 128, 576),
               "mqa": (8, 12, 1, 64, 576),
               "rep 16 dh 128": (8, 16, 1, 128, 576),
               "rep 32 dh 128": (8, 32, 1, 128, 576)}


def paged_kernel_attributes():
    """Registers, shared memory per CTA, CTAs per SM and spill bytes of
    row 6's and K3's split-key kernel under each plan of PAGED_PLANS (every
    compute dtype over every float pool dtype, and over an int8 pool) and
    of K3's projection (fp32 and bf16 W, in vectors and one element at a
    time)."""
    from apex_tpu_torch.ops import decode_step as tds
    from apex_tpu_torch.ops import paged_attention as tpa

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    floats = (torch.float32, torch.bfloat16, torch.float16)
    out = {}
    for name, (b, nh, g, dh, reach) in PAGED_PLANS.items():
        for dt in floats:
            for pool in floats + (torch.int8,):
                plan = tpa.paged_plan(b, g, nh // g, dh, reach,
                                      pool.itemsize, sms)
                key = (f"{name} {str(dt)[6:]} q, {str(pool)[6:]} pool "
                       f"(H{plan.heads} EPL{plan.epl})")
                out[f"row 6 {key}"] = tpa.kernel_attributes(dt, pool, plan)
                out[f"K3 {key}"] = tds.kernel_attributes(
                    dt, pool, plan, torch.float32, nh * dh)["attention"]
    plan = tpa.paged_plan(8, 12, 1, 64, 576, 2, sms)
    for w_dt in (torch.float32, torch.bfloat16):
        for vec in (True, False):
            out[f"K3 projection {str(w_dt)[6:]} W"
                f"{'' if vec else ' scalar'}"] = tds.kernel_attributes(
                torch.bfloat16, torch.bfloat16, plan, w_dt, 768,
                vec)["projection"]
    return out


def kernel_decode(dev, gen):
    """K3 against its plain version at every variant of DECODE_VARIANTS
    (within DECODE_TOL; the empty lane exact zeros), bitwise repeats and a
    CUDA-graph replay with other lengths, each variant timed beside its
    bound (bytes: live K/V and scales once, W once in its dtype, q, out,
    tables; flops 4 per K/V element and head, 2 per W element and row)."""
    from apex_tpu_torch.ops import decode_step as tds

    errs, timed = {}, {}
    cases = [v + (torch.bfloat16, torch.bfloat16) for v in DECODE_VARIANTS]
    cases += [(f"mha learned, {_dt(qd)} q, {_dt(pd)} pool", 12, 12, 64,
               False, False, torch.float32, False, qd, pd)
              for qd, pd in FOREIGN_POOLS]
    for (name, nh, g, dh, rope, quant, w_dtype, empty, q_dtype,
         pool_dtype) in cases:
        args, sc = _decode_inputs(dev, gen, nh, g, dh, rope, quant, w_dtype,
                                  empty, q_dtype=q_dtype,
                                  pool_dtype=pool_dtype)
        q, kp, vp, tables, lens, w = args
        got = tds.fused_decode_layer(*args, **sc)
        want = tds.fused_decode_layer(*args, backend="reference", **sc)
        errs[name] = max_err(got, want)
        check(errs[name] <= DECODE_TOL, f"K3 {name} error {errs[name]}")
        if empty:
            check(int(torch.count_nonzero(got[-1])) == 0,
                  f"K3 {name}: the length-0 lane is not exact zeros")
        repeat_and_replay(lambda: tds.fused_decode_layer(*args, **sc), lens,
                          _mapped_tokens(tables, kp.shape[0], kp.shape[1]),
                          f"K3 {name}")
        b, h_out = q.shape[0], w.shape[1]
        live = int(lens.sum())
        per_elem, per_scale = (1, 4) if quant else (kp.element_size(), 0)
        qs = q.element_size()
        nbytes = (live * g * (dh * per_elem + per_scale) * 2
                  + w.numel() * w.element_size() + q.numel() * qs
                  + b * h_out * qs + tables.numel() * 4 + b * 4)
        bms, by = bound(nbytes, 4 * live * nh * dh + 2 * b * nh * dh * h_out,
                        PEAK_FP32_FLOPS)
        timed[name] = {
            "err": errs[name],
            "ms": time_ms(lambda: tds.fused_decode_layer(*args, **sc)),
            "plain_ms": time_ms(lambda: tds.fused_decode_layer(
                *args, backend="reference", **sc)),
            "library_ms": None, "bound_ms": bms, "bound_by": by}
    main = timed.pop("mha learned")
    return dict(main, err=max(errs.values()), tol=DECODE_TOL, detail=errs,
                variants=timed,
                shape="b=8 nh=12 g=12 dh=64 block=16 lengths 17-576 bf16 "
                      "pool, W fp32 [768, 768] (variants: rope, GQA g=4, "
                      "int8 pool, bf16 W, MQA g=1, 16 and 32 heads a group "
                      "at dh 128, the wide ones with a length-0 lane; each "
                      "compute dtype over each other float pool dtype)")


# row 6 at the engine's decode shape: 32 lanes, lengths 1-1024 with
# len % 16 in {0, 1, 15}, and a lane of length 0 whose table holds only
# sentinels (a free engine lane)
PAGED_LENS = [1, 15, 16, 17, 31, 32, 33, 63, 64, 65, 100, 128, 129, 200,
              255, 256, 257, 300, 383, 384, 385, 500, 511, 512, 513, 640,
              767, 768, 769, 1000, 1024, 0]
# (name, nh, g, dh, int8 pool); MHA with a bf16 pool is the main row
PAGED_VARIANTS = (
    ("mha bf16 pool", 12, 12, 64, False),
    ("mha int8 pool", 12, 12, 64, True),
    ("gqa g=4 int8 pool", 12, 4, 64, True),
    ("mqa bf16 pool", 12, 1, 64, False),
    ("mqa int8 pool", 12, 1, 64, True),
    ("rep 16 dh 128 bf16 pool", 16, 1, 128, False),
    ("rep 16 dh 128 int8 pool", 16, 1, 128, True),
    ("rep 32 dh 128 bf16 pool", 32, 1, 128, False))


def _paged_inputs(dev, gen, g, quant, nh=12, dh=64, bs=16, mb=64,
                  q_dtype=torch.bfloat16, pool_dtype=torch.bfloat16):
    from apex_tpu_torch.serving.paged_cache import quantize_kv

    b = len(PAGED_LENS)
    lens = torch.tensor(PAGED_LENS, device=dev, dtype=torch.int32)
    nb = b * mb + 7
    tables = torch.randperm(nb, device=dev, generator=gen)[:b * mb]
    tables = tables.view(b, mb).to(torch.int32)
    for i, n in enumerate(PAGED_LENS):
        tables[i, -(-n // bs):] = nb + 1 + i          # sentinel tails
    q = torch.randn(b, nh, dh, device=dev, generator=gen).to(q_dtype)
    kp = torch.randn(nb, bs, g, dh, device=dev, generator=gen)
    vp = torch.randn(nb, bs, g, dh, device=dev, generator=gen)
    if not quant:
        return (q, kp.to(pool_dtype), vp.to(pool_dtype), tables, lens), {}
    kq, ks = quantize_kv(kp)
    vq, vs = quantize_kv(vp)
    return (q, kq, vq, tables, lens), dict(k_scale=ks, v_scale=vs)


def kernel_paged(dev, gen):
    """Row 6 against its plain version at every variant of PAGED_VARIANTS
    (the length-0 lane exact zeros), bitwise repeats and a CUDA-graph
    replay with other lengths, each variant timed beside its bound."""
    from apex_tpu_torch.ops import paged_attention as tpa

    tol = 2e-2
    errs, timed = {}, {}
    cases = [v + (torch.bfloat16, torch.bfloat16) for v in PAGED_VARIANTS]
    cases += [(f"mha {_dt(qd)} q, {_dt(pd)} pool", 12, 12, 64, False, qd,
               pd) for qd, pd in FOREIGN_POOLS]
    for name, nh, g, dh, quant, q_dtype, pool_dtype in cases:
        args, sc = _paged_inputs(dev, gen, g, quant, nh=nh, dh=dh,
                                 q_dtype=q_dtype, pool_dtype=pool_dtype)
        q, kp, vp, tables, lens = args
        got = tpa.ragged_paged_attention(*args, **sc)
        want = tpa.ragged_paged_attention(*args, backend="reference", **sc)
        errs[name] = max_err(got, want)
        check(errs[name] <= tol, f"row 6 {name} error {errs[name]}")
        check(int(torch.count_nonzero(got[-1])) == 0,
              f"row 6 {name}: the length-0 lane is not exact zeros")
        repeat_and_replay(lambda: tpa.ragged_paged_attention(*args, **sc),
                          lens, _mapped_tokens(tables, kp.shape[0],
                                               kp.shape[1]), f"row 6 {name}")
        live = sum(PAGED_LENS)
        per_elem, per_scale = (1, 4) if quant else (kp.element_size(), 0)
        b = len(PAGED_LENS)
        nbytes = (live * g * (dh * per_elem + per_scale) * 2
                  + 2 * b * nh * dh * q.element_size() + tables.numel() * 4
                  + b * 4)
        bms, by = bound(nbytes, 4 * live * nh * dh, PEAK_FP32_FLOPS)
        timed[name] = {
            "err": errs[name],
            "ms": time_ms(lambda: tpa.ragged_paged_attention(*args, **sc)),
            "plain_ms": time_ms(lambda: tpa.ragged_paged_attention(
                *args, backend="reference", **sc)),
            "library_ms": None, "bound_ms": bms, "bound_by": by}
    main = timed.pop("mha bf16 pool")
    return dict(main, err=max(errs.values()), tol=tol, detail=errs,
                variants=timed,
                shape=f"b={len(PAGED_LENS)} nh=12 g=12 dh=64 block=16 "
                      "max_blocks=64 lengths 0-1024 bf16 pool (variants: "
                      "int8 pool, GQA g=4, MQA g=1, 16 and 32 heads a group "
                      "at dh 128; each compute dtype over each other float "
                      "pool dtype)")


# row 10 at GPT-2 125M's four per-layer matmuls: (in, out)
DENSE_SITES = (("qkv", 768, 2304), ("proj", 768, 768), ("fc1", 768, 3072),
               ("fc2", 3072, 768))
# decode lanes (the decode route); a prefill of 1024 tokens and the
# quantized MoE forward's 4096 (the tensor-core GEMM)
DENSE_ROWS = {"dense_int8_decode": (32,), "dense_int8": (1024, 4096)}
DENSE_TOL = {torch.bfloat16: 1e-2, torch.float32: 1e-5}


def _dense_case(dev, gen, m, k, n, dtype):
    """One row 10 call on a seeded slab against its plain version: (args,
    relative error, max abs error, bound ms, what bounds it, the weight
    dequantized to x's dtype for the library call)."""
    from apex_tpu_torch.ops import dense as td

    w = torch.randn(k, n, device=dev, generator=gen) * 0.02
    slab = td.quantize_weight(w)
    x = torch.randn(m, k, device=dev, generator=gen).to(dtype)
    args = (x, slab["wire"], slab["scale"])
    got = td.dense_quantized(*args)
    want = td.dense_quantized(*args, backend="reference")
    kb = k // slab["scale"].shape[0]
    esz = x.element_size()
    nbytes = m * k * esz + k * n + (k // kb) * n * 4 + m * n * esz
    bms, by = bound(nbytes, 2 * m * k * n,
                    PEAK_BF16_FLOPS if dtype == torch.bfloat16
                    else PEAK_FP32_FLOPS)
    wd = td.dequantize_weight(slab["wire"], slab["scale"]).to(dtype)
    return args, rel_err(got, want), max_err(got, want), bms, by, wd


def kernel_dense_int8(dev, gen):
    """Row 10's three routes against the plain version (fp32 x against
    the dequantized slab): the decode route at M = 32 and the tensor-core
    GEMM at M = 1024 and 4096, each at the four GPT-2 125M kernels in
    bf16, and the CUDA-core route on one fp32 case; errors relative to
    max |plain|.  Every call is checked to launch its route's kernel.
    The library time is bf16 ``torch.mm`` on the weight dequantized to
    bf16 beforehand: a reference point that reads bf16 weights, not the
    same input."""
    from apex_tpu_torch.ops import _kernel_utils as ku
    from apex_tpu_torch.ops import dense as td

    cases = [(kname, m, site, torch.bfloat16)
             for kname, rows in DENSE_ROWS.items() for m in rows
             for site in DENSE_SITES]
    cases.append(("dense_int8_simt", 32, DENSE_SITES[0], torch.float32))
    out = {}
    for kname, m, (site, k, n), dtype in cases:
        errs, abs_err, variants = out.setdefault(kname, ({}, 0.0, {}))
        before = ku.KERNELS[kname].launches
        args, rel, err, bms, by, wd = _dense_case(dev, gen, m, k, n, dtype)
        check(ku.KERNELS[kname].launches == before + 1,
              f"row 10 M={m} {site} {dtype} did not take {kname}")
        name = f"M={m} {site} [{k}, {n}] {str(dtype)[6:]}"
        errs[name] = rel
        check(rel <= DENSE_TOL[dtype], f"row 10 {kname} {name} error {errs}")
        x = args[0]
        variants[name] = {
            "ms": time_ms(lambda: td.dense_quantized(*args)),
            "plain_ms": time_ms(lambda: td.dense_quantized(
                *args, backend="reference")),
            "library_ms": time_ms(lambda: torch.mm(x, wd)),
            "bound_ms": bms, "bound_by": by}
        out[kname] = (errs, max(abs_err, err), variants)
    desc = {
        "dense_int8_decode": "sum of the four GPT-2 125M matmuls (qkv, "
        "proj, fc1, fc2) at M=32 bf16, the decode route",
        "dense_int8": "sum of the four GPT-2 125M matmuls at M=1024 bf16 "
        "(the tensor-core GEMM); M=4096 per matmul under variants",
        "dense_int8_simt": "qkv [768, 2304] at M=32 fp32 (the CUDA-core "
        "route; no main path runs it)",
    }
    results = {}
    for kname, (errs, abs_err, variants) in out.items():
        # the headline: the first row count's four matmuls (or the one case)
        m0 = DENSE_ROWS.get(kname, (32,))[0]
        head = [v for k, v in variants.items() if k.startswith(f"M={m0} ")]
        results[kname] = {
            "err": abs_err, "rel_err": max(errs.values()),
            "tol": DENSE_TOL[torch.float32 if kname == "dense_int8_simt"
                             else torch.bfloat16], "detail": errs,
            "ms": sum(v["ms"] for v in head),
            "plain_ms": sum(v["plain_ms"] for v in head),
            "library_ms": sum(v["library_ms"] for v in head),
            "bound_ms": sum(v["bound_ms"] for v in head),
            "bound_by": ("bytes" if all(v["bound_by"] == "bytes"
                                        for v in head) else "operations"),
            "variants": variants,
            "shape": desc[kname] + "; library = bf16 torch.mm on the "
                     "weight dequantized beforehand (reads bf16, not the "
                     "int8 slab)",
        }
    return results


# K4's variants: name -> (b, V, dtype, top_k, top_p, mode); the main row
# is generate's decode ([8, 50304] fp32, top-k 50, top-p 0.95, greedy
# rows among sampled ones); the engine samples its 32 lanes; Qwen2's and
# Gemma's vocabularies passed the first version's one-SM row
SAMPLER_MAIN = "[8, 50304] fp32 top_k=50 top_p=0.95"
SAMPLER_VARIANTS = {
    SAMPLER_MAIN: (8, 50304, torch.float32, 50, 0.95, "mixed"),
    "[32, 50304] fp32 top_k=50 top_p=0.95 (engine lanes)":
        (32, 50304, torch.float32, 50, 0.95, "mixed"),
    "[1, 50304] fp32 top_k=50 top_p=0.95":
        (1, 50304, torch.float32, 50, 0.95, "mixed"),
    "[8, 50304] fp32 top_p=0.95": (8, 50304, torch.float32, None, 0.95,
                                   "mixed"),
    "[8, 50304] fp32 top_k=50": (8, 50304, torch.float32, 50, None, "mixed"),
    "[8, 50304] fp32 no filter": (8, 50304, torch.float32, None, None,
                                  "mixed"),
    "[8, 50304] bf16 top_k=50 top_p=0.95":
        (8, 50304, torch.bfloat16, 50, 0.95, "mixed"),
    "[8, 50304] fp32 top_k=50 top_p=0.95, token-mask holes":
        (8, 50304, torch.float32, 50, 0.95, "holes"),
    "[8, 50304] fp32 top_k=50 top_p=0.95, all greedy":
        (8, 50304, torch.float32, 50, 0.95, "greedy"),
    "[8, 50304] fp32 top_p=0.95, flat rows":
        (8, 50304, torch.float32, None, 0.95, "flat"),
    "[8, 152064] fp32 top_k=50 top_p=0.95":
        (8, 152064, torch.float32, 50, 0.95, "mixed"),
    "[8, 262144] fp32 top_k=50 top_p=0.95":
        (8, 262144, torch.float32, 50, 0.95, "mixed"),
    "[8, 262144] bf16 top_k=50 top_p=0.95":
        (8, 262144, torch.bfloat16, 50, 0.95, "mixed"),
}
SAMPLER_WORDS = ((1, 2), (0xDEADBEEF, 0x12345678), (7, 7))


def _sampler_case(dev, gen, b, V, dtype, top_k, top_p, mode):
    """One K4 variant: x = randn * 4 in dtype (flat rows: uniform in [0,
    0.05)), vocab limit V - 47 (GPT-2's 50257 of 50304); mismatching
    tokens against _sampling_plain over SAMPLER_WORDS, one launch a call;
    kernel and plain times of the fused_sample call with its key words
    in a device tensor, as a captured decode step passes them (Python
    words add two fills a call; with a token mask its torch.where is
    timed too), and the bound: each logit read once, the temperatures,
    words and tokens; 4 operations a logit at the fp32 rate."""
    from apex_tpu_torch.ops import fused_sampling as tfs

    x = torch.randn(b, V, device=dev, generator=gen) * 4
    if mode == "flat":
        x = torch.rand(b, V, device=dev, generator=gen) * 0.05
    x = x.to(dtype)
    base = torch.tensor([0.8, 1.0, 0.0, 0.5, 1.5, 0.8, 0.0, 2.0])
    temps = (torch.zeros(b) if mode == "greedy"
             else base.repeat(-(-b // 8))[:b]).to(dev)
    mask = (torch.rand(b, V, device=dev, generator=gen) > 0.3
            if mode == "holes" else None)
    limit = V - 47
    kw = dict(temperature=temps, top_k=top_k, top_p=top_p,
              vocab_limit=limit, token_mask=mask)
    xm = x if mask is None else tfs.apply_token_mask(x, mask)
    mismatches = 0
    for words in SAMPLER_WORDS:
        before = tfs.FUSED_SAMPLE.launches
        got = tfs.fused_sample(x, seed_words=words, **kw)
        torch.cuda.synchronize()
        check(tfs.FUSED_SAMPLE.launches == before + 1,
              "K4: not one launch a call")
        want = tfs._sampling_plain(xm, words, temps, top_k, top_p, limit)
        mismatches += int((got != want).sum())
        check(int(got.max()) < limit, "K4 token past the vocab limit")
    plan = tfs.sample_plan(b, V, x.element_size(),
                           0 if top_k is None else top_k, top_p is not None,
                           torch.cuda.get_device_properties(dev)
                           .multi_processor_count)
    bms, by = bound(b * V * x.element_size() + b * 8 + 16, b * V * 4,
                    PEAK_FP32_FLOPS)
    words = torch.tensor([1, 2], dtype=torch.int64, device=dev)
    return {
        "err": float(mismatches), "token_mismatches": mismatches,
        "plan": plan._asdict(),
        "ms": time_ms(lambda: tfs.fused_sample(x, seed_words=words, **kw)),
        "plain_ms": time_ms(lambda: tfs._sampling_plain(
            xm, (1, 2), temps, top_k, top_p, limit), iters=2),
        "library_ms": None, "bound_ms": bms, "bound_by": by,
    }


def _sampler_replays(dev, gen):
    """At the main shape: twenty calls give the same tokens, and a call
    captured in a CUDA graph with its key words in a device tensor replays
    new words copied into it as eager calls with them do."""
    from apex_tpu_torch.ops import fused_sampling as tfs

    b, V = 8, 50304
    x = torch.randn(b, V, device=dev, generator=gen) * 4
    temps = torch.tensor([0.8, 1.0, 0.0, 0.5, 1.5, 0.8, 0.0, 2.0],
                         device=dev)
    kw = dict(temperature=temps, top_k=50, top_p=0.95,
              vocab_limit=VOCAB_LIMIT)
    first = tfs.fused_sample(x, seed_words=(3, 4), **kw)
    repeats = sum(int(torch.equal(tfs.fused_sample(x, seed_words=(3, 4),
                                                   **kw), first))
                  for _ in range(20))
    words = torch.tensor([3, 4], dtype=torch.int64, device=dev)
    tfs.fused_sample(x, seed_words=words, **kw)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = tfs.fused_sample(x, seed_words=words, **kw)
    replays = 0
    for pair in ((5, 6), (0xFFFFFFFF, 1), (77, 0x9E3779B9)):
        words.copy_(torch.tensor(pair, dtype=torch.int64))
        graph.replay()
        eager = tfs.fused_sample(x, seed_words=pair, **kw)
        torch.cuda.synchronize()
        replays += int(torch.equal(captured, eager))
    check(repeats == 20, f"K4 repeats differ: {repeats} of 20 equal")
    check(replays == 3, f"K4 graph replays with new words: {replays} of 3 "
                        "equal the eager calls")
    return {"bitwise_repeats": repeats, "graph_replays_equal": replays}


def kernel_sampler(dev, gen):
    """K4 at SAMPLER_VARIANTS (the main row and the others as variants),
    every one token-identical to _sampling_plain; bitwise repeats and
    graph replays with new key words at the main shape."""
    runs = {name: _sampler_case(dev, gen, *c)
            for name, c in SAMPLER_VARIANTS.items()}
    bad = {n: r["token_mismatches"] for n, r in runs.items()
           if r["token_mismatches"]}
    check(not bad, f"K4 differs from _sampling_plain: {bad}")
    main = runs.pop(SAMPLER_MAIN)
    return dict(main, tol=0.0, variants=runs,
                detail={"token_mismatches": main["token_mismatches"],
                        **_sampler_replays(dev, gen)},
                shape=f"{SAMPLER_MAIN}, vocab limit 50257, temperatures "
                      "[0.8, 1.0, 0.0, 0.5, 1.5, 0.8, 0.0, 2.0] (the other "
                      "rows as variants, every one 0 token mismatches "
                      f"over {len(SAMPLER_WORDS)} key-word pairs)")


# row 9 at the LoRA path of GPT-2 125M: rank 8 over a 24-slot pool; each
# target matmul runs an A side [N, in] x [in, 8] and a B side [N, 8] x
# [8, out].  Decode has 32 lanes; an adapter prefill a bucket of up to 1024
LORA_RANK, LORA_SLOTS = 8, 24
LORA_SITES = (("qkv", 768, 2304), ("proj", 768, 768), ("fc1", 768, 3072),
              ("fc2", 3072, 768))
GMM_TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}


def kernel_grouped_matmul(dev, gen):
    """Row 9 against its plain version (one masked fp32 product per group)
    at the LoRA decode and prefill shapes and adversarial offsets, fp32
    and bf16, one launch a call; rows outside the window must be exact
    zeros.  The library
    point is ``torch.bmm`` of each row against its own group's weight,
    gathered per row beforehand (the gather not timed): no single PyTorch
    call computes this function."""
    from apex_tpu_torch.ops import grouped_matmul as tgm

    # the layouts the card-only kernel tests check, from one definition
    sys.path.insert(0, str(Path(__file__).resolve().parent / "tests"))
    from torch_gmm_cases import ADVERSARIAL, offsets_case

    errs, abs_err, variants = {}, 0.0, {}
    cases = [(lay, f"{site} {side}", k, p, torch.float32)
             for lay in ("decode", "prefill")
             for site, h_in, h_out in LORA_SITES
             for side, k, p in (("A", h_in, LORA_RANK),
                                ("B", LORA_RANK, h_out))]
    cases += [("decode", "qkv A", 768, LORA_RANK, torch.bfloat16),
              ("decode", "qkv B", LORA_RANK, 2304, torch.bfloat16)]
    cases += [(name, "", k, p, dt)
              for name in ADVERSARIAL
              for k, p, dt in ((100, 24, torch.float32),
                               (8, 300, torch.bfloat16))]
    for lay, site, k, p, dtype in cases:
        n, g, off = offsets_case(lay)
        off = off.tolist()
        x = torch.randn(n, k, device=dev, generator=gen).to(dtype)
        w = (torch.randn(g, k, p, device=dev, generator=gen) * 0.1).to(dtype)
        offs = torch.tensor(off, dtype=torch.int32, device=dev)
        name = f"{lay} {site} N={n} k={k} p={p} {str(dtype)[6:]}"
        row9 = (tgm.GROUPED_MATMUL, tgm.GROUPED_MATMUL_MMA)
        before = sum(kern.launches for kern in row9)
        got = tgm.grouped_matmul(x, w, offs)
        check(sum(kern.launches for kern in row9) == before + 1,
              f"row 9 {name}: not one launch a call")
        want = tgm.grouped_matmul(x, w, offs, backend="reference")
        check(int(torch.count_nonzero(got[:off[0]]))
              + int(torch.count_nonzero(got[off[-1]:])) == 0,
              f"row 9 {name}: rows outside the window are not zero")
        errs[name] = rel_err(got, want) if off[-1] > off[0] else 0.0
        abs_err = max(abs_err, max_err(got, want))
        check(errs[name] <= GMM_TOL[dtype], f"row 9 {name} error {errs}")
        if not site:
            continue
        live = sum(1 for a, b in zip(off, off[1:]) if b > a)
        esz = x.element_size()
        # x: the window's rows only (the rest are never read); the
        # output: every row, zeros included
        nbytes = ((off[-1] - off[0]) * k + live * k * p + n * p) * esz \
            + 4 * (g + 1)
        bms, by = bound(nbytes, 2 * (off[-1] - off[0]) * k * p,
                        PEAK_FP32_FLOPS)
        gid = tgm.group_ids(offs, n, g).long()
        wrow = torch.cat([w, w.new_zeros(1, k, p)])[gid]     # [N, k, p]
        x3 = x[:, None, :]
        variants[name] = {
            "ms": time_ms(lambda: tgm.grouped_matmul(x, w, offs)),
            "plain_ms": time_ms(lambda: tgm.grouped_matmul(
                x, w, offs, backend="reference")),
            "library_ms": time_ms(lambda: torch.bmm(x3, wrow)),
            "bound_ms": bms, "bound_by": by}
        del wrow
    # the headline: one decode layer's LoRA deltas, the 8 fp32 calls
    decode = [v for k, v in variants.items()
              if k.startswith("decode") and k.endswith("float32")]
    check(len(decode) == 8, "row 9: decode variants")
    return {
        "err": abs_err, "rel_err": max(errs.values()),
        "tol": GMM_TOL[torch.float32], "tol_bf16": GMM_TOL[torch.bfloat16],
        "detail": errs,
        "ms": sum(v["ms"] for v in decode),
        "plain_ms": sum(v["plain_ms"] for v in decode),
        "library_ms": sum(v["library_ms"] for v in decode),
        "bound_ms": sum(v["bound_ms"] for v in decode),
        "bound_by": ("bytes" if all(v["bound_by"] == "bytes" for v in decode)
                     else "operations"),
        "variants": variants,
        "shape": "sum of one decode layer's 8 LoRA calls (A and B sides of "
                 "qkv, proj, fc1, fc2; N=32 over 20 live groups of 24, "
                 "rank 8, fp32); per-shape times, the 1024-row prefill, "
                 "bf16 and adversarial offsets under variants; library = "
                 "torch.bmm on per-row gathered weights (gather not timed)",
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
    # and of one sampled generate: the greedy one launches no K4
    # (temperature 0 is an argmax), the sampled one 64 times
    _, s_names, _, _ = _profile(lambda: tgen.generate(params, prompt, cfg,
                                                      **sample_kw))
    return {
        "sampled_device_busy_ms": sum(s_names.values()),
        "sampled_k4_device_ms": sum(v for k, v in s_names.items()
                                    if "sampling_kernel" in k),
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


MQA_NEW_TOKENS = 16


def mqa_generate_phase(dev):
    """Greedy ``generate`` of ``gpt_125m(num_query_groups=1)`` at full
    width (12 query heads on one kv group: a geometry rows 6 and 7 refused
    before their split-key redesign): PROMPT_LENS's 8 ragged prompts, +16
    tokens, paged bf16.  K3 launches exactly layers x decode steps.  The
    tokens equal a ``backend="reference"`` run's, or where a row first
    differs the position is a bf16 near-tie (``tie_verdict`` on the
    teacher-forced kernel and plain logits over the kernel run's tokens),
    and every teacher-forced logit agrees within LOGIT_TOL."""
    from apex_tpu_torch.models import generate as tgen
    from apex_tpu_torch.models.config import gpt_125m
    from apex_tpu_torch.models.transformer_lm import init_gpt_params
    from apex_tpu_torch.ops import _kernel_utils as ku

    cfg = gpt_125m(num_query_groups=1)
    params = init_gpt_params(cfg, torch.Generator().manual_seed(0), dev)
    gen = torch.Generator().manual_seed(1)
    b, s = len(PROMPT_LENS), max(PROMPT_LENS)
    prompt = torch.zeros(b, s, dtype=torch.long)
    for i, n in enumerate(PROMPT_LENS):
        prompt[i, :n] = torch.randint(0, VOCAB_LIMIT, (n,), generator=gen)
    prompt = prompt.to(dev)
    lens = torch.tensor(PROMPT_LENS, device=dev)
    kw = dict(max_new_tokens=MQA_NEW_TOKENS, prompt_lens=lens,
              cache_layout="paged", block_size=16, device=dev)
    tgen.generate(params, prompt, cfg, **dict(kw, max_new_tokens=2))
    torch.cuda.synchronize()

    ku.reset_launch_counts()
    toks = tgen.generate(params, prompt, cfg, **kw)
    torch.cuda.synchronize()
    counts = ku.launch_counts()
    steps, L = MQA_NEW_TOKENS - 1, cfg.num_layers
    want = {name: 0 for name in ku.KERNELS}
    want.update({"layer_norm_fwd": (2 * L + 1) * (1 + steps),
                 "flash_attention_fwd": L, "fused_decode_layer": L * steps})
    check(counts == want, f"mqa generate launches {counts} != {want}")
    plain = tgen.generate(params, prompt, cfg, backend="reference", **kw)

    rows = torch.arange(b, device=dev)
    tok_k = torch.stack([toks[rows, lens + j]
                         for j in range(MQA_NEW_TOKENS)], 1)
    tok_p = torch.stack([plain[rows, lens + j]
                         for j in range(MQA_NEW_TOKENS)], 1)

    def forced(backend):
        cache = tgen.init_kv_cache(cfg, b, s + MQA_NEW_TOKENS,
                                   cache_layout="paged", block_size=16,
                                   device=dev)
        logits, cache = tgen.prefill(params, prompt, cfg, prompt_lens=lens,
                                     cache=cache, device=dev,
                                     backend=backend)
        out = [logits]
        for j in range(steps):
            logits, cache = tgen.decode_step(params, tok_k[:, j], cache, cfg,
                                             device=dev, backend=backend)
            out.append(logits)
        return torch.stack(out, 1)[..., :VOCAB_LIMIT]

    lk, lp = forced(None), forced("reference")
    logit_err = max_err(lk, lp)
    check(logit_err <= LOGIT_TOL,
          f"mqa kernel vs plain logits differ by {logit_err}")
    ties = []
    for i in range(b):
        diff = (tok_k[i] != tok_p[i]).nonzero()
        if diff.numel():
            j = int(diff[0])
            v = tie_verdict(lk[i, j], lp[i, j], int(tok_k[i, j]),
                            int(tok_p[i, j]))
            ties.append(dict(v, row=i, step=j))
            check(v["near_tie"], f"mqa generate row {i} step {j}: not a "
                  f"near-tie {v}")
    return {"counts": counts, "logit_err": logit_err,
            "rows_identical": b - len(ties), "near_ties": ties,
            "shape": f"gpt_125m(num_query_groups=1) b={b} prompts "
                     f"{PROMPT_LENS} +{MQA_NEW_TOKENS} greedy, paged bf16"}


# the serving engine at bench.py's paged geometry and its
# long_prompt_starvation mix
# the engine phases (eager, graph, spec, host tier) run GPT-2 125M's
# widths at ENGINE_LAYERS of its 12 layers, and BERT-large its widths at
# BERT_LAYERS of 24: the script's time limit is shared with the
# single-device training phases (at full depth the whole run took 1146 s
# of phases on an H100 80GB HBM3 at 700 W, against its 1200 s limit)
ENGINE_LAYERS = 6
ENGINE_KW = dict(max_slots=32, max_len=1024, cache_layout="paged",
                 block_size=16, num_blocks=512, top_k=50, top_p=0.95,
                 vocab_limit=VOCAB_LIMIT)
ENGINE_RUNS = (("float", None), ("float", "int8"), ("quantized", None),
               ("quantized", "int8"))
STARVED_BLOCKS = 64
FORCED_BATCH = 8


def engine_requests(vocab):
    """2 long prompts (768 tokens, 64 new, class batch) submitted first,
    then 16 short ones (32 tokens, 32 new, class interactive), every
    fourth sampled at temperature 0.8, the rest greedy."""
    import numpy as np

    rng = np.random.RandomState(1)
    reqs = [dict(prompt=rng.randint(0, vocab, (768,)), max_new_tokens=64,
                 slo_class="batch") for _ in range(2)]
    reqs += [dict(prompt=rng.randint(0, vocab, (32,)), max_new_tokens=32,
                  slo_class="interactive",
                  temperature=0.8 if i % 4 == 3 else 0.0)
             for i in range(16)]
    return reqs


def pct(vals, q):
    """bench.py's nearest-rank percentile."""
    vals = sorted(vals)
    if not vals:
        return 0.0
    return vals[min(len(vals) - 1, max(0, round(q * (len(vals) - 1))))]


class PrefillBuckets:
    """Records the bucket of every prefill the engine runs (its
    ``pad_prompt`` calls), so that row 10's launches split by route: a
    prefill of at most 64 padded tokens takes the decode route, a longer
    one the tensor-core GEMM."""

    def __enter__(self):
        from apex_tpu_torch.serving import engine as engine_mod

        self._mod, self._orig = engine_mod, engine_mod.pad_prompt
        self.buckets = []

        def recorded(tokens, bucket, *args, **kw):
            self.buckets.append(int(bucket))
            return self._orig(tokens, bucket, *args, **kw)

        engine_mod.pad_prompt = recorded
        return self

    def __exit__(self, *exc):
        self._mod.pad_prompt = self._orig

    def row10(self, decode_steps, prefills, layers):
        """Row 10's launches per route: four matmuls a layer for every
        decode step (32 lanes) and every prefill."""
        from apex_tpu_torch.ops.dense import DECODE_ROWS

        check(len(self.buckets) == prefills,
              f"{len(self.buckets)} padded prompts, {prefills} prefills")
        short = sum(1 for b in self.buckets if b <= DECODE_ROWS)
        return {"dense_int8_decode": (decode_steps + short) * layers * 4,
                "dense_int8": (prefills - short) * layers * 4}


def drive_engine(engine, reqs):
    """Submit, step until idle, track the concurrency high-water mark →
    (responses by request id, wall ms, most concurrent requests)."""
    for kw in reqs:
        engine.submit(**kw)
    resps, hw = [], 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    while not engine.idle:
        resps.extend(engine.step())
        hw = max(hw, engine.stats()["active"])
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    return sorted(resps, key=lambda r: r.request_id), wall, hw


def check_responses(engine, reqs, resps, what):
    check(len(resps) == len(reqs), f"{what}: {len(resps)} of {len(reqs)} "
                                   "requests completed")
    for r, kw in zip(resps, reqs):
        check(r.finish_reason == "length"
              and r.tokens.size == kw["max_new_tokens"],
              f"{what}: request {r.request_id} ended {r.finish_reason} "
              f"after {r.tokens.size} of {kw['max_new_tokens']} tokens")
        check(int(r.tokens.max()) < VOCAB_LIMIT and int(r.tokens.min()) >= 0,
              f"{what}: request {r.request_id} token outside the vocab")
    st = engine.stats()
    check(engine.idle and st["blocks_in_use"] == 0
          and st["blocks_free"] == st["num_blocks"],
          f"{what}: ledger not clean once idle: {st['blocks_in_use']} "
          f"blocks in use, {st['blocks_free']} free of {st['num_blocks']}")


def first_token_tie(engine, prompt, tok_kernel, tok_plain, dev):
    """A greedy first token that differs between the kernel and the plain
    engine: the request's prefill logits on both paths (the engine's own
    bucket-padded prefill call).  It is a near-tie when each path's
    argmax is the token its engine emitted, the paths agree within
    LOGIT_TOL everywhere, and the two tokens' plain logits lie within
    LOGIT_TOL of each other."""
    from apex_tpu_torch.models import generate as tgen
    from apex_tpu_torch.serving.batching import pad_prompt, pick_bucket

    n = prompt.size
    bucket = pick_bucket(n, engine.buckets)
    padded = torch.as_tensor(pad_prompt(prompt, bucket)[None],
                             dtype=torch.long, device=dev)
    lens = torch.tensor([n], dtype=torch.int32, device=dev)
    lk, lp = (tgen.prefill(engine.params, padded, engine.cfg,
                           prompt_lens=lens, max_len=bucket, device=dev,
                           backend=b)[0][0, :VOCAB_LIMIT]
              for b in (None, "reference"))
    return tie_verdict(lk, lp, tok_kernel, tok_plain)


def tie_verdict(lk, lp, tok_kernel, tok_plain):
    """The near-tie rule on one position's kernel and plain logits."""
    err = max_err(lk, lp)
    gap = float(lp[tok_plain] - lp[tok_kernel])
    return {"kernel_token": tok_kernel, "plain_token": tok_plain,
            "logit_err": err, "plain_gap": gap,
            "near_tie": (int(lk.argmax()) == tok_kernel
                         and int(lp.argmax()) == tok_plain
                         and err <= LOGIT_TOL and gap <= LOGIT_TOL)}


def forced_logits(params, cfg, reqs, resps, wire, backend, dev):
    """Teacher-forced decode over the kernel run's greedy streams: the
    first FORCED_BATCH greedy requests prefilled together (ragged), then
    ``decode_step`` fed their generated tokens → logits [b, steps + 1, v]."""
    from apex_tpu_torch.models import generate as tgen

    ids = [i for i, kw in enumerate(reqs)
           if kw.get("temperature", 0.0) == 0.0][:FORCED_BATCH]
    lens = [reqs[i]["prompt"].size for i in ids]
    steps = min(resps[i].tokens.size for i in ids) - 1
    b, s = len(ids), max(lens)
    prompt = torch.zeros(b, s, dtype=torch.long)
    for row, i in enumerate(ids):
        prompt[row, :lens[row]] = torch.as_tensor(reqs[i]["prompt"])
    toks = torch.stack([torch.as_tensor(resps[i].tokens[:steps]).long()
                        for i in ids]).to(dev)
    cache = tgen.init_kv_cache(cfg, b, s + steps + 1, cache_layout="paged",
                               block_size=16, cache_wire=wire, device=dev)
    logits, cache = tgen.prefill(params, prompt.to(dev), cfg,
                                 prompt_lens=torch.tensor(lens, device=dev),
                                 cache=cache, device=dev, backend=backend)
    out = [logits]
    for j in range(steps):
        logits, cache = tgen.decode_step(params, toks[:, j], cache, cfg,
                                         device=dev, backend=backend)
        out.append(logits)
    return torch.stack(out, 1)[..., :VOCAB_LIMIT]


def engine_phase(dev):
    """The paged ServingEngine on GPT-2 125M: float or quantize_params
    weights x native or int8 pool, each with exact launch identities,
    SLO numbers, a clean ledger, first-token identity against the same
    engine on the plain path and (besides float + native) teacher-forced
    logits kernel vs plain; one profiled run for the idle share; one
    starved run that must preempt."""
    from apex_tpu_torch.models.config import gpt_125m
    from apex_tpu_torch.models.quantized import param_bytes, quantize_params
    from apex_tpu_torch.models.transformer_lm import init_gpt_params
    from apex_tpu_torch.ops import _kernel_utils as ku
    from apex_tpu_torch.serving import ServingEngine

    cfg = gpt_125m(num_layers=ENGINE_LAYERS)
    L = cfg.num_layers
    weights = {"float": init_gpt_params(cfg, torch.Generator().manual_seed(0),
                                        dev)}
    weights["quantized"] = quantize_params(weights["float"])
    reqs = engine_requests(cfg.vocab_size)
    greedy = [i for i, kw in enumerate(reqs)
              if kw.get("temperature", 0.0) == 0.0]

    def engine(wname, wire, **kw):
        return ServingEngine(weights[wname], cfg, cache_wire=wire,
                             generator=torch.Generator().manual_seed(0),
                             device=dev, **dict(ENGINE_KW, **kw))

    out = {}
    for wname, wire in ENGINE_RUNS:
        name = f"{wname} weights, {wire or 'native'} pool"
        # warm-up: allocator and library handles, both prompt buckets
        engine(wname, wire).run([dict(reqs[0], max_new_tokens=2),
                                 dict(reqs[2], max_new_tokens=2)])
        eng = engine(wname, wire)
        # --- the main path: counts reset just before, read just after ---
        with PrefillBuckets() as pb:
            ku.reset_launch_counts()
            resps, wall, hw = drive_engine(eng, reqs)
            counts = ku.launch_counts()
        st = eng.stats()
        D, P = st["decode_steps"], st["prefill_calls"]
        want = {k: 0 for k in ku.KERNELS if k != "fused_sample"}
        want.update(layer_norm_fwd=(D + P) * (2 * L + 1),
                    flash_attention_fwd=P * L)
        if wname == "float":
            want["fused_decode_layer"] = D * L
        else:
            want.update(ragged_paged_attention=D * L, **pb.row10(D, P, L))
        got = {k: v for k, v in counts.items() if k != "fused_sample"}
        check(got == want, f"engine {name}: launches {got} != {want} "
                           f"({D} decode steps, {P} prefill calls)")
        check_responses(eng, reqs, resps, f"engine {name}")
        ref = engine(wname, wire, backend="reference")
        rresps = ref.run(reqs)
        check_responses(ref, reqs, rresps, f"plain engine {name}")
        flips = {}
        for i in greedy:
            tk, tp = int(resps[i].tokens[0]), int(rresps[i].tokens[0])
            if tk != tp:
                flips[i] = first_token_tie(eng, reqs[i]["prompt"], tk, tp,
                                           dev)
        check(all(f["near_tie"] for f in flips.values()),
              f"engine {name}: first tokens differ from the plain "
              f"engine's beyond a bf16 near-tie: {flips}")
        same = sum(int((resps[i].tokens == rresps[i].tokens).sum())
                   for i in greedy)
        total = sum(resps[i].tokens.size for i in greedy)
        row = {
            "wall_ms": wall,
            "gen_tokens_per_s": sum(r.tokens.size for r in resps)
            / (wall / 1e3),
            "decode_steps": D, "prefill_calls": P,
            "max_concurrent_requests": hw,
            "blocks_high_water": st["blocks_high_water"],
            "param_bytes": param_bytes(weights[wname]),
            "cache_bytes": st["cache_bytes"],
            "greedy_tokens_identical_to_plain": same / total,
            "greedy_first_tokens_identical": (len(greedy) - len(flips),
                                              len(greedy)),
            "first_token_near_ties": flips,
            "counts": counts,
        }
        for cls in ("batch", "interactive"):
            rs = [r for r in resps if r.slo_class == cls]
            for metric in ("ttft_ms", "tpot_ms"):
                vals = [getattr(r, metric) for r in rs]
                row[f"{cls}_{metric}_p50"] = pct(vals, 0.5)
                row[f"{cls}_{metric}_p95"] = pct(vals, 0.95)
        if (wname, wire) != ("float", None):
            lk = forced_logits(weights[wname], cfg, reqs, resps, wire, None,
                               dev)
            lp = forced_logits(weights[wname], cfg, reqs, resps, wire,
                               "reference", dev)
            row["forced_logit_err"] = max_err(lk, lp)
            check(row["forced_logit_err"] <= LOGIT_TOL,
                  f"engine {name}: teacher-forced logits kernel vs plain "
                  f"differ by {row['forced_logit_err']} > {LOGIT_TOL}")
        out[name] = row
        print(f"engine {name}: {json.dumps(row)}")

    # --- device idle share: one profiled run, quantized + int8 -----------
    eng = engine("quantized", "int8")
    for kw in reqs:
        eng.submit(**kw)
    t_prof, busy, top, by_cat, by_op = profile_busy(eng.run)
    check(eng.idle, "profiled engine run did not drain")
    out["profiled quantized weights, int8 pool"] = {
        "wall_ms": t_prof, "device_busy_ms": busy if busy > 0
        else "not measured",
        "device_idle_share": (1 - busy / t_prof) if busy > 0
        else "not measured",
        "device_top_ms": top, "device_ms_by_category": by_cat,
        "device_ms_by_op": by_op}

    # --- a starved pool: must preempt, complete everything, end clean ----
    short = [reqs[0]] + reqs[2:10]
    eng = engine("quantized", "int8", num_blocks=STARVED_BLOCKS)
    resps, wall, hw = drive_engine(eng, short)
    check_responses(eng, short, resps, "starved engine")
    st = eng.stats()
    check(st["preemptions"] >= 1, f"starved engine ({STARVED_BLOCKS} "
                                  "blocks) never preempted")
    row = {"num_blocks": STARVED_BLOCKS, "requests": len(short),
           "preemptions": st["preemptions"], "wall_ms": wall,
           "max_concurrent_requests": hw,
           "blocks_high_water": st["blocks_high_water"]}
    out["starved quantized weights, int8 pool"] = row
    print(f"engine starved, quantized weights, int8 pool: {json.dumps(row)}")
    return out


# the compiled ladder (ServingEngine(compile_cache_dir=)) on the engine
# geometry above: every ladder entry a CUDA graph over kernel libraries
# kept in the directory
GRAPH_RUNS = (("float", None), ("quantized", "int8"))
GRAPH_CHUNK = 256
MASK_SINGLE = 1234              # the one token the single-token request allows
CACHE_ROOT = Path(__file__).resolve().parent / "build" / "compile_cache"


def _engine_weights(dev):
    from apex_tpu_torch.models.config import gpt_125m
    from apex_tpu_torch.models.quantized import quantize_params
    from apex_tpu_torch.models.transformer_lm import init_gpt_params

    cfg = gpt_125m(num_layers=ENGINE_LAYERS)
    weights = {"float": init_gpt_params(cfg, torch.Generator().manual_seed(0),
                                        dev)}
    weights["quantized"] = quantize_params(weights["float"])
    return cfg, weights


def _fresh_dir(name: str) -> Path:
    import shutil

    d = CACHE_ROOT / name
    shutil.rmtree(d, ignore_errors=True)
    return d


def _without_counts(row):
    return {k: (_without_counts(v) if isinstance(v, dict) else v)
            for k, v in row.items() if k != "counts"}


def drive_steps(engine, reqs):
    """drive_engine, timing every step: → (responses by request id, wall
    ms, ms of each step that only decoded: no admission, no chunk)."""
    for kw in reqs:
        engine.submit(**kw)
    resps, decode_ms = [], []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    while not engine.idle:
        # the engine's own counters (no stats() call inside the timing)
        # (an engine without chunked prefill has no prefilling lanes)
        busy = (engine._prefill_count, len(engine._queue),
                any(getattr(s, "prefilling", False) for s in engine._slots))
        s0 = time.perf_counter()
        resps.extend(engine.step())
        dt = (time.perf_counter() - s0) * 1e3
        if (busy[:2] == (engine._prefill_count, len(engine._queue))
                and not busy[2]):
            decode_ms.append(dt)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    return sorted(resps, key=lambda r: r.request_id), wall, decode_ms


def first_step_digest(engine, reqs) -> str:
    """SHA-256 of the first decode step's logits of ``reqs`` on an idle
    engine (the step admits them all and decodes once)."""
    import hashlib

    for kw in reqs:
        engine.submit(**kw)
    engine.step()
    return hashlib.sha256(
        engine.last_logits.float().cpu().numpy().tobytes()).hexdigest()


def graph_child(d: str, wname: str, wire: str, dev=None) -> dict:
    """``--graph-child``: a fresh process building the graph engine on
    directory ``d`` → its ladder, hits, misses, nvcc runs, start-up ms and
    first decode step's digest."""
    from apex_tpu_torch.ops import _kernel_utils as ku
    from apex_tpu_torch.serving import ServingEngine, warmup_ladder

    dev = dev or torch.device("cuda")
    cfg, weights = _engine_weights(dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng = ServingEngine(weights[wname], cfg,
                        cache_wire=None if wire == "native" else wire,
                        generator=torch.Generator().manual_seed(0),
                        compile_cache_dir=d, device=dev, **ENGINE_KW)
    ladder = warmup_ladder(eng)
    torch.cuda.synchronize()
    start_ms = (time.perf_counter() - t0) * 1e3
    digest = first_step_digest(eng, engine_requests(cfg.vocab_size))
    st = eng.stats()["compile_cache"]
    return {"start_ms": start_ms, "ladder": ladder, "hits": st["hits"],
            "misses": st["misses"], "entries": st["entries"],
            "nvcc": list(ku.NVCC_RUNS), "digest": digest}


def run_child(d: Path, wname: str, wire) -> dict:
    t0 = time.perf_counter()
    out = subprocess.run(
        [sys.executable, str(Path(__file__).resolve()), "--graph-child",
         str(d), wname, wire or "native"], capture_output=True, text=True,
        timeout=600, cwd=str(Path(__file__).resolve().parent))
    check(out.returncode == 0, f"graph child on {d} failed:\n"
                               f"{out.stderr[-3000:]}")
    row = json.loads(out.stdout.strip().splitlines()[-1])
    row["process_ms"] = (time.perf_counter() - t0) * 1e3
    return row


def _forced_row0(params, cfg, wire, prompt, toks, j, chunked, dev):
    """Logits ``[v]`` (first VOCAB_LIMIT) of the token at generated
    position ``j`` of a request whose prompt is ``prompt`` and whose first
    ``j`` generated tokens are ``toks[:j]``, computed as the engine does
    it: the prompt through the ``prefill[bucket]`` + ``insert`` pair, or
    (``chunked``, a prompt longer than a chunk) through GRAPH_CHUNK-token
    verify chunks at b=1, into row 0 of a 32-lane paged pool; then decode
    steps over all 32 lanes (the engine's batch shape)."""
    from apex_tpu_torch.models import generate as tgen
    from apex_tpu_torch.serving.batching import (
        default_buckets, pad_prompt, pick_bucket)
    from apex_tpu_torch.serving.engine import _insert_entry, _prefill_entry

    params = tgen._compute_dtype_params(params, cfg)
    S, n = ENGINE_KW["max_slots"], prompt.size
    cache = tgen.init_kv_cache(cfg, S, ENGINE_KW["max_len"],
                               cache_layout="paged", block_size=16,
                               cache_wire=wire, device=dev)
    p = torch.as_tensor(prompt, dtype=torch.long, device=dev)[None]
    if chunked and n > GRAPH_CHUNK:
        row0 = dict(cache, block_tables=cache["block_tables"][:1],
                    pos=cache["pos"][:1])
        lg, _ = tgen.prefill_chunked(params, p, cfg, chunk_tokens=GRAPH_CHUNK,
                                     cache=row0, device=dev)
    else:
        bucket = pick_bucket(n, default_buckets(ENGINE_KW["max_len"]))
        padded = torch.as_tensor(pad_prompt(prompt, bucket)[None],
                                 dtype=torch.long, device=dev)
        lens = torch.tensor([n], dtype=torch.int32, device=dev)
        lg, ks, vs = _prefill_entry(padded, lens, params=params, cfg=cfg,
                                    bucket=bucket,
                                    cache_dtype=cfg.compute_dtype,
                                    backend=None)
        wid = torch.full((bucket // 16,), cache["k"].shape[1],
                         dtype=torch.int32, device=dev)
        wid[: -(-n // 16)] = cache["block_tables"][0, : -(-n // 16)]
        pools = {k: v for k, v in cache.items() if k != "pos"}
        pools.pop("block_tables")
        _insert_entry(ks, vs, wid, lens, cache=pools, layout="paged",
                      bucket=bucket, block_size=16)
    cache["pos"][0] = n
    for s in range(j):
        tok = torch.zeros(S, dtype=torch.int32, device=dev)
        tok[0] = int(toks[s])
        lg, cache = tgen.decode_step(params, tok, cache, cfg, device=dev)
    return lg[0, :VOCAB_LIMIT].float()


def chunk_tie(params, cfg, wire, prompt, tok_c, tok_p, dev):
    """A greedy stream that differs between the chunked and the unchunked
    engine: both paths' logits at the first differing position, teacher
    forced on the shared tokens before it, judged by the near-tie rule
    (chunked as the kernel side, unchunked as the plain side)."""
    j = int((tok_c != tok_p).nonzero()[0][0])
    lc = _forced_row0(params, cfg, wire, prompt, tok_p, j, True, dev)
    lp = _forced_row0(params, cfg, wire, prompt, tok_p, j, False, dev)
    return dict(tie_verdict(lc, lp, int(tok_c[j]), int(tok_p[j])),
                position=j)


def mask_requests(vocab):
    """The engine mix, each request allowed a seeded random half of the
    vocabulary's real ids; request 5 (greedy) only MASK_SINGLE."""
    import numpy as np

    rng = np.random.RandomState(2)
    reqs = engine_requests(vocab)
    allowed = []
    for i, kw in enumerate(reqs):
        m = np.zeros(vocab, bool)
        if i == 5:
            m[MASK_SINGLE] = True
        else:
            m[rng.permutation(VOCAB_LIMIT)[: VOCAB_LIMIT // 2]] = True
        allowed.append(m)
        kw["token_mask_fn"] = (lambda v, m=m: m)
    return reqs, allowed


def graph_engine_phase(dev):
    """The compiled ladder on GPT-2 125M under the engine mix: per weight
    and pool configuration an eager engine and a ``compile_cache_dir=``
    engine on the same requests and generator (tokens, finish reasons and
    launch counts identical, a clean ledger; tokens/s, idle share, decode
    ms a step, the ladder's entries and ms); a fresh process on the primed
    directory (every entry a hit, no nvcc, the same first-step logits bit
    for bit) and one on an empty directory (the cold start); the chunked
    engine (chunk_tokens=256) against the unchunked one; and a masked
    run."""
    from apex_tpu_torch.ops import _kernel_utils as ku
    from apex_tpu_torch.serving import ServingEngine, warmup_ladder

    cfg, weights = _engine_weights(dev)
    reqs = engine_requests(cfg.vocab_size)
    greedy = [i for i, kw in enumerate(reqs)
              if kw.get("temperature", 0.0) == 0.0]
    shorts = [i for i, kw in enumerate(reqs)
              if kw["slo_class"] == "interactive"]

    def engine(wname, wire, d=None, **kw):
        return ServingEngine(weights[wname], cfg, cache_wire=wire,
                             generator=torch.Generator().manual_seed(0),
                             compile_cache_dir=d, device=dev,
                             **dict(ENGINE_KW, **kw))

    def counted(eng, rs):
        ku.reset_launch_counts()
        out = drive_steps(eng, rs)
        torch.cuda.synchronize()
        return out + (ku.launch_counts(),)

    def same(a, b, what, ids=None):
        for i in (range(len(a)) if ids is None else ids):
            check(a[i].tokens.tolist() == b[i].tokens.tolist()
                  and a[i].finish_reason == b[i].finish_reason,
                  f"{what}: request {i} differs")

    out = {}
    for wname, wire in GRAPH_RUNS:
        name = f"{wname} weights, {wire or 'native'} pool"
        engine(wname, wire).run([dict(reqs[0], max_new_tokens=2),
                                 dict(reqs[2], max_new_tokens=2)])
        ea, e_wall, e_dec, e_counts = counted(engine(wname, wire), reqs)
        d = _fresh_dir(f"{wname}-{wire or 'native'}")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        g = engine(wname, wire, d)
        ladder = warmup_ladder(g)
        torch.cuda.synchronize()
        cold_in_process_ms = (time.perf_counter() - t0) * 1e3
        check(ladder["skipped"] == [] and ladder["misses"] == ladder["entries"],
              f"graph engine {name}: ladder {ladder}")
        ga, g_wall, g_dec, g_counts = counted(g, reqs)
        same(ea, ga, f"graph engine {name} vs eager")
        check(g_counts == e_counts, f"graph engine {name}: launches "
                                    f"{g_counts} != eager {e_counts}")
        st = g.stats()
        check(st["blocks_in_use"] == 0 and g.idle,
              f"graph engine {name}: {st['blocks_in_use']} blocks in use")
        check(st["compile_cache"]["misses"] == ladder["entries"],
              f"graph engine {name}: serving missed {st['compile_cache']}")
        recorded = sorted({s for e in g._compile_cache._memo.values()
                           for s in e.record["libraries"]})
        check(recorded == ladder["sources"],
              f"graph engine {name}: the entries launched the kernels of "
              f"{recorded}, the ladder prebuilt {ladder['sources']}")
        check_responses(g, reqs, ga, f"graph engine {name}")
        prof = {}
        for kind, eng in (("eager", engine(wname, wire)), ("graph", g)):
            for kw in reqs:
                eng.submit(**kw)
            t_p, busy, top, by_cat, _ = profile_busy(eng.run)
            check(eng.idle, f"profiled {kind} engine {name} did not drain")
            prof[kind] = {"wall_ms": t_p,
                          "device_busy_ms": busy if busy > 0
                          else "not measured",
                          "device_idle_share": (1 - busy / t_p) if busy > 0
                          else "not measured",
                          "device_ms_by_category": by_cat,
                          "device_top_ms": top}
        child = run_child(d, wname, wire)
        twin = engine(wname, wire, d)
        warmup_ladder(twin)
        parent_digest = first_step_digest(twin, reqs)
        check(child["nvcc"] == [], f"graph child {name} ran nvcc on "
                                   f"{child['nvcc']}")
        check(child["hits"] == child["entries"] and child["misses"] == 0,
              f"graph child {name}: {child['hits']} hits, "
              f"{child['misses']} misses, {child['entries']} entries")
        check(child["digest"] == parent_digest,
              f"graph child {name}: first-step logits differ bitwise")
        row = {
            "gen_tokens_per_s_eager": sum(r.tokens.size for r in ea)
            / (e_wall / 1e3),
            "gen_tokens_per_s_graph": sum(r.tokens.size for r in ga)
            / (g_wall / 1e3),
            "wall_ms_eager": e_wall, "wall_ms_graph": g_wall,
            "decode_ms_per_step_eager": pct(e_dec, 0.5),
            "decode_ms_per_step_graph": pct(g_dec, 0.5),
            "decode_only_steps": (len(e_dec), len(g_dec)),
            "decode_steps": st["decode_steps"],
            "ladder_entries": ladder["entries"], "ladder_ms": ladder["ms"],
            "ladder_sources": ladder["sources"],
            "ladder_labels": ladder["labels"],
            "cold_start_in_process_ms": cold_in_process_ms,
            "warm_child": {k: child[k] for k in
                           ("start_ms", "process_ms", "hits", "misses",
                            "entries")},
            "profiled": prof, "counts": g_counts,
        }
        if wname == "float":
            cold = run_child(_fresh_dir("cold-float"), wname, wire)
            check(cold["digest"] == parent_digest,
                  "cold graph child: first-step logits differ bitwise")
            check(cold["nvcc"] == ladder["sources"],
                  f"cold graph child ran nvcc on {cold['nvcc']}, not on "
                  f"the ladder's sources {ladder['sources']}")
            row["cold_child"] = {k: cold[k] for k in
                                 ("start_ms", "process_ms", "hits", "misses",
                                  "entries", "nvcc")}
        # -- chunked prefill under graphs, against the unchunked graph run
        c = engine(wname, wire, _fresh_dir(f"chunk-{wname}"),
                   chunk_tokens=GRAPH_CHUNK)
        warmup_ladder(c)
        ca, c_wall, _, c_counts = counted(c, reqs)
        check_responses(c, reqs, ca, f"chunked graph engine {name}")
        ties = {}
        for i in greedy:
            if ca[i].tokens.tolist() != ga[i].tokens.tolist():
                ties[i] = chunk_tie(weights[wname], cfg, wire,
                                    reqs[i]["prompt"], ca[i].tokens,
                                    ga[i].tokens, dev)
        check(all(t["near_tie"] for t in ties.values()),
              f"chunked graph engine {name}: greedy tokens differ from the "
              f"unchunked engine's beyond a bf16 near-tie: {ties}")
        row["chunked"] = {
            "chunk_tokens": GRAPH_CHUNK, "wall_ms": c_wall,
            "decode_steps": c.stats()["decode_steps"],
            "greedy_identical": len(greedy) - len(ties),
            "greedy": len(greedy), "near_ties": ties,
            "short_tpot_p95_ms_chunked": pct(
                [ca[i].tpot_ms for i in shorts], 0.95),
            "short_tpot_p95_ms_unchunked": pct(
                [ga[i].tpot_ms for i in shorts], 0.95),
            "counts": c_counts}
        out[name] = row
        print(f"graph engine {name}: {json.dumps(row)}")

    # -- constrained decoding under graphs -------------------------------
    mreqs, allowed = mask_requests(cfg.vocab_size)
    me, _, _, me_counts = counted(engine("float", None, token_masks=True),
                                  mreqs)
    mg = engine("float", None, _fresh_dir("masked"), token_masks=True)
    warmup_ladder(mg)
    ma, m_wall, _, m_counts = counted(mg, mreqs)
    same(me, ma, "masked graph engine vs eager")
    check(m_counts == me_counts, f"masked graph engine: launches {m_counts} "
                                 f"!= eager {me_counts}")
    check(m_counts["fused_sample"] > 0, "masked run launched no K4")
    for r, m in zip(ma, allowed):
        check(bool(m[r.tokens].all()),
              f"masked request {r.request_id} emitted a disallowed token")
    check(set(ma[5].tokens.tolist()) == {MASK_SINGLE},
          f"single-token request emitted {set(ma[5].tokens.tolist())}")
    check(mg.stats()["blocks_in_use"] == 0, "masked engine ledger not clean")
    out["masked float weights, native pool"] = {
        "wall_ms": m_wall, "k4_launches": m_counts["fused_sample"],
        "tokens": sum(r.tokens.size for r in ma), "counts": m_counts}
    print(f"masked graph engine: "
          f"{json.dumps(out['masked float weights, native pool'])}")
    # release the engines' graphs now, not in a later phase's capture
    del g, c, mg
    gc.collect()
    torch.cuda.empty_cache()
    return out


# multi-tenant LoRA serving on the engine geometry above: bench.py's
# bench_adapter_ablation (64 tenants, rank 8, every 8th request on the
# base model) at GPT-2 125M widths
LORA_ADAPTERS, LORA_REQUESTS, LORA_NEW = 64, 64, 32
# the LoRA engine phase runs GPT-2 125M's widths at 2 of its 12 layers:
# its plain twin and teacher-forced checks made it the script's longest
# phase (243 s of 930 at full depth; 114 s at 4 layers of a 1111 s run),
# and the script's time limit is shared with the spec, host-tier and
# training phases
LORA_LAYERS = 2
LORA_RUNS = (("float", None), ("quantized", "int8"))
ORACLE_LAYERS, ORACLE_TENANTS, ORACLE_NEW, ORACLE_SLOTS = 2, 8, 16, 4
ORACLE_TIE = 1e-3               # |logit gap| of an fp32 near-tie


# speculative decoding: generate at bench_spec_ablation's geometry
# (bench.py:918-921: b8, prompt 64, +128, k 8, gpt_125m with 512
# positions, paged), under its two sweeps (bench.py:930-933)
SPEC_K = 8
SPEC_BATCH, SPEC_PROMPT, SPEC_NEW = 8, 64, 128
SPEC_TIMED_RUNS = 3
SPEC_COUNTERS = ("draft_tokens", "accepted_tokens", "verify_calls")


class CountCalls:
    """Counts the calls of ``module.name`` while active (the spec rounds
    a ``generate`` runs: ``speculative.spec_generate`` looks the round up
    in its module at each call)."""

    def __init__(self, module, name):
        self.module, self.name, self.n = module, name, 0

    def __enter__(self):
        self.orig = getattr(self.module, self.name)

        def counted(*a, **kw):
            self.n += 1
            return self.orig(*a, **kw)

        setattr(self.module, self.name, counted)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.orig)


def spec_tie(params, cfg, prompt_row, gen_row, j, tok_spec, tok_off, dev):
    """Greedy spec and spec-off tokens that first differ at new token
    ``j``: the logits predicting it after the prompt and ``gen_row[:j]``
    through the verify forward (spec's path) and through decode steps
    (spec-off's).  A near-tie when the two paths agree within LOGIT_TOL
    and both tokens lie within LOGIT_TOL of the top logit on both."""
    from apex_tpu_torch.models import generate as tgen

    n = prompt_row.numel()

    def prefilled():
        cache = tgen.init_kv_cache(cfg, 1, n + j + 1, cache_layout="paged",
                                   block_size=16, device=dev)
        return tgen.prefill(params, prompt_row[None], cfg, cache=cache,
                            device=dev)

    lg, cache = prefilled()
    lv = lg[0]
    if j:
        lv = tgen.decode_verify(params, gen_row[None, :j], cache, cfg,
                                device=dev)[0][0, -1]
    ls, cache = prefilled()
    for t in range(j):
        ls, cache = tgen.decode_step(params, gen_row[t:t + 1], cache, cfg,
                                     device=dev)
    lv, ls = lv[:VOCAB_LIMIT], ls[0][:VOCAB_LIMIT]
    err = max_err(lv, ls)
    gaps = [float(x.max() - min(x[tok_spec], x[tok_off])) for x in (lv, ls)]
    return {"step": j, "spec_token": tok_spec, "off_token": tok_off,
            "logit_err": err, "gaps": gaps,
            "near_tie": err <= LOGIT_TOL and max(gaps) <= LOGIT_TOL}


def spec_generate_phase(dev):
    """``generate(spec=SpecConfig(k=8))`` on GPT-2 125M at
    bench_spec_ablation's geometry, repetition prompts greedy and random
    prompts at temperature 1: exact launches a round (K1 2L+1, no paged
    kernel: the verify attention is torch arithmetic; K2 and, sampled, K4
    once for the first tokens), greedy tokens equal spec-off greedy on the
    kernel path or differ first at a near-tie, the spec counters, and
    decode tokens/s spec against off (medians of SPEC_TIMED_RUNS)."""
    import numpy as np

    from apex_tpu_torch.models import generate as tgen
    from apex_tpu_torch.models import speculative as tspec
    from apex_tpu_torch.models.config import gpt_125m
    from apex_tpu_torch.models.transformer_lm import init_gpt_params
    from apex_tpu_torch.observability import metrics as tel
    from apex_tpu_torch.ops import _kernel_utils as ku

    cfg = gpt_125m(max_position_embeddings=512)
    L = cfg.num_layers
    params = init_gpt_params(cfg, torch.Generator().manual_seed(0), dev)
    rng = np.random.RandomState(0)
    b, s, new = SPEC_BATCH, SPEC_PROMPT, SPEC_NEW
    pattern = rng.randint(0, VOCAB_LIMIT, (4,))
    sweeps = {
        "repetition": (np.tile(pattern, (b, -(-s // 4)))[:, :s], 0.0),
        "random": (rng.randint(0, VOCAB_LIMIT, (b, s)), 1.0)}
    spec = tspec.SpecConfig(k=SPEC_K)
    kw = dict(max_new_tokens=new, cache_layout="paged", block_size=16,
              vocab_limit=VOCAB_LIMIT, seed=5, device=dev)
    prompt0 = torch.as_tensor(sweeps["repetition"][0]).to(dev)
    tgen.generate(params, prompt0, cfg, spec=spec, **dict(kw,
                                                          max_new_tokens=4))
    torch.cuda.synchronize()
    out, paths = {}, {}
    for sweep, (prompt_np, temp) in sweeps.items():
        prompt = torch.as_tensor(prompt_np).long().to(dev)
        skw = dict(kw, temperature=temp)
        reg = tel.configure()
        try:
            # --- the main path: counts reset just before, read just after
            with CountCalls(tspec, "spec_round") as rounds:
                ku.reset_launch_counts()
                toks = tgen.generate(params, prompt, cfg, spec=spec, **skw)
                torch.cuda.synchronize()
                counts = ku.launch_counts()
            stats = {n: reg.counter(f"generate.spec.{n}").value
                     for n in SPEC_COUNTERS}
        finally:
            tel.shutdown()
        R = rounds.n
        want = {k: 0 for k in ku.KERNELS}
        want.update(layer_norm_fwd=(2 * L + 1) * (1 + R),
                    flash_attention_fwd=L,
                    fused_sample=1 if temp > 0 else 0)
        check(counts == want, f"spec generate {sweep}: launches {counts} != "
                              f"{want} ({R} rounds)")
        check(-(-(new - 1) // (SPEC_K + 1)) <= R <= new - 1,
              f"spec generate {sweep}: {R} rounds for {new} tokens")
        check(tuple(toks.shape) == (b, s + new)
              and int(toks[:, s:].max()) < VOCAB_LIMIT,
              f"spec generate {sweep}: shape or vocab")
        off = tgen.generate(params, prompt, cfg, **skw)
        ties = []
        if temp == 0.0:
            for i in range(b):
                diff = (toks[i, s:] != off[i, s:]).nonzero()
                if diff.numel():
                    j = int(diff[0])
                    t = spec_tie(params, cfg, prompt[i], off[i, s:], j,
                                 int(toks[i, s + j]), int(off[i, s + j]),
                                 dev)
                    ties.append(dict(t, row=i))
                    check(t["near_tie"], f"spec generate row {i} step {j}: "
                                         f"not a near-tie {t}")
        else:
            again = tgen.generate(params, prompt, cfg, spec=spec, **skw)
            check(torch.equal(again, toks), "sampled spec generate is not "
                                            "reproducible under one seed")

        def prefill_only():
            cache = tgen.init_kv_cache(cfg, b, s + new + SPEC_K + 1,
                                       cache_layout="paged", block_size=16,
                                       device=dev)
            tgen.prefill(params, prompt, cfg, cache=cache, device=dev)

        pf = quartiles([wall_ms(prefill_only)
                        for _ in range(SPEC_TIMED_RUNS)])[1]
        on_ms = quartiles([wall_ms(lambda: tgen.generate(
            params, prompt, cfg, spec=spec, **skw))
            for _ in range(SPEC_TIMED_RUNS)])[1]
        off_ms = quartiles([wall_ms(lambda: tgen.generate(
            params, prompt, cfg, **skw)) for _ in range(SPEC_TIMED_RUNS)])[1]
        row = {
            "temperature": temp, "rounds": R, "counters": stats,
            "accept_rate": stats["accepted_tokens"] / stats["draft_tokens"],
            "tokens_per_verify": (stats["accepted_tokens"]
                                  + stats["verify_calls"])
            / stats["verify_calls"],
            "k1_launches_per_round": 2 * L + 1,
            "prefill_ms": pf, "generate_ms_spec": on_ms,
            "generate_ms_off": off_ms,
            "decode_tokens_per_s_spec": b * (new - 1) / ((on_ms - pf) / 1e3),
            "decode_tokens_per_s_off": b * (new - 1) / ((off_ms - pf) / 1e3),
            "greedy_rows_identical_to_off": (b - len(ties) if temp == 0.0
                                             else None),
            "near_ties": ties}
        out[sweep] = row
        paths[f"spec generate {sweep}"] = counts
        print(f"spec generate {sweep}: {json.dumps(row)}")
    return out, paths


# the spec engine and the host tier on the engine geometry and mix
SPEC_ENGINE_RUNS = (("float", None), ("quantized", "int8"))
HOST_TIER_BYTES = 1 << 30


def spec_engine_phase(dev):
    """``ServingEngine(spec="ngram")`` (k 8) on GPT-2 125M under the engine
    mix, float + native and quantized + int8: the eager engine and the
    graph engine (the spec round as the captured ``decode`` entry) on the
    same requests and generator, with identical tokens, finish reasons and
    launches; exact launches (K1 2L+1 a round and a prefill, K2 L a
    prefill, row 10 four a layer on every round and prefill by route, no
    paged kernel); a clean ledger; the spec counters; a profiled graph run
    with the verify gather's device time (``aten::index``)."""
    from apex_tpu_torch.models.speculative import SpecConfig
    from apex_tpu_torch.observability import metrics as tel
    from apex_tpu_torch.ops import _kernel_utils as ku
    from apex_tpu_torch.ops.dense import DECODE_ROWS
    from apex_tpu_torch.serving import ServingEngine, warmup_ladder

    cfg, weights = _engine_weights(dev)
    L = cfg.num_layers
    reqs = engine_requests(cfg.vocab_size)
    sampled = sum(1 for kw in reqs if kw.get("temperature", 0.0) > 0)

    def engine(wname, wire, d=None, **kw):
        return ServingEngine(weights[wname], cfg, cache_wire=wire,
                             spec=SpecConfig(k=SPEC_K),
                             generator=torch.Generator().manual_seed(0),
                             compile_cache_dir=d, device=dev,
                             **dict(ENGINE_KW, **kw))

    out, paths = {}, {}
    for wname, wire in SPEC_ENGINE_RUNS:
        name = f"{wname} weights, {wire or 'native'} pool"
        engine(wname, wire).run([dict(reqs[0], max_new_tokens=2),
                                 dict(reqs[2], max_new_tokens=2)])
        runs = {}
        for kind in ("eager", "graph"):
            eng = engine(wname, wire,
                         _fresh_dir(f"spec-{wname}") if kind == "graph"
                         else None)
            ladder = warmup_ladder(eng) if kind == "graph" else None
            reg = tel.configure()
            try:
                with PrefillBuckets() as pb:
                    ku.reset_launch_counts()
                    resps, wall, dec = drive_steps(eng, reqs)
                    counts = ku.launch_counts()
                stats = {n: reg.counter(f"generate.spec.{n}").value
                         for n in SPEC_COUNTERS}
            finally:
                tel.shutdown()
            check_responses(eng, reqs, resps, f"spec engine {name} {kind}")
            st = eng.stats()
            D, P = st["decode_steps"], st["prefill_calls"]
            want = {k: 0 for k in ku.KERNELS}
            want.update(layer_norm_fwd=(D + P) * (2 * L + 1),
                        flash_attention_fwd=P * L, fused_sample=sampled)
            if wname == "quantized":
                short = sum(1 for bk in pb.buckets if bk <= DECODE_ROWS)
                want.update(dense_int8_decode=short * 4 * L,
                            dense_int8=(D + P - short) * 4 * L)
            check(counts == want, f"spec engine {name} {kind}: launches "
                                  f"{counts} != {want} ({D} rounds, {P} "
                                  "prefills)")
            runs[kind] = dict(resps=resps, wall=wall, dec=dec, counts=counts,
                              stats=stats, eng=eng, ladder=ladder, D=D)
        e, g = runs["eager"], runs["graph"]
        for a, c in zip(e["resps"], g["resps"]):
            check(a.tokens.tolist() == c.tokens.tolist()
                  and a.finish_reason == c.finish_reason,
                  f"spec graph engine {name}: request {a.request_id} "
                  "differs from the eager engine's")
        check(g["counts"] == e["counts"] and g["stats"] == e["stats"],
              f"spec graph engine {name}: launches or counters differ")
        check(g["ladder"]["labels"][-1] == "decode"
              and [x for x, _ in g["ladder"]["skipped"]] == ["sample"],
              f"spec graph engine {name}: ladder {g['ladder']}")
        check(g["eng"].stats()["compile_cache"]["replays"] > 0,
              f"spec graph engine {name}: nothing replayed")
        stats = g["stats"]
        row = {
            "gen_tokens_per_s_eager": sum(r.tokens.size for r in e["resps"])
            / (e["wall"] / 1e3),
            "gen_tokens_per_s_graph": sum(r.tokens.size for r in g["resps"])
            / (g["wall"] / 1e3),
            "decode_ms_per_step_eager": pct(e["dec"], 0.5),
            "decode_ms_per_step_graph": pct(g["dec"], 0.5),
            "decode_steps": g["D"], "counters": stats,
            "accept_rate": stats["accepted_tokens"] / stats["draft_tokens"],
            "tokens_per_verify": (stats["accepted_tokens"]
                                  + stats["verify_calls"])
            / stats["verify_calls"],
            "ladder_labels": g["ladder"]["labels"]}
        if wname == "float":
            # the eager run names the ops that launched the device time
            # (the verify gathers are aten::index); the graph run's replays
            # show kernels only
            for kind, d in (("eager", None),
                            ("graph", _fresh_dir(f"spec-{wname}"))):
                eng = engine(wname, wire, d)
                if d is not None:
                    warmup_ladder(eng)
                for kw in reqs:
                    eng.submit(**kw)
                t_p, busy, top, by_cat, by_op = profile_busy(eng.run)
                check(eng.idle, f"profiled spec engine {name} {kind} did "
                                "not drain")
                row[f"profiled_{kind}"] = {
                    "wall_ms": t_p, "decode_steps": eng.stats()[
                        "decode_steps"],
                    "device_busy_ms": busy if busy > 0 else "not measured",
                    "device_idle_share": (1 - busy / t_p) if busy > 0
                    else "not measured",
                    "verify_gather_device_ms": (
                        by_op.get("aten::index", "not measured")
                        if kind == "eager" else "not measured"),
                    "device_ms_by_category": by_cat, "device_top_ms": top,
                    "device_ms_by_op": by_op}
                del eng
        out[name] = row
        paths[f"spec engine {name}"] = e["counts"]
        paths[f"spec graph engine {name}"] = g["counts"]
        print(f"spec engine {name}: {json.dumps(row)}")
        del runs, e, g
        gc.collect()
        torch.cuda.empty_cache()
    return out, paths


def tier_requests(vocab):
    """The starved run's requests (one 768-token prompt and eight 32-token
    ones), all greedy, so that tokens compare bit for bit."""
    reqs = engine_requests(vocab)
    return [dict(kw, temperature=0.0) for kw in [reqs[0]] + reqs[2:10]]


def shared_prefix_requests(vocab):
    """bench.py:1468-1471's shared-system-prompt trace at gpt_125m's
    vocabulary: four sequential arrivals sharing a 64-token system prefix
    with 8 private tokens each, 8 new tokens."""
    import numpy as np

    rng = np.random.RandomState(18)
    system = rng.randint(0, vocab, (64,))
    return [dict(prompt=np.concatenate([system, rng.randint(0, vocab, (8,))]),
                 max_new_tokens=8) for _ in range(4)]


def host_tier_phase(dev):
    """The host-DRAM tier on GPT-2 125M, float weights, native bf16 pool,
    raw wire: the starved pool (STARVED_BLOCKS blocks) preempts; with the
    tier the resumes page in (no replay) and the greedy tokens equal an
    unstarved engine's bit for bit (decode-written K/V kept), where the
    tier-off engine replays the prefill (K/V recomputed; near-ties may
    flip); page-in ms per resume against the replay's prefill ms; then the
    shared-system-prompt trace (chunked, 32-token chunks), where the
    tier's digest hits page the cold prefix back in."""
    from apex_tpu_torch.observability import metrics as tel
    from apex_tpu_torch.ops import _kernel_utils as ku
    from apex_tpu_torch.serving import ServingEngine

    cfg, weights = _engine_weights(dev)
    reqs = tier_requests(cfg.vocab_size)

    def engine(**kw):
        return ServingEngine(weights["float"], cfg,
                             generator=torch.Generator().manual_seed(0),
                             device=dev, **dict(ENGINE_KW, **kw))

    base, _, _ = drive_engine(engine(), reqs)
    runs = {}
    for mode, kw in (("off", {}), ("on", dict(host_tier_bytes=HOST_TIER_BYTES,
                                               host_tier_wire="raw"))):
        reg = tel.configure()
        try:
            eng = engine(num_blocks=STARVED_BLOCKS, **kw)
            ku.reset_launch_counts()
            resps, wall, hw = drive_engine(eng, reqs)
            counts = ku.launch_counts()
            tier = {n: reg.counter(f"serving.host_tier.{n}").value
                    for n in ("page_ins", "resumes", "replays")}
        finally:
            tel.shutdown()
        check_responses(eng, reqs, resps, f"starved engine, tier {mode}")
        check(eng.stats()["preemptions"] >= 1,
              f"starved engine, tier {mode}: never preempted")
        runs[mode] = dict(resps=resps, wall=wall, counts=counts, tier=tier,
                          st=eng.stats())
    on, off = runs["on"], runs["off"]
    check(on["tier"]["resumes"] >= 1 and on["tier"]["replays"] == 0,
          f"tier on: resumes {on['tier']}")
    for a, c in zip(on["resps"], base):
        check(a.tokens.tolist() == c.tokens.tolist(),
              f"tier on: request {a.request_id} differs from the unstarved "
              "engine's (a page-in resume keeps the K/V bit for bit)")
    same_off = sum(a.tokens.tolist() == c.tokens.tolist()
                   for a, c in zip(on["resps"], off["resps"]))
    paged = [r.prefill_ms for r in on["resps"] if r.preemptions]
    replayed = [r.prefill_ms for r in off["resps"] if r.preemptions]
    row = {
        "preemptions_on": on["st"]["preemptions"],
        "preemptions_off": off["st"]["preemptions"],
        "tier_counters": on["tier"], "tier_stats": on["st"]["host_tier"],
        "requests_identical_to_unstarved": len(reqs),
        "requests_identical_tier_on_vs_off": same_off,
        "page_in_ms_per_resume_p50": pct(paged, 0.5),
        "replay_prefill_ms_p50": pct(replayed, 0.5),
        "wall_ms_on": on["wall"], "wall_ms_off": off["wall"]}
    # --- the shared-system-prompt trace: sequential arrivals ------------
    shared = shared_prefix_requests(cfg.vocab_size)
    trace = {}
    for mode, kw in (("off", {}), ("on", dict(host_tier_bytes=HOST_TIER_BYTES))):
        eng = ServingEngine(weights["float"], cfg, max_slots=2, max_len=128,
                            prompt_buckets=(96,), cache_layout="paged",
                            block_size=16, chunk_tokens=32, device=dev,
                            generator=torch.Generator().manual_seed(0), **kw)
        toks, ttft = [], []
        for r in shared:
            resps, _, _ = drive_engine(eng, [r])
            toks += [x.tokens.tolist() for x in resps]
            ttft += [x.ttft_ms for x in resps]
        check(eng.stats()["blocks_in_use"] == 0,
              f"shared-prefix trace, tier {mode}: ledger not clean")
        trace[mode] = dict(tokens=toks, ttft_ms_p95=pct(ttft, 0.95),
                           host=eng.stats().get("host_tier"))
    check(trace["on"]["host"]["hits"] >= 1,
          f"shared-prefix trace: no host-tier digest hit {trace['on']}")
    check(trace["on"]["tokens"] == trace["off"]["tokens"],
          "shared-prefix trace: tokens differ with the tier on")
    row["shared_prefix"] = {
        "host_hits": trace["on"]["host"]["hits"],
        "host_pages": trace["on"]["host"]["pages"],
        "ttft_ms_p95_on": trace["on"]["ttft_ms_p95"],
        "ttft_ms_p95_off": trace["off"]["ttft_ms_p95"]}
    print(f"host tier: {json.dumps(row)}")
    return row, {"host tier engine": on["counts"]}


def foreign_pool_phase(dev):
    """fp32 compute over a bf16 pool (``cache_dtype``): ``generate`` on
    GPT-2 125M (K3 with an fp32 query over the bf16 pool, exact launches,
    teacher-forced logits kernel vs plain) and the engine on the mix's
    short requests (K3 every step, a clean ledger, greedy tokens against
    the plain engine's or a near-tie at the first difference)."""
    from apex_tpu_torch.models import generate as tgen
    from apex_tpu_torch.models.config import gpt_125m
    from apex_tpu_torch.models.transformer_lm import init_gpt_params
    from apex_tpu_torch.ops import _kernel_utils as ku
    from apex_tpu_torch.serving import ServingEngine

    cfg = gpt_125m(compute_dtype=torch.float32)
    L = cfg.num_layers
    params = init_gpt_params(cfg, torch.Generator().manual_seed(0), dev)
    b, new = 4, 16
    lens = PROMPT_LENS[:b]
    gen = torch.Generator().manual_seed(1)
    prompt = torch.zeros(b, max(lens), dtype=torch.long)
    for i, n in enumerate(lens):
        prompt[i, :n] = torch.randint(0, VOCAB_LIMIT, (n,), generator=gen)
    prompt = prompt.to(dev)
    plens = torch.tensor(lens, device=dev)
    kw = dict(max_new_tokens=new, prompt_lens=plens, cache_layout="paged",
              block_size=16, cache_dtype=torch.bfloat16, device=dev)
    tgen.generate(params, prompt, cfg, **dict(kw, max_new_tokens=2))
    ku.reset_launch_counts()
    toks = tgen.generate(params, prompt, cfg, **kw)
    torch.cuda.synchronize()
    g_counts = ku.launch_counts()
    want = {k: 0 for k in ku.KERNELS}
    want.update(layer_norm_fwd=(2 * L + 1) * new, flash_attention_fwd=L,
                fused_decode_layer=L * (new - 1))
    check(g_counts == want, f"fp32 over bf16 generate: launches {g_counts} "
                            f"!= {want}")
    plain = tgen.generate(params, prompt, cfg, backend="reference", **kw)

    def forced(backend):
        cache = tgen.init_kv_cache(cfg, b, max(lens) + new,
                                   cache_dtype=torch.bfloat16,
                                   cache_layout="paged", block_size=16,
                                   device=dev)
        lg, cache = tgen.prefill(params, prompt, cfg, prompt_lens=plens,
                                 cache=cache, device=dev, backend=backend)
        outs = [lg]
        for j in range(new - 1):
            tok = toks[torch.arange(b, device=dev), plens + j]
            lg, cache = tgen.decode_step(params, tok, cache, cfg, device=dev,
                                         backend=backend)
            outs.append(lg)
        return torch.stack(outs, 1)[..., :VOCAB_LIMIT]

    logit_err = max_err(forced(None), forced("reference"))
    check(logit_err <= LOGIT_TOL, f"fp32 over bf16 generate: kernel vs "
                                  f"plain logits {logit_err}")
    rows_same = sum(torch.equal(toks[i], plain[i]) for i in range(b))
    # the engine: 32 lanes over a bf16 pool, fp32 compute
    reqs = [dict(kw2, temperature=0.0)
            for kw2 in engine_requests(cfg.vocab_size)[2:10]]
    eng = ServingEngine(params, cfg, cache_dtype=torch.bfloat16,
                        generator=torch.Generator().manual_seed(0),
                        device=dev, **ENGINE_KW)
    eng.run([dict(reqs[0], max_new_tokens=2)])
    eng = ServingEngine(params, cfg, cache_dtype=torch.bfloat16,
                        generator=torch.Generator().manual_seed(0),
                        device=dev, **ENGINE_KW)
    ku.reset_launch_counts()
    resps, wall, _ = drive_engine(eng, reqs)
    e_counts = ku.launch_counts()
    check_responses(eng, reqs, resps, "fp32 over bf16 engine")
    check(eng.cache["k"].dtype == torch.bfloat16, "engine pool not bf16")
    st = eng.stats()
    D, P = st["decode_steps"], st["prefill_calls"]
    want = {k: 0 for k in ku.KERNELS}
    want.update(layer_norm_fwd=(D + P) * (2 * L + 1),
                flash_attention_fwd=P * L, fused_decode_layer=D * L)
    check(e_counts == want, f"fp32 over bf16 engine: launches {e_counts} "
                            f"!= {want}")
    ref = ServingEngine(params, cfg, cache_dtype=torch.bfloat16,
                        generator=torch.Generator().manual_seed(0),
                        device=dev, backend="reference", **ENGINE_KW)
    rresps = ref.run(reqs)
    same = sum(a.tokens.tolist() == c.tokens.tolist()
               for a, c in zip(resps, rresps))
    flips = {}
    for a, c in zip(resps, rresps):
        if int(a.tokens[0]) != int(c.tokens[0]):
            flips[a.request_id] = first_token_tie(
                eng, reqs[a.request_id]["prompt"], int(a.tokens[0]),
                int(c.tokens[0]), dev)
    check(all(f["near_tie"] for f in flips.values()),
          f"fp32 over bf16 engine: first tokens differ beyond a near-tie "
          f"{flips}")
    row = {"generate_logit_err": logit_err,
           "generate_rows_identical_to_plain": (rows_same, b),
           "engine_requests_identical_to_plain": (same, len(reqs)),
           "engine_first_token_near_ties": flips,
           "engine_gen_tokens_per_s": sum(r.tokens.size for r in resps)
           / (wall / 1e3)}
    print(f"fp32 compute over a bf16 pool: {json.dumps(row)}")
    return row, {"fp32 over bf16 generate": g_counts,
                 "fp32 over bf16 engine": e_counts}


def adapter_suite(cfg, n, dev, seed=0):
    """Adapters 1..n, adapter ``aid`` drawn from a generator seeded
    ``seed * 100003 + aid`` (the JAX package's ``build_adapter_suite``
    contract): rank 8, all four targets, B at std 0.02."""
    from apex_tpu_torch.models.lora import init_lora_adapter

    return {aid: init_lora_adapter(
                torch.Generator().manual_seed(seed * 100_003 + aid), cfg,
                rank=LORA_RANK, b_std=0.02, device=dev)
            for aid in range(1, n + 1)}


def lora_requests():
    """64 prompts of 16-256 tokens, 32 new tokens each; request i serves
    adapter i + 1, every 8th the base model; 8 sampled at 0.8."""
    import numpy as np

    rng = np.random.RandomState(2)
    return [dict(prompt=rng.randint(0, VOCAB_LIMIT,
                                    (int(rng.randint(16, 257)),)),
                 max_new_tokens=LORA_NEW,
                 adapter_id=0 if i % 8 == 7 else i + 1,
                 temperature=0.8 if i % 8 == 3 else 0.0)
            for i in range(LORA_REQUESTS)]


def lora_forced_logits(params, cfg, suite, reqs, resps, wire, backend, dev):
    """Teacher-forced LoRA decode over the kernel run's greedy streams:
    the first FORCED_BATCH greedy adapter requests' prompts through one
    ``decode_verify`` (each row its own adapter), then ``decode_step`` fed
    their generated tokens → logits [b, steps + 1, v]."""
    from apex_tpu_torch.models import generate as tgen
    from apex_tpu_torch.models.lora import stack_adapter_slabs

    ids = [i for i, kw in enumerate(reqs)
           if kw["temperature"] == 0.0 and kw["adapter_id"]][:FORCED_BATCH]
    lens = [reqs[i]["prompt"].size for i in ids]
    prompt = torch.zeros(len(ids), max(lens), dtype=torch.long)
    for row, i in enumerate(ids):
        prompt[row, :lens[row]] = torch.as_tensor(reqs[i]["prompt"])
    prompt = prompt.to(dev)
    steps = min(resps[i].tokens.size for i in ids) - 1
    toks = torch.stack([torch.as_tensor(resps[i].tokens[:steps]).long()
                        for i in ids]).to(dev)
    b = len(ids)
    lora = {"idx": torch.arange(1, b + 1, dtype=torch.int32, device=dev),
            "slabs": stack_adapter_slabs(
                [suite[reqs[i]["adapter_id"]] for i in ids], cfg)}
    cache = tgen.init_kv_cache(cfg, b, prompt.shape[1] + steps + 1,
                               cache_layout="paged", block_size=16,
                               cache_wire=wire, device=dev)
    vlog, cache = tgen.decode_verify(params, prompt, cache, cfg, lora=lora,
                                     device=dev, backend=backend)
    last = torch.tensor(lens, device=dev) - 1
    out = [vlog[torch.arange(b, device=dev), last]]
    # continue each row from its own length (the padding behind is masked)
    cache["pos"] = (last + 1).to(torch.int32)
    for j in range(steps):
        logits, cache = tgen.decode_step(params, toks[:, j], cache, cfg,
                                         lora=lora, device=dev,
                                         backend=backend)
        out.append(logits)
    return torch.stack(out, 1)[..., :VOCAB_LIMIT]


def lora_engine_phase(dev):
    """Multi-tenant LoRA on the paged ServingEngine, GPT-2 125M's widths
    at LORA_LAYERS layers: float weights + bf16 pool and quantize_params
    weights + int8 pool, each with exact launch identities, a clean block
    ledger and adapter pool, LRU churn, first tokens against the plain
    engine and teacher-forced kernel-vs-plain logits; a merged
    single-adapter engine on the same requests; one profiled run."""
    from apex_tpu_torch.models.config import gpt_125m
    from apex_tpu_torch.models.lora import merge_lora
    from apex_tpu_torch.models.quantized import quantize_params
    from apex_tpu_torch.models.transformer_lm import init_gpt_params
    from apex_tpu_torch.ops import _kernel_utils as ku
    from apex_tpu_torch.serving import AdapterPool, ServingEngine

    t_phase = time.perf_counter()
    cfg = gpt_125m(num_layers=LORA_LAYERS)
    L = cfg.num_layers
    weights = {"float": init_gpt_params(cfg, torch.Generator().manual_seed(0),
                                        dev)}
    weights["quantized"] = quantize_params(weights["float"])
    suite = adapter_suite(cfg, LORA_ADAPTERS, dev)
    reqs = lora_requests()
    greedy = [i for i, kw in enumerate(reqs) if kw["temperature"] == 0.0]

    def engine(wname, wire, **kw):
        pool = AdapterPool(cfg, slots=LORA_SLOTS)
        for aid, ad in suite.items():
            pool.register(aid, ad)
        return ServingEngine(weights[wname], cfg, cache_wire=wire,
                             adapter_pool=pool,
                             generator=torch.Generator().manual_seed(0),
                             device=dev, **dict(ENGINE_KW, **kw))

    def slo(resps):
        ttft = [r.ttft_ms for r in resps]
        tpot = [r.tpot_ms for r in resps]
        return {"ttft_ms_p50": pct(ttft, 0.5), "ttft_ms_p95": pct(ttft, 0.95),
                "tpot_ms_p50": pct(tpot, 0.5), "tpot_ms_p95": pct(tpot, 0.95)}

    warm = [dict(reqs[0], max_new_tokens=2), dict(reqs[7], max_new_tokens=2)]
    out = {}
    for wname, wire in LORA_RUNS:
        name = f"lora {wname} weights, {wire or 'native'} pool"
        engine(wname, wire).run(warm)
        eng = engine(wname, wire)
        # --- the main path: counts reset just before, read just after ---
        with PrefillBuckets() as pb:
            ku.reset_launch_counts()
            resps, wall, hw = drive_engine(eng, reqs)
            counts = ku.launch_counts()
        st = eng.stats()
        D, P = st["decode_steps"], st["prefill_calls"]
        # adapter prefills: every admission of an adapter request,
        # re-admissions after a preemption included
        PA = sum(1 + r.preemptions for r, kw in zip(resps, reqs)
                 if kw["adapter_id"])
        want = {k: 0 for k in ku.KERNELS if k != "fused_sample"}
        want.update(layer_norm_fwd=(D + P) * (2 * L + 1),
                    flash_attention_fwd=(P - PA) * L,
                    ragged_paged_attention=D * L,
                    grouped_matmul=(D + PA) * L * 8)
        if wname == "quantized":
            want.update(pb.row10(D, P, L))
        got = {k: v for k, v in counts.items() if k != "fused_sample"}
        check(got == want, f"engine {name}: launches {got} != {want} ({D} "
                           f"decode steps, {P} prefill calls, {PA} adapter)")
        check_responses(eng, reqs, resps, f"engine {name}")
        ps = st["adapter_pool"]
        census = eng._adapters.census()
        check(ps["pinned_refs"] == 0 and census["pinned"] == 0
              and ps["evictions"] >= 1,
              f"engine {name}: adapter pool not clean or never churned: "
              f"{ps} {census}")
        ref = engine(wname, wire, backend="reference")
        rresps = ref.run(reqs)
        check_responses(ref, reqs, rresps, f"plain engine {name}")
        flips = {}
        for i in greedy:
            tk, tp = int(resps[i].tokens[0]), int(rresps[i].tokens[0])
            if tk == tp:
                continue
            aid = reqs[i]["adapter_id"]
            if aid:
                lk, lp = (e.adapter_prefill_logits(reqs[i]["prompt"],
                                                   aid)[:VOCAB_LIMIT]
                          for e in (eng, ref))
                flips[i] = tie_verdict(lk, lp, tk, tp)
            else:
                flips[i] = first_token_tie(eng, reqs[i]["prompt"], tk, tp,
                                           dev)
        check(all(f["near_tie"] for f in flips.values()),
              f"engine {name}: first tokens differ from the plain "
              f"engine's beyond a bf16 near-tie: {flips}")
        same = sum(int((resps[i].tokens == rresps[i].tokens).sum())
                   for i in greedy)
        total = sum(resps[i].tokens.size for i in greedy)
        lk = lora_forced_logits(weights[wname], cfg, suite, reqs, resps,
                                wire, None, dev)
        lp = lora_forced_logits(weights[wname], cfg, suite, reqs, resps,
                                wire, "reference", dev)
        forced = max_err(lk, lp)
        check(forced <= LOGIT_TOL,
              f"engine {name}: teacher-forced LoRA logits kernel vs plain "
              f"differ by {forced} > {LOGIT_TOL}")
        row = dict(slo(resps), **{
            "wall_ms": wall,
            "gen_tokens_per_s": sum(r.tokens.size for r in resps)
            / (wall / 1e3),
            "decode_steps": D, "prefill_calls": P,
            "adapter_prefill_calls": PA,
            "max_concurrent_requests": hw,
            "blocks_high_water": st["blocks_high_water"],
            "preemptions": st["preemptions"],
            "adapter_pool": {k: ps[k] for k in (
                "slots", "hits", "misses", "evictions", "resident",
                "pinned_refs", "pool_bytes")},
            "greedy_tokens_identical_to_plain": same / total,
            "greedy_first_tokens_identical": (len(greedy) - len(flips),
                                              len(greedy)),
            "first_token_near_ties": flips,
            "forced_logit_err": forced,
            "counts": counts,
        })
        out[name] = row
        print(f"engine {name}: {json.dumps(row)}")

    # --- the same requests on one merged adapter, no pool (K3 decodes) ---
    merged = merge_lora(weights["float"], cfg, suite[1])
    base_reqs = [{k: v for k, v in kw.items() if k != "adapter_id"}
                 for kw in reqs]

    def merged_engine():
        return ServingEngine(merged, cfg,
                             generator=torch.Generator().manual_seed(0),
                             device=dev, **ENGINE_KW)

    merged_engine().run([{k: v for k, v in kw.items() if k != "adapter_id"}
                         for kw in warm])
    mresps, mwall, mhw = drive_engine(merged_engine(), base_reqs)
    mrow = dict(slo(mresps), wall_ms=mwall,
                gen_tokens_per_s=sum(r.tokens.size for r in mresps)
                / (mwall / 1e3), max_concurrent_requests=mhw)
    batched = out["lora float weights, native pool"]
    mrow["batched_over_merged"] = (batched["gen_tokens_per_s"]
                                   / mrow["gen_tokens_per_s"])
    out["merged adapter 1, float weights, native pool"] = mrow
    print(f"engine merged single adapter: {json.dumps(mrow)}")

    # --- device idle share: one profiled LoRA run, float weights ---------
    eng = engine("float", None)
    for kw in reqs:
        eng.submit(**kw)
    t_prof, busy, top, by_cat, by_op = profile_busy(eng.run)
    check(eng.idle, "profiled LoRA engine run did not drain")
    out["profiled lora float weights, native pool"] = {
        "wall_ms": t_prof, "device_busy_ms": busy if busy > 0
        else "not measured",
        "device_idle_share": (1 - busy / t_prof) if busy > 0
        else "not measured",
        "device_top_ms": top, "device_ms_by_category": by_cat,
        "device_ms_by_op": by_op}
    out["phase_wall_s"] = time.perf_counter() - t_phase
    return out


def lora_oracle_phase(dev):
    """At fp32 (GPT-2 125M widths, 2 layers): 8 tenants, 8 greedy requests
    through a 4-slot pool; each stream equals its tenant's merged-weights
    ``generate`` stream, or first diverges where the merged model's two
    logits lie within ORACLE_TIE."""
    import numpy as np

    from apex_tpu_torch.models import generate as tgen
    from apex_tpu_torch.models.config import gpt_125m
    from apex_tpu_torch.models.lora import merge_lora
    from apex_tpu_torch.models.transformer_lm import init_gpt_params
    from apex_tpu_torch.serving import AdapterPool, ServingEngine

    cfg = gpt_125m(num_layers=ORACLE_LAYERS, compute_dtype=torch.float32)
    params = init_gpt_params(cfg, torch.Generator().manual_seed(0), dev)
    suite = adapter_suite(cfg, ORACLE_TENANTS, dev)
    rng = np.random.RandomState(3)
    reqs = [dict(prompt=rng.randint(0, VOCAB_LIMIT,
                                    (int(rng.randint(16, 129)),)),
                 max_new_tokens=ORACLE_NEW, adapter_id=aid)
            for aid in range(1, ORACLE_TENANTS + 1)]
    pool = AdapterPool(cfg, slots=ORACLE_SLOTS)
    for aid, ad in suite.items():
        pool.register(aid, ad)
    eng = ServingEngine(params, cfg, adapter_pool=pool,
                        max_slots=ORACLE_TENANTS, cache_layout="paged",
                        block_size=16, vocab_limit=VOCAB_LIMIT, device=dev)
    resps = eng.run(reqs)
    check(len(resps) == len(reqs) and pool.stats()["pinned_refs"] == 0,
          "fp32 LoRA engine did not drain clean")
    report = {}
    for r, kw in zip(resps, reqs):
        merged = merge_lora(params, cfg, suite[kw["adapter_id"]])
        prompt = torch.as_tensor(kw["prompt"][None], device=dev)
        want = tgen.generate(merged, prompt, cfg, max_new_tokens=ORACLE_NEW,
                             cache_layout="paged", vocab_limit=VOCAB_LIMIT,
                             device=dev)[0, prompt.shape[1]:].cpu().numpy()
        diff = np.nonzero(r.tokens != want)[0]
        if not diff.size:
            report[kw["adapter_id"]] = "identical"
            continue
        d = int(diff[0])
        ctx = torch.cat([prompt[0], torch.as_tensor(
            r.tokens[:d], device=dev).long()])[None]
        cache = tgen.init_kv_cache(cfg, 1, ctx.shape[1], device=dev)
        logits, _ = tgen.decode_verify(merged, ctx, cache, cfg, device=dev,
                                       backend="reference")
        gap = abs(float(logits[0, -1, int(want[d])]
                        - logits[0, -1, int(r.tokens[d])]))
        report[kw["adapter_id"]] = {"first_divergence": d,
                                    "engine_token": int(r.tokens[d]),
                                    "merged_token": int(want[d]),
                                    "merged_logit_gap": gap}
        check(gap <= ORACLE_TIE,
              f"fp32 LoRA stream of adapter {kw['adapter_id']} leaves its "
              f"merged oracle at step {d} by a logit gap {gap} > "
              f"{ORACLE_TIE}")
    return {"streams": report, "adapter_pool": pool.stats(),
            "identical": sum(v == "identical" for v in report.values())}


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
    # the pair as one function: 10·d flops per open pair (s, dp, dq, dk,
    # dv), each of q, k, v, do, dq, dk, dv, lse and delta moved once
    pair_b, pair_by = bound(7 * b * s * n * d * 2 + stats, 10 * d * pairs,
                            PEAK_BF16_FLOPS)
    pair = {"ms": time_ms(lambda: (tfa.flash_bwd_dq(ops, causal=True),
                                   tfa.flash_bwd_dkv(ops, causal=True))),
            "plain_ms": plain_ms, "library_ms": lib_ms,
            "bound_ms": pair_b, "bound_by": pair_by}
    common = {"err": abs_err, "rel_err": max(errs.values()),
              "tol": FLASH_BWD_TOL, "detail": errs,
              "plain_ms": plain_ms, "library_ms": lib_ms,
              "variants": {"pair K6 + K7 (dq, dk, dv: the function)": pair}}
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
                 "flash_attention_bwd_dkv": L, **ADAM_TAIL})
    check(counts == want, f"train-step launches {counts} != {want}")
    print(f"launches (one train step): {counts}")

    step_ms = [wall_ms(one) for _ in range(TRAIN_STEPS)]
    q1, med, q3 = quartiles(step_ms)
    t_prof, busy, top, by_cat, by_op = profile_busy(one)
    tail = {"kernels": profile_tail(one)}
    # the same step with the plain tail (the per-leaf torch composition):
    # the model on the kernel path, make_train_step(backend="reference")
    from apex_tpu_torch.amp.frontend import make_train_step
    from apex_tpu_torch.models.transformer_lm import gpt_loss

    _, plain_step = make_train_step(
        lambda p, t, lab: gpt_loss(p, t, lab, cfg), fused_adam(lr=1e-4), "O2",
        device=dev, backend="reference")
    plain_state = state

    def one_plain():
        nonlocal plain_state
        plain_state, _ = plain_step(plain_state, tokens, labels)

    one_plain()
    tail["plain"] = profile_tail(one_plain)
    plain_ms = [wall_ms(one_plain) for _ in range(3)]
    del plain_state
    # the tail's least bytes: the unscale reads and writes each fp32
    # gradient; Adam reads g, p, m, v and writes p, m, v and the fp16 copy
    tail["bound_ms"] = {"unscale_device_ms": 8 * n_params / PEAK_BYTES_PER_S
                        * 1e3,
                        "tail_device_ms": 30 * n_params / PEAK_BYTES_PER_S
                        * 1e3}
    tail["plain_tail_step_ms"] = plain_ms
    losses = [float(m["loss"]) for m in traj]
    scales = [float(m["loss_scale"]) for m in traj]
    overflow = [bool(m["overflow"]) for m in traj]
    check(all(math.isfinite(x) for x in losses), f"losses {losses}")
    check(not all(overflow), "every train step overflowed")
    tokens_per_s = TRAIN_BATCH * TRAIN_SEQ / (med / 1e3)
    flops_per_tok = 6 * n_params + 12 * L * cfg.hidden_size * TRAIN_SEQ
    return {"tail": tail,
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


NORM_KEYS = ("grad_norm", "update_norm", "param_norm")


def train_check(dev):
    """3 steps at b4 x s1024 from one state on the kernel path and on the
    plain path (backend="reference"), both with norm_telemetry=True:
    per-step loss, identical scaler decisions, global grad norm within
    GRAD_NORM_RTOL, and the step's grad, update and param norms within
    GRAD_NORM_RTOL."""
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
                                         grad_postprocess=post,
                                         norm_telemetry=True)
        if state0 is None:
            state0 = init(torch.Generator().manual_seed(0))
        state, seq, step_norms = state0, [], []
        for _ in range(CHECK_STEPS):
            state, m = step(state, tokens, labels)
            seq.append((float(m["loss"]), bool(m["overflow"]),
                        float(m["loss_scale"])))
            step_norms.append({k: float(m[k]) for k in NORM_KEYS})
        runs["kernel" if backend is None else "plain"] = (
            seq, [float(x) for x in norms], step_norms)
        del state
    (ks, kn, ksn), (ps, pn, psn) = runs["kernel"], runs["plain"]
    telemetry_err = max(abs(a[k] - b[k]) / abs(b[k])
                        for a, b, st in zip(ksn, psn, ks) if not st[1]
                        for k in NORM_KEYS)
    check(telemetry_err <= GRAD_NORM_RTOL,
          f"norm_telemetry kernel {ksn} plain {psn}: {telemetry_err}")
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
            "grad_norm_rel_err": norm_err, "norm_telemetry_kernel": ksn,
            "norm_telemetry_plain": psn,
            "norm_telemetry_rel_err": telemetry_err}


def train_accum_check(dev):
    """The GPT-2 125M O2 step at b16 x s1024 with accum_steps=4 (four
    microbatches of 4, fp32 accumulation through M1's axpby mode) against
    accum_steps=1 on the same batch, 3 steps from one state each: losses
    within TRAIN_LOSS_TOL, the same scaler decisions; the accumulating
    step's launches (M1 four times: three adds, and the unscale, which
    divides by 4 in the same pass)."""
    from apex_tpu_torch.amp.frontend import make_train_step
    from apex_tpu_torch.models.gpt import make_gpt_train_step
    from apex_tpu_torch.models.transformer_lm import gpt_loss
    from apex_tpu_torch.ops import _kernel_utils as ku
    from apex_tpu_torch.optimizers import fused_adam

    cfg = _train_cfg()
    tokens, labels = _batch(cfg, TRAIN_BATCH, 2, dev)
    state0 = make_gpt_train_step(cfg, fused_adam(lr=1e-4), "O2",
                                 device=dev)[0](
        torch.Generator().manual_seed(0))
    seqs, counts = {}, {}
    for accum in (1, 4):
        _, step = make_train_step(
            lambda p, t, lab: gpt_loss(p, t, lab, cfg), fused_adam(lr=1e-4),
            "O2", accum_steps=accum, device=dev)
        state, seq = state0, []
        for i in range(CHECK_STEPS):
            if i == CHECK_STEPS - 1:
                torch.cuda.synchronize()
                ku.reset_launch_counts()
            state, m = step(state, tokens, labels)
            seq.append((float(m["loss"]), bool(m["overflow"]),
                        float(m["loss_scale"])))
        counts[accum] = ku.launch_counts()
        seqs[accum] = seq
        del state
    loss_err = max(abs(a[0] - b[0]) for a, b in zip(seqs[4], seqs[1]))
    check(loss_err <= TRAIN_LOSS_TOL,
          f"accum_steps=4 vs 1 losses {seqs[4]} {seqs[1]}: {loss_err}")
    check([a[1:] for a in seqs[4]] == [b[1:] for b in seqs[1]],
          f"accum_steps=4 vs 1 scaler decisions {seqs[4]} {seqs[1]}")
    L = cfg.num_layers
    check(counts[4].get("multi_tensor_scale") == 3 + 1
          and counts[4].get("multi_tensor_adam") == 1
          and counts[4].get("layer_norm_fwd") == 4 * (2 * L + 1),
          f"accum_steps=4 launches {counts[4]}")
    return {"accum_4": seqs[4], "accum_1": seqs[1], "loss_err": loss_err,
            "launches_accum_4": counts[4], "launches_accum_1": counts[1]}


def _flash_bwd_case(dev, gen, b, s, n, g, d, causal, kpm):
    q = torch.randn(b, s, n, d, device=dev, generator=gen).bfloat16()
    k = torch.randn(b, s, g, d, device=dev, generator=gen).bfloat16()
    v = torch.randn(b, s, g, d, device=dev, generator=gen).bfloat16()
    do = torch.randn(b, s, n, d, device=dev, generator=gen).bfloat16()
    from apex_tpu_torch.ops import flash_attention as tfa

    o, lse = tfa.flash_attention_fwd(q, k, v, causal=causal,
                                     key_padding_mask=kpm)
    ops = tfa.flash_bwd_operands(q, k, v, o, lse, do, key_padding_mask=kpm)
    return q, k, v, o, lse, do, ops


def _sdpa_bwd_ms(q, k, v, do, causal, add=None):
    """SDPA's backward alone: its forward and backward timed together,
    less its forward."""
    qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_()
                  for t in (q, k, v))
    dot = do.transpose(1, 2)

    def sdpa():
        return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=add,
                                              is_causal=causal)

    return (time_ms(lambda: torch.autograd.grad(sdpa(), (qt, kt, vt), dot))
            - time_ms(sdpa))


# a head size between the kernels' tile widths: Phi-2's 80 (128-column
# tiles, the last 48 columns zero-filled by TMA), 32 heads, at the smoke's
# serving batch and length
D80 = (8, 512, 32, 80)


def kernel_flash_d80(dev, gen):
    """K2 and row 5 (flash_attention_bwd's route at 512 keys) at head size
    80, b8 s512 n32 causal bf16, against the plain forward and backward;
    SDPA's forward and backward beside them; and K2 at head size 78,
    which runs on a copy zero-padded to 80 (the copy's cost)."""
    from apex_tpu_torch.ops import _kernel_utils as ku
    from apex_tpu_torch.ops import flash_attention as tfa

    b, s, n, d = D80
    q, k, v, o, lse, do, ops = _flash_bwd_case(dev, gen, b, s, n, n, d,
                                               True, None)
    ref_o, _ = tfa.flash_attention_fwd_ref(q, k, v, causal=True)
    fwd_err = max_err(o, ref_o)
    del ref_o
    before = ku.launch_counts()
    got = tfa.flash_attention_bwd(q, k, v, o, lse, do, causal=True)
    torch.cuda.synchronize()
    check(ku.launch_counts()["flash_attention_bwd_short"]
          == before["flash_attention_bwd_short"] + 1,
          "d80 backward did not take row 5")
    want = tfa.flash_attention_bwd_ref(q, k, v, o, lse, do, causal=True)
    bwd_rel = max(rel_err(a, e) for a, e in zip(got, want))
    bwd_abs = max(max_err(a, e) for a, e in zip(got, want))
    del got, want
    check(fwd_err <= 2e-2, f"K2 d80 error {fwd_err}")
    check(bwd_rel <= FLASH_BWD_TOL, f"row 5 d80 relative error {bwd_rel}")
    pairs = n * b * s * (s + 1) // 2
    fb, fby = bound(4 * b * s * n * d * 2 + b * n * s * 4, 4 * d * pairs,
                    PEAK_BF16_FLOPS)
    bb, bby = bound(7 * b * s * n * d * 2 + 2 * b * n * s * 4,
                    10 * d * pairs, PEAK_BF16_FLOPS)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    q78, k78, v78 = (t[..., :78].contiguous() for t in (q, k, v))
    fwd = {"err": fwd_err,
           "ms": time_ms(lambda: tfa.flash_attention_fwd(q, k, v,
                                                         causal=True)),
           "plain_ms": time_ms(lambda: tfa.flash_attention_fwd_ref(
               q, k, v, causal=True), iters=2),
           "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
               qt, kt, vt, is_causal=True)),
           "bound_ms": fb, "bound_by": fby,
           "d78_padded_copy_ms": time_ms(lambda: tfa.flash_attention_fwd(
               q78, k78, v78, causal=True))}
    bwd = {"err": bwd_abs, "rel_err": bwd_rel,
           "ms": time_ms(lambda: tfa.flash_bwd_fused(ops, causal=True)),
           "plain_ms": time_ms(lambda: tfa.flash_attention_bwd_ref(
               q, k, v, o, lse, do, causal=True), iters=2),
           "library_ms": _sdpa_bwd_ms(q, k, v, do, True),
           "bound_ms": bb, "bound_by": bby}
    return fwd, bwd


# keys of the crossover sweep between row 5 and K6 + K7 (flash_bwd_fused
# takes up to 1024: a cluster of 8 ranks)
CROSSOVER_KEYS = (256, 384, 512, 640, 768, 1024)


def kernel_flash_bwd_short(dev, gen):
    """Row 5 against flash_attention_bwd_ref at BERT-large's shape (b8
    s512 n16 d64 bf16, non-causal, ragged key padding with one fully
    masked batch row), and causal and GQA g=4 variants; K6 + K7 on the
    same inputs (the split pair the JAX route chose against) and SDPA's
    backward with the same additive mask beside it.  Then the GPT-MoE
    steps' shape (b8 s512 n12 d64 causal, no padding) against the plain
    version, K6 + K7 and SDPA, and the crossover sweep: row 5 and K6 + K7
    at CROSSOVER_KEYS keys, b8 n12 d64 causal and b8 n16 non-causal."""
    from apex_tpu_torch.ops import flash_attention as tfa

    b, s, n, d = BERT_BATCH, BERT_SEQ, 16, 64
    lens = bert_lens(b, s, torch.Generator().manual_seed(4)).to(dev)
    lens[-1] = 0
    kpm = torch.arange(s, device=dev)[None] >= lens[:, None]
    errs, abs_err, main = {}, 0.0, None
    for name, g, causal in (("non-causal+pad", 16, False),
                            ("causal+pad", 16, True),
                            ("gqa g=4 non-causal+pad", 4, False)):
        q, k, v, o, lse, do, ops = _flash_bwd_case(dev, gen, b, s, n, g, d,
                                                   causal, kpm)
        got = tfa.flash_bwd_fused(ops, causal=causal)
        want = tfa.flash_attention_bwd_ref(q, k, v, o, lse, do,
                                           causal=causal,
                                           key_padding_mask=kpm)
        for gname, a, e in zip(("dq", "dk", "dv"), got, want):
            errs[f"{name} {gname}"] = rel_err(a, e)
            abs_err = max(abs_err, max_err(a, e))
        check(all(int(torch.count_nonzero(t[-1])) == 0 for t in got),
              f"row 5 {name}: the fully masked batch row has gradients")
        del want
        check(max(errs.values()) <= FLASH_BWD_TOL,
              f"row 5 {name} error {errs}")
        if name == "non-causal+pad":
            main = (q, k, v, o, lse, do, ops)
    q, k, v, o, lse, do, ops = main
    split = (tfa.flash_bwd_dq(ops, causal=False),
             *tfa.flash_bwd_dkv(ops, causal=False))
    fused = tfa.flash_bwd_fused(ops, causal=False)
    errs["row 5 vs K6+K7"] = max(rel_err(a, e) for a, e in zip(fused, split))
    check(errs["row 5 vs K6+K7"] <= FLASH_BWD_TOL,
          f"row 5 against K6 + K7: {errs}")
    # one launch a call, the same bits on every call
    before = tfa.FLASH_BWD_SHORT.launches
    again = tfa.flash_bwd_fused(ops, causal=False)
    check(tfa.FLASH_BWD_SHORT.launches == before + 1,
          "row 5: more than one launch a call")
    check(all(torch.equal(a, e) for a, e in zip(again, fused)),
          "row 5: two calls on the same inputs differ")
    # open (query, key) pairs: every query row against its batch row's
    # valid keys; 5 products of 2*d flops each
    pairs = int(lens.sum()) * s * n
    io = 7 * b * s * n * d * 2                  # q k v do in, dq dk dv out
    stats = 2 * b * n * s * 4 + b * s * 4       # lse, delta, key padding
    bms, by = bound(io + stats, 10 * d * pairs, PEAK_BF16_FLOPS)
    split_b, split_by = bound(io + 2 * stats, 14 * d * pairs,
                              PEAK_BF16_FLOPS)
    plain_ms = time_ms(lambda: tfa.flash_attention_bwd_ref(
        q, k, v, o, lse, do, key_padding_mask=kpm), iters=2, reps=2)
    add = torch.where(kpm, -1e30, 0.0).bfloat16()[:, None, None, :]
    lib_ms = _sdpa_bwd_ms(q, k, v, do, False, add)
    split_ms = time_ms(lambda: (tfa.flash_bwd_dq(ops, causal=False),
                                tfa.flash_bwd_dkv(ops, causal=False)))
    variants = {"K6+K7 on the same inputs": {
        "ms": split_ms, "plain_ms": plain_ms, "library_ms": lib_ms,
        "bound_ms": split_b, "bound_by": split_by}}

    # the GPT-MoE steps' attention: b8 s512 n12 d64 causal, no padding
    mb, ms_, mn = MOE_BATCH, MOE_SEQ, 12
    q, k, v, o, lse, do, mops = _flash_bwd_case(dev, gen, mb, ms_, mn, mn, d,
                                                True, None)
    got = tfa.flash_bwd_fused(mops, causal=True)
    want = tfa.flash_attention_bwd_ref(q, k, v, o, lse, do, causal=True)
    for gname, a, e in zip(("dq", "dk", "dv"), got, want):
        errs[f"moe causal {gname}"] = rel_err(a, e)
        abs_err = max(abs_err, max_err(a, e))
    del want
    check(max(errs.values()) <= FLASH_BWD_TOL, f"row 5 moe error {errs}")
    mpairs = mb * mn * ms_ * (ms_ + 1) // 2     # causal, no padding
    mio = 7 * mb * ms_ * mn * d * 2
    mstats = 2 * mb * mn * ms_ * 4
    m_plain = time_ms(lambda: tfa.flash_attention_bwd_ref(
        q, k, v, o, lse, do, causal=True), iters=2, reps=2)
    m_lib = _sdpa_bwd_ms(q, k, v, do, True)
    mb_ms, m_by = bound(mio + mstats, 10 * d * mpairs, PEAK_BF16_FLOPS)
    ms_b, ms_by = bound(mio + 2 * mstats, 14 * d * mpairs, PEAK_BF16_FLOPS)
    variants[f"MoE shape b{mb} s{ms_} n{mn} d{d} causal"] = {
        "ms": time_ms(lambda: tfa.flash_bwd_fused(mops, causal=True)),
        "plain_ms": m_plain, "library_ms": m_lib, "bound_ms": mb_ms,
        "bound_by": m_by}
    variants["K6+K7 at the MoE shape"] = {
        "ms": time_ms(lambda: (tfa.flash_bwd_dq(mops, causal=True),
                               tfa.flash_bwd_dkv(mops, causal=True))),
        "plain_ms": m_plain, "library_ms": m_lib, "bound_ms": ms_b,
        "bound_by": ms_by}
    del mops, q, k, v, o, lse, do

    crossover = {}
    for causal, cn in ((True, 12), (False, 16)):
        for sk in CROSSOVER_KEYS:
            *_, cops = _flash_bwd_case(dev, gen, 8, sk, cn, cn, d, causal,
                                       None)
            crossover[f"{'causal' if causal else 'non-causal'} n{cn} "
                      f"s{sk}"] = {
                "row5_ms": time_ms(lambda: tfa.flash_bwd_fused(
                    cops, causal=causal)),
                "k6_k7_ms": time_ms(lambda: (
                    tfa.flash_bwd_dq(cops, causal=causal),
                    tfa.flash_bwd_dkv(cops, causal=causal)))}
            del cops
    return {
        "err": abs_err, "rel_err": max(errs.values()),
        "tol": FLASH_BWD_TOL, "detail": errs,
        "ms": time_ms(lambda: tfa.flash_bwd_fused(ops, causal=False)),
        "plain_ms": plain_ms, "library_ms": lib_ms,
        "bound_ms": bms, "bound_by": by,
        "variants": variants, "crossover": crossover,
        "rank_steps": {
            "bert": tfa.short_rank_steps(s, s, n, n, d, False),
            "moe": tfa.short_rank_steps(ms_, ms_, mn, mn, d, True)},
        # clusters the card holds at once: one wave of the launch
        "resident_clusters": {sk: tfa.short_resident_clusters(sk, d)
                              for sk in CROSSOVER_KEYS},
        "shape": f"b={b} s={s} n={n} d={d} bf16 non-causal, key lengths "
                 f"{lens.tolist()} (checked also causal and GQA g=4, and "
                 "at the MoE shape); plain = flash_attention_bwd_ref, "
                 "library = SDPA backward with the same additive mask",
    }


def kernel_softmax(dev, gen):
    """Row 11 against _softmax_fwd_ref at BERT-large's fused_softmax scores
    [8, 16, 512, 512] fp32 with a [8, 1, 1, 512] bool mask; variants bf16
    input, causal, and a full-shape mask."""
    from apex_tpu_torch.ops import softmax as tsm

    b, n, s = BERT_BATCH, 16, BERT_SEQ
    scale = 1.0 / 8.0
    lens = bert_lens(b, s, torch.Generator().manual_seed(5)).to(dev)
    lens[-1] = 0
    kpm = (torch.arange(s, device=dev)[None] >= lens[:, None])[
        :, None, None, :]
    full = torch.rand(b, n, s, s, device=dev, generator=gen) < 0.2
    x32 = torch.randn(b, n, s, s, device=dev, generator=gen) * 8
    errs, variants, main = {}, {}, None
    for name, x, mask, causal in (
            ("fp32 key padding", x32, kpm, False),
            ("bf16 key padding", x32.bfloat16(), kpm, False),
            ("fp32 causal", x32, None, True),
            ("fp32 full-shape mask", x32, full, False)):
        got = tsm.softmax_fwd(x, scale, mask, causal)
        want = tsm._softmax_fwd_ref(x, scale, mask, causal)
        errs[name] = max_err(got, want)
        check(errs[name] <= SOFTMAX_TOL[x.dtype],
              f"row 11 {name} error {errs}")
        if mask is kpm:
            check(int(torch.count_nonzero(got[-1])) == 0,
                  f"row 11 {name}: the fully masked batch row is not 0")
        del got, want
        x_in = torch.where(mask, -10000.0, x.float() * scale) if (
            mask is not None) else x.float() * scale
        if causal:
            tri = torch.ones(s, s, dtype=torch.bool, device=dev).triu(1)
            x_in = x_in.masked_fill(tri, -10000.0)
        x_in = x_in.to(x.dtype)
        elems = x.numel()
        mbytes = 0 if mask is None else (mask.numel() if mask is full
                                         else b * s)
        # the function needs x only where it is not masked: count those
        # reads (this run's data), beside the bound that reads all of x
        if causal:
            live = b * n * s * (s + 1) // 2
        elif mask is full:
            live = int((~full).sum())
        else:
            live = int((~kpm).sum()) * n * s
        bms, by = bound((elems + live) * x.element_size() + mbytes,
                        5 * elems, PEAK_FP32_FLOPS)
        full_ms, _ = bound(2 * elems * x.element_size() + mbytes, 5 * elems,
                           PEAK_FP32_FLOPS)
        row = {"err": errs[name],
               "ms": time_ms(lambda: tsm.softmax_fwd(x, scale, mask,
                                                     causal)),
               "plain_ms": time_ms(lambda: tsm._softmax_fwd_ref(
                   x, scale, mask, causal), iters=4),
               "library_ms": time_ms(lambda: torch.softmax(x_in, -1)),
               "bound_ms": bms, "bound_by": by,
               "bound_all_of_x_ms": full_ms,
               "x_elements_read_by_the_function": live}
        del x_in
        if main is None:
            main = row
        else:
            variants[name] = row
    # the backward composition (_ScaledSoftmax.backward, a torch
    # composition here as in the JAX package) on the main variant's y
    y = tsm.softmax_fwd(x32, scale, kpm)
    dy = torch.randn(y.shape, device=dev, generator=gen)

    class Ctx:
        saved_tensors = (y,)

    Ctx.scale = scale
    bwd_ms = time_ms(lambda: tsm._ScaledSoftmax.backward(Ctx, dy), iters=4)
    del y, dy
    return dict(main, err=max(errs.values()), tol=SOFTMAX_TOL[torch.float32],
                detail=errs, variants=variants, backward_composition_ms=bwd_ms,
                shape=f"[{b}, {n}, {s}, {s}] fp32, [{b}, 1, 1, {s}] bool "
                      f"mask, scale {scale}, key lengths {lens.tolist()}; "
                      "library = torch.softmax of the pre-scaled, "
                      "pre-masked input; bound = x's unmasked elements read "
                      "and y written once (bound_all_of_x_ms reads all of "
                      "x); bf16 tolerance "
                      f"{SOFTMAX_TOL[torch.bfloat16]}")


def bert_cfg(backend, num_layers=BERT_LAYERS):
    from apex_tpu_torch.models.config import bert_large

    return bert_large(num_layers=num_layers,
                      max_position_embeddings=BERT_SEQ, remat=False,
                      attention_backend=backend)


def bert_batch(cfg, b, seed, dev):
    """A seeded BERT pretraining batch: valid lengths from 3/4 s to s (row
    0 full), random tokens, ~15% of the real positions with MLM labels
    (the rest -1), NSP labels 0/1, token types 0 then 1 split at a
    per-row boundary inside the valid length, int attention mask (1 =
    real token)."""
    gen = torch.Generator().manual_seed(seed)
    s = BERT_SEQ
    lens = bert_lens(b, s, gen)
    am = (torch.arange(s)[None] < lens[:, None]).long()
    tokens = torch.randint(0, cfg.vocab_size, (b, s), generator=gen)
    picked = (torch.rand(b, s, generator=gen) < 0.15) & (am == 1)
    mlm = torch.where(picked, torch.randint(0, cfg.vocab_size, (b, s),
                                            generator=gen), -1)
    nsp = torch.randint(0, 2, (b,), generator=gen)
    split = (torch.rand(b, generator=gen) * (lens - 1)).long() + 1
    tt = (torch.arange(s)[None] >= split[:, None]).long()
    return tuple(t.to(dev) for t in (tokens, mlm, nsp, tt, am))


def bert_train_phase(dev, backend):
    """The BERT-large AMP-O2 FusedLAMB train step at b8 x s512 under one
    attention backend: exact launch counts, step time, tokens/s (b x s and
    real tokens), MFU, the device idle share and peak memory."""
    from apex_tpu_torch.models.bert import make_bert_train_step
    from apex_tpu_torch.ops import _kernel_utils as ku
    from apex_tpu_torch.optimizers import fused_lamb
    from apex_tpu_torch.optimizers._common import tree_leaves

    cfg = bert_cfg(backend)
    init, step = make_bert_train_step(
        cfg, fused_lamb(lr=1e-4, weight_decay=0.01), "O2", device=dev)
    t0 = time.perf_counter()
    state = init(torch.Generator().manual_seed(0))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in tree_leaves(state.master_params))
    batch = bert_batch(cfg, BERT_BATCH, 0, dev)
    real_tokens = int(batch[4].sum())
    traj = []

    def one():
        nonlocal state
        state, m = step(state, *batch)
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
    want.update({"layer_norm_fwd": 2 * L + 3, "layer_norm_bwd": 2 * L + 3,
                 **LAMB_TAIL})
    if backend == "flash":
        want.update({"flash_attention_fwd": L,
                     "flash_attention_bwd_short": L})
    else:
        want.update({"scaled_softmax_fwd": L})
    check(counts == want, f"bert {backend} launches {counts} != {want}")
    print(f"launches (one bert {backend} train step): {counts}")

    step_ms = [wall_ms(one) for _ in range(TRAIN_STEPS)]
    q1, med, q3 = quartiles(step_ms)
    t_prof, busy, top, by_cat, by_op = profile_busy(one)
    tail = profile_tail(one)
    softmax_ms = {}
    if backend == "fused_softmax":
        # row 11's forward and the torch backward composition around it
        # (_ScaledSoftmax.backward), device ms of one step
        softmax_ms = profile_spans(
            one, {"row11_forward_device_ms": "namespace)::softmax_"},
            {"softmax_backward_composition_device_ms":
             "_ScaledSoftmaxBackward"})
    losses = [float(m["loss"]) for m in traj]
    scales = [float(m["loss_scale"]) for m in traj]
    overflow = [bool(m["overflow"]) for m in traj]
    check(all(math.isfinite(x) for x in losses), f"losses {losses}")
    check(not all(overflow), "every train step overflowed")
    tokens_per_s = BERT_BATCH * BERT_SEQ / (med / 1e3)
    flops_per_tok = 6 * n_params + 12 * L * cfg.hidden_size * BERT_SEQ
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    del state
    return {
        "params": n_params, "batch": BERT_BATCH, "seq": BERT_SEQ,
        "real_tokens": real_tokens, "init_s": init_s,
        "step_ms": med, "step_ms_q1_q3": [q1, q3], "steps_timed": TRAIN_STEPS,
        "tokens_per_s": tokens_per_s,
        "real_tokens_per_s": real_tokens / (med / 1e3),
        "mfu": tokens_per_s * flops_per_tok / PEAK_BF16_FLOPS,
        "profiled_step_ms": t_prof,
        "device_busy_ms": busy if busy > 0 else "not measured",
        "device_idle_share": (1 - busy / t_prof) if busy > 0
        else "not measured",
        "device_top_ms": top, "device_ms_by_category": by_cat,
        "device_ms_by_op": by_op, "peak_memory_gb": peak_gb,
        "losses": losses, "loss_scales": scales, "overflow": overflow,
        "counts": counts, "tail": tail, **softmax_ms,
    }


def bert_train_check(dev, backend):
    """3 steps at b4 x s512 from one state on the kernel path and on the
    plain path (backend="reference"): per-step loss, identical scaler
    decisions, global grad norm within GRAD_NORM_RTOL."""
    from apex_tpu_torch.models.bert import make_bert_train_step
    from apex_tpu_torch.optimizers import fused_lamb, global_norm

    cfg = bert_cfg(backend)
    batch = bert_batch(cfg, CHECK_BATCH, 1, dev)
    runs, state0 = {}, None
    for path in (None, "reference"):
        norms = []

        def post(grads, norms=norms):
            norms.append(global_norm(grads))
            return grads

        init, step = make_bert_train_step(
            cfg, fused_lamb(lr=1e-4, weight_decay=0.01), "O2", device=dev,
            backend=path, grad_postprocess=post)
        if state0 is None:
            state0 = init(torch.Generator().manual_seed(0))
        state, seq = state0, []
        for _ in range(CHECK_STEPS):
            state, m = step(state, *batch)
            seq.append((float(m["loss"]), bool(m["overflow"]),
                        float(m["loss_scale"])))
        runs["kernel" if path is None else "plain"] = (
            seq, [float(x) for x in norms])
        del state
    (ks, kn), (ps, pn) = runs["kernel"], runs["plain"]
    loss_err = max(abs(a[0] - b[0]) for a, b in zip(ks, ps))
    check(loss_err <= TRAIN_LOSS_TOL,
          f"bert {backend} kernel vs plain losses {ks} {ps} differ by "
          f"{loss_err}")
    check([a[1:] for a in ks] == [b[1:] for b in ps],
          f"bert {backend} scaler decisions differ: kernel {ks} plain {ps}")
    check(not all(x[1] for x in ks), f"bert {backend}: every step overflowed")
    norm_err = max(abs(a - b) / b for a, b, s in zip(kn, pn, ks) if not s[1])
    check(norm_err <= GRAD_NORM_RTOL,
          f"bert {backend} grad norms kernel {kn} plain {pn}: {norm_err} > "
          f"{GRAD_NORM_RTOL}")
    return {"kernel": ks, "plain": ps, "grad_norm_kernel": kn,
            "grad_norm_plain": pn, "loss_err": loss_err,
            "grad_norm_rel_err": norm_err}


# GPT-MoE training (bench.py:2219-2259 bench_gpt_moe): 12 layers, h768,
# 12 heads, vocab 50304, 8 experts, b8 x s512, fused_adam(lr=1e-4), O2;
# "capacity" is the bench as configured, "ragged" the one-device row of
# bench_moe_ablation (bench.py:2470-2483, 2541-2546)
MOE_BATCH, MOE_SEQ = 8, 512
MOE_ROUTINGS = ("capacity", "ragged")
# routing flips between the kernel and the plain path at a plain top-k
# gap below ROUTER_TIE are counted apart (bf16 hidden states round
# differently on the two paths, so most flips sit at wider gaps)
ROUTER_TIE = 1e-5


def moe_cfg(routing):
    from apex_tpu_torch.models.config import TransformerConfig

    return TransformerConfig(
        num_layers=12, hidden_size=768, num_attention_heads=12,
        vocab_size=50304, max_position_embeddings=MOE_SEQ, num_experts=8,
        moe_routing=routing, remat=False, scan_layers=False)


def moe_batch(cfg, b, seed, dev):
    """bench_gpt_moe's batch: tokens then labels from RandomState(seed)."""
    import numpy as np

    rng = np.random.RandomState(seed)
    tokens = rng.randint(0, cfg.vocab_size, (b, MOE_SEQ))
    labels = rng.randint(0, cfg.vocab_size, (b, MOE_SEQ))
    return (torch.from_numpy(tokens).to(dev),
            torch.from_numpy(labels).to(dev))


def moe_active_params(cfg, n_params):
    """Parameters one token passes through: all but the E - k experts of
    each layer that it skips."""
    h, f = cfg.hidden_size, cfg.ffn_hidden_size
    expert = 2 * h * f + f + h
    return n_params - cfg.num_layers * (
        cfg.num_experts - cfg.moe_top_k) * expert


class MoEProbe:
    """Within a ``with`` block, records each MoE layer's ``MoEOutput``,
    router logits and router probabilities by wrapping the port's own
    ``transformer/moe.switch_moe_mlp`` and ``_router_probs`` (a probe
    forward outside every counted window).  With ``force``, a list of
    another forward's router probabilities, every layer routes by those
    instead of its own (its own are still recorded), so two forwards make
    the same routing decisions and differ only by their numerics."""

    def __init__(self, force=None):
        self.force = force

    def __enter__(self):
        from apex_tpu_torch.transformer import moe

        self.outs, self.logits, self.probs = [], [], []
        self._moe = moe
        self._real = (moe.switch_moe_mlp, moe._router_probs)

        def switch(*a, **kw):
            self.outs.append(self._real[0](*a, **kw))
            return self.outs[-1]

        def probs(router, x2, *rest):
            self.logits.append(x2.float() @ router.float())
            self.probs.append(self._real[1](router, x2, *rest))
            if self.force is not None:
                return self.force[len(self.probs) - 1]
            return self.probs[-1]

        moe.switch_moe_mlp, moe._router_probs = switch, probs
        return self

    def __exit__(self, *exc):
        self._moe.switch_moe_mlp, self._moe._router_probs = self._real

    def stats(self):
        return {
            "expert_load": [[int(v) for v in o.expert_load.tolist()]
                            for o in self.outs],
            "aux_loss": [float(o.aux_loss) for o in self.outs],
            "dropped_fraction": [float(o.dropped_fraction)
                                 for o in self.outs]}


def moe_probe(params, tokens, cfg, backend=None, force=None):
    from apex_tpu_torch.models.transformer_lm import gpt_forward

    with torch.no_grad(), MoEProbe(force) as probe:
        logits = gpt_forward(params, tokens, cfg, backend=backend)
    return logits, probe


def _topk_sets(probs, top_k):
    from apex_tpu_torch.transformer.moe import _topk_routing

    return _topk_routing(probs, top_k)[0].sort(-1).values


def routing_flips(pk, pp, top_k):
    """Free-running kernel-path vs plain-path routing of one forward: the
    tokens whose top-k expert set differs (a token routed elsewhere keeps
    a different hidden state in every later layer, and attention carries
    it to later positions, so flips cascade), the layers with flips, and
    how many flips sit at a plain top-k gap below ROUTER_TIE.  Reported
    as a witness; ``routing_drift`` is the check."""
    out = {"tokens_flipped": 0, "below_1e-5": 0, "layers_with_flips": 0,
           "max_flipped_gap": 0.0}
    for a, b in zip(pk.probs, pp.probs):
        flip = (_topk_sets(a, top_k) != _topk_sets(b, top_k)).any(-1)
        n = int(flip.sum())
        if not n:
            continue
        top = b.sort(-1, descending=True).values
        gap = (top[:, top_k - 1] - top[:, top_k])[flip]
        out["tokens_flipped"] += n
        out["layers_with_flips"] += 1
        out["below_1e-5"] += int((gap < ROUTER_TIE).sum())
        out["max_flipped_gap"] = max(out["max_flipped_gap"],
                                     float(gap.max()))
    return out


def routing_drift(pf, pp, top_k):
    """The kernel path routed by the plain path's probabilities (``pf``,
    ``MoEProbe(force=)``) against the plain path (``pp``): both make the
    same routing decisions in every layer, so there is no cascade and the
    router inputs differ only by the two paths' rounding.  The check: in
    every layer the router logits agree within LOGIT_TOL, the smoke's
    tolerance for bf16 compute through 12 layers (a softmax then moves no
    probability by more than half that).  Also reported: the largest
    probability change, and the tokens whose own top-k set would differ
    (with their largest plain gap and how many sit below ROUTER_TIE)."""
    out = {"max_router_logit_err": 0.0, "max_prob_change": 0.0,
           "tokens_would_flip": 0, "would_flip_below_1e-5": 0,
           "max_would_flip_gap": 0.0}
    for za, zb, a, b in zip(pf.logits, pp.logits, pf.probs, pp.probs):
        out["max_router_logit_err"] = max(out["max_router_logit_err"],
                                          max_err(za, zb))
        out["max_prob_change"] = max(out["max_prob_change"], max_err(a, b))
        flip = (_topk_sets(a, top_k) != _topk_sets(b, top_k)).any(-1)
        if not flip.any():
            continue
        top = b.sort(-1, descending=True).values
        gap = (top[:, top_k - 1] - top[:, top_k])[flip]
        out["tokens_would_flip"] += int(flip.sum())
        out["would_flip_below_1e-5"] += int((gap < ROUTER_TIE).sum())
        out["max_would_flip_gap"] = max(out["max_would_flip_gap"],
                                        float(gap.max()))
    return out


def moe_train_phase(dev, routing):
    """The GPT-MoE AMP-O2 train step at b8 x s512 under one routing:
    exact launch counts, step time, tokens/s, MFU over the active
    parameters, device busy time and idle share, peak memory, and a probe
    forward's expert loads, aux losses and dropped fractions.  Returns
    (result, the state's fp32 master parameters)."""
    from apex_tpu_torch.models.gpt import make_gpt_train_step
    from apex_tpu_torch.ops import _kernel_utils as ku
    from apex_tpu_torch.optimizers import fused_adam
    from apex_tpu_torch.optimizers._common import tree_leaves

    cfg = moe_cfg(routing)
    init, step = make_gpt_train_step(cfg, fused_adam(lr=1e-4), "O2",
                                     device=dev)
    t0 = time.perf_counter()
    state = init(torch.Generator().manual_seed(0))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in tree_leaves(state.master_params))
    n_active = moe_active_params(cfg, n_params)
    tokens, labels = moe_batch(cfg, MOE_BATCH, 0, dev)
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
                 "flash_attention_fwd": L, "flash_attention_bwd_short": L,
                 **ADAM_TAIL})
    if routing == "ragged":
        # fc1 and fc2 forward, and their dx through the transposed read
        want.update({"grouped_matmul_mma": 2 * L,
                     "grouped_matmul_mma_t": 2 * L})
    check(counts == want, f"moe {routing} launches {counts} != {want}")
    print(f"launches (one moe {routing} train step): {counts}")

    step_ms = [wall_ms(one) for _ in range(TRAIN_STEPS)]
    q1, med, q3 = quartiles(step_ms)
    t_prof, busy, top, by_cat, by_op = profile_busy(one)
    tail = profile_tail(one)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    losses = [float(m["loss"]) for m in traj]
    scales = [float(m["loss_scale"]) for m in traj]
    overflow = [bool(m["overflow"]) for m in traj]
    check(all(math.isfinite(x) for x in losses), f"losses {losses}")
    check(not all(overflow), "every moe train step overflowed")
    _, probe = moe_probe(state.params, tokens, cfg)
    routing_stats = probe.stats()
    check(len(probe.outs) == L, "moe probe: one output per layer")
    check(all(sum(ld) == MOE_BATCH * MOE_SEQ * cfg.moe_top_k
              for ld in routing_stats["expert_load"]),
          f"expert loads {routing_stats['expert_load']}")
    if routing == "ragged":
        check(all(d == 0.0 for d in routing_stats["dropped_fraction"]),
              "ragged routing dropped tokens")
    tokens_per_s = MOE_BATCH * MOE_SEQ / (med / 1e3)
    flops_per_tok = 6 * n_active + 12 * L * cfg.hidden_size * MOE_SEQ
    master = state.master_params
    del state
    return {
        "params": n_params, "active_params": n_active, "batch": MOE_BATCH,
        "seq": MOE_SEQ, "init_s": init_s,
        "step_ms": med, "step_ms_q1_q3": [q1, q3], "steps_timed": TRAIN_STEPS,
        "tokens_per_s": tokens_per_s,
        "mfu": tokens_per_s * flops_per_tok / PEAK_BF16_FLOPS,
        "mfu_formula": "tokens/s x (6 x active params + 12 x L x h x s) / "
                       "989 TFLOP/s",
        "profiled_step_ms": t_prof,
        "device_busy_ms": busy if busy > 0 else "not measured",
        "device_idle_share": (1 - busy / t_prof) if busy > 0
        else "not measured",
        "busy_over_median_step": busy / med if busy > 0 else "not measured",
        "device_top_ms": top, "device_ms_by_category": by_cat,
        "device_ms_by_op": by_op, "peak_memory_gb": peak_gb,
        "losses": losses, "loss_scales": scales, "overflow": overflow,
        "counts": counts, "tail": tail, **routing_stats,
    }, master


def moe_train_check(dev, routing):
    """3 kernel-vs-plain steps at b4 x s512 in lockstep: each step starts
    the kernel path and the plain path (backend="reference") from the
    kernel path's state, so a routing flip in one step does not carry
    into the next (under capacity routing a flipped token changes which
    later tokens drop).  Per step: loss within TRAIN_LOSS_TOL, identical
    scaler decisions, grad norms within GRAD_NORM_RTOL, and probe
    forwards of the shared state: the kernel path routed by the plain
    path's probabilities holds its router logits to the plain path's
    (routing_drift, the check); the free-running paths' routing flips and
    layers with unequal expert loads are reported (routing_flips)."""
    from apex_tpu_torch.models.gpt import make_gpt_train_step
    from apex_tpu_torch.optimizers import fused_adam, global_norm

    cfg = moe_cfg(routing)
    tokens, labels = moe_batch(cfg, CHECK_BATCH, 1, dev)
    steps, norms = {}, {}
    for path in (None, "reference"):
        name = "kernel" if path is None else "plain"
        norms[name] = []

        def post(grads, out=norms[name]):
            out.append(global_norm(grads))
            return grads

        steps[name] = make_gpt_train_step(
            cfg, fused_adam(lr=1e-4), "O2", device=dev, backend=path,
            grad_postprocess=post)
    state = steps["kernel"][0](torch.Generator().manual_seed(0))
    seq = {"kernel": [], "plain": []}
    flips, drift, loads_differ = [], [], 0
    for _ in range(CHECK_STEPS):
        _, pp = moe_probe(state.params, tokens, cfg, backend="reference")
        _, pk = moe_probe(state.params, tokens, cfg)
        _, pf = moe_probe(state.params, tokens, cfg, force=pp.probs)
        flips.append(routing_flips(pk, pp, cfg.moe_top_k))
        loads_differ += sum(not torch.equal(a.expert_load, b.expert_load)
                            for a, b in zip(pk.outs, pp.outs))
        d = routing_drift(pf, pp, cfg.moe_top_k)
        drift.append(d)
        check(d["max_router_logit_err"] <= LOGIT_TOL,
              f"moe {routing}: kernel vs plain router logits under one "
              f"routing {d}")
        del pp, pk, pf
        new = {}
        for name in ("kernel", "plain"):
            new[name], m = steps[name][1](state, tokens, labels)
            seq[name].append((float(m["loss"]), bool(m["overflow"]),
                              float(m["loss_scale"])))
        state = new["kernel"]
        del new
    ks, ps = seq["kernel"], seq["plain"]
    kn = [float(x) for x in norms["kernel"]]
    pn = [float(x) for x in norms["plain"]]
    loss_err = max(abs(a[0] - b[0]) for a, b in zip(ks, ps))
    check(loss_err <= TRAIN_LOSS_TOL,
          f"moe {routing} kernel vs plain losses {ks} {ps} differ by "
          f"{loss_err}")
    check([a[1:] for a in ks] == [b[1:] for b in ps],
          f"moe {routing} scaler decisions differ: kernel {ks} plain {ps}")
    check(not all(x[1] for x in ks), f"moe {routing}: every step overflowed")
    norm_err = max(abs(a - b) / b for a, b, s in zip(kn, pn, ks) if not s[1])
    check(norm_err <= GRAD_NORM_RTOL,
          f"moe {routing} grad norms kernel {kn} plain {pn}: {norm_err} > "
          f"{GRAD_NORM_RTOL}")
    return {"kernel": ks, "plain": ps, "grad_norm_kernel": kn,
            "grad_norm_plain": pn, "loss_err": loss_err,
            "grad_norm_rel_err": norm_err, "routing_drift": drift,
            "routing_flips": flips,
            "layers_with_unequal_loads": loads_differ}


def moe_quantized_phase(dev, master):
    """``quantize_params`` of the ragged model, then a teacher-forced
    ``gpt_forward`` on the b8 x s512 batch: exact launch counts (row 9's
    int8 branch at the 24 expert sites, row 10 at the 24 dense ones),
    forward time, tokens/s, forward MFU, device busy time, peak memory,
    kernel vs plain logits at every position with the kernel path routed
    by the plain path's probabilities (routing_drift; the free-running
    flips are reported), and the loss against the float forward on the
    same weights."""
    from apex_tpu_torch.models.quantized import param_bytes, quantize_params
    from apex_tpu_torch.models.transformer_lm import (
        gpt_forward, lm_cross_entropy)
    from apex_tpu_torch.ops import _kernel_utils as ku

    cfg = moe_cfg("ragged")
    qp = quantize_params(master)
    tokens, labels = moe_batch(cfg, MOE_BATCH, 0, dev)
    with torch.no_grad():
        gpt_forward(qp, tokens, cfg)                  # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        # --- the main path: counts reset just before, read just after ---
        ku.reset_launch_counts()
        logits = gpt_forward(qp, tokens, cfg)
        torch.cuda.synchronize()
        counts = ku.launch_counts()
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        L = cfg.num_layers
        want = {name: 0 for name in ku.KERNELS}
        want.update({"layer_norm_fwd": 2 * L + 1, "flash_attention_fwd": L,
                     "grouped_matmul_int8": 2 * L, "dense_int8": 2 * L})
        check(counts == want, f"moe int8 forward launches {counts} != {want}")
        print(f"launches (one quantized moe forward): {counts}")
        fwd_ms = [wall_ms(lambda: gpt_forward(qp, tokens, cfg))
                  for _ in range(TRAIN_STEPS)]
        q1, med, q3 = quartiles(fwd_ms)
        t_prof, busy, top, by_cat, by_op = profile_busy(
            lambda: gpt_forward(qp, tokens, cfg))
        lp, pp = moe_probe(qp, tokens, cfg, backend="reference")
        lk, pk = moe_probe(qp, tokens, cfg)
        flips = routing_flips(pk, pp, cfg.moe_top_k)
        probe_stats = pk.stats()
        free_err = max_err(lk, lp)
        del lk, pk
        lf, pf = moe_probe(qp, tokens, cfg, force=pp.probs)
        drift = routing_drift(pf, pp, cfg.moe_top_k)
        logit_err = max_err(lf, lp)
        del lf, pf, lp, pp
        check(drift["max_router_logit_err"] <= LOGIT_TOL,
              f"moe int8 forward: kernel vs plain router logits under one "
              f"routing {drift}")
        check(logit_err <= LOGIT_TOL,
              f"moe int8 forward kernel vs plain logits {logit_err}")
        loss_q = float(lm_cross_entropy(logits, labels))
        loss_f = float(lm_cross_entropy(gpt_forward(master, tokens, cfg),
                                        labels))
        check(abs(loss_q - loss_f) <= LOGIT_TOL,
              f"quantized loss {loss_q} vs float {loss_f}")
    n_params = sum(p.numel() for p in _leaves(master))
    n_active = moe_active_params(cfg, n_params)
    tokens_per_s = MOE_BATCH * MOE_SEQ / (med / 1e3)
    flops_per_tok = 2 * n_active + 4 * L * cfg.hidden_size * MOE_SEQ
    return {
        "forward_ms": med, "forward_ms_q1_q3": [q1, q3],
        "forwards_timed": TRAIN_STEPS, "tokens_per_s": tokens_per_s,
        "mfu": tokens_per_s * flops_per_tok / PEAK_BF16_FLOPS,
        "mfu_formula": "tokens/s x (2 x active params + 4 x L x h x s) / "
                       "989 TFLOP/s",
        "profiled_forward_ms": t_prof,
        "device_busy_ms": busy if busy > 0 else "not measured",
        "device_idle_share": (1 - busy / t_prof) if busy > 0
        else "not measured",
        "device_top_ms": top, "device_ms_by_category": by_cat,
        "device_ms_by_op": by_op, "peak_memory_gb": peak_gb,
        "param_bytes_quantized": param_bytes(qp),
        "param_bytes_float": param_bytes(master),
        "logit_err": logit_err, "logit_err_free_running": free_err,
        "routing_drift": drift, "routing_flips": flips,
        "loss_quantized": loss_q, "loss_float": loss_f,
        "counts": counts, **probe_stats,
    }


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


MOE_H, MOE_F = 768, 3072
QUANT_KB = 128


def _gmm_bound(off, n, k, p, w_bytes_per, x_bytes=2, out_bytes=2,
               scale_rows=0):
    """Least time of one row 9 call: x over the window's rows, the live
    groups' weights (and scale rows), every output row; operations on the
    window's rows at the bf16 tensor-core rate."""
    rows = off[-1] - off[0]
    live = sum(1 for a, b in zip(off, off[1:]) if b > a)
    nbytes = (rows * k * x_bytes + live * k * p * w_bytes_per
              + live * scale_rows * p * 4 + n * p * out_bytes
              + 4 * len(off))
    return bound(nbytes, 2 * rows * k * p, PEAK_BF16_FLOPS)


def _grouped_mm_library(x, w, offs, trans):
    """One ``torch._grouped_mm`` call for the same function (bf16, sm_90),
    where this torch has it: (callable, name) or (None, reason)."""
    fn = getattr(torch, "_grouped_mm", None)
    if fn is None:
        return None, "none: this torch has no torch._grouped_mm"
    wb = w.transpose(1, 2) if trans else w
    ends = offs[1:].contiguous()
    try:
        fn(x, wb, offs=ends)
        torch.cuda.synchronize()
    except RuntimeError as e:          # a layout this torch refuses
        return None, f"none: torch._grouped_mm refused: {str(e)[:160]}"
    return (lambda: fn(x, wb, offs=ends)), "torch._grouped_mm"


def kernel_grouped_matmul_moe(dev, gen, loads):
    """Row 9's 16-bit, transposed and int8 branches at the ragged MoE
    step's shapes (N = 8 x 512 token slots over the 8 experts with the
    loads the seeded ragged run routed in layer 0), each against the
    plain version on the card and timed as CUDA-graph replays beside its
    bound and ``torch._grouped_mm`` where it exists; adversarial offsets
    checked at small shapes; and ``_grouped_dw`` per call (fp32 operands
    and bf16 operands with an fp32 result).  Returns the three kernels'
    results and the dw timing."""
    from apex_tpu_torch.ops import grouped_matmul as tgm

    sys.path.insert(0, str(Path(__file__).resolve().parent / "tests"))
    from torch_gmm_cases import ADVERSARIAL, MOE, TILE_EDGES, offsets_case

    n, g = sum(loads), len(loads)
    off = [0]
    for c in loads:
        off.append(off[-1] + c)
    offs = torch.tensor(off, dtype=torch.int32, device=dev)
    bf = torch.bfloat16

    def rnd(*shape, scale=1.0):
        return (torch.randn(*shape, device=dev, generator=gen)
                * scale).to(bf)

    x1, x2 = rnd(n, MOE_H), rnd(n, MOE_F)
    g1, g2 = rnd(n, MOE_F), rnd(n, MOE_H)
    w1, w2 = rnd(g, MOE_H, MOE_F, scale=0.02), rnd(g, MOE_F, MOE_H,
                                                     scale=0.02)
    q1 = tgm.quantize_group_weights(w1.float(), QUANT_KB)
    q2 = tgm.quantize_group_weights(w2.float(), QUANT_KB)
    calls = {
        "grouped_matmul_mma": [("fc1 forward", x1, w1, False),
                               ("fc2 forward", x2, w2, False)],
        "grouped_matmul_mma_t": [("fc1 dx", g1, w1, True),
                                 ("fc2 dx", g2, w2, True)],
    }
    out = {}
    for kname, cl in calls.items():
        errs, abs_err, variants, lib_notes = {}, 0.0, {}, {}
        for name, x, w, trans in cl:
            got = tgm._gmm_route(x, w, offs, False, trans=trans)
            wf = w.transpose(1, 2) if trans else w
            want = tgm.grouped_matmul_reference(x, wf, offs)
            errs[name] = rel_err(got, want)
            abs_err = max(abs_err, max_err(got, want))
            check(errs[name] <= GMM_TOL[bf], f"row 9 {kname} {name} {errs}")
            k, p = x.shape[1], wf.shape[2]
            bms, by = _gmm_bound(off, n, k, p, 2)
            lib, note = _grouped_mm_library(x, w, offs, trans)
            lib_ms = None
            if lib is not None:
                lib_notes[name] = f"{note}, error {rel_err(lib(), want):.3g}"
                lib_ms = time_ms(lib)
            else:
                lib_notes[name] = note
            variants[f"{name} N={n} k={k} p={p}"] = {
                "ms": time_ms(lambda: tgm._gmm_route(x, w, offs, False,
                                                     trans=trans)),
                "plain_ms": time_ms(
                    lambda: tgm.grouped_matmul_reference(x, wf, offs),
                    iters=5),
                "library_ms": lib_ms, "bound_ms": bms, "bound_by": by,
                "library": lib_notes[name]}
            del got, want
        out[kname] = (errs, abs_err, variants)
    errs, abs_err, variants = {}, 0.0, {}
    for name, x, q in (("fc1 int8", x1, q1), ("fc2 int8", x2, q2)):
        got = tgm.grouped_matmul_quantized(x, q["wire"], q["scale"], offs)
        want = tgm.grouped_matmul_quantized(x, q["wire"], q["scale"], offs,
                                            backend="reference")
        errs[name] = rel_err(got, want)
        abs_err = max(abs_err, max_err(got, want))
        check(errs[name] <= GMM_TOL[bf], f"row 9 int8 {name} {errs}")
        k, p = q["wire"].shape[1:]
        bms, by = _gmm_bound(off, n, k, p, 1,
                             scale_rows=q["scale"].shape[1])
        variants[f"{name} N={n} k={k} p={p} kb={QUANT_KB}"] = {
            "ms": time_ms(lambda: tgm.grouped_matmul_quantized(
                x, q["wire"], q["scale"], offs)),
            "plain_ms": time_ms(lambda: tgm.grouped_matmul_quantized(
                x, q["wire"], q["scale"], offs, backend="reference"),
                iters=5),
            "library_ms": None, "bound_ms": bms, "bound_by": by,
            "library": "none: no PyTorch call multiplies by an int8 slab "
                       "with per-block scales"}
        del got, want
    out["grouped_matmul_int8"] = (errs, abs_err, variants)

    # adversarial offsets (checked, not timed): windows, empty groups,
    # N < 64, G = 70, segments across 128-row tiles, one expert holding
    # all rows but one, at shapes with a partial column tile
    for case in ADVERSARIAL + MOE[1:] + TILE_EDGES:
        na, ga, oa = offsets_case(case)
        oa_t = torch.as_tensor(oa, device=dev)
        xa, wa = rnd(na, 64), rnd(ga, 64, 72, scale=0.1)
        for kname, trans in (("grouped_matmul_mma", False),
                             ("grouped_matmul_mma_t", True)):
            # trans reads the [G, 64, 72] slab as [G, 72, 64]
            xin = rnd(na, 72) if trans else xa
            got = tgm._gmm_route(xin, wa, oa_t, False, trans=trans)
            want = tgm.grouped_matmul_reference(
                xin, wa.transpose(1, 2) if trans else wa, oa_t)
            e = rel_err(got, want) if oa[-1] > oa[0] else 0.0
            check(int(torch.count_nonzero(got[:oa[0]]))
                  + int(torch.count_nonzero(got[oa[-1]:])) == 0,
                  f"row 9 {kname} {case}: rows outside the window")
            check(e <= GMM_TOL[bf], f"row 9 {kname} {case} error {e}")
            out[kname][0][case] = e
        qa = tgm.quantize_group_weights(rnd(ga, 64, 80).float(), 32)
        got = tgm.grouped_matmul_quantized(xa, qa["wire"], qa["scale"], oa_t)
        want = tgm.grouped_matmul_quantized(xa, qa["wire"], qa["scale"],
                                            oa_t, backend="reference")
        e = rel_err(got, want) if oa[-1] > oa[0] else 0.0
        check(e <= GMM_TOL[bf], f"row 9 int8 {case} error {e}")
        out["grouped_matmul_int8"][0][case] = e

    shapes = (f"N={n} token slots over {g} experts with loads {loads} "
              f"(the ragged run's layer 0), bf16")
    desc = {
        "grouped_matmul_mma": "sum of one ragged MoE layer's 2 forward "
        "calls: fc1 [N, 768] x [8, 768, 3072] and fc2 [N, 3072] x "
        "[8, 3072, 768]; ",
        "grouped_matmul_mma_t": "sum of one ragged MoE layer's 2 dx calls "
        "(the transposed read): [N, 3072] x w1[g]^T and [N, 768] x "
        "w2[g]^T; ",
        "grouped_matmul_int8": "sum of one quantized ragged MoE layer's 2 "
        "int8-slab calls: scales [8, 6, 3072] and [8, 24, 768] (kb 128); ",
    }
    results = {}
    for kname, (errs, abs_err, variants) in out.items():
        timed = list(variants.values())
        libs = [v["library_ms"] for v in timed]
        results[kname] = {
            "err": abs_err, "rel_err": max(errs.values()),
            "tol": GMM_TOL[bf], "detail": errs,
            "ms": sum(v["ms"] for v in timed),
            "plain_ms": sum(v["plain_ms"] for v in timed),
            "library_ms": (None if any(v is None for v in libs)
                           else sum(libs)),
            "bound_ms": sum(v["bound_ms"] for v in timed),
            "bound_by": ("bytes" if all(v["bound_by"] == "bytes"
                                        for v in timed) else "operations"),
            "variants": variants,
            "shape": desc[kname] + shapes + "; adversarial offsets "
            "checked at k=64, p=72 (int8 p=80, kb 32)",
        }

    # _grouped_dw per call: the masked full-N products, as the JAX
    # package's XLA composition (no kernel of this repository)
    dw = {}
    for name, x, gg in (("fc1 dw", x1, g1), ("fc2 dw", x2, g2)):
        # fp32 operands take the widened route, bf16 ones the bf16 x bf16
        # -> fp32 products
        x32, g32 = x.float(), gg.float()
        a = tgm._grouped_dw(x32, g32, offs)
        b = tgm._grouped_dw(x, gg, offs)
        k, p = x.shape[1], gg.shape[1]
        dw[name] = {
            "fp32_operands_ms": time_ms(
                lambda: tgm._grouped_dw(x32, g32, offs), iters=3),
            "bf16_operands_fp32_result_ms": time_ms(
                lambda: tgm._grouped_dw(x, gg, offs), iters=3),
            "rel_diff": rel_err(b, a),
            "flops_computed": 2 * g * n * k * p,
            "flops_needed": 2 * n * k * p,
            "bound_ms": bound((n * k + n * p) * 2 + g * k * p * 4,
                              2 * n * k * p, PEAK_BF16_FLOPS)[0]}
        check(dw[name]["rel_diff"] <= 1e-2, f"_grouped_dw {name}: {dw}")
        del a, b, x32, g32
    return results, dw


def generic_mask_phase(dev):
    """A [b, 1, s, s] bool mask through ``gpt_forward`` on GPT-2 125M
    widths (2 layers, b2 x s256, attention_backend="flash"): the generic
    mask takes the materialized-score path, so row 11 runs once per layer
    and K2 never; logits against the plain path."""
    from apex_tpu_torch.models.config import gpt_125m
    from apex_tpu_torch.models.transformer_lm import (
        gpt_forward, init_gpt_params)
    from apex_tpu_torch.ops import _kernel_utils as ku

    cfg = gpt_125m(num_layers=2, max_position_embeddings=256)
    params = init_gpt_params(cfg, torch.Generator().manual_seed(0), dev)
    gen = torch.Generator().manual_seed(2)
    b, s = 2, 256
    tokens = torch.randint(0, VOCAB_LIMIT, (b, s), generator=gen).to(dev)
    mask = (torch.rand(b, 1, s, s, generator=gen) < 0.2).to(dev)
    with torch.no_grad():
        ku.reset_launch_counts()
        got = gpt_forward(params, tokens, cfg, attention_mask=mask)
        torch.cuda.synchronize()
        counts = ku.launch_counts()
        want_counts = {name: 0 for name in ku.KERNELS}
        want_counts.update({"layer_norm_fwd": 2 * cfg.num_layers + 1,
                            "scaled_softmax_fwd": cfg.num_layers})
        check(counts == want_counts,
              f"generic-mask launches {counts} != {want_counts}")
        plain = gpt_forward(params, tokens, cfg, attention_mask=mask,
                            backend="reference")
    err = max_err(got, plain)
    check(err <= LOGIT_TOL, f"generic-mask logits kernel vs plain {err}")
    return {"counts": counts, "logit_err": err,
            "shape": f"gpt_125m widths, 2 layers, b{b} x s{s}, "
                     f"[{b}, 1, {s}, {s}] bool mask, flash backend"}


# ---------------------------------------------------------------------------
# slice 15: attention dropout and segment ids in rows 3, 4a, 4b and 5, the
# wide-head branches of rows 3, 4a and 4b, row 9's CUDA-core int8 branch;
# the dropout train steps and the packed-attention path
# ---------------------------------------------------------------------------

DROPOUT_P = 0.1                 # GPT-2's and BERT-large's published rates
DROPOUT_WORDS = (0x1234, 0xABCD)
# packed attention at GPT-2 widths: seeded documents of 64-2048 tokens in
# [16384, 12, 64] (the last document cut at the end)
PACKED_TOKENS, PACKED_HEADS, PACKED_DIM = 16384, 12, 64
PACKED_DOC_LENS = (64, 2048)
PACKED_PREFIX_TOKENS = 4096     # the prefix held by the one-piece plain
PACKED_PLAIN_ROWS = 1024        # query rows a block of the plain version
# wide heads: Gemma's 256 and one size above it, b4 s1024 n8 causal bf16
WIDE_SHAPE, WIDE_DIMS = (4, 1024, 8), (256, 320)
# the dropout steps are timed over fewer steps, without a profile
DROPOUT_STEPS = 10


def _dropout_seed(dev):
    from apex_tpu_torch.ops import flash_attention as tfa

    return tfa.seed_from_key(torch.tensor(DROPOUT_WORDS, dtype=torch.int64,
                                          device=dev))


def _sdpa_fwd_bwd_ms(q, k, v, do, **kw):
    """SDPA's forward and its backward alone (forward and backward timed
    together, less the forward), BSND inputs, ``kw`` SDPA's."""
    qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_()
                  for t in (q, k, v))
    dot = do.transpose(1, 2)

    def sdpa():
        return F.scaled_dot_product_attention(qt, kt, vt, **kw)

    fwd = time_ms(sdpa)
    return fwd, time_ms(lambda: torch.autograd.grad(sdpa(), (qt, kt, vt),
                                                    dot)) - fwd


def _fwd_bwd_bounds(b, s, n, d, pairs, extra_bytes=0):
    """Bounds of the forward, K6, K7 and row 5 (the one-pass backward) for
    ``pairs`` open (query, key) pairs over q, k, v of [b, s, n, d] bf16."""
    t = b * s * n * d * 2
    stats = 2 * b * n * s * 4
    return {"fwd": bound(4 * t + b * n * s * 4 + extra_bytes, 4 * d * pairs,
                         PEAK_BF16_FLOPS),
            "dq": bound(5 * t + stats + extra_bytes, 6 * d * pairs,
                        PEAK_BF16_FLOPS),
            "dkv": bound(6 * t + stats + extra_bytes, 8 * d * pairs,
                         PEAK_BF16_FLOPS),
            "short": bound(7 * t + stats + extra_bytes, 10 * d * pairs,
                           PEAK_BF16_FLOPS)}


def _hold_fwd_bwd(q, k, v, do, kw, what, bwd_route):
    """K2's forward and the backward route (``"split"``: K6 and K7, or
    ``"short"``: row 5) with ``kw`` against the plain versions; returns
    the forward's max abs error and each gradient's relative error.  The
    masks are the same bits on both sides, so the dropout-free tolerances
    hold, times 1/(1 - p)."""
    from apex_tpu_torch.ops import flash_attention as tfa

    scale = 1.0 / (1.0 - kw.get("dropout_p", 0.0))
    o, lse = tfa.flash_attention_fwd(q, k, v, **kw)
    ro, _ = tfa.flash_attention_fwd_ref(q, k, v, **kw)
    errs = {f"{what} o": max_err(o, ro)}
    del ro
    check(errs[f"{what} o"] <= 2e-2 * scale, f"K2 {what}: {errs}")
    bkw = {key: val for key, val in kw.items() if key != "causal"}
    ops = tfa.flash_bwd_operands(q, k, v, o, lse, do, **bkw)
    if bwd_route == "short":
        got = tfa.flash_bwd_fused(ops, causal=kw["causal"])
    else:
        got = (tfa.flash_bwd_dq(ops, causal=kw["causal"]),
               *tfa.flash_bwd_dkv(ops, causal=kw["causal"]))
    want = tfa.flash_attention_bwd_ref(q, k, v, o, lse, do, **kw)
    for name, a, e in zip(("dq", "dk", "dv"), got, want):
        errs[f"{what} {name}"] = rel_err(a, e)
    del want, got
    check(max(v_ for k_, v_ in errs.items() if not k_.endswith(" o"))
          <= FLASH_BWD_TOL * scale, f"{bwd_route} backward {what}: {errs}")
    return errs, ops


def _plain_blocks(q, k, v, o, lse, do, kw):
    """The plain version of one call computed in blocks of
    PACKED_PLAIN_ROWS query rows (``q_offset``: global rows for the causal
    mask and the hash; each block's ids against the row's): with ``o`` None
    the forward → (o, lse), else the backward from the kernel's ``o``,
    ``lse`` and ``do`` → (dq, dk, dv), dk and dv summed over the blocks
    in fp32 (the block's inputs widened to fp32, which the plain backward
    computes in anyway)."""
    from apex_tpu_torch.ops import flash_attention as tfa

    b, sq, n, _ = q.shape
    seg = kw.get("segment_ids")
    outs, dk, dv = [], 0.0, 0.0
    for r0 in range(0, sq, PACKED_PLAIN_ROWS):
        rows = slice(r0, min(sq, r0 + PACKED_PLAIN_ROWS))
        bkw = dict(kw, q_offset=r0)
        if seg is not None:
            bkw["segment_ids"] = (seg[:, rows], seg)
        if o is None:
            ob, lb = tfa.flash_attention_fwd_ref(q[:, rows], k, v, **bkw)
            outs.append((ob, lb.reshape(b, n, -1)))
            continue
        lb = lse.reshape(b, n, sq)[:, :, rows].reshape(b * n, -1)
        gq, gk, gv = tfa.flash_attention_bwd_ref(
            q[:, rows].float(), k.float(), v.float(), o[:, rows], lb,
            do[:, rows].float(), **bkw)
        outs.append(gq.to(q.dtype))
        dk, dv = dk + gk, dv + gv
    if o is None:
        return (torch.cat([x for x, _ in outs], 1),
                torch.cat([x for _, x in outs], 2).reshape(b * n, sq))
    return torch.cat(outs, 1), dk.to(k.dtype), dv.to(v.dtype)


def _hold_packed(q, k, v, do, kw):
    """K2, K6 and K7 on one packed call with ``kw`` against the plain
    version of the whole call computed in query blocks; the same masks on
    both sides, so the dropout-free tolerances hold, times 1/(1 - p).
    The forward's error is taken over 1 + |plain|: the whole row holds
    outputs of 4-8 (a document's first rows average few values, scaled
    by 1/(1 - p)), where one bf16 step of either side's rounding is
    2**-5, above the absolute 2e-2 that the smaller shapes hold."""
    from apex_tpu_torch.ops import flash_attention as tfa

    scale = 1.0 / (1.0 - kw.get("dropout_p", 0.0))
    what = "packed segments + dropout, whole row"
    o, lse = tfa.flash_attention_fwd(q, k, v, **kw)
    ro, rlse = _plain_blocks(q, k, v, None, None, None, kw)
    diff = (o.float() - ro.float()).abs()
    at = int(diff.argmax())
    errs = {f"{what} o": float((diff / (1 + ro.float().abs())).max()),
            f"{what} o abs": float(diff.max()),
            f"{what} |plain o| at the largest abs error": float(
                ro.float().reshape(-1)[at].abs())}
    del ro, rlse, diff
    check(errs[f"{what} o"] <= 2e-2 * scale, f"K2 {what}: {errs}")
    ops = tfa.flash_bwd_operands(q, k, v, o, lse, do,
                                 **{a: b for a, b in kw.items()
                                    if a != "causal"})
    got = (tfa.flash_bwd_dq(ops, causal=kw["causal"]),
           *tfa.flash_bwd_dkv(ops, causal=kw["causal"]))
    want = _plain_blocks(q, k, v, o, lse, do, kw)
    for name, a, e in zip(("dq", "dk", "dv"), got, want):
        errs[f"{what} {name}"] = rel_err(a, e)
    check(max(errs[f"{what} {name}"] for name in ("dq", "dk", "dv"))
          <= FLASH_BWD_TOL * scale, f"split backward {what}: {errs}")
    return errs


def _packed_docs(total, gen):
    """Seeded document lengths in PACKED_DOC_LENS filling ``total`` (the
    last one cut at the end) → cu_seqlens (int32, CPU)."""
    lens, pos = [], 0
    while pos < total:
        n = int(torch.randint(PACKED_DOC_LENS[0], PACKED_DOC_LENS[1] + 1,
                              (1,), generator=gen))
        n = min(n, total - pos)
        lens.append(n)
        pos += n
    return torch.tensor([0] + lens, dtype=torch.int64).cumsum(0).to(
        torch.int32)


def _block_diag_mask(cu, total, causal, dev):
    """The [total, total] bool keep-mask of packed documents (True = the
    query sees the key), for SDPA."""
    doc = torch.searchsorted(cu.to(dev).long(), torch.arange(
        total, device=dev), right=True)
    m = doc[:, None] == doc[None]
    if causal:
        m &= torch.ones(total, total, dtype=torch.bool, device=dev).tril()
    return m


def kernel_flash_branches(dev, gen):
    """Rows 3, 4a, 4b and 5's dropout and segment branches at the main
    paths' shapes against their plain versions (the same seed and ids):
    K2, K6 and K7 with dropout at the GPT step's shape (b16 s1024 n12
    d64 causal); K2 and row 5 with dropout at BERT-large's (b8 s512 n16
    d64, ragged key padding); K2 and row 5 with segment ids at BERT's
    shape (2-4 documents a row); timed beside SDPA with ``dropout_p`` (its
    masks differ: the same work) and with a materialized block-diagonal
    mask.  → ``{kernel: {variant: {...}}}`` and the errors."""
    from apex_tpu_torch.ops import flash_attention as tfa

    p, seed = DROPOUT_P, _dropout_seed(dev)
    out = {k: {} for k in ("flash_attention_fwd", "flash_attention_bwd_dq",
                           "flash_attention_bwd_dkv",
                           "flash_attention_bwd_short")}
    errs = {}
    # --- dropout at the GPT step's shape: K2, K6, K7 ---------------------
    b, s, n, d = TRAIN_BATCH, TRAIN_SEQ, 12, 64
    q, k, v, do = (torch.randn(b, s, n, d, device=dev,
                               generator=gen).bfloat16() for _ in range(4))
    kw = dict(causal=True, dropout_p=p, seed=seed)
    e, ops = _hold_fwd_bwd(q, k, v, do, kw, "gpt dropout", "split")
    errs.update(e)
    bd = _fwd_bwd_bounds(b, s, n, d, n * b * s * (s + 1) // 2)
    plain_f = time_ms(lambda: tfa.flash_attention_fwd_ref(q, k, v, **kw),
                      iters=2, reps=2)
    o, lse = tfa.flash_attention_fwd(q, k, v, **kw)
    plain_b = time_ms(lambda: tfa.flash_attention_bwd_ref(
        q, k, v, o, lse, do, **kw), iters=2, reps=2)
    lib_f, lib_b = _sdpa_fwd_bwd_ms(q, k, v, do, is_causal=True,
                                    dropout_p=p)
    name = f"dropout {p} gpt step b{b} s{s} n{n} d{d} causal"
    out["flash_attention_fwd"][name] = {
        "ms": time_ms(lambda: tfa.flash_attention_fwd(q, k, v, **kw)),
        "plain_ms": plain_f, "library_ms": lib_f,
        "bound_ms": bd["fwd"][0], "bound_by": bd["fwd"][1]}
    for kname, fn, bkey in (
            ("flash_attention_bwd_dq",
             lambda: tfa.flash_bwd_dq(ops, causal=True), "dq"),
            ("flash_attention_bwd_dkv",
             lambda: tfa.flash_bwd_dkv(ops, causal=True), "dkv")):
        out[kname][name] = {"ms": time_ms(fn), "plain_ms": plain_b,
                            "library_ms": lib_b,
                            "bound_ms": bd[bkey][0], "bound_by": bd[bkey][1]}
    del q, k, v, do, o, lse, ops
    # --- dropout and segments at BERT's shape: K2, row 5 -----------------
    b, s, n, d = BERT_BATCH, BERT_SEQ, 16, 64
    lens = bert_lens(b, s, torch.Generator().manual_seed(6)).to(dev)
    kpm = torch.arange(s, device=dev)[None] >= lens[:, None]
    add = torch.where(kpm, -1e30, 0.0).bfloat16()[:, None, None, :]
    q, k, v, do = (torch.randn(b, s, n, d, device=dev,
                               generator=gen).bfloat16() for _ in range(4))
    sgen = torch.Generator().manual_seed(7)
    seg = torch.stack([torch.repeat_interleave(
        torch.arange(4), torch.diff(torch.cat([
            torch.tensor([0]), torch.sort(torch.randint(
                1, s, (3,), generator=sgen)).values, torch.tensor([s])])))
        for _ in range(b)]).to(torch.int32).to(dev)
    keep = (seg[:, :, None] == seg[:, None, :])[:, None]
    for what, kw, pairs, lib_kw in (
            ("dropout", dict(causal=False, key_padding_mask=kpm,
                             dropout_p=p, seed=seed),
             int(lens.sum()) * s * n, dict(attn_mask=add, dropout_p=p)),
            ("segments", dict(causal=False, segment_ids=seg),
             int(keep.sum()) * n, dict(attn_mask=keep))):
        e, ops = _hold_fwd_bwd(q, k, v, do, kw, f"bert {what}", "short")
        errs.update(e)
        bd = _fwd_bwd_bounds(b, s, n, d, pairs)
        plain_f = time_ms(lambda: tfa.flash_attention_fwd_ref(q, k, v, **kw),
                          iters=2, reps=2)
        o, lse = tfa.flash_attention_fwd(q, k, v, **kw)
        plain_b = time_ms(lambda: tfa.flash_attention_bwd_ref(
            q, k, v, o, lse, do, **kw), iters=2, reps=2)
        lib_f, lib_b = _sdpa_fwd_bwd_ms(q, k, v, do, **lib_kw)
        name = (f"{what}{' ' + str(p) if what == 'dropout' else ''} bert "
                f"b{b} s{s} n{n} d{d} non-causal"
                + (", ragged padding" if what == "dropout"
                   else ", 4 documents a row"))
        out["flash_attention_fwd"][name] = {
            "ms": time_ms(lambda: tfa.flash_attention_fwd(q, k, v, **kw)),
            "plain_ms": plain_f, "library_ms": lib_f,
            "bound_ms": bd["fwd"][0], "bound_by": bd["fwd"][1]}
        out["flash_attention_bwd_short"][name] = {
            "ms": time_ms(lambda: tfa.flash_bwd_fused(ops, causal=False)),
            "plain_ms": plain_b, "library_ms": lib_b,
            "bound_ms": bd["short"][0], "bound_by": bd["short"][1]}
        del ops, o, lse
    return out, errs


def packed_phase(dev, gen):
    """The packed-attention path at GPT-2 widths: seeded documents of
    64-2048 tokens packed into [16384, 12, 64] bf16 with cu_seqlens,
    causal, dropout 0.1, forward and backward through
    ``flash_attention_packed`` (exact launches: K2, K6 and K7 once each;
    16384 keys take the split pair).  Held: without dropout, each
    document's rows and gradients against one ``flash_attention`` call on
    that document alone (kernel against kernel, bf16 tolerance); with
    dropout and segments, K2, K6 and K7 against the plain version of the
    whole row, computed in blocks of query rows.  Timed: the packed forward and backward, K2, K6 and K7 on the
    packed rows (their segment branches) against a dense causal call over
    the same 16384 tokens (the tile skip) and SDPA with the materialized
    block-diagonal mask."""
    from apex_tpu_torch.ops import _kernel_utils as ku
    from apex_tpu_torch.ops import flash_attention as tfa

    total, n, d, p = PACKED_TOKENS, PACKED_HEADS, PACKED_DIM, DROPOUT_P
    cu = _packed_docs(total, torch.Generator().manual_seed(8))
    doc_lens = torch.diff(cu).tolist()
    cu_d = cu.to(dev)
    q, k, v, do = (torch.randn(total, n, d, device=dev,
                               generator=gen).bfloat16() for _ in range(4))
    words = torch.tensor(DROPOUT_WORDS, dtype=torch.int64, device=dev)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]

    def packed_step(drop=True):
        # autograd.grad, not backward(): no gradient accumulates on the
        # leaves, so the call captures in a CUDA graph
        out = tfa.flash_attention_packed(
            *leaves, cu_d, causal=True, dropout_p=p if drop else 0.0,
            dropout_rng=words if drop else None)
        return out, torch.autograd.grad(out, leaves, do)

    packed_step()
    torch.cuda.synchronize()
    # --- the path: counts reset just before, read just after -------------
    ku.reset_launch_counts()
    packed_step()
    torch.cuda.synchronize()
    counts = ku.launch_counts()
    want = {name: 0 for name in ku.KERNELS}
    want.update({"flash_attention_fwd": 1, "flash_attention_bwd_dq": 1,
                 "flash_attention_bwd_dkv": 1})
    check(counts == want, f"packed launches {counts} != {want}")
    # --- held: per-document kernel calls (no dropout) --------------------
    out, grads = packed_step(drop=False)
    errs, start = {}, 0
    for L in doc_lens:
        sl = slice(start, start + L)
        parts = [t[sl][None].clone().requires_grad_() for t in (q, k, v)]
        one = tfa.flash_attention(*parts, causal=True)
        one.backward(do[sl][None])
        errs[f"doc {L} o"] = rel_err(out[sl].detach(), one[0].detach())
        for name, grad, part in zip(("dq", "dk", "dv"), grads, parts):
            errs[f"doc {L} {name}"] = rel_err(grad[sl], part.grad[0])
        start += L
    check(max(errs.values()) <= FLASH_BWD_TOL,
          f"packed rows against per-document calls: {errs}")
    # --- held: dropout, kernel against plain on the first 4096 tokens ----
    tp = PACKED_PREFIX_TOKENS
    cu_p = torch.clamp(cu, max=tp).unique().to(torch.int32)
    seg = tfa.segment_ids_from_cu_seqlens(cu_p.to(dev), tp)[None]
    kw = dict(causal=True, dropout_p=p, seed=_dropout_seed(dev),
              segment_ids=seg)
    perr, _ = _hold_fwd_bwd(*(t[:tp][None] for t in (q, k, v, do)), kw,
                            "packed dropout 4096", "split")
    errs.update(perr)
    # --- held: dropout and segments, kernel against plain, whole row ------
    q4, k4, v4, do4 = (t[None] for t in (q, k, v, do))
    seg_all = tfa.segment_ids_from_cu_seqlens(cu_d, total)[None]
    pkw = dict(causal=True, dropout_p=p, seed=_dropout_seed(dev),
               segment_ids=seg_all)
    perr = _hold_packed(q4, k4, v4, do4, pkw)
    errs.update(perr)
    # --- timed -------------------------------------------------------------
    # --- timed -------------------------------------------------------------
    o, lse = tfa.flash_attention_fwd(q4, k4, v4, **pkw)
    ops = tfa.flash_bwd_operands(q4, k4, v4, o, lse, do4,
                                 **{a: b for a, b in pkw.items()
                                    if a != "causal"})
    dense_o, dense_lse = tfa.flash_attention_fwd(q4, k4, v4, causal=True)
    dops = tfa.flash_bwd_operands(q4, k4, v4, dense_o, dense_lse, do4)
    pairs = n * sum(L * (L + 1) // 2 for L in doc_lens)
    dense_pairs = n * total * (total + 1) // 2
    bd = _fwd_bwd_bounds(1, total, n, d, pairs, extra_bytes=total * 4)
    mask = _block_diag_mask(cu, total, True, dev)
    lib_f, lib_b = _sdpa_fwd_bwd_ms(q4, k4, v4, do4, attn_mask=mask)
    del mask
    def fwd_bwd(kw):
        # K2, then K6 and K7 on its o and lse, called directly: the
        # autograd backward runs on autograd's thread, outside a capture
        o_, lse_ = tfa.flash_attention_fwd(q4, k4, v4, **kw)
        ops_ = tfa.flash_bwd_operands(
            q4, k4, v4, o_, lse_, do4,
            **{a: b for a, b in kw.items() if a != "causal"})
        return (tfa.flash_bwd_dq(ops_, causal=True),
                tfa.flash_bwd_dkv(ops_, causal=True))

    ms = {
        "packed_fwd_bwd_ms": time_ms(lambda: fwd_bwd(pkw), iters=3),
        "dense_causal_fwd_bwd_ms": time_ms(
            lambda: fwd_bwd(dict(causal=True)), iters=3),
        "packed_fwd_ms": time_ms(lambda: tfa.flash_attention_fwd(
            q4, k4, v4, **pkw)),
        "packed_k6_ms": time_ms(lambda: tfa.flash_bwd_dq(ops, causal=True)),
        "packed_k7_ms": time_ms(lambda: tfa.flash_bwd_dkv(ops, causal=True)),
        "dense_causal_fwd_ms": time_ms(lambda: tfa.flash_attention_fwd(
            q4, k4, v4, causal=True)),
        "dense_causal_k6_ms": time_ms(lambda: tfa.flash_bwd_dq(
            dops, causal=True)),
        "dense_causal_k7_ms": time_ms(lambda: tfa.flash_bwd_dkv(
            dops, causal=True)),
        "sdpa_block_diagonal_fwd_ms": lib_f,
        "sdpa_block_diagonal_bwd_ms": lib_b,
    }
    variants = {}
    name = (f"segments + dropout {p}: packed [{total}, {n}, {d}] causal, "
            f"{len(doc_lens)} documents")
    plain_note = (f"plain_ms: the plain version of the whole row in "
                  f"blocks of {PACKED_PLAIN_ROWS} query rows (its "
                  "materialized scores of all rows do not fit)")
    plain_f = time_ms(lambda: _plain_blocks(q4, k4, v4, None, None, None,
                                            pkw), iters=1, reps=2)
    plain_b = time_ms(lambda: _plain_blocks(q4, k4, v4, o, lse, do4, pkw),
                      iters=1, reps=2)
    for kname, key, bkey, lib in (
            ("flash_attention_fwd", "packed_fwd_ms", "fwd", lib_f),
            ("flash_attention_bwd_dq", "packed_k6_ms", "dq", lib_b),
            ("flash_attention_bwd_dkv", "packed_k7_ms", "dkv", lib_b)):
        variants[kname] = {name: {
            "ms": ms[key], "plain_ms": plain_b if bkey != "fwd" else plain_f,
            "library_ms": lib, "bound_ms": bd[bkey][0],
            "bound_by": bd[bkey][1], "note": plain_note}}
    return {"counts": counts, "errs": errs, "tol": FLASH_BWD_TOL,
            "documents": len(doc_lens), "doc_lens": doc_lens,
            "open_pairs": pairs, "dense_causal_pairs": dense_pairs,
            "variants": variants, **ms}


def kernel_flash_wide(dev, gen):
    """The wide-head branches of rows 3, 4a and 4b (flash_attention_fwd_
    wide, flash_attention_bwd_dq_wide, flash_attention_bwd_dkv_wide) at
    head sizes 256 (Gemma's) and 320, b4 s1024 n8 causal bf16, against the
    plain forward and backward, beside SDPA (forward and backward) at the
    same head size; and the wide-head path: one differentiable
    ``flash_attention`` call with dropout at d256, forward and backward,
    exact launches.  → (results by kernel, path counts)."""
    from apex_tpu_torch.ops import _kernel_utils as ku
    from apex_tpu_torch.ops import flash_attention as tfa

    b, s, n = WIDE_SHAPE
    res = {}
    for d in WIDE_DIMS:
        q, k, v, do = (torch.randn(b, s, n, d, device=dev,
                                   generator=gen).bfloat16()
                       for _ in range(4))
        kw = dict(causal=True)
        errs, ops = _hold_fwd_bwd(q, k, v, do, kw, f"wide d{d}", "split")
        bd = _fwd_bwd_bounds(b, s, n, d, n * b * s * (s + 1) // 2)
        o, lse = tfa.flash_attention_fwd(q, k, v, **kw)
        plain_f = time_ms(lambda: tfa.flash_attention_fwd_ref(q, k, v, **kw),
                          iters=2, reps=2)
        plain_b = time_ms(lambda: tfa.flash_attention_bwd_ref(
            q, k, v, o, lse, do, **kw), iters=2, reps=2)
        lib_f, lib_b = _sdpa_fwd_bwd_ms(q, k, v, do, is_causal=True)
        shape = f"b{b} s{s} n{n} d{d} bf16 causal"
        for kname, fn, bkey, plain, lib in (
                ("flash_attention_fwd_wide",
                 lambda: tfa.flash_attention_fwd(q, k, v, **kw), "fwd",
                 plain_f, lib_f),
                ("flash_attention_bwd_dq_wide",
                 lambda: tfa.flash_bwd_dq(ops, causal=True), "dq", plain_b,
                 lib_b),
                ("flash_attention_bwd_dkv_wide",
                 lambda: tfa.flash_bwd_dkv(ops, causal=True), "dkv", plain_b,
                 lib_b)):
            row = {"ms": time_ms(fn), "plain_ms": plain, "library_ms": lib,
                   "bound_ms": bd[bkey][0], "bound_by": bd[bkey][1]}
            if d == WIDE_DIMS[0]:
                err_keys = [e for e in errs if (e.endswith(" o"))
                            == (bkey == "fwd")]
                res[kname] = dict(
                    row, err=max(errs[e] for e in err_keys),
                    tol=2e-2 if bkey == "fwd" else FLASH_BWD_TOL,
                    detail=errs, shape=shape + (
                        "; plain and library = the whole backward"
                        if bkey != "fwd" else ""), variants={})
                if bkey != "fwd":
                    res[kname]["rel_err"] = res[kname]["err"]
            else:
                res[kname]["variants"][shape] = dict(row, detail=errs)
        del q, k, v, do, o, lse, ops
    # --- the wide-head path ---------------------------------------------
    d = WIDE_DIMS[0]
    leaves = [torch.randn(b, s, n, d, device=dev, generator=gen).bfloat16()
              .requires_grad_() for _ in range(3)]
    do = torch.randn(b, s, n, d, device=dev, generator=gen).bfloat16()
    words = torch.tensor(DROPOUT_WORDS, dtype=torch.int64, device=dev)
    torch.cuda.synchronize()
    ku.reset_launch_counts()
    tfa.flash_attention(*leaves, causal=True, dropout_p=DROPOUT_P,
                        dropout_rng=words).backward(do)
    torch.cuda.synchronize()
    counts = ku.launch_counts()
    want = {name: 0 for name in ku.KERNELS}
    want.update({"flash_attention_fwd_wide": 1,
                 "flash_attention_bwd_dq_wide": 1,
                 "flash_attention_bwd_dkv_wide": 1})
    check(counts == want, f"wide-head launches {counts} != {want}")
    check(all(torch.isfinite(t.grad.float()).all() for t in leaves),
          "wide-head path: non-finite gradients")
    return res, counts


def kernel_gmm_int8_simt(dev, gen):
    """Row 9's CUDA-core int8 branch (grouped_matmul_int8_simt) at the
    ragged MoE step's fc1 with fp32 activations ([4096, 768] over 8
    experts' [768, 3072] int8 slab, kb 128), and at the other geometries
    the GEMM refuses: bf16 x with kb 48, bf16 x with p 40 (fc1's first 40
    columns); against the plain version (the slab dequantized to fp32), and
    the row-9 geometry path: one ``grouped_matmul_quantized`` call with
    fp32 x, exact launches.  → (result, path counts)."""
    from apex_tpu_torch.ops import _kernel_utils as ku
    from apex_tpu_torch.ops import grouped_matmul as tgm

    sys.path.insert(0, str(Path(__file__).resolve().parent / "tests"))
    from torch_gmm_cases import offsets_case

    n, g, off = offsets_case("moe")
    offs = torch.as_tensor(off, device=dev)
    k, p = MOE_H, MOE_F
    w = torch.randn(g, k, p, device=dev, generator=gen) * 0.02
    x = torch.randn(n, k, device=dev, generator=gen)
    live = int(off[-1] - off[0])
    cases = {}
    for name, xx, ww, kb in (
            (f"fp32 x [{n}, {k}] x [8, {k}, {p}] kb {QUANT_KB}", x, w,
             QUANT_KB),
            (f"bf16 x, kb 48", x.bfloat16(), w, 48),
            (f"bf16 x, p 40", x.bfloat16(), w[..., :40].contiguous(),
             QUANT_KB)):
        q = tgm.quantize_group_weights(ww, kb)
        check(not tgm.int8_gemm_takes(xx.dtype, k, ww.shape[-1], g, kb),
              f"row 9 int8 {name}: the GEMM takes it")
        before = tgm.GROUPED_MATMUL_INT8_SIMT.launches
        got = tgm.grouped_matmul_quantized(xx, q["wire"], q["scale"], offs)
        torch.cuda.synchronize()
        check(tgm.GROUPED_MATMUL_INT8_SIMT.launches == before + 1,
              f"row 9 int8 {name}: not one launch of the CUDA-core branch")
        want = tgm.grouped_matmul_quantized(xx, q["wire"], q["scale"], offs,
                                            backend="reference")
        tol = 1e-5 if xx.dtype == torch.float32 else 1e-2
        err = rel_err(got, want)
        check(err <= tol, f"row 9 int8 {name}: {err} > {tol}")
        pp = ww.shape[-1]
        nbytes = (live * k * xx.element_size() + g * k * pp
                  + q["scale"].numel() * 4 + n * pp * xx.element_size())
        # fp32 x multiplies on the CUDA cores; 16-bit x times the slab
        # widened to 16 bits is work the tensor cores take (the GEMM's
        # route), so its bound is at their rate
        bms, by = bound(nbytes, 2 * live * k * pp,
                        PEAK_FP32_FLOPS if xx.dtype == torch.float32
                        else PEAK_BF16_FLOPS)
        cases[name] = {
            "err": err, "tol": tol,
            "ms": time_ms(lambda: tgm.grouped_matmul_quantized(
                xx, q["wire"], q["scale"], offs)),
            "plain_ms": time_ms(lambda: tgm.grouped_matmul_quantized(
                xx, q["wire"], q["scale"], offs, backend="reference"),
                iters=2, reps=2),
            "library_ms": None, "bound_ms": bms, "bound_by": by}
    # --- the path --------------------------------------------------------
    q = tgm.quantize_group_weights(w, QUANT_KB)
    torch.cuda.synchronize()
    ku.reset_launch_counts()
    tgm.grouped_matmul_quantized(x, q["wire"], q["scale"], offs)
    torch.cuda.synchronize()
    counts = ku.launch_counts()
    want = {name: 0 for name in ku.KERNELS}
    want["grouped_matmul_int8_simt"] = 1
    check(counts == want, f"row 9 int8 geometry launches {counts}")
    main_name = next(iter(cases))
    main = cases.pop(main_name)
    return dict(main, rel_err=main["err"], detail={
        k_: v_["err"] for k_, v_ in cases.items()},
        variants=cases, shape=main_name + " (the MoE offsets); "
        "bounds at 67 TFLOP/s for fp32 x, 989 for bf16 x"), counts


def dropout_train_phase(dev, kind, backend=None):
    """The GPT-2 125M O2 FusedAdam step at b16 x s1024 (``kind="gpt"``),
    the BERT-large O2 FusedLAMB step at b8 x s512 under one attention
    backend (``kind="bert"``) or the GPT-MoE step at bench_gpt_moe's
    configuration under ragged routing (``kind="moe"``, b8 x s512) with
    hidden and attention dropout 0.1:
    exact launch counts (the dropout-free steps' kernels; the masks of the
    hidden sites and of fused_softmax's probabilities are torch ops), step
    ms over DROPOUT_STEPS steps, tokens/s and MFU, one profiled step
    (device busy, idle share, device ms by category and launching op),
    and the device ms of one hidden site's forward (mask and scale over
    [b, s, h] bf16, CUDA-graph replays) and, under fused_softmax, of the
    probabilities' site ([b, n, s, s] fp32)."""
    from apex_tpu_torch.models import transformer_lm as ttlm
    from apex_tpu_torch.models.transformer_lm import dropout_keys
    from apex_tpu_torch.ops import _kernel_utils as ku
    from apex_tpu_torch.optimizers._common import tree_leaves

    cfg, init, step, batch, seq, bsz = _dropout_step(dev, kind, backend)
    state = init(torch.Generator().manual_seed(0))
    n_params = sum(p.numel() for p in tree_leaves(state.master_params))
    if kind == "moe":
        n_params = moe_active_params(cfg, n_params)
    words = dropout_keys(cfg, torch.Generator().manual_seed(9), dev)
    traj = []

    def one():
        nonlocal state
        state, m = step(state, *batch, words)
        traj.append(m)

    for _ in range(TRAIN_WARMUP):
        one()
    torch.cuda.synchronize()
    ku.reset_launch_counts()
    one()
    torch.cuda.synchronize()
    counts = ku.launch_counts()
    L = cfg.num_layers
    want = {name: 0 for name in ku.KERNELS}
    norms = 2 * L + (3 if kind == "bert" else 1)
    want.update({"layer_norm_fwd": norms, "layer_norm_bwd": norms,
                 **(LAMB_TAIL if kind == "bert" else ADAM_TAIL)})
    if kind == "gpt":
        want.update({"flash_attention_fwd": L, "flash_attention_bwd_dq": L,
                     "flash_attention_bwd_dkv": L})
    elif kind == "moe":
        want.update({"flash_attention_fwd": L, "flash_attention_bwd_short": L,
                     "grouped_matmul_mma": 2 * L,
                     "grouped_matmul_mma_t": 2 * L})
    elif backend == "flash":
        want.update({"flash_attention_fwd": L,
                     "flash_attention_bwd_short": L})
    else:
        want["scaled_softmax_fwd"] = L
    what = kind if kind != "bert" else f"bert {backend}"
    check(counts == want, f"{what} dropout launches {counts} != {want}")
    step_ms = [wall_ms(one) for _ in range(DROPOUT_STEPS)]
    q1, med, q3 = quartiles(step_ms)
    t_prof, busy, top, by_cat, by_op = profile_busy(one)
    losses = [float(m["loss"]) for m in traj]
    check(all(math.isfinite(x) for x in losses), f"losses {losses}")
    tokens_per_s = bsz * seq / (med / 1e3)
    flops_per_tok = 6 * n_params + 12 * L * cfg.hidden_size * seq
    del state
    site = {}
    x = torch.randn(bsz, seq, cfg.hidden_size, device=dev).bfloat16()
    site["hidden site [b, s, h] bf16"] = time_ms(
        lambda: ttlm._dropout(x, cfg.hidden_dropout, words[0, 1]))
    if backend == "fused_softmax":
        pr = torch.rand(bsz, cfg.num_attention_heads, seq, seq, device=dev)
        site["probabilities [b, n, s, s] fp32"] = time_ms(
            lambda: ttlm._dropout(pr, cfg.attention_dropout, words[0, 0]))
        del pr
    del x
    return {"step_ms": med, "step_ms_q1_q3": [q1, q3],
            "step_ms_all": step_ms,
            "steps_timed": DROPOUT_STEPS, "tokens_per_s": tokens_per_s,
            "mfu": tokens_per_s * flops_per_tok / PEAK_BF16_FLOPS,
            "profiled_step_ms": t_prof,
            "device_busy_ms": busy if busy > 0 else "not measured",
            "device_idle_share": (1 - busy / t_prof) if busy > 0
            else "not measured",
            "device_top_ms": top, "device_ms_by_category": by_cat,
            "device_ms_by_op": by_op, "site_forward_ms": site,
            "losses": losses, "counts": counts}


def _dropout_profile_text(r):
    """One dropout step's spread, profile and mask-site times, as text."""
    return (f"every step's ms {[round(t, 2) for t in r['step_ms_all']]}; "
            f"profiled step {r['profiled_step_ms']:.1f} ms, device busy "
            f"{r['device_busy_ms']} ms, idle share "
            f"{r['device_idle_share']}; device ms by category "
            f"{r['device_ms_by_category']}; top device time "
            f"{r['device_top_ms']}; by launching op {r['device_ms_by_op']}; "
            f"one mask site's forward, device ms {r['site_forward_ms']}")


def _dropout_step(dev, kind, backend, batch_size=None, grad_postprocess=None,
                  plain=False):
    """(cfg, init, step, batch, seq, batch size) of a dropout train step."""
    if kind == "gpt":
        from apex_tpu_torch.models.gpt import make_gpt_train_step
        from apex_tpu_torch.optimizers import fused_adam

        cfg = dataclasses.replace(_train_cfg(), hidden_dropout=DROPOUT_P,
                                  attention_dropout=DROPOUT_P)
        bsz = batch_size or TRAIN_BATCH
        init, step = make_gpt_train_step(
            cfg, fused_adam(lr=1e-4), "O2", device=dev,
            backend="reference" if plain else None,
            grad_postprocess=grad_postprocess)
        return cfg, init, step, _batch(cfg, bsz, 0, dev), TRAIN_SEQ, bsz
    if kind == "moe":
        from apex_tpu_torch.models.gpt import make_gpt_train_step
        from apex_tpu_torch.optimizers import fused_adam

        cfg = dataclasses.replace(moe_cfg("ragged"), hidden_dropout=DROPOUT_P,
                                  attention_dropout=DROPOUT_P)
        bsz = batch_size or MOE_BATCH
        init, step = make_gpt_train_step(
            cfg, fused_adam(lr=1e-4), "O2", device=dev,
            backend="reference" if plain else None,
            grad_postprocess=grad_postprocess)
        return cfg, init, step, moe_batch(cfg, bsz, 0, dev), MOE_SEQ, bsz
    from apex_tpu_torch.models.bert import make_bert_train_step
    from apex_tpu_torch.optimizers import fused_lamb

    cfg = dataclasses.replace(bert_cfg(backend), hidden_dropout=DROPOUT_P,
                              attention_dropout=DROPOUT_P)
    bsz = batch_size or BERT_BATCH
    init, step = make_bert_train_step(
        cfg, fused_lamb(lr=1e-4, weight_decay=0.01), "O2", device=dev,
        backend="reference" if plain else None,
        grad_postprocess=grad_postprocess)
    return cfg, init, step, bert_batch(cfg, bsz, 0, dev), BERT_SEQ, bsz


def dropout_train_check(dev, kind, backend=None):
    """3 dropout steps at b4 from one state on the kernel path and on the
    plain path (backend="reference"), each step's key words the same on
    both: per-step loss within TRAIN_LOSS_TOL, identical scaler decisions,
    global grad norm within GRAD_NORM_RTOL (the dropout masks are the same
    bits on both paths).  The MoE step runs in lockstep, as
    moe_train_check: each step starts both paths from the kernel path's
    state, so a routing flip does not carry into the next step."""
    from apex_tpu_torch.models.transformer_lm import dropout_keys
    from apex_tpu_torch.optimizers import global_norm

    paths, norms = {}, {"kernel": [], "plain": []}
    for plain in (False, True):
        name = "plain" if plain else "kernel"

        def post(grads, out=norms[name]):
            out.append(global_norm(grads))
            return grads

        cfg, init, step, batch, _, _ = _dropout_step(
            dev, kind, backend, CHECK_BATCH, post, plain)
        paths[name] = (init, step)
    state0 = paths["kernel"][0](torch.Generator().manual_seed(0))
    seq = {"kernel": [], "plain": []}
    states = {"kernel": state0, "plain": state0}
    for i in range(CHECK_STEPS):
        words = dropout_keys(cfg, torch.Generator().manual_seed(20 + i), dev)
        start = {name: states["kernel" if kind == "moe" else name]
                 for name in states}
        for name in ("kernel", "plain"):
            states[name], m = paths[name][1](start[name], *batch, words)
            seq[name].append((float(m["loss"]), bool(m["overflow"]),
                              float(m["loss_scale"])))
    del states, state0
    what = kind if kind != "bert" else f"bert {backend}"
    ks, ps = seq["kernel"], seq["plain"]
    kn = [float(x) for x in norms["kernel"]]
    pn = [float(x) for x in norms["plain"]]
    loss_err = max(abs(a[0] - b[0]) for a, b in zip(ks, ps))
    check(loss_err <= TRAIN_LOSS_TOL,
          f"{what} dropout kernel vs plain losses {ks} {ps}: {loss_err}")
    check([a[1:] for a in ks] == [b[1:] for b in ps],
          f"{what} dropout scaler decisions differ: {ks} {ps}")
    check(not all(x[1] for x in ks), f"{what} dropout: every step overflowed")
    norm_err = max(abs(a - b) / b for a, b, s in zip(kn, pn, ks) if not s[1])
    check(norm_err <= GRAD_NORM_RTOL,
          f"{what} dropout grad norms {kn} {pn}: {norm_err}")
    return {"kernel": ks, "plain": ps, "grad_norm_kernel": kn,
            "grad_norm_plain": pn, "loss_err": loss_err,
            "grad_norm_rel_err": norm_err}


# ---- M1-M4: the multi-tensor kernels (csrc/multi_tensor.cu) at the
# master trees of the three train steps (GPT-2 125M, BERT-large, GPT-MoE
# ragged), from each step's init; errors relative to each tensor's
# largest plain value (an element that is a near-cancelling sum moves far
# relative to itself when one operand moves by an ulp)
MT_TOL = 1e-6
MT_LOSS_SCALE = 2.0 ** 16


def _mt_tree(dev, kind):
    """(float master leaves, model dtypes, leaf count, seeded fp32
    gradients, m and v of their shapes) of one train step's init state."""
    from apex_tpu_torch.models.bert import make_bert_train_step
    from apex_tpu_torch.models.gpt import make_gpt_train_step
    from apex_tpu_torch.optimizers import fused_adam, fused_lamb
    from apex_tpu_torch.optimizers._common import float_leaves

    if kind == "bert":
        # BERT-large's whole master tree (24 layers), as the kernels'
        # table in PERF.md records it
        init, _ = make_bert_train_step(
            bert_cfg("flash", num_layers=24),
            fused_lamb(lr=1e-4, weight_decay=0.01), "O2", device=dev)
    else:
        cfg = _train_cfg() if kind == "gpt" else moe_cfg("ragged")
        init, _ = make_gpt_train_step(cfg, fused_adam(lr=1e-4), "O2",
                                      device=dev)
    state = init(torch.Generator().manual_seed(0))
    masters = float_leaves(state.master_params)
    dtypes = [x.dtype for x in float_leaves(state.params)]
    del state
    gen = torch.Generator(device=dev).manual_seed(31)
    grads = [torch.randn(p.shape, device=dev, generator=gen) * 1e-3
             for p in masters]
    m = [torch.randn(p.shape, device=dev, generator=gen) * 1e-4
         for p in masters]
    v = [torch.rand(p.shape, device=dev, generator=gen) * 1e-7
         for p in masters]
    return masters, dtypes, grads, m, v


def _mt_rel(got, want) -> float:
    """Largest |got - want| over each tensor's largest |want|."""
    worst = 0.0
    for a, b in zip(got, want):
        if a is None or b.numel() == 0:
            continue
        d = float((a.float() - b.float()).abs().max())
        worst = max(worst, d / max(float(b.float().abs().max()), 1e-30))
    return worst


def _mt_abs(got, want) -> float:
    return max((max_err(a, b) for a, b in zip(got, want)
                if a is not None and b.numel()), default=0.0)


def _mt_row(kernel, run, library, nbytes, what, leaves):
    """One kernel at one tree: ``run(backend)`` returns the outputs as one
    list; held against the plain version (MT_TOL relative), bitwise over
    a repeat, one launch a call; ms of kernel, plain version and library
    call (``None``: none) beside the byte bound."""
    before = kernel.launches
    got = run(None)
    torch.cuda.synchronize()
    launches = kernel.launches - before
    check(launches == 1, f"{kernel.name} at {what}: {launches} launches")
    want = run("reference")
    rel, err = _mt_rel(got, want), _mt_abs(got, want)
    check(rel <= MT_TOL, f"{kernel.name} at {what}: error {rel} > {MT_TOL}")
    again = run(None)
    check(all(torch.equal(a, b) for a, b in zip(got, again)
              if a is not None), f"{kernel.name} at {what}: repeats differ")
    del got, want, again
    bound_ms, bound_by = bound(nbytes, 0, PEAK_FP32_FLOPS)
    return {"shape": f"{what} master tree, {leaves} float leaves",
            "rel_err": rel, "err": err, "tol": MT_TOL, "leaves": leaves,
            "launches_per_call": launches,
            "ms": time_ms(lambda: run(None)),
            "plain_ms": time_ms(lambda: run("reference")),
            "library_ms": None if library is None else time_ms(library),
            "bound_ms": bound_ms, "bound_by": bound_by,
            "detail": "bitwise over a repeat, one launch a call"}


MT_WHERE = {"gpt": "gpt_125m", "bert": "bert_large", "moe": "gpt_moe ragged"}
# each kernel's main path tree (the others are variants): M1 and M3 run
# in every GPT and MoE step, M2 and M4 in every BERT step (M1 too)
MT_MAIN = {"multi_tensor_scale": "gpt", "multi_tensor_l2norm": "bert",
           "multi_tensor_adam": "gpt", "multi_tensor_lamb": "bert"}
MT_RUNS = {"gpt": ("multi_tensor_scale", "multi_tensor_l2norm",
                   "multi_tensor_adam"),
           "bert": ("multi_tensor_scale", "multi_tensor_l2norm",
                    "multi_tensor_lamb"),
           "moe": ("multi_tensor_scale", "multi_tensor_adam")}


def _mt_cases(dev, kind):
    """{kernel: row} of the kernels MT_RUNS names at one tree, and the
    overflow check there (an inf in one gradient: the scale halves, every
    master and moment comes back bit for bit)."""
    from apex_tpu_torch.amp import scaler as sl
    from apex_tpu_torch.multi_tensor import multi_tensor_apply as mta

    masters, dtypes, grads, m, v = _mt_tree(dev, kind)
    n = sum(p.numel() for p in masters)
    leaves = len(masters)
    what = MT_WHERE[kind]
    rows = {}
    step = torch.tensor(3.0, device=dev)
    bc1 = 1.0 - torch.pow(torch.full_like(step, 0.9), step)
    bc2 = 1.0 - torch.pow(torch.full_like(step, 0.999), step)
    no_ov = torch.zeros((), dtype=torch.bool, device=dev)
    model_bytes = sum(p.numel() * torch.empty((), dtype=dt).element_size()
                      for p, dt in zip(masters, dtypes))
    if "multi_tensor_scale" in MT_RUNS[kind]:
        scaled = [g * MT_LOSS_SCALE for g in grads]
        inv = torch.tensor(1.0 / MT_LOSS_SCALE, device=dev)
        f32 = [torch.float32] * leaves
        lib_in = [g.clone() for g in scaled]
        found = torch.zeros(1, device=dev)

        def unscale(backend):
            outs, flag = mta.multi_tensor_scale(scaled, inv, out_dtypes=f32,
                                                backend=backend)
            return outs + [flag]

        rows["multi_tensor_scale"] = _mt_row(
            mta.MT_SCALE, unscale,
            lambda: torch._amp_foreach_non_finite_check_and_unscale_(
                lib_in, found, inv), 8 * n, what, leaves)
        del scaled, lib_in
    if "multi_tensor_l2norm" in MT_RUNS[kind]:
        def norms(backend):
            return list(mta.multi_tensor_l2norm(grads, per_tensor=True,
                                                backend=backend))

        rows["multi_tensor_l2norm"] = _mt_row(
            mta.MT_L2NORM, norms, lambda: torch._foreach_norm(grads),
            4 * n, what, leaves)
    adam_kw = dict(lr=1e-4, betas=(0.9, 0.999), eps=1e-8, weight_decay=0.0,
                   adam_w_mode=True, bc1=bc1, bc2=bc2, apply=True)
    if "multi_tensor_adam" in MT_RUNS[kind]:
        lib_p = [p.clone() for p in masters]
        lib_m = [x.clone() for x in m]
        lib_v = [x.clone() for x in v]
        steps = [torch.tensor(3.0, device=dev) for _ in masters]

        def adam(backend):
            out = mta.multi_tensor_adam(grads, masters, m, v, overflow=no_ov,
                                        model_dtypes=dtypes, backend=backend,
                                        **adam_kw)
            return (out.params + out.exp_avg + out.exp_avg_sq
                    + [x for x in out.model])

        # g, p, m, v read; p, m, v and the model copy written
        rows["multi_tensor_adam"] = _mt_row(
            mta.MT_ADAM, adam,
            lambda: torch._fused_adamw_(
                lib_p, grads, lib_m, lib_v, [], steps, lr=1e-4, beta1=0.9,
                beta2=0.999, weight_decay=0.0, eps=1e-8, amsgrad=False,
                maximize=False), 28 * n + model_bytes, what, leaves)
        del lib_p, lib_m, lib_v
    lamb_kw = dict(lr=1e-4, betas=(0.9, 0.999), beta3=0.1, eps=1e-6,
                   weight_decay=0.01, adam_w_mode=True, use_ratio=True,
                   bc1=bc1, bc2=bc2, apply=True)
    if "multi_tensor_lamb" in MT_RUNS[kind]:
        clip = torch.clamp(mta.multi_tensor_l2norm(grads)[0], min=1.0)

        def lamb(backend):
            out = mta.multi_tensor_lamb(grads, masters, m, v, clip=clip,
                                        overflow=no_ov, model_dtypes=dtypes,
                                        backend=backend, **lamb_kw)
            return (out.params + out.exp_avg + out.exp_avg_sq
                    + [x for x in out.model])

        # the function's inputs read once, its outputs written once (as
        # M3's); the two stages also write and read u and read p again,
        # 12 B a value more, because the trust ratio needs each tensor's
        # norms before the update is applied
        rows["multi_tensor_lamb"] = _mt_row(
            mta.MT_LAMB, lamb, None, 28 * n + model_bytes, what, leaves)
    # an overflowed step: an inf planted in one gradient
    bad = [g * MT_LOSS_SCALE for g in grads]
    bad[leaves // 2].view(-1)[7] = float("inf")
    cfg, ls = sl.init_loss_scale("dynamic", device=dev)
    unscaled, finite = sl.unscale_grads(bad, ls)
    new_ls, overflow = sl.update_loss_scale(cfg, ls, ~finite)
    if kind == "bert":
        out = mta.multi_tensor_lamb(unscaled, masters, m, v,
                                    overflow=overflow, model_dtypes=dtypes,
                                    **lamb_kw)
    else:
        out = mta.multi_tensor_adam(unscaled, masters, m, v,
                                    overflow=overflow, model_dtypes=dtypes,
                                    **adam_kw)
    torch.cuda.synchronize()
    kept = (all(torch.equal(a, b) for a, b in zip(out.params, masters))
            and all(torch.equal(a, b) for a, b in zip(out.exp_avg, m))
            and all(torch.equal(a, b) for a, b in zip(out.exp_avg_sq, v))
            and all(torch.equal(a, p.to(a.dtype))
                    for a, p in zip(out.model, masters)))
    check(bool(overflow) and kept and float(new_ls.loss_scale)
          == float(ls.loss_scale) / 2,
          f"{what}: overflow {bool(overflow)}, kept {kept}, scale "
          f"{float(ls.loss_scale)} -> {float(new_ls.loss_scale)}")
    overflow_row = {"flag": bool(overflow), "every_output_kept": kept,
                    "scale": [float(ls.loss_scale),
                              float(new_ls.loss_scale)]}
    del masters, grads, m, v, bad, unscaled, out
    return rows, overflow_row


MT_MANY = 700   # tensors of the many-leaf check: three tables of 320


def _mt_many_leaves(dev):
    """M1-M4 over a list of MT_MANY tensors (odd, empty and multi-chunk;
    fp32 and bf16 gradients), longer than one kernel table: each call is
    ceil(MT_MANY / MAX_TENSORS) launches, the outputs within MT_TOL of the
    plain version (M1 bit for bit) and the norms bitwise over a repeat.
    {kernel: {"launches_per_call", "rel_err"}}."""
    from apex_tpu_torch.multi_tensor import multi_tensor_apply as mta

    want_launches = -(-MT_MANY // mta.MAX_TENSORS)
    gen = torch.Generator(device=dev).manual_seed(41)
    sizes = [(0, 1, 3, 4099, 65541)[i % 5] + i for i in range(MT_MANY)]
    ps = [torch.randn(n, device=dev, generator=gen) * 0.1 for n in sizes]
    gs = [(torch.randn(n, device=dev, generator=gen) * 0.01).to(
        (torch.float32, torch.bfloat16)[i % 2]) for i, n in enumerate(sizes)]
    ms = [torch.randn(n, device=dev, generator=gen) * 1e-3 for n in sizes]
    vs = [torch.rand(n, device=dev, generator=gen) * 1e-5 for n in sizes]
    step = torch.tensor(2.0, device=dev)
    kw = dict(betas=(0.9, 0.999), eps=1e-6, weight_decay=0.01,
              adam_w_mode=True, lr=1e-3, apply=True,
              bc1=1.0 - torch.pow(torch.full_like(step, 0.9), step),
              bc2=1.0 - torch.pow(torch.full_like(step, 0.999), step),
              overflow=torch.zeros((), dtype=torch.bool, device=dev),
              model_dtypes=[torch.bfloat16] * MT_MANY)
    f32 = [torch.float32] * MT_MANY
    runs = {
        "multi_tensor_scale": (mta.MT_SCALE, lambda b: mta.multi_tensor_scale(
            gs, 0.25, out_dtypes=f32, backend=b)[0]),
        "multi_tensor_l2norm": (mta.MT_L2NORM, lambda b: list(
            mta.multi_tensor_l2norm(gs, per_tensor=True, backend=b))),
        "multi_tensor_adam": (mta.MT_ADAM, lambda b: [
            x for lst in mta.multi_tensor_adam(gs, ps, ms, vs, backend=b,
                                               **kw)[:4] for x in lst]),
        "multi_tensor_lamb": (mta.MT_LAMB, lambda b: [
            x for lst in mta.multi_tensor_lamb(gs, ps, ms, vs, beta3=0.1,
                                               use_ratio=True, backend=b,
                                               **kw)[:4] for x in lst]),
    }
    out = {}
    for name, (kernel, run) in runs.items():
        before = kernel.launches
        got = run(None)
        torch.cuda.synchronize()
        launches = kernel.launches - before
        want = run("reference")
        rel = _mt_rel(got, want)
        exact = all(torch.equal(a, b) for a, b in zip(got, want))
        check(launches == want_launches,
              f"{name} over {MT_MANY} tensors: {launches} launches, not "
              f"{want_launches}")
        check(exact if name == "multi_tensor_scale" else rel <= MT_TOL,
              f"{name} over {MT_MANY} tensors: error {rel} (exact {exact})")
        if name == "multi_tensor_l2norm":
            check(all(torch.equal(a, b) for a, b in zip(got, run(None))),
                  f"{name} over {MT_MANY} tensors: repeats differ")
        out[name] = {"launches_per_call": launches, "rel_err": rel}
        del got, want
    return out


def multi_tensor_phase(dev):
    """M1-M4 at the GPT-2 125M, BERT-large and GPT-MoE master trees:
    ({kernel: row with its other trees as variants}, {tree: overflow
    check, and "many_leaves": the check of a list of MT_MANY
    tensors})."""
    results, overflow = {}, {}
    for kind in ("gpt", "bert", "moe"):
        torch.cuda.empty_cache()
        with torch.inference_mode():
            rows, overflow[MT_WHERE[kind]] = _mt_cases(dev, kind)
        for name, row in rows.items():
            if MT_MAIN[name] == kind:
                results[name] = {**row, "variants": results.get(
                    name, {}).get("variants", {})}
            else:
                results.setdefault(name, {"variants": {}})[
                    "variants"][row["shape"]] = row
    with torch.inference_mode():
        overflow["many_leaves"] = _mt_many_leaves(dev)
    torch.cuda.empty_cache()
    return results, overflow



# ---------------------------------------------------------------------------
# single-device training, complete: remat, memory_efficient
# norms, O1/O4, swiglu, the train-state checkpoint
# ---------------------------------------------------------------------------

# the repo's 350M row (bench.py:129-134) and long-context row (:200-233)
GPT350_GEOM = dict(num_layers=24, hidden_size=1024, num_attention_heads=16)
GPT350_BATCH = 8
LONGCTX_BATCH, LONGCTX_SEQ = 2, 8192
# depths of the full-width steps the time limit allows (of 12 layers)
CAST_LAYERS, SWIGLU_LAYERS, SWIGLU_MOE_LAYERS = 4, 4, 2
CKPT_DIR = Path(__file__).resolve().parent / "build" / "checkpoint_smoke"


def _gpt350(remat, seq=TRAIN_SEQ):
    from apex_tpu_torch.models.config import gpt_125m

    return gpt_125m(max_position_embeddings=seq, remat=remat,
                    fused_head_ce=True, **GPT350_GEOM)


def _seq_batch(cfg, b, s, seed, dev):
    gen = torch.Generator().manual_seed(seed)
    tokens = torch.randint(0, cfg.vocab_size, (b, s), generator=gen)
    labels = torch.randint(0, cfg.vocab_size, (b, s), generator=gen)
    return tokens.to(dev), labels.to(dev)


def _bits_equal(a, b) -> bool:
    """Two trees of tensors with the same leaves, bit for bit."""
    from apex_tpu_torch.optimizers._common import tree_leaves

    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and x.shape == y.shape
        and torch.equal(x.reshape(-1).view(torch.uint8),
                        y.reshape(-1).view(torch.uint8))
        for x, y in zip(la, lb))


def _want(counts_of):
    from apex_tpu_torch.ops import _kernel_utils as ku

    want = {name: 0 for name in ku.KERNELS}
    want.update(counts_of)
    return want


def _dense_want(L, remat, short=False):
    """One dense GPT step's launches: K1 (with remat also each layer's two
    forward norms again in the recompute), K5, the attention forward (again
    in the recompute) and backward, the optimizer tail."""
    bwd = ({"flash_attention_bwd_short": L} if short else
           {"flash_attention_bwd_dq": L, "flash_attention_bwd_dkv": L})
    return _want({"layer_norm_fwd": 2 * L + 1 + (2 * L if remat else 0),
                  "layer_norm_bwd": 2 * L + 1,
                  "flash_attention_fwd": L * (2 if remat else 1),
                  **bwd, **ADAM_TAIL})


def _lockstep(cfg, level, batch, state0, dev, what):
    """CHECK_STEPS steps from ``state0`` on the kernel path and on the
    plain path (backend="reference"): losses within TRAIN_LOSS_TOL, grad
    norms within GRAD_NORM_RTOL, identical scaler decisions."""
    from apex_tpu_torch.models.gpt import make_gpt_train_step
    from apex_tpu_torch.optimizers import fused_adam, global_norm

    runs = {}
    for backend in (None, "reference"):
        norms = []

        def post(grads, norms=norms):
            norms.append(global_norm(grads))
            return grads

        _, step = make_gpt_train_step(cfg, fused_adam(lr=1e-4), level,
                                      device=dev, backend=backend,
                                      grad_postprocess=post)
        state, seq = state0, []
        for _ in range(CHECK_STEPS):
            state, m = step(state, *batch)
            seq.append((float(m["loss"]), bool(m["overflow"]),
                        float(m["loss_scale"])))
        runs[backend] = (seq, [float(n) for n in norms])
        del state
    (ks, kn), (ps, pn) = runs[None], runs["reference"]
    loss_err = max(abs(a[0] - b[0]) for a, b in zip(ks, ps))
    check(all(math.isfinite(a[0]) for a in ks), f"{what}: losses {ks}")
    check(loss_err <= TRAIN_LOSS_TOL,
          f"{what}: kernel vs plain losses {ks} {ps}: {loss_err}")
    check([a[1:] for a in ks] == [b[1:] for b in ps],
          f"{what}: scaler decisions kernel {ks} plain {ps}")
    live = [i for i, s in enumerate(ks) if not s[1]]
    norm_err = max((abs(kn[i] - pn[i]) / pn[i] for i in live), default=0.0)
    check(norm_err <= GRAD_NORM_RTOL,
          f"{what}: grad norms kernel {kn} plain {pn}: {norm_err}")
    return {"kernel": ks, "plain": ps, "grad_norm_kernel": kn,
            "grad_norm_plain": pn, "loss_err": loss_err,
            "grad_norm_rel_err": norm_err}


def _remat_pair(make_step, cfgs, state0, batches, what):
    """The step without and with remat from one state, one step a batch
    of ``batches``: the first step's launches (counts reset just before,
    read just after); the losses and, after the last step, every master,
    model parameter, moment, scale state and step count bitwise equal
    between the two (the recompute repeats the forward's bits).  Each
    run must apply some update and move the masters off ``state0``: an
    all-overflow run keeps ``state0`` and would compare equal without
    testing the recompute's gradients.
    -> {remat: (state, [(loss, overflow, scale)], counts, step)}"""
    from apex_tpu_torch.ops import _kernel_utils as ku

    runs, losses = {}, {}
    for remat in (False, True):
        step = make_step(cfgs[remat])
        state, seq, counts = state0, [], None
        losses[remat] = []
        for i, batch in enumerate(batches):
            torch.cuda.synchronize()
            if i == 0:
                # --- the main path: counts reset before, read after ----
                ku.reset_launch_counts()
            state, m = step(state, *batch)
            torch.cuda.synchronize()
            if i == 0:
                counts = ku.launch_counts()
            losses[remat].append(m["loss"])
            seq.append((float(m["loss"]), bool(m["overflow"]),
                        float(m["loss_scale"])))
        check(all(math.isfinite(s[0]) for s in seq),
              f"{what} remat={remat} losses {seq}")
        check(not all(s[1] for s in seq),
              f"{what} remat={remat}: every step overflowed {seq}")
        check(not _bits_equal(state0.master_params, state.master_params),
              f"{what} remat={remat}: the masters did not move")
        runs[remat] = (state, seq, counts, step)
    (st0, s0, _, _), (st1, s1, _, _) = runs[False], runs[True]
    check(_bits_equal(losses[False], losses[True]),
          f"{what} remat losses {s1} != no-remat {s0} bit for bit")
    for field in ("master_params", "params", "opt_state",
                  "loss_scale_state", "step"):
        check(_bits_equal(getattr(st0, field), getattr(st1, field)),
              f"{what} remat {field} differ from no-remat bit for bit")
    return runs


def remat_train_phase(dev):
    """The GPT-2 350M AMP-O2 step (b8 x s1024, fused head) with and
    without remat from one state (:func:`_remat_pair`): 3 steps, bitwise
    equal between the two, exact launches of each (the recompute's K1
    and K2 counted), the median of 10 steps and the peak memory of each,
    and the remat step on the kernel path against the plain path (3
    steps at b4)."""
    from apex_tpu_torch.models.gpt import make_gpt_train_step
    from apex_tpu_torch.optimizers import fused_adam
    from apex_tpu_torch.optimizers._common import tree_leaves

    cfgs = {r: _gpt350(r) for r in (False, True)}
    init = make_gpt_train_step(cfgs[True], fused_adam(lr=1e-4), "O2",
                               device=dev)[0]
    t0 = time.perf_counter()
    state0 = init(torch.Generator().manual_seed(0))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in tree_leaves(state0.master_params))
    batches = [_seq_batch(cfgs[True], GPT350_BATCH, TRAIN_SEQ, 10 + i, dev)
               for i in range(CHECK_STEPS)]
    L = cfgs[True].num_layers
    out = {"params": n_params, "init_s": init_s}
    runs = _remat_pair(
        lambda cfg: make_gpt_train_step(cfg, fused_adam(lr=1e-4), "O2",
                                        device=dev)[1],
        cfgs, state0, batches, "350m")
    for remat, (_, _, counts, _) in runs.items():
        want = _dense_want(L, remat)
        check(counts == want,
              f"350m remat={remat} launches {counts} != {want}")
    (st0, _, c0, step0), (st1, s1, c1, step1) = runs[False], runs[True]
    out.update({"losses": s1, "launches_no_remat": c0,
                "launches_remat": c1})
    out["check"] = _lockstep(
        cfgs[True], "O2", _seq_batch(cfgs[True], CHECK_BATCH, TRAIN_SEQ, 20,
                                     dev), state0, dev, "350m remat")
    # one train state alive (and the step's next) while each is timed
    finals = {False: st0, True: st1}
    del state0, st0, st1, runs
    tok, lab = batches[0]
    for remat, step in ((False, step0), (True, step1)):
        state = finals.pop(remat)
        torch.cuda.empty_cache()

        def one(step=step):
            nonlocal state
            state, _ = step(state, tok, lab)

        one()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ms = [wall_ms(one) for _ in range(TRAIN_STEPS)]
        q1, med, q3 = quartiles(ms)
        key = "remat" if remat else "no_remat"
        out[f"step_ms_{key}"] = med
        out[f"step_ms_q1_q3_{key}"] = [q1, q3]
        out[f"peak_memory_gb_{key}"] = torch.cuda.max_memory_allocated() / 1e9
        t_prof, busy, top, by_cat, _ = profile_busy(one)
        out[f"profiled_{key}"] = {
            "step_ms": t_prof,
            "device_busy_ms": busy if busy > 0 else "not measured",
            "device_idle_share": (1 - busy / t_prof) if busy > 0
            else "not measured", "device_ms_by_category": by_cat,
            "device_top_ms": top}
        del state
    flops_per_tok = 6 * n_params + 12 * L * cfgs[True].hidden_size * TRAIN_SEQ
    for key in ("remat", "no_remat"):
        tps = GPT350_BATCH * TRAIN_SEQ / (out[f"step_ms_{key}"] / 1e3)
        out[f"tokens_per_s_{key}"] = tps
        out[f"mfu_{key}"] = tps * flops_per_tok / PEAK_BF16_FLOPS
    return out


def longctx_phase(dev):
    """The long-context row: GPT-2 125M at b2 x s8192 with remat and the
    fused head, O2: two steps, each timed, their peak memory and exact
    launches."""
    from apex_tpu_torch.models.config import gpt_125m
    from apex_tpu_torch.models.gpt import make_gpt_train_step
    from apex_tpu_torch.ops import _kernel_utils as ku
    from apex_tpu_torch.optimizers import fused_adam

    cfg = gpt_125m(max_position_embeddings=LONGCTX_SEQ, remat=True,
                   fused_head_ce=True)
    init, step = make_gpt_train_step(cfg, fused_adam(lr=1e-4), "O2",
                                     device=dev)
    state = init(torch.Generator().manual_seed(0))
    tok, lab = _seq_batch(cfg, LONGCTX_BATCH, LONGCTX_SEQ, 30, dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ms, losses, counts = [], [], None
    for i in range(2):
        torch.cuda.synchronize()
        if i == 0:
            ku.reset_launch_counts()
        t0 = time.perf_counter()
        state, m = step(state, tok, lab)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        if i == 0:
            counts = ku.launch_counts()
        losses.append(float(m["loss"]))
    want = _dense_want(cfg.num_layers, True)
    check(counts == want, f"long-context launches {counts} != {want}")
    check(all(math.isfinite(x) for x in losses), f"losses {losses}")
    peak = torch.cuda.max_memory_allocated() / 1e9
    del state
    torch.cuda.empty_cache()
    return {"step_ms": ms, "losses": losses, "peak_memory_gb": peak,
            "counts": counts,
            "tokens_per_s": LONGCTX_BATCH * LONGCTX_SEQ / (ms[-1] / 1e3),
            "attention_check": longctx_attention_check(cfg, dev)}


def longctx_attention_check(cfg, dev):
    """One layer's attention at the long-context step's shape ([2, 8192,
    12, 64] bf16, causal, no dropout or segments: the instantiation the
    step runs): K2's o and K6/K7's dq, dk and dv against the plain version
    computed in blocks of PACKED_PLAIN_ROWS query rows.  o is held over
    1 + |plain| within 2e-2 (a causal row's first outputs average few
    values, up to ~4, where one bf16 step is up to 2**-5), the gradients
    within FLASH_BWD_TOL of their largest plain value."""
    from apex_tpu_torch.ops import flash_attention as tfa

    gen = torch.Generator(device=dev).manual_seed(31)
    shape = (LONGCTX_BATCH, LONGCTX_SEQ, cfg.num_attention_heads,
             cfg.hidden_size // cfg.num_attention_heads)
    q, k, v, do = (torch.randn(shape, device=dev, generator=gen).bfloat16()
                   for _ in range(4))
    kw = {"causal": True}
    o, lse = tfa.flash_attention_fwd(q, k, v, **kw)
    ro, _ = _plain_blocks(q, k, v, None, None, None, kw)
    errs = {"o": float(((o.float() - ro.float()).abs()
                        / (1 + ro.float().abs())).max())}
    del ro
    check(errs["o"] <= 2e-2, f"K2 long context: {errs}")
    ops = tfa.flash_bwd_operands(q, k, v, o, lse, do)
    got = (tfa.flash_bwd_dq(ops, causal=True),
           *tfa.flash_bwd_dkv(ops, causal=True))
    want = _plain_blocks(q, k, v, o, lse, do, kw)
    for name, a, e in zip(("dq", "dk", "dv"), got, want):
        errs[name] = rel_err(a, e)
    del got, want, ops
    check(max(errs[n] for n in ("dq", "dk", "dv")) <= FLASH_BWD_TOL,
          f"K6/K7 long context: {errs}")
    torch.cuda.empty_cache()
    return {"shape": f"b{shape[0]} s{shape[1]} n{shape[2]} d{shape[3]} "
                     "bf16 causal", "errs": errs, "o_tol": 2e-2,
            "grad_tol": FLASH_BWD_TOL}


def per_op_cast_phase(dev):
    """O4 and O1 on the GPT-2 125M step at b16 x s1024, full width, at
    CAST_LAYERS of its 12 layers: launches of one kernel step, the
    median of 5 steps, 3 kernel steps against 3 plain ones from one
    state (losses, scaler decisions, grad norms), and under O1 (fp16,
    dynamic scale) a step forced to overflow (the scale set to 2**40)
    that keeps every master, moment and the step bit for bit."""
    from apex_tpu_torch.amp.scaler import LossScaleState
    from apex_tpu_torch.models.config import gpt_125m
    from apex_tpu_torch.models.gpt import make_gpt_train_step
    from apex_tpu_torch.ops import _kernel_utils as ku
    from apex_tpu_torch.optimizers import fused_adam

    cfg = gpt_125m(num_layers=CAST_LAYERS, max_position_embeddings=TRAIN_SEQ,
                   fused_head_ce=True)
    batch = _seq_batch(cfg, TRAIN_BATCH, TRAIN_SEQ, 40, dev)
    out = {}
    for level in ("O4", "O1"):
        init, step = make_gpt_train_step(cfg, fused_adam(lr=1e-4), level,
                                         device=dev)
        state0 = init(torch.Generator().manual_seed(0))
        row = {"check": _lockstep(cfg, level, batch, state0, dev, level)}
        state = state0
        torch.cuda.synchronize()
        ku.reset_launch_counts()
        state, m = step(state, *batch)
        torch.cuda.synchronize()
        row["counts"] = ku.launch_counts()
        want = _dense_want(cfg.num_layers, False)
        check(row["counts"] == want,
              f"{level} launches {row['counts']} != {want}")

        def one(step=step):
            nonlocal state
            state, _ = step(state, *batch)

        row["step_ms"] = quartiles([wall_ms(one) for _ in range(5)])[1]
        if level == "O1":
            big = state._replace(loss_scale_state=LossScaleState(
                torch.tensor(2.0 ** 40, device=dev),
                torch.zeros((), dtype=torch.int32, device=dev)))
            after, m = step(big, *batch)
            check(bool(m["overflow"]), "O1 at scale 2**40 did not overflow")
            for field in ("master_params", "params", "opt_state", "step"):
                check(_bits_equal(getattr(after, field),
                                  getattr(big, field)),
                      f"O1 overflowed step changed {field}")
            row["forced_overflow"] = {
                "overflow": True, "scale_after": float(m["loss_scale"]),
                "masters_kept_bitwise": True}
        out[level] = row
        del state, state0
    return out


def memory_efficient_phase(dev, gen):
    """``memory_efficient=True`` LayerNorm at the GPT step's [16384, 768]
    and the 350M step's [8192, 1024] bf16: dx, dγ, dβ against the default
    mode's (relative to the default's largest value), the rebuild's
    device ms beside K5's, the saved bytes (what the norm keeps alive
    past a consumer that saves y anyway), and one forward and backward's
    launches (K1 1, K5 1)."""
    from apex_tpu_torch.ops import _kernel_utils as ku
    from apex_tpu_torch.ops import layer_norm as tln

    rows_main, out, counts = None, {}, None
    for rows, h in ((TRAIN_BATCH * TRAIN_SEQ, 768),
                    (GPT350_BATCH * TRAIN_SEQ, 1024)):
        w = 1 + 0.1 * torch.randn(h, device=dev, generator=gen)
        b = 0.1 * torch.randn(h, device=dev, generator=gen)
        x = (torch.randn(rows, h, device=dev, generator=gen) * 2).bfloat16()
        dy = torch.randn(rows, h, device=dev, generator=gen).bfloat16()
        grads = {}
        for me in (False, True):
            leaves = [t.detach().clone().requires_grad_()
                      for t in (x, w, b)]
            torch.cuda.synchronize()
            if me and counts is None:
                ku.reset_launch_counts()
            y = tln.fused_layer_norm(*leaves, memory_efficient=me)
            y.backward(dy)
            torch.cuda.synchronize()
            if me and counts is None:
                counts = ku.launch_counts()
            grads[me] = [t.grad for t in leaves]
        errs = {n: rel_err(a, e) for n, a, e in
                zip(("dx", "dgamma", "dbeta"), grads[True], grads[False])}
        check(max(errs.values()) <= LN_BWD_TOL[torch.bfloat16],
              f"memory_efficient [{rows}, {h}] vs default {errs}")
        y, mu, rs = tln.layer_norm_fwd_stats(x, w, b)
        xr = tln.rebuild_input(y, w, b, mu, rs, 1e-5)

        def me_bwd(backend=None):
            xx = tln.rebuild_input(y, w, b, mu, rs, 1e-5)
            return tln.layer_norm_bwd(dy, xx, w, mu, rs, backend=backend)

        # bytes the norm keeps alive past its consumer: y feeds a matmul
        # that saves y; x has no other holder
        wm = torch.randn(h, 64, device=dev, generator=gen).bfloat16()
        wm.requires_grad_()
        ww = w.detach().clone().requires_grad_()
        alive = {}
        for me in (False, True):
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            xx = x.clone()
            z = tln.fused_layer_norm(xx, ww, b, memory_efficient=me) @ wm
            del xx
            torch.cuda.synchronize()
            alive[me] = torch.cuda.memory_allocated() - base
            del z
        wb, bb = w.bfloat16(), b.bfloat16()
        _, lmean, lrstd = torch.ops.aten.native_layer_norm(x, [h], wb, bb,
                                                           1e-5)
        nbytes = 3 * rows * h * 2 + 2 * rows * 4 + 4 * h * 4
        bms, by = bound(nbytes, 17 * rows * h, PEAK_FP32_FLOPS)
        out[f"[{rows}, {h}] bf16"] = {
            "errors_vs_default": errs,
            "rebuild_ms": time_ms(lambda: tln.rebuild_input(
                y, w, b, mu, rs, 1e-5)),
            "k5_ms": time_ms(lambda: tln.layer_norm_bwd(dy, xr, w, mu, rs)),
            "ms": time_ms(me_bwd), "plain_ms": time_ms(
                lambda: me_bwd("reference")),
            "library_ms": time_ms(
                lambda: torch.ops.aten.native_layer_norm_backward(
                    dy, x, [h], lmean, lrstd, wb, bb, [True, True, True])),
            "bound_ms": bms, "bound_by": by,
            "saved_bytes": rows * h * 2,
            "bytes_alive_past_consumer": {"default": alive[False],
                                          "memory_efficient": alive[True]},
            "err": max(max_err(a, e) for a, e in
                       zip(grads[True], grads[False]))}
        if rows_main is None:
            rows_main = out[f"[{rows}, {h}] bf16"]
        del x, dy, grads, y, xr
    want = _want({"layer_norm_fwd": 1, "layer_norm_bwd": 1})
    check(counts == want, f"memory_efficient launches {counts} != {want}")
    return out, counts


def swiglu_phase(dev, gen):
    """swiglu: the GPT-2 125M-width swiglu step (SWIGLU_LAYERS layers) on
    the kernel path against the plain path (3 steps at b4); the ragged
    swiglu MoE step at bench_gpt_moe's widths (SWIGLU_MOE_LAYERS layers,
    b8 x s512): exact launches with row 9 on the 2f-wide fc1, zero
    dropped tokens; and row 9's forward and transposed read at the 2f
    fc1 (N = 4096 over 8 experts with the step's layer-0 loads) against
    their plain versions, timed."""
    from apex_tpu_torch.models.config import gpt_125m
    from apex_tpu_torch.models.gpt import make_gpt_train_step
    from apex_tpu_torch.ops import _kernel_utils as ku
    from apex_tpu_torch.ops import grouped_matmul as tgm
    from apex_tpu_torch.optimizers import fused_adam

    out = {}
    cfg = gpt_125m(num_layers=SWIGLU_LAYERS, activation="swiglu",
                   max_position_embeddings=TRAIN_SEQ, fused_head_ce=True)
    init, step = make_gpt_train_step(cfg, fused_adam(lr=1e-4), "O2",
                                     device=dev)
    state0 = init(torch.Generator().manual_seed(0))
    batch = _seq_batch(cfg, CHECK_BATCH, TRAIN_SEQ, 50, dev)
    torch.cuda.synchronize()
    ku.reset_launch_counts()
    state, _ = step(state0, *batch)
    torch.cuda.synchronize()
    counts = ku.launch_counts()
    want = _dense_want(cfg.num_layers, False)
    check(counts == want, f"swiglu gpt launches {counts} != {want}")
    del state
    out["gpt"] = {"check": _lockstep(cfg, "O2", batch, state0, dev,
                                     "swiglu gpt"), "counts": counts}
    del state0

    mcfg = dataclasses.replace(moe_cfg("ragged"),
                               num_layers=SWIGLU_MOE_LAYERS,
                               activation="swiglu")
    init, step = make_gpt_train_step(mcfg, fused_adam(lr=1e-4), "O2",
                                     device=dev)
    state = init(torch.Generator().manual_seed(0))
    tok, lab = moe_batch(mcfg, MOE_BATCH, 0, dev)
    state, _ = step(state, tok, lab)
    torch.cuda.synchronize()
    ku.reset_launch_counts()
    state, m = step(state, tok, lab)
    torch.cuda.synchronize()
    mcounts = ku.launch_counts()
    L = mcfg.num_layers
    want = _want({"layer_norm_fwd": 2 * L + 1, "layer_norm_bwd": 2 * L + 1,
                  "flash_attention_fwd": L, "flash_attention_bwd_short": L,
                  "grouped_matmul_mma": 2 * L, "grouped_matmul_mma_t": 2 * L,
                  **ADAM_TAIL})
    check(mcounts == want, f"swiglu moe launches {mcounts} != {want}")
    check(math.isfinite(float(m["loss"])), f"swiglu moe loss {m['loss']}")
    one_ms = []
    for _ in range(5):
        def one():
            nonlocal state
            state, _ = step(state, tok, lab)
        one_ms.append(wall_ms(one))
    _, probe = moe_probe(state.params, tok, mcfg)
    stats = probe.stats()
    check(all(d == 0.0 for d in stats["dropped_fraction"]),
          f"swiglu ragged dropped tokens {stats['dropped_fraction']}")
    check(all(sum(ld) == MOE_BATCH * MOE_SEQ * mcfg.moe_top_k
              for ld in stats["expert_load"]), f"loads {stats}")
    out["moe"] = {"counts": mcounts, "loss": float(m["loss"]),
                  "step_ms": quartiles(one_ms)[1], **stats}
    del state

    # row 9 at the 2f fc1: its forward and the transposed read of its dx
    loads = stats["expert_load"][0]
    off = [0]
    for c in loads:
        off.append(off[-1] + c)
    offs = torch.tensor(off, dtype=torch.int32, device=dev)
    n, g, f2 = off[-1], len(loads), 2 * MOE_F
    x = torch.randn(n, MOE_H, device=dev, generator=gen).bfloat16()
    gy = torch.randn(n, f2, device=dev, generator=gen).bfloat16()
    w = (torch.randn(g, MOE_H, f2, device=dev, generator=gen)
         * 0.02).bfloat16()
    variants = {}
    for kname, a, trans in (("grouped_matmul_mma", x, False),
                            ("grouped_matmul_mma_t", gy, True)):
        wf = w.transpose(1, 2) if trans else w
        got = tgm._gmm_route(a, w, offs, False, trans=trans)
        want_t = tgm.grouped_matmul_reference(a, wf, offs)
        err = rel_err(got, want_t)
        check(err <= GMM_TOL[torch.bfloat16],
              f"row 9 {kname} at the swiglu 2f fc1: {err}")
        k, p = a.shape[1], wf.shape[2]
        bms, by = _gmm_bound(off, n, k, p, 2)
        lib, note = _grouped_mm_library(a, w, offs, trans)
        variants[kname] = {
            f"swiglu fc1 {'dx' if trans else 'forward'} N={n} k={k} p={p}": {
                "ms": time_ms(lambda: tgm._gmm_route(a, w, offs, False,
                                                     trans=trans)),
                "plain_ms": time_ms(lambda: tgm.grouped_matmul_reference(
                    a, wf, offs), iters=5),
                "library_ms": None if lib is None else time_ms(lib),
                "library": note, "bound_ms": bms, "bound_by": by,
                "err": max_err(got, want_t), "rel_err": err}}
        del got, want_t
    return out, variants


def checkpoint_resume_phase(dev):
    """The 350M remat state: 2 steps, an ``AsyncCheckpointer`` save whose
    write overlaps step 3, step 4; then a fresh ``init_fn`` state restored
    from the checkpoint takes steps 3 and 4 again: losses, masters,
    moments, model parameters, scaler and step must be bitwise those of
    the unkilled run.  Save (blocking and background) and restore ms,
    bytes, and step 3's ms beside step 4's."""
    import shutil

    from apex_tpu_torch.amp.frontend import restore_train_state
    from apex_tpu_torch.checkpoint import AsyncCheckpointer
    from apex_tpu_torch.models.gpt import make_gpt_train_step
    from apex_tpu_torch.optimizers import fused_adam

    cfg = _gpt350(True)
    init, step = make_gpt_train_step(cfg, fused_adam(lr=1e-4), "O2",
                                     device=dev)
    batches = [_seq_batch(cfg, GPT350_BATCH, TRAIN_SEQ, 60 + i, dev)
               for i in range(4)]
    shutil.rmtree(CKPT_DIR, ignore_errors=True)
    state = init(torch.Generator().manual_seed(0))
    for tok, lab in batches[:2]:
        state, _ = step(state, tok, lab)
    torch.cuda.synchronize()
    ck = AsyncCheckpointer(str(CKPT_DIR), keep=1)
    t0 = time.perf_counter()
    ck.save(2, state)
    t1 = time.perf_counter()
    state, m3 = step(state, *batches[2])
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    res = ck.wait()
    t3 = time.perf_counter()
    state, m4 = step(state, *batches[3])
    torch.cuda.synchronize()
    t4 = time.perf_counter()
    fresh = init(torch.Generator().manual_seed(1))
    torch.cuda.synchronize()
    t5 = time.perf_counter()
    resumed = restore_train_state(str(CKPT_DIR), fresh)
    torch.cuda.synchronize()
    restore_ms = (time.perf_counter() - t5) * 1e3
    del fresh
    resumed, r3 = step(resumed, *batches[2])
    resumed, r4 = step(resumed, *batches[3])
    for a, b in ((r3, m3), (r4, m4)):
        check(torch.equal(a["loss"].view(torch.int32),
                          b["loss"].view(torch.int32)),
              f"resumed loss {float(a['loss'])} != unkilled "
              f"{float(b['loss'])}")
    for field in ("master_params", "params", "opt_state", "loss_scale_state",
                  "step"):
        check(_bits_equal(getattr(resumed, field), getattr(state, field)),
              f"resumed {field} differs from the unkilled run")
    out = {"bytes": res.bytes, "save_blocking_ms": (t1 - t0) * 1e3,
           "save_background_ms": res.save_ms,
           "overlap_ratio": res.overlap_ratio,
           "step3_ms_during_save": (t2 - t1) * 1e3,
           "wait_after_step3_ms": (t3 - t2) * 1e3,
           "step4_ms": (t4 - t3) * 1e3,
           "restore_ms": restore_ms,
           "losses": [float(m3["loss"]), float(m4["loss"])]}
    del state, resumed
    shutil.rmtree(CKPT_DIR, ignore_errors=True)
    return out


def training_slice(dev, gen, results, paths):
    """Every single-device training phase, in order; their kernel rows go
    into ``results`` as variants and their launch counts into ``paths``.
    Returns the line's entries."""
    torch.cuda.empty_cache()
    rem = remat_train_phase(dev)
    paths["gpt 350m remat"] = rem.pop("launches_remat")
    paths["gpt 350m no remat"] = rem.pop("launches_no_remat")
    torch.cuda.empty_cache()
    fam = rem["family"] = remat_family_check(dev)
    for kind, row in fam.items():
        paths[f"{kind} remat"] = row.pop("launches_remat")
        paths[f"{kind} no remat"] = row.pop("launches_no_remat")
    torch.cuda.empty_cache()
    lc = longctx_phase(dev)
    paths["gpt 125m long context remat"] = lc.pop("counts")
    at = lc["attention_check"]
    for kname, names in (("flash_attention_fwd", ("o",)),
                         ("flash_attention_bwd_dq", ("dq",)),
                         ("flash_attention_bwd_dkv", ("dk", "dv"))):
        if kname in results:
            results[kname].setdefault("variants", {})[
                f"long context {at['shape']}"] = {
                    n: at["errs"][n] for n in names}
    torch.cuda.empty_cache()
    casts = per_op_cast_phase(dev)
    for level, row in casts.items():
        paths[f"gpt per-op casts {level}"] = row.pop("counts")
    torch.cuda.empty_cache()
    me, me_counts = memory_efficient_phase(dev, gen)
    paths["memory_efficient layer norm"] = me_counts
    if "layer_norm_bwd" in results:
        results["layer_norm_bwd"].setdefault("variants", {}).update(
            {f"memory_efficient (rebuild + K5) {k}": v
             for k, v in me.items()})
    torch.cuda.empty_cache()
    sw, sw_variants = swiglu_phase(dev, gen)
    paths["swiglu gpt"] = sw["gpt"].pop("counts")
    paths["swiglu moe ragged"] = sw["moe"].pop("counts")
    for kname, rows in sw_variants.items():
        if kname in results:
            results[kname].setdefault("variants", {}).update(rows)
    torch.cuda.empty_cache()
    ckpt = checkpoint_resume_phase(dev)
    torch.cuda.empty_cache()
    return {"remat": rem, "long_context": lc, "per_op_casts": casts,
            "memory_efficient": me, "swiglu": sw,
            "swiglu_row9_2f": sw_variants, "checkpoint": ckpt}


def print_training_slice(t, smi):
    rem, lc = t["remat"], t["long_context"]
    print(f"train gpt 350m (24 layers, h1024, 16 heads; {rem['params']} "
          f"params) AMP-O2 b{GPT350_BATCH} x s{TRAIN_SEQ} on {smi}: step "
          f"median no remat {rem['step_ms_no_remat']:.2f} ms (q1-q3 "
          f"{rem['step_ms_q1_q3_no_remat']}), peak memory "
          f"{rem['peak_memory_gb_no_remat']:.2f} GB; remat "
          f"{rem['step_ms_remat']:.2f} ms (q1-q3 "
          f"{rem['step_ms_q1_q3_remat']}), peak memory "
          f"{rem['peak_memory_gb_remat']:.2f} GB; MFU {rem['mfu_remat']:.4f}"
          f" / {rem['mfu_no_remat']:.4f}; {CHECK_STEPS} steps bitwise equal "
          f"with and without remat, losses {rem['losses']}; kernel vs "
          f"plain (remat, b{CHECK_BATCH}): max loss diff "
          f"{rem['check']['loss_err']:.5f}, grad norm max rel diff "
          f"{rem['check']['grad_norm_rel_err']:.5f}; profiled no remat "
          f"{json.dumps(rem['profiled_no_remat'])}; remat "
          f"{json.dumps(rem['profiled_remat'])}")
    print(f"remat at {REMAT_FAMILY_LAYERS} layers, one AMP-O2 step each, "
          f"bitwise equal to the step without remat, K1 +2L and K2 x2 in "
          f"the recompute: {json.dumps(rem['family'])}")
    print(f"train gpt 125m long context b{LONGCTX_BATCH} x s{LONGCTX_SEQ} "
          f"remat on {smi}: step ms {lc['step_ms']}, peak memory "
          f"{lc['peak_memory_gb']:.2f} GB, losses {lc['losses']}; one "
          f"layer's attention at {lc['attention_check']['shape']} kernel vs "
          f"plain {json.dumps(lc['attention_check']['errs'])} (o tol "
          f"{lc['attention_check']['o_tol']} of 1 + |plain|, gradients "
          f"{lc['attention_check']['grad_tol']} of max |plain|)")
    for level, row in t["per_op_casts"].items():
        c = row["check"]
        print(f"train gpt 125m width {CAST_LAYERS} layers {level} "
              f"b{TRAIN_BATCH} x s{TRAIN_SEQ} on {smi}: step median "
              f"{row['step_ms']:.2f} ms; kernel vs plain {c['kernel']} vs "
              f"{c['plain']}, max loss diff {c['loss_err']:.5f}, grad norm "
              f"max rel diff {c['grad_norm_rel_err']:.5f}"
              + (f"; forced overflow {row['forced_overflow']}"
                 if "forced_overflow" in row else ""))
    for shape, row in t["memory_efficient"].items():
        print(f"memory_efficient layer norm {shape} on {smi}: errors vs "
              f"the default mode {row['errors_vs_default']}; rebuild "
              f"{row['rebuild_ms']:.4f} ms beside K5 {row['k5_ms']:.4f} ms;"
              f" bytes alive past the consumer "
              f"{row['bytes_alive_past_consumer']}")
    sw = t["swiglu"]
    print(f"swiglu gpt 125m width {SWIGLU_LAYERS} layers on {smi}: kernel "
          f"vs plain max loss diff {sw['gpt']['check']['loss_err']:.5f}, "
          f"grad norm max rel diff "
          f"{sw['gpt']['check']['grad_norm_rel_err']:.5f}; swiglu moe "
          f"ragged {SWIGLU_MOE_LAYERS} layers b{MOE_BATCH} x s{MOE_SEQ}: "
          f"step median {sw['moe']['step_ms']:.2f} ms, dropped "
          f"{sw['moe']['dropped_fraction']}; row 9 at the 2f fc1 "
          f"{json.dumps(t['swiglu_row9_2f'])}")
    print(f"checkpoint resume gpt 350m on {smi}: {json.dumps(t['checkpoint'])}")


REMAT_FAMILY_LAYERS = 2


def remat_family_check(dev):
    """BERT-large (flash) and the ragged GPT-MoE at REMAT_FAMILY_LAYERS
    layers and full width, one AMP-O2 step each with and without remat
    from one state (:func:`_remat_pair`: the states after the step
    bitwise equal, the update applied): K1 launched 2L more times (each
    layer's two norms again in the recompute) and K2 twice as often, no
    kernel launched less."""
    from apex_tpu_torch.models.bert import make_bert_train_step
    from apex_tpu_torch.models.gpt import make_gpt_train_step
    from apex_tpu_torch.optimizers import fused_adam, fused_lamb

    L = REMAT_FAMILY_LAYERS
    out = {}
    for kind in ("bert flash", "moe ragged"):
        if kind == "bert flash":
            base = bert_cfg("flash", num_layers=L)
            make = functools.partial(
                make_bert_train_step,
                optimizer=fused_lamb(lr=1e-4, weight_decay=0.01))
            batch = bert_batch(base, BERT_BATCH, 0, dev)
        else:
            base = dataclasses.replace(moe_cfg("ragged"), num_layers=L)
            make = functools.partial(make_gpt_train_step,
                                     optimizer=fused_adam(lr=1e-4))
            batch = moe_batch(base, MOE_BATCH, 0, dev)
        cfgs = {r: dataclasses.replace(base, remat=r) for r in (False, True)}
        state0 = make(cfgs[False], policy_or_amp="O2", device=dev)[0](
            torch.Generator().manual_seed(0))
        runs = _remat_pair(
            lambda cfg: make(cfg, policy_or_amp="O2", device=dev)[1],
            cfgs, state0, [batch], kind)
        (_, _, c0, _), (_, s1, c1, _) = runs[False], runs[True]
        check(c1["layer_norm_fwd"] == c0["layer_norm_fwd"] + 2 * L > 2 * L,
              f"{kind} remat K1 {c1['layer_norm_fwd']} vs no-remat "
              f"{c0['layer_norm_fwd']}: the recompute's norms not launched")
        check(c1["flash_attention_fwd"] == 2 * c0["flash_attention_fwd"] > 0,
              f"{kind} remat K2 {c1['flash_attention_fwd']} vs no-remat "
              f"{c0['flash_attention_fwd']}")
        check(all(c1[k] >= c0[k] for k in c0),
              f"{kind} remat launched a kernel less: {c1} vs {c0}")
        out[kind] = {"loss": s1[0][0], "overflow": s1[0][1],
                     "launches_no_remat": c0, "launches_remat": c1}
        del runs, state0
        torch.cuda.empty_cache()
    return out


# ---- the cluster serving tier: two worker processes behind a router ----

CLUSTER_REQUESTS = 24
CLUSTER_NEW = 32
CLUSTER_SAMPLED = 4
CLUSTER_SLOTS = 8
CLUSTER_MAX_LEN = 1024
CLUSTER_BLOCK = 16
CLUSTER_SEED = 0
# class -> prompt lengths (bench.py's _bursty_trace classes, at 17-512
# tokens)
CLUSTER_CLASSES = (("interactive", 17, 128), ("standard", 128, 320),
                   ("batch", 320, 513))
CLUSTER_MIGRATE = 6             # requests of the in-process drain check
CLUSTER_WIRES = ("int8", "bf16")
CLUSTER_TIMEOUT_S = 240         # a worker's READY, a router's replay
CLUSTER_RPC_S = 120.0
# GPT-2 125M at full width and depth, as the workers build it
CLUSTER_MODEL = dict(layers=12, hidden=768, heads=12, vocab=50304,
                     max_pos=1024, compute_dtype="bfloat16")
CLUSTER_FLAGS = ["--seed", str(CLUSTER_SEED), "--layers", "12",
                 "--hidden", "768", "--heads", "12", "--vocab", "50304",
                 "--max-pos", "1024", "--compute-dtype", "bfloat16",
                 "--max-len", str(CLUSTER_MAX_LEN), "--vocab-limit",
                 str(VOCAB_LIMIT), "--block-size", str(CLUSTER_BLOCK),
                 "--device", "cuda"]
CLUSTER_DECODE_FLAGS = ["--max-slots", str(CLUSTER_SLOTS),
                        "--cache-layout", "paged"]
CLUSTER_ENGINE = dict(max_slots=CLUSTER_SLOTS, max_len=CLUSTER_MAX_LEN,
                      cache_layout="paged", block_size=CLUSTER_BLOCK,
                      vocab_limit=VOCAB_LIMIT)


def cluster_trace(rng, vocab, n_requests=CLUSTER_REQUESTS, calm_gap_s=0.15,
                  burst_every=6, burst_len=3):
    """bench.py's ``_bursty_trace`` arrival process: a calm exponential
    stream broken by near-simultaneous volleys (every ``burst_every``-th
    arrival opens ``burst_len`` back-to-back ones); classes cycle
    interactive / standard / batch, all greedy, +CLUSTER_NEW tokens, the
    prompt lengths drawn from each class's range → sorted ``[(t_s,
    submit kwargs)]``."""
    trace, t, i = [], 0.0, 0
    while len(trace) < n_requests:
        volley = burst_len if i % burst_every == 0 else 1
        for _ in range(volley):
            if len(trace) >= n_requests:
                break
            cls, lo, hi = CLUSTER_CLASSES[len(trace) % len(CLUSTER_CLASSES)]
            plen = int(rng.randint(lo, hi))
            trace.append((round(t, 4), dict(
                prompt=rng.randint(0, vocab, (plen,)).tolist(),
                max_new_tokens=CLUSTER_NEW, temperature=0.0,
                slo_class=cls)))
            t += 0.002
        t += float(rng.exponential(calm_gap_s))
        i += 1
    return trace


def replay_single(engine, trace, max_wall_s=CLUSTER_TIMEOUT_S):
    """Open-loop replay against one engine (arrivals submit at their
    offsets whatever completes) → (responses by request id, wall s)."""
    out = []
    t0 = time.perf_counter()
    i = 0
    while i < len(trace) or not engine.idle:
        now = time.perf_counter() - t0
        check(now < max_wall_s, "single-engine replay ran out of time")
        while i < len(trace) and trace[i][0] <= now:
            engine.submit(**trace[i][1])
            i += 1
        if engine.idle:
            time.sleep(max(0.0, min(trace[i][0] - now, 0.002)))
            continue
        out.extend(engine.step())
    torch.cuda.synchronize()
    return ({r.request_id: r for r in out},
            time.perf_counter() - t0)


def topology_report(resps, wall_s) -> dict:
    """wall s, generated tokens/s, and TTFT and e2e p50/p95 per class."""
    row = {"wall_s": wall_s,
           "generated_tokens_per_s":
               sum(len(r.tokens) for r in resps) / wall_s}
    for cls, _lo, _hi in CLUSTER_CLASSES:
        rs = [r for r in resps if r.slo_class == cls]
        row[cls] = {f"{m}_p{q}": pct([getattr(r, f"{m}_ms") for r in rs],
                                     q / 100)
                    for m in ("ttft", "e2e") for q in (50, 95)}
    return row


def first_divergence(got, want):
    """Index of the first differing token (or of the shorter end), None
    when the sequences are equal."""
    got, want = list(got), list(want)
    for j, (a, b) in enumerate(zip(got, want)):
        if a != b:
            return j
    return None if len(got) == len(want) else min(len(got), len(want))


def check_tokens(resps, ref, trace, what):
    """Every request's tokens equal the single engine's, or fail naming
    the request and position."""
    for rid, r in sorted(resps.items()):
        j = first_divergence(r.tokens.tolist(), ref[rid].tokens.tolist())
        if j is not None:
            print(f"{what}: request {rid} ({trace[rid][1]['slo_class']}, "
                  f"prompt {len(trace[rid][1]['prompt'])} tokens) differs "
                  f"from the single engine at position {j}: "
                  f"{r.tokens.tolist()} vs {ref[rid].tokens.tolist()}")
        check(j is None, f"{what}: request {rid} differs at position {j}")


def scrape(url: str) -> dict:
    """One /metrics scrape through the port's OpenMetrics parser."""
    import urllib.request

    from apex_tpu_torch.observability import openmetrics

    with urllib.request.urlopen(url + "/metrics", timeout=10) as r:
        return openmetrics.parse(r.read().decode())


def healthz(url: str) -> int:
    import urllib.error
    import urllib.request

    try:
        with urllib.request.urlopen(url + "/healthz", timeout=10) as r:
            return r.status
    except urllib.error.HTTPError as e:
        return e.code


def spawn_pair(env, decode_extra=(), prefill_extra=()):
    """Start a prefill and a decode worker process together → the two
    ready ``PendingWorker`` handles (READY ms on each); kills both and
    fails when either is not READY in time."""
    from apex_tpu_torch.serving.cluster.worker import (
        shutdown_worker, spawn_worker_async)

    pend = [spawn_worker_async("prefill", env=env, timeout=CLUSTER_TIMEOUT_S,
                               extra_args=CLUSTER_FLAGS + list(prefill_extra)),
            spawn_worker_async("decode", env=env, timeout=CLUSTER_TIMEOUT_S,
                               extra_args=CLUSTER_FLAGS + CLUSTER_DECODE_FLAGS
                               + list(decode_extra))]
    while any(p.poll() is None for p in pend):
        time.sleep(0.05)
    if not all(p.poll() == "ready" for p in pend):
        for p in pend:
            shutdown_worker(p.proc)
        check(False, f"cluster workers not READY: {[p.error for p in pend]}")
    return pend


class MidflightGate:
    """Once an engine's step has admitted work, later steps hold (no
    completions, no state touched) until :meth:`restore`, so its lanes are
    mid-flight when the drain lands."""

    def __init__(self, engine):
        import threading

        self._open = threading.Event()
        self._engine, self._orig = engine, engine.step

        def gated():
            if not self._open.is_set() and engine._pool.n_active:
                time.sleep(0.002)
                return []
            return self._orig()

        engine.step = gated

    def restore(self):
        self._open.set()
        self._engine.step = self._orig


def wait_until(pred, timeout=60.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(0.002)
    return pred()


def drain_check(params, cfg, trace, ref, dev) -> dict:
    """Two decode WorkerServers in threads on the card behind a router:
    drain one mid-flight; the migrated requests finish on the survivor
    with the single engine's tokens."""
    import threading

    from apex_tpu_torch.serving.cluster import Router, WorkerServer

    kw = dict(CLUSTER_ENGINE, device=dev)
    pf = WorkerServer("prefill", params, cfg, max_len=CLUSTER_MAX_LEN,
                      block_size=CLUSTER_BLOCK, vocab_limit=VOCAB_LIMIT,
                      device=dev)
    dcs = [WorkerServer("decode", params, cfg, **kw) for _ in range(2)]
    servers = [pf] + dcs
    for s in servers:
        threading.Thread(target=s.serve_forever, daemon=True).start()
    gate = MidflightGate(dcs[0].engine)
    router = Router([pf.addr], [d.addr for d in dcs], max_worker_queue=8,
                    rpc_timeout=CLUSTER_RPC_S)
    try:
        for _t, kw_ in trace[:CLUSTER_MIGRATE]:
            router.submit(**kw_)
        out = []
        victim = next(w for w in router._decode if w.addr == dcs[0].addr)
        check(wait_until(lambda: (out.extend(router.step()),
                                  victim.in_flight)[1]),
              "drain check: the victim never got work")
        check(wait_until(lambda: dcs[0].engine._pool.n_active >= 1),
              "drain check: the victim admitted nothing")
        router.scrape_stats()
        drained = router.drain_worker(dcs[0].addr)
        out.extend(router.take_drain_completions())
        router.remove_worker(dcs[0].addr)
        gate.restore()
        out.extend(router.run(max_wall_s=CLUSTER_TIMEOUT_S))
        got = {r.request_id: r for r in out}
        check(sorted(got) == list(range(CLUSTER_MIGRATE)),
              f"drain check: completed {sorted(got)}")
        check(drained["migrated"] >= 1, f"drain check: {drained}")
        check_tokens(got, ref, trace, "drain and migrate")
        return {"drained": drained,
                "migrations": sum(r.migrations for r in out),
                "requeues": sum(r.requeues for r in out),
                "identical": len(got)}
    finally:
        gate.restore()
        router.close(shutdown_workers=True)
        for s in servers:
            s.stop()


def worker_stats(router) -> dict:
    """Each pool's one worker's stats, scraped now: {pool: stats}; a
    worker's ``launch_counts`` are its process's running totals."""
    router.scrape_stats()
    return {"prefill": dict(router._prefill[0].stats),
            "decode": dict(router._decode[0].stats)}


def worker_launches(before, after, want_of, what) -> dict:
    """Each worker's launches between two :func:`worker_stats` snapshots,
    held to the launches its work in that window fixes: a prefill (one
    request at batch 1) launches K1 2L+1 times and K2 L times, and K4
    once when the request samples; a decode step K1 2L+1 times and row
    7 L times, and K4 once when its lanes sample.  ``want_of(pool,
    calls)`` -> that pool's {kernel: launches}, ``calls`` the worker's
    prefill calls or decode steps in the window."""
    from apex_tpu_torch.ops import _kernel_utils as ku

    out = {}
    for pool, key in (("prefill", "prefill_calls"),
                      ("decode", "decode_steps")):
        b, a = before[pool]["launch_counts"], after[pool]["launch_counts"]
        got = {k: a.get(k, 0) - b.get(k, 0) for k in ku.KERNELS}
        calls = after[pool][key] - before[pool][key]
        want = _want(want_of(pool, calls))
        check(got == want,
              f"{what}: {pool} worker launched {got}, not {want} "
              f"({calls} {key})")
        out[pool] = got
    return out


def cluster_phase(dev) -> dict:
    """GPT-2 125M at 12 layers, h768, bf16, paged blocks of 16, seed 0:
    one prefill and one decode worker as separate processes behind a
    Router (raw wire), a bursty open-loop trace of CLUSTER_REQUESTS greedy
    requests replayed on them and on one in-process engine from the same
    seed (tokens equal for every request), then CLUSTER_SAMPLED sampled
    requests (K4 in both workers), the int8 and bf16 wires, a mid-flight
    drain in-process, and a decode worker on a primed compiled-ladder
    directory."""
    import argparse
    import os

    import numpy as np

    from apex_tpu_torch import observability as tobs
    from apex_tpu_torch.ops import _kernel_utils as ku
    from apex_tpu_torch.serving import ServingEngine
    from apex_tpu_torch.serving.cluster import Router
    from apex_tpu_torch.serving.cluster import worker as cw
    from apex_tpu_torch.observability import openmetrics

    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    root = str(Path(__file__).resolve().parent)
    env = {"PYTHONPATH": root + os.pathsep + os.environ.get("PYTHONPATH", "")}
    trace = cluster_trace(np.random.RandomState(CLUSTER_SEED), VOCAB_LIMIT)
    out = {"model": "gpt_125m 12 layers h768 bf16, paged blocks of "
                    f"{CLUSTER_BLOCK}, {CLUSTER_SLOTS} decode lanes",
           "requests": len(trace), "new_tokens": CLUSTER_NEW,
           "prompt_tokens": [len(kw["prompt"]) for _t, kw in trace]}
    procs = []
    router = None
    reg = None
    try:
        pend = spawn_pair(env, decode_extra=["--export-port", "0"])
        procs += [p.proc for p in pend]
        pfw, dcw = pend
        out["ready_ms"] = {"prefill": pfw.ready_ms, "decode": dcw.ready_ms}
        check(dcw.metrics is not None, "decode worker exports no /metrics")
        # bench.py's warmup before the clock: the first two requests at
        # two tokens (libraries loaded, first calls made in both workers)
        router = Router([pfw.addr], [dcw.addr], rpc_timeout=CLUSTER_RPC_S)
        for _t, kw_ in trace[:2]:
            router.submit(kw_["prompt"], max_new_tokens=2)
        check(len(router.run(max_wall_s=CLUSTER_TIMEOUT_S)) == 2,
              "cluster warmup")
        router.close()
        injected0 = openmetrics.sample_value(
            scrape(dcw.metrics), "serving_kv_injected_total")
        # the router's own telemetry: /healthz over its pool-stall and
        # SLO detectors
        reg = tobs.configure(export_port=0)
        router = Router([pfw.addr], [dcw.addr], rpc_timeout=CLUSTER_RPC_S)
        # --- the main path: each worker's counts read just before and
        # just after the replay, the difference its launches -----------
        st0 = worker_stats(router)
        t0 = time.perf_counter()
        got = router.run_trace(trace, max_wall_s=CLUSTER_TIMEOUT_S)
        wall = time.perf_counter() - t0
        st1 = worker_stats(router)
        resps = {r.request_id: r for r in got}
        check(sorted(resps) == list(range(len(trace))),
              f"cluster replay completed {sorted(resps)}")
        out["cluster"] = topology_report(resps.values(), wall)
        out["cluster"]["handoff_bytes_total"] = sum(
            r.handoff_bytes for r in resps.values())
        out["cluster"]["requeued"] = router.stats()["requeued"]
        out["router_healthz"] = healthz(reg.exporter.url)
        print(f"cluster replay: {json.dumps(out['cluster'])}")
        check(out["router_healthz"] == 200,
              f"router /healthz {out['router_healthz']}: "
              f"{[a.to_dict() for a in reg.detectors.anomalies]}")
        tobs.shutdown()
        reg = None
        injected = openmetrics.sample_value(
            scrape(dcw.metrics), "serving_kv_injected_total") - injected0
        out["decode_kv_injected"] = injected
        check(injected == len(trace),
              f"decode worker serving_kv_injected_total grew by "
              f"{injected}, not {len(trace)}")
        L = CLUSTER_MODEL["layers"]
        steps = st1["decode"]["decode_steps"] - st0["decode"]["decode_steps"]
        check(st1["prefill"]["prefill_calls"]
              - st0["prefill"]["prefill_calls"] == len(trace),
              "the prefill worker did not prefill each request once")
        check(CLUSTER_NEW - 1 <= steps <= len(trace) * (CLUSTER_NEW - 1),
              f"decode worker ran {steps} steps for {len(trace)} requests "
              f"of {CLUSTER_NEW - 1} steps each")
        out["decode_steps"] = steps
        out["counts"] = worker_launches(
            st0, st1, lambda pool, n: (
                {"layer_norm_fwd": (2 * L + 1) * n,
                 "flash_attention_fwd": L * n} if pool == "prefill" else
                {"layer_norm_fwd": (2 * L + 1) * n,
                 "fused_decode_layer": L * n}), "raw-wire replay")

        # the single engine: same seed, same geometry, same trace
        ns = argparse.Namespace(seed=CLUSTER_SEED, device=str(dev),
                                **CLUSTER_MODEL)
        params, cfg = cw._build_model(ns)
        eng = ServingEngine(params, cfg, device=dev,
                            generator=torch.Generator().manual_seed(0),
                            **CLUSTER_ENGINE)
        eng.run([dict(prompt=kw_["prompt"], max_new_tokens=2)
                 for _t, kw_ in trace[:2]])           # the same warmup
        eng = ServingEngine(params, cfg, device=dev,
                            generator=torch.Generator().manual_seed(0),
                            **CLUSTER_ENGINE)
        ref, wall_single = replay_single(eng, trace)
        check(sorted(ref) == list(range(len(trace))),
              f"single replay completed {sorted(ref)}")
        out["single"] = topology_report(ref.values(), wall_single)
        out["single"]["handoff_bytes_total"] = 0
        out["single"]["requeued"] = 0
        check_tokens(resps, ref, trace, "raw-wire cluster")
        out["tokens_identical"] = len(resps)
        del eng
        torch.cuda.empty_cache()

        # sampled requests: K4 in the prefill worker (first tokens) and
        # the decode worker (every step)
        rng = np.random.RandomState(CLUSTER_SEED + 1)
        for _ in range(CLUSTER_SAMPLED):
            router.submit(rng.randint(0, VOCAB_LIMIT, (64,)).tolist(),
                          max_new_tokens=CLUSTER_NEW, temperature=0.8)
        sampled = router.run(max_wall_s=CLUSTER_TIMEOUT_S)
        st2 = worker_stats(router)
        check(len(sampled) == CLUSTER_SAMPLED
              and all(len(r.tokens) == CLUSTER_NEW
                      and int(r.tokens.max()) < VOCAB_LIMIT
                      and int(r.tokens.min()) >= 0 for r in sampled),
              f"sampled requests: {[r.tokens.tolist() for r in sampled]}")
        check(st2["prefill"]["prefill_calls"]
              - st1["prefill"]["prefill_calls"] == CLUSTER_SAMPLED,
              "the prefill worker did not prefill each sampled request once")
        out["counts_sampled"] = worker_launches(
            st1, st2, lambda pool, n: (
                {"layer_norm_fwd": (2 * L + 1) * n,
                 "flash_attention_fwd": L * n, "fused_sample": n}
                if pool == "prefill" else
                {"layer_norm_fwd": (2 * L + 1) * n,
                 "fused_decode_layer": L * n, "fused_sample": n}),
            "sampled requests")
        router.close()
        router = None

        # compressed wires: not held to token identity
        out["wires"] = {}
        for wire in CLUSTER_WIRES:
            router = Router([pfw.addr], [dcw.addr], wire_dtype=wire,
                            rpc_timeout=CLUSTER_RPC_S)
            got = {r.request_id: r for r in
                   router.run_trace(trace, max_wall_s=CLUSTER_TIMEOUT_S)}
            check(sorted(got) == list(range(len(trace))),
                  f"{wire} wire completed {sorted(got)}")
            div = [first_divergence(got[i].tokens.tolist(),
                                    ref[i].tokens.tolist())
                   for i in range(len(trace))]
            out["wires"][wire] = {
                "handoff_bytes_total": sum(r.handoff_bytes
                                           for r in got.values()),
                "requests_identical": sum(d is None for d in div),
                "first_divergence": min((d for d in div if d is not None),
                                        default=None),
                "first_divergence_by_request": div}
            router.close(shutdown_workers=wire == CLUSTER_WIRES[-1])
            router = None
        for p in procs:
            cw.shutdown_worker(p)
        procs = []
        out["cluster_processes_s"] = time.perf_counter() - t_phase

        # drain and migrate, in-process, on the card
        ku.reset_launch_counts()
        out["drain"] = drain_check(params, cfg, trace, ref, dev)
        out["drain"]["counts"] = ku.launch_counts()

        # the compiled ladder: a decode worker on a directory this run
        # primed with its kernel libraries (no nvcc in the worker)
        d = _fresh_dir("cluster_decode")
        ku.build_all(directory=d / "kernels")
        t0 = time.perf_counter()
        gpend = spawn_pair(env, decode_extra=["--compile-cache", str(d)])
        procs += [p.proc for p in gpend]
        out["graph_ladder"] = {
            "ready_ms": {"prefill": gpend[0].ready_ms,
                         "decode": gpend[1].ready_ms},
            "spawn_wall_s": time.perf_counter() - t0}
        router = Router([gpend[0].addr], [gpend[1].addr],
                        rpc_timeout=CLUSTER_RPC_S)
        for _t, kw_ in trace[:CLUSTER_MIGRATE]:
            router.submit(**kw_)
        got = {r.request_id: r for r in
               router.run(max_wall_s=CLUSTER_TIMEOUT_S)}
        router.scrape_stats()
        st = router._decode[0].stats
        out["graph_ladder"].update(
            compile_cache={k: st["compile_cache"][k]
                           for k in ("entries", "hits", "misses")},
            requests_identical=sum(
                first_divergence(got[i].tokens.tolist(),
                                 ref[i].tokens.tolist()) is None
                for i in got))
        check(len(got) == CLUSTER_MIGRATE,
              f"graph-ladder decode worker completed {sorted(got)}")
        check(out["graph_ladder"]["requests_identical"] == CLUSTER_MIGRATE,
              f"graph-ladder decode worker: tokens identical to the single "
              f"engine for {out['graph_ladder']['requests_identical']} of "
              f"{CLUSTER_MIGRATE}")
        router.close(shutdown_workers=True)
        router = None
    finally:
        if router is not None:
            router.close()
        if reg is not None:
            tobs.shutdown()
        for p in procs:
            cw.shutdown_worker(p)
    out["phase_s"] = time.perf_counter() - t_phase
    return out


def _nonzero(counts):
    return {p: {k: v for k, v in n.items() if v} for p, n in counts.items()}


def print_cluster(c, smi):
    print(f"cluster gpt_125m ({c['model']}) on {smi}: READY ms "
          f"{json.dumps(c['ready_ms'])}; {c['requests']} greedy requests "
          f"(+{c['new_tokens']} tokens, prompts "
          f"{min(c['prompt_tokens'])}-{max(c['prompt_tokens'])}) raw wire: "
          f"tokens identical to the single engine for "
          f"{c['tokens_identical']} of {c['requests']}; two processes "
          f"{json.dumps(c['cluster'])}; single engine "
          f"{json.dumps(c['single'])}; decode worker "
          f"serving_kv_injected_total {c['decode_kv_injected']}, router "
          f"/healthz {c['router_healthz']}; worker launches in the "
          f"replay ({c['decode_steps']} decode steps) "
          f"{json.dumps(_nonzero(c['counts']))}, in the "
          f"{CLUSTER_SAMPLED} sampled requests "
          f"{json.dumps(_nonzero(c['counts_sampled']))}")
    print(f"cluster wires on {smi}: {json.dumps(c['wires'])}")
    dr = c["drain"]
    print(f"cluster drain in-process on {smi}: {json.dumps(dr['drained'])}, "
          f"migrations {dr['migrations']}, requeues {dr['requeues']}, "
          f"identical to the undrained run {dr['identical']} of "
          f"{CLUSTER_MIGRATE}; graph-ladder decode worker "
          f"{json.dumps(c['graph_ladder'])}; phase {c['phase_s']:.1f}s")


def matmul_times(root: str) -> dict:
    """Rows 5, 9 and 10 of the ``apex_tpu_torch`` found under ``root``
    (this checkout, or a ``git archive`` of another commit unpacked
    elsewhere), built from that tree's sources and timed as CUDA-graph
    replays at the main paths' shapes: row 10 at the four GPT-2 125M
    matmuls for M = 32, 1024 and 4096 (bf16), row 9's forward, transposed
    read and int8 slab (kb 128) at the ragged MoE step's fc1 and fc2 over
    the ``moe`` offsets of tests/torch_gmm_cases.py (4096 rows, 8 uneven
    experts), row 9's fp32 branch at one layer's 8 LoRA calls at decode
    (32 rows over 20 live groups of 24) and at an adapter prefill (1024
    rows), and row 5 with K6 + K7 beside it at BERT's shape (b8 s512 n16
    d64, key padding), the MoE steps' (b8 s512 n12 d64 causal) and at d128
    (b8 s512 n8, key padding), K6 and K7 at the GPT step's (b16 s1024 n12
    d64 causal); row
    11 at BERT's fused_softmax scores ([8, 16, 512, 512] fp32 and bf16,
    [8, 1, 1, 512] key padding), K1 at the five main paths' shapes
    (LN_SHAPES, bf16 x, fp32 γ/β), row 6 at the engine's decode (b32 MHA,
    PAGED_LENS, bf16 and int8 pools) and K3 at generate's (b8 MHA,
    DECODE_LENS, fp32 W, bf16 and int8 pools), row 8 (K4) at generate's
    [8, 50304] and the engine's [32, 50304] (fp32, top-k 50, top-p 0.95)
    and K2 at head size 64 (the smoke's serving shape b8 s512 n12 causal
    with padding, and the GPT step's b16 s1024 n12 causal) and 128.  It
    calls only entry points both this tree and its parent have (for rows
    11 and K1
    ``softmax_fwd`` and ``layer_norm_fwd_stats``, for rows 6 and 7
    ``ragged_paged_attention`` and ``fused_decode_layer``, for row 8
    ``fused_sample``, for K2 ``flash_attention_fwd``), so that parent and
    change run the same measurement in one chip call."""
    sys.path.insert(0, str(Path(root).resolve()))
    import apex_tpu_torch
    from apex_tpu_torch.ops import _kernel_utils as ku
    from apex_tpu_torch.ops import decode_step as tds
    from apex_tpu_torch.ops import dense as td
    from apex_tpu_torch.ops import flash_attention as tfa
    from apex_tpu_torch.ops import fused_sampling as tfs
    from apex_tpu_torch.ops import grouped_matmul as tgm
    from apex_tpu_torch.ops import layer_norm as tln
    from apex_tpu_torch.ops import paged_attention as tpa
    from apex_tpu_torch.ops import softmax as tsm

    pkg = Path(apex_tpu_torch.__file__).resolve().parent
    check(pkg.parent == Path(root).resolve(),
          f"imported {pkg}, not the tree under {root}")
    sys.path.insert(0, str(Path(__file__).resolve().parent / "tests"))
    from torch_gmm_cases import offsets_case

    t0 = time.perf_counter()
    ku.build_all(["dense_int8.cu", "grouped_matmul.cu", "flash_attention.cu",
                  "flash_attention_bwd.cu", "flash_attention_bwd_short.cu",
                  "softmax.cu", "layer_norm.cu", "paged_attention.cu",
                  "decode_step.cu", "fused_sampling.cu"])
    build_s = time.perf_counter() - t0
    gen = torch.Generator(device="cuda").manual_seed(0)
    bf = torch.bfloat16
    row10 = {}
    with torch.inference_mode():
        for m in (32, 1024, 4096):
            for site, k, n in DENSE_SITES:
                slab = td.quantize_weight(
                    torch.randn(k, n, device="cuda", generator=gen) * 0.02)
                x = torch.randn(m, k, device="cuda", generator=gen).to(bf)
                row10[f"M={m} {site}"] = time_ms(
                    lambda: td.dense_quantized(x, slab["wire"],
                                               slab["scale"]))
        n, g, off = offsets_case("moe")
        offs = torch.as_tensor(off, device="cuda")

        def rnd(*shape, scale=1.0):
            return (torch.randn(*shape, device="cuda", generator=gen)
                    * scale).to(bf)

        row9 = {}
        for site, k, p in (("fc1", MOE_H, MOE_F), ("fc2", MOE_F, MOE_H)):
            w = rnd(g, k, p, scale=0.02)
            x, dy = rnd(n, k), rnd(n, p)
            q = tgm.quantize_group_weights(w.float(), QUANT_KB)
            row9[f"{site} forward"] = time_ms(
                lambda: tgm._gmm_route(x, w, offs, False))
            row9[f"{site} dx"] = time_ms(
                lambda: tgm._gmm_route(dy, w, offs, False, trans=True))
            row9[f"{site} int8"] = time_ms(
                lambda: tgm.grouped_matmul_quantized(x, q["wire"],
                                                     q["scale"], offs))
        lora = {}
        for lay in ("decode", "prefill"):
            ln, lg, loff = offsets_case(lay)
            loffs = torch.as_tensor(loff, device="cuda")
            per = {}
            for site, h_in, h_out in LORA_SITES:
                for side, k, p in (("A", h_in, LORA_RANK),
                                   ("B", LORA_RANK, h_out)):
                    x = torch.randn(ln, k, device="cuda", generator=gen)
                    w = torch.randn(lg, k, p, device="cuda",
                                    generator=gen) * 0.1
                    per[f"{site} {side}"] = time_ms(
                        lambda: tgm.grouped_matmul(x, w, loffs))
            lora[lay] = {"sum_ms": sum(per.values()), "per_call_ms": per}
    row5 = {}
    for name, (n, causal, pad, d) in (
            ("bert b8 s512 n16 padded", (16, False, True, 64)),
            ("moe b8 s512 n12 causal", (12, True, False, 64)),
            ("d128 b8 s512 n8 padded", (8, False, True, 128))):
        kpm = None
        if pad:
            lens = bert_lens(BERT_BATCH, BERT_SEQ,
                             torch.Generator().manual_seed(4)).cuda()
            lens[-1] = 0
            kpm = torch.arange(BERT_SEQ, device="cuda")[None] >= lens[:, None]
        *_, ops = _flash_bwd_case("cuda", gen, BERT_BATCH, BERT_SEQ, n, n, d,
                                  causal, kpm)
        row5[name] = {
            "row5_ms": time_ms(lambda: tfa.flash_bwd_fused(ops,
                                                           causal=causal)),
            "k6_k7_ms": time_ms(lambda: (tfa.flash_bwd_dq(ops, causal=causal),
                                         tfa.flash_bwd_dkv(ops,
                                                           causal=causal)))}
    # K6 + K7 at the GPT step's shape (the split pair's main path)
    *_, ops = _flash_bwd_case("cuda", gen, TRAIN_BATCH, TRAIN_SEQ, 12, 12, 64,
                              True, None)
    row5["gpt b16 s1024 n12 causal"] = {
        "k6_ms": time_ms(lambda: tfa.flash_bwd_dq(ops, causal=True)),
        "k7_ms": time_ms(lambda: tfa.flash_bwd_dkv(ops, causal=True))}
    del ops
    row11, k1 = {}, {}
    with torch.inference_mode():
        lens = bert_lens(BERT_BATCH, BERT_SEQ,
                         torch.Generator().manual_seed(5)).cuda()
        lens[-1] = 0
        kpm = (torch.arange(BERT_SEQ, device="cuda")[None]
               >= lens[:, None])[:, None, None, :]
        x = torch.randn(BERT_BATCH, 16, BERT_SEQ, BERT_SEQ, device="cuda",
                        generator=gen) * 8
        for name, xt in (("fp32", x), ("bf16", x.bfloat16())):
            row11[f"bert {name} key padding"] = time_ms(
                lambda: tsm.softmax_fwd(xt, 0.125, kpm))
        del x, xt
        for name, rows, h in LN_SHAPES:
            w = torch.randn(h, device="cuda", generator=gen)
            b = torch.randn(h, device="cuda", generator=gen)
            x = torch.randn(rows, h, device="cuda", generator=gen).to(bf)
            k1[f"[{rows}, {h}] ({name})"] = time_ms(
                lambda: tln.layer_norm_fwd_stats(x, w, b))
    paged = {}
    with torch.inference_mode():
        for quant in (False, True):
            pool = "int8" if quant else "bf16"
            args, sc = _paged_inputs("cuda", gen, 12, quant)
            paged[f"row 6 b32 mha {pool} pool"] = time_ms(
                lambda: tpa.ragged_paged_attention(*args, **sc))
            args, sc = _decode_inputs("cuda", gen, 12, 12, 64, False, quant,
                                      torch.float32, False)
            paged[f"K3 b8 mha {pool} pool"] = time_ms(
                lambda: tds.fused_decode_layer(*args, **sc))
    row8, k2 = {}, {}
    with torch.inference_mode():
        # a tree whose K4 reads its key words from device memory takes
        # them as a device tensor (a captured decode step's form); an older
        # one as Python words, which it passes as kernel arguments
        words = (torch.tensor([1, 2], dtype=torch.int64, device="cuda")
                 if hasattr(tfs, "sample_plan") else (1, 2))
        for b in (8, 32):
            x = torch.randn(b, 50304, device="cuda", generator=gen) * 4
            temps = torch.tensor([0.8, 1.0, 0.0, 0.5, 1.5, 0.8, 0.0, 2.0]
                                 * (b // 8), device="cuda")
            row8[f"[{b}, 50304] fp32 top_k=50 top_p=0.95"] = time_ms(
                lambda: tfs.fused_sample(x, seed_words=words,
                                         temperature=temps, top_k=50,
                                         top_p=0.95,
                                         vocab_limit=VOCAB_LIMIT))
        lens = torch.tensor(PROMPT_LENS, device="cuda")
        kpm = torch.arange(512, device="cuda")[None] >= lens[:, None]
        for name, (b, s_, pad, d) in (
                ("b8 s512 n12 d64 causal+pad", (8, 512, True, 64)),
                ("b16 s1024 n12 d64 causal", (TRAIN_BATCH, TRAIN_SEQ, False,
                                              64)),
                ("b8 s512 n12 d128 causal+pad", (8, 512, True, 128))):
            q, k, v = (torch.randn(b, s_, 12, d, device="cuda",
                                   generator=gen).bfloat16()
                       for _ in range(3))
            m = kpm if pad else None
            k2[name] = time_ms(lambda: tfa.flash_attention_fwd(
                q, k, v, causal=True, key_padding_mask=m))
    return {"root": str(root), "device": nvidia_smi(),
            "build_s": build_s, "row10_ms": row10, "row9_ms": row9,
            "row8_ms": row8, "k2_ms": k2,
            "row9_lora_fp32": lora, "row5": row5, "row11_ms": row11,
            "k1_ms": k1, "paged_ms": paged,
            "moe_loads": [int(b - a) for a, b in zip(off, off[1:])]}


def paged_probe() -> dict:
    """Rows 6 and 7 (K3) under forced plans and uniform lengths, CUDA-graph
    replays in µs: row 6 at the engine's decode shape (b32, PAGED_LENS) and
    at generate's (b8, DECODE_LENS), each with the planner's split count and
    others; every lane of one length (0, 1, 128, 129, 256: launch and exit
    alone, one token, one full chunk, a second chunk of one token, two
    chunks); K3 with all lengths 0 (the attention's launch and the whole
    projection) and with a bf16 W."""
    from apex_tpu_torch.ops import decode_step as tds
    from apex_tpu_torch.ops import paged_attention as tpa

    gen = torch.Generator(device="cuda").manual_seed(0)
    res = {}

    def us(fn, plan=None):
        real = tpa.plan_for
        if plan is not None:
            tpa.plan_for = tds.plan_for = lambda *a: plan
        try:
            return round(time_ms(fn) * 1e3, 2)
        finally:
            tpa.plan_for = tds.plan_for = real

    with torch.inference_mode():
        for shape in ("row6 b32", "k3 b8"):
            if shape == "k3 b8":
                (q, kp, vp, tab, lens, w), sc = _decode_inputs(
                    "cuda", gen, 12, 12, 64, False, False, torch.float32,
                    False)
            else:
                (q, kp, vp, tab, lens), sc = _paged_inputs("cuda", gen, 12,
                                                           False)
            reach = tab.shape[1] * kp.shape[1]
            plan = tpa.plan_for(q, kp, tab)
            res[f"{shape} plan"] = list(plan)
            res[f"{shape} row 6"] = us(
                lambda: tpa.ragged_paged_attention(q, kp, vp, tab, lens))
            for splits in (1, 2, 4, 8, 16):
                per = -(-reach // splits)
                chunk = -(-per // 64) * 64
                forced = plan._replace(splits=-(-reach // chunk),
                                       chunk=chunk)
                res[f"{shape} row 6, {forced.splits} splits"] = us(
                    lambda: tpa.ragged_paged_attention(q, kp, vp, tab, lens),
                    forced)
            dn_max = min(q.shape[2], 32 * plan.epl)
            for stages in (3, 4):
                deeper = plan._replace(stages=stages, smem=tpa.paged_smem(
                    q.shape[2], kp.element_size(), plan.rc, dn_max,
                    plan.tile, stages))
                res[f"{shape} row 6, ring of {stages}"] = us(
                    lambda: tpa.ragged_paged_attention(q, kp, vp, tab, lens),
                    deeper)
            mapped = ((tab < kp.shape[0]).sum(1) * kp.shape[1]).int()
            for n in (0, 1, 128, 129, 256):
                ln = torch.minimum(torch.full_like(lens, n), mapped)
                res[f"{shape} row 6, every length {n}"] = us(
                    lambda: tpa.ragged_paged_attention(q, kp, vp, tab, ln))
            if shape == "k3 b8":
                res["k3 b8"] = us(
                    lambda: tds.fused_decode_layer(q, kp, vp, tab, lens, w))
                wb = w.bfloat16()
                res["k3 b8, bf16 W"] = us(
                    lambda: tds.fused_decode_layer(q, kp, vp, tab, lens, wb))
                z = torch.zeros_like(lens)
                res["k3 b8, every length 0"] = us(
                    lambda: tds.fused_decode_layer(q, kp, vp, tab, z, w))
    return {"device": nvidia_smi(), "us": res}


SERVING_TIME_RUNS = 5


TRAIN_TIME_STEPS = 10


def train_times(root: str) -> dict:
    """The train steps of the ``apex_tpu_torch`` found under ``root`` (this
    checkout, or another commit's ``git archive``), built from that tree's
    sources: the GPT-2 125M O2 FusedAdam step (b16 x s1024), the BERT-large
    O2 FusedLAMB step under flash attention (b8 x s512) and the GPT-MoE
    ragged O2 step (b8 x s512), each TRAIN_TIME_STEPS host-timed steps
    after TRAIN_WARMUP (median, quartiles, every step) and one profiled
    step's device busy ms.  It calls only entry points both this tree and
    its parent have, so parent and change run the same measurement in one
    chip call (parent, change, change, parent)."""
    sys.path.insert(0, str(Path(root).resolve()))
    import apex_tpu_torch
    from apex_tpu_torch.models.bert import make_bert_train_step
    from apex_tpu_torch.models.gpt import make_gpt_train_step
    from apex_tpu_torch.ops import _kernel_utils as ku
    from apex_tpu_torch.optimizers import fused_adam, fused_lamb

    pkg = Path(apex_tpu_torch.__file__).resolve().parent
    check(pkg.parent == Path(root).resolve(),
          f"imported {pkg}, not the tree under {root}")
    t0 = time.perf_counter()
    built = ku.build_all()
    build_s = time.perf_counter() - t0
    dev = torch.device("cuda")
    steps = {
        "gpt_125m b16 s1024": lambda: (
            make_gpt_train_step(_train_cfg(), fused_adam(lr=1e-4), "O2",
                                device=dev),
            _batch(_train_cfg(), TRAIN_BATCH, 0, dev)),
        "bert_large flash b8 s512": lambda: (
            make_bert_train_step(bert_cfg("flash"),
                                 fused_lamb(lr=1e-4, weight_decay=0.01),
                                 "O2", device=dev),
            bert_batch(bert_cfg("flash"), BERT_BATCH, 0, dev)),
        "gpt_moe ragged b8 s512": lambda: (
            make_gpt_train_step(moe_cfg("ragged"), fused_adam(lr=1e-4), "O2",
                                device=dev),
            moe_batch(moe_cfg("ragged"), MOE_BATCH, 0, dev)),
    }
    res = {}
    for name, make in steps.items():
        (init, step), batch = make()
        state = init(torch.Generator().manual_seed(0))

        def one():
            nonlocal state
            state, _ = step(state, *batch)

        for _ in range(TRAIN_WARMUP):
            one()
        ms = [wall_ms(one) for _ in range(TRAIN_TIME_STEPS)]
        q1, med, q3 = quartiles(ms)
        _, busy, _, by_cat, _ = profile_busy(one)
        res[name] = {"step_ms": med, "step_ms_q1_q3": [q1, q3],
                     "step_ms_all": ms, "device_busy_ms": busy,
                     "device_ms_by_category": by_cat}
        del state, batch
        torch.cuda.empty_cache()
    return {"device": nvidia_smi(), "root": str(root), "build_s": build_s,
            "compiled": built, "steps": TRAIN_TIME_STEPS, **res}




def serving_times(root: str) -> dict:
    """The eager serving paths of the ``apex_tpu_torch`` found under
    ``root``, built from that tree's sources: the ``ServingEngine`` without
    a compile cache on the engine mix (``engine_requests``, ENGINE_KW;
    float + native and quantized + int8, SERVING_TIME_RUNS runs each after
    a warm-up: generated tokens/s and the median ms of a step that only
    decoded) and a greedy paged ``generate`` on the slice phase's batch
    (PROMPT_LENS, NEW_TOKENS; GENERATE_RUNS runs, and PREFILL_RUNS of its
    prefill alone: decode ms a step).  It calls only entry points both
    this tree and its parent have, so parent and change run the same
    measurement in one chip call."""
    sys.path.insert(0, str(Path(root).resolve()))
    import apex_tpu_torch
    from apex_tpu_torch.models import generate as tgen
    from apex_tpu_torch.ops import _kernel_utils as ku
    from apex_tpu_torch.serving import ServingEngine

    pkg = Path(apex_tpu_torch.__file__).resolve().parent
    check(pkg.parent == Path(root).resolve(),
          f"imported {pkg}, not the tree under {root}")
    t0 = time.perf_counter()
    ku.build_all(["layer_norm.cu", "flash_attention.cu", "fused_sampling.cu",
                  "decode_step.cu", "paged_attention.cu", "dense_int8.cu"])
    build_s = time.perf_counter() - t0
    dev = torch.device("cuda")
    cfg, weights = _engine_weights(dev)
    reqs = engine_requests(cfg.vocab_size)
    res = {}
    for wname, wire in GRAPH_RUNS:
        def engine():
            return ServingEngine(weights[wname], cfg, cache_wire=wire,
                                 generator=torch.Generator().manual_seed(0),
                                 device=dev, **ENGINE_KW)
        engine().run([dict(reqs[0], max_new_tokens=2),
                      dict(reqs[2], max_new_tokens=2)])
        tps, dec = [], []
        for _ in range(SERVING_TIME_RUNS):
            resps, wall, decode_ms = drive_steps(engine(), reqs)
            tps.append(sum(r.tokens.size for r in resps) / (wall / 1e3))
            dec.append(pct(decode_ms, 0.5))
        res[f"engine {wname} weights, {wire or 'native'} pool"] = {
            "gen_tokens_per_s": tps, "decode_ms_per_step": dec}
    params = weights["float"]
    gen = torch.Generator().manual_seed(1)
    b, s = len(PROMPT_LENS), max(PROMPT_LENS)
    prompt = torch.zeros(b, s, dtype=torch.long)
    for i, n in enumerate(PROMPT_LENS):
        prompt[i, :n] = torch.randint(0, VOCAB_LIMIT, (n,), generator=gen)
    prompt = prompt.to(dev)
    lens = torch.tensor(PROMPT_LENS, device=dev)
    kw = dict(max_new_tokens=NEW_TOKENS, prompt_lens=lens,
              cache_layout="paged", block_size=16, device=dev)
    tgen.generate(params, prompt, cfg, **dict(kw, max_new_tokens=2))

    def do_prefill():
        cache = tgen.init_kv_cache(cfg, b, s + NEW_TOKENS,
                                   cache_layout="paged", block_size=16,
                                   device=dev)
        tgen.prefill(params, prompt, cfg, prompt_lens=lens, cache=cache,
                     device=dev)

    prefill = quartiles([wall_ms(do_prefill) for _ in range(PREFILL_RUNS)])
    gen_ms = quartiles([wall_ms(lambda: tgen.generate(params, prompt, cfg,
                                                      **kw))
                        for _ in range(GENERATE_RUNS)])
    res["generate greedy"] = {
        "generate_ms": gen_ms[1], "generate_ms_q1_q3": [gen_ms[0],
                                                        gen_ms[2]],
        "prefill_ms": prefill[1],
        "decode_ms_per_step": (gen_ms[1] - prefill[1]) / (NEW_TOKENS - 1),
        "tokens_per_s": b * NEW_TOKENS / (gen_ms[1] / 1e3)}
    return {"device": nvidia_smi(), "root": str(root), "build_s": build_s,
            "runs": SERVING_TIME_RUNS, **res}


def main() -> int:
    check(torch.cuda.is_available(),
          "no CUDA device: chip_smoke.py runs only on the card")
    if sys.argv[1:2] == ["--paged-probe"]:
        # python3 chip_smoke.py --paged-probe: rows 6 and 7 under forced
        # plans and lengths
        print(json.dumps(paged_probe()))
        return 0
    if sys.argv[1:2] == ["--graph-child"]:
        # python3 chip_smoke.py --graph-child DIR WEIGHTS WIRE: one fresh
        # graph engine on DIR (the graph engine phase starts it)
        print(json.dumps(graph_child(*sys.argv[2:5])))
        return 0
    if sys.argv[1:2] == ["--serving-times"]:
        # python3 chip_smoke.py --serving-times ROOT: the eager engine and
        # generate of the port under ROOT
        print(json.dumps(serving_times(sys.argv[2])))
        return 0
    if sys.argv[1:2] == ["--train-times"]:
        # python3 chip_smoke.py --train-times ROOT: the GPT, BERT-flash and
        # MoE train steps of the port under ROOT
        print(json.dumps(train_times(sys.argv[2])))
        return 0
    if sys.argv[1:2] == ["--cluster"]:
        # python3 chip_smoke.py --cluster: the cluster phase and the remat
        # family check alone (one JSON line)
        from apex_tpu_torch.ops import _kernel_utils as ku
        from apex_tpu_torch.ops import (  # noqa: F401  (register them)
            decode_step, dense, flash_attention, fused_sampling,
            grouped_matmul, layer_norm, paged_attention, softmax)

        dev = torch.device("cuda")
        ku.build_all()
        print(json.dumps({"cluster": cluster_phase(dev),
                          "remat_family": remat_family_check(dev)}))
        return 0
    if sys.argv[1:2] == ["--matmul-times"]:
        # python3 chip_smoke.py --matmul-times ROOT: rows 5-7, 9-11, K1
        print(json.dumps(matmul_times(sys.argv[2])))
        return 0
    dev = torch.device("cuda")
    # wall seconds of each phase, printed at the end (the script's time
    # limit is shared by all of them)
    phase_s, t_mark = {}, [time.perf_counter()]

    def mark(label):
        now = time.perf_counter()
        phase_s[label] = round(now - t_mark[0], 1)
        t_mark[0] = now

    cap = torch.cuda.get_device_capability(0)
    check(cap == (9, 0), f"compute capability {cap}, need (9, 0) (Hopper)")
    device_name = torch.cuda.get_device_name(0)
    smi = nvidia_smi()
    print(f"device: {device_name} x{torch.cuda.device_count()} capability "
          f"{cap}; "
          f"nvidia-smi: {smi}; torch {torch.__version__} "
          f"cuda {torch.version.cuda}")

    from apex_tpu_torch.multi_tensor import (  # noqa: F401
        multi_tensor_apply)
    from apex_tpu_torch.ops import _kernel_utils as ku
    from apex_tpu_torch.ops import (  # noqa: F401  (register the kernels)
        decode_step, dense, flash_attention, fused_sampling, grouped_matmul,
        layer_norm, paged_attention, softmax)

    t0 = time.perf_counter()
    built = ku.build_all()
    print(f"build: {time.perf_counter() - t0:.1f}s wall (one nvcc per "
          f"source, in parallel), compiled now: {built}")

    attrs, sass = hopper_kernels()
    print(f"hopper kernels (16-bit K2, K6, K7, row 5; rows 9 and 10's "
          f"tensor-core routes, row 9's fp32 cluster kernel; row 11 and K1's "
          f"row kernels; rows 6 and 7's split-key kernel and K3's "
          f"projection; row 8's cluster sampler) on {smi}: "
          f"registers, shared memory per CTA, CTAs per "
          f"SM and spill bytes {json.dumps(attrs)}; SASS HGMMA / UTMALDG "
          f"per kernel {json.dumps(sass)}")

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
        for vname, v in r.get("variants", {}).items():
            vlib = v["library_ms"]
            verr = (f"max_abs_err {v['err']:.3g}, " if "err" in v else "")
            print(f"  {kname} [{vname}]: {verr}kernel {v['ms']:.4f} ms, plain "
                  f"{v['plain_ms']:.4f} ms, library "
                  f"{'none' if vlib is None else f'{vlib:.4f} ms'}, bound "
                  f"{v['bound_ms']:.4f} ms ({v['bound_by']})")

    mark("build and hopper line")
    gen = torch.Generator(device="cuda").manual_seed(0)
    with torch.inference_mode():
        for kname, fn in (("layer_norm_fwd", kernel_layer_norm),
                          ("flash_attention_fwd", kernel_flash),
                          ("fused_decode_layer", kernel_decode),
                          ("fused_sample", kernel_sampler),
                          ("ragged_paged_attention", kernel_paged),
                          ("grouped_matmul", kernel_grouped_matmul)):
            report(kname, fn(dev, gen))
        for kname, r in kernel_dense_int8(dev, gen).items():
            report(kname, r)
        mark("serving kernels")
        sl = slice_phase(dev)
        mqa = mqa_generate_phase(dev)
        mark("generate")
        eng = engine_phase(dev)
        mark("engine")
        graphs = graph_engine_phase(dev)
        mark("graph engine")
        lora = lora_engine_phase(dev)
        oracle = lora_oracle_phase(dev)
        mark("lora")
        spec_gen, spec_gen_paths = spec_generate_phase(dev)
        mark("spec generate")
        spec_eng, spec_eng_paths = spec_engine_phase(dev)
        mark("spec engine")
        tier, tier_paths = host_tier_phase(dev)
        mark("host tier")
        foreign, foreign_paths = foreign_pool_phase(dev)
        mark("fp32 over bf16 pool")
    cluster = cluster_phase(dev)
    mark("cluster")
    for gname, row in graphs.items():
        if "profiled" not in row:
            continue
        idle = {k: v["device_idle_share"] for k, v in row["profiled"].items()}
        print(f"graph engine {gname} on {smi}: generated tokens/s eager "
              f"{row['gen_tokens_per_s_eager']:.1f}, graph "
              f"{row['gen_tokens_per_s_graph']:.1f}; decode ms a step eager "
              f"{row['decode_ms_per_step_eager']:.3f}, graph "
              f"{row['decode_ms_per_step_graph']:.3f}; idle share {idle}; "
              f"ladder {row['ladder_entries']} entries in "
              f"{row['ladder_ms']:.1f} ms; start-up: fresh process on the "
              f"primed directory {row['warm_child']['start_ms']:.1f} ms "
              f"(process {row['warm_child']['process_ms']:.1f} ms)"
              + (f", on an empty directory "
                 f"{row['cold_child']['start_ms']:.1f} ms (process "
                 f"{row['cold_child']['process_ms']:.1f} ms, nvcc on "
                 f"{len(row['cold_child']['nvcc'])} sources)"
                 if "cold_child" in row else "")
              + f"; chunked: short TPOT p95 "
              f"{row['chunked']['short_tpot_p95_ms_chunked']:.3f} ms vs "
              f"{row['chunked']['short_tpot_p95_ms_unchunked']:.3f} "
              f"unchunked, greedy identical "
              f"{row['chunked']['greedy_identical']} of "
              f"{row['chunked']['greedy']}")
    for sweep, row in spec_gen.items():
        print(f"spec generate {sweep} (gpt_125m b{SPEC_BATCH} prompt "
              f"{SPEC_PROMPT} +{SPEC_NEW}, k {SPEC_K}, paged bf16) on {smi}: "
              f"accept rate {row['accept_rate']:.4f}, tokens per verify "
              f"{row['tokens_per_verify']:.3f}, {row['rounds']} rounds, K1 "
              f"{row['k1_launches_per_round']} a round; decode tokens/s spec "
              f"{row['decode_tokens_per_s_spec']:.1f} vs off "
              f"{row['decode_tokens_per_s_off']:.1f}; greedy rows identical "
              f"to spec-off {row['greedy_rows_identical_to_off']}")
    for ename, row in spec_eng.items():
        print(f"spec engine {ename} on {smi}: generated tokens/s eager "
              f"{row['gen_tokens_per_s_eager']:.1f}, graph "
              f"{row['gen_tokens_per_s_graph']:.1f}; decode ms a step eager "
              f"{row['decode_ms_per_step_eager']:.3f}, graph "
              f"{row['decode_ms_per_step_graph']:.3f}; accept rate "
              f"{row['accept_rate']:.4f}, tokens per verify "
              f"{row['tokens_per_verify']:.3f}"
              + (f"; verify gathers (aten::index, eager) "
                 f"{row['profiled_eager']['verify_gather_device_ms']} ms of "
                 f"{row['profiled_eager']['device_busy_ms']} busy; graph idle "
                 f"share {row['profiled_graph']['device_idle_share']}"
                 if "profiled_eager" in row else ""))
    print(f"host tier on {smi}: resumes {tier['tier_counters']}, page-in "
          f"ms per resume p50 {tier['page_in_ms_per_resume_p50']:.3f} vs "
          f"replay prefill ms p50 {tier['replay_prefill_ms_p50']:.3f}; "
          f"tier-on tokens identical to tier-off on "
          f"{tier['requests_identical_tier_on_vs_off']} of "
          f"{tier['requests_identical_to_unstarved']} requests; shared "
          f"prefix: {json.dumps(tier['shared_prefix'])}")
    print(f"fp32 compute over a bf16 pool on {smi}: {json.dumps(foreign)}")
    print_cluster(cluster, smi)
    prof = lora["profiled lora float weights, native pool"]
    print(f"lora engine phase on {smi}: {lora['phase_wall_s']:.1f}s wall; "
          f"profiled run {json.dumps(prof)}")
    print(f"lora fp32 merged oracle ({ORACLE_LAYERS} layers, "
          f"{ORACLE_TENANTS} tenants, {ORACLE_NEW} new tokens): "
          f"{oracle['identical']} of {ORACLE_TENANTS} streams identical; "
          f"{json.dumps(oracle)}")
    print(f"mqa generate: {mqa['shape']} on {smi}: launches "
          f"{mqa['counts']}; rows identical to plain "
          f"{mqa['rows_identical']} of {len(PROMPT_LENS)}, near-ties "
          f"{json.dumps(mqa['near_ties'])}; teacher-forced logits max "
          f"|kernel - plain| {mqa['logit_err']:.5f} (tol {LOGIT_TOL})")
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
          f"{sl['device_top_ms']}; profiled sampled generate (top-k 50, "
          f"top-p 0.95, temperature 0.8): device busy "
          f"{sl['sampled_device_busy_ms']:.3f} ms, K4 "
          f"{sl['sampled_k4_device_ms']:.3f} ms")

    mark("serving prints")
    report("layer_norm_bwd", kernel_layer_norm_bwd(dev, gen))
    for kname, r in kernel_flash_bwd(dev, gen).items():
        report(kname, r)
    short = kernel_flash_bwd_short(dev, gen)
    d80_fwd, d80_bwd = kernel_flash_d80(dev, gen)
    d80 = "b8 s512 n32 d80 causal (head size between tile widths)"
    results["flash_attention_fwd"]["variants"][d80] = d80_fwd
    short["variants"][d80] = d80_bwd
    print(f"K2 and row 5 at head size 80, {d80}, bf16, on {smi}: forward "
          f"{json.dumps(d80_fwd)}; backward {json.dumps(d80_bwd)}")
    report("flash_attention_bwd_short", short)
    branches, branch_errs = kernel_flash_branches(dev, gen)
    for kname, rows in branches.items():
        results[kname]["variants"] = {**results[kname]["variants"], **rows}
    print(f"rows 3, 4a, 4b and 5: dropout {DROPOUT_P} and segment-id "
          f"branches against their plain versions on {smi}: errors "
          f"{json.dumps(branch_errs)}; times {json.dumps(branches)}")
    wide, wide_counts = kernel_flash_wide(dev, gen)
    for kname, r in wide.items():
        report(kname, r)
    print(f"wide heads (rows 3, 4a, 4b above d128), b{WIDE_SHAPE[0]} "
          f"s{WIDE_SHAPE[1]} n{WIDE_SHAPE[2]} causal bf16 on {smi}: d256 "
          + ", ".join(f"{k} {r['ms']:.4f} ms" for k, r in wide.items())
          + "; d320 " + ", ".join(
              f"{k} {v['ms']:.4f} ms" for k, r in wide.items()
              for v in r["variants"].values())
          + f"; path launches {json.dumps({k: c for k, c in wide_counts.items() if c})}")
    with torch.inference_mode():
        simt, simt_counts = kernel_gmm_int8_simt(dev, gen)
    report("grouped_matmul_int8_simt", simt)
    packed = packed_phase(dev, gen)
    for kname, rows in packed.pop("variants").items():
        results[kname]["variants"] = {**results[kname]["variants"], **rows}
    print(f"packed attention [{PACKED_TOKENS}, {PACKED_HEADS}, {PACKED_DIM}]"
          f" bf16 causal, dropout {DROPOUT_P}, {packed['documents']} "
          f"documents of {PACKED_DOC_LENS[0]}-{PACKED_DOC_LENS[1]} tokens on "
          f"{smi}: forward + backward {packed['packed_fwd_bwd_ms']:.3f} ms "
          f"against a dense causal call's {packed['dense_causal_fwd_bwd_ms']:.3f}; "
          f"K2 {packed['packed_fwd_ms']:.4f} ms vs dense causal "
          f"{packed['dense_causal_fwd_ms']:.4f} ms, K6 "
          f"{packed['packed_k6_ms']:.4f} vs {packed['dense_causal_k6_ms']:.4f}"
          f", K7 {packed['packed_k7_ms']:.4f} vs "
          f"{packed['dense_causal_k7_ms']:.4f} (open pairs "
          f"{packed['open_pairs']} of {packed['dense_causal_pairs']}); SDPA "
          f"with the block-diagonal mask forward "
          f"{packed['sdpa_block_diagonal_fwd_ms']:.4f} ms, backward "
          f"{packed['sdpa_block_diagonal_bwd_ms']:.4f} ms; launches "
          f"{json.dumps({k: c for k, c in packed['counts'].items() if c})}; "
          f"max error {max(v for k, v in packed['errs'].items() if 'whole' not in k):.4g} (tol "
          f"{packed['tol']}, relative; o of the 4096-token prefix absolute); "
          f"whole row against the plain version in query blocks "
          f"{ {k: v for k, v in packed['errs'].items() if 'whole' in k} }")
    print(f"row 5 vs K6 + K7 crossover (b8, d64, bf16; flash_attention_bwd "
          f"sends up to {flash_attention.SHORT_KEYS_MAX} keys to row 5) on "
          f"{smi}: "
          f"{json.dumps(short['crossover'])}; row 5's (head, query tile) "
          f"steps with products per rank [warpgroup 0, 1]: "
          f"{json.dumps(short['rank_steps'])}; resident clusters by keys "
          f"(d64 bf16): {json.dumps(short['resident_clusters'])}")
    with torch.inference_mode():
        report("scaled_softmax_fwd", kernel_softmax(dev, gen))
    print(f"row 11's backward composition (_ScaledSoftmax.backward, torch "
          f"ops) at its main shape on {smi}: "
          f"{results['scaled_softmax_fwd']['backward_composition_ms']:.4f} "
          "ms a call")
    mark("training kernels")
    mt_rows, mt_overflow = multi_tensor_phase(dev)
    for kname, r in mt_rows.items():
        report(kname, r)
    print(f"multi-tensor kernels M1-M4 at the train steps' master trees on "
          f"{smi}: one launch a call at "
          + ", ".join(f"{r['leaves']} leaves ({r['shape'].split(' master')[0]})"
                      for r in [mt_rows["multi_tensor_scale"],
                                *mt_rows["multi_tensor_scale"]["variants"]
                                .values()])
          + f"; an inf planted in one gradient, and {MT_MANY} tensors "
          f"(launches a call, error): {json.dumps(mt_overflow)}")
    mark("multi-tensor kernels")
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
    print(f"train gpt_125m optimizer tail (record_function spans, one "
          f"profiled step each) on {smi}: kernels {json.dumps(tr['tail']['kernels'])}; "
          f"plain tail (the per-leaf torch composition, same model path) "
          f"{json.dumps(tr['tail']['plain'])}, its step ms "
          f"{tr['tail']['plain_tail_step_ms']}; bounds "
          f"{json.dumps(tr['tail']['bound_ms'])}")
    torch.cuda.empty_cache()
    tc = train_check(dev)
    print(f"train kernel vs plain, b{CHECK_BATCH} x s{TRAIN_SEQ}, "
          f"{CHECK_STEPS} steps: (loss, overflow, scale) kernel "
          f"{tc['kernel']} plain {tc['plain']}; max loss diff "
          f"{tc['loss_err']:.5f} (tol {TRAIN_LOSS_TOL}); grad norms kernel "
          f"{tc['grad_norm_kernel']} plain {tc['grad_norm_plain']}, max "
          f"rel diff {tc['grad_norm_rel_err']:.5f} (tol {GRAD_NORM_RTOL}); "
          f"norm_telemetry grad/update/param norms max rel diff "
          f"{tc['norm_telemetry_rel_err']:.5f} (kernel "
          f"{tc['norm_telemetry_kernel']})")
    torch.cuda.empty_cache()
    ta = train_accum_check(dev)
    print(f"train gpt accum_steps=4 (4 x b{TRAIN_BATCH // 4}) vs 1 at "
          f"b{TRAIN_BATCH} x s{TRAIN_SEQ}, {CHECK_STEPS} steps: (loss, "
          f"overflow, scale) {ta['accum_4']} vs {ta['accum_1']}; max loss "
          f"diff {ta['loss_err']:.5f} (tol {TRAIN_LOSS_TOL}); launches of "
          f"one accumulating step "
          f"{json.dumps({k: c for k, c in ta['launches_accum_4'].items() if c})}")

    torch.cuda.empty_cache()
    trd = dropout_train_phase(dev, "gpt")
    print(f"train gpt_125m AMP-O2 with hidden and attention dropout "
          f"{DROPOUT_P} b{TRAIN_BATCH} x s{TRAIN_SEQ} on {smi}: step median "
          f"{trd['step_ms']:.2f} ms (q1-q3 {trd['step_ms_q1_q3']}, "
          f"{DROPOUT_STEPS} steps), {trd['tokens_per_s']:.1f} tokens/s, MFU "
          f"{trd['mfu']:.4f}; the dropout-free step in this run "
          f"{tr['step_ms']:.2f} ms, MFU {tr['mfu']:.4f} (PERF.md: 77.34 ms, "
          f"run BE); launches {json.dumps({k: c for k, c in trd['counts'].items() if c})}"
          f"; {_dropout_profile_text(trd)}")
    torch.cuda.empty_cache()
    tcd = dropout_train_check(dev, "gpt")
    print(f"train gpt dropout kernel vs plain, b{CHECK_BATCH} x "
          f"s{TRAIN_SEQ}, {CHECK_STEPS} steps: (loss, overflow, scale) "
          f"kernel {tcd['kernel']} plain {tcd['plain']}; max loss diff "
          f"{tcd['loss_err']:.5f} (tol {TRAIN_LOSS_TOL}); grad norms "
          f"max rel diff {tcd['grad_norm_rel_err']:.5f} (tol "
          f"{GRAD_NORM_RTOL})")
    mark("gpt train")
    bert, bert_checks, bert_drop = {}, {}, {}
    for backend in BERT_BACKENDS:
        torch.cuda.empty_cache()
        br = bert[backend] = bert_train_phase(dev, backend)
        print(f"train bert_large {backend} AMP-O2 fused_lamb(lr=1e-4, "
              f"wd=0.01) b{BERT_BATCH} x s{BERT_SEQ} ({br['params']} "
              f"params, {br['real_tokens']} real tokens) on {smi}: step "
              f"median {br['step_ms']:.2f} ms (q1-q3 {br['step_ms_q1_q3']}, "
              f"{TRAIN_STEPS} steps), {br['tokens_per_s']:.1f} tokens/s "
              f"(b x s), {br['real_tokens_per_s']:.1f} real tokens/s, MFU "
              f"{br['mfu']:.4f} of 989 TFLOP/s; profiled step "
              f"{br['profiled_step_ms']:.1f} ms, device busy "
              f"{br['device_busy_ms']} ms, idle share "
              f"{br['device_idle_share']}; peak memory "
              f"{br['peak_memory_gb']:.2f} GB; init {br['init_s']:.1f}s; "
              f"losses {br['losses']}; loss scales {br['loss_scales']}; "
              f"overflow {br['overflow']}; device ms by category "
              f"{br['device_ms_by_category']}; top device time "
              f"{br['device_top_ms']}; by launching op "
              f"{br['device_ms_by_op']}")
        print(f"train bert {backend} optimizer tail spans on {smi}: "
              f"{json.dumps(br['tail'])}")
        if backend == "fused_softmax":
            print(f"bert fused_softmax step, softmax device ms on {smi}: "
                  f"row 11 forward {br['row11_forward_device_ms']}, "
                  f"backward composition (_ScaledSoftmax.backward) "
                  f"{br['softmax_backward_composition_device_ms']}")
        torch.cuda.empty_cache()
        bc = bert_checks[backend] = bert_train_check(dev, backend)
        print(f"train bert {backend} kernel vs plain, b{CHECK_BATCH} x "
              f"s{BERT_SEQ}, {CHECK_STEPS} steps: (loss, overflow, scale) "
              f"kernel {bc['kernel']} plain {bc['plain']}; max loss diff "
              f"{bc['loss_err']:.5f} (tol {TRAIN_LOSS_TOL}); grad norms "
              f"kernel {bc['grad_norm_kernel']} plain "
              f"{bc['grad_norm_plain']}, max rel diff "
              f"{bc['grad_norm_rel_err']:.5f} (tol {GRAD_NORM_RTOL})")
        torch.cuda.empty_cache()
        bd = bert_drop[backend] = dropout_train_phase(dev, "bert", backend)
        torch.cuda.empty_cache()
        bdc = bd["check"] = dropout_train_check(dev, "bert", backend)
        print(f"train bert_large {backend} AMP-O2 with hidden and attention "
              f"dropout {DROPOUT_P} b{BERT_BATCH} x s{BERT_SEQ} on {smi}: "
              f"step median {bd['step_ms']:.2f} ms (q1-q3 "
              f"{bd['step_ms_q1_q3']}, {DROPOUT_STEPS} steps), "
              f"{bd['tokens_per_s']:.1f} tokens/s, MFU {bd['mfu']:.4f}; the "
              f"dropout-free step in this run {br['step_ms']:.2f} ms, MFU "
              f"{br['mfu']:.4f}"
              + (" (PERF.md: 134.80 ms)" if backend == "flash" else "")
              + f"; kernel vs plain b{CHECK_BATCH}, {CHECK_STEPS} steps: "
              f"losses {bdc['kernel']} vs {bdc['plain']}, max loss diff "
              f"{bdc['loss_err']:.5f}, grad norm max rel diff "
              f"{bdc['grad_norm_rel_err']:.5f}; {_dropout_profile_text(bd)}")

    mark("bert train")
    moe, moe_checks, moe_master = {}, {}, None
    for routing in MOE_ROUTINGS:
        torch.cuda.empty_cache()
        mr, master = moe_train_phase(dev, routing)
        moe[routing] = mr
        if routing == "ragged":
            moe_master = master
        del master
        print(f"train gpt_moe {routing} AMP-O2 fused_adam(lr=1e-4) "
              f"b{MOE_BATCH} x s{MOE_SEQ} ({mr['params']} params, "
              f"{mr['active_params']} active per token) on {smi}: step "
              f"median {mr['step_ms']:.2f} ms (q1-q3 {mr['step_ms_q1_q3']}, "
              f"{TRAIN_STEPS} steps), {mr['tokens_per_s']:.1f} tokens/s, MFU "
              f"{mr['mfu']:.4f} ({mr['mfu_formula']}); profiled step "
              f"{mr['profiled_step_ms']:.1f} ms, device busy "
              f"{mr['device_busy_ms']} ms, idle share "
              f"{mr['device_idle_share']}, busy / median step "
              f"{mr['busy_over_median_step']}; peak memory "
              f"{mr['peak_memory_gb']:.2f} GB; init {mr['init_s']:.1f}s; "
              f"losses {mr['losses']}; loss scales {mr['loss_scales']}; "
              f"overflow {mr['overflow']}; expert load per layer "
              f"{mr['expert_load']}; aux loss per layer {mr['aux_loss']}; "
              f"dropped fraction per layer {mr['dropped_fraction']}; device "
              f"ms by category {mr['device_ms_by_category']}; top device "
              f"time {mr['device_top_ms']}; by launching op "
              f"{mr['device_ms_by_op']}")
        print(f"train gpt_moe {routing} optimizer tail spans on {smi}: "
              f"{json.dumps(mr['tail'])}")
        torch.cuda.empty_cache()
        mc = moe_checks[routing] = moe_train_check(dev, routing)
        print(f"train gpt_moe {routing} kernel vs plain, b{CHECK_BATCH} x "
              f"s{MOE_SEQ}, {CHECK_STEPS} steps: (loss, overflow, scale) "
              f"kernel {mc['kernel']} plain {mc['plain']}; max loss diff "
              f"{mc['loss_err']:.5f} (tol {TRAIN_LOSS_TOL}); grad norms "
              f"kernel {mc['grad_norm_kernel']} plain "
              f"{mc['grad_norm_plain']}, max rel diff "
              f"{mc['grad_norm_rel_err']:.5f} (tol {GRAD_NORM_RTOL}); "
              f"one routing: router logits and probabilities per step "
              f"{mc['routing_drift']} (logit tol {LOGIT_TOL}); free running:"
              f" routing flips per step {mc['routing_flips']}, layers with "
              f"unequal expert loads {mc['layers_with_unequal_loads']}")
    torch.cuda.empty_cache()
    mdrop = dropout_train_phase(dev, "moe")
    torch.cuda.empty_cache()
    mdc = mdrop["check"] = dropout_train_check(dev, "moe")
    print(f"train gpt_moe ragged AMP-O2 with hidden and attention dropout "
          f"{DROPOUT_P} b{MOE_BATCH} x s{MOE_SEQ} on {smi}: step median "
          f"{mdrop['step_ms']:.2f} ms (q1-q3 {mdrop['step_ms_q1_q3']}, "
          f"{DROPOUT_STEPS} steps), {mdrop['tokens_per_s']:.1f} tokens/s, "
          f"MFU {mdrop['mfu']:.4f} (active parameters); the dropout-free "
          f"step in this run {moe['ragged']['step_ms']:.2f} ms; kernel vs "
          f"plain b{CHECK_BATCH}, {CHECK_STEPS} steps in lockstep: losses "
          f"{mdc['kernel']} vs {mdc['plain']}, max loss diff "
          f"{mdc['loss_err']:.5f}, grad norm max rel diff "
          f"{mdc['grad_norm_rel_err']:.5f}; {_dropout_profile_text(mdrop)}")
    torch.cuda.empty_cache()
    mq = moe_quantized_phase(dev, moe_master)
    del moe_master
    print(f"gpt_moe ragged quantize_params teacher-forced forward "
          f"b{MOE_BATCH} x s{MOE_SEQ} on {smi}: forward median "
          f"{mq['forward_ms']:.2f} ms (q1-q3 {mq['forward_ms_q1_q3']}), "
          f"{mq['tokens_per_s']:.1f} tokens/s, MFU {mq['mfu']:.4f} "
          f"({mq['mfu_formula']}); profiled forward "
          f"{mq['profiled_forward_ms']:.1f} ms, device busy "
          f"{mq['device_busy_ms']} ms, idle share {mq['device_idle_share']};"
          f" peak memory {mq['peak_memory_gb']:.2f} GB; param bytes "
          f"{mq['param_bytes_quantized']} (float {mq['param_bytes_float']})"
          f"; logits kernel vs plain under one routing "
          f"{mq['logit_err']:.5f} (tol {LOGIT_TOL}), router "
          f"{mq['routing_drift']}; free running: logits "
          f"{mq['logit_err_free_running']:.5f}, routing flips "
          f"{mq['routing_flips']}; loss quantized {mq['loss_quantized']:.5f}"
          f" vs float {mq['loss_float']:.5f}; expert load per layer "
          f"{mq['expert_load']}; device ms by category "
          f"{mq['device_ms_by_category']}; top device time "
          f"{mq['device_top_ms']}")
    torch.cuda.empty_cache()
    with torch.inference_mode():
        moe_kernels, grouped_dw = kernel_grouped_matmul_moe(
            dev, gen, moe["ragged"]["expert_load"][0])
    for kname, r in moe_kernels.items():
        report(kname, r)
    print(f"_grouped_dw per call (masked full-N products over the "
          f"{MOE_BATCH * MOE_SEQ} token slots, [8, k, p] fp32) on {smi}: "
          f"{json.dumps(grouped_dw)}")
    gm = generic_mask_phase(dev)
    print(f"generic mask: {gm['shape']}: launches {gm['counts']}; logits "
          f"kernel vs plain {gm['logit_err']:.5f} (tol {LOGIT_TOL})")

    mark("moe and masks")
    slice_paths = {}
    training = training_slice(dev, gen, results, slice_paths)
    print_training_slice(training, smi)
    mark("remat, per-op casts, memory_efficient, swiglu, checkpoint")
    print(f"phase seconds: {json.dumps(phase_s)}")
    paths = {"serving": sl["counts"], "mqa generate": mqa["counts"],
             "train_step": tr["counts"], "train_step dropout": trd["counts"],
             "packed attention": packed["counts"],
             "wide head attention": wide_counts,
             "row 9 int8 geometries": simt_counts}
    paths.update({f"bert {b} dropout": row["counts"]
                  for b, row in bert_drop.items()})
    paths.update({f"bert {b}": row["counts"] for b, row in bert.items()})
    paths.update({f"moe {r}": row["counts"] for r, row in moe.items()})
    paths["moe ragged dropout"] = mdrop["counts"]
    paths["train_step accum_steps=4"] = ta["launches_accum_4"]
    paths["moe int8 forward"] = mq["counts"]
    paths["generic mask"] = gm["counts"]
    paths.update(slice_paths)
    for extra in (spec_gen_paths, spec_eng_paths, tier_paths, foreign_paths):
        paths.update(extra)
    paths["cluster prefill worker"] = cluster["counts"]["prefill"]
    paths["cluster decode worker"] = cluster["counts"]["decode"]
    paths["cluster prefill worker sampled"] = (
        cluster["counts_sampled"]["prefill"])
    paths["cluster decode worker sampled"] = (
        cluster["counts_sampled"]["decode"])
    paths["cluster drain in-process"] = cluster["drain"].pop("counts")
    paths.update({f"engine {name}": row["counts"]
                  for name, row in eng.items() if "counts" in row})
    paths.update({f"engine {name}": row["counts"]
                  for name, row in lora.items()
                  if isinstance(row, dict) and "counts" in row})
    for gname, row in graphs.items():
        paths[f"graph engine {gname}"] = row["counts"]
        if "chunked" in row:
            paths[f"chunked graph engine {gname}"] = row["chunked"]["counts"]
    line = {"kernels": [
        {"name": k, "route": "cuda", "source": "apex_tpu_torch/csrc/"
         + ku.KERNELS[k].source, "replaces": ku.KERNELS[k].replaces,
         "launches": sum(c.get(k, 0) for c in paths.values()),
         "launches_by_path": {p: c.get(k, 0) for p, c in paths.items()},
         "max_abs_err": r["err"], "max_rel_err": r.get("rel_err"),
         "tol": r["tol"],
         "tol_of": "max_rel_err" if "rel_err" in r else "max_abs_err",
         "ms": r["ms"],
         "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
         "bound_by": r["bound_by"], "library_ms": r["library_ms"],
         "variants": r.get("variants", {})}
        for k, r in results.items()],
        "slice": {k: v for k, v in sl.items() if k != "counts"},
        "mqa_generate": {k: v for k, v in mqa.items() if k != "counts"},
        "engine": {n: {k: v for k, v in row.items() if k != "counts"}
                   for n, row in eng.items()},
        "lora_engine": {n: ({k: v for k, v in row.items() if k != "counts"}
                            if isinstance(row, dict) else row)
                        for n, row in lora.items()},
        "graph_engine": {n: _without_counts(row) for n, row in graphs.items()},
        "lora_oracle": oracle,
        "train": {k: v for k, v in tr.items() if k != "counts"},
        "train_check": tc,
        "train_dropout": {k: v for k, v in trd.items() if k != "counts"},
        "train_dropout_check": tcd,
        "bert_train_dropout": {n: {k: v for k, v in row.items()
                                   if k != "counts"}
                               for n, row in bert_drop.items()},
        "packed_attention": {k: v for k, v in packed.items()
                             if k != "counts"},
        "bert_train": {n: {k: v for k, v in row.items() if k != "counts"}
                       for n, row in bert.items()},
        "bert_train_check": bert_checks,
        "moe_train": {n: {k: v for k, v in row.items() if k != "counts"}
                      for n, row in moe.items()},
        "moe_train_check": moe_checks,
        "moe_train_dropout": {k: v for k, v in mdrop.items()
                              if k != "counts"},
        "train_accum_check": {k: v for k, v in ta.items()
                              if not k.startswith("launches")},
        "multi_tensor_overflow": mt_overflow,
        "moe_int8_forward": {k: v for k, v in mq.items() if k != "counts"},
        "grouped_dw": grouped_dw,
        "flash_bwd_crossover": short["crossover"],
        "softmax_backward_composition_ms":
            results["scaled_softmax_fwd"]["backward_composition_ms"],
        "generic_mask": {k: v for k, v in gm.items() if k != "counts"},
        "spec_generate": spec_gen, "spec_engine": spec_eng,
        "host_tier": tier, "fp32_over_bf16_pool": foreign,
        "cluster": {k: v for k, v in cluster.items()
                    if k not in ("counts", "counts_sampled")},
        "training_slice": training, "phase_s": phase_s}
    print(json.dumps(line))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
