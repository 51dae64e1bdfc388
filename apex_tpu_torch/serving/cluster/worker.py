"""Prefill and decode workers of the disaggregated serving tier
(``apex_tpu/serving/cluster/worker.py``).

One :class:`WorkerServer` is one pool member: a single-threaded
``select()`` loop that multiplexes the socket protocol
(:mod:`~apex_tpu_torch.serving.cluster.protocol`) with engine stepping,
so RPC handling and decode progress interleave without locking: the
engine is only ever touched from this loop.

Two roles (``role=``):

- ``"prefill"`` — holds the model parameters and the prompt buckets; a
  ``prefill`` RPC runs ONE batched prefill (kernels K1 and K2; row 10
  with quantized weights) into a scratch cache (paged by default, the K/V
  extracted through the block table as a resident paged engine hands its
  pages over; ``"contiguous"`` slices a stripe), draws the first token
  as the serving engine does (the masked argmax for greedy requests,
  kernel K4 for sampled ones), and returns it with the serialized K/V
  (:mod:`~apex_tpu_torch.serving.cluster.handoff`).  Shapes are the
  bucket shapes a single engine's admission runs, so a raw-wire handoff
  is bit-exact against never disaggregating.  An adapter request
  prefills through ``decode_verify`` with the adapter's delta (row 9).
- ``"decode"`` — wraps a :class:`~apex_tpu_torch.serving.ServingEngine`;
  a ``decode`` RPC injects the handoff (``submit_prefilled``) and the
  serve loop steps the engine between RPCs (K1 and K3, or rows 6 and
  10 with quantized weights; K4 for sampled lanes).  ``poll`` returns
  completed responses and piggybacks ``engine.stats()``, the router's
  admission signal.

RPC surface (JSON headers; K/V rides as raw blobs), the JAX package's:

====================  ====================================================
``hello``             role/model handshake
``stats``             engine (or executor) stats, plus this process's
                      kernel launch counts (``launch_counts``)
``prefill``           ``{prompt, temperature, wire_dtype?, adapter_id?}``
                      → first token + K/V handoff blobs
``decode``            handoff + generation params → accepted ack
``poll``              completed responses + stats
``drain``             every request's state out, for migration
``shutdown``          clean stop (the loop exits after replying)
====================  ====================================================

``python -m apex_tpu_torch.serving.cluster.worker --role prefill ...``
runs a worker as its own OS process (on ``cuda`` unless ``--device``
says otherwise); :func:`spawn_worker` wraps that for callers.  Every
process builds the model from ``(--seed, geometry flags)`` through
:func:`~apex_tpu_torch.models.transformer_lm.init_gpt_params` with a
``torch.Generator(seed)``, so every port process materializes identical
parameters without shipping weights (they are not the JAX package's
draws: a JAX and a port worker share weights only when the caller
converts them, ``models/convert.py``).
"""

from __future__ import annotations

import dataclasses
import os
import select
import socket
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from apex_tpu_torch.serving.cluster import protocol
from apex_tpu_torch.serving.cluster.handoff import (
    WIRE_DTYPES, decode_kv, encode_kv, wire_bytes)

__all__ = ["WorkerServer", "spawn_worker", "spawn_worker_async",
           "PendingWorker", "shutdown_worker", "build_adapter_suite",
           "READY_PREFIX"]

READY_PREFIX = "APEX_TPU_CLUSTER_WORKER ready"


def build_adapter_suite(cfg, n: int, seed: int = 0, rank: int = 8,
                        device=None):
    """Deterministic LoRA adapters 1..n from ``(seed, geometry)``: every
    pool member (and a single-engine baseline) materializes the same
    adapters from a few integers, so no slab ever ships over the wire.
    ``b_std > 0`` makes the deltas visible (a zero B is a no-op)."""
    from apex_tpu_torch.models.lora import init_lora_adapter

    return {aid: init_lora_adapter(
                torch.Generator().manual_seed(seed * 100_003 + aid), cfg,
                rank=rank, b_std=0.02, device=device)
            for aid in range(1, int(n) + 1)}


@dataclasses.dataclass
class _PrefillExec:
    """The prefill worker's state: params, the bucket ladder, the
    sampling knobs and generator, and a scratch-cache prefill per request
    (no resident lanes: prefill is stateless between requests)."""

    params: dict
    cfg: object
    buckets: tuple
    cache_dtype: torch.dtype
    scratch_layout: str
    block_size: int
    sampling: dict
    generator: torch.Generator
    device: torch.device
    calls: int = 0
    # the deterministic adapter suite and a per-adapter slab stack
    adapters: dict = dataclasses.field(default_factory=dict)
    slab_cache: dict = dataclasses.field(default_factory=dict)


class WorkerServer:
    """One cluster worker: socket loop + (decode) engine pump.
    ``device`` defaults to ``cuda`` (raising without a card)."""

    def __init__(self, role: str, params, cfg, *,
                 host: str = "127.0.0.1", port: int = 0,
                 max_slots: int = 4, max_len: Optional[int] = None,
                 cache_layout: str = "contiguous", block_size: int = 16,
                 cache_dtype: Optional[torch.dtype] = None, cache_wire=None,
                 top_k=None, top_p=None, vocab_limit=None, slo_targets=None,
                 scratch_layout: str = "paged",
                 wire_dtype: str = "raw", seed: int = 0,
                 chunk_tokens: Optional[int] = None,
                 compile_cache: Optional[str] = None,
                 host_tier_bytes=None, host_tier_wire=None,
                 adapters: int = 0, adapter_pool_bytes=None,
                 device=None):
        if role not in ("prefill", "decode"):
            raise ValueError(f"role={role!r}: expected 'prefill' or "
                             "'decode'")
        if wire_dtype not in WIRE_DTYPES:
            raise ValueError(f"wire_dtype={wire_dtype!r}: expected one "
                             f"of {WIRE_DTYPES}")
        if scratch_layout not in ("contiguous", "paged"):
            raise ValueError(
                f"scratch_layout={scratch_layout!r}: expected "
                "'contiguous' or 'paged'")
        from apex_tpu_torch.serving.batching import default_buckets
        from apex_tpu_torch.serving.engine import ServingEngine
        from apex_tpu_torch.utils.registry import resolve_device

        dev = resolve_device(device)
        self.role = role
        self.cfg = cfg
        self.wire_dtype = wire_dtype
        self._max_len = int(max_len or cfg.max_position_embeddings)
        self._stop = False
        # engine and RPC bookkeeping are confined to the select loop
        self.engine: Optional[ServingEngine] = None
        self._exec: Optional[_PrefillExec] = None
        # engine request id -> (router rid, submit wall time)
        self._ridmap: Dict[int, tuple] = {}
        self._outbox: List[dict] = []
        # set by the drain RPC: new work is refused while the member's
        # state migrates out
        self._draining = False
        self.n_adapters = int(adapters)
        suite = (build_adapter_suite(cfg, self.n_adapters, seed, device=dev)
                 if self.n_adapters else {})
        if role == "decode":
            pool = None
            if suite:
                from apex_tpu_torch.serving.adapter_pool import AdapterPool

                pool = AdapterPool(cfg, pool_bytes=adapter_pool_bytes)
                for aid, ad in suite.items():
                    pool.register(aid, ad)
            self.engine = ServingEngine(
                params, cfg, max_slots=max_slots, max_len=self._max_len,
                cache_layout=cache_layout, block_size=block_size,
                cache_dtype=cache_dtype, cache_wire=cache_wire,
                top_k=top_k, top_p=top_p,
                vocab_limit=vocab_limit, slo_targets=slo_targets,
                chunk_tokens=chunk_tokens,
                host_tier_bytes=host_tier_bytes,
                host_tier_wire=host_tier_wire,
                compile_cache_dir=compile_cache,
                adapter_pool=pool,
                generator=torch.Generator().manual_seed(seed),
                device=dev)
        else:
            from apex_tpu_torch.models.generate import _compute_dtype_params

            self._exec = _PrefillExec(
                params=_compute_dtype_params(params, cfg), cfg=cfg,
                buckets=tuple(sorted(default_buckets(self._max_len))),
                cache_dtype=(cfg.compute_dtype if cache_dtype is None
                             else cache_dtype),
                scratch_layout=scratch_layout, block_size=block_size,
                sampling=dict(top_k=top_k, top_p=top_p,
                              vocab_limit=vocab_limit),
                generator=torch.Generator().manual_seed(seed),
                device=dev, adapters=suite)
        self._listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._listener.bind((host, int(port)))
        self._listener.listen(8)
        self.host, self.port = self._listener.getsockname()[:2]
        self._clients: List[socket.socket] = []

    @property
    def addr(self) -> str:
        return f"{self.host}:{self.port}"

    # -- serve loop ---------------------------------------------------------

    def serve_forever(self, poll_s: float = 0.02) -> None:
        """Run until a ``shutdown`` RPC or :meth:`stop`.  One iteration:
        service every readable socket, then (decode role) advance the
        engine one step and bank completions, so a long decode backlog
        never starves the control plane for more than one step."""
        try:
            while not self._stop:
                busy = self.engine is not None and not self.engine.idle
                r, _w, _x = select.select(
                    [self._listener] + self._clients, [], [],
                    0.0 if busy else poll_s)
                for sock in r:
                    if sock is self._listener:
                        conn, _ = self._listener.accept()
                        conn.settimeout(30.0)
                        self._clients.append(conn)
                        continue
                    self._service(sock)
                if busy:
                    self._pump()
        finally:
            self.close()

    def stop(self) -> None:
        self._stop = True

    def close(self) -> None:
        for sock in self._clients:
            try:
                sock.close()
            except OSError:
                pass
        self._clients = []
        try:
            self._listener.close()
        except OSError:
            pass

    def _pump(self) -> None:
        """One engine step; completed responses land in the outbox (read
        by the next ``poll``)."""
        for resp in self.engine.step():
            rid, _t = self._ridmap.pop(resp.request_id,
                                       (resp.request_id, 0.0))
            self._outbox.append(self._serialize(rid, resp))

    def _service(self, sock: socket.socket) -> None:
        try:
            msg = protocol.recv_msg(sock)
        except (protocol.ProtocolError, OSError):
            # a malformed frame, a recv timeout or any other socket
            # failure drops THAT client, never the pool member
            msg = None
        if msg is None:                       # peer gone
            try:
                sock.close()
            finally:
                if sock in self._clients:
                    self._clients.remove(sock)
            return
        header, blobs = msg
        try:
            reply, rblobs = self.handle(header, blobs)
        except Exception as e:                # noqa: BLE001 — one bad RPC
            # must not kill the pool member
            reply, rblobs = {"ok": False,
                             "error": f"{type(e).__name__}: {e}"}, []
        try:
            protocol.send_msg(sock, reply, rblobs)
        except OSError:
            if sock in self._clients:
                self._clients.remove(sock)

    # -- RPC handlers -------------------------------------------------------

    def handle(self, header: dict, blobs: List[bytes]):
        """Dispatch one RPC → ``(reply_header, reply_blobs)`` (public so
        in-process tests can drive a worker without sockets)."""
        op = header.get("op")
        if op == "hello":
            return {"ok": True, "role": self.role,
                    "max_len": self._max_len,
                    "wire_dtype": self.wire_dtype}, []
        if op == "stats":
            return {"ok": True, "role": self.role,
                    "stats": self._stats()}, []
        if op == "prefill":
            return self._handle_prefill(header)
        if op == "decode":
            return self._handle_decode(header, blobs)
        if op == "poll":
            if self.engine is None:
                return {"ok": False,
                        "error": "poll on a prefill worker"}, []
            # read what is ready without blocking the caller on decode
            # progress (the serve loop pumps between polls)
            if not self.engine.idle:
                self._pump()
            out, self._outbox = self._outbox, []
            return {"ok": True, "responses": out,
                    "stats": self._stats()}, []
        if op == "drain":
            return self._handle_drain()
        if op == "shutdown":
            self._stop = True
            return {"ok": True}, []
        return {"ok": False, "error": f"unknown op {op!r}"}, []

    def _handle_drain(self):
        """Lossless scale-down: stop admitting, then hand EVERY request's
        state back to the router — live lanes as migration records (the
        cache's token sequence, the pending token, the remaining budget
        and the per-token K/V on the RAW wire: a migration must not
        change one token), queued requests as requeue rids, and any
        completed-but-unpolled responses.  The engine is idle after."""
        self._draining = True
        if self.engine is None:
            return {"ok": True, "live": [], "requeue": [],
                    "responses": []}, []
        live, requeue = self.engine.drain()
        recs: List[dict] = []
        blobs_out: List[bytes] = []
        for rec in live:
            kv_header, kv_blobs = encode_kv(rec.pop("k"), rec.pop("v"),
                                            wire_dtype="raw")
            rid, _t = self._ridmap.pop(rec["engine_rid"],
                                       (rec["engine_rid"], 0.0))
            recs.append({
                "rid": rid,
                "prompt": [int(t) for t in rec["prompt"]],
                "first_token": rec["first_token"],
                "done_tokens": rec["done_tokens"],
                "max_new_tokens": rec["max_new_tokens"],
                "temperature": rec["temperature"],
                "eos_token_id": rec["eos_token_id"],
                "slo_class": rec["slo_class"],
                "adapter_id": rec.get("adapter_id", 0),
                "prefill_ms": rec["prefill_ms"],
                # source-leg accounting the router stitches onto the
                # survivor's numbers
                "preemptions": rec["preemptions"],
                "decode_polls": rec["decode_polls"],
                "kv": kv_header,
                "n_blobs": len(kv_blobs),
            })
            blobs_out.extend(kv_blobs)
        requeue_rids = []
        for req in requeue:
            rid, _t = self._ridmap.pop(req.request_id,
                                       (req.request_id, 0.0))
            requeue_rids.append(rid)
        out, self._outbox = self._outbox, []
        return {"ok": True, "live": recs, "requeue": requeue_rids,
                "responses": out}, blobs_out

    def _stats(self) -> dict:
        from apex_tpu_torch.ops import _kernel_utils as ku

        if self.engine is not None:
            st = dict(self.engine.stats())
            st["buckets"] = list(st["buckets"])
            st["pending_responses"] = len(self._outbox)
        else:
            st = {"role": "prefill",
                  "buckets": list(self._exec.buckets),
                  "prefill_calls": self._exec.calls,
                  "scratch_layout": self._exec.scratch_layout,
                  "queued": 0, "queued_by_class": {},
                  "free_block_headroom": 1, "headroom_tokens": 1}
        # which kernels this process launched, for a caller in another
        # process (readers that do not know the key ignore it)
        st["launch_counts"] = ku.launch_counts()
        return st

    def _first_token(self, logits, temperature: float) -> int:
        """The first token as the serving engine draws it: the masked
        argmax for greedy, one fused sampler call (K4) otherwise."""
        from apex_tpu_torch.ops.fused_sampling import fused_sample

        ex = self._exec
        kw = ex.sampling
        if temperature <= 0.0:
            first = fused_sample(logits, temperature=0.0,
                                 vocab_limit=kw["vocab_limit"])
        else:
            t = torch.tensor([temperature], dtype=torch.float32,
                             device=logits.device)
            first = fused_sample(logits, generator=ex.generator,
                                 temperature=t, top_k=kw["top_k"],
                                 top_p=kw["top_p"],
                                 vocab_limit=kw["vocab_limit"])
        return int(first[0])                       # host sync

    def _handle_prefill(self, header: dict):
        if self._exec is None:
            return {"ok": False,
                    "error": "prefill on a decode worker"}, []
        if self._draining:
            return {"ok": False, "error": "worker is draining"}, []
        from apex_tpu_torch.models.generate import (
            extract_kv, init_kv_cache, prefill)
        from apex_tpu_torch.serving.batching import pad_prompt, pick_bucket

        ex = self._exec
        dev = ex.device
        prompt = np.asarray(header["prompt"], np.int32).reshape(-1)
        if prompt.size < 1:
            return {"ok": False, "error": "empty prompt"}, []
        adapter_id = int(header.get("adapter_id", 0))
        if adapter_id and adapter_id not in ex.adapters:
            return {"ok": False,
                    "error": f"adapter_id={adapter_id} not in this "
                             f"worker's suite (--adapters "
                             f"{len(ex.adapters)})"}, []
        temperature = float(header.get("temperature", 0.0))
        wire_dtype = header.get("wire_dtype", self.wire_dtype)
        n = int(prompt.size)
        t0 = time.perf_counter()
        bucket = pick_bucket(n, ex.buckets)
        padded = torch.as_tensor(pad_prompt(prompt, bucket)[None],
                                 dtype=torch.long, device=dev)
        lens = torch.tensor([n], dtype=torch.int32, device=dev)
        if adapter_id:
            # the verify forward with the adapter's delta folded in, the
            # forward the decode engine's adapter admission runs; a
            # contiguous scratch (adapter pages are never shareable)
            from apex_tpu_torch.models.generate import decode_verify

            scratch = init_kv_cache(ex.cfg, 1, bucket,
                                    cache_dtype=ex.cache_dtype, device=dev)
            logits, cache = decode_verify(
                ex.params, padded, scratch, ex.cfg, device=dev,
                lora={"idx": torch.ones(1, dtype=torch.int32, device=dev),
                      "slabs": self._adapter_slabs(adapter_id)})
            logits = logits[:, n - 1]
        elif ex.scratch_layout == "paged":
            scratch = init_kv_cache(ex.cfg, 1, bucket,
                                    cache_dtype=ex.cache_dtype,
                                    cache_layout="paged",
                                    block_size=ex.block_size, device=dev)
            logits, cache = prefill(ex.params, padded, ex.cfg,
                                    prompt_lens=lens, cache=scratch,
                                    device=dev)
        else:
            logits, cache = prefill(ex.params, padded, ex.cfg,
                                    prompt_lens=lens, max_len=bucket,
                                    cache_dtype=ex.cache_dtype, device=dev)
        tok = self._first_token(logits, temperature)
        k, v = extract_kv(cache, n, row=0)
        kv_header, kv_blobs = encode_kv(k, v, wire_dtype=wire_dtype)
        ms = (time.perf_counter() - t0) * 1e3
        ex.calls += 1
        # prefill_pages marks the payload as fresh whole-prompt prefill
        # output (never decode-written drain records): the decode side may
        # publish raw-wire pages under the flash digest namespace.
        # Adapter pages never qualify.
        return {"ok": True, "first_token": tok, "n": n,
                "prefill_ms": round(ms, 3),
                "handoff_bytes": wire_bytes(kv_blobs),
                "prefill_pages": adapter_id == 0,
                "kv": kv_header}, kv_blobs

    def _adapter_slabs(self, adapter_id: int):
        """Single-adapter slab stack for the prefill forward (lane slot
        1 reads slab 0, the adapter), built once per adapter."""
        ex = self._exec
        if adapter_id not in ex.slab_cache:
            from apex_tpu_torch.models.lora import stack_adapter_slabs

            ex.slab_cache[adapter_id] = stack_adapter_slabs(
                [ex.adapters[adapter_id]], ex.cfg)
        return ex.slab_cache[adapter_id]

    def _handle_decode(self, header: dict, blobs: List[bytes]):
        if self.engine is None:
            return {"ok": False,
                    "error": "decode on a prefill worker"}, []
        if self._draining:
            # the router marks a draining worker undispatchable before
            # the drain RPC, so this guards crossed wires: refuse, and
            # the router requeues the request
            return {"ok": False, "error": "worker is draining"}, []
        k, v = decode_kv(header["kv"], blobs)
        prompt = np.asarray(header["prompt"], np.int32).reshape(-1)
        rid = header.get("rid")
        adapter_id = int(header.get("adapter_id", 0))
        # only raw-wire fresh-prefill pages are bit-identical to a local
        # flash prefill; drain records omit prefill_pages and stay
        # private, and adapter pages are never shareable
        shareable = (bool(header.get("prefill_pages"))
                     and header["kv"].get("wire_dtype") == "raw"
                     and adapter_id == 0)
        eng_rid = self.engine.submit_prefilled(
            prompt, k, v, int(header["first_token"]),
            max_new_tokens=int(header.get("max_new_tokens", 32)),
            temperature=float(header.get("temperature", 0.0)),
            eos_token_id=header.get("eos_token_id"),
            slo_class=str(header.get("slo_class", "default")),
            prefill_ms=float(header.get("prefill_ms", 0.0)),
            shareable=shareable, adapter_id=adapter_id)
        self._ridmap[eng_rid] = (rid if rid is not None else eng_rid,
                                 time.time())
        return {"ok": True, "accepted": True, "engine_rid": eng_rid}, []

    @staticmethod
    def _serialize(rid, resp) -> dict:
        return {
            "rid": rid,
            "tokens": [int(t) for t in resp.tokens],
            "finish_reason": resp.finish_reason,
            "prefill_ms": resp.prefill_ms,
            "decode_steps": resp.decode_steps,
            "slo_class": resp.slo_class,
            "queue_wait_ms": resp.queue_wait_ms,
            "ttft_ms": resp.ttft_ms,
            "tpot_ms": resp.tpot_ms,
            "e2e_ms": resp.e2e_ms,
            "preemptions": resp.preemptions,
            "preempt_overhead_ms": resp.preempt_overhead_ms,
            "slo_met": resp.slo_met,
        }


# -- process entry point -----------------------------------------------------


def _build_model(args):
    """The model from CLI geometry + seed: every process draws the same
    parameters from ``torch.Generator().manual_seed(seed)``."""
    from apex_tpu_torch.models.config import TransformerConfig
    from apex_tpu_torch.models.transformer_lm import init_gpt_params

    cfg = TransformerConfig(
        num_layers=args.layers, hidden_size=args.hidden,
        num_attention_heads=args.heads, vocab_size=args.vocab,
        max_position_embeddings=args.max_pos,
        compute_dtype=getattr(torch, args.compute_dtype))
    params = init_gpt_params(cfg, torch.Generator().manual_seed(args.seed),
                             args.device)
    return params, cfg


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        description="Run one cluster serving worker (prefill or decode "
                    "pool member).")
    ap.add_argument("--role", required=True, choices=("prefill", "decode"))
    ap.add_argument("--device", default="cuda",
                    help="torch device (cuda by default; cpu runs every "
                         "op's plain version)")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=0,
                    help="0 = ephemeral (read the READY line)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--hidden", type=int, default=64)
    ap.add_argument("--heads", type=int, default=4)
    ap.add_argument("--vocab", type=int, default=256)
    ap.add_argument("--max-pos", type=int, default=128)
    ap.add_argument("--compute-dtype", default="float32")
    ap.add_argument("--cache-dtype", default=None)
    ap.add_argument("--max-slots", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=None)
    ap.add_argument("--cache-layout", default="contiguous",
                    choices=("contiguous", "paged"))
    ap.add_argument("--cache-wire", default=None, choices=("native", "int8"),
                    help="paged-pool at-rest form")
    ap.add_argument("--block-size", type=int, default=16)
    ap.add_argument("--chunk-tokens", type=int, default=None,
                    help="chunked prefill: stream prompts longer than this "
                         "through fixed-size chunk forwards interleaved "
                         "with decode")
    ap.add_argument("--scratch-layout", default="paged",
                    choices=("contiguous", "paged"),
                    help="prefill scratch-cache layout (paged = the "
                         "block-table extraction path)")
    ap.add_argument("--wire-dtype", default="raw", choices=WIRE_DTYPES)
    ap.add_argument("--top-k", type=int, default=None)
    ap.add_argument("--top-p", type=float, default=None)
    ap.add_argument("--vocab-limit", type=int, default=None)
    ap.add_argument("--export-port", type=int, default=None,
                    help="also serve /metrics + /healthz on this localhost "
                         "port (0 = ephemeral)")
    ap.add_argument("--host-tier-bytes", default=None,
                    help="host-DRAM KV offload tier capacity (256m/2g "
                         "suffixes; 0/off disables)")
    ap.add_argument("--host-tier-wire", default=None, choices=("raw", "int8"),
                    help="host-tier at-rest codec")
    ap.add_argument("--adapters", type=int, default=0,
                    help="register this many synthetic LoRA adapters (ids "
                         "1..N)")
    ap.add_argument("--adapter-pool-bytes", default=None,
                    help="device budget of the decode-side adapter slab "
                         "pool; 256m/2g suffixes (APEX_TPU_ADAPTER_POOL_"
                         "BYTES overrides)")
    ap.add_argument("--compile-cache", default=None,
                    help="compiled-ladder directory: the decode engine "
                         "captures its ladder entries as CUDA graphs over "
                         "the kernel libraries kept here, and warms the "
                         "whole ladder before READY")
    args = ap.parse_args(argv)

    t_start = time.perf_counter()
    metrics_url = ""
    if args.export_port is not None:
        from apex_tpu_torch import observability as obs

        reg = obs.configure(export_port=args.export_port,
                            tags={"pool": args.role})
        metrics_url = reg.exporter.url
    params, cfg = _build_model(args)
    server = WorkerServer(
        args.role, params, cfg, host=args.host, port=args.port,
        max_slots=args.max_slots, max_len=args.max_len,
        cache_layout=args.cache_layout, block_size=args.block_size,
        cache_dtype=(None if args.cache_dtype is None
                     else getattr(torch, args.cache_dtype)),
        cache_wire=args.cache_wire,
        top_k=args.top_k, top_p=args.top_p,
        vocab_limit=args.vocab_limit,
        scratch_layout=args.scratch_layout,
        wire_dtype=args.wire_dtype, seed=args.seed,
        chunk_tokens=args.chunk_tokens,
        host_tier_bytes=args.host_tier_bytes,
        host_tier_wire=args.host_tier_wire,
        compile_cache=args.compile_cache,
        adapters=args.adapters,
        adapter_pool_bytes=args.adapter_pool_bytes,
        device=args.device)
    if server.engine is not None and server.engine._compile_cache:
        # warm the whole ladder BEFORE declaring READY: a primed directory
        # makes this a capture per entry with no nvcc run
        from apex_tpu_torch.serving.compile_cache import warmup_ladder

        warmup_ladder(server.engine)
    ready_ms = (time.perf_counter() - t_start) * 1e3
    from apex_tpu_torch.observability import metrics as _telemetry

    _telemetry.gauge("worker.ready_ms").set(round(ready_ms, 3))
    _telemetry.event("worker.ready", role=args.role,
                     ready_ms=round(ready_ms, 3))
    print(f"{READY_PREFIX} role={args.role} addr={server.addr} "
          f"metrics={metrics_url} ready_ms={ready_ms:.0f}", flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        if args.export_port is not None:
            from apex_tpu_torch import observability as obs

            obs.shutdown()
    return 0


def _parse_ready(line: str):
    """``(addr, metrics_url, ready_ms)`` out of a READY line; unknown
    key=value parts are ignored."""
    addr = metrics = ready_ms = None
    for part in line.split():
        if part.startswith("addr="):
            addr = part[5:]
        elif part.startswith("metrics="):
            metrics = part[8:] or None
        elif part.startswith("ready_ms="):
            try:
                ready_ms = float(part[9:])
            except ValueError:
                pass
    return addr, metrics, ready_ms


class _ChildLines:
    """Lines of a child's unbuffered stdout, read with ``os.read`` after
    ``select`` says the pipe is readable.  (A buffered ``readline`` can
    pull two lines off the pipe at once; ``select`` then sees an empty
    pipe while the READY line waits in the buffer.)"""

    def __init__(self, proc):
        self.fd = proc.stdout.fileno()
        self.rest = b""
        self.eof = False

    def read(self, timeout: float) -> List[str]:
        """The complete lines that arrive within ``timeout`` seconds (at
        EOF, the unterminated rest too)."""
        if self.eof:
            return []
        r, _w, _x = select.select([self.fd], [], [], timeout)
        if not r:
            return []
        chunk = os.read(self.fd, 1 << 16)
        if not chunk:
            self.eof = True
            lines, self.rest = ([self.rest] if self.rest else []), b""
        else:
            *lines, self.rest = (self.rest + chunk).split(b"\n")
        return [ln.decode("utf-8", "replace").rstrip() for ln in lines]


def _attach_drain(proc, lines: _ChildLines) -> None:
    """Keep reading the child's output: a full pipe buffer would block
    the worker mid-decode.  The tail stays inspectable."""
    import collections
    import threading

    tail: collections.deque = collections.deque(maxlen=200)

    def _drain():
        while not lines.eof:
            tail.extend(lines.read(1.0))

    drain = threading.Thread(target=_drain, daemon=True,
                             name="apex-tpu-worker-drain")
    drain.start()
    proc.output_tail = tail
    # exits on the child's stdout EOF; shutdown_worker() joins it
    proc.drain_thread = drain


def _spawn_proc(role: str, extra_args, env):
    import subprocess
    import sys

    cmd = [sys.executable, "-m", "apex_tpu_torch.serving.cluster.worker",
           "--role", role] + list(extra_args or [])
    child_env = dict(os.environ)
    if env:
        child_env.update(env)
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, bufsize=0,
                            env=child_env)


def spawn_worker(role: str, *, extra_args: Optional[List[str]] = None,
                 timeout: float = 120.0, env: Optional[dict] = None):
    """Start ``python -m apex_tpu_torch.serving.cluster.worker`` as a
    child process and block until its READY line → ``(Popen, addr,
    metrics_url)``; ``proc.ready_ms`` holds the child's own READY time.
    The caller owns the process (:func:`shutdown_worker`)."""
    pend = PendingWorker(role, _spawn_proc(role, extra_args, env), timeout)
    while pend.poll() is None:
        time.sleep(0.02)
    if pend.addr is None:
        pend.proc.kill()
        pend.proc.wait()
        raise RuntimeError(
            f"{role} worker failed to become ready in {timeout:.0f}s:"
            f"\n{pend.error}")
    pend.proc.ready_ms = pend.ready_ms
    return pend.proc, pend.addr, pend.metrics


class PendingWorker:
    """One not-yet-READY worker child (:func:`spawn_worker_async`), the
    deferred-attach scale-up handle.  :meth:`poll` does not block;
    states: ``None`` (warming) → ``"ready"`` (``addr``/``metrics``/
    ``ready_ms`` set, stdout drain attached) or ``"dead"`` (``error``
    holds the output tail; reap with :func:`shutdown_worker`)."""

    def __init__(self, role: str, proc, timeout: float):
        self.role = role
        self.proc = proc
        self.addr: Optional[str] = None
        self.metrics: Optional[str] = None
        self.ready_ms: Optional[float] = None
        self.error: Optional[str] = None
        self.timeout_s = float(timeout)
        self._deadline = time.time() + timeout
        self._t0 = time.perf_counter()
        self._lines: List[str] = []
        self._reader = _ChildLines(proc)

    @property
    def age_s(self) -> float:
        """Seconds since spawn."""
        return time.perf_counter() - self._t0

    def poll(self) -> Optional[str]:
        """Advance the handshake without blocking: read what the child
        has written, return ``"ready"`` / ``"dead"`` / ``None``."""
        if self.addr is not None:
            return "ready"
        if self.error is not None:
            return "dead"
        for line in self._reader.read(0.0):
            self._lines.append(line)
            if line.startswith(READY_PREFIX):
                self.addr, self.metrics, self.ready_ms = _parse_ready(line)
                _attach_drain(self.proc, self._reader)
                return "ready"
        if self._reader.eof or self.proc.poll() is not None:
            if not self._reader.eof:
                return None                # read what it left first
            self.error = ("worker died before READY:\n"
                          + "\n".join(self._lines[-20:]))
            return "dead"
        if time.time() > self._deadline:
            self.proc.kill()
            self.error = (f"{self.role} worker not READY in "
                          f"{self.timeout_s:.0f}s:\n"
                          + "\n".join(self._lines[-20:]))
            return "dead"
        return None


def spawn_worker_async(role: str, *,
                       extra_args: Optional[List[str]] = None,
                       timeout: float = 120.0,
                       env: Optional[dict] = None) -> PendingWorker:
    """Start a worker child without waiting for its READY line: a
    :class:`PendingWorker` the caller polls."""
    return PendingWorker(role, _spawn_proc(role, extra_args, env), timeout)


def shutdown_worker(proc, timeout: float = 10.0) -> None:
    """Tear down a spawned child: terminate (then kill) the process and
    join its stdout drain thread.  Idempotent; safe on a child that
    already died."""
    import subprocess

    if proc.poll() is None:
        proc.terminate()
        try:
            proc.wait(timeout)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(timeout)
    drain = getattr(proc, "drain_thread", None)
    if drain is not None:
        drain.join(timeout)


if __name__ == "__main__":
    import sys

    sys.exit(main())
