"""The port's cluster serving tier against the JAX package's, on the CPU at
a tiny fp32 GPT (mirrors ``tests/test_serving_cluster.py`` and the
protocol half of ``tests/test_serving_handoff.py``).

- ``protocol.send_msg`` frames are byte for byte JAX's (over a
  ``socketpair``), and each package reads the other's;
- the worker RPC surface: ``hello`` equal to JAX's, a prefill reply
  equal to JAX's (first token, handoff header, K/V within fp32
  tolerance), the decode RPC pair, the ``launch_counts`` stats key;
- the routing policy (class priority, queue caps, the pool-stall latch,
  autoscale hints) on both packages' routers with one script;
- over real sockets (workers serving in threads): greedy tokens equal to
  the port's single engine and to the JAX cluster on the same (converted)
  parameters; a killed decode worker requeues and loses nothing; a
  stalled pool latches ``/healthz``;
- across packages: a JAX prefill worker handing off to a port decode
  worker and the reverse, behind either package's router, give the
  single-package tokens;
- one spawned two-process cluster (``--device cpu``).

Every socket has a timeout, every worker is stopped in a ``finally``.
"""

import json
import os
import socket
import threading
import time
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.models.config import TransformerConfig as JConfig
from apex_tpu.models.transformer_lm import init_gpt_params as j_init
from apex_tpu.serving.cluster import Router as JRouter
from apex_tpu.serving.cluster import WorkerServer as JWorker
from apex_tpu.serving.cluster import protocol as jproto
from apex_tpu_torch import observability as tobs
from apex_tpu_torch.models.config import TransformerConfig as TConfig
from apex_tpu_torch.models.convert import params_from_numpy
from apex_tpu_torch.models.transformer_lm import init_gpt_params as t_init
from apex_tpu_torch.serving import ServingEngine as TEngine
from apex_tpu_torch.serving.cluster import Router as TRouter
from apex_tpu_torch.serving.cluster import RouterBusy as TRouterBusy
from apex_tpu_torch.serving.cluster import WorkerServer as TWorker
from apex_tpu_torch.serving.cluster import protocol as tproto
from apex_tpu_torch.serving.cluster.handoff import decode_kv

CFG = dict(num_layers=2, hidden_size=64, num_attention_heads=4,
           vocab_size=128, max_position_embeddings=64,
           init_method_std=0.2)
ROUTERS = {"jax": JRouter, "torch": TRouter}
DECODE = dict(max_len=32, cache_layout="paged", block_size=4, max_slots=2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_MODEL = {}


def _model():
    if not _MODEL:
        jcfg = JConfig(compute_dtype=jnp.float32, remat=False, **CFG)
        tcfg = TConfig(compute_dtype=torch.float32, **CFG)
        jp = j_init(jax.random.PRNGKey(0), jcfg)
        tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
        _MODEL.update(jcfg=jcfg, jp=jp, tcfg=tcfg, tp=tp)
    return _MODEL


def _worker(pkg, role, **kw):
    m = _model()
    if pkg == "jax":
        return JWorker(role, m["jp"], m["jcfg"], **kw)
    return TWorker(role, m["tp"], m["tcfg"], device="cpu", **kw)


def _start(*servers):
    for s in servers:
        threading.Thread(target=s.serve_forever, daemon=True).start()
    return servers


def _prompts(seed, n=5):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, 128, (3 + 2 * i,)) for i in range(n)]


_REFS = {}


def _reference(seed, max_new=4, n=5):
    """The port's single paged engine on the same prompts (cached)."""
    key = (seed, max_new, n)
    if key not in _REFS:
        m = _model()
        eng = TEngine(m["tp"], m["tcfg"], device="cpu", **DECODE)
        _REFS[key] = {tuple(r.prompt.tolist()): r.tokens.tolist()
                      for r in eng.run([dict(prompt=p, max_new_tokens=max_new)
                                        for p in _prompts(seed, n)])}
    return _REFS[key]


def _tokens(out):
    return {tuple(r.prompt.tolist()): r.tokens.tolist() for r in out}


# ---------------------------------------------------------------------------
# framing
# ---------------------------------------------------------------------------


FRAMES = {
    "control": ({"op": "poll"}, []),
    "nested": ({"op": "decode", "rid": 7, "prompt": [1, 2, 3],
                "kv": {"shape": [2, 3, 4, 16], "wire_dtype": "raw"},
                "eos_token_id": None, "temperature": 0.5}, [b"\x01" * 17]),
    "blobs": ({"op": "x", "v": [1, 2]}, [b"\x00" * 1000, b"xyz", b""]),
    "unicode": ({"op": "hello", "note": "héllo ✓"}, [bytearray(b"ab")]),
}


def _sent(proto, header, blobs):
    a, b = socket.socketpair()
    a.settimeout(5)
    b.settimeout(5)
    try:
        n = proto.send_msg(a, header, blobs)
        a.close()
        raw = b""
        while True:
            chunk = b.recv(1 << 16)
            if not chunk:
                break
            raw += chunk
        return n, raw
    finally:
        b.close()


class TestProtocol:
    @pytest.mark.parametrize("frame", sorted(FRAMES))
    def test_send_msg_bytes_equal_jax(self, frame):
        header, blobs = FRAMES[frame]
        assert _sent(tproto, header, blobs) == _sent(jproto, header, blobs)

    @pytest.mark.parametrize("frame", sorted(FRAMES))
    @pytest.mark.parametrize("direction", ["jax_to_torch", "torch_to_jax"])
    def test_each_reads_the_other(self, frame, direction):
        header, blobs = FRAMES[frame]
        tx, rx = ((jproto, tproto) if direction == "jax_to_torch"
                  else (tproto, jproto))
        a, b = socket.socketpair()
        a.settimeout(5)
        b.settimeout(5)
        try:
            tx.send_msg(a, header, blobs)
            got_h, got_b = rx.recv_msg(b)
            assert got_h == header
            assert got_b == [bytes(x) for x in blobs]
        finally:
            a.close()
            b.close()

    def test_clean_close_is_none_midframe_raises(self):
        a, b = socket.socketpair()
        b.settimeout(5)
        a.close()
        assert tproto.recv_msg(b) is None
        b.close()
        a, b = socket.socketpair()
        b.settimeout(5)
        try:
            a.sendall(b"\x00\x00\x00\xff")
            a.sendall(b"{")
            a.close()
            with pytest.raises(tproto.ProtocolError, match="mid-frame"):
                tproto.recv_msg(b)
        finally:
            b.close()

    def test_bounds_and_bad_headers(self):
        a, b = socket.socketpair()
        b.settimeout(5)
        try:
            a.sendall((tproto.MAX_HEADER + 1).to_bytes(4, "big"))
            with pytest.raises(tproto.ProtocolError, match="MAX_HEADER"):
                tproto.recv_msg(b)
        finally:
            a.close()
            b.close()
        a, b = socket.socketpair()
        b.settimeout(5)
        try:
            a.sendall(len(b"[1]").to_bytes(4, "big") + b"[1]")
            with pytest.raises(tproto.ProtocolError, match="JSON object"):
                tproto.recv_msg(b)
        finally:
            a.close()
            b.close()
        with pytest.raises(tproto.ProtocolError, match="dict"):
            tproto.send_msg(None, [1], [])


# ---------------------------------------------------------------------------
# the worker RPC surface
# ---------------------------------------------------------------------------


class TestWorkerRPC:
    @pytest.mark.parametrize("role", ["prefill", "decode"])
    def test_hello_equals_jax(self, role):
        kw = dict(max_len=32) if role == "prefill" else DECODE
        tw, jw = _worker("torch", role, **kw), _worker("jax", role, **kw)
        try:
            assert tw.handle({"op": "hello"}, []) == \
                jw.handle({"op": "hello"}, [])
        finally:
            tw.close()
            jw.close()

    def test_hello_stats_and_bad_ops(self):
        w = _worker("torch", "prefill", max_len=32)
        try:
            reply, _ = w.handle({"op": "hello"}, [])
            assert reply["ok"] and reply["role"] == "prefill"
            reply, _ = w.handle({"op": "stats"}, [])
            st = reply["stats"]
            assert st["scratch_layout"] == "paged"
            assert "fused_sample" in st["launch_counts"]
            reply, _ = w.handle({"op": "poll"}, [])
            assert not reply["ok"]
            reply, _ = w.handle({"op": "nope"}, [])
            assert not reply["ok"] and "unknown op" in reply["error"]
            reply, _ = w.handle({"op": "prefill", "prompt": []}, [])
            assert not reply["ok"]
            reply, _ = w.handle({"op": "decode", "prompt": [1]}, [])
            assert not reply["ok"] and "prefill worker" in reply["error"]
        finally:
            w.close()

    def test_worker_needs_a_device(self):
        if torch.cuda.is_available():
            pytest.skip("a card is present")
        m = _model()
        with pytest.raises(RuntimeError, match="CUDA"):
            TWorker("prefill", m["tp"], m["tcfg"], max_len=32)

    @pytest.mark.parametrize("scratch", ["paged", "contiguous"])
    @pytest.mark.parametrize("wire", ["raw", "bf16", "int8"])
    def test_prefill_reply_equals_jax(self, scratch, wire):
        """One prefill RPC in each package: the same first token, the
        same handoff header (dtype names included) and byte count, K/V
        within fp32 tolerance after decoding."""
        tw = _worker("torch", "prefill", max_len=32, scratch_layout=scratch,
                     block_size=4)
        jw = _worker("jax", "prefill", max_len=32, scratch_layout=scratch,
                     block_size=4)
        try:
            rpc = {"op": "prefill", "prompt": list(range(3, 14)),
                   "temperature": 0.0, "wire_dtype": wire}
            tr, tb = tw.handle(rpc, [])
            jr, jb = jw.handle(rpc, [])
            assert tr["ok"] and jr["ok"]
            for key in ("first_token", "n", "handoff_bytes",
                        "prefill_pages", "kv"):
                assert tr[key] == jr[key], key
            tk, tv = decode_kv(tr["kv"], tb)
            jk, jv = decode_kv(jr["kv"], jb)
            tol = 1e-5 if wire == "raw" else 2e-2
            np.testing.assert_allclose(tk.float().numpy(),
                                       jk.float().numpy(), atol=tol,
                                       rtol=tol)
            np.testing.assert_allclose(tv.float().numpy(),
                                       jv.float().numpy(), atol=tol,
                                       rtol=tol)
            st = tw.handle({"op": "stats"}, [])[0]["stats"]
            assert st["prefill_calls"] == 1
        finally:
            tw.close()
            jw.close()

    def test_prefill_decode_rpc_pair(self):
        pf = _worker("torch", "prefill", max_len=32)
        dc = _worker("torch", "decode", max_len=32, max_slots=1)
        try:
            prompt = list(range(1, 8))
            reply, blobs = pf.handle({"op": "prefill", "prompt": prompt,
                                      "temperature": 0.0}, [])
            assert reply["ok"] and reply["n"] == 7
            assert reply["handoff_bytes"] == sum(len(b) for b in blobs)
            ack, _ = dc.handle({"op": "decode", "rid": 42, "prompt": prompt,
                                "first_token": reply["first_token"],
                                "kv": reply["kv"], "max_new_tokens": 4},
                               blobs)
            assert ack["ok"] and ack["accepted"]
            for _ in range(30):
                if dc.engine.idle:
                    break
                dc._pump()
            poll, _ = dc.handle({"op": "poll"}, [])
            (resp,) = poll["responses"]
            assert resp["rid"] == 42 and len(resp["tokens"]) == 4
            assert resp["tokens"][0] == reply["first_token"]
            assert poll["stats"]["queued"] == 0
            assert "launch_counts" in poll["stats"]
        finally:
            pf.close()
            dc.close()

    def test_adapter_prefill_continues_like_the_engine(self):
        """An adapter request through the worker pair gives the tokens of
        a single engine serving the same adapter suite."""
        from apex_tpu_torch.serving.adapter_pool import AdapterPool
        from apex_tpu_torch.serving.cluster.worker import build_adapter_suite

        m = _model()
        suite = build_adapter_suite(m["tcfg"], 2, seed=0, device="cpu")
        pool = AdapterPool(m["tcfg"])
        for aid, ad in suite.items():
            pool.register(aid, ad)
        eng = TEngine(m["tp"], m["tcfg"], adapter_pool=pool, device="cpu",
                      max_len=32, max_slots=2)
        prompt = list(range(5, 14))
        (ref,) = eng.run([dict(prompt=prompt, max_new_tokens=5,
                               adapter_id=2)])
        pf = _worker("torch", "prefill", max_len=32, adapters=2)
        dc = _worker("torch", "decode", max_len=32, max_slots=2, adapters=2)
        try:
            reply, blobs = pf.handle({"op": "prefill", "prompt": prompt,
                                      "adapter_id": 2}, [])
            assert reply["ok"] and not reply["prefill_pages"]
            ack, _ = dc.handle({"op": "decode", "rid": 1, "prompt": prompt,
                                "first_token": reply["first_token"],
                                "kv": reply["kv"], "max_new_tokens": 5,
                                "adapter_id": 2}, blobs)
            assert ack["ok"]
            while not dc.engine.idle:
                dc._pump()
            (resp,) = dc.handle({"op": "poll"}, [])[0]["responses"]
            assert resp["tokens"] == ref.tokens.tolist()
            bad, _ = pf.handle({"op": "prefill", "prompt": prompt,
                                "adapter_id": 3}, [])
            assert not bad["ok"] and "suite" in bad["error"]
        finally:
            pf.close()
            dc.close()


# ---------------------------------------------------------------------------
# routing policy units, both packages' routers
# ---------------------------------------------------------------------------


def _bare_router(pkg, **kw):
    """A Router with no sockets: the policy state only."""
    from apex_tpu.serving.slo import resolve_slo_targets as j_slo
    from apex_tpu_torch.serving.slo import resolve_slo_targets as t_slo

    r = object.__new__(ROUTERS[pkg])
    r._prefill, r._decode = [], []
    r._slo_targets = (j_slo if pkg == "jax" else t_slo)(None)
    r._caps = kw.get("queue_caps", {})
    r._priority = kw.get("class_priority",
                         ("interactive", "standard", "default", "batch"))
    r.wire_dtype = "raw"
    r._max_worker_queue = 4
    r._queues = {}
    r._next_rid = 0
    r._pf_rr = 0
    r._last_decode_pick = None
    r._requeued_total = 0
    r._completed_total = 0
    r._drain_completed = []
    return r


class _W:
    def __init__(self, addr="w0", **stats):
        self.alive = True
        self.draining = False
        self.addr = addr
        self.stats = dict(stats)
        self.in_flight = {}
        self.dispatched_since_poll = 0


class TestRoutingPolicy:
    @pytest.mark.parametrize("pkg", sorted(ROUTERS))
    def test_class_priority_order(self, pkg):
        r = _bare_router(pkg)
        for cls in ("batch", "bulk-custom", "standard", "interactive"):
            r.submit([1, 2], slo_class=cls)
        order = []
        while True:
            cls = r._next_class()
            if cls is None:
                break
            order.append(cls)
            r._queues[cls].popleft()
        assert order == ["interactive", "standard", "bulk-custom", "batch"]

    def test_queue_caps_shed_load(self):
        r = _bare_router("torch", queue_caps={"batch": 2})
        r.submit([1], slo_class="batch")
        r.submit([1], slo_class="batch")
        with pytest.raises(TRouterBusy, match="cap"):
            r.submit([1], slo_class="batch")
        r.submit([1], slo_class="interactive")
        with pytest.raises(ValueError):
            r.submit([], slo_class="standard")

    @pytest.mark.parametrize("pkg", sorted(ROUTERS))
    def test_pick_decode_affinity_then_headroom(self, pkg):
        """Adapter residency outranks prefix affinity outranks headroom,
        and a saturated worker is skipped."""
        r = _bare_router(pkg)
        r.submit(list(range(16)), adapter_id=3)
        pend = r._queues["default"][0]
        roomy = _W("roomy", headroom_tokens=512, block_size=4, queued=0)
        holder = _W("holder", headroom_tokens=8, block_size=4, queued=0,
                    adapter_pool={"resident_ids": [3]})
        full = _W("full", headroom_tokens=4096, block_size=4, queued=9)
        r._decode = [roomy, holder, full]
        assert r._pick_decode(pend).addr == "holder"
        holder.stats["adapter_pool"] = {"resident_ids": []}
        assert r._pick_decode(pend).addr == "roomy"
        from apex_tpu_torch.serving.cluster.router import _prompt_digests

        chain = _prompt_digests(pend.prompt, 4, 0)
        holder.stats["digest_inventory"] = {"block_size": 4,
                                            "hbm": chain[:2]}
        assert r._pick_decode(pend).addr == "holder"

    @pytest.mark.parametrize("pkg", sorted(ROUTERS))
    def test_autoscale_hints_from_fleet_summary(self, pkg):
        r = _bare_router(pkg)
        r._decode = [_W(free_block_headroom=5, max_slots=4, active=1)]
        r._prefill = [_W()]
        sig = r.autoscale_signal()
        assert sig["decode"]["hint"] == 0
        fleet = {"sketches": {
            "serving.ttft_ms{slo_class=interactive}": {"p95": 800.0},
            "serving.tpot_ms{slo_class=interactive}": {"p95": 90.0},
        }}
        sig = r.autoscale_signal(fleet)
        assert sig["prefill"]["hint"] == 1
        assert sig["decode"]["hint"] == 1
        assert set(sig["slo_violations"]) == {"interactive:ttft",
                                              "interactive:tpot"}

    @pytest.mark.parametrize("case", ["empty", "draining", "idle_pair",
                                      "host_tier"])
    def test_autoscale_signal_equals_jax(self, case):
        """The same worker snapshots through both routers' signal."""
        def workers():
            if case == "empty":
                return [], [_W()]
            if case == "draining":
                w = _W(headroom_tokens=64, max_slots=4, active=0)
                w.draining = True
                return [w], [_W()]
            if case == "idle_pair":
                return ([_W("a", headroom_tokens=64, max_slots=4,
                            active=0),
                         _W("b", headroom_tokens=64, max_slots=4,
                            active=0)], [_W()])
            return ([_W(headroom_tokens=0, max_slots=4, active=4,
                        host_tier={"free_bytes": 1 << 20})], [_W()])

        sigs = []
        for pkg in ("jax", "torch"):
            r = _bare_router(pkg)
            r._decode, r._prefill = workers()
            sigs.append(r.autoscale_signal())
        assert sigs[0] == sigs[1]

    def test_pool_stall_detector_latch(self):
        from apex_tpu_torch.observability.detectors import (
            PoolStallDetector)

        det = PoolStallDetector(threshold=3)
        assert det.feed("decode", False) is None
        assert det.feed("decode", False) is None
        a = det.feed("decode", False)
        assert a is not None and a.kind == "pool_stall"
        assert det.stalled("decode")
        assert det.feed("decode", False) is None
        det.feed("decode", True)
        det.feed("decode", True)
        assert det.stalled("decode")
        det.feed("decode", True)
        assert not det.stalled("decode")
        assert det.feed("prefill", False) is None


# ---------------------------------------------------------------------------
# integration over real sockets
# ---------------------------------------------------------------------------


def _cluster(pf_pkg, dc_pkgs, **decode_kw):
    kw = dict(DECODE, **decode_kw)
    servers = [_worker(pf_pkg, "prefill", max_len=32)]
    servers += [_worker(p, "decode", **kw) for p in dc_pkgs]
    return _start(*servers)


def _stop(router, servers):
    try:
        router.close(shutdown_workers=True)
    finally:
        for s in servers:
            s.stop()


class TestClusterIntegration:
    def test_token_identity_and_telemetry(self):
        """Routed greedy outputs equal the port's single engine, and the
        cluster counters carry the routing evidence."""
        ref = _reference(1)
        reg = tobs.configure()
        prompts = _prompts(1)
        classes = ["interactive", "standard", "batch", "default",
                   "interactive"]
        servers = _cluster("torch", ["torch"])
        router = TRouter([servers[0].addr], [servers[1].addr],
                         rpc_timeout=30)
        try:
            for p, c in zip(prompts, classes):
                router.submit(p, max_new_tokens=4, slo_class=c)
            out = router.run(max_wall_s=60)
            assert _tokens(out) == ref
            for r in out:
                assert r.handoff_bytes > 0
                assert r.pool == servers[1].addr
                assert 0 <= r.queue_wait_ms <= r.ttft_ms <= r.e2e_ms
            counters = [r for r in reg.snapshot() if r["kind"] == "counter"]
            assert sum(r["value"] for r in counters
                       if r["name"] == "cluster.route") == 5
            assert sum(r["value"] for r in counters
                       if r["name"] == "cluster.handoff_bytes") == \
                sum(r.handoff_bytes for r in out)
            assert reg.counter("serving.kv_injected").value == 5
            assert reg.counter("serving.prefill_calls").value == 0
        finally:
            _stop(router, servers)
            tobs.shutdown()

    def test_equals_the_jax_cluster(self):
        """The JAX cluster on the same parameters gives the port's
        tokens."""
        outs = {}
        for pkg in ("jax", "torch"):
            servers = _cluster(pkg, [pkg])
            router = ROUTERS[pkg]([servers[0].addr], [servers[1].addr],
                                  rpc_timeout=30)
            try:
                for p in _prompts(2):
                    router.submit(p, max_new_tokens=6)
                outs[pkg] = _tokens(router.run(max_wall_s=60))
            finally:
                _stop(router, servers)
        assert outs["torch"] == outs["jax"] == _reference(2, max_new=6)

    @pytest.mark.parametrize("router_pkg", sorted(ROUTERS))
    @pytest.mark.parametrize("mix", ["jax_prefill_torch_decode",
                                     "torch_prefill_jax_decode"])
    def test_across_packages(self, mix, router_pkg):
        """A handoff across packages over the raw wire: the greedy tokens
        equal the single-package runs."""
        pf, dc = mix.split("_prefill_")[0], mix.split("_")[2]
        servers = _cluster(pf, [dc])
        router = ROUTERS[router_pkg]([servers[0].addr], [servers[1].addr],
                                     rpc_timeout=30)
        try:
            for p in _prompts(4):
                router.submit(p, max_new_tokens=5)
            out = router.run(max_wall_s=60)
            assert _tokens(out) == _reference(4, max_new=5)
        finally:
            _stop(router, servers)

    def test_killed_decode_worker_requeues_not_loses(self):
        """Kill one of two decode workers mid-flight: every request still
        completes on the survivor with the single engine's tokens."""
        prompts = _prompts(6, n=5)
        ref = _reference(6, max_new=6)
        servers = _cluster("torch", ["torch", "torch"], max_slots=1)
        victim = servers[2]
        router = TRouter([servers[0].addr],
                         [servers[1].addr, servers[2].addr],
                         max_worker_queue=2, rpc_timeout=30)
        try:
            for p in prompts:
                router.submit(p, max_new_tokens=6)
            out = []
            deadline = time.time() + 60
            victim_w = next(w for w in router._decode
                            if w.addr == victim.addr)
            while time.time() < deadline and not victim_w.in_flight:
                out.extend(router.step())
            assert victim_w.in_flight, "victim never got work"
            victim.stop()
            time.sleep(0.1)
            out.extend(router.run(max_wall_s=60))
            assert _tokens(out) == ref
            assert router.stats()["requeued"] >= 1
            assert any(r.requeues > 0 for r in out)
            assert all(r.pool == servers[1].addr for r in out if r.requeues)
        finally:
            _stop(router, servers)

    def test_pool_stall_latches_healthz(self):
        """All decode workers dead with queued work: the detector latches
        and the router process's /healthz answers 503; the request is
        requeued, not lost."""
        reg = tobs.configure(export_port=0)
        servers = _cluster("torch", ["torch"])
        router = TRouter([servers[0].addr], [servers[1].addr],
                         rpc_timeout=30)
        try:
            url = reg.exporter.url
            assert json.loads(urllib.request.urlopen(
                url + "/healthz", timeout=5).read())["status"] == "ok"
            servers[1].stop()
            time.sleep(0.1)
            router.submit([1, 2, 3], max_new_tokens=2)
            for _ in range(5):
                router.step()
            assert reg.detectors.pool.stalled("decode")
            with pytest.raises(urllib.error.HTTPError) as ei:
                urllib.request.urlopen(url + "/healthz", timeout=5)
            assert ei.value.code == 503
            assert "pool_stall" in json.loads(ei.value.read())["kinds"]
            assert router.stats()["queued"] == 1
        finally:
            _stop(router, servers)
            tobs.shutdown()

    def test_scrape_stats_covers_prefill_pool(self):
        servers = _cluster("torch", ["torch"])
        router = TRouter([servers[0].addr], [servers[1].addr],
                         rpc_timeout=30)
        try:
            router.scrape_stats()
            st = router.stats()
            assert st["pools"]["decode"][0]["stats"]["max_slots"] == 2
            assert router._prefill[0].stats["prefill_calls"] == 0
            assert "launch_counts" in router._prefill[0].stats
        finally:
            _stop(router, servers)


class TestTwoProcess:
    def test_two_process_token_identity(self):
        """Two spawned worker processes on ``--device cpu`` behind a
        router here: the greedy tokens of a single engine built from the
        same seed."""
        from apex_tpu_torch.serving.cluster.worker import (
            shutdown_worker, spawn_worker_async)

        cfg = TConfig(compute_dtype=torch.float32, num_layers=2,
                      hidden_size=64, num_attention_heads=4, vocab_size=128,
                      max_position_embeddings=64)
        params = t_init(cfg, torch.Generator().manual_seed(3), "cpu")
        prompts = _prompts(3, n=3)
        eng = TEngine(params, cfg, device="cpu", **DECODE)
        ref = _tokens(eng.run([dict(prompt=p, max_new_tokens=4)
                               for p in prompts]))
        flags = ["--device", "cpu", "--seed", "3", "--hidden", "64",
                 "--heads", "4", "--vocab", "128", "--max-pos", "64",
                 "--max-len", "32"]
        env = {"PYTHONPATH": REPO, "OMP_NUM_THREADS": "1"}
        pend = [spawn_worker_async("prefill", extra_args=flags, env=env,
                                   timeout=60),
                spawn_worker_async("decode", env=env, timeout=60,
                                   extra_args=flags + [
                                       "--max-slots", "2", "--cache-layout",
                                       "paged", "--block-size", "4"])]
        router = None
        try:
            deadline = time.time() + 60
            while (time.time() < deadline
                   and any(p.poll() is None for p in pend)):
                time.sleep(0.05)
            assert all(p.poll() == "ready" for p in pend), \
                [p.error for p in pend]
            assert all(p.ready_ms > 0 for p in pend)
            router = TRouter([pend[0].addr], [pend[1].addr], rpc_timeout=30)
            for p in prompts:
                router.submit(p, max_new_tokens=4)
            assert _tokens(router.run(max_wall_s=60)) == ref
            st = router._decode[0].stats
            assert st["launch_counts"]["fused_decode_layer"] == 0  # CPU
        finally:
            if router is not None:
                router.close(shutdown_workers=True)
            for p in pend:
                shutdown_worker(p.proc)
            assert all(p.proc.poll() is not None for p in pend)
