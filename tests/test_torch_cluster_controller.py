"""The port's elastic pool controller and lossless drain against the JAX
package's, on the CPU at a tiny fp32 GPT (mirrors
``tests/test_serving_controller.py``).

- the ``PoolController`` hysteresis cases over a stub router, run on
  both packages' controllers with the same script;
- ``ServingEngine.drain()``: its records equal the JAX engine's after
  the same steps (prompt, first token, remaining budget, K/V to the raw
  codec's tolerance), and feeding them into a second engine through
  ``submit_prefilled`` continues token-identically;
- over real sockets (in-process workers, each serving in a thread): a
  mid-flight drain that keeps every token, the drain of a dead worker,
  and a request migrated twice.

Every worker and router is closed in a ``finally``; every wait has a
deadline.
"""

import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.models.config import TransformerConfig as JConfig
from apex_tpu.models.transformer_lm import init_gpt_params as j_init
from apex_tpu.serving import ServingEngine as JEngine
from apex_tpu.serving.cluster import PoolController as JController
from apex_tpu_torch.models.config import TransformerConfig as TConfig
from apex_tpu_torch.models.convert import params_from_numpy
from apex_tpu_torch.serving import ServingEngine as TEngine
from apex_tpu_torch.serving.cluster import PoolController as TController
from apex_tpu_torch.serving.cluster import Router, WorkerServer

CFG = dict(num_layers=2, hidden_size=64, num_attention_heads=4,
           vocab_size=128, max_position_embeddings=64,
           init_method_std=0.2)
CONTROLLERS = {"jax": JController, "torch": TController}

_MODEL = {}


def _model():
    if not _MODEL:
        jcfg = JConfig(compute_dtype=jnp.float32, remat=False, **CFG)
        tcfg = TConfig(compute_dtype=torch.float32, **CFG)
        jp = j_init(jax.random.PRNGKey(0), jcfg)
        tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
        _MODEL.update(jcfg=jcfg, jp=jp, tcfg=tcfg, tp=tp)
    return _MODEL


# ---------------------------------------------------------------------------
# stub-router policy units, both packages' controllers
# ---------------------------------------------------------------------------


class _StubWorker:
    def __init__(self, addr, pool):
        self.addr = addr
        self.pool = pool
        self.alive = True
        self.draining = False
        self.in_flight = {}
        self.stats = {"max_slots": 4, "active": 0,
                      "headroom_tokens": 64, "block_size": 8}


class _StubRouter:
    """The surface PoolController touches, with a scripted signal."""

    def __init__(self, hints):
        self.hints = list(hints)          # per-tick decode hints
        self._prefill = [_StubWorker("p0", "prefill")]
        self._decode = [_StubWorker("d0", "decode")]
        self.spawned = 0
        self.drained = []

    def _pool_list(self, pool):
        return self._prefill if pool == "prefill" else self._decode

    def scrape_stats(self):
        pass

    def autoscale_signal(self, fleet_summary=None):
        hint = self.hints.pop(0) if self.hints else 0
        return {"decode": {"hint": hint, "workers": len(self._decode)},
                "prefill": {"hint": 0, "workers": len(self._prefill)}}

    def add_worker(self, addr, pool):
        self._pool_list(pool).append(_StubWorker(addr, pool))

    def remove_worker(self, addr):
        for pool in (self._prefill, self._decode):
            for w in list(pool):
                if w.addr == addr:
                    pool.remove(w)

    def drain_worker(self, addr):
        self.drained.append(addr)
        for w in self._decode:
            if w.addr == addr:
                w.draining = True
        return {"migrated": 1, "requeued": 0, "completed": 0}


def _stub_ctrl(pkg, hints, **kw):
    router = _StubRouter(hints)
    kw.setdefault("min_decode", 1)
    kw.setdefault("max_decode", 3)
    kw.setdefault("scale_up_after", 2)
    kw.setdefault("scale_down_after", 2)
    kw.setdefault("cooldown_ticks", 1)
    kw.setdefault("tick_interval_s", 0.0)

    def spawn(pool):
        router.spawned += 1
        return object(), f"new{router.spawned}"

    return router, CONTROLLERS[pkg](router, spawn=spawn, **kw)


def _trace(pkg, hints, ticks, extra_decode=False, **kw):
    """(per-tick action names, spawned, drained, final stats subset) of
    one scripted run."""
    router, ctrl = _stub_ctrl(pkg, hints, **kw)
    if extra_decode:
        router.add_worker("d1", "decode")
    acts = [[a["action"] for a in ctrl.tick()["actions"]]
            for _ in range(ticks)]
    st = ctrl.stats()
    keep = ("pool_size", "pending_spawns", "draining", "actions_taken",
            "drained_requests", "up_streak", "down_streak", "cooldown")
    return acts, router.spawned, router.drained, {k: st[k] for k in keep}


SCRIPTS = {
    "flapping": (dict(hints=[1, 0, 1, 0, -1, 0, 1, 0, -1, 0], ticks=10),),
    "sustained_up_cooldown": (dict(hints=[1] * 6, ticks=4,
                                   cooldown_ticks=3),),
    "sustained_down_drains": (dict(hints=[0, 0, -1, -1], ticks=4,
                                   extra_decode=True),),
    "bound_at_max": (dict(hints=[1] * 6, ticks=6, max_decode=1),),
    "bound_at_min": (dict(hints=[-1] * 6, ticks=6),),
    "up_then_down": (dict(hints=[1, 1, 0, -1, -1, -1, -1, 0], ticks=8,
                          cooldown_ticks=0),),
}


class TestHysteresis:
    @pytest.mark.parametrize("script", sorted(SCRIPTS))
    def test_same_actions_as_jax(self, script):
        """One scripted signal through both packages' controllers: the
        same actions at the same ticks, the same spawns and drains, the
        same hysteresis state."""
        (kw,) = SCRIPTS[script]
        assert _trace("torch", **kw) == _trace("jax", **kw)

    def test_flapping_signal_never_acts(self):
        router, ctrl = _stub_ctrl("torch", [1, 0, 1, 0, -1, 0, 1, 0])
        for _ in range(8):
            ctrl.tick()
        assert ctrl.stats()["actions_taken"] == 0
        assert router.spawned == 0 and router.drained == []

    @pytest.mark.parametrize("pkg", sorted(CONTROLLERS))
    def test_chip_seconds_accrue(self, pkg):
        router, ctrl = _stub_ctrl(pkg, [0] * 3)
        ctrl.tick()
        time.sleep(0.05)
        ctrl.tick()
        assert ctrl.stats()["chip_seconds"] > 0

    @pytest.mark.parametrize("pkg", sorted(CONTROLLERS))
    def test_bad_knobs_raise(self, pkg):
        ctl = CONTROLLERS[pkg]
        with pytest.raises(ValueError, match="min pool"):
            ctl(_StubRouter([]), spawn=lambda p: None, min_decode=0)
        with pytest.raises(ValueError, match="below min"):
            ctl(_StubRouter([]), spawn=lambda p: None, min_decode=2,
                max_decode=1)

    @pytest.mark.parametrize("pkg", sorted(CONTROLLERS))
    def test_transient_spawn_failure_recorded_not_raised(self, pkg):
        router = _StubRouter([1] * 6)
        calls = []

        def spawn(pool):
            calls.append(pool)
            raise RuntimeError("worker failed to become ready")

        ctrl = CONTROLLERS[pkg](router, spawn=spawn, min_decode=1,
                                max_decode=3, scale_up_after=2,
                                cooldown_ticks=2, tick_interval_s=0.0)
        for _ in range(6):
            ctrl.tick()
        fails = [a for a in ctrl.stats()["actions"]
                 if a["action"] == "spawn_failed"]
        assert fails and "ready" in fails[0]["error"]
        assert len(calls) == 2

    @pytest.mark.parametrize("pkg", sorted(CONTROLLERS))
    def test_spawn_without_flags_or_hook_fails_loudly(self, pkg):
        ctrl = CONTROLLERS[pkg](_StubRouter([1, 1, 1]), min_decode=1,
                                max_decode=2, scale_up_after=2,
                                cooldown_ticks=0, tick_interval_s=0.0)
        ctrl.tick()
        with pytest.raises(ValueError, match="worker_flags"):
            ctrl.tick()


# ---------------------------------------------------------------------------
# engine.drain(): records against JAX's, and submit_prefilled continuation
# ---------------------------------------------------------------------------


ENGINE = dict(max_slots=2, max_len=48, block_size=4)


def _prompts(seed, n=3):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, 128, (4 + 3 * i,)) for i in range(n)]


@pytest.mark.parametrize("layout", ["paged", "contiguous"])
def test_drain_records_equal_jax(layout):
    """The same requests stepped the same number of times in both
    engines, then drained: the live records agree field for field (K/V
    within fp32 tolerance), the requeued requests are the same."""
    m = _model()
    je = JEngine(m["jp"], m["jcfg"], cache_layout=layout, **ENGINE)
    te = TEngine(m["tp"], m["tcfg"], cache_layout=layout, device="cpu",
                 **ENGINE)
    for p in _prompts(3):
        je.submit(p, max_new_tokens=12, slo_class="standard")
        te.submit(p, max_new_tokens=12, slo_class="standard")
    for _ in range(4):
        je.step()
        te.step()
    jl, jq = je.drain()
    tl, tq = te.drain()
    assert je.idle and te.idle
    assert len(tl) == len(jl) == 2
    assert [r.request_id for r in tq] == [r.request_id for r in jq]
    assert te.stats()["active"] == 0
    for j, t in zip(jl, tl):
        for key in ("engine_rid", "orig_prompt_len", "done_tokens",
                    "first_token", "max_new_tokens", "temperature",
                    "eos_token_id", "slo_class", "preemptions",
                    "decode_polls", "adapter_id"):
            assert t[key] == j[key], key
        np.testing.assert_array_equal(t["prompt"], j["prompt"])
        for key in ("k", "v"):
            np.testing.assert_allclose(t[key].numpy(), np.asarray(j[key]),
                                       rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("layout", ["paged", "contiguous"])
def test_drain_then_submit_prefilled_continues(layout):
    """engine.drain() → submit_prefilled into a second engine: the
    stitched tokens equal an undrained run's."""
    m = _model()
    prompts = _prompts(5)
    ref_e = TEngine(m["tp"], m["tcfg"], cache_layout=layout, device="cpu",
                    **ENGINE)
    ref = {tuple(r.prompt.tolist()): r.tokens.tolist()
           for r in ref_e.run([dict(prompt=p, max_new_tokens=14)
                               for p in prompts])}
    src = TEngine(m["tp"], m["tcfg"], cache_layout=layout, device="cpu",
                  **ENGINE)
    for p in prompts:
        src.submit(p, max_new_tokens=14)
    done = {}
    for _ in range(5):
        for r in src.step():
            done[tuple(r.prompt.tolist())] = r.tokens.tolist()
    live, requeue = src.drain()
    assert live and src.idle
    dst = TEngine(m["tp"], m["tcfg"], cache_layout=layout, device="cpu",
                  **ENGINE)
    prior = {}
    for rec in live:
        rid = dst.submit_prefilled(
            rec["prompt"], rec["k"], rec["v"], rec["first_token"],
            max_new_tokens=rec["max_new_tokens"],
            temperature=rec["temperature"])
        orig = tuple(rec["prompt"][:rec["orig_prompt_len"]].tolist())
        prior[rid] = (orig, rec["done_tokens"][:-1])
    for req in requeue:
        rid = dst.submit(req.prompt, max_new_tokens=req.max_new_tokens)
        prior[rid] = (tuple(req.prompt.tolist()), [])
    for r in dst.run():
        orig, head = prior[r.request_id]
        done[orig] = head + r.tokens.tolist()
    assert done == ref
    assert dst.stats()["prefill_calls"] == len(requeue)


# ---------------------------------------------------------------------------
# drain migration over real sockets
# ---------------------------------------------------------------------------


def _start(server):
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    return t


def _pools(n_decode=2, **decode_kw):
    m = _model()
    decode_kw.setdefault("max_len", 64)
    decode_kw.setdefault("cache_layout", "paged")
    decode_kw.setdefault("block_size", 4)
    decode_kw.setdefault("max_slots", 2)
    servers = [WorkerServer("prefill", m["tp"], m["tcfg"], max_len=64,
                            device="cpu")]
    servers += [WorkerServer("decode", m["tp"], m["tcfg"], device="cpu",
                             **decode_kw) for _ in range(n_decode)]
    for s in servers:
        _start(s)
    return servers


def _wait_until(pred, timeout=30.0, interval=0.002):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(interval)
    return pred()


def _refusing(addr):
    import socket

    host, port = addr.rsplit(":", 1)
    try:
        socket.create_connection((host, int(port)), timeout=0.2).close()
    except OSError:
        return True
    return False


class _MidflightGate:
    """Once an engine's step has admitted work, later steps hold (no
    completions, no state touched) until :meth:`release`, so its lanes
    stay mid-flight until the drain lands."""

    def __init__(self, *engines):
        self._open = threading.Event()
        self._orig = []
        for e in engines:
            orig = e.step

            def gated(e=e, orig=orig):
                if not self._open.is_set() and e._pool.n_active:
                    time.sleep(0.002)
                    return []
                return orig()

            self._orig.append((e, orig))
            e.step = gated

    def release(self):
        self._open.set()

    def restore(self):
        self._open.set()
        for e, orig in self._orig:
            e.step = orig


def _reference(prompts, max_new, **kw):
    m = _model()
    eng = TEngine(m["tp"], m["tcfg"], cache_layout="paged", block_size=4,
                  device="cpu", **kw)
    return {tuple(r.prompt.tolist()): r.tokens.tolist()
            for r in eng.run([dict(prompt=p, max_new_tokens=max_new)
                              for p in prompts])}


class TestDrainMigration:
    def test_mid_flight_drain_token_identical(self):
        """Drain a decode worker while it holds live lanes: every request
        completes on the survivor with the undrained tokens."""
        prompts = _prompts(11, n=4)
        ref = _reference(prompts, 24, max_slots=2, max_len=64)
        servers = _pools()
        victim = servers[1]
        gate = _MidflightGate(victim.engine)
        router = Router([servers[0].addr],
                        [servers[1].addr, servers[2].addr],
                        max_worker_queue=3, rpc_timeout=30)
        try:
            for p in prompts:
                router.submit(p, max_new_tokens=24)
            out = []
            victim_w = next(w for w in router._decode
                            if w.addr == victim.addr)
            assert _wait_until(lambda: (out.extend(router.step()),
                                        victim_w.in_flight)[1],
                               timeout=60, interval=0)
            assert _wait_until(lambda: victim.engine._pool.n_active >= 1,
                               timeout=60)
            router.scrape_stats()
            drained = router.drain_worker(victim.addr)
            assert drained["migrated"] >= 1
            out.extend(router.take_drain_completions())
            router.remove_worker(victim.addr)
            gate.restore()
            out.extend(router.run(max_wall_s=60))
            got = {tuple(r.prompt.tolist()): r.tokens.tolist()
                   for r in out}
            assert got == ref
            assert any(r.migrations > 0 for r in out)
            assert all(r.pool == servers[2].addr for r in out
                       if r.migrations)
        finally:
            gate.restore()
            router.close(shutdown_workers=True)
            for s in servers:
                s.stop()

    def test_double_migration_keeps_all_tokens(self):
        """A request drained twice (A→B, B→C) stitches all three legs."""
        prompt = _prompts(17, n=1)[0]
        ref = _reference([prompt], 30, max_slots=2, max_len=64)
        servers = _pools(n_decode=3)
        gate = _MidflightGate(*(s.engine for s in servers[1:]))
        router = Router([servers[0].addr], [s.addr for s in servers[1:]],
                        max_worker_queue=3, rpc_timeout=30)
        try:
            router.submit(prompt, max_new_tokens=30)
            out = []
            engines = {s.addr: s.engine for s in servers[1:]}

            def holder():
                return next((w for w in router._decode if w.in_flight),
                            None)

            for _ in range(2):
                assert _wait_until(lambda: (out.extend(router.step()),
                                            holder() is not None)[1],
                                   timeout=60, interval=0)
                w = holder()
                assert _wait_until(
                    lambda: engines[w.addr]._pool.n_active >= 1,
                    timeout=60)
                drained = router.drain_worker(w.addr)
                out.extend(router.take_drain_completions())
                assert drained["migrated"] == 1
                router.remove_worker(w.addr)
            gate.release()
            out.extend(router.run(max_wall_s=60))
            (resp,) = out
            assert resp.migrations == 2
            assert {tuple(resp.prompt.tolist()): resp.tokens.tolist()} \
                == ref
        finally:
            gate.restore()
            router.close(shutdown_workers=True)
            for s in servers:
                s.stop()

    def test_drain_dead_worker_requeues_everything(self):
        """A worker dead at the drain RPC takes the death path: all
        requeue, none migrate, none are lost."""
        prompts = _prompts(13, n=4)
        servers = _pools()
        victim = servers[1]
        router = Router([servers[0].addr],
                        [servers[1].addr, servers[2].addr],
                        max_worker_queue=3, rpc_timeout=30)
        try:
            for p in prompts:
                router.submit(p, max_new_tokens=6)
            out = []
            victim_w = next(w for w in router._decode
                            if w.addr == victim.addr)
            assert _wait_until(lambda: (out.extend(router.step()),
                                        victim_w.in_flight)[1],
                               timeout=60, interval=0)
            victim.stop()
            assert _wait_until(lambda: _refusing(victim.addr))
            drained = router.drain_worker(victim.addr)
            assert drained["migrated"] == 0
            assert drained["requeued"] >= 1
            router.remove_worker(victim.addr)
            out.extend(router.run(max_wall_s=60))
            assert len(out) == len(prompts)
            assert (_reference(prompts, 6, max_slots=2, max_len=64)
                    == {tuple(r.prompt.tolist()): r.tokens.tolist()
                        for r in out})
        finally:
            router.close(shutdown_workers=True)
            for s in servers:
                s.stop()

    def test_add_worker_role_mismatch_refused(self):
        servers = _pools(n_decode=1)
        router = Router([servers[0].addr], [servers[1].addr],
                        rpc_timeout=30)
        try:
            with pytest.raises(ValueError, match="role"):
                router.add_worker(servers[0].addr, "decode")
        finally:
            router.close(shutdown_workers=True)
            for s in servers:
                s.stop()
