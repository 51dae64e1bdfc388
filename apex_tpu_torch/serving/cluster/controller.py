"""Elastic pool controller (``apex_tpu/serving/cluster/controller.py``):
the loop that ACTS on :meth:`~apex_tpu_torch.serving.cluster.router.
Router.autoscale_signal`.

- **poll** — each :meth:`PoolController.tick` refreshes worker stats,
  optionally loads a *windowed* fleet summary (recent percentiles, not
  lifetime totals), and reads the fused signal;
- **hysteresis** — a hint must persist for ``scale_up_after`` /
  ``scale_down_after`` consecutive ticks before anything happens, and
  every action opens a ``cooldown_ticks`` refractory window, so a
  signal flapping between +1 and 0 never oscillates the fleet;
- **scale-up** — deferred attach by default: launch a new pool member
  (:func:`~apex_tpu_torch.serving.cluster.worker.spawn_worker_async`
  with the controller's per-role CLI flags, a real OS process) and
  return from the tick at once; later ticks poll the child's READY line
  without blocking and :meth:`Router.add_worker` it the tick it reports
  in.  A worker that dies before READY is reaped without ever attaching.
  ``defer_spawn=False`` restores the blocking spawn, and a ``spawn=``
  hook is always synchronous (in-process servers);
- **scale-down** — LOSSLESS drain: pick the least-loaded member, stop
  admitting onto it, migrate every in-flight request's KV to a survivor
  through the bit-exact raw handoff wire (:meth:`Router.drain_worker`),
  then reap the process;
- **accounting** — ``controller.pool_size{pool=}`` /
  ``controller.draining`` gauges, ``controller.actions{action=,pool=}``
  / ``controller.drained_requests`` counters, and the
  ``controller.chip_seconds`` gauge (the integral of pool size over
  wall time).

Threading: the controller has NO threads of its own.  It is stepped
from the SAME loop that steps the router (``Router.run_trace(...,
on_step=controller.maybe_tick)`` or an explicit tick loop, which should
collect ``router.take_drain_completions()`` once after it exits), so
every mutable field below is confined to that loop.  The worker
processes it spawns carry their own stdout drain threads, reaped by
:func:`~apex_tpu_torch.serving.cluster.worker.shutdown_worker`.
"""

from __future__ import annotations

import json
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from apex_tpu_torch.observability import metrics as _telemetry

__all__ = ["PoolController"]

_POOLS = ("prefill", "decode")


class PoolController:
    """Drive a :class:`~apex_tpu_torch.serving.cluster.router.Router`'s pool
    sizes from its own ``autoscale_signal`` (see module doc).

    ``spawn(role) -> (handle, addr)`` creates one new pool member; the
    default spawns a real worker process from ``worker_flags[role]``
    (the CLI flag list `python -m ...cluster.worker` takes).  Handles
    are reaped with :func:`~apex_tpu_torch.serving.cluster.
    worker.shutdown_worker` at scale-down / :meth:`close` — a handle without
    a ``poll`` method (an in-process test server) is reaped via its
    ``stop``/``close`` if present.

    Scale-up is deferred-attach unless a ``spawn=`` hook is given or
    ``defer_spawn=False`` (module doc): ``spawn_async(role)`` — default
    :func:`~apex_tpu_torch.serving.cluster.worker.spawn_worker_async`
    over
    ``worker_flags`` — must return a handle with a non-blocking
    ``poll() -> None|"ready"|"dead"`` plus ``addr``/``proc``/``error``
    fields; pending handles are ticked each cycle and count toward
    pool size (so a warming member is never double-spawned) and
    chip-seconds (its chip burns from launch, not from attach).

    ``min_/max_`` bound each pool; ``scale_up_after`` /
    ``scale_down_after`` are the hysteresis streak lengths (down
    defaults slower than up: adding capacity late costs latency,
    removing it late only costs chips); ``cooldown_ticks`` is the
    refractory window after any action.  ``tick_interval_s`` rate-limits
    :meth:`maybe_tick` so it can ride a hot router loop.

    ``fleet_summary`` sharpens the signal with windowed fleet evidence:
    a callable returning the ``aggregate_telemetry --json`` dict, or a
    path to that artifact (re-read every tick; missing/torn files are
    skipped — live signals alone still work).
    """

    def __init__(self, router, *,
                 spawn: Optional[Callable] = None,
                 spawn_async: Optional[Callable] = None,
                 defer_spawn: bool = True,
                 spawn_timeout_s: float = 120.0,
                 worker_flags: Optional[Dict[str, Sequence[str]]] = None,
                 min_prefill: int = 1, max_prefill: int = 2,
                 min_decode: int = 1, max_decode: int = 2,
                 scale_up_after: int = 2, scale_down_after: int = 4,
                 cooldown_ticks: int = 2,
                 tick_interval_s: float = 0.25,
                 fleet_summary=None):
        if spawn is not None and spawn_async is not None:
            raise ValueError("pass spawn= (blocking) OR spawn_async= "
                             "(deferred-attach), not both")
        if min_prefill < 1 or min_decode < 1:
            raise ValueError("min pool sizes must be >= 1 (a pool "
                             "scaled to zero cannot serve anything)")
        if max_prefill < min_prefill or max_decode < min_decode:
            raise ValueError("max pool size below min")
        if scale_up_after < 1 or scale_down_after < 1:
            raise ValueError("hysteresis streaks must be >= 1")
        self._router = router
        self._spawn_hook = spawn
        self._spawn = spawn or self._spawn_process
        self._spawn_async = spawn_async
        # deferred-attach is the default ONLY for the process spawn
        # path — a legacy spawn= hook stays synchronous (in-process
        # test servers have no READY handshake to poll)
        self._defer = bool(defer_spawn) and spawn is None
        self._spawn_timeout_s = float(spawn_timeout_s)
        self._worker_flags = {k: list(v)
                              for k, v in (worker_flags or {}).items()}
        self._bounds = {"prefill": (min_prefill, max_prefill),
                        "decode": (min_decode, max_decode)}
        self._up_after = int(scale_up_after)
        self._down_after = int(scale_down_after)
        self._cooldown_ticks = int(cooldown_ticks)
        self._tick_interval_s = float(tick_interval_s)
        self._fleet_summary = fleet_summary
        # all controller state is confined to the loop that steps the
        # router (module-doc threading contract)
        self._procs: Dict[str, object] = {}      # guarded-by: confined(controller-loop)
        self._pending: Dict[str, List] = {p: [] for p in _POOLS}  # guarded-by: confined(controller-loop)
        self._up_streak = dict.fromkeys(_POOLS, 0)    # guarded-by: confined(controller-loop)
        self._down_streak = dict.fromkeys(_POOLS, 0)  # guarded-by: confined(controller-loop)
        self._cooldown = dict.fromkeys(_POOLS, 0)     # guarded-by: confined(controller-loop)
        self._actions: List[dict] = []           # guarded-by: confined(controller-loop)
        self._drained_requests = 0               # guarded-by: confined(controller-loop)
        self._chip_seconds = 0.0                 # guarded-by: confined(controller-loop)
        self._last_tick_t: Optional[float] = None  # guarded-by: confined(controller-loop)
        self._last_maybe_t = 0.0                 # guarded-by: confined(controller-loop)

    # -- the control loop ---------------------------------------------------

    def maybe_tick(self) -> Optional[dict]:
        """Rate-limited :meth:`tick` — call it every router cycle
        (``Router.run_trace(..., on_step=controller.maybe_tick)``);
        only every ``tick_interval_s`` actually polls and decides."""
        now = time.perf_counter()
        if now - self._last_maybe_t < self._tick_interval_s:
            return None
        self._last_maybe_t = now
        return self.tick()

    def tick(self) -> dict:
        """One control cycle: accrue chip-seconds, refresh stats, read
        the fused signal, update the hysteresis streaks, act at most
        once per pool.  Returns the signal (with the actions taken
        under ``"actions"``) so callers can log it."""
        now = time.perf_counter()
        n_workers = self._n_workers()
        if self._last_tick_t is not None:
            # the integral of pool size over wall time: a draining
            # worker still burns its chip until it is reaped, so it
            # counts — chip_seconds is honest spend, not target size
            self._chip_seconds += (now - self._last_tick_t) * n_workers
        self._last_tick_t = now
        self._router.scrape_stats()
        sig = self._router.autoscale_signal(self._load_fleet())
        # deferred-attach: advance every pending spawn's
        # READY handshake FIRST — non-blocking, so a warming worker
        # costs this tick microseconds, and the attach happens the
        # same cycle the child reports in
        actions: List[dict] = self._poll_pending()
        for pool in _POOLS:
            hint = sig.get(pool, {}).get("hint", 0)
            if hint > 0:
                self._up_streak[pool] += 1
                self._down_streak[pool] = 0
            elif hint < 0:
                self._down_streak[pool] += 1
                self._up_streak[pool] = 0
            else:
                # hysteresis: a flap back to 0 resets BOTH streaks —
                # only a sustained signal moves the fleet
                self._up_streak[pool] = 0
                self._down_streak[pool] = 0
            if self._cooldown[pool] > 0:
                self._cooldown[pool] -= 1
                continue
            lo, hi = self._bounds[pool]
            # a warming (pending-attach) member counts toward size:
            # the hint persisting through its spawn must not stack a
            # second spawn on top of the first
            size = self._pool_size(pool) + len(self._pending[pool])
            act = None
            if (self._up_streak[pool] >= self._up_after
                    and size < hi):
                act = self._guarded(self._scale_up, "spawn", pool)
            elif (self._down_streak[pool] >= self._down_after
                    and size > lo):
                act = self._guarded(self._scale_down, "drain", pool)
            if act is not None:
                actions.append(act)
        self._set_gauges()
        sig["actions"] = actions
        return sig

    def _guarded(self, fn, kind: str, pool: str) -> Optional[dict]:
        """Run one scaling action without letting a transient failure
        (spawn timeout, worker died mid-drain handshake) unwind the
        SERVING loop the controller rides on — the failure is recorded
        as a ``<kind>_failed`` action (cooldown applies, so it retries
        after the refractory window, not every tick).
        Misconfiguration (``ValueError`` — no worker flags, a
        mis-wired role) still raises loudly: no amount of retrying
        fixes a config."""
        try:
            return fn(pool)
        except ValueError:
            raise
        except Exception as e:
            return self._record(f"{kind}_failed", pool, "",
                                error=str(e)[:200])

    # -- actions ------------------------------------------------------------

    def _scale_up(self, pool: str) -> dict:
        if self._spawn_async is not None or self._defer:
            launch = self._spawn_async or self._spawn_process_async
            self._pending[pool].append(launch(pool))
            return self._record("spawn_started", pool, "")
        handle, addr = self._spawn(pool)
        try:
            self._router.add_worker(addr, pool)
        except Exception:
            self._reap(handle)
            raise
        self._procs[addr] = handle
        return self._record("spawn", pool, addr)

    def _poll_pending(self) -> List[dict]:
        """Tick every pending spawn's non-blocking READY poll: attach
        the ones that reported in, reap the ones that died before
        READY (never attached, so nothing to drain), keep warming the
        rest.  Runs every tick regardless of cooldown — an attach is
        the COMPLETION of a past action, not a new one."""
        acts: List[dict] = []
        for pool in _POOLS:
            still: List = []
            for pw in self._pending[pool]:
                state = pw.poll()
                if state is None:
                    still.append(pw)
                    continue
                if state == "ready":
                    try:
                        self._router.add_worker(pw.addr, pool)
                    except Exception as e:   # noqa: BLE001 — tick survives
                        self._reap(pw.proc)
                        acts.append(self._record(
                            "attach_failed", pool, pw.addr or "",
                            error=str(e)[:200]))
                        continue
                    self._procs[pw.addr] = pw.proc
                    extra = {}
                    if getattr(pw, "ready_ms", None) is not None:
                        extra["ready_ms"] = round(pw.ready_ms, 3)
                    acts.append(self._record("attach", pool, pw.addr,
                                             **extra))
                else:                        # dead before READY
                    self._reap(pw.proc)
                    acts.append(self._record(
                        "spawn_failed", pool, "",
                        error=str(getattr(pw, "error", ""))[:200]))
            self._pending[pool] = still
        return acts

    def _scale_down(self, pool: str) -> Optional[dict]:
        victim = self._pick_victim(pool)
        if victim is None:      # defensive twin of tick()'s size guard
            return None
        drained = self._router.drain_worker(victim.addr)
        self._drained_requests += (drained["migrated"]
                                   + drained["requeued"])
        # the worker must actually STOP, not just leave the router's
        # lists — chip_seconds stops counting it here, and a process
        # the controller did not spawn would otherwise keep burning
        # its chip unreaped.  The shutdown RPC exits the serve loop
        # (a CLI worker process then exits); controller-spawned
        # handles additionally get the full terminate-and-join reap.
        try:
            victim.rpc({"op": "shutdown"})
        except Exception:
            pass                      # dead already = stopped already
        self._router.remove_worker(victim.addr)
        self._reap(self._procs.pop(victim.addr, None))
        return self._record("drain", pool, victim.addr, **drained)

    def _pick_victim(self, pool: str):
        """Least-loaded live member: fewest in-flight requests, then
        lowest occupancy — the cheapest drain."""
        cands = [w for w in self._router._pool_list(pool)
                 if w.alive and not w.draining]
        if len(cands) <= self._bounds[pool][0]:
            return None
        return min(cands, key=lambda w: (
            len(w.in_flight),
            w.stats.get("active", 0),
            w.addr))

    def _record(self, action: str, pool: str, addr: str,
                **extra) -> dict:
        rec = {"action": action, "pool": pool, "addr": addr,
               "t": time.time(), **extra}
        self._actions.append(rec)
        self._up_streak[pool] = 0
        self._down_streak[pool] = 0
        self._cooldown[pool] = self._cooldown_ticks
        _telemetry.counter("controller.actions",
                           {"action": action, "pool": pool}).inc()
        if extra.get("migrated") or extra.get("requeued"):
            _telemetry.counter("controller.drained_requests").inc(
                extra.get("migrated", 0) + extra.get("requeued", 0))
        _telemetry.event("controller.action", **rec)
        return rec

    # -- plumbing -----------------------------------------------------------

    def _pool_size(self, pool: str) -> int:
        return sum(1 for w in self._router._pool_list(pool)
                   if w.alive and not w.draining)

    def _n_workers(self) -> int:
        # pending spawns burn their chip from launch, not from attach
        return (sum(1 for w in (self._router._prefill
                                + self._router._decode) if w.alive)
                + sum(len(v) for v in self._pending.values()))

    def _load_fleet(self) -> Optional[dict]:
        src = self._fleet_summary
        if src is None:
            return None
        if callable(src):
            return src()
        try:
            with open(src) as f:
                return json.load(f)
        except (OSError, ValueError):
            # a missing/torn artifact degrades to live signals only —
            # the fleet evidence sharpens the policy, never gates it
            return None

    def _spawn_process(self, pool: str) -> Tuple[object, str]:
        from apex_tpu_torch.serving.cluster.worker import spawn_worker

        proc, addr, _metrics = spawn_worker(
            pool, extra_args=self._pool_flags(pool),
            timeout=self._spawn_timeout_s)
        return proc, addr

    def _spawn_process_async(self, pool: str):
        from apex_tpu_torch.serving.cluster.worker import spawn_worker_async

        return spawn_worker_async(pool, extra_args=self._pool_flags(pool),
                                  timeout=self._spawn_timeout_s)

    def _pool_flags(self, pool: str) -> List[str]:
        flags = self._worker_flags.get(pool)
        if flags is None:
            raise ValueError(
                f"no worker_flags[{pool!r}] configured and no spawn= "
                "hook given — the controller cannot grow this pool")
        return flags

    @staticmethod
    def _reap(handle) -> None:
        if handle is None:
            return
        if hasattr(handle, "poll"):            # a spawn_worker Popen
            from apex_tpu_torch.serving.cluster.worker import shutdown_worker

            shutdown_worker(handle)
            return
        for meth in ("stop", "close"):         # in-process test server
            fn = getattr(handle, meth, None)
            if callable(fn):
                fn()

    def _set_gauges(self) -> None:
        for pool in _POOLS:
            _telemetry.gauge("controller.pool_size",
                             {"pool": pool}).set(self._pool_size(pool))
        _telemetry.gauge("controller.draining").set(sum(
            1 for w in (self._router._prefill + self._router._decode)
            if w.alive and w.draining))
        _telemetry.gauge("controller.pending_spawns").set(
            sum(len(v) for v in self._pending.values()))
        # per-pool warming countdown: the oldest pending
        # spawn's age and its READY deadline — serve_dash renders the
        # remaining-time row from these; 0/0 means nothing warming
        for pool in _POOLS:
            pend = [pw for pw in self._pending[pool]
                    if hasattr(pw, "age_s")]
            oldest = max(pend, key=lambda pw: pw.age_s, default=None)
            _telemetry.gauge("controller.warming_age_s",
                             {"pool": pool}).set(
                round(oldest.age_s, 3) if oldest else 0.0)
            _telemetry.gauge("controller.warming_timeout_s",
                             {"pool": pool}).set(
                getattr(oldest, "timeout_s", 0.0) or 0.0
                if oldest else 0.0)
        _telemetry.gauge("controller.chip_seconds").set(
            round(self._chip_seconds, 3))

    # -- operator surface ---------------------------------------------------

    def stats(self) -> dict:
        """Snapshot for dashboards/tests: pool sizes, hysteresis
        state, the action log tail, drained-request and chip-second
        totals."""
        return {
            "pool_size": {p: self._pool_size(p) for p in _POOLS},
            "pending_spawns": {p: len(self._pending[p])
                               for p in _POOLS},
            # the dashboard's "warming" rows: one per pending spawn,
            # with how long it has been warming vs its READY deadline
            "warming": [
                {"pool": p, "age_s": round(pw.age_s, 3),
                 "timeout_s": getattr(pw, "timeout_s", None)}
                for p in _POOLS for pw in self._pending[p]
                if hasattr(pw, "age_s")],
            "draining": sum(
                1 for w in (self._router._prefill
                            + self._router._decode)
                if w.alive and w.draining),
            "actions": list(self._actions[-16:]),
            "actions_taken": len(self._actions),
            "last_action": (self._actions[-1] if self._actions
                            else None),
            "drained_requests": self._drained_requests,
            "chip_seconds": round(self._chip_seconds, 3),
            "up_streak": dict(self._up_streak),
            "down_streak": dict(self._down_streak),
            "cooldown": dict(self._cooldown),
        }

    def close(self, reap_spawned: bool = True) -> None:
        """Reap every worker THIS controller spawned — attached or
        still warming (pre-existing pool members are the operator's)."""
        if not reap_spawned:
            self._procs.clear()
            for p in _POOLS:
                self._pending[p] = []
            return
        while self._procs:
            _addr, handle = self._procs.popitem()
            try:
                self._reap(handle)
            except Exception:
                pass
        for p in _POOLS:
            pending, self._pending[p] = self._pending[p], []
            for pw in pending:
                try:
                    self._reap(getattr(pw, "proc", pw))
                except Exception:
                    pass
