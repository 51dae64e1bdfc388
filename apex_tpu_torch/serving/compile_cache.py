"""Persistent serving ladder (``apex_tpu/serving/compile_cache.py``).

The JAX engine persists one compiled executable per ladder entry (a
prefill and a KV insert per prompt bucket, the decode step, the sampler,
the chunk step) so a fresh worker loads them instead of tracing.  In
torch the counterpart is two things:

- **on disk**, the kernel libraries each entry's call loads: a
  :class:`CompileCache` directory holds them under ``kernels/``, beside
  one record per entry, ``<key>.json``, and the ``manifest.json`` index;
- **in the process**, a ``torch.cuda.CUDAGraph`` of the entry's call,
  captured once with its static input and output buffers and replayed
  for every later call (the per-process memo).

An entry's key covers its name, its static parts (the engine's
``_cc_parts``: bucket, ``cache_wire``, ``chunk_tokens``, sampling
knobs), the shapes and dtypes of its arguments and of the state it is
bound to, and :func:`code_version` (the port's sources, every
``csrc/*.cu``/``*.cuh``, torch and CUDA versions, the card).  A stale
digest is a different key: an old entry is orphaned, never hit.

- A **hit** is an entry whose record reads and whose libraries all load
  from the directory with no ``nvcc`` run.
- A **miss** (no record, a torn or foreign record, a missing or torn
  library) is rebuilt: the first call runs eagerly, which builds what it
  needs, and the record and libraries are written (records and the
  manifest atomically, temp file plus ``os.replace``).  It never raises
  for cache trouble.
- A **capture or replay failure raises** on the card.  The JAX engine
  falls back to the plain jit when an executable is refused; here that
  would hide the kernel behind an eager run, so there is no retry.  On
  a CPU device there is nothing to capture: the entry runs eagerly (the
  CPU route, as for every op) and its record lists no library.

Calling an entry: ``fn = cache.load_or_compile(name, step, args,
bound, key_parts=...)``; ``fn(*args)`` runs ``step(*args, **bound)``.
``args`` are the call's inputs (host or device tensors): each call
copies them into the entry's static buffers, except a device tensor
that already is one (another entry's output).  ``bound`` holds
everything else: state tensors captured by address (the parameters, the
KV pools) and plain values.  They must keep their addresses for the
entry's life, and every tensor among them must lie on the cache's
device.  Keep the entry and call it again: the lookup keys and hashes
the bound state, so it belongs to set-up, not to every step.  The
outputs are the entry's static buffers: valid until its next call.  Each replay adds to the kernels' launch counters the
launches recorded while the graph was captured, so counts stay exact.

Telemetry: ``serving.compile_cache.{hits,misses}`` counters and the
``serving.compile_cache.load_ms`` sketch.
"""

from __future__ import annotations

import functools
import gc
import hashlib
import json
import os
import tempfile
import time
import weakref
from pathlib import Path
from typing import Any, Dict, Optional

import torch

from apex_tpu_torch.observability import metrics as _telemetry
from apex_tpu_torch.ops import _kernel_utils as ku
from apex_tpu_torch.utils.registry import resolve_device

__all__ = ["CompileCache", "code_version", "warmup_ladder"]

_MANIFEST = "manifest.json"
KERNEL_DIR = "kernels"
_PKG = Path(__file__).resolve().parent.parent


def _device_tag() -> str:
    if not torch.cuda.is_available():
        return "cpu"
    return "%s sm_%d%d" % ((torch.cuda.get_device_name(0),)
                           + torch.cuda.get_device_capability(0))


@functools.lru_cache(maxsize=None)
def _digest(device: str) -> str:
    h = hashlib.sha256()
    for path in sorted(_PKG.rglob("*")):
        if path.suffix not in (".py", ".cu", ".cuh") or not path.is_file():
            continue
        h.update(str(path.relative_to(_PKG)).encode())
        h.update(path.read_bytes())
    for part in (torch.__version__, str(torch.version.cuda), device):
        h.update(part.encode())
    return h.hexdigest()[:16]


def code_version() -> str:
    """SHA-256 (16 hex digits) over everything that can silently stale an
    entry: the port's ``.py`` files and kernel sources, the torch and
    CUDA versions, and the card's name and compute capability."""
    return _digest(_device_tag())


def _sig(x) -> Any:
    """One value's part of an entry key: a tensor its shape and dtype (a
    ``meta`` tensor and a real one share a key), containers element-wise,
    anything else its repr."""
    if isinstance(x, torch.Tensor):
        return [list(x.shape), str(x.dtype)]
    if isinstance(x, dict):
        return {str(k): _sig(v) for k, v in sorted(x.items(),
                                                   key=lambda kv: str(kv[0]))}
    if isinstance(x, (list, tuple)):
        return [_sig(v) for v in x]
    return repr(x)


def _leaves(x):
    """The non-container values of nested dicts, lists and tuples."""
    if isinstance(x, dict):
        for v in x.values():
            yield from _leaves(v)
    elif isinstance(x, (list, tuple)):
        for v in x:
            yield from _leaves(v)
    else:
        yield x


def _flat_out(out):
    return out if isinstance(out, tuple) else (out,)


def _counts_add(delta: Dict[str, int]) -> None:
    for name, n in delta.items():
        ku.KERNELS[name].launches += n


class _Entry:
    """One ladder entry in this process: its record, and on the card its
    captured graph (module doc)."""

    def __init__(self, cache: "CompileCache", key: str, name: str, fn,
                 bound: dict, parts: dict, record: Optional[dict]):
        # no strong reference back: a cycle would leave a dropped engine's
        # graphs to the cyclic collector, which may run during another
        # capture, where destroying a graph is refused
        self._owner = weakref.ref(cache)
        self.device, self.pool = cache.device, cache.pool
        self.key, self.name = key, name
        self.fn, self.bound, self.parts = fn, bound, parts
        self.record = record
        self.graph = None
        self.static_in: tuple = ()
        self.static_out: tuple = ()
        self.single = True
        # launches one replay makes, as recorded at capture
        self.launches: Dict[str, int] = {}
        self.replays = 0

    def __call__(self, *args):
        if self.device.type != "cuda":
            out = self.fn(*args, **self.bound)
            if self.record is None:
                self._owner()._record(self, {})
            return out
        if self.graph is None:
            return self._first(args)
        for buf, a in zip(self.static_in, args):
            if buf is not a:
                buf.copy_(a, non_blocking=True)
        self.graph.replay()
        _counts_add(self.launches)
        self.replays += 1
        return self.static_out[0] if self.single else self.static_out

    def _first(self, args):
        """The first call on the card: run eagerly (it builds the kernels
        its launches need and warms the allocator, library handles and
        anything else lazy), record the entry on a miss, capture the graph
        on the same static buffers, and hand out those buffers holding the
        eager run's outputs."""
        dev = self.device
        self.static_in = tuple(
            a if a.device == dev else a.to(dev) for a in args)
        before = ku.launch_counts()
        stream = torch.cuda.Stream(dev)
        stream.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(stream):
            out = self.fn(*self.static_in, **self.bound)
        torch.cuda.current_stream(dev).wait_stream(stream)
        eager = {k: n - before[k] for k, n in ku.launch_counts().items()
                 if n != before[k]}
        if self.record is None:
            self._owner()._record(self, eager)
        torch.cuda.synchronize(dev)
        self.single = not isinstance(out, tuple)
        graph = torch.cuda.CUDAGraph()
        mark = ku.launch_counts()
        # no cyclic collection while capturing: freeing another graph (or
        # anything whose release calls into CUDA) would end the capture
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(graph, pool=self.pool):
                static_out = self.fn(*self.static_in, **self.bound)
        finally:
            if collecting:
                gc.enable()
        captured = {k: n - mark[k] for k, n in ku.launch_counts().items()
                    if n != mark[k]}
        # capturing recorded the launches; it made none
        _counts_add({k: -n for k, n in captured.items()})
        if captured != eager:
            raise RuntimeError(
                f"compile cache entry {self.name!r}: the capture recorded "
                f"launches {captured}, the eager call made {eager}; the "
                "call's launches depend on more than its shapes")
        self.launches = captured
        self.graph = graph
        self.static_out = _flat_out(static_out)
        for dst, src in zip(self.static_out, _flat_out(out)):
            if dst is not None:
                dst.copy_(src)
        return self.static_out[0] if self.single else self.static_out


class CompileCache:
    """One on-disk ladder store and this process's captured graphs (module
    doc).  ``device`` is the device of the state the entries are bound to
    (the engine's): the card unless ``"cpu"`` is passed, as for every
    entry point.  One instance per engine: a captured graph holds the
    addresses of that engine's tensors."""

    def __init__(self, cache_dir, device=None):
        dev = resolve_device(device)
        self.dir = Path(cache_dir)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.kernel_dir = self.dir / KERNEL_DIR
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        self.device = dev
        self._memo: Dict[str, _Entry] = {}
        self._manifest = self._read_manifest()
        self.hits = 0
        self.misses = 0
        # the graphs share one memory pool: they replay one at a time on
        # one stream, and every static output stays referenced
        self.pool = (torch.cuda.graph_pool_handle()
                     if self.device.type == "cuda" else None)

    # -- keys ---------------------------------------------------------------

    def key_for(self, name: str, args=(), bound=None,
                key_parts: Optional[dict] = None) -> str:
        ident = {
            "name": name,
            "parts": {str(k): repr(v)
                      for k, v in (key_parts or {}).items()},
            "avals": hashlib.sha256(json.dumps(
                [_sig(tuple(args)), _sig(dict(bound or {}))]).encode()
            ).hexdigest()[:16],
            "code": code_version(),
            "device": self.device.type,
        }
        return hashlib.sha256(
            json.dumps(ident, sort_keys=True).encode()).hexdigest()[:24]

    # -- the one entry point ------------------------------------------------

    def load_or_compile(self, name: str, fn, args=(), bound=None, *,
                        key_parts: Optional[dict] = None) -> _Entry:
        """The entry of ``fn`` at these shapes: memoized in the process,
        else its record and libraries loaded from the directory (a hit),
        else a new entry recorded at its first call (a miss).  Call the
        result with the arguments (module doc).  Raises when a tensor of
        ``bound`` lies on another device than the cache's: the entry would
        run it on the wrong route (eagerly, or captured over foreign
        memory)."""
        bound = dict(bound or {})
        key = self.key_for(name, args, bound, key_parts)
        ent = self._memo.get(key)
        if ent is not None:
            return ent
        for t in _leaves(bound):
            if isinstance(t, torch.Tensor) and t.device != self.device:
                raise ValueError(
                    f"compile cache entry {name!r}: bound state on "
                    f"{t.device}, the cache is on {self.device}")
        record = self._load(key)
        if record is not None:
            self.hits += 1
            _telemetry.counter("serving.compile_cache.hits").inc()
        else:
            self.misses += 1
            _telemetry.counter("serving.compile_cache.misses").inc()
        ent = _Entry(self, key, name, fn, bound, dict(key_parts or {}),
                     record)
        self._memo[key] = ent
        return ent

    # -- disk ---------------------------------------------------------------

    def _record_path(self, key: str) -> Path:
        return self.dir / f"{key}.json"

    def _load(self, key: str) -> Optional[dict]:
        t0 = time.perf_counter()
        try:
            rec = json.loads(self._record_path(key).read_text())
            libs = rec["libraries"]
            ok = (isinstance(rec, dict) and rec.get("key") == key
                  and isinstance(libs, list)
                  and all(isinstance(s, str) for s in libs))
        except (OSError, ValueError, KeyError, TypeError):
            # missing = cold; anything else is torn or foreign: a miss
            return None
        if not ok or not all(ku.load_built(s, self.kernel_dir)
                             for s in libs):
            return None
        _telemetry.sketch("serving.compile_cache.load_ms").observe(
            (time.perf_counter() - t0) * 1e3)
        return rec

    def _record(self, ent: _Entry, launched: Dict[str, int]) -> None:
        """Write a missed entry: the libraries of the kernels its first
        call launched (built into the directory, a copy where the same
        build is loaded from elsewhere), then its record, then the
        manifest."""
        libs = sorted({ku.KERNELS[k].source for k in launched})
        if libs:
            ku.build_all(libs, directory=self.kernel_dir)
        rec = {
            "key": ent.key, "name": ent.name,
            "parts": {str(k): repr(v) for k, v in ent.parts.items()},
            "libraries": libs,
            "files": {s: ku.lib_path(s, self.kernel_dir).name for s in libs},
            "launches": launched, "code": code_version(),
            "created": time.time(),
        }
        self._atomic_write(self._record_path(ent.key),
                           json.dumps(rec, indent=1).encode())
        ent.record = rec
        self._manifest[ent.key] = {k: rec[k] for k in
                                   ("name", "parts", "libraries", "code",
                                    "created")}
        self._write_manifest()

    def _atomic_write(self, path: Path, blob: bytes) -> None:
        fd, tmp = tempfile.mkstemp(dir=self.dir, suffix=".tmp")
        try:
            with os.fdopen(fd, "wb") as f:
                f.write(blob)
            os.replace(tmp, path)
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise

    def _read_manifest(self) -> dict:
        try:
            m = json.loads((self.dir / _MANIFEST).read_text())
            return m if isinstance(m, dict) else {}
        except (OSError, ValueError):
            # a missing or torn manifest degrades to empty; entries are
            # indexed again as they are recorded
            return {}

    def _write_manifest(self) -> None:
        self._atomic_write(self.dir / _MANIFEST, json.dumps(
            self._manifest, indent=1, sort_keys=True).encode())

    # -- operator surface ---------------------------------------------------

    def stats(self) -> dict:
        return {"dir": str(self.dir), "entries": len(self._manifest),
                "hits": self.hits, "misses": self.misses,
                "captured": sum(e.graph is not None
                                for e in self._memo.values()),
                "replays": sum(e.replays for e in self._memo.values())}


def warmup_ladder(engine) -> dict:
    """Load or record, and on the card capture, every entry ``engine``
    can call: ``prefill[b]`` and ``insert[b]`` for each prompt bucket,
    ``decode``, ``sample`` and, with ``chunk_tokens``, ``chunk`` (the JAX
    ladder's labels).  On the card it first builds into the directory,
    one ``nvcc`` each and all at once, the libraries of the kernels the
    engine's entries launch (``engine._ladder_sources()``; a primed
    directory has them all).  Each entry runs once on inputs that change
    nothing an idle engine holds (inserts and chunks write only unmapped
    or free cells; positions are restored), so the engine must be idle.
    Returns ``{"entries", "labels", "hits", "misses", "skipped",
    "sources", "ms"}``;
    ``skipped`` lists ``(label, reason)`` for an entry this engine cannot
    call, for the static reason the engine states; ``sources`` the
    kernel sources built or found in the directory."""
    cc = engine._compile_cache
    if cc is None:
        return {"entries": 0, "labels": [], "hits": 0, "misses": 0,
                "skipped": [("*", "no compile_cache_dir")], "sources": [],
                "ms": 0.0}
    if not engine.idle:
        raise RuntimeError("warmup_ladder needs an idle engine: its "
                           "entries run once on placeholder inputs")
    t0 = time.perf_counter()
    hits0, miss0 = cc.hits, cc.misses
    sources = []
    if cc.device.type == "cuda":
        sources = engine._ladder_sources()
        ku.build_all(sources, directory=cc.kernel_dir)
    labels, skipped = [], []
    for label, call in engine._ladder():
        reason = engine._ladder_skip(label)
        if reason is not None:
            skipped.append((label, reason))
            continue
        call()
        labels.append(label)
    if cc.device.type == "cuda":
        torch.cuda.synchronize(cc.device)
    out = {"entries": len(labels), "labels": labels,
           "hits": cc.hits - hits0, "misses": cc.misses - miss0,
           "skipped": skipped, "sources": sources,
           "ms": (time.perf_counter() - t0) * 1e3}
    _telemetry.event("serving.compile_cache.warmup",
                     **dict(out, skipped=len(skipped), labels=len(labels),
                            sources=len(sources)))
    return out
