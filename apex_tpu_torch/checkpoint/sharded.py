"""Snapshots in the JAX package's sharded on-disk format, single process
(``apex_tpu/checkpoint/sharded.py``).

Layout (one directory per step)::

    <directory>/
      step_00000400/
        shard_p0.bin        # every leaf's raw little-endian bytes
        MANIFEST.json       # committed LAST, via write-temp-then-rename
      step_00000500/ ...

The manifest is the commit point: a step directory without a valid
``MANIFEST.json`` does not exist (``latest_step`` skips it, retention
deletes it).  It records, per leaf, the tree path in ``jax.tree_util.
keystr`` form (``.master_params['layers']['qkv_kernel']``: a named
tuple's field, a dict's key in sorted order, a sequence's index), the
shape, the dtype by its numpy name (``bfloat16`` for bf16), the byte
offset and length in the shard file and a ``sha256:`` digest of the
bytes.  The port's ``TrainState``, ``AdamState``, ``LambState`` and
``LossScaleState`` carry the JAX field names, so a state of the port
and the same state of the JAX package have the same manifest (keys,
shapes, dtypes, digests), and each package restores the other's files.
As in JAX, the process writes a manifest fragment (``MANIFEST.p0.json``,
atomically) and then commits the merged manifest; re-saving a committed
step de-commits it first.

Restore is driven by a template (the freshly initialised state): the
tree structure, every shape and dtype must match the manifest, every
digest is checked, and each leaf is placed on the template leaf's device
bit for bit.  One process only: more processes, ``reshard=True`` and
mesh geometry come with the distributed-training slice, and raise.
"""

from __future__ import annotations

import hashlib
import json
import os
import re
import shutil
import time
from typing import Any, Callable, List, Optional, Tuple

import numpy as np
import torch

from apex_tpu_torch.observability import metrics as _telemetry

__all__ = ["MANIFEST_NAME", "MANIFEST_SCHEMA_VERSION", "CheckpointError",
           "all_steps", "latest_step", "load_manifest", "prune_checkpoints",
           "restore_sharded", "save_sharded", "flatten_with_keys"]

MANIFEST_NAME = "MANIFEST.json"
MANIFEST_SCHEMA_VERSION = 1
SHARD_FILE = "shard_p0.bin"

_STEP_DIR = re.compile(r"^step_(\d{8})$")


class CheckpointError(RuntimeError):
    """A checkpoint could not be saved, validated or restored."""


def _distributed(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} comes with the distributed-training slice of the port")


def _step_dir(directory: str, step: int) -> str:
    return os.path.join(os.path.abspath(directory), f"step_{int(step):08d}")


# ---------------------------------------------------------------------------
# tree paths (jax.tree_util.keystr of the same structure)
# ---------------------------------------------------------------------------


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def flatten_with_keys(tree) -> Tuple[List[Tuple[str, Any]], Callable]:
    """``([(keystr, leaf), ...], rebuild)``: the leaves in JAX's
    flattening order (named-tuple fields in order, dict keys sorted,
    sequence items in order; ``None`` holds no leaf) and a function that
    builds the same structure from a list of new leaves."""
    out: List[Tuple[str, Any]] = []

    def walk(node, path):
        if node is None:
            return lambda it: None
        if _is_namedtuple(node):
            parts = [walk(getattr(node, f), f"{path}.{f}")
                     for f in node._fields]
            return lambda it: type(node)(*[p(it) for p in parts])
        if isinstance(node, dict):
            keys = sorted(node)
            parts = [walk(node[k], f"{path}[{k!r}]") for k in keys]

            def build_dict(it, keys=keys, parts=parts, order=list(node)):
                vals = {k: p(it) for k, p in zip(keys, parts)}
                return {k: vals[k] for k in order}   # the template's order
            return build_dict
        if isinstance(node, (list, tuple)):
            parts = [walk(v, f"{path}[{i}]") for i, v in enumerate(node)]
            return lambda it: type(node)(p(it) for p in parts)
        out.append((path, node))
        return lambda it: next(it)

    build = walk(tree, "")
    return out, lambda leaves: build(iter(leaves))


# ---------------------------------------------------------------------------
# bytes of a leaf
# ---------------------------------------------------------------------------

_TORCH_TO_NAME = {torch.float32: "float32", torch.float16: "float16",
                  torch.bfloat16: "bfloat16", torch.float64: "float64",
                  torch.int64: "int64", torch.int32: "int32",
                  torch.int16: "int16", torch.int8: "int8",
                  torch.uint8: "uint8", torch.bool: "bool"}
_NAME_TO_TORCH = {v: k for k, v in _TORCH_TO_NAME.items()}


def _dtype_name(leaf) -> str:
    if torch.is_tensor(leaf):
        name = _TORCH_TO_NAME.get(leaf.dtype)
        if name is None:
            raise CheckpointError(f"leaf dtype {leaf.dtype} has no numpy "
                                  "name the manifest can record")
        return name
    return str(np.asarray(leaf).dtype)


def _shape(leaf) -> List[int]:
    return [int(d) for d in (leaf.shape if torch.is_tensor(leaf)
                             else np.shape(leaf))]


def _host_bytes(leaf) -> np.ndarray:
    """The leaf's bytes as a flat uint8 numpy view of host memory (a
    device tensor is copied to the host first)."""
    if torch.is_tensor(leaf):
        t = leaf.detach()
        if t.device.type != "cpu":
            t = t.cpu()
        t = t.contiguous().reshape(-1)
        return t.view(torch.uint8).numpy()
    return np.ascontiguousarray(np.asarray(leaf)).reshape(-1).view(np.uint8)


def _digest(buf) -> str:
    return "sha256:" + hashlib.sha256(buf).hexdigest()


def _fsync_dir(path: str) -> None:
    """fsync a directory so the renames inside it are durable
    (best-effort: not every filesystem opens directories)."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def _write_json_atomic(path: str, doc: dict, indent=None) -> None:
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(doc, f, indent=indent)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


# ---------------------------------------------------------------------------
# save
# ---------------------------------------------------------------------------


def save_sharded(directory: str, step: int, state: Any, *,
                 process_index: Optional[int] = None,
                 expected_processes: Optional[int] = None,
                 keep: Optional[int] = None, extra: Optional[dict] = None,
                 return_stats: bool = False):
    """Snapshot ``state`` (a tree of tensors, numpy arrays and Python
    scalars) under ``directory/step_<N>`` and commit the manifest
    atomically.  ``keep`` prunes older committed checkpoints beyond the
    newest ``keep`` after the commit; ``extra`` is a JSON-safe dict
    stored in the manifest.  Returns the step directory (``(path,
    bytes_written)`` with ``return_stats``)."""
    if process_index not in (None, 0) or expected_processes not in (None,
                                                                    1):
        raise _distributed("saving from more than one process")
    path = _step_dir(directory, step)
    os.makedirs(path, exist_ok=True)
    manifest_path = os.path.join(path, MANIFEST_NAME)
    if os.path.exists(manifest_path):
        # re-saving a committed step: de-commit first, so a crash in the
        # rewrite never leaves a manifest over half-written bytes
        os.remove(manifest_path)
        _fsync_dir(path)
    frag_path = os.path.join(path, "MANIFEST.p0.json")
    if os.path.exists(frag_path):
        os.remove(frag_path)
        _fsync_dir(path)

    keyed, _ = flatten_with_keys(state)
    leaves_meta: List[dict] = []
    offset = 0
    with open(os.path.join(path, SHARD_FILE), "wb") as f:
        for key, leaf in keyed:
            buf = _host_bytes(leaf)
            f.write(buf)
            shape = _shape(leaf)
            leaves_meta.append({
                "key": key, "shape": shape, "dtype": _dtype_name(leaf),
                "prng_impl": None, "typed_key": False, "sharding": None,
                "shards": [{"file": SHARD_FILE, "offset": offset,
                            "nbytes": int(buf.nbytes),
                            "index": [[0, d] for d in shape],
                            "digest": _digest(buf)}]})
            offset += int(buf.nbytes)
        f.flush()
        os.fsync(f.fileno())
    _write_json_atomic(frag_path, {"process_index": 0,
                                   "total_bytes": offset,
                                   "leaves": leaves_meta})
    _fsync_dir(path)
    manifest = {"manifest_schema_version": MANIFEST_SCHEMA_VERSION,
                "step": int(step), "t": time.time(), "process_count": 1,
                "total_bytes": offset, "leaves": leaves_meta}
    if extra is not None:
        manifest["extra"] = extra
    _write_json_atomic(manifest_path, manifest, indent=1)   # the commit
    os.remove(frag_path)
    _fsync_dir(path)
    _fsync_dir(os.path.dirname(path))
    if keep is not None:
        prune_checkpoints(directory, keep)
    return (path, offset) if return_stats else path


# ---------------------------------------------------------------------------
# discovery / retention
# ---------------------------------------------------------------------------


def _committed(path: str) -> bool:
    try:
        with open(os.path.join(path, MANIFEST_NAME)) as f:
            doc = json.load(f)
        return isinstance(doc, dict) and "manifest_schema_version" in doc
    except (OSError, ValueError):
        return False


def all_steps(directory: str) -> List[int]:
    """Sorted steps of every committed checkpoint (a parseable manifest;
    torn snapshots are invisible)."""
    directory = os.path.abspath(directory)
    if not os.path.isdir(directory):
        return []
    return sorted(int(m.group(1)) for m in map(_STEP_DIR.match,
                                               os.listdir(directory))
                  if m and _committed(os.path.join(directory, m.group(0))))


def latest_step(directory: str) -> Optional[int]:
    """Newest committed step, or None."""
    steps = all_steps(directory)
    return steps[-1] if steps else None


def prune_checkpoints(directory: str, keep: int) -> List[int]:
    """Delete committed checkpoints beyond the newest ``keep`` and any
    torn ``step_*`` attempt older than the newest committed one; returns
    the deleted committed steps."""
    if keep < 1:
        raise ValueError(f"keep={keep} must be >= 1")
    directory = os.path.abspath(directory)
    committed = all_steps(directory)
    doomed = committed[:-keep] if len(committed) > keep else []
    for step in doomed:
        shutil.rmtree(_step_dir(directory, step), ignore_errors=True)
    if committed:
        newest = committed[-1]
        for name in os.listdir(directory):
            m = _STEP_DIR.match(name)
            if (m and int(m.group(1)) < newest
                    and not _committed(os.path.join(directory, name))):
                shutil.rmtree(os.path.join(directory, name),
                              ignore_errors=True)
    return doomed


def load_manifest(directory: str, step: Optional[int] = None) -> dict:
    """The committed manifest of ``step`` (default: the newest)."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise CheckpointError(
                f"no committed checkpoints under {directory}")
    path = os.path.join(_step_dir(directory, step), MANIFEST_NAME)
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, ValueError) as e:
        raise CheckpointError(f"unreadable manifest {path}: {e}") from e


# ---------------------------------------------------------------------------
# restore
# ---------------------------------------------------------------------------


def _place(raw: bytes, meta: dict, template):
    """The leaf of ``raw`` bytes with the template's type, dtype and
    device."""
    shape = tuple(meta["shape"])
    if torch.is_tensor(template):
        host = torch.frombuffer(bytearray(raw), dtype=torch.uint8)
        t = host.view(_NAME_TO_TORCH[meta["dtype"]]).reshape(shape)
        return t.to(template.device)
    arr = np.frombuffer(raw, np.dtype(meta["dtype"])).reshape(shape).copy()
    if isinstance(template, np.ndarray):
        return arr
    return type(template)(arr.reshape(())[()])


def restore_sharded(directory: str, state_like: Any, *,
                    step: Optional[int] = None, verify_digests: bool = True,
                    reshard: bool = False) -> Any:
    """Restore a snapshot into the structure of ``state_like`` (module
    docstring); every leaf lands on the template leaf's device, bit for
    bit."""
    if reshard:
        raise _distributed("reshard=True (restoring onto another mesh)")
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise CheckpointError(
                f"no committed checkpoints under {directory}")
    t0 = time.perf_counter()
    path = _step_dir(directory, step)
    manifest = load_manifest(directory, step)
    if int(manifest.get("process_count", 1)) != 1:
        raise _distributed("restoring a checkpoint of more than one process")
    keyed, rebuild = flatten_with_keys(state_like)
    saved = {leaf["key"]: leaf for leaf in manifest["leaves"]}
    live = [k for k, _ in keyed]
    missing = [k for k in live if k not in saved]
    unexpected = [k for k in saved if k not in set(live)]
    if missing or unexpected:
        raise CheckpointError(
            f"tree structure mismatch restoring step {step}: missing from "
            f"checkpoint {missing[:5]}, unexpected in checkpoint "
            f"{unexpected[:5]} (template has {len(live)} leaves, checkpoint "
            f"{len(saved)})")
    handles = {}
    out = []
    try:
        for key, template in keyed:
            meta = saved[key]
            if meta.get("typed_key"):
                raise CheckpointError(
                    f"leaf {key}: a typed JAX PRNG key; the port holds raw "
                    "key words")
            if tuple(meta["shape"]) != tuple(_shape(template)):
                raise CheckpointError(
                    f"leaf {key}: shape mismatch (saved "
                    f"{tuple(meta['shape'])}, live {tuple(_shape(template))})")
            if meta["dtype"] != _dtype_name(template):
                raise CheckpointError(
                    f"leaf {key}: dtype mismatch (saved {meta['dtype']}, "
                    f"live {_dtype_name(template)})")
            if meta.get("sharding") is not None:
                raise _distributed(f"leaf {key}: a leaf saved on a mesh")
            shards = meta["shards"]
            if len(shards) != 1 or shards[0]["index"] != [
                    [0, d] for d in meta["shape"]]:
                raise _distributed(f"leaf {key}: a leaf saved in shards")
            sh = shards[0]
            f = handles.get(sh["file"])
            if f is None:
                fpath = os.path.join(path, sh["file"])
                try:
                    f = handles[sh["file"]] = open(fpath, "rb")
                except OSError as e:
                    raise CheckpointError(
                        f"missing shard file {fpath}") from e
            f.seek(sh["offset"])
            raw = f.read(sh["nbytes"])
            if len(raw) != sh["nbytes"]:
                raise CheckpointError(
                    f"short read from {sh['file']} at {sh['offset']}: "
                    f"wanted {sh['nbytes']} bytes, got {len(raw)}")
            if verify_digests and _digest(raw) != sh["digest"]:
                raise CheckpointError(
                    f"leaf {key}: content digest mismatch in {sh['file']} "
                    f"(expected {sh['digest']}, got {_digest(raw)}): the "
                    "checkpoint is corrupt")
            out.append(_place(raw, meta, template))
    finally:
        for f in handles.values():
            f.close()
    restored = rebuild(out)
    reg = _telemetry.registry()
    if reg is not None:
        reg.histogram("checkpoint.restore").observe(time.perf_counter() - t0)
        _telemetry.counter("checkpoint.restores").inc()
    return restored
