"""Paged KV cache: global block pool + per-request block tables
(``apex_tpu/serving/paged_cache.py``).

- **block pool** — one buffer per K/V side, ``[num_layers, num_blocks,
  block_size, kv_groups, dh]``; ``cache_wire="int8"`` stores it as
  int8 with one fp32 scale per (token, kv group) in the parallel
  ``k_scale``/``v_scale`` pools ``[L, num_blocks, block_size,
  kv_groups]``;
- **block tables** — each request owns an ordered int32 list of pool
  indices; entries ``>= num_blocks`` are the unmapped sentinel (reads
  clamp and mask, writes drop);
- **free-list reuse and prefix sharing** — :class:`BlockManager`, the
  host ledger (numpy and hashlib, as in JAX): refcounts, chained
  SHA-256 digests of full prompt blocks, copy-on-write.

The port updates pools in place: the JAX package's ``.at[].set(...,
mode="drop")`` becomes an ``index_put_`` whose dropped cells are
redirected on the device before any index is formed (an out-of-range
index would raise or corrupt memory; :func:`plan_cells`), with no host
sync and no shape set by the data, so a CUDA graph captures it.  The
pool is never grown by a trash block, so the resident bytes equal the
JAX package's.
"""

from __future__ import annotations

import hashlib
from typing import (Dict, List, NamedTuple, Optional, Sequence, Tuple,
                    Union)

import numpy as np
import torch

from apex_tpu_torch.models.config import TransformerConfig

__all__ = ["BlockManager", "CACHE_WIRES", "Cells", "blocks_for", "chunk_salt",
           "dequantize_kv", "gather_block_kv", "gather_block_scales",
           "init_paged_pool", "paged_insert_prefill",
           "paged_insert_prefill_q", "plan_cells", "prefix_block_hashes",
           "quantize_kv",
           "resolve_cache_wire", "scatter_kv_quantized", "write_cells"]

CACHE_WIRES = ("native", "int8")
_INT8_MAX = 127.0


def resolve_cache_wire(cache_wire) -> str:
    """Normalize the pool-form knob (None == "native")."""
    wire = "native" if cache_wire is None else str(cache_wire)
    if wire not in CACHE_WIRES:
        raise ValueError(
            f"cache_wire={cache_wire!r}: expected one of {CACHE_WIRES} "
            "(or None for native)")
    return wire


def blocks_for(n_tokens: int, block_size: int) -> int:
    """Blocks needed to hold ``n_tokens`` (ceil division)."""
    if n_tokens < 0:
        raise ValueError(f"n_tokens={n_tokens} must be >= 0")
    if block_size < 1:
        raise ValueError(f"block_size={block_size} must be positive")
    return -(-n_tokens // block_size)


def init_paged_pool(cfg: TransformerConfig, num_blocks: int,
                    block_size: int, cache_dtype: Optional[torch.dtype] = None,
                    cache_wire: Optional[str] = None, *,
                    device: Union[str, torch.device]) -> dict:
    """Zeroed K/V pools ``[L, num_blocks, block_size, kv_groups, dh]`` in
    ``cache_dtype`` (default ``cfg.compute_dtype``) on ``device``;
    ``cache_wire="int8"``: int8 pools plus fp32 ``k_scale``/``v_scale``
    ``[L, num_blocks, block_size, kv_groups]`` set to 1, so an untouched
    block dequantizes exactly."""
    if num_blocks < 1:
        raise ValueError(f"num_blocks={num_blocks} must be positive")
    if block_size < 1:
        raise ValueError(f"block_size={block_size} must be positive")
    wire = resolve_cache_wire(cache_wire)
    dt = cfg.compute_dtype if cache_dtype is None else cache_dtype
    shape = (cfg.num_layers, num_blocks, block_size, cfg.kv_groups,
             cfg.kv_channels)
    if wire == "native":
        return {"k": torch.zeros(shape, dtype=dt, device=device),
                "v": torch.zeros(shape, dtype=dt, device=device)}
    return {
        "k": torch.zeros(shape, dtype=torch.int8, device=device),
        "v": torch.zeros(shape, dtype=torch.int8, device=device),
        "k_scale": torch.ones(shape[:-1], dtype=torch.float32, device=device),
        "v_scale": torch.ones(shape[:-1], dtype=torch.float32, device=device),
    }


def quantize_kv(x: torch.Tensor):
    """Symmetric round-half-to-even int8 over the head dim: ``x``
    ``[..., dh]`` float → ``(wire int8 [..., dh], scale fp32 [...])``,
    the JAX package's ``comm/quantize.quantize_blocks`` at block ``dh``:
    scale ``amax / 127``, all-zero rows get scale 1 (exact round trip),
    a NaN poisons its scale."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1)
    scale = torch.where(amax == 0, torch.ones_like(amax), amax / _INT8_MAX)
    q = torch.round(xf / scale[..., None])
    wire = q.clamp(-_INT8_MAX, _INT8_MAX).to(torch.int8)
    return wire, scale


def dequantize_kv(wire, scale, dtype: torch.dtype = torch.float32):
    """Invert :func:`quantize_kv`: ``wire`` int8 ``[..., dh]`` ×
    ``scale`` ``[...]`` → float ``[..., dh]``."""
    return (wire.float() * scale[..., None]).to(dtype)


class Cells(NamedTuple):
    """The cells of one write, planned once for every pool it writes
    (:func:`plan_cells`)."""
    idx: tuple                      # the index tuple, dropped cells redirected
    src: Optional[torch.Tensor]     # [n] the value row each cell takes
    live: Optional[torch.Tensor]    # [] bool: any cell kept
    first: tuple                    # ``idx`` narrowed to its first cell


def plan_cells(idx, keep=None) -> Cells:
    """The capture-safe stand-in for ``keep.nonzero()`` ahead of an index
    write over ``n`` candidate cells.  ``idx`` is a tuple of ``[n]`` index
    tensors, optionally led by ``slice(None)``s; ``keep`` ``[n]`` bool
    (None: every cell is kept).  A dropped cell is redirected to the first
    kept cell and takes that cell's value row, so the write puts every
    kept cell's own value and writes each duplicate with that same value:
    the ``nonzero`` write bit for bit, with no host sync and no shape set
    by the data.  With nothing kept every cell becomes cell 0, which is
    rewritten with what it holds.  Plan once per call and pass the plan
    to every :func:`write_cells` of that call."""
    idx = tuple(idx)
    if keep is None or keep.shape[0] == 0:
        return Cells(idx, None, None, ())
    n = keep.shape[0]
    first = torch.argmax(keep.to(torch.int32))       # the first True
    src = torch.where(keep, torch.arange(n, device=keep.device), first)
    live = keep.any()
    sel = tuple(i if isinstance(i, slice) else torch.where(live, i[src], 0)
                for i in idx)
    return Cells(sel, src, live,
                 tuple(i if isinstance(i, slice) else i[:1] for i in sel))


def write_cells(pools, values, idx, keep=None) -> None:
    """``pool[idx] = value`` for each (pool, value) pair, in place, over
    the cells ``keep`` ``[n]`` marks (every cell when None).  ``idx`` is
    an index tuple as :func:`plan_cells` takes, or its plan (then
    ``keep`` is None); each value holds the ``n`` cells on the axis the
    advanced index takes in ``pool[idx]``."""
    cells = idx if isinstance(idx, Cells) else plan_cells(idx, keep)
    ax = sum(isinstance(i, slice) for i in cells.idx)
    for pool, val in zip(pools, values):
        val = val.to(pool.dtype)
        if cells.src is not None:
            # one cell read back: what cell 0 holds, should nothing be kept
            val = torch.where(cells.live, val.index_select(ax, cells.src),
                              pool[cells.first])
        pool[cells.idx] = val


def scatter_kv_quantized(pool_k, pool_v, k_scale, v_scale, k, v, idx,
                         keep=None):
    """THE quantized write edge, in place: quantize float K/V per (token,
    group) and write wire and scales through the same index tuple, so a
    payload cell and its scale cell never desynchronize.  ``idx`` is an
    advanced-index tuple addressing ``(block, offset)`` cells (with a
    leading ``slice(None)`` when the pools carry the layer axis) or its
    :func:`plan_cells` plan; cells that ``keep`` leaves out drop."""
    qk, sk = quantize_kv(k)
    qv, sv = quantize_kv(v)
    write_cells((pool_k, pool_v, k_scale, v_scale), (qk, qv, sk, sv), idx,
                keep)


def prefix_block_hashes(tokens, block_size: int,
                        salt: bytes = b"") -> List[bytes]:
    """Chained SHA-256 digests of every FULL block of ``tokens`` (int64
    bytes, chained from ``salt``) — byte for byte the JAX package's, so
    a digest names the same causal prefix in both packages."""
    tokens = np.asarray(tokens, np.int64).reshape(-1)
    out: List[bytes] = []
    h = bytes(salt)
    for i in range(tokens.size // block_size):
        blk = tokens[i * block_size: (i + 1) * block_size]
        h = hashlib.sha256(h + blk.tobytes()).digest()
        out.append(h)
    return out


def chunk_salt(chunk_tokens: int) -> bytes:
    """The digest namespace of chunk-written pages."""
    return b"chunk:%d" % int(chunk_tokens)


class BlockManager:
    """Host-side ledger of the block pool: free list, per-block
    refcounts, and the prefix-hash table behind copy-on-write sharing.
    Pure bookkeeping, single-thread confined (the engine loop)."""

    def __init__(self, num_blocks: int, block_size: int):
        if num_blocks < 1:
            raise ValueError(f"num_blocks={num_blocks} must be positive")
        if block_size < 1:
            raise ValueError(f"block_size={block_size} must be positive")
        self.num_blocks = int(num_blocks)
        self.block_size = int(block_size)
        self._free = list(range(num_blocks - 1, -1, -1))   # pop -> 0 first
        self._ref: Dict[int, int] = {}
        self._hash_to_block: Dict[bytes, int] = {}
        self._block_to_hash: Dict[int, bytes] = {}
        self._pub_order: Dict[bytes, None] = {}         # newest at the end

    def alloc(self) -> Optional[int]:
        """Claim one free block (refcount 1), or None when exhausted."""
        if not self._free:
            return None
        blk = self._free.pop()
        self._ref[blk] = 1
        return blk

    def incref(self, blk: int) -> None:
        if blk not in self._ref:
            raise ValueError(f"block {blk} is not allocated")
        self._ref[blk] += 1

    def decref(self, blk: int) -> bool:
        """Drop one reference; frees (and unpublishes) the block when the
        count hits zero.  Returns True when it freed."""
        if blk not in self._ref:
            raise ValueError(f"block {blk} is not allocated")
        self._ref[blk] -= 1
        if self._ref[blk] > 0:
            return False
        del self._ref[blk]
        h = self._block_to_hash.pop(blk, None)
        if h is not None and self._hash_to_block.get(h) == blk:
            del self._hash_to_block[h]
            self._pub_order.pop(h, None)
        self._free.append(blk)
        return True

    def free_all(self, blocks: Sequence[int]) -> None:
        for blk in blocks:
            self.decref(blk)

    def lookup_prefix(self, chain_hash) -> Optional[int]:
        """Live block published under ``chain_hash``, or None."""
        return self._hash_to_block.get(chain_hash)

    def share_prefix(self, chain_hash) -> Optional[int]:
        """Map the published block for ``chain_hash`` into a new table
        (incref), or None on miss."""
        blk = self._hash_to_block.get(chain_hash)
        if blk is None:
            return None
        self.incref(blk)
        return blk

    def publish_prefix(self, chain_hash, blk: int) -> None:
        """Publish an immutable FULL block under its chain hash (last
        writer wins)."""
        if blk not in self._ref:
            raise ValueError(f"block {blk} is not allocated")
        self._hash_to_block[chain_hash] = blk
        self._block_to_hash[blk] = chain_hash
        self._pub_order.pop(chain_hash, None)
        self._pub_order[chain_hash] = None

    def digest_of(self, blk: int) -> Optional[bytes]:
        """The chain digest ``blk`` is currently published under, or
        None."""
        h = self._block_to_hash.get(blk)
        if h is not None and self._hash_to_block.get(h) == blk:
            return h
        return None

    def newest_digests(self, limit: int) -> List[bytes]:
        """The newest ``limit`` published chain digests, newest first."""
        if limit <= 0:
            return []
        out = list(self._pub_order.keys())[-limit:]
        out.reverse()
        return out

    def ensure_private(self, blk: int) -> Tuple[Optional[int], bool]:
        """Copy-on-write edge: ``(blk, False)`` at refcount 1; shared →
        move this table's reference onto a fresh block and return
        ``(new_blk, True)`` (the caller copies the payload), or ``(None,
        True)`` when the pool is exhausted."""
        if self._ref.get(blk, 0) <= 1:
            return blk, False
        fresh = self.alloc()
        if fresh is None:
            return None, True
        self._ref[blk] -= 1
        return fresh, True

    @property
    def n_free(self) -> int:
        return len(self._free)

    @property
    def n_in_use(self) -> int:
        return self.num_blocks - len(self._free)

    @property
    def n_shared(self) -> int:
        """Physical blocks saved by prefix sharing: the references beyond
        the first on every live block."""
        return sum(r - 1 for r in self._ref.values() if r > 1)

    def refcount(self, blk: int) -> int:
        return self._ref.get(blk, 0)


def _block_ids(block_ids, device) -> torch.Tensor:
    ids = torch.as_tensor(np.asarray(block_ids), dtype=torch.long,
                          device=device)
    if ids.ndim != 1:
        raise ValueError(
            f"block_ids must be a 1-D block list, got shape "
            f"{tuple(ids.shape)}")
    return ids


def gather_block_kv(pool_k, pool_v, block_ids):
    """Dereference an ordered block list into token-major K/V
    ``[L, len(block_ids)·block_size, kv_groups, dh]``."""
    ids = _block_ids(block_ids, pool_k.device)
    L, _, bs, g, dh = pool_k.shape
    n = ids.shape[0] * bs
    return (pool_k[:, ids].reshape(L, n, g, dh),
            pool_v[:, ids].reshape(L, n, g, dh))


def gather_block_scales(scale_pool, block_ids):
    """The scale-pool analog of :func:`gather_block_kv`:
    ``[L, len(block_ids)·block_size, kv_groups]``."""
    ids = _block_ids(block_ids, scale_pool.device)
    L, _, bs, g = scale_pool.shape
    return scale_pool[:, ids].reshape(L, ids.shape[0] * bs, g)


def _insert_cells(nb: int, write_ids, length, s: int, block_size: int,
                  device):
    """(kept time rows ``[s]`` bool, blocks, offsets) of a bucket of ``s``
    tokens scattered through ``write_ids`` — rows past ``length`` and rows
    of unmapped pages are left out (the JAX ``mode="drop"``).
    ``write_ids`` and ``length`` may be device tensors (a captured insert
    reads them in place)."""
    if isinstance(write_ids, torch.Tensor):
        wid = write_ids.to(device=device, dtype=torch.long)
    else:
        wid = torch.as_tensor(np.asarray(write_ids), dtype=torch.long,
                              device=device)
    t = torch.arange(s, device=device)
    blk = wid[t // block_size]
    keep = (t < length) & (blk < nb) & (blk >= 0)
    return keep, blk, t % block_size


def paged_insert_prefill(pool_k, pool_v, ks, vs, write_ids, length, *,
                         block_size: int) -> None:
    """Scatter a bucket-sized prefill cache ``[L, 1, S, g, dh]`` into the
    listed pool blocks, in place.  ``write_ids`` ``[ceil(S/block_size)]``
    maps each page of the bucket to its block; entries ``>= num_blocks``
    drop that page (prefix-shared blocks, the bucket's padding tail), and
    positions ``>= length`` drop one by one."""
    keep, blk, off = _insert_cells(pool_k.shape[1], write_ids, length,
                                   ks.shape[2], block_size, pool_k.device)
    write_cells((pool_k, pool_v), (ks[:, 0], vs[:, 0]),
                (slice(None), blk, off), keep)


def paged_insert_prefill_q(pool_k, pool_v, k_scale, v_scale, ks, vs,
                           write_ids, length, *, block_size: int) -> None:
    """The int8-pool form of :func:`paged_insert_prefill`: the float
    bucket cache is quantized per (token, group) at the write edge and
    wire and scales land in the same cells, with the same drops."""
    keep, blk, off = _insert_cells(pool_k.shape[1], write_ids, length,
                                   ks.shape[2], block_size, pool_k.device)
    scatter_kv_quantized(pool_k, pool_v, k_scale, v_scale, ks[:, 0],
                         vs[:, 0], (slice(None), blk, off), keep)
