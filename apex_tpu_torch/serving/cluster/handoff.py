"""KV-cache serialization (``apex_tpu/serving/cluster/handoff.py``, the
codec): per-token K/V ``[L, n, g, dh]`` (from
:func:`~apex_tpu_torch.models.generate.extract_kv`) → a JSON-able header
and byte blobs, and back.

The wire is byte-compatible with the JAX package's in both directions:
the same K/V give the same header and blobs, and each side decodes the
other's.  Wire dtypes:

- ``"raw"`` — the cache dtype's bytes as they are: bit-exact;
- ``"bf16"`` — an elementwise round-to-nearest-even cast (no-op for bf16
  caches);
- ``"int8"`` — block-scaled int8 over the flattened tensor
  (:mod:`apex_tpu_torch.comm.quantize`, blocks of 256), then the fp32
  scales.

The header names shape, cache dtype and wire dtype (and the int8 block),
so a decoder refuses a torn or mismatched handoff instead of
reinterpreting bytes.  :func:`decode_kv` returns CPU tensors in the
cache dtype.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from apex_tpu_torch.comm.quantize import dequantize_blocks, quantize_blocks

__all__ = ["WIRE_DTYPES", "encode_kv", "decode_kv", "wire_bytes"]

WIRE_DTYPES = ("raw", "bf16", "int8")

_DTYPES = {"float32": torch.float32, "float16": torch.float16,
           "bfloat16": torch.bfloat16}

_INT8_BLOCK = 256     # the comm/ gradient-collective default


def _tensor(x) -> torch.Tensor:
    """A CPU tensor of ``x`` (a tensor on any device, or a numpy array of
    float32/float16)."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu()
    return torch.from_numpy(np.ascontiguousarray(x))


def _bytes(t: torch.Tensor) -> bytes:
    """The tensor's elements in memory order (little-endian, as numpy's
    ``tobytes``)."""
    t = t.contiguous()
    return t.reshape(-1).view(torch.uint8).numpy().tobytes()


def _from_bytes(blob: bytes, dtype: torch.dtype) -> torch.Tensor:
    raw = torch.from_numpy(np.frombuffer(blob, np.uint8).copy())
    return raw.view(dtype)


def encode_kv(k, v, *, wire_dtype: str = "raw",
              block: int = _INT8_BLOCK) -> Tuple[dict, List[bytes]]:
    """Serialize per-token K/V ``[L, n, g, dh]`` → ``(header, blobs)``."""
    if wire_dtype not in WIRE_DTYPES:
        raise ValueError(
            f"wire_dtype={wire_dtype!r}: expected one of {WIRE_DTYPES}")
    k, v = _tensor(k), _tensor(v)
    if k.ndim != 4 or k.shape != v.shape:
        raise ValueError(f"expected matching [L, n, g, dh] K/V, got "
                         f"{tuple(k.shape)} / {tuple(v.shape)}")
    name = str(k.dtype).replace("torch.", "")
    if name not in _DTYPES or v.dtype != k.dtype:
        raise ValueError(f"unsupported cache dtype {name!r} "
                         f"(expected one of {sorted(_DTYPES)})")
    header = {"kind": "kv", "shape": list(k.shape), "cache_dtype": name,
              "wire_dtype": wire_dtype}
    if wire_dtype == "raw":
        return header, [_bytes(k), _bytes(v)]
    if wire_dtype == "bf16":
        return header, [_bytes(k.to(torch.bfloat16)),
                        _bytes(v.to(torch.bfloat16))]
    header["block"] = int(block)
    blobs: List[bytes] = []
    for x in (k, v):
        wire, scales = quantize_blocks(x.float().reshape(-1), "int8", block)
        blobs.append(_bytes(wire))
        blobs.append(_bytes(scales.float()))
    return header, blobs


def decode_kv(header: dict, blobs: List[bytes]
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Invert :func:`encode_kv` → ``(k, v)`` CPU tensors in the original
    cache dtype and shape.  Raises ``ValueError`` on a header and blobs
    that do not agree."""
    try:
        shape = tuple(int(s) for s in header["shape"])
        cache_dtype = _DTYPES[header["cache_dtype"]]
        wire_dtype = header["wire_dtype"]
    except (KeyError, TypeError, ValueError) as e:
        raise ValueError(f"malformed KV header: {e}") from e
    if len(shape) != 4 or any(s < 1 for s in shape):
        raise ValueError(f"malformed KV shape {shape}")
    n_elem = int(np.prod(shape))
    if wire_dtype in ("raw", "bf16"):
        if len(blobs) != 2:
            raise ValueError(
                f"{wire_dtype} handoff needs 2 blobs, got {len(blobs)}")
        wdt = cache_dtype if wire_dtype == "raw" else torch.bfloat16
        itemsize = torch.empty((), dtype=wdt).element_size()
        out = []
        for blob in blobs:
            if len(blob) != n_elem * itemsize:
                raise ValueError(f"blob holds {len(blob)} bytes, header "
                                 f"declares {n_elem * itemsize}")
            out.append(_from_bytes(blob, wdt).reshape(shape).to(cache_dtype))
        return out[0], out[1]
    if wire_dtype != "int8":
        raise ValueError(f"unknown wire_dtype {wire_dtype!r}")
    if len(blobs) != 4:
        raise ValueError(f"int8 handoff needs 4 blobs, got {len(blobs)}")
    block = int(header.get("block", _INT8_BLOCK))
    if block < 1:
        raise ValueError(f"malformed block {block}")
    n_pad = -(-n_elem // block) * block
    n_scales = n_pad // block
    out = []
    for wire_b, scale_b in ((blobs[0], blobs[1]), (blobs[2], blobs[3])):
        if len(wire_b) != n_pad or len(scale_b) != n_scales * 4:
            raise ValueError(
                f"int8 blobs hold {len(wire_b)}/{len(scale_b)} bytes, "
                f"header declares {n_pad}/{n_scales * 4}")
        flat = dequantize_blocks(_from_bytes(wire_b, torch.int8),
                                 _from_bytes(scale_b, torch.float32), block,
                                 n_elem)
        out.append(flat.reshape(shape).to(cache_dtype))
    return out[0], out[1]


def wire_bytes(blobs: List[bytes]) -> int:
    """Payload bytes of an encoded handoff."""
    return sum(len(b) for b in blobs)
