"""Serving pieces of the port (``apex_tpu/serving``): the paged KV pool
and its block ledger, bucketing, SLO classes, the LoRA adapter pool, the
compiled ladder (:class:`CompileCache`, :func:`warmup_ladder`), and the
continuous-batching :class:`ServingEngine`.

The names load on first use: ``models/generate.py`` imports
``serving.paged_cache``, and the engine imports ``models/generate.py``.
"""

import importlib

_EXPORTS = {
    "AdapterPool": "adapter_pool",
    "CompileCache": "compile_cache", "warmup_ladder": "compile_cache",
    "ServingEngine": "engine", "Request": "engine", "Response": "engine",
    "BlockManager": "paged_cache", "dequantize_kv": "paged_cache",
    "init_paged_pool": "paged_cache", "quantize_kv": "paged_cache",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name):
    if name in _EXPORTS:
        mod = importlib.import_module(f"{__name__}.{_EXPORTS[name]}")
        return getattr(mod, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
