"""Device accounting the serving engine reports into
(``apex_tpu/observability/device.py``).

:func:`sample_device_memory` reads the CUDA caching allocator
(``torch.cuda.memory_allocated`` / ``max_memory_allocated``) into the
``hbm.bytes_in_use`` / ``hbm.peak_bytes`` gauges.  :class:`compile_label`
names a region for the JAX package's recompile tracker; eager PyTorch
compiles nothing there, so it is a no-op kept for the call sites.
"""

from __future__ import annotations

from typing import Optional

import torch

from apex_tpu_torch.observability import metrics as _metrics

__all__ = ["compile_label", "sample_device_memory"]


class compile_label:
    """No-op region label (nothing is traced or compiled per call)."""

    def __init__(self, label: str):
        self.label = label

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def sample_device_memory(emit: bool = True) -> Optional[dict]:
    """``{"bytes_in_use", "peak_bytes", "devices"}`` of the current CUDA
    device, or None without one; with ``emit`` and a configured registry
    the two byte counts also land in gauges."""
    if not torch.cuda.is_available():
        return None
    out = {"bytes_in_use": int(torch.cuda.memory_allocated()),
           "peak_bytes": int(torch.cuda.max_memory_allocated()),
           "devices": 1}
    reg = _metrics.registry()
    if emit and reg is not None:
        reg.gauge("hbm.bytes_in_use").set(out["bytes_in_use"])
        reg.gauge("hbm.peak_bytes").set(out["peak_bytes"])
    return out
