"""Device resolution for the port (``apex_tpu/utils/registry.py``'s
``on_tpu`` gate, reduced to what a CUDA port needs).

The JAX package picks a Pallas kernel or an XLA composition by platform.
Here the tensor decides: a CUDA tensor goes to the hand-written kernel,
a CPU tensor to the plain PyTorch version.  Entry points that create
tensors resolve their device with :func:`resolve_device`, which defaults
to the card and refuses to carry on quietly on the CPU.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

__all__ = ["resolve_device", "on_cuda", "check_backend"]


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``None`` → ``cuda``; raise when that card is absent.  An explicit
    ``"cpu"`` (the tests) is honoured as given."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "apex_tpu_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run the plain PyTorch path")
    return dev


def on_cuda(t: torch.Tensor) -> bool:
    """True when ``t`` lives on a CUDA device (the kernel route)."""
    return t.device.type == "cuda"


def check_backend(backend: Optional[str]) -> Optional[str]:
    """Validate an op's ``backend=`` pin: ``None`` (kernel for CUDA
    tensors, plain version for CPU tensors) or ``"reference"`` (the plain
    version wherever the tensors are)."""
    if backend not in (None, "reference"):
        raise ValueError(
            f"backend={backend!r}: expected None or 'reference'")
    return backend
