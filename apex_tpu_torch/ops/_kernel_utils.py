"""Build, load and launch the port's hand-written CUDA kernels
(the role ``apex_tpu/ops/_pallas_utils.py`` plays for the Pallas ones).

Each source ``apex_tpu_torch/csrc/<name>.cu`` exposes a plain C entry
point (no PyTorch headers, so ``nvcc`` takes seconds, not minutes).  At
first use it is compiled with

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -o build/apex_tpu_torch/<name>-<hash>.so <name>.cu

into the repository's ``build/apex_tpu_torch/`` directory (git-ignored),
keyed on a hash of the source and the shared headers, and loaded with
``ctypes``.  :func:`build_all` starts one ``nvcc`` per source at once.

Every pointer and the stream pass as ``c_void_p`` (a bare Python int
would be cut to 32 bits).  The C entry returns ``cudaGetLastError()``
after its launch; :class:`Kernel` raises on anything but 0, so a launch
the card refuses (too much shared memory, a bad grid) never goes
unnoticed.  Each kernel keeps a plain integer ``launches`` count, raised
by one per launch and nowhere else.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Sequence

import torch

__all__ = ["Kernel", "KERNELS", "register", "build_all",
           "reset_launch_counts", "launch_counts", "ptr", "stream_ptr",
           "dtype_code", "check_cuda_operands", "check_aligned", "aligned",
           "CSRC",
           "BUILD_DIR"]

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build" / \
    "apex_tpu_torch"
_COMMON = ("common.cuh", "paged_tile.cuh", "flash_bwd_tile.cuh",
           "mma_tile.cuh")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-lineinfo")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (PATH or /usr/local/cuda/bin): the port's CUDA "
        "kernels are built from apex_tpu_torch/csrc at first use")


def _lib_path(source: str) -> Path:
    h = hashlib.sha256()
    for name in (source,) + _COMMON:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    stem = source.rsplit(".", 1)[0]
    return BUILD_DIR / f"{stem}-{h.hexdigest()[:16]}.so"


def _start_build(source: str):
    """Start ``nvcc`` on one source unless its library is already built;
    returns ``(process, temporary path, final path)`` or ``None``."""
    out = _lib_path(source)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp.so")
    cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
           str(CSRC / source)]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def build_all(sources: Optional[Iterable[str]] = None) -> List[str]:
    """Compile every listed source (default: all kernels' sources) with
    one ``nvcc`` each, started together, and load them.  Returns the
    sources compiled now (not found already built).  Every ``nvcc`` is
    waited for before a failure is raised."""
    if sources is None:
        sources = sorted({k.source for k in KERNELS.values()})
    with _lock:
        todo = [s for s in sources if s not in _libs]
        started = [(s, _start_build(s)) for s in todo]
        logs = {s: b[0].communicate()[0] for s, b in started if b}
        for s, b in started:
            if b is not None:
                proc, tmp, out = b
                if proc.returncode != 0:
                    raise RuntimeError(
                        f"nvcc failed on csrc/{s} (exit {proc.returncode}):"
                        f"\n{logs[s]}")
                # atomic: a concurrent build in another process sees all
                # or none of the library
                os.replace(tmp, out)
            _libs[s] = ctypes.CDLL(str(_lib_path(s)))
    return [s for s, b in started if b is not None]


def _lib(source: str) -> ctypes.CDLL:
    lib = _libs.get(source)
    if lib is None:
        build_all([source])
        lib = _libs[source]
    return lib


# element-type codes shared with csrc/common.cuh (enum ApexDtype)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def dtype_code(t: torch.Tensor) -> int:
    try:
        return DTYPE_CODES[t.dtype]
    except KeyError:
        raise TypeError(
            f"the CUDA kernels take float32, bfloat16 or float16 tensors, "
            f"got {t.dtype}") from None


def check_cuda_operands(name: str, *tensors: Optional[torch.Tensor]) -> None:
    """Every operand on one CUDA device and contiguous — the layout the
    kernels index by hand."""
    dev = None
    for t in tensors:
        if t is None:
            continue
        if t.device.type != "cuda":
            raise ValueError(f"{name}: operand on {t.device}, expected cuda")
        if dev is not None and t.device != dev:
            raise ValueError(f"{name}: operands on {dev} and {t.device}")
        dev = t.device
        if not t.is_contiguous():
            raise ValueError(f"{name}: operands must be contiguous")


def check_aligned(name: str, *tensors: torch.Tensor) -> None:
    """Operands a kernel reads or writes with 16-byte vector accesses."""
    for t in tensors:
        if t.data_ptr() % 16:
            raise ValueError(
                f"{name}: operand at {t.data_ptr():#x} is not 16-byte "
                "aligned; pass a fresh contiguous tensor")


def aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous at a 16-byte-aligned address (a row view may not
    be), for the kernels that load 16 bytes at a time."""
    t = t.contiguous()
    return t.clone() if t.data_ptr() % 16 else t


def ptr(t: Optional[torch.Tensor]) -> ctypes.c_void_p:
    """Device pointer of ``t`` (``NULL`` for ``None``)."""
    return ctypes.c_void_p(0 if t is None else t.data_ptr())


def stream_ptr(device: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


class Kernel:
    """One C entry point of one source: typed once, launched by call.

    ``argtypes`` lists the C types after which the stream follows as the
    last argument.  Calling raises when the entry returns a non-zero
    CUDA error and otherwise adds one to ``launches``."""

    def __init__(self, name: str, source: str, symbol: str,
                 argtypes: Sequence, replaces: str):
        self.name = name
        self.source = source
        self.symbol = symbol
        self.argtypes = list(argtypes) + [ctypes.c_void_p]
        self.replaces = replaces
        self.launches = 0
        self._fn = None

    def _entry(self):
        if self._fn is None:
            fn = getattr(_lib(self.source), self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            self._fn = fn
        return self._fn

    def __call__(self, device: torch.device, *args) -> None:
        fn = self._entry()
        with torch.cuda.device(device):
            err = fn(*args, stream_ptr(device))
        if err != 0:
            raise RuntimeError(
                f"kernel {self.name} ({self.source}:{self.symbol}) failed "
                f"to launch: cudaError {err}")
        self.launches += 1


KERNELS: Dict[str, Kernel] = {}


def register(kernel: Kernel) -> Kernel:
    KERNELS[kernel.name] = kernel
    return kernel


def reset_launch_counts() -> None:
    for k in KERNELS.values():
        k.launches = 0


def launch_counts() -> Dict[str, int]:
    return {name: k.launches for name, k in KERNELS.items()}
