"""Build, load and launch the port's hand-written CUDA kernels
(the role ``apex_tpu/ops/_pallas_utils.py`` plays for the Pallas ones).

Each source ``apex_tpu_torch/csrc/<name>.cu`` exposes a plain C entry
point (no PyTorch headers, so ``nvcc`` takes seconds, not minutes).  At
first use it is compiled with

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -o build/apex_tpu_torch/<name>-<hash>.so <name>.cu

into the repository's ``build/apex_tpu_torch/`` directory (git-ignored),
keyed on a hash of the source, every ``csrc/*.cuh`` header and the
flags, and loaded with ``ctypes``.  :func:`build_all`, :func:`lib_path`
and :func:`load_built` take another directory (the serving engine's
``compile_cache_dir=`` keeps its kernel libraries in its own, so a
primed directory starts with no ``nvcc`` run), and :data:`NVCC_RUNS`
lists every source this process handed to ``nvcc``.
:func:`build_all` starts one ``nvcc`` per source at once.  The Hopper kernels (K2, K6, K7, row 5's
16-bit kernel and rows 9 and 10's tensor-core routes) find the CUDA
driver's ``cuTensorMapEncodeTiled`` through ``cudaGetDriverEntryPoint``,
so no library links ``-lcuda``.

Every pointer and the stream pass as ``c_void_p`` (a bare Python int
would be cut to 32 bits).  The C entry returns ``cudaGetLastError()``
after its launch; :class:`Kernel` raises on anything but 0, so a launch
the card refuses (too much shared memory, a bad grid) never goes
unnoticed.  Each kernel keeps a plain integer ``launches`` count, raised
by one per launch and nowhere else.

    python -m apex_tpu_torch.ops._kernel_utils [source.cu ...]

compiles each source (default: the Hopper kernels' sources: K2's,
K6/K7's, row 5's, row 9's and row 10's) once more with the
build's flags plus ``-Xptxas -v`` into ``build/apex_tpu_torch/report/``,
prints what ``ptxas`` says of every kernel (registers, shared memory,
spills), and beside it how many ``HGMMA`` (``wgmma``) and ``UTMALDG``
(TMA load) instructions ``cuobjdump --dump-sass`` lists in each kernel.
Needs the CUDA toolkit; no card.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import sys
import threading
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import torch

__all__ = ["Kernel", "KERNELS", "register", "build_all", "library",
           "lib_path", "ptxas_report", "sass_counts", "demangle",
           "reset_launch_counts", "launch_counts", "ptr", "stream_ptr",
           "dtype_code", "check_cuda_operands", "check_aligned", "aligned",
           "tma_strides_ok", "ATTR_KEYS", "hopper_attrs", "sm_count", "CSRC",
           "BUILD_DIR", "load_built", "NVCC_RUNS"]

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build" / \
    "apex_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-lineinfo")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
# source -> the file its loaded library came from
_lib_files: Dict[str, Path] = {}
# every source this process started nvcc on, in order
NVCC_RUNS: List[str] = []


def _cuda_tool(name: str) -> str:
    for cand in (shutil.which(name), f"/usr/local/cuda/bin/{name}"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        f"{name} not found (PATH or /usr/local/cuda/bin): the port's CUDA "
        "kernels are built from apex_tpu_torch/csrc at first use")


def lib_path(source: str, directory=None) -> Path:
    """Where the library of one source is built under ``directory``
    (default :data:`BUILD_DIR`); its name carries the build key."""
    h = hashlib.sha256()
    # every header, whether the source includes it or not: a header added
    # later cannot leave a stale library behind
    headers = sorted(p.name for p in CSRC.glob("*.cuh"))
    for name in [source] + headers:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    stem = source.rsplit(".", 1)[0]
    return Path(directory or BUILD_DIR) / f"{stem}-{h.hexdigest()[:16]}.so"


def _start_build(source: str, directory: Path):
    """Start ``nvcc`` on one source unless its library is already built
    in ``directory``; returns ``(process, temporary path, final path)`` or
    ``None``."""
    out = lib_path(source, directory)
    if out.exists():
        return None
    directory.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp.so")
    have = _lib_files.get(source)
    if have is not None and have.name == out.name and have.is_file():
        # the same build key is loaded from another directory: copy it
        shutil.copyfile(have, tmp)
        os.replace(tmp, out)
        return None
    NVCC_RUNS.append(source)
    cmd = [_cuda_tool("nvcc"), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
           str(CSRC / source)]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def build_all(sources: Optional[Iterable[str]] = None,
              directory=None) -> List[str]:
    """Compile every listed source (default: all kernels' sources) with
    one ``nvcc`` each, started together, into ``directory`` (default
    :data:`BUILD_DIR`), and load them.  A source whose library is loaded
    already is built only if ``directory`` lacks its file.  Returns the
    sources compiled now (not found already built).  Every ``nvcc`` is
    waited for before a failure is raised."""
    if sources is None:
        sources = sorted({k.source for k in KERNELS.values()})
    directory = Path(directory or BUILD_DIR)
    with _lock:
        todo = [s for s in sources
                if s not in _libs or not lib_path(s, directory).exists()]
        started = [(s, _start_build(s, directory)) for s in todo]
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
            if s not in _libs:
                _load(s, lib_path(s, directory))
    return [s for s, b in started if b is not None]


def _load(source: str, path: Path) -> None:
    _libs[source] = ctypes.CDLL(str(path))
    _lib_files[source] = path


def load_built(source: str, directory) -> bool:
    """Whether ``directory`` holds a loadable library of ``source`` at the
    current build key; loads it (no ``nvcc``) unless one is loaded
    already, in which case the file counts when its name (which carries
    the build key) is the loaded one's.  A missing file, or one that does
    not load, is ``False``."""
    path = lib_path(source, directory)
    if not path.is_file():
        return False
    with _lock:
        have = _lib_files.get(source)
        if have is not None:
            # the file name carries the build key
            return have.name == path.name
        try:
            _load(source, path)
        except OSError:
            return False
    return True


def library(source: str) -> ctypes.CDLL:
    """The loaded library of one source, built first if need be."""
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


def tma_strides_ok(shape: Sequence[int], itemsize: int) -> bool:
    """Whether a TMA tensor map can describe a contiguous tensor of this
    shape and element size: every row stride (the bytes of the axes
    inside it) a multiple of 16 below 2**40.  With a 16-byte-aligned base
    (:func:`aligned`) these are the maps' only conditions on a tensor."""
    stride = itemsize
    for d in reversed(tuple(shape)[1:]):
        stride *= int(d)
        if stride % 16 or stride >= 2 ** 40:
            return False
    return True


# what sm90::kernel_attrs reports of one Hopper kernel
ATTR_KEYS = ("registers", "smem_bytes", "ctas_per_sm", "spill_bytes")


def hopper_attrs(source: str, symbol: str, *args: int) -> dict:
    """``{"registers", "smem_bytes", "ctas_per_sm", "spill_bytes"}`` of
    one Hopper kernel, from a source's ``<symbol>(int args..., int*
    out)`` entry (which calls ``sm90::kernel_attrs``).  Needs the card."""
    vals = (ctypes.c_int * len(ATTR_KEYS))()
    err = getattr(library(source), symbol)(
        *(ctypes.c_int(a) for a in args), vals)
    if err != 0:
        raise RuntimeError(f"{symbol}{args}: cudaError {err}")
    return dict(zip(ATTR_KEYS, vals))


@functools.lru_cache(maxsize=None)
def sm_count(device: torch.device) -> int:
    """The SMs of a CUDA device (the launch planners' card size)."""
    return torch.cuda.get_device_properties(device).multi_processor_count


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
            fn = getattr(library(self.source), self.symbol)
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


# ---- what ptxas and cuobjdump say of the built kernels ----

REPORT_SOURCES = ("flash_attention.cu", "flash_attention_bwd.cu",
                  "flash_attention_bwd_short.cu", "grouped_matmul.cu",
                  "dense_int8.cu")
SASS_OPS = ("HGMMA", "UTMALDG")


def demangle(names: List[str]) -> Dict[str, str]:
    """Mangled → readable names (``cu++filt``; unchanged without it)."""
    try:
        tool = _cuda_tool("cu++filt")
    except RuntimeError:
        return {n: n for n in names}
    out = subprocess.run([tool], input="\n".join(names), text=True,
                         capture_output=True, check=True).stdout.split("\n")
    return dict(zip(names, out))


def ptxas_report(source: str) -> Tuple[Dict[str, dict], List[str]]:
    """``({mangled kernel: {"registers", "smem", "stack", "spill_stores",
    "spill_loads"}}, notes)`` from ``nvcc -Xptxas -v`` on one source; the
    notes are ptxas's warnings and performance remarks (a serialized
    ``wgmma``, say)."""
    out_dir = BUILD_DIR / "report"
    out_dir.mkdir(parents=True, exist_ok=True)
    cmd = [_cuda_tool("nvcc"), *NVCC_FLAGS, "-Xptxas", "-v", "-I", str(CSRC),
           "-o", str(out_dir / source.replace(".cu", ".so")),
           str(CSRC / source)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed on csrc/{source}:\n{res.stderr}")
    report, notes, cur = {}, [], None
    for line in (res.stdout + res.stderr).splitlines():
        if "warning" in line or "Performance" in line:
            notes.append(line.strip())
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            cur = report.setdefault(m.group(1), {})
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            cur.update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                       spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["registers"] = int(m.group(1))
            sm = re.search(r"(\d+) bytes smem", line)
            cur["smem"] = int(sm.group(1)) if sm else 0
    return report, notes


def sass_counts(lib: Path) -> Dict[str, Dict[str, int]]:
    """``{mangled kernel: {"HGMMA": n, "UTMALDG": n}}`` over the machine
    code of one built library."""
    res = subprocess.run([_cuda_tool("cuobjdump"), "--dump-sass", str(lib)],
                         capture_output=True, text=True, check=True)
    counts, cur = {}, None
    for line in res.stdout.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            cur = counts.setdefault(m.group(1), dict.fromkeys(SASS_OPS, 0))
            continue
        if cur is not None:
            for op in SASS_OPS:
                if re.search(rf"\b{op}\b", line):
                    cur[op] += 1
    return counts


def main(argv: List[str]) -> int:
    sources = argv or list(REPORT_SOURCES)
    for source in sources:
        rep, notes = ptxas_report(source)
        sass = sass_counts(BUILD_DIR / "report" / source.replace(".cu", ".so"))
        names = demangle(sorted(set(rep) | set(sass)))
        print(f"== csrc/{source}")
        for line in notes:
            print(line)
        for k in sorted(rep):
            r, s = rep[k], sass.get(k, {})
            print(f"{names[k]}: {r.get('registers')} registers, "
                  f"{r.get('smem')} bytes static smem, stack "
                  f"{r.get('stack')}, spill stores {r.get('spill_stores')}, "
                  f"spill loads {r.get('spill_loads')}; SASS "
                  + ", ".join(f"{op} {s.get(op, 0)}" for op in SASS_OPS))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
