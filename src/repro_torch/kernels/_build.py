"""Build and load the hand-written CUDA kernels (``csrc/*.cu``).

Each source is compiled by ``nvcc`` for Hopper (``sm_90a``) into its own
shared library with a plain C interface and loaded with ``ctypes``:
every pointer and the stream travel as ``c_void_p``, sizes as ``c_int``,
and each C entry point returns ``cudaGetLastError()`` right after its
launch, which ``check`` turns into an exception.  No PyTorch headers are
involved, so a build takes seconds.

The first call that needs a kernel builds all of them at once, one
``nvcc`` per source started together.  Libraries are named by a hash of
their source, the ``csrc/`` headers it includes and the flags, and go to
``build/repro_torch/`` at the root of the checkout (listed in
``.gitignore``); a changed source or header never loads a stale library.
Nothing builds at import time.

``LAUNCHES`` counts kernel launches by kernel name; each wrapper adds
one where it launches its kernel and nowhere else, so a run can show
that its main path went through the kernels.

Given tensors on the meta device (a plan traced by
``launch.op_analysis``), a wrapper launches nothing: it returns empty
outputs of its kernel's shapes and passes the bytes its kernel moves
(each input read once, each output written once) to ``charge``, which
hands them to every meter in ``METERS``.
"""
from __future__ import annotations

import collections
import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
SOURCES = ("pq_lookup", "l2_dist", "fused_traversal", "topk_merge")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)

LAUNCHES: collections.Counter = collections.Counter()

_LOCK = threading.Lock()
_LIBS: dict[str, ctypes.CDLL] = {}  # guarded by _LOCK


def reset_launches() -> None:
    LAUNCHES.clear()


METERS: list = []  # callables (kernel name, bytes), while an op_analysis meter runs


def charge(name: str, *tensors) -> None:
    """A kernel's bytes on the meta device: the given tensors' (its inputs
    as read, its outputs as written), to every meter in ``METERS``."""
    n = sum(t.numel() * t.element_size() for t in tensors)
    for meter in METERS:
        meter(name, n)


def is_meta(t) -> bool:
    return t.device.type == "meta"


def _nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found: the CUDA kernels build only where the "
                           "CUDA toolkit is installed")
    return found


_INCLUDE = re.compile(rb'^\s*#\s*include\s*"([^"]+)"', re.MULTILINE)


def source_tag(name: str, csrc: Path = CSRC) -> str:
    """A hash of ``csrc/<name>.cu``, of every header under ``csrc`` that it
    includes (``#include "..."``, followed transitively) and of the flags:
    a changed source or header never loads a stale library."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    seen, todo = set(), [f"{name}.cu"]
    while todo:
        rel = todo.pop()
        if rel in seen:
            continue
        seen.add(rel)
        text = (csrc / rel).read_bytes()
        h.update(rel.encode() + b"\0" + text + b"\0")
        todo.extend(inc.decode() for inc in _INCLUDE.findall(text)
                    if (csrc / inc.decode()).is_file())
    return h.hexdigest()[:16]


def _lib_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}-{source_tag(name)}.so"


def build_all(extra_flags: tuple[str, ...] = ()) -> dict[str, str]:
    """Compile every missing library in parallel; return nvcc's output per
    source (``-Xptxas -v`` in ``extra_flags`` prints registers and spills).
    Raises with the compiler's output if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for name in SOURCES:
        out = _lib_path(name)
        if out.exists() and not extra_flags:
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, *extra_flags, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), tmp, out)
    logs, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(name)
        else:
            os.replace(tmp, out)  # atomic: a concurrent build process never sees a partial file
    if failed:
        raise RuntimeError("nvcc failed for " + ", ".join(failed) + ":\n"
                           + "\n".join(logs[n] for n in failed))
    return logs


def library(name: str) -> ctypes.CDLL:
    """The loaded library of one kernel source, building all on first use."""
    with _LOCK:
        if name not in _LIBS:
            path = _lib_path(name)
            if not path.exists():
                build_all()
            _LIBS[name] = ctypes.CDLL(str(path))
        return _LIBS[name]


@functools.cache
def entry(name: str, symbol: str, n_ptrs: int, n_ints: int, stream: bool = True):
    """A C entry point taking ``n_ptrs`` pointers, ``n_ints`` ints and (if
    ``stream``) the stream, returning an int: a launch's CUDA error code."""
    fn = getattr(library(name), symbol)
    fn.argtypes = ([ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * n_ints
                   + [ctypes.c_void_p] * stream)
    fn.restype = ctypes.c_int
    return fn


def check(err: int, what: str) -> None:
    """Raise if a launch reported a CUDA error."""
    if err != 0:
        lib = library(SOURCES[0])
        lib.repro_cuda_error_string.restype = ctypes.c_char_p
        lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
        msg = lib.repro_cuda_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")


def stream_ptr(tensor) -> int:
    """PyTorch's current stream, as a raw handle, for a launch on the
    tensor's device — which must be the current device, since the C entry
    points launch on the current device."""
    import torch

    if tensor.device.index is not None and tensor.device.index != torch.cuda.current_device():
        raise ValueError(f"tensor on {tensor.device} but the current device is "
                         f"cuda:{torch.cuda.current_device()}")
    return torch.cuda.current_stream(tensor.device).cuda_stream


def ptr(tensor) -> int | None:
    """Device pointer of a tensor (None for an empty one)."""
    return tensor.data_ptr() if tensor.numel() else None
