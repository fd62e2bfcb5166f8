"""Build and load the hand-written CUDA kernels.

At first use the sources under ``seldon_core_tpu_torch/csrc`` are compiled
by ``nvcc`` for ``sm_90a`` (one process per source, all started together,
then one link) into a shared library with a plain C interface under
``build/torch_kernels/`` at the repository root, and loaded with
``ctypes``.  The library's name carries a hash of the sources and flags, so
an edited source is rebuilt and a stale library is never loaded.  A failed
build raises: there is no fallback.

Every C entry returns the launch's ``cudaError_t``; :func:`check` raises
on anything but 0.  ``LAUNCHES`` counts kernel launches per wrapper (a
launch made anywhere adds one), so a run can show that its path went
through the kernels.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC = PKG_DIR / "csrc"
SOURCES = ("flash_attention.cu", "paged_attention.cu")
HEADERS = ("common.cuh",)
BUILD_DIR = PKG_DIR.parent / "build" / "torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
)

# dtype codes shared with csrc/common.cuh (sct::DType)
DTYPE_CODES = {
    torch.float32: 0,
    torch.float16: 1,
    torch.bfloat16: 2,
    torch.int8: 3,
}

LAUNCHES = {"flash_attention": 0, "paged_decode_attention": 0}

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_F = ctypes.c_float
_ARGTYPES = {
    "sct_flash_attention_fwd": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I]
    + [_LL] * 12
    + [_F, _I, _P],
    "sct_paged_decode_attention": [_P] * 8 + [_I] * 10 + [_F, _P],
}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
build_seconds: float | None = None  # nvcc wall time of this process's build


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    found = shutil.which("nvcc") or str(Path(home) / "bin" / "nvcc")
    if not Path(found).exists():
        raise RuntimeError(
            "nvcc not found (PATH, CUDA_HOME or /usr/local/cuda/bin): the CUDA "
            "kernels of seldon_core_tpu_torch are built from source at first use"
        )
    return found


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def _compile(lib_path: Path) -> None:
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = lib_path.stem
    objs = [BUILD_DIR / f"{tag}.{Path(s).stem}.o" for s in SOURCES]
    procs = [
        subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", str(CSRC / src), "-o", str(obj)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        )
        for src, obj in zip(SOURCES, objs)
    ]
    errors = []
    for src, p in zip(SOURCES, procs):
        out, _ = p.communicate()
        if p.returncode:
            errors.append(f"{src}:\n{out.decode(errors='replace')}")
    if errors:
        raise RuntimeError("nvcc failed:\n" + "\n".join(errors))
    tmp = lib_path.with_suffix(f".{os.getpid()}.tmp")
    link = subprocess.run(
        [nvcc, *NVCC_FLAGS, "-shared", *map(str, objs), "-o", str(tmp)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
    )
    if link.returncode:
        raise RuntimeError("nvcc link failed:\n" + link.stdout.decode(errors="replace"))
    os.replace(tmp, lib_path)  # atomic: a concurrent loader never sees half a file


def library() -> ctypes.CDLL:
    """The kernels' shared library, built on first call."""
    global _lib, build_seconds
    with _lock:
        if _lib is None:
            lib_path = BUILD_DIR / f"libsct_torch_kernels_{_digest()}.so"
            if not lib_path.exists():
                t0 = time.perf_counter()
                _compile(lib_path)
                build_seconds = time.perf_counter() - t0
            lib = ctypes.CDLL(str(lib_path))
            for fn, argtypes in _ARGTYPES.items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
            lib.sct_error_string.argtypes = [ctypes.c_int]
            lib.sct_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def check(code: int, what: str) -> None:
    """Raise when a C entry reports a CUDA error."""
    if code:
        msg = library().sct_error_string(code).decode(errors="replace")
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")


def stream_handle(device: torch.device) -> int:
    """The current PyTorch stream of ``device`` as an int for ctypes."""
    return torch.cuda.current_stream(device).cuda_stream
