"""Build and load the hand-written CUDA kernels.

At first use the sources under ``seldon_core_tpu_torch/csrc`` are compiled
by ``nvcc`` for ``sm_90a`` (one process per source, all started together,
then one link) into a shared library with a plain C interface under
``build/torch_kernels/`` at the repository root, and loaded with
``ctypes``.  The library's name carries a hash of the sources and flags, so
an edited source is rebuilt and a stale library is never loaded.  A failed
build raises: there is no fallback.  ``ptxas -v`` reports each kernel's
registers, shared memory and spills into a log beside the library;
:func:`kernel_report` reads it back, with the count of tensor-core
instructions in each kernel's SASS.

Every C entry returns the launch's ``cudaError_t``; :func:`check` raises
on anything but 0.  ``LAUNCHES`` counts kernel launches per wrapper (a
launch made anywhere adds one), so a run can show that its path went
through the kernels; ``PAGED_LAUNCHES_BY_L`` splits the paged kernel's
count by its query positions per slot (1 in a decode step, ``1 +
spec_draft`` in a speculative verify pass), and ``LAUNCHES_BY_D`` splits
both kernels' counts by head dim (``"name@D"``).  A wrapper called while a CUDA
graph is captured launches nothing: :func:`take_captured` moves what the
capture counted into the graph's record, and each replay adds it back
(:func:`add_launches`), so the counts stay real launches.
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import re
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
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# dtype codes shared with csrc/common.cuh (sct::DType)
DTYPE_CODES = {
    torch.float32: 0,
    torch.float16: 1,
    torch.bfloat16: 2,
    torch.int8: 3,
}

LAUNCHES = {"flash_attention": 0, "paged_decode_attention": 0}
PAGED_LAUNCHES_BY_L: collections.Counter = collections.Counter()
LAUNCHES_BY_D: collections.Counter = collections.Counter()

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_F = ctypes.c_float
_ARGTYPES = {
    "sct_flash_attention_fwd": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I]
    + [_LL] * 12
    + [_F, _I, _P],
    "sct_paged_decode_attention": [_P] * 10 + [_I] * 12 + [_F, _P],
}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
build_seconds: float | None = None  # nvcc wall time of this process's build


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0
    PAGED_LAUNCHES_BY_L.clear()
    LAUNCHES_BY_D.clear()


def snapshot_launches() -> tuple[dict, collections.Counter]:
    """The launch counts now, for :func:`take_captured`."""
    return (dict(LAUNCHES), collections.Counter(PAGED_LAUNCHES_BY_L),
            collections.Counter(LAUNCHES_BY_D))


def take_captured(snapshot: tuple) -> tuple[dict, collections.Counter]:
    """The launches the wrappers counted since ``snapshot`` while a CUDA
    graph was captured (the capture launched none of them): returned as
    the graph's per-replay record and taken off the counts."""
    before, by_l, by_d = snapshot
    delta = {name: LAUNCHES[name] - before[name] for name in LAUNCHES}
    delta_l = PAGED_LAUNCHES_BY_L - by_l
    delta_d = LAUNCHES_BY_D - by_d
    LAUNCHES.update(before)
    for counter, kept in ((PAGED_LAUNCHES_BY_L, by_l), (LAUNCHES_BY_D, by_d)):
        counter.clear()
        counter.update(kept)
    return delta, delta_l, delta_d


def add_launches(record: tuple) -> None:
    """Count the launches of one replay of a graph (its :func:`take_captured`
    record)."""
    delta, delta_l, delta_d = record
    for name, n in delta.items():
        LAUNCHES[name] += n
    PAGED_LAUNCHES_BY_L.update(delta_l)
    LAUNCHES_BY_D.update(delta_d)


def _cuda_tool(name: str) -> str | None:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    found = shutil.which(name) or str(Path(home) / "bin" / name)
    return found if Path(found).exists() else None


def _nvcc() -> str:
    found = _cuda_tool("nvcc")
    if found is None:
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
    errors, logs = [], []
    for src, p in zip(SOURCES, procs):
        out = p.communicate()[0].decode(errors="replace")
        logs.append(out)
        if p.returncode:
            errors.append(f"{src}:\n{out}")
    if errors:
        raise RuntimeError("nvcc failed:\n" + "\n".join(errors))
    lib_path.with_suffix(".ptxas.txt").write_text("\n".join(logs))
    tmp = lib_path.with_suffix(f".{os.getpid()}.tmp")
    link = subprocess.run(
        [nvcc, *NVCC_FLAGS, "-shared", *map(str, objs), "-o", str(tmp)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
    )
    if link.returncode:
        raise RuntimeError("nvcc link failed:\n" + link.stdout.decode(errors="replace"))
    os.replace(tmp, lib_path)  # atomic: a concurrent loader never sees half a file


def _lib_path() -> Path:
    return BUILD_DIR / f"libsct_torch_kernels_{_digest()}.so"


def library() -> ctypes.CDLL:
    """The kernels' shared library, built on first call."""
    global _lib, build_seconds
    with _lock:
        if _lib is None:
            lib_path = _lib_path()
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


_PTXAS_ENTRY = re.compile(r"Compiling entry function '(\w+)'")
_PTXAS_FIELDS = {
    "stack": re.compile(r"(\d+) bytes stack frame"),
    "spill_stores": re.compile(r"(\d+) bytes spill stores"),
    "spill_loads": re.compile(r"(\d+) bytes spill loads"),
    "regs": re.compile(r"Used (\d+) registers"),
    "static_smem": re.compile(r"(\d+) bytes smem"),
}


def _demangle(names: list[str]) -> dict[str, str]:
    """Short readable kernel names (``tc::flash_tc_kernel<__nv_bfloat16, 64>``)."""
    filt = _cuda_tool("cu++filt")
    out = names
    if filt is not None and names:
        run = subprocess.run([filt], input="\n".join(names), capture_output=True, text=True)
        if run.returncode == 0 and len(run.stdout.splitlines()) == len(names):
            out = run.stdout.splitlines()
    short = []
    for full in out:
        full = full.replace("(anonymous namespace)::", "").replace("void ", "", 1)
        cut = full.index(">(") + 1 if ">(" in full else full.find("(")
        short.append(full[:cut] if cut > 0 else full)
    return dict(zip(names, short))


def kernel_report() -> list[dict]:
    """Per kernel of the built library: registers, spills, static shared
    memory and stack (``ptxas -v``), and the count of ``HGMMA`` and
    ``HMMA`` instructions in its SASS (``cuobjdump -sass``, where the
    toolkit has it; None otherwise)."""
    library()
    lib_path = _lib_path()
    log = lib_path.with_suffix(".ptxas.txt")
    lines = log.read_text().splitlines() if log.exists() else []
    stats: dict[str, dict] = {}
    current = None
    for line in lines:
        entry = _PTXAS_ENTRY.search(line)
        if entry:
            current = stats.setdefault(entry.group(1), {})
            continue
        if current is not None:
            for key, pattern in _PTXAS_FIELDS.items():
                found = pattern.search(line)
                if found:
                    current[key] = int(found.group(1))
    sass: dict[str, dict] | None = None
    dump = _cuda_tool("cuobjdump")
    if dump is not None:
        run = subprocess.run([dump, "-sass", str(lib_path)], capture_output=True, text=True)
        if run.returncode == 0:
            sass, fn = {}, None
            for line in run.stdout.splitlines():
                head = re.search(r"Function : (\w+)", line)
                if head:
                    fn = sass.setdefault(head.group(1), {"hgmma": 0, "hmma": 0})
                elif fn is not None:
                    fn["hgmma"] += "HGMMA" in line
                    fn["hmma"] += bool(re.search(r"\bHMMA\b", line))
    # ptxas names a kernel whose wgmma it had to serialize (a lost overlap)
    for line in lines:
        if "wgmma" in line and "serialized" in line:
            for mangled in re.findall(r"'(\w+)'", line):
                if mangled in stats:
                    stats[mangled]["wgmma_serialized"] = line.split("serialized", 1)[1].strip()
    names = _demangle(sorted(stats))
    report = []
    for mangled in sorted(stats):
        rec = {"kernel": names[mangled], **stats[mangled]}
        counts = (sass or {}).get(mangled)
        rec["hgmma"] = None if counts is None else counts["hgmma"]
        rec["hmma"] = None if counts is None else counts["hmma"]
        report.append(rec)
    return report


def check(code: int, what: str) -> None:
    """Raise when a C entry reports a CUDA error."""
    if code:
        msg = library().sct_error_string(code).decode(errors="replace")
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")


def stream_handle(device: torch.device) -> int:
    """The current PyTorch stream of ``device`` as an int for ctypes."""
    return torch.cuda.current_stream(device).cuda_stream
