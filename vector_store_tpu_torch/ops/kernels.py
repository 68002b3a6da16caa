"""Build and bind the hand-written CUDA kernels of ``csrc/``.

The sources are compiled with ``nvcc`` for Hopper (``sm_90a``), one
``nvcc`` process per source, all started together, and linked into one
shared library with a plain C interface, loaded with ctypes. They need
``nvcc`` and the CUDA runtime only: the scans stage their
operands by TMA, and the tensor maps are encoded by a libcuda function that
the runtime looks up (``cudaGetDriverEntryPoint``), so nothing links libcuda
itself and no other header tree is included. The build
happens at first use (never at import: a CPU-only installation imports
every module of the port) into ``vector_store_tpu_torch/_build/``, keyed by
a hash of the sources, so an unchanged checkout builds once.

Each C entry point launches on the stream it is given and returns the
launch's ``cudaGetLastError()``; :func:`launch` raises on a non-zero code.
Tensor pointers and the stream travel as ``c_void_p`` (a plain Python int
would be cut to 32 bits).
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

PACKAGE_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")

# storage dtype -> csrc/hopper_scan.cuh DType (int8: I8 rows, scanned by bf16
# queries in the grouped scan only)
DTYPE_CODES = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2, torch.int8: 3}

# entry point -> (pointer arguments, int arguments incl. the device index);
# the stream comes last
_ENTRY_POINTS = {
    "vst_fused_scan": (6, 6),
    "vst_grouped_scan": (6, 7),
    "vst_partition_scan": (11, 7),
}

_lock = threading.Lock()
# guards the wrappers' launch counts: searches launch from several
# executor threads (a batch's dispatch beside another's dropped-pair retry)
count_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
# wall seconds of this process's nvcc build (None: none ran, or a cached
# library was loaded) and the compiler's resource report (-Xptxas -v)
build_seconds: float | None = None
ptxas_report: str = ""


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (shutil.which("nvcc"), os.path.join(home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found: put it on PATH or set CUDA_HOME to build the "
        "port's CUDA kernels"
    )


def _run_all(cmds: list[list[str]]) -> list[str]:
    """Run the commands side by side; raise with the first failure's
    output; return each command's stderr."""
    procs = [
        subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for c in cmds
    ]
    outs = [p.communicate() for p in procs]
    for c, p, (_, err) in zip(cmds, procs, outs):
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed with code {p.returncode} ({c[-1]}):\n{err}")
    return [err for _, err in outs]


def _build(sources: list[Path], so: Path, flags: tuple[str, ...]) -> str:
    """Compile each source (with the extra ``flags``) to an object, all at
    once, then link them into ``so`` (written under a temporary name, then
    moved into place); return the compiler's resource report (-Xptxas -v)."""
    nvcc, tag = _nvcc(), f"{os.getpid()}.tmp"
    objs = [so.with_name(f"{so.stem}.{src.stem}.{tag}.o") for src in sources]
    try:
        report = _run_all([
            [nvcc, *ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
             "-Xptxas", "-v", *flags, "-c", "-o", str(obj), str(src)]
            for src, obj in zip(sources, objs)
        ])
        tmp = so.with_name(f"{so.name}.{tag}")
        _run_all([[nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp), *map(str, objs)]])
        os.replace(tmp, so)
    finally:
        for obj in objs:
            obj.unlink(missing_ok=True)
    return "".join(report)


def load(flags: tuple[str, ...] = ()) -> tuple[ctypes.CDLL, float | None, str]:
    """Build (unless ``_build/`` already holds them) and bind the kernels of
    ``csrc/``: (library, nvcc wall seconds or None, the compiler's resource
    report). ``library`` does this with no extra flags; the ablation script
    (bench/scan_ablation.py) passes the -D switches of csrc/hopper_scan.cuh."""
    sources = sorted(CSRC_DIR.glob("*.cu"))
    digest = hashlib.sha256()
    for path in sources + sorted(CSRC_DIR.glob("*.cuh")):
        digest.update(path.name.encode() + path.read_bytes())
    digest.update(" ".join(ARCH_FLAGS + tuple(flags)).encode())
    so = BUILD_DIR / f"libvst_kernels_{digest.hexdigest()[:16]}.so"
    seconds, report = None, ""
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        t0 = time.perf_counter()
        report = _build(sources, so, tuple(flags))
        seconds = time.perf_counter() - t0
    lib = ctypes.CDLL(str(so))
    for name, (n_ptr, n_int) in _ENTRY_POINTS.items():
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    lib.vst_error_string.argtypes = [ctypes.c_int]
    lib.vst_error_string.restype = ctypes.c_char_p
    return lib, seconds, report


def library() -> ctypes.CDLL:
    """The kernels' shared library, built from ``csrc/`` on first use."""
    global _lib, build_seconds, ptxas_report
    with _lock:
        if _lib is None:
            _lib, build_seconds, ptxas_report = load()
        return _lib


def launch(
    name: str, tensors: list[torch.Tensor | int], ints: list[int], lib: ctypes.CDLL | None = None
) -> None:
    """Call entry point ``name`` (of ``lib``; by default of ``library()``)
    with the tensors' device pointers (an int is passed as a pointer as it
    is: an address inside a tensor the caller holds), the int arguments,
    the first tensor's device index and PyTorch's current stream on that
    device; raise if the launch was refused. The stream comes from
    ``torch._C._cuda_getCurrentRawStream``, the raw handle that Triton's
    launcher reads too: building a ``torch.cuda.Stream`` object for it
    took host time that a small batch's launch cannot spare."""
    lib = lib or library()
    index = tensors[0].device.index or 0
    rc = getattr(lib, name)(
        *[t if isinstance(t, int) else t.data_ptr() for t in tensors], *ints, index,
        torch._C._cuda_getCurrentRawStream(index),
    )
    if rc != 0:
        msg = lib.vst_error_string(rc).decode()
        raise RuntimeError(f"{name} launch failed: CUDA error {rc} ({msg})")
