"""Build and load the hand-written CUDA kernels under ``csrc/``.

Each source compiles with ``nvcc`` into a shared library of its own with a
plain C interface, loaded with ``ctypes``; the sources build in parallel,
one ``nvcc`` each. The build runs at first use, from the sources in this
checkout only, into ``build/gfplslam_torch/<hash>/`` at the repo root
(git-ignored), where ``<hash>`` covers the source and the flags, so an
edited kernel rebuilds and an unchanged one loads at once. ``ptxas``'s
report (registers, shared memory, stack, spills) is kept beside each
library as ``ptxas.txt``. Nothing is built while a module is imported, and
nothing is built for CPU tensors.

Each C entry point launches on the stream it is given and returns
``cudaGetLastError()``; :func:`check` turns a non-zero code into an error.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from types import SimpleNamespace

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "gfplslam_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
# source -> its C entry points: (name, argtypes); each returns cudaError_t
KERNELS = {
    "fast_score.cu": {"gfpl_fast_score": (_P, _P, _I, _I, _I, _P, _P)},
    "hamming.cu": {"gfpl_hamming": (_I, _P, _P),
                   "gfpl_hamming_rate": (_I, _I, _I, _P, _P)},
}

_libs: dict[Path, SimpleNamespace] = {}
build_seconds: float | None = None  # wall time of this process's last build


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError(
        "gfplslam_torch: nvcc not found (looked on PATH and in "
        "$CUDA_HOME/bin, default /usr/local/cuda/bin); the CUDA kernels "
        "under gfplslam_torch/csrc must be built with the CUDA toolkit")


def library_path(source: Path) -> Path:
    """Where the library of one ``.cu`` source lives, by content hash."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    h.update(source.name.encode())
    h.update(source.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16] / f"lib{source.stem}.so"


def build(csrc: Path = CSRC) -> dict[str, Path]:
    """Compile every source of ``csrc`` that has no library yet, one
    ``nvcc`` per source, all started together. Returns source -> library."""
    global build_seconds
    libs = {name: library_path(csrc / name) for name in KERNELS}
    todo = {name: out for name, out in libs.items() if not out.exists()}
    if not todo:
        return libs
    t0 = time.perf_counter()
    procs = {}
    for name, out in todo.items():
        out.parent.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
        os.close(fd)
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(csrc / name)]
        procs[name] = (cmd, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    failed = []
    for name, (cmd, tmp, proc) in procs.items():
        stdout, stderr = proc.communicate()
        out = todo[name]
        if proc.returncode != 0:
            os.unlink(tmp)
            failed.append(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n"
                          f"{stdout}\n{stderr}")
            continue
        (out.parent / "ptxas.txt").write_text(stdout + stderr)
        os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
    if failed:
        raise RuntimeError("\n".join(failed))
    build_seconds = time.perf_counter() - t0
    return libs


def ptxas_report(csrc: Path = CSRC) -> dict[str, str]:
    """source -> the ``-Xptxas -v`` lines of its build (after :func:`build`)."""
    return {name: (library_path(csrc / name).parent / "ptxas.txt").read_text()
            for name in KERNELS}


def load(csrc: Path = CSRC) -> SimpleNamespace:
    """The C entry points of the kernels under ``csrc``, built on first
    call; one attribute per entry point. Every wrapper call comes here, so
    a loaded set costs one dictionary lookup and no file system access."""
    if csrc not in _libs:
        fns = {}
        for name, path in build(csrc).items():
            lib = ctypes.CDLL(str(path))
            for fn_name, args in KERNELS[name].items():
                fn = getattr(lib, fn_name)
                fn.argtypes = list(args)
                fn.restype = ctypes.c_int
                fns[fn_name] = fn
        _libs[csrc] = SimpleNamespace(**fns)
    return _libs[csrc]


def stream_ptr(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def check(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {err}")


def require_cuda(t: torch.Tensor, name: str, dtype: torch.dtype,
                 ndim: int) -> None:
    """Raise unless ``t`` is a contiguous CUDA tensor of this dtype/rank."""
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name} must have {ndim} dims, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
