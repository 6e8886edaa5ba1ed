"""ctypes bindings for the native C++ prefetching data loader.

Port of ``gfplslam_tpu/io/native_loader.py`` with the same API
(``decode_image``, ``StereoLoader``). The loader is
``gfplslam_torch/csrc/dataloader.cpp``, a copy of ``native/dataloader.cpp``
whose PNG and JPEG decoders compile in only where libpng's and libjpeg's
headers are found: image decode + rectification remap + a bounded prefetch
queue on background threads, off the device's critical path
(plslam_mod.cpp:330-354 is the reference's main-thread equivalent).

At first use it is compiled with ``g++`` into
``build/gfplslam_torch/native/<hash>/`` at the repo root (git-ignored),
keyed by the source and the flags. Binary PGM (P5) always decodes; a PNG
or JPEG path on a build without that library raises a clear error. There is
no Python fallback: if the build fails, the loader raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "dataloader.cpp"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "gfplslam_torch" / "native"
# the flags of native/Makefile, so this source decodes and remaps to the
# same floats as the reference's loader (-march=native lets g++ contract the
# remap's products into FMAs)
CXX_FLAGS = ("-O3", "-march=native", "-std=c++17", "-fPIC", "-Wall", "-pthread",
             "-shared")
# header -> the libraries to link when it is found
OPTIONAL_LIBS = {"png.h": ("-lpng", "-lz"), "jpeglib.h": ("-ljpeg",)}
PNG, JPEG = 1, 2  # bits of gfpl_loader_formats()

_lib = None


def _cxx() -> str:
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if not cxx:
        raise RuntimeError("gfplslam_torch: g++ not found; the native loader "
                           "(gfplslam_torch/csrc/dataloader.cpp) needs a C++17 "
                           "compiler")
    return cxx


def _has_header(cxx: str, header: str) -> bool:
    probe = subprocess.run([cxx, "-x", "c++", "-E", "-", "-o", os.devnull],
                           input=f"#include <{header}>\n", text=True,
                           capture_output=True, timeout=60)
    return probe.returncode == 0


def _cpu_flags() -> str:
    """This host's CPU feature line: -march=native builds for it, so a
    library built on another host (a copied checkout) is never reused."""
    try:
        with open("/proc/cpuinfo") as f:
            return next((ln for ln in f if ln.startswith("flags")), "")
    except OSError:
        return platform.processor()


def build() -> Path:
    """Compile the loader if this source, these flags and this host have no
    library yet; returns the library's path. Raises if the compiler
    fails."""
    cxx = _cxx()
    libs = [flag for header, flags in OPTIONAL_LIBS.items()
            if _has_header(cxx, header) for flag in flags]
    h = hashlib.sha256(" ".join((cxx, *CXX_FLAGS, *libs, platform.machine(),
                                 _cpu_flags())).encode())
    h.update(SOURCE.read_bytes())
    out = BUILD_ROOT / h.hexdigest()[:16] / "libgfpl_dataloader.so"
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
    os.close(fd)
    cmd = [cxx, *CXX_FLAGS, "-o", tmp, str(SOURCE), *libs]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"native loader build failed ({proc.returncode}):\n"
                           f"{' '.join(cmd)}\n{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
    return out


def get_lib() -> ctypes.CDLL:
    """The loader's C entry points, built on first call."""
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(str(build()))
    fp = ctypes.POINTER(ctypes.c_float)
    lib.loader_create.restype = ctypes.c_void_p
    lib.loader_create.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_char_p),
        ctypes.c_int, fp, fp, fp, fp,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int]
    lib.loader_next.restype = ctypes.c_int
    lib.loader_next.argtypes = [ctypes.c_void_p, fp, fp]
    lib.loader_destroy.restype = None
    lib.loader_destroy.argtypes = [ctypes.c_void_p]
    lib.decode_image.restype = ctypes.c_int
    lib.decode_image.argtypes = [ctypes.c_char_p, fp, ctypes.c_int, ctypes.c_int,
                                 ctypes.POINTER(ctypes.c_int),
                                 ctypes.POINTER(ctypes.c_int)]
    lib.gfpl_loader_formats.restype = ctypes.c_int
    lib.gfpl_loader_formats.argtypes = []
    _lib = lib
    return _lib


def native_available() -> bool:
    """Whether the loader builds and loads on this host (tests skip on a
    host with no C++ compiler)."""
    try:
        get_lib()
    except (RuntimeError, OSError):
        return False
    return True


def formats() -> set[str]:
    """The image formats this build decodes."""
    bits = get_lib().gfpl_loader_formats()
    return {"pgm"} | ({"png"} if bits & PNG else set()) | (
        {"jpeg"} if bits & JPEG else set())


def _require_format(path: str) -> None:
    ext = os.path.splitext(path)[1].lower()
    fmt = {".png": "png", ".jpg": "jpeg", ".jpeg": "jpeg"}.get(ext)
    if fmt is not None and fmt not in formats():
        raise RuntimeError(
            f"{path}: this build of the native loader has no {fmt} decoder "
            f"(lib{'png' if fmt == 'png' else 'jpeg'}'s header was not found "
            f"when it was compiled); convert the frames to binary PGM (P5)")


def decode_image(path: str, max_w: int = 4096, max_h: int = 4096
                 ) -> np.ndarray:
    """Decode one image via the native library -> float32 [H, W]."""
    lib = get_lib()
    _require_format(path)
    buf = np.empty(max_w * max_h, np.float32)
    w = ctypes.c_int()
    h = ctypes.c_int()
    rc = lib.decode_image(path.encode(), buf.ctypes.data_as(
        ctypes.POINTER(ctypes.c_float)), max_w, max_h,
        ctypes.byref(w), ctypes.byref(h))
    if rc != 0:
        raise IOError(f"decode failed ({rc}): {path}")
    return buf[:w.value * h.value].reshape(h.value, w.value).copy()


class StereoLoader:
    """Prefetching rectified-stereo-sequence iterator: yields
    ``(index, left, right)`` with float32 [out_h, out_w] images, in order."""

    def __init__(self, paths_l: Sequence[str], paths_r: Sequence[str],
                 out_w: int, out_h: int,
                 maps: Optional[tuple[np.ndarray, np.ndarray, np.ndarray,
                                      np.ndarray]] = None,
                 n_threads: int = 2, queue_depth: int = 4):
        self._h_ptr = None
        lib = get_lib()
        for p in (*paths_l[:1], *paths_r[:1]):
            _require_format(p)
        self._lib = lib
        self._n = len(paths_l)
        self._w, self._h = out_w, out_h
        arr_l = (ctypes.c_char_p * self._n)(*[p.encode() for p in paths_l])
        arr_r = (ctypes.c_char_p * self._n)(*[p.encode() for p in paths_r])
        self._keep = (arr_l, arr_r)
        fp = ctypes.POINTER(ctypes.c_float)
        if maps is not None:
            ms = [np.ascontiguousarray(m, np.float32) for m in maps]
            if any(m.shape != (out_h, out_w) for m in ms):
                raise ValueError(f"maps must be [{out_h}, {out_w}], got "
                                 f"{[m.shape for m in ms]}")
            self._maps = ms
            mp = [m.ctypes.data_as(fp) for m in ms]
        else:
            self._maps = None
            mp = [ctypes.cast(None, fp)] * 4
        self._h_ptr = lib.loader_create(arr_l, arr_r, self._n, *mp,
                                        out_w, out_h, n_threads, queue_depth)

    def __iter__(self):
        return self

    def __next__(self):
        out_l = np.empty((self._h, self._w), np.float32)
        out_r = np.empty((self._h, self._w), np.float32)
        fp = ctypes.POINTER(ctypes.c_float)
        rc = self._lib.loader_next(self._h_ptr, out_l.ctypes.data_as(fp),
                                   out_r.ctypes.data_as(fp))
        if rc == -1:
            raise StopIteration
        if rc == -2:
            raise IOError("frame decode failed")
        return rc, out_l, out_r

    def close(self):
        if self._h_ptr:
            self._lib.loader_destroy(self._h_ptr)
            self._h_ptr = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        self.close()
