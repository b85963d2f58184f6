"""ctypes binding for the port's native C++ image loader
(``tpuseg_torch/native/tpuseg_loader.cpp``; the port's copy of
``tpuseg/data/native_loader.py``).

The source is built with ``g++`` against libjpeg and libpng at first use,
once per hash of the source and flags, into
``build/tpuseg_torch/native/<hash>/`` at the repository root (the compiler's
output in ``build.log`` beside the library); nothing is written beside the
source. Where it does not build (a machine without the libjpeg or libpng
headers), or a file does not decode natively, the batch is decoded with PIL
(:func:`~tpuseg_torch.data.image_io.load_image_rgb`) and resized by
:func:`~tpuseg_torch.data.image_io.resize_bilinear_u8`, the numpy twin of
the C++ resize: the same API either way, and :attr:`is_native` says which.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import warnings
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

from tpuseg_torch.data.image_io import load_image_rgb, resize_bilinear_u8

SOURCE = Path(__file__).resolve().parents[1] / "native" / "tpuseg_loader.cpp"
BUILD_ROOT = (Path(__file__).resolve().parents[2] / "build" / "tpuseg_torch"
              / "native")
CXX_FLAGS = ("-O3", "-march=native", "-fPIC", "-std=c++17", "-Wall",
             "-shared")
LIBS = ("-ljpeg", "-lpng", "-lpthread")

_state = {"lib": None}  # None: not tried yet; False: does not build here


def build() -> Path:
    """Compile the loader (once per source and flags hash) -> the library
    path; raises with the compiler's output where it does not build."""
    h = hashlib.sha256(" ".join(CXX_FLAGS + LIBS).encode())
    h.update(SOURCE.read_bytes())
    out_dir = BUILD_ROOT / h.hexdigest()[:16]
    lib = out_dir / "libtpuseg_torch_loader.so"
    if lib.exists():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = out_dir / f".tmp.{os.getpid()}.so"
    cmd = ["g++", *CXX_FLAGS, str(SOURCE), "-o", str(tmp), *LIBS]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=300)
        out, rc = proc.stdout + proc.stderr, proc.returncode
    except OSError as e:  # no g++
        out, rc = str(e), -1
    (out_dir / "build.log").write_text(" ".join(cmd) + "\n" + out)
    if rc != 0:
        raise RuntimeError(f"g++ failed with code {rc}:\n{out[-4000:]}")
    os.replace(tmp, lib)  # atomic: a concurrent build sees all or nothing
    return lib


def _get_lib():
    """The loaded library, or False where it does not build."""
    if _state["lib"] is None:
        try:
            lib = ctypes.CDLL(str(build()))
        except (RuntimeError, OSError):
            _state["lib"] = False
            return False
        lib.nl_create.restype = ctypes.c_void_p
        lib.nl_create.argtypes = [ctypes.c_int]
        lib.nl_destroy.argtypes = [ctypes.c_void_p]
        lib.nl_load_batch.restype = ctypes.c_int
        lib.nl_load_batch.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_char_p),
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_int)]
        _state["lib"] = lib
    return _state["lib"]


class NativeImageLoader:
    """Batch image loader: decode + resize on a C++ worker pool.

    load_batch(paths, out_h, out_w, keep_aspect) ->
        (images [N, out_h, out_w, 3] uint8 RGB, orig_hw [N, 2] int32)
    """

    def __init__(self, threads: int | None = None):
        self.threads = threads or max(os.cpu_count() or 1, 1)
        lib = _get_lib()
        self._native = bool(lib)
        self._pool = None  # the PIL path's threads, made at first use
        if self._native:
            self._lib = lib
            self._handle = lib.nl_create(self.threads)

    @property
    def is_native(self) -> bool:
        return self._native

    def load_batch(self, paths: list[str], out_h: int, out_w: int,
                   keep_aspect: bool = False):
        """Both paths decode in the annotation frame (raw pixels, EXIF
        orientation ignored), so gt masks rasterized at the COCO json dims
        always match the decoded frame. ``keep_aspect`` letterboxes: the
        longer edge scaled to fit, centred on grey (128)."""
        n = len(paths)
        out = np.empty((n, out_h, out_w, 3), np.uint8)
        hw = np.empty((n, 2), np.int32)
        if self._native:
            arr = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
            rc = self._lib.nl_load_batch(
                self._handle, arr, n, out_h, out_w, int(keep_aspect),
                out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                hw.ctypes.data_as(ctypes.POINTER(ctypes.c_int)))
            if rc == 0:
                return out, hw
            # libjpeg/libpng cannot decode every format PIL does (CMYK
            # JPEG, BMP, TIFF, ...): retry the batch on the PIL path
            # instead of aborting the whole eval run on one odd file
            warnings.warn(f"native decode failed for {paths[rc - 1]}; "
                          "falling back to PIL for this batch")

        def one(i):
            img = load_image_rgb(paths[i], ignore_orientation=True)
            h, w = img.shape[:2]
            hw[i] = h, w
            if keep_aspect:
                s = min(np.float32(out_w) / np.float32(w),
                        np.float32(out_h) / np.float32(h))
                nw = int(np.float32(w) * s + np.float32(0.5))
                nh = int(np.float32(h) * s + np.float32(0.5))
                out[i] = 128
                t, left = (out_h - nh) // 2, (out_w - nw) // 2
                out[i, t:t + nh, left:left + nw] = resize_bilinear_u8(
                    img, nh, nw)
            else:
                out[i] = resize_bilinear_u8(img, out_h, out_w)

        if self._pool is None:
            self._pool = ThreadPoolExecutor(self.threads)
        list(self._pool.map(one, range(n)))
        return out, hw

    def __del__(self):
        if getattr(self, "_native", False):
            try:
                self._lib.nl_destroy(self._handle)
            except Exception:
                pass
        if getattr(self, "_pool", None) is not None:
            self._pool.shutdown(wait=False)
