"""Hand-written CUDA kernels: build, load, dispatch and launch counts.

Replaces the dispatch of ``tpuseg/ops/pallas/__init__.py``. The sources in
``tpuseg_torch/csrc/`` are compiled by ``nvcc`` for ``sm_90a`` into one
shared library with a plain C interface, at first use, into
``build/tpuseg_torch/<hash of sources and flags>/`` at the repository root,
and loaded with ``ctypes``. Nothing is built or loaded at import time.

Dispatch (:func:`use_kernel`): a CPU tensor takes the plain PyTorch version
of a kernel, a CUDA tensor takes the kernel, any other device raises.
:func:`force_plain` sends CUDA tensors through the plain versions on purpose
(to compare the two on one card). There is no fallback: a CUDA tensor whose
kernel cannot be built or launched raises.

Each kernel wrapper adds one to ``LAUNCHES[name]`` (:func:`count_launch`,
under a lock: replicas launch from threads of their own) where it launches
its kernel, and nowhere else, so a run can show that it went through the
kernels.
"""
from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
SOURCES = ("nms.cu", "roi_align.cu", "roi_align_bwd.cu", "dcn_sample.cu",
           "dcn_sample_bwd.cu")
HEADERS = ("roi_align_common.cuh", "vec_io.cuh")  # hashed with the sources
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "tpuseg_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C entry points: name -> argtypes. Each returns cudaGetLastError() as int.
_SIGNATURES = {
    # boxes, order, sorted valid, mask scratch, keep, B, N, thr,
    # to_remove, stream
    "tpuseg_nms_mask": [_P, _P, _P, _P, _P, _I, _I, _F, _F, _P],
    # level ptrs[L], heights[L], widths[L], scales[L], L, B, C, boxes,
    # batch_idx, levels, N, P, S, out, stream
    "tpuseg_roi_align_f32": [_P, _P, _P, _P, _I, _I, _I, _P, _P, _P, _I, _I,
                             _I, _P, _P],
    "tpuseg_roi_align_bf16": [_P, _P, _P, _P, _I, _I, _I, _P, _P, _P, _I, _I,
                              _I, _P, _P],
    # as the forward, with grad ptrs[L] (f32, added into) first and the
    # pooled gradient in place of out, then whether it is NCHW (else
    # channels-last) and whether to merge in shared memory
    "tpuseg_roi_align_bwd_f32": [_P, _P, _P, _P, _I, _I, _I, _P, _P, _P, _I,
                                 _I, _I, _P, _I, _I, _P],
    "tpuseg_roi_align_bwd_bf16": [_P, _P, _P, _P, _I, _I, _I, _P, _P, _P, _I,
                                  _I, _I, _P, _I, _I, _P],
    # feats, sy, sx, m (or null), B, H, W, C, S, out, stream
    "tpuseg_dcn_sample_f32": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P, _P],
    "tpuseg_dcn_sample_bf16": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P, _P],
    # feats, sy, sx, m (or null), grad, B, H, W, C, S, dfeats (f32, added
    # into, or null), dsy, dsx (or null), dm (or null), stream
    "tpuseg_dcn_sample_bwd_f32": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P,
                                  _P, _P, _P, _P],
    "tpuseg_dcn_sample_bwd_bf16": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                                   _P, _P, _P, _P, _P],
}

LAUNCHES = {"nms": 0, "roi_align": 0, "roi_align_bwd": 0, "dcn_sample": 0,
            "dcn_sample_bwd": 0}

_state = {"lib": None, "force_plain": False}
# the replicas of parallel/inference.py launch from one thread each
_launch_lock = threading.Lock()


def count_launch(name: str) -> None:
    """One launch of kernel ``name``: the wrappers call this where they
    launch, and nowhere else."""
    with _launch_lock:
        LAUNCHES[name] += 1


def reset_launch_counts() -> None:
    with _launch_lock:
        for k in LAUNCHES:
            LAUNCHES[k] = 0


def launch_counts() -> dict:
    with _launch_lock:
        return dict(LAUNCHES)


@contextlib.contextmanager
def force_plain():
    """Run the plain PyTorch versions even for CUDA tensors."""
    prev = _state["force_plain"]
    _state["force_plain"] = True
    try:
        yield
    finally:
        _state["force_plain"] = prev


def use_kernel(t: torch.Tensor) -> bool:
    """True: launch the CUDA kernel; False: run the plain version."""
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise RuntimeError(f"no kernel or plain path for device {t.device}")
    return not _state["force_plain"]


def find_nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None:
        cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
        path = str(cand) if cand.exists() else None
    if path is None:
        raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, "
                           "/usr/local/cuda/bin): the CUDA kernels cannot be built")
    return path


def build() -> Path:
    """Compile the kernels (once per source hash), one nvcc per source, all
    started together, then link them; returns the library path."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    out_dir = BUILD_ROOT / h.hexdigest()[:16]
    lib = out_dir / "libtpuseg_kernels.so"
    if lib.exists():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc, pid = find_nvcc(), os.getpid()
    objs = [out_dir / f"{name}.{pid}.o" for name in SOURCES]
    steps = [[nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(CSRC / name)]
             for name, o in zip(SOURCES, objs)]
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for cmd in steps]
    results = [(cmd, p.communicate()[0], p.returncode)
               for cmd, p in zip(steps, procs)]
    tmp = out_dir / f".tmp.{pid}.so"
    if all(rc == 0 for _, _, rc in results):
        link = [nvcc, "-shared", "-o", str(tmp), *map(str, objs)]
        proc = subprocess.run(link, capture_output=True, text=True)
        results.append((link, proc.stdout + proc.stderr, proc.returncode))
    (out_dir / "build.log").write_text("".join(
        " ".join(cmd) + "\n" + out for cmd, out, _ in results))
    for o in objs:
        o.unlink(missing_ok=True)
    for cmd, out, rc in results:
        if rc != 0:
            raise RuntimeError(f"{' '.join(cmd[-3:])}: nvcc failed with code "
                               f"{rc}:\n{out[-4000:]}")
    os.replace(tmp, lib)  # atomic: a concurrent build sees all or nothing
    return lib


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    if _state["lib"] is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.tpuseg_cuda_error_string.argtypes = [ctypes.c_int]
        lib.tpuseg_cuda_error_string.restype = ctypes.c_char_p
        _state["lib"] = lib
    return _state["lib"]


def check_status(status: int, name: str) -> None:
    if status != 0:
        msg = library().tpuseg_cuda_error_string(status).decode()
        raise RuntimeError(f"{name}: CUDA error {status} ({msg})")


def check_tensor(t: torch.Tensor, name: str, *, device: torch.device,
                 dtypes: tuple, ndim: int, channels_last: bool = False,
                 align: int = 1) -> None:
    """Raise unless ``t`` is what a kernel can read as a raw pointer."""
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype not in dtypes:
        raise ValueError(f"{name}: dtype {t.dtype}, expected one of {dtypes}")
    if t.ndim != ndim:
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {ndim} dims")
    fmt = torch.channels_last if channels_last else torch.contiguous_format
    if not t.is_contiguous(memory_format=fmt):
        raise ValueError(f"{name}: not contiguous"
                         + (" in channels_last" if channels_last else ""))
    if t.data_ptr() % align:
        raise ValueError(f"{name}: data pointer not {align}-byte aligned")


def stream_ptr(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream
