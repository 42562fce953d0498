"""Build the port's CUDA kernels and load them with ctypes.

Every ``yolo_tpu_torch/csrc/*.cu`` file is compiled by its own ``nvcc``
for ``sm_90a``, all at once, and the objects are linked into one shared
library with a plain C interface. The library is named by a hash of the
sources and of every compile and link flag, and written to
``build/yolo_tpu_torch/`` beside the package (git-ignored), at first use.
A process that finds the library already built loads it without
compiling. Without ``nvcc`` the build raises: the port never runs a CUDA
tensor without its kernel.

Plain C + ctypes instead of ``torch.utils.cpp_extension.load``: a source
that includes PyTorch's headers compiles far longer than this plain-C
one, and every fresh machine builds anew.
"""

from __future__ import annotations

import ctypes
import functools
import glob
import hashlib
import os
import shutil
import subprocess
import threading
import time

import torch

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build",
                         "yolo_tpu_torch")

# -fmad=false: the NMS IoU must round exactly as the plain PyTorch
# version does (no multiply-add contraction); the conv and entry kernels
# spell their multiply-adds as __fmaf_rn instead. IEEE division is nvcc's
# default without --use_fast_math, which is never passed
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-Xcompiler", "-fPIC")
# the conv kernel reaches the driver's tensor-map encoders through
# cudaGetDriverEntryPointByVersion, so the link needs no -lcuda
LINK_FLAGS = ("-shared",)

_lock = threading.Lock()


def _sources():
    srcs = sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu")))
    if not srcs:
        raise RuntimeError(f"no CUDA sources under {CSRC_DIR}")
    return srcs, sorted(glob.glob(os.path.join(CSRC_DIR, "*.cuh")))


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    raise RuntimeError(
        "cannot build the yolo_tpu_torch CUDA kernels: nvcc is not on "
        f"PATH and not at {path} (set CUDA_HOME to the CUDA toolkit)")


def library_path() -> str:
    """Where the library for the current sources and flags lives."""
    srcs, headers = _sources()
    h = hashlib.sha256(" ".join(NVCC_FLAGS + LINK_FLAGS).encode())
    for path in srcs + headers:
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"yolo_tpu_torch_{h.hexdigest()[:16]}.so")


def _check(cmd, returncode: int, log: str) -> None:
    if returncode != 0:
        raise RuntimeError(f"nvcc failed ({returncode}): {' '.join(cmd)}\n"
                           f"{log}")


def build() -> tuple:
    """Compile the kernels if their library is missing.
    Returns (library path, seconds spent compiling; 0.0 if cached)."""
    out = library_path()
    with _lock:
        if os.path.exists(out):
            return out, 0.0
        os.makedirs(BUILD_DIR, exist_ok=True)
        srcs, _ = _sources()
        tmp = f"{out}.{os.getpid()}.tmp"
        t0 = time.perf_counter()
        # one nvcc per source, started together, then one link
        objs = [f"{tmp}.{os.path.basename(src)}.o" for src in srcs]
        cmds = [[nvcc_path(), *NVCC_FLAGS, "-c", "-o", obj, src]
                for src, obj in zip(srcs, objs)]
        procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for cmd in cmds]
        logs = [p.communicate()[0] for p in procs]
        for cmd, p, log in zip(cmds, procs, logs):
            _check(cmd, p.returncode, log)
        link = [nvcc_path(), *NVCC_FLAGS, *LINK_FLAGS, "-o", tmp, *objs]
        proc = subprocess.run(link, capture_output=True, text=True)
        _check(link, proc.returncode, proc.stdout + proc.stderr)
        for obj in objs:
            os.remove(obj)
        # atomic publish: concurrent builders each write their own tmp
        os.replace(tmp, out)
        return out, time.perf_counter() - t0


def check_tensor(name: str, t: torch.Tensor, device, dtype,
                 channels_last: bool) -> None:
    """Raises ValueError unless the torch tensor ``t`` is what a kernel of
    the library may read or write through its bare pointer: on
    ``device``, of ``dtype``, dense in channels_last (NHWC bytes) or
    row-major order, and 16-byte aligned for vector loads."""
    if t.device != device:
        raise ValueError(f"{name} must be on {device}, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    fmt = torch.channels_last if channels_last else torch.contiguous_format
    if not t.is_contiguous(memory_format=fmt):
        raise ValueError(f"{name} must be contiguous in {fmt}")
    if t.data_ptr() % 16:
        raise ValueError(f"{name} must be 16-byte aligned")


@functools.lru_cache(maxsize=1)
def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    path, _ = build()
    lib = ctypes.CDLL(path)
    lib.yolo_nms_suppress.restype = ctypes.c_int
    lib.yolo_nms_suppress.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_float,
        ctypes.c_void_p]
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.yolo_conv_bias_act.restype = i32
    # x, w, bias, out, workspace; batch, h, w, cin, co, ks, leaky, bf16;
    # the plan's bm, bn, splits; stream
    lib.yolo_conv_bias_act.argtypes = [
        ptr, ptr, ptr, ptr, ptr, i32, i32, i32, i32, i32, i32, i32, i32,
        i32, i32, i32, ptr]
    lib.yolo_entry_conv_pool.restype = i32
    lib.yolo_entry_conv_pool.argtypes = [
        ptr, ptr, ptr, ptr, i32, i32, i32, i32, i32, ptr]
    lib.yolo_conv_s8_bias_act.restype = i32
    f32 = ctypes.c_float
    # x, x kind, x_inv, w, scale, bias, out, out_scale; batch, h, w, cin,
    # co, ks, stride, dilation, groups, pad, ho, wo, act, out kind; body,
    # bm, bn, aux, splits; workspace; pool size, stride, ph, pw; stream
    lib.yolo_conv_s8_bias_act.argtypes = [
        ptr, i32, f32, ptr, ptr, ptr, ptr, f32, *([i32] * 19), ptr,
        i32, i32, i32, i32, ptr]
    lib.yolo_quantize_s8.restype = i32
    # x, x kind, x_inv, q, n; stream
    lib.yolo_quantize_s8.argtypes = [ptr, i32, f32, ptr, ctypes.c_longlong,
                                     ptr]
    lib.yolo_maxpool_s8.restype = i32
    # x, out; b, h, w, c, size, stride, ho, wo, vec; stream
    lib.yolo_maxpool_s8.argtypes = [ptr, ptr, *([i32] * 9), ptr]
    return lib
