"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface, loaded with ``ctypes`` (no
PyTorch headers, so a build takes seconds). Libraries land in
``build/tpu_resnet_torch/`` at the repository root, named by a hash of the
sources and flags, so an edited source rebuilds and an unchanged one loads
from disk. :func:`build_all` starts one ``nvcc`` per source together.

A failed build raises; nothing here has a fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict, List, Tuple

import torch

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(CSRC)), "build",
                         "tpu_resnet_torch")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")
# Element-type codes of csrc/common.cuh (tr::DType).
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
# C signatures of each library's entry points: {library: {symbol: argtypes}}.
SIGNATURES: Dict[str, Dict[str, List]] = {
    "epilogue": {
        "tr_sbr": [_P, _P, _P, _P, _L, _I, _I, _I, _P],
        "tr_sbr_add": [_P, _P, _P, _P, _P, _L, _I, _I, _I, _P],
        "tr_sbr_bwd": [_P] * 7 + [_L, _I, _I, _I, _I, _P],
    },
    "fused_block": {"tr_block_fwd": [_P] * 8 + [_I] * 6 + [_P]},
    "fused_block_train": {
        "tr_block_stats": [_P] * 6 + [_I] * 6 + [_P],
        "tr_block_bwd1": [_P] * 14 + [_I] * 6 + [_P],
        "tr_block_bwd2": [_P] * 16 + [_I] * 6 + [_P],
        "tr_block_bwd3": [_P] * 17 + [_I] * 6 + [_P],
        "tr_block_bwd": [_P] * 11 + [_I] * 6 + [_P],
    },
    "fused_bottleneck": {"tr_bottleneck_fwd": [_P] * 11 + [_I] * 6 + [_P]},
    "fused_bottleneck_train": {
        "tr_bottleneck_train": [_I, _P] + [_I] * 6 + [_P],
        "tr_bottleneck_wgrad": [_I, _P] + [_I] * 8 + [_P],
    },
    "softmax_xent": {
        "tr_xent_fwd": [_P, _P, _P, _I, _I, _I, _P],
        "tr_xent_bwd": [_P, _P, _P, _P, _I, _I, _I, _P],
    },
}

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (PATH or /usr/local/cuda/bin): "
                           "the port's CUDA kernels cannot be built")
    return path


def _target(name: str) -> Tuple[str, str]:
    """(source path, library path keyed by the hash of what it is built
    from)."""
    src = os.path.join(CSRC, f"{name}.cu")
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for fn in sorted(os.listdir(CSRC)):
        if fn == f"{name}.cu" or fn.endswith(".cuh"):
            with open(os.path.join(CSRC, fn), "rb") as f:
                h.update(fn.encode() + b"\0" + f.read())
    return src, os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:16]}.so")


def build_all(names=tuple(SIGNATURES)) -> Dict[str, str]:
    """Compile every library that is not built yet, one ``nvcc`` per
    source, all started together. Returns {name: library path}; raises
    with the compiler's output if any build fails."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    out, procs = {}, {}
    for name in names:
        src, lib = _target(name)
        out[name] = lib
        if not os.path.exists(lib):
            tmp = f"{lib}.tmp{os.getpid()}"
            procs[name] = (subprocess.Popen(
                [_nvcc(), *NVCC_FLAGS, "-o", tmp, src],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
                tmp, lib)
    failed = []
    for name, (proc, tmp, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
        else:
            os.replace(tmp, lib)
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return out


def library(name: str) -> ctypes.CDLL:
    """The loaded kernel library ``name`` (built on first use), with the
    argument types of its entry points set."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            lib = ctypes.CDLL(build_all((name,))[name])
            for symbol, argtypes in SIGNATURES[name].items():
                fn = getattr(lib, symbol)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _loaded[name] = lib
        return lib


def check(err: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")
