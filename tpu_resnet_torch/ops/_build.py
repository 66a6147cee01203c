"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface, loaded with ``ctypes`` (no
PyTorch headers, so a build takes seconds). A library that calls one of
the CUDA toolkit's own libraries (``jpeg_decode``: nvJPEG) links it with
the flags of :func:`link_flags`, which find it beside ``nvcc``. Libraries
land in ``build/tpu_resnet_torch/`` at the repository root, named by a
hash of the sources and flags, so an edited source rebuilds and an
unchanged one loads from disk. :func:`build_all` starts one ``nvcc`` per
source together.

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
# The toolkit libraries each kernel library links, by name (-l).
LINKED_LIBS: Dict[str, Tuple[str, ...]] = {"jpeg_decode": ("nvjpeg",)}
# Element-type codes of csrc/common.cuh (tr::DType).
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
# Host arrays: of bytes objects (passed without a copy), int64, int32.
_PB = ctypes.POINTER(ctypes.c_char_p)
_PL = ctypes.POINTER(_L)
_PI = ctypes.POINTER(_I)
# C signatures of each library's entry points: {library: {symbol: argtypes}}.
SIGNATURES: Dict[str, Dict[str, List]] = {
    "epilogue": {
        "tr_sbr": [_P, _P, _P, _P, _L] + [_I] * 7 + [_P],
        "tr_noop": [_I, _P],
        "tr_sbr_add": [_P, _P, _P, _P, _P, _L, _I, _I, _I, _P],
        "tr_sbr_bwd": [_P] * 8 + [_L, _I, _I, _I, _I, _P],
    },
    "fused_block_tc": {"tr_block_tc": [_I, _P] + [_I] * 7 + [_P]},
    "bottleneck_wgrad": {
        "tr_bottleneck_wgrad": [_I, _P] + [_I] * 8 + [_P]},
    "fused_bottleneck_tc": {"tr_bottleneck_tc": [_I, _P] + [_I] * 7 + [_P]},
    "jpeg_decode": {
        "tr_jpeg_create": [_I, ctypes.POINTER(_P)],
        "tr_jpeg_destroy": [_P],
        "tr_jpeg_info_batch": [_P, _I, _PB, _PL, _PI, _PI],
        "tr_jpeg_decode_batch": [_P, _I, _PB, _PL, _PI, _PI, _P, _PL, _P,
                                 _PI],
        "tr_resize_crop": [_P] * 6 + [_I, _I, _I, _P, _I, _P],
    },
    "softmax_xent": {
        "tr_xent_fwd": [_P, _P, _I, _L, _P, _I, _I, _I, _P],
        "tr_xent_bwd": [_P, _P, _I, _L, _P, _L, _P, _I, _I, _I, _P],
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


def link_flags(name: str, cuda_home: str) -> List[str]:
    """nvcc flags that link library ``name`` against the toolkit libraries
    it calls (``LINKED_LIBS``), found in ``cuda_home``'s library
    directories and recorded as the library's run path; none for a
    library that calls none."""
    libs = LINKED_LIBS.get(name, ())
    if not libs:
        return []
    dirs = [d for d in (os.path.join(cuda_home, "lib64"),
                        os.path.join(cuda_home, "targets", "x86_64-linux",
                                     "lib"))
            if os.path.isdir(d)]
    flags = []
    for d in dirs:
        flags += [f"-L{d}", "-Xlinker", f"-rpath={d}"]
    return flags + [f"-l{lib}" for lib in libs]


def _target(name: str, extra: List[str]) -> Tuple[str, str]:
    """(source path, library path keyed by the hash of what it is built
    from)."""
    src = os.path.join(CSRC, f"{name}.cu")
    h = hashlib.sha256(" ".join((*NVCC_FLAGS, *extra)).encode())
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
    nvcc = _nvcc()
    cuda_home = os.path.dirname(os.path.dirname(os.path.realpath(nvcc)))
    for name in names:
        extra = link_flags(name, cuda_home)
        src, lib = _target(name, extra)
        out[name] = lib
        if not os.path.exists(lib):
            tmp = f"{lib}.tmp{os.getpid()}"
            procs[name] = (subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-o", tmp, src, *extra],
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


def stream(x: torch.Tensor) -> int:
    """The handle of x's device's current CUDA stream."""
    return torch.cuda.current_stream(x.device).cuda_stream


def pointers(kind: str, names, tensors) -> ctypes.Array:
    """A ctypes array of the tensors' pointers in the order of ``names``
    (null for a name not given), each tensor checked contiguous and 16-byte
    aligned; ``kind`` names the caller in errors."""
    for name, t in tensors.items():
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{kind}: {name} must be contiguous and 16-byte "
                             f"aligned")
    return (ctypes.c_void_p * len(names))(*(
        tensors[n].data_ptr() if n in tensors else None for n in names))
