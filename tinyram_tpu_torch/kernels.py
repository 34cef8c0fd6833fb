"""Build and load the port's CUDA kernels (`csrc/*.cu`) as one library.

`library()` compiles every `.cu` file under `csrc/` with `nvcc` for
`sm_90a` into `build/kernels/libtinyram_kernels.so` at the checkout root,
once per content hash of the sources, and loads it with ctypes.  Each C
entry point takes its pointers and the CUDA stream as `void*` and returns
`cudaGetLastError()` after its launch; `check()` raises on a non-zero code.
A failed build raises: there is no fallback to the plain versions.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import time

_PKG = os.path.dirname(os.path.abspath(__file__))
SRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "kernels")
LIB_NAME = "libtinyram_kernels.so"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]

_lib = None
_WRAPPERS: dict = {}  # kernel id -> wrapper function (with .launches)
build_seconds = None  # wall time of the last build in this process
build_log = ""  # nvcc's output of that build, including -Xptxas -v


def _sources() -> list[str]:
    return sorted(glob.glob(os.path.join(SRC_DIR, "*.cu")))


def _digest() -> str:
    h = hashlib.sha256()
    for path in sorted(glob.glob(os.path.join(SRC_DIR, "*"))):
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    h.update(" ".join(ARCH_FLAGS).encode())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    for cand in ("/usr/local/cuda/bin/nvcc", shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def build() -> str:
    """Compile the kernels if the library for this source hash is missing;
    returns its path."""
    global build_seconds, build_log
    out_dir = os.path.join(BUILD_DIR, _digest())
    lib_path = os.path.join(out_dir, LIB_NAME)
    if os.path.exists(lib_path):
        return lib_path
    os.makedirs(out_dir, exist_ok=True)
    tmp = lib_path + f".tmp{os.getpid()}"
    cmd = [
        _nvcc(), *ARCH_FLAGS, "-std=c++17", "-O3", "-shared",
        "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-lineinfo",
        "-I", SRC_DIR, "-o", tmp, *_sources(),
    ]
    t0 = time.time()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    build_seconds = time.time() - t0
    build_log = proc.stdout + proc.stderr
    with open(os.path.join(out_dir, "build.log"), "w") as f:
        f.write(" ".join(cmd) + "\n" + build_log)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{build_log}")
    os.replace(tmp, lib_path)
    return lib_path


_VP = ctypes.c_void_p
_I64 = ctypes.c_int64
_INT = ctypes.c_int

# entry point -> argument types (every entry returns cudaError_t as int)
_SIGNATURES = {
    # B1: out = a*b/R mod p            (a, b, out, n, field, stream)
    "tr_mont_mul": [_VP, _VP, _VP, _I64, _INT, _VP],
    # B2: natural-order NTT of rows    (x, out, tw, mult, mult_rows, scale,
    #                                   rows, log_s, field, stream)
    "tr_ntt": [_VP, _VP, _VP, _VP, _I64, _VP, _I64, _INT, _INT, _VP],
    # B3: select(mask, acc + (qx,qy,1), (qx,qy,1))
    #     (mask, ax, ay, az, qx, qy, ox, oy, oz, n, stream)
    "tr_madd_select": [_VP] * 9 + [_I64, _VP],
    # B4: p + q    (px, py, pz, qx, qy, qz, ox, oy, oz, n, stream)
    "tr_padd": [_VP] * 9 + [_I64, _VP],
    # B5: select(mask, p + q, q)   (mask, p*, q*, o*, n, stream)
    "tr_padd_select": [_VP] * 10 + [_I64, _VP],
    # B6: 2p       (px, py, pz, ox, oy, oz, n, stream)
    "tr_pdouble": [_VP] * 6 + [_I64, _VP],
    "tr_error_string": [_INT],
}


def library():
    """The loaded kernel library (built on first use)."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build())
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_char_p if name == "tr_error_string" else _INT
        _lib = lib
    return _lib


def check(code: int, name: str) -> None:
    if code != 0:
        msg = library().tr_error_string(code).decode()
        raise RuntimeError(f"{name}: CUDA error {code}: {msg}")


def stream_ptr(device) -> int:
    import torch

    return torch.cuda.current_stream(device).cuda_stream


def register(kernel_id: str, wrapper):
    """Give a kernel wrapper its launch count (a plain int attribute that
    the wrapper bumps where it launches) and list it under `kernel_id`."""
    wrapper.launches = 0
    _WRAPPERS[kernel_id] = wrapper
    return wrapper


def launch_counts() -> dict:
    return {k: w.launches for k, w in _WRAPPERS.items()}


def total_launches() -> int:
    return sum(w.launches for w in _WRAPPERS.values())


def reset_launch_counts() -> None:
    for w in _WRAPPERS.values():
        w.launches = 0
