"""Build and load the port's CUDA kernels (`csrc/*.cu`) as one library.

`library()` compiles every `.cu` file under `csrc/` with `nvcc` for
`sm_90a`, one process per file in parallel, and links them into
`build/kernels/<hash>/libtinyram_kernels.so` at the checkout root,
once per content hash of the sources, and loads it with ctypes.  Each C
entry point takes its pointers and the CUDA stream as `void*` and returns
`cudaGetLastError()` after its launch; `check()` raises on a non-zero code.
A failed build raises: there is no fallback to the plain versions.
"""

from __future__ import annotations

import collections
import ctypes
import glob
import hashlib
import os
import re
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
    returns its path.  One `nvcc -c` per source, all started together, then
    one link; the object files are removed after it."""
    global build_seconds, build_log
    out_dir = os.path.join(BUILD_DIR, _digest())
    lib_path = os.path.join(out_dir, LIB_NAME)
    if os.path.exists(lib_path):
        return lib_path
    os.makedirs(out_dir, exist_ok=True)
    tag = f".tmp{os.getpid()}"
    flags = [*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC"]
    cmds = [
        [_nvcc(), *flags, "-Xptxas", "-v", "-lineinfo", "-I", SRC_DIR, "-c",
         "-o", os.path.join(out_dir, f"{os.path.basename(src)}{tag}.o"), src]
        for src in _sources()
    ]
    link = [_nvcc(), *flags, "-shared", "-o", lib_path + tag,
            *(cmd[cmd.index("-o") + 1] for cmd in cmds)]
    t0 = time.time()
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for cmd in cmds]
    logs = [(cmd, proc.communicate()[0], proc.returncode)
            for cmd, proc in zip(cmds, procs)]
    if all(rc == 0 for _, _, rc in logs):
        proc = subprocess.run(link, capture_output=True, text=True)
        logs.append((link, proc.stdout + proc.stderr, proc.returncode))
    build_seconds = time.time() - t0
    for obj in link[link.index(lib_path + tag) + 1:]:
        if os.path.exists(obj):
            os.remove(obj)
    build_log = "".join(" ".join(cmd) + "\n" + out for cmd, out, _ in logs)
    with open(os.path.join(out_dir, "build.log"), "w") as f:
        f.write(build_log)
    failed = [rc for _, _, rc in logs if rc != 0]
    if failed:
        raise RuntimeError(f"nvcc failed ({failed[0]}):\n{build_log}")
    os.replace(lib_path + tag, lib_path)
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
    # B3 (L = 1) and B3s: L steps acc = select(same[s], acc + (qx,qy,1),
    #     (qx,qy,1)), o*[s] = acc; a* null starts from the identity
    #     (same, ax, ay, az, qx, qy, ox, oy, oz, L, n, stream)
    "tr_madd_select_scan": [_VP] * 9 + [_I64, _I64, _VP],
    # B4: p + q    (px, py, pz, qx, qy, qz, ox, oy, oz, n, stream)
    "tr_padd": [_VP] * 9 + [_I64, _VP],
    # B4s: S steps from the last: acc += b[s]; tot = acc + tot for s >= 1
    #     (bx, by, bz, scratch, acc*, tot*, S, H, sl, sa, n, stream), b
    #     (16, n / H, H, S) at limb stride sl and block stride sa
    "tr_padd_suffix_scan": [_VP] * 10 + [_I64] * 5 + [_VP],
    # B5: select(mask, p + q, q)   (mask, p*, q*, o*, n, stream)
    "tr_padd_select": [_VP] * 10 + [_I64, _VP],
    # B5l: R steps acc = select(bits[r], p + 2acc, 2acc) from the identity
    #     (bits, px, py, pz, ox, oy, oz, R, n, stream)
    "tr_padd_select_ladder": [_VP] * 7 + [_I64, _I64, _VP],
    # B6: 2^times p      (px, py, pz, ox, oy, oz, times, n, stream)
    "tr_pdouble": [_VP] * 6 + [_I64, _I64, _VP],
    # B6h: Horner, per window c doublings then + S_w, from the identity
    #     (sx, sy, sz, ox, oy, oz, c, nw, group, n, stream), S (16, nw, n)
    "tr_pdouble_horner": [_VP] * 6 + [_I64, _I64, _INT, _I64, _VP],
    # M1: radix-2^log_r DFT along axis 1 of (16, R, L) limbs, in and out at
    #     the element strides (sl, sr, sc)
    #     (x, out, digits, fold consts, log_r, L, sl, sr, sc, field, stream)
    "tr_mxu_dft": [_VP] * 4 + [_INT, _I64, _I64, _I64, _I64, _INT, _VP],
    # A1: L steps of the affine bucket accumulation over M lanes
    #     (same, qx, qy, ox, oy, oinf, L, M, stream)
    "tr_affine_scan": [_VP] * 6 + [_I64, _I64, _VP],
    # A2: inverses over groups of 2^group_log2 lanes (d, out, n, group_log2,
    #     stream)
    "tr_batch_inv": [_VP, _VP, _I64, _INT, _VP],
    # P1/P2: REPS chained op(x, b) per element
    #     (op, reps, a, b, out, n, stream)
    "tr_vpu_probe": [_INT, _INT, _VP, _VP, _VP, _I64, _VP],
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


def _cuobjdump() -> str:
    for cand in ("/usr/local/cuda/bin/cuobjdump", shutil.which("cuobjdump")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("cuobjdump not found: the SASS cannot be read")


_SASS_LINE = re.compile(
    r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)([^;]*)")


def sass() -> dict:
    """SASS of the built library, per kernel (`cuobjdump -sass`): mangled
    name -> [(address, opcode, operands)] in address order.  Names are
    matched by their length-prefixed identifier, e.g. "11padd_kernel"."""
    out = subprocess.run([_cuobjdump(), "-sass", build()], capture_output=True,
                         text=True, check=True).stdout
    funcs: dict = {}
    cur = None
    for line in out.splitlines():
        if "Function :" in line:
            cur = funcs.setdefault(line.split("Function :")[1].strip(), [])
        elif cur is not None:
            m = _SASS_LINE.search(line)
            if m:
                cur.append((int(m.group(1), 16), m.group(2), m.group(3)))
    return funcs


def sass_opcodes(listing: dict | None = None) -> dict:
    """Mangled name -> Counter of SASS opcodes, from `listing` (what
    `sass()` returns) or a fresh one."""
    return {name: collections.Counter(op for _, op, _ in ins)
            for name, ins in (listing or sass()).items()}


def check(code: int, name: str) -> None:
    if code != 0:
        msg = library().tr_error_string(code).decode()
        raise RuntimeError(f"{name}: CUDA error {code}: {msg}")


def stream_ptr(device) -> int:
    import torch

    return torch.cuda.current_stream(device).cuda_stream


def register(kernel_id: str, wrapper):
    """Give a kernel wrapper its launch count (a plain int attribute that
    the wrapper bumps where it launches) and its widest launch (the most
    elements of one launch, for wrappers that record it: B1), and list it
    under `kernel_id`."""
    wrapper.launches = 0
    wrapper.widest = 0
    _WRAPPERS[kernel_id] = wrapper
    return wrapper


def launch_counts() -> dict:
    return {k: w.launches for k, w in _WRAPPERS.items()}


def widest_launches() -> dict:
    return {k: w.widest for k, w in _WRAPPERS.items() if w.widest}


def total_launches() -> int:
    return sum(w.launches for w in _WRAPPERS.values())


def reset_launch_counts() -> None:
    for w in _WRAPPERS.values():
        w.launches = 0
        w.widest = 0
