"""ctypes bridge to the native C++ TinyRAM emulator.

Port of `tinyram_tpu/tinyram/native/`: `emulator.cpp` here is its copy.
It is compiled with `g++` on first use into
`build/native/<hash>/libtinyram_emulator.so` at the checkout root (one
library per content hash of the source) and loaded with ctypes.  A failed
build raises: nothing switches to the Python emulator behind the caller's
back.  `eval_program_native` returns the same columnar `Trace` as the
Python `eval_program`, step for step, at word sizes up to MAX_WORD_BITS
(32, where a product of two words still fits 64 bits); it raises
ValueError above.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess

import numpy as np

from ..emulator import MemAccess, Trace
from ..isa import Imm, Program

_HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(_HERE, "emulator.cpp")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(_HERE))),
                         "build", "native")
LIB_NAME = "libtinyram_emulator.so"
FLAGS = ["-O2", "-shared", "-fPIC", "-std=c++17"]

MAX_WORD_BITS = 32  # above it a product of two words overflows 64 bits
_LIB = None


class _Instr(ctypes.Structure):
    _fields_ = [
        ("op", ctypes.c_uint8),
        ("ri", ctypes.c_uint8),
        ("rj", ctypes.c_uint8),
        ("a_is_imm", ctypes.c_uint8),
        ("a", ctypes.c_uint64),
    ]


class _Access(ctypes.Structure):
    _fields_ = [
        ("address", ctypes.c_uint64),
        ("time", ctypes.c_uint64),
        ("value", ctypes.c_uint64),
        ("kind", ctypes.c_uint8),
    ]


def build() -> str:
    """Compile the emulator if the library for this source is missing;
    returns its path.  Raises if `g++` is missing or fails."""
    with open(SRC, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(FLAGS).encode()).hexdigest()
    out_dir = os.path.join(BUILD_DIR, digest[:16])
    lib_path = os.path.join(out_dir, LIB_NAME)
    if os.path.exists(lib_path):
        return lib_path
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found: the native emulator cannot be built")
    os.makedirs(out_dir, exist_ok=True)
    tmp = f"{lib_path}.tmp{os.getpid()}"
    proc = subprocess.run([gxx, *FLAGS, SRC, "-o", tmp], capture_output=True,
                          text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed ({proc.returncode}):\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, lib_path)
    return lib_path


def library() -> ctypes.CDLL:
    """The loaded emulator library (built on first use)."""
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(build())
        # every argument typed: an untyped Python int goes as a 32-bit int,
        # and a `long` parameter then reads garbage in its upper half
        i64p = ctypes.POINTER(ctypes.c_int64)
        lib.tinyram_run.argtypes = [
            ctypes.POINTER(_Instr), ctypes.c_long,
            ctypes.POINTER(ctypes.c_uint64), ctypes.c_long,
            ctypes.c_int, ctypes.c_int, ctypes.c_long,
            i64p, i64p, i64p, i64p, i64p, i64p,
            ctypes.POINTER(_Access), ctypes.POINTER(ctypes.c_long), i64p]
        lib.tinyram_run.restype = ctypes.c_long
        _LIB = lib
    return _LIB


def native_available() -> bool:
    """Whether the emulator builds and loads here (for callers that ask;
    `eval_program_native` itself raises instead)."""
    try:
        library()
        return True
    except (RuntimeError, OSError):
        return False


def eval_program_native(
    prog: Program,
    word_bits: int,
    reg_count: int,
    primary_tape=(),
    aux_tape=(),
    max_steps: int = 1 << 22,
) -> Trace:
    if not 0 < word_bits <= MAX_WORD_BITS:
        raise ValueError(f"native emulator: word_bits={word_bits} is outside "
                         f"1..{MAX_WORD_BITS}, where its products are exact")
    lib = library()
    L = len(prog)
    # the same immediate-vs-word-size check as `eval_program`: the C++ core
    # masks immediates, but the program-table instance commits them raw
    mask = (1 << word_bits) - 1
    for i, inst in enumerate(prog):
        if isinstance(inst.a, Imm) and not 0 <= inst.a.value <= mask:
            raise ValueError(
                f"program line {i} ({inst.op}): immediate "
                f"{inst.a.value:#x} does not fit word_bits={word_bits}"
            )
    instrs = (_Instr * L)()
    for i, inst in enumerate(prog):
        instrs[i].op = inst.opcode
        instrs[i].ri = inst.ri or 0
        instrs[i].rj = inst.rj or 0
        instrs[i].a_is_imm = 1 if isinstance(inst.a, Imm) else 0
        instrs[i].a = inst.immediate() if isinstance(inst.a, Imm) else inst.a.index

    tape = np.array(list(primary_tape) + list(aux_tape), dtype=np.uint64)
    M = max_steps
    pc = np.zeros(M, np.int64)
    opcode = np.zeros(M, np.int64)
    vaddr = np.zeros(M, np.int64)
    inst_index = np.zeros(M, np.int64)
    regs = np.zeros((M + 1) * reg_count, np.int64)
    flag = np.zeros(M + 1, np.int64)
    accs = (_Access * (len(tape) + 2 * M + 4))()
    acc_count = ctypes.c_long(0)
    answer = ctypes.c_int64(0)

    def ptr(arr):
        return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))

    steps = lib.tinyram_run(
        instrs, L,
        tape.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)), len(tape),
        word_bits, reg_count, M,
        ptr(pc), ptr(opcode), ptr(vaddr), ptr(inst_index), ptr(regs),
        ptr(flag), accs, ctypes.byref(acc_count), ctypes.byref(answer),
    )
    if steps < 0:
        raise ValueError("native emulator: the program did not Answer within "
                         f"{M} steps")
    T = int(steps)
    accesses = [
        MemAccess(
            kind=("init", "store", "load")[accs[i].kind],
            address=int(accs[i].address),
            time=int(accs[i].time),
            value=int(accs[i].value),
        )
        for i in range(acc_count.value)
    ]
    return Trace(
        word_bits=word_bits,
        reg_count=reg_count,
        prog=prog,
        pc=pc[:T].copy(),
        opcode=opcode[:T].copy(),
        regs=regs[: (T + 1) * reg_count].reshape(T + 1, reg_count).copy(),
        flag=flag[: T + 1].copy(),
        v_addr=vaddr[:T].copy(),
        inst_index=inst_index[:T].copy(),
        accesses=accesses,
        answer=int(answer.value),
        primary_tape=tuple(int(w) for w in primary_tape),
        aux_len=len(list(aux_tape)),
    )
