"""BASELINE configs 2, 3 and 4 through the port's entry points: the twin
of `scripts/prove_config3.py` and `scripts/prove_config4.py`.

`prove_config` runs the stages of the JAX scripts on one device (the card
unless the caller names another):

  1. emulate the configuration's program (`config2_program`, or
     `config3_program` for configs 3 and 4, 2^steps_log2 steps at
     `word_bits`) with the Python emulator and the native one, and require
     equal traces;
  2. build the witness on `TinyRamCircuit(word_bits, 8, k)`;
  3. `mock`: the port's `MockProver` on that witness; any failure raises;
  4. `prove`: `setup(k)` (SRS cached on disk in `cache_dir`), the key from
     `cache_dir` (`load_pk`) or from `keygen` (then saved with `save_pk`),
     `create_proof`, `verify`; the proof must verify and must be rejected
     for answer + 1.

Each stage's wall time is taken after the device has finished, and on the
card its peak device memory (`torch.cuda.max_memory_allocated`, reset
before the stage) and the memory allocated after it.  The kernel launch counts (and the widest launch of
B1) are reset just before the proof and read just after it.  The report holds the eight prover phases
and the four verifier phases ("prover.*", "verifier.*" of
`utils.profiling.counters`).  Nothing is cut: W = 24, k = 17 is the JAX
script's configuration (BASELINE config 3); config 2 is W = 24, 2^12
steps, k = 14 (the row count its trace needs), as `bench.py`'s prover
benchmark proves it; config 4 is `scripts/prove_config4.py`'s W = 24, 2^20
steps, k = 21.

`SIZING` holds a configuration's memory plan (`Sizing`): config 4 keeps its
witness in pinned host memory and proves in narrow passes, with the
arithmetic against the card's 80 GiB beside it; configs 2 and 3 use the
library's defaults.  Every sizing gives the same keys and proof bytes.

`on_stage(name, seconds, peak_bytes, held_bytes, error)` is called as each
stage ends (peak and held None off the card), and once more with the
exception for the stage that an exception leaves, which `prove_config`
then re-raises: a caller can write its record as the run goes
(`scripts/torch_prove_config4.py`).  With `frugal` (config 4's callers
pass it) the verifier's instance-commitment cache (one entry is the
instance columns' coefficients, ~12.5 GiB at k = 21) is emptied after each
verification, with the device memory held before and after in
"instance_cache_held", and the allocator's free blocks are returned to the
device after each stage.
"""

from __future__ import annotations

import gc
import os
import secrets
import time
from dataclasses import asdict, dataclass

import numpy as np
import torch

from .. import kernels
from ..ipa import setup
from ..ipa.ipa import COMMIT_CHUNK
from ..ipa.srs import CACHE_DIR
from ..plonk import MockProver, create_proof, load_pk, save_pk
from ..plonk import verifier
from ..plonk.prover import EVAL_SLAB, EXT_CHUNK, GATE_SLAB
from ..utils.device import CUDA, resolve
from ..utils.profiling import counters
from .bench_programs import config2_program, config3_program
from .circuit import TinyRamCircuit
from .emulator import Trace, eval_program
from .native import eval_program_native

WORD_BITS = 24
REG_COUNT = 8
K = 17  # a 2^16-step trace and its memory log fit 2^17 rows
# BASELINE config -> (program, steps_log2, k; None: the rows the trace needs)
CONFIGS = {2: (config2_program, 12, None), 3: (config3_program, 16, K),
           4: (config3_program, 20, 21)}


@dataclass(frozen=True)
class Sizing:
    """Where a configuration's witness rests and how wide each pass of its
    proof is: `host` stores the assignment, and the key's fixed Lagrange
    columns, in host memory (pinned on the card's host,
    `Assignment(host=True)`, `keygen(host=True)`; such a key is made anew,
    not cached, since `load_pk` would place it on the card); the widths
    are `create_proof`'s (`commit_chunk` keygen's and the verifier's too).
    The defaults are the library's: no width changes a byte of a key or a
    proof.  The quotient picks its lift itself (`prover._lift_whole`)."""

    host: bool = False
    ext_chunk: int = EXT_CHUNK
    gate_slab: int = GATE_SLAB
    commit_chunk: int = COMMIT_CHUNK
    eval_slab: int = EVAL_SLAB

    def prover(self) -> dict:
        """`create_proof`'s keyword arguments."""
        out = asdict(self)
        del out["host"]
        return out


# Config 4 (k = 21) on one 80 GiB card; a column of 2^21 (16, n) int32
# limbs is 128 MiB.  Held on the card through the quotient: the
# coefficients of the instance and advice columns (290, 36.25 GiB), of the
# key's fixed columns (31, 3.9 GiB) and of the lookups' and the LogUp
# argument's columns (37, 4.6 GiB), the SRS and the domain's tables
# (~2 GiB): ~47 GiB, which leaves ~30 GiB for a pass.  So the witness (321
# columns, 40.1 GiB), the key's fixed Lagrange columns (3.9 GiB) and,
# after the grand products, the lookups' Lagrange columns (4.6 GiB) rest in
# pinned host memory and come to the card for each use (`host`; the key,
# 7.75 GiB, is not cached: `save_pk` took 777 s for it); ext_chunk 2 (a
# four-step transform holds ~4 copies of its input: 2 columns, ~1 GiB; at
# 8 columns keygen's 31-column transform peaked at 75.5 GiB beside the
# key); commit_chunk 2 (an MSM pass costs up to ~3.4 KB a point and
# column, config 3's keygen peak: 2 x 6.7 GiB at 2^21 points); gate_slab 8
# (at most 35 columns a gate block, 4.4 GiB on a coset of 2^21 rows, where
# the default 48 reads up to 75); eval_slab 8 (the evaluations' and the
# multiopen fold's stacks, 1 GiB each: at the default 64, 8 GiB, the
# evaluations ran out of the card with 74.57 GiB allocated, 4 GiB asked).  The quotient's widest block, the `prog`
# lookup's 195 columns, would take ~195 GiB lifted whole, so it is lifted
# one coset at a time.  Configs 2 and 3 keep the defaults.
SIZING = {4: Sizing(host=True, ext_chunk=2, gate_slab=8, commit_chunk=2,
                    eval_slab=8)}


def key_path(cache_dir: str, config: int, word_bits: int, k: int) -> str:
    """Where `prove_config` caches the key of a configuration."""
    return os.path.join(cache_dir,
                        f"pk_config{config}_w{word_bits}_r{REG_COUNT}_k{k}.npz")


def trace_mismatch(a: Trace, b: Trace) -> list[str]:
    """The fields in which two traces differ (empty: equal)."""
    bad = [name for name in ("word_bits", "reg_count", "answer",
                             "primary_tape", "aux_len")
           if getattr(a, name) != getattr(b, name)]
    bad += [name for name in ("pc", "opcode", "regs", "flag", "v_addr",
                              "inst_index")
            if not np.array_equal(getattr(a, name), getattr(b, name))]
    if [(x.kind, x.address, x.time, x.value) for x in a.accesses] != \
            [(x.kind, x.address, x.time, x.value) for x in b.accesses]:
        bad.append("accesses")
    return bad


class _Stages:
    """Times each stage after the device has finished and, on the card,
    records its peak device memory and the memory still allocated after
    it; `on_stage` (see the module's docstring) hears of each stage as it
    ends, and of the one an exception leaves.  `frugal` returns the
    allocator's free blocks to the device after each stage."""

    def __init__(self, device, log, tag, on_stage=None, frugal=False):
        self.device = device
        self.log = log
        self.tag = tag
        self.on_stage = on_stage
        self.frugal = frugal
        self.seconds: dict = {}
        self.peak_bytes: dict = {}
        self.held_bytes: dict = {}

    def _memory(self):
        """(peak, allocated) bytes on the card since the stage began."""
        if self.device.type != "cuda":
            return None, None
        return (torch.cuda.max_memory_allocated(self.device),
                torch.cuda.memory_allocated(self.device))

    def __call__(self, name, fn):
        cuda = self.device.type == "cuda"
        if cuda:
            torch.cuda.synchronize(self.device)
            torch.cuda.reset_peak_memory_stats(self.device)
        t0 = time.time()
        try:
            out = fn()
            if cuda:
                torch.cuda.synchronize(self.device)
        except BaseException as e:
            if self.on_stage is not None:
                self.on_stage(name, time.time() - t0, *self._memory(), e)
            raise
        if cuda:
            self.peak_bytes[name], self.held_bytes[name] = self._memory()
        self.seconds[name] = time.time() - t0
        peak = (f", peak device memory {self.peak_bytes[name] / 2**30:.2f} GiB"
                f", held after {self.held_bytes[name] / 2**30:.2f} GiB"
                if cuda else "")
        self.log(f"[{self.tag}] {name}: {self.seconds[name]:.2f}s{peak}")
        if self.frugal:
            gc.collect()
            if cuda:
                torch.cuda.empty_cache()
        if self.on_stage is not None:
            self.on_stage(name, self.seconds[name], self.peak_bytes.get(name),
                          self.held_bytes.get(name), None)
        return out

    def drop_instance_cache(self) -> dict:
        """Empty the verifier's instance-commitment cache; the device bytes
        allocated before and after (None off the card)."""
        before = self._memory()[1]
        verifier.clear_instance_cache()
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        return {"before": before, "after": self._memory()[1]}


def prove_config(config: int = 3, steps_log2: int | None = None,
                 mock: bool = True, prove: bool = True, device=CUDA,
                 cache_dir: str | None = CACHE_DIR, rng=secrets,
                 word_bits: int = WORD_BITS, k: int | None = None, log=print,
                 warm: int = 0, on_stage=None, frugal: bool = False,
                 sizing: Sizing | None = None) -> dict:
    """Run the stages of BASELINE config `config` (2, 3 or 4) at its steps
    and k unless `steps_log2` or `k` say otherwise; returns a report
    (seconds, peak bytes, phases, launches, sizes) and the objects of the
    run under "objects".  `on_stage`, `frugal`: see the module's
    docstring; `sizing`: the configuration's `SIZING` (the defaults for
    configs 2 and 3) unless given.
    `warm` more proofs follow the first, each timed ("warm_prove_s") with
    its phases ("warm_phases": the last one's).  Raises if the
    traces differ, the mock names a failure, the proof is rejected or
    answer + 1 is accepted."""
    dev = resolve(device)
    sizing = SIZING.get(config, Sizing()) if sizing is None else sizing
    knobs = sizing.prover()
    stage = _Stages(dev, log, f"config{config}", on_stage, frugal)
    program, default_steps, default_k = CONFIGS[config]
    steps_log2 = default_steps if steps_log2 is None else steps_log2
    k = default_k if k is None else k
    prog = program(1 << steps_log2, word_bits=word_bits)
    trace = stage("emulate", lambda: eval_program(prog, word_bits, REG_COUNT))
    native = stage("emulate native", lambda: eval_program_native(
        prog, word_bits, REG_COUNT))
    bad = trace_mismatch(trace, native)
    if bad:
        raise AssertionError(f"native and Python traces differ in {bad}")
    circ = TinyRamCircuit(word_bits, REG_COUNT, k=k)
    cs = circ.tcs.cs
    log(f"[config{config}] {len(trace)} steps, {len(trace.accesses)} memory "
        f"accesses, traces equal; W={word_bits} k={circ.k} n={circ.tcs.n} "
        f"advice={cs.num_advice} fixed={cs.num_fixed} "
        f"instance={cs.num_instance} lookups={len(cs.lookups)} "
        f"range={len(cs.range_lookups)}")
    report = {"config": config, "word_bits": word_bits, "k": circ.k,
              "sizing": asdict(sizing),
              "steps": len(trace), "accesses": len(trace.accesses),
              "seconds": stage.seconds, "peak_bytes": stage.peak_bytes,
              "held_bytes": stage.held_bytes}
    objects = {"prog": prog, "trace": trace, "circ": circ}
    report["objects"] = objects
    asg = stage("witness", lambda: circ.assignment(trace, dev,
                                                   host=sizing.host))
    objects["asg"] = asg

    if mock:
        failures = stage("mock", lambda: MockProver(cs, asg).verify())
        report["mock_failures"] = [str(f) for f in failures]
        log(f"[config{config}] mock: {len(failures)} failures "
            f"{report['mock_failures'][:10]}")
        if failures:
            raise AssertionError(f"the config-{config} witness does not "
                                 "satisfy the circuit: "
                                 f"{report['mock_failures'][:10]}")

    if prove:
        srs = stage("srs setup", lambda: setup(circ.k, dev, cache_dir=cache_dir))
        pk_path = None if cache_dir is None or sizing.host \
            else key_path(cache_dir, config, word_bits, circ.k)
        if pk_path is not None and os.path.exists(pk_path):
            pk = stage("key load", lambda: load_pk(pk_path, cs, dev))
        else:
            pk = stage("keygen", lambda: circ.keygen(
                srs, commit_chunk=sizing.commit_chunk, host=sizing.host))
            if pk_path is not None:
                os.makedirs(cache_dir, exist_ok=True)
                stage("key save", lambda: save_pk(pk_path, pk))
        kernels.reset_launch_counts()
        counters.ops.clear()
        counters.seconds.clear()
        proof = stage("prove", lambda: create_proof(
            srs, pk, asg, rng=rng, phase_hook=lambda name, s, n: log(
                f"[config{config} phase] {name}: {s:.3f}s, {n} kernel launches"),
            **knobs))
        report["launches"] = kernels.launch_counts()
        report["widest_launches"] = kernels.widest_launches()
        report["phases"] = {name[len("prover."):]: v["seconds"]
                            for name, v in counters.report().items()
                            if name.startswith("prover.")}
        counters.ops.clear()
        counters.seconds.clear()
        ok = stage("verify", lambda: circ.verify(
            srs, pk, prog, trace.answer, proof,
            commit_chunk=sizing.commit_chunk))
        if frugal:
            report["instance_cache_held"] = {
                "verify": stage.drop_instance_cache()}
        report["verifier_phases"] = {
            name[len("verifier."):]: v["seconds"]
            for name, v in counters.report().items()
            if name.startswith("verifier.")}
        bad_ok = stage("verify answer+1", lambda: circ.verify(
            srs, pk, prog, trace.answer + 1, proof,
            commit_chunk=sizing.commit_chunk))
        if frugal:
            report["instance_cache_held"]["verify answer+1"] = \
                stage.drop_instance_cache()
        report["proof_bytes"] = len(proof)
        log(f"[config{config}] proof {len(proof)} bytes, verify={ok}, answer+1 "
            f"accepted={bad_ok}; launches {report['launches']}; verifier "
            f"phases {report['verifier_phases']}")
        if not ok:
            raise AssertionError(f"the config-{config} proof is rejected")
        if bad_ok:
            raise AssertionError(f"the config-{config} proof verifies for "
                                 "answer + 1")
        objects.update(srs=srs, pk=pk, proof=proof)
        report["warm_prove_s"] = []
        for i in range(warm):
            counters.ops.clear()
            counters.seconds.clear()
            stage(f"prove warm {i + 1}", lambda: create_proof(
                srs, pk, asg, rng=rng, **knobs))
            report["warm_prove_s"].append(stage.seconds[f"prove warm {i + 1}"])
            report["warm_phases"] = {
                name[len("prover."):]: v["seconds"]
                for name, v in counters.report().items()
                if name.startswith("prover.")}
    return report
