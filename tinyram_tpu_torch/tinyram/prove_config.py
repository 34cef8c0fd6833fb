"""BASELINE configs 2 and 3 through the port's entry points: the twin of
`scripts/prove_config3.py`.

`prove_config` runs the stages of the JAX script on one device (the card
unless the caller names another):

  1. emulate the configuration's program (`config2_program` or
     `config3_program`, 2^steps_log2 steps at `word_bits`) with the Python
     emulator and the native one, and require equal traces;
  2. build the witness on `TinyRamCircuit(word_bits, 8, k)`;
  3. `mock`: the port's `MockProver` on that witness; any failure raises;
  4. `prove`: `setup(k)` (SRS cached on disk in `cache_dir`), the key from
     `cache_dir` (`load_pk`) or from `keygen` (then saved with `save_pk`),
     `create_proof`, `verify`; the proof must verify and must be rejected
     for answer + 1.

Each stage's wall time is taken after the device has finished, and on the
card its peak device memory (`torch.cuda.max_memory_allocated`, reset
before the stage) and the memory allocated after it.  The kernel launch counts (and the widest launch of
B1) are reset just before the proof and read just after it.  The report holds the seven prover phases
and the four verifier phases ("prover.*", "verifier.*" of
`utils.profiling.counters`).  Nothing is cut: W = 24, k = 17 is the JAX
script's configuration (BASELINE config 3); config 2 is W = 24, 2^12
steps, k = 14 (the row count its trace needs), as `bench.py`'s prover
benchmark proves it.
"""

from __future__ import annotations

import os
import secrets
import time

import numpy as np
import torch

from .. import kernels
from ..ipa import setup
from ..ipa.srs import CACHE_DIR
from ..plonk import MockProver, create_proof, load_pk, save_pk
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
CONFIGS = {2: (config2_program, 12, None), 3: (config3_program, 16, K)}


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
    it."""

    def __init__(self, device, log, tag):
        self.device = device
        self.log = log
        self.tag = tag
        self.seconds: dict = {}
        self.peak_bytes: dict = {}
        self.held_bytes: dict = {}

    def __call__(self, name, fn):
        cuda = self.device.type == "cuda"
        if cuda:
            torch.cuda.synchronize(self.device)
            torch.cuda.reset_peak_memory_stats(self.device)
        t0 = time.time()
        out = fn()
        if cuda:
            torch.cuda.synchronize(self.device)
            self.peak_bytes[name] = torch.cuda.max_memory_allocated(self.device)
            self.held_bytes[name] = torch.cuda.memory_allocated(self.device)
        self.seconds[name] = time.time() - t0
        peak = (f", peak device memory {self.peak_bytes[name] / 2**30:.2f} GiB"
                f", held after {self.held_bytes[name] / 2**30:.2f} GiB"
                if cuda else "")
        self.log(f"[{self.tag}] {name}: {self.seconds[name]:.2f}s{peak}")
        return out


def prove_config(config: int = 3, steps_log2: int | None = None,
                 mock: bool = True, prove: bool = True, device=CUDA,
                 cache_dir: str | None = CACHE_DIR, rng=secrets,
                 word_bits: int = WORD_BITS, k: int | None = None, log=print,
                 warm: int = 0) -> dict:
    """Run the stages of BASELINE config `config` (2 or 3) at its steps
    and k unless `steps_log2` or `k` say otherwise; returns a report
    (seconds, peak bytes, phases, launches, sizes) and the objects of the
    run under "objects".
    `warm` more proofs follow the first, each timed ("warm_prove_s") with
    its phases ("warm_phases": the last one's).  Raises if the
    traces differ, the mock names a failure, the proof is rejected or
    answer + 1 is accepted."""
    dev = resolve(device)
    stage = _Stages(dev, log, f"config{config}")
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
              "steps": len(trace), "accesses": len(trace.accesses),
              "seconds": stage.seconds, "peak_bytes": stage.peak_bytes,
              "held_bytes": stage.held_bytes}
    objects = {"prog": prog, "trace": trace, "circ": circ}
    report["objects"] = objects
    asg = stage("witness", lambda: circ.assignment(trace, dev))
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
        pk_path = None if cache_dir is None else key_path(
            cache_dir, config, word_bits, circ.k)
        if pk_path is not None and os.path.exists(pk_path):
            pk = stage("key load", lambda: load_pk(pk_path, cs, dev))
        else:
            pk = stage("keygen", lambda: circ.keygen(srs))
            if pk_path is not None:
                os.makedirs(cache_dir, exist_ok=True)
                stage("key save", lambda: save_pk(pk_path, pk))
        kernels.reset_launch_counts()
        counters.ops.clear()
        counters.seconds.clear()
        proof = stage("prove", lambda: create_proof(
            srs, pk, asg, rng=rng, phase_hook=lambda name, s, n: log(
                f"[config{config} phase] {name}: {s:.3f}s, {n} kernel launches")))
        report["launches"] = kernels.launch_counts()
        report["widest_launches"] = kernels.widest_launches()
        report["phases"] = {name[len("prover."):]: v["seconds"]
                            for name, v in counters.report().items()
                            if name.startswith("prover.")}
        counters.ops.clear()
        counters.seconds.clear()
        ok = stage("verify", lambda: circ.verify(srs, pk, prog, trace.answer,
                                                 proof))
        report["verifier_phases"] = {
            name[len("verifier."):]: v["seconds"]
            for name, v in counters.report().items()
            if name.startswith("verifier.")}
        bad_ok = stage("verify answer+1", lambda: circ.verify(
            srs, pk, prog, trace.answer + 1, proof))
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
                srs, pk, asg, rng=rng))
            report["warm_prove_s"].append(stage.seconds[f"prove warm {i + 1}"])
            report["warm_phases"] = {
                name[len("prover."):]: v["seconds"]
                for name, v in counters.report().items()
                if name.startswith("prover.")}
    return report
