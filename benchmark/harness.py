"""One run of one cell: set-up, the measured window, the check against the
plain reference, and the result line.

The system under test is the PyTorch and CUDA port, `tinyram_tpu_torch`.
A request is one fresh execution proved: the program from the cell's
client (`programs.py`), emulated by the port's native emulator, its
witness built (`TinyRamCircuit.assignment`) and proved
(`plonk.create_proof`) under the cell's key, with a blinding stream drawn
from the seed.  The loop is closed: one client, each request sent when the
last one has ended; the requests started before `--seconds` are finished
and counted.

Set-up (`setup_s`, from the process's start to the first timed request):
the imports, the kernels' library (built into `build/kernels/` on a
checkout's first run), the SRS (`build/cache/`), `keygen`, and one
request of each size the cell sends.

After the window, once the device's peak has been read and the port's
state is dropped, the reference (`reference/`, which loads nothing of the
port) emulates every request's program again and compares the traces, and
checks the proofs: each number compared is printed beside its limit.
"""

from __future__ import annotations

import argparse
import gc
import json
import random
import subprocess
import sys
import time

from . import programs, work
from .spec import Spec, SpecError

FORBIDDEN = ("jax", "jaxlib", "flax", "tinyram_tpu")
MAX_CHECKED = 32  # proofs the reference checks in a run, drawn from the seed
CHECK_POOL = 8  # the reference's processes at most, whatever the host's cores


class SeededRng:
    """`randbelow` from a seeded `random.Random`: the prover's blinding."""

    def __init__(self, seed: int):
        self._r = random.Random(seed)

    def randbelow(self, n: int) -> int:
        return self._r.randrange(n)


class Request:
    """One request's record: its program, the port's trace and proof, and
    its spans (seconds of `time.perf_counter`)."""

    def __init__(self, index: int, prog: list):
        self.index = index
        self.prog = prog
        self.trace = None
        self.proof = None
        self.spans: list[tuple] = []  # (name, start, end)
        self.launches = 0

    @property
    def seconds(self) -> float:
        return self.spans[-1][2] - self.spans[0][1]

    def span_seconds(self, *names) -> float:
        return sum(e - s for n, s, e in self.spans if n in names)


class System:
    """The port at one configuration: its key, the three calls a request
    makes (`emulate`, `assign`, `prove`), which a planted fault may wrap,
    and the last proof it made."""

    def __init__(self, config: dict, device):
        import torch

        from tinyram_tpu_torch import kernels
        from tinyram_tpu_torch.ipa import setup
        from tinyram_tpu_torch.ipa.srs import CACHE_DIR
        from tinyram_tpu_torch.plonk import create_proof
        from tinyram_tpu_torch.tinyram import TinyRamCircuit
        from tinyram_tpu_torch.tinyram.isa import Imm, Instruction, Reg
        from tinyram_tpu_torch.tinyram.native import eval_program_native

        self.torch = torch
        self.kernels = kernels
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"
        self.w, self.r = config["word_bits"], config["reg_count"]
        self._insn = (Instruction, Imm, Reg)
        if self.cuda:
            kernels.library()
        self.circuit = TinyRamCircuit(self.w, self.r, k=config["k"])
        self.srs = setup(self.circuit.k, self.device,
                         cache_dir=CACHE_DIR if self.cuda else None)
        self.pk = self.circuit.keygen(self.srs)
        self.emulate = lambda prog: eval_program_native(prog, self.w, self.r)
        self.assign = lambda trace: self.circuit.assignment(trace,
                                                            self.device)
        self.prove = lambda asg, rng, hook: create_proof(
            self.srs, self.pk, asg, rng=rng, phase_hook=hook)
        self.last_proof = None

    def sync(self) -> None:
        if self.cuda:
            self.torch.cuda.synchronize(self.device)

    def instructions(self, prog: list) -> list:
        Instruction, Imm, Reg = self._insn
        return [Instruction(op, ri, rj, Imm(v) if kind == "imm" else Reg(v))
                for op, ri, rj, (kind, v) in prog]

    def request(self, req: Request, blinding_seed: int) -> None:
        """Make one proof; its spans end after the device has finished."""
        clock = time.perf_counter
        t0 = clock()
        req.trace = self.emulate(self.instructions(req.prog))
        t1 = clock()
        asg = self.assign(req.trace)
        self.sync()
        t2 = clock()
        req.spans += [("emulate", t0, t1), ("witness", t1, t2)]

        def hook(name, seconds, launches):
            end = clock()
            req.spans.append((f"prover.{name}", end - seconds, end))

        l0 = self.kernels.total_launches()
        req.proof = self.prove(asg, SeededRng(blinding_seed), hook)
        self.sync()
        req.launches = self.kernels.total_launches() - l0
        req.spans.append(("proof end", clock(), clock()))
        self.last_proof = req.proof

    def close(self) -> None:
        """Drop the port's state and return its device memory."""
        self.pk = self.srs = self.circuit = None
        self.emulate = self.assign = self.prove = None
        gc.collect()
        if self.cuda:
            self.torch.cuda.empty_cache()


class Run:
    """What a run measured, as the metric readers see it."""

    def __init__(self, config: dict, cs, seconds: float):
        self.cs = cs
        self.k = config["k"]
        self.peaks = work.peaks()
        self.seconds = seconds
        self.setup_s = None
        self.requests: list[Request] = []
        self.window_s = None
        self.window_peak_bytes = None
        self.profile = None

    @property
    def completed(self) -> list[Request]:
        return [r for r in self.requests if r.proof is not None]

    def per_request(self, *phases) -> float | None:
        """The seconds of spans named `phases`, summed over the window's
        completed requests and divided by their number."""
        done = self.completed
        if not done:
            return None
        return sum(r.span_seconds(*phases) for r in done) / len(done)


def window(system: System, client: programs.Client, run: Run,
           recorder=None) -> None:
    """The closed loop: requests until `run.seconds` have passed since the
    first was sent, each finished."""
    torch = system.torch
    if system.cuda:
        torch.cuda.reset_peak_memory_stats(system.device)
    if recorder is not None:
        recorder.start()
    t0 = time.perf_counter()
    i = 0
    while time.perf_counter() - t0 < run.seconds:
        req = Request(i, client.program(i))
        run.requests.append(req)
        try:
            system.request(req, client.blinding_seed(i))
        except Exception as e:  # the request failed; the run goes on
            req.proof = None
            print(f"request {i} failed: {type(e).__name__}: {e}",
                  file=sys.stderr)
        i += 1
    t1 = time.perf_counter()
    run.window_s = t1 - t0
    if system.cuda:
        run.window_peak_bytes = torch.cuda.max_memory_allocated(system.device)
    if recorder is not None:
        spans = [sp for r in run.requests for sp in r.spans]
        from .trace import Profile

        run.profile = Profile(recorder.stop(), t0, t1, spans)


def compare_traces(port, ref) -> list[str]:
    """The fields in which the port's trace differs from the reference's."""
    import numpy as np

    bad = [name for name in ("answer", "aux_len")
           if getattr(port, name) != getattr(ref, name)]
    bad += [name for name in ("pc", "opcode", "regs", "flag", "v_addr",
                              "inst_index")
            if not np.array_equal(getattr(port, name), getattr(ref, name))]
    if [(a.kind, a.address, a.time, a.value) for a in port.accesses] != \
            [(a.kind, a.address, a.time, a.value) for a in ref.accesses]:
        bad.append("accesses")
    return bad


def check(run: Run, config: dict, config_file: str, seed: int,
          pool: int) -> dict:
    """The numbers that decide `correct`, each with its limit."""
    from .reference import emulator, isa
    from .reference.verifier import Verifier

    def ref_prog(prog):
        return [isa.Instruction(op, ri, rj, isa.Imm(v) if kind == "imm"
                                else isa.Reg(v))
                for op, ri, rj, (kind, v) in prog]

    w, r = config["word_bits"], config["reg_count"]
    done = run.completed
    differing, items = 0, []
    for req in done:
        prog = ref_prog(req.prog)
        ref = emulator.eval_program(prog, w, r)
        bad = compare_traces(req.trace, ref)
        if bad:
            differing += 1
            print(f"request {req.index}: the trace differs in {bad}",
                  file=sys.stderr)
        items.append((req.index, prog, ref.answer, req.proof))
    if len(items) > MAX_CHECKED:
        items = programs.stream(seed, "checked").sample(items, MAX_CHECKED)
    rejected = 0
    if items:
        verdicts = Verifier(config, config_file, pool).check(
            [(prog, answer, proof) for _, prog, answer, proof in items])
        for (index, *_), why in zip(items, verdicts):
            if why:
                rejected += 1
                print(f"request {index}: proof rejected: {why}",
                      file=sys.stderr)
    return {
        "requests_failed": {"value": len(run.requests) - len(done),
                            "limit": 0, "rule": "<="},
        "traces_differing": {"value": differing, "limit": 0, "rule": "<="},
        "proofs_rejected": {"value": rejected, "limit": 0, "rule": "<="},
        "proofs_checked": {"value": len(items), "limit": 1, "rule": ">="},
    }


def passed(checks: dict) -> bool:
    return all(c["value"] <= c["limit"] if c["rule"] == "<="
               else c["value"] >= c["limit"] for c in checks.values())


def loaded_forbidden() -> list[str]:
    """The loaded modules whose top-level name (before the first dot) is
    one of FORBIDDEN, compared whole."""
    return sorted(name for name in sys.modules
                  if name.split(".", 1)[0] in FORBIDDEN)


def card() -> dict:
    """The card's name and power limit, as nvidia-smi reports them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader", "-i", "0"],
            capture_output=True, text=True, timeout=30, check=True).stdout
    except (OSError, subprocess.SubprocessError):
        return {}
    name, limit = (s.strip() for s in out.strip().split(",", 1))
    return {"card": name, "power_limit": limit}


class Cell:
    """A cell's system set up once: its spec, configuration, traffic and
    the port at that configuration (`device` other than the card serves
    the benchmark's own tests)."""

    def __init__(self, spec: Spec, name: str, device: str = "cuda"):
        self.spec = spec
        self.name = name
        self.cell = spec.cell(name)
        self.config = spec.config(self.cell["config"])
        self.config_file = spec.config_file(self.cell["config"])
        self.traffic = spec.traffic(self.cell["traffic"])
        self.system = System(self.config, device)

    def warm_up(self, seed: int) -> None:
        """One request of each size the cell sends, apart from the
        window's."""
        client = programs.Client(self.config, self.traffic, seed)
        for j, prog in enumerate(client.warmup_programs()):
            self.system.request(Request(-1 - j, prog),
                                client.blinding_seed(-1 - j))

    def measure(self, seed: int, seconds: float, trace: bool,
                setup_s: float | None, pool: int | None = None,
                close: bool = True) -> dict:
        """One window and its check; the result line's object.  With
        `close`, the port's state is dropped before the check."""
        from .reference import curve
        from .reference.tinyram_cs import TinyRamCS

        system, config = self.system, self.config
        readers = [(m, self.spec.reader(m["name"]))
                   for m in self.spec.metrics(self.name, trace)]
        client = programs.Client(config, self.traffic, seed)
        run = Run(config, TinyRamCS(config["word_bits"], config["reg_count"],
                                    k=config["k"]).cs, seconds)
        run.setup_s = setup_s
        setup_peak = (system.torch.cuda.max_memory_allocated(system.device)
                      if system.cuda else None)
        recorder = None
        if trace:
            from .trace import Recorder

            recorder = Recorder()
        window(system, client, run, recorder)
        device_info = {"platform": "gpu" if system.cuda else "cpu",
                       "kind": (system.torch.cuda.get_device_name(0)
                                if system.cuda else "cpu"),
                       "count": int(self.cell["chips"]),
                       "memory_peak_bytes": (
                           max(setup_peak, run.window_peak_bytes)
                           if system.cuda else None)}
        if close:
            system.close()
        metrics = {}
        for m, read in readers:
            value = read(run)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        out = {"correct": False, "attempted": len(run.requests),
               "failed": len(run.requests) - len(run.completed),
               "metrics": metrics, "device": device_info}
        if trace and run.profile is not None:
            device_info["busy_s"] = run.profile.busy_s
            device_info["window_s"] = run.profile.window_s
            out["breakdown"] = {"device_ops": run.profile.top_ops(),
                                "idle_gaps": run.profile.idle_gaps()}
        out["info"] = {"setup_s": run.setup_s, "window_s": run.window_s,
                       "request_s": [r.seconds for r in run.completed],
                       **(card() if system.cuda else {})}
        t_check = time.time()
        checks = check(run, config, self.config_file, seed,
                       min(curve.workers(), CHECK_POOL) if pool is None
                       else pool)
        out["info"]["check_s"] = time.time() - t_check
        out["correct"] = passed(checks)
        out["checks"] = checks
        return out


def execute(spec: Spec, cell_name: str, seed: int, seconds: float,
            trace: bool, t_start: float, device: str = "cuda",
            pool: int | None = None, fault=None) -> dict:
    """One run of a cell: set-up (timed from `t_start`), the window, the
    check.  `device` other than the card, and `fault(system)`, planted
    after the set-up (`faults.py`), serve the benchmark's own tests."""
    cell = Cell(spec, cell_name, device)
    cell.warm_up(seed)
    setup_s = time.time() - t_start
    if fault is not None:
        fault(cell.system)
    return cell.measure(seed, seconds, trace, setup_s, pool)


def parse(argv: list[str]) -> argparse.Namespace:
    ap = argparse.ArgumentParser(
        prog="benchmark/run.py",
        description="Run one cell of BENCHMARK.json once and print its "
                    "result as the last line.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv: list[str], t_start: float) -> int:
    args = parse(argv)
    try:
        spec = Spec.load()
        chips = int(spec.cell(args.workload)["chips"])
    except SpecError as e:
        print(f"benchmark: {e}", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"benchmark: the cell needs {chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              " available", file=sys.stderr)
        return 3
    out = execute(spec, args.workload, args.seed, args.seconds,
                  bool(args.trace), t_start)
    found = loaded_forbidden()
    if found:
        print(f"benchmark: the run loaded {found}", file=sys.stderr)
        return 4
    for name, c in out["checks"].items():
        print(f"{name} {c['value']} limit {c['rule']} {c['limit']}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out))
    return 0
