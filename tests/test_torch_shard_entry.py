"""The sharded entry points at small sizes on gloo ranks of the CPU.

`entry.dryrun_multichip(4, prove=False)`: the sharded NTT, the MSM over 32
points against the host oracle and the row-sharded gate with its halo
exchange on four ranks (the proof is in test_torch_shard_prover.py), and
a three-rank mesh, where the NTT is skipped as in the JAX dry run.
`shard.scaling.scaling_report` on one and two ranks: positive rates, the
efficiency of the base count 1.0, and an analysis that says what a CPU
mesh measures.
"""

import torch

from tinyram_tpu_torch.entry import dryrun_multichip
from tinyram_tpu_torch.shard.scaling import scaling_report

torch.set_num_threads(1)  # test workers share the cores: more threads oversubscribe them


def test_dryrun_four_ranks_without_proof():
    lines = []
    res = dryrun_multichip(4, device="cpu", prove=False, timeout_s=300,
                           log=lines.append)
    assert lines[-1] == ("dryrun_multichip(4): NTT + MSM + row-sharded gate "
                         "eval (proof skipped: prove=False) OK")
    assert res["proofs"] == [None] * 4
    assert all(sorted(s) == ["msm", "ntt"] for s in res["stats"])


def test_dryrun_three_ranks_skips_the_ntt():
    lines = []
    dryrun_multichip(3, device="cpu", timeout_s=300, log=lines.append)
    assert lines[-1] == ("dryrun_multichip(3): NTT (skipped: non-pow2 mesh) "
                         "+ MSM + row-sharded gate eval (skipped: needs pow2 "
                         "mesh ≤ 8) OK")


def test_scaling_report_on_cpu_ranks():
    rep = scaling_report(log_n_ntt=6, log_n_msm=4, device_counts=[1, 2],
                         device="cpu", iters=1, cache_dir=None,
                         log=lambda _: None)
    assert set(rep["ntt"]) == {1, 2} and set(rep["msm"]) == {1, 2}
    assert all(v > 0 for v in rep["ntt"].values())
    assert all(v > 0 for v in rep["msm"].values())
    assert rep["efficiency"]["ntt"][1] == rep["efficiency"]["msm"][1] == 1.0
    assert rep["sizes"] == {"ntt": 64, "msm": 16}
    assert rep["analysis"].startswith("CPU ranks")
    assert rep["backend"][2] == "2 ranks on cpu, backend gloo"


def test_make_mesh_from_a_torchrun_environment():
    """`make_mesh` starts the process group from the variables `torchrun`
    sets when none is running (one rank here, on the CPU: gloo)."""
    import os
    import socket
    import subprocess
    import sys

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, MASTER_ADDR="localhost", MASTER_PORT=str(port),
               RANK="0", WORLD_SIZE="1", LOCAL_RANK="0")
    code = ("from tinyram_tpu_torch.shard import make_mesh\n"
            "m = make_mesh(devices=['cpu'])\n"
            "print(m.size, m.rank, m.device, m.backend)\n")
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
    out = subprocess.run([sys.executable, "-c", code], cwd=root, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["1", "0", "cpu", "gloo"]
