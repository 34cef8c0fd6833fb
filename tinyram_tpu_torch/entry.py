"""The port's twins of `__graft_entry__.entry()`, one forward step of the
prover's compute path, and of `__graft_entry__.dryrun_multichip`.

`entry(device)` returns `(fn, (a, b))`: `fn` is NTT -> pointwise
Montgomery multiply -> inverse NTT over Fp at n = 2^12 (the polynomial
product at the heart of quotient evaluation), a plain function on tensors,
and `a`, `b` are its (16, n) limb arguments, drawn as the JAX function
draws them (`np.random.default_rng(0)`, top limb masked with 0x3FFF) and
held as int32 tensors with the same bits.  On the card the transforms run
kernel B2 (four-step, 64 x 64 rows) and the product kernel B1; on the CPU
their plain versions.

Run on the card: `python -c "from tinyram_tpu_torch.entry import entry;
fn, args = entry(); print(fn(*args)[:, :4])"`.

`dryrun_multichip(n_devices)` proves on a mesh of `n_devices` ranks (one
spawned process each, `shard.run_on_mesh`; on the card unless the caller
passes `device="cpu"`), at the JAX function's shapes: the four-step NTT
with its all-to-alls equal to `ntt` (power-of-two meshes), the
point-sharded MSM over 8·D points equal to the `curve/host.py` oracle, the
row-sharded gate x·(next(x) + x) with its halo exchange equal to its
unsharded value, and, for power-of-two D <= 8, the k = 6 toy circuit
proved by `create_proof(mesh=)` on every rank, the bytes equal on all
ranks, accepted by the single-device `verify_proof` and rejected for a
changed public input.  Run on the card: `python -c "from
tinyram_tpu_torch.entry import dryrun_multichip; dryrun_multichip(2)"`.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from .curve.vesta import from_affine_host
from .field import FP
from .poly import ntt
from .utils.device import CUDA, resolve

LOG_N = 12


def poly_product_step(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The coefficients of a·b mod (X^n - 1) for (16, n) coefficient limbs."""
    fa = ntt(FP, a)
    fb = ntt(FP, b)
    return ntt(FP, FP.mul(fa, fb), inverse=True)


def entry(device=None):
    """(poly_product_step, (a, b)) with a, b on `device` (the card unless
    the caller names another)."""
    dev = resolve(CUDA if device is None else device)
    rng = np.random.default_rng(0)
    limbs = rng.integers(0, 1 << 16, size=(2, 16, 1 << LOG_N)).astype(np.uint32)
    limbs[:, 15] &= 0x3FFF  # keep values < p
    a, b = (torch.as_tensor(x.view(np.int32), device=dev) for x in limbs)
    return poly_product_step, (a, b)


def _dryrun_rank(mesh, prove: bool, seed) -> dict:
    """One rank of `dryrun_multichip`; raises on any mismatch."""
    from .curve import host
    from .field.params import ints_to_limb_array
    from .ipa.srs import _hash_to_curve
    from .shard import paths
    from .shard.rows import gate_eval

    D = mesh.size
    dev = mesh.device
    pow2 = D & (D - 1) == 0
    out = {"rank": mesh.rank, "stats": {}}

    # sharded NTT (a power-of-two mesh divides the four-step split)
    n = max(64, 4 * D * D)
    n = 1 << (n - 1).bit_length()
    a = FP.encode(list(range(1, 33)) + [0] * (n - 32), device=dev)
    if pow2:
        got, out["stats"]["ntt"] = paths.ntt_path(mesh, a.cpu().numpy())
        if not torch.equal(torch.as_tensor(got, device=dev), ntt(FP, a)):
            raise AssertionError("sharded NTT mismatch")

    # point-sharded MSM over N = 8·D points
    N = 8 * D
    base = host.scalar_mul(5, _hash_to_curve(b"dryrun", 0))
    pts = [base]
    for _ in range(N - 1):
        pts.append(host.add(pts[-1], base))
    scalars = [3 * i + 1 for i in range(N)]
    pb = from_affine_host(pts)
    got, out["stats"]["msm"] = paths.msm_path(
        mesh, ints_to_limb_array(scalars), np.stack([c.numpy() for c in pb]))
    if got[0] != host.msm(scalars, pts):
        raise AssertionError("sharded MSM mismatch")

    # row-sharded gate with a rotation: the halo exchange
    cols = FP.encode([i % 251 for i in range(128 * D)], device=dev)
    got = paths.gate_path(mesh, cols.cpu().numpy())
    if not torch.equal(torch.as_tensor(got, device=dev), gate_eval(cols)):
        raise AssertionError("row-sharded gate evaluation mismatch")

    if prove and pow2 and D <= 8:
        res = paths.toy_proof(mesh, seed)
        out["stats"]["proof"] = res.pop("stats")
        out.update(res)
    return out


def dryrun_multichip(n_devices: int, device=None, prove: bool = True,
                     seed: int | None = None, timeout_s: float = 900.0,
                     log=print) -> dict:
    """Sharded proving on a mesh of `n_devices` ranks, tiny shapes (the
    module docstring lists the checks; any failure raises).  `seed` draws
    the proof's blinds from `SeededRng(seed)` instead of `secrets`;
    `prove=False` leaves the proof out.  Prints the JAX function's summary
    line and returns it with each rank's stats (per path: seconds, launch
    counts, peak device memory), each rank's proof bytes, rank 0's verdict
    on the proof and the last rank's on the changed public input."""
    from .shard import run_on_mesh

    t0 = time.time()
    ranks = run_on_mesh(_dryrun_rank, n_devices, prove, seed, device=device,
                        timeout_s=timeout_s, log=log)
    pow2 = n_devices & (n_devices - 1) == 0
    proved = "proof" in ranks[0]
    if proved:
        proofs = {r["proof"] for r in ranks}
        if len(proofs) != 1:
            raise AssertionError("the ranks' proofs differ")
        if not ranks[0]["verified"]:
            raise AssertionError("sharded proof rejected by the "
                                 "single-device verifier")
        if not ranks[-1]["rejected"]:
            raise AssertionError("sharded proof accepted for a changed "
                                 "public input")
        note = " + sharded create_proof->verify"
    elif not prove:
        note = " (proof skipped: prove=False)"
    else:
        note = " (skipped: needs pow2 mesh ≤ 8)"
    summary = (f"dryrun_multichip({n_devices}): NTT"
               f"{' +' if pow2 else ' (skipped: non-pow2 mesh) +'} MSM + "
               f"row-sharded gate eval{note} OK")
    log(summary)
    return {"summary": summary, "seconds": time.time() - t0,
            "stats": [r["stats"] for r in ranks],
            "proofs": [r.get("proof") for r in ranks],
            "verified": ranks[0].get("verified"),
            "rejected": ranks[-1].get("rejected")}
