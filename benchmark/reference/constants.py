"""The commitments a configuration's proofs are checked against, worked out
by the reference alone: the verifying key (one commitment per fixed
column; the circuit has no copy constraints, so no permutation columns)
and the commitments of the first Lagrange basis polynomials and of the
sum of the rest up to the program table's end, from which the reference
commits a program's instance columns.

None of them depends on the seed: the program is an instance column, so
one key serves every execution.  At k = 17 they take some minutes of
Python integers, so they are worked out once and kept beside the
configuration (`benchmark/configs/<config>.constants.json`):

    python3 -m benchmark.reference.constants benchmark/configs/config3.json

`load` reads them back and checks them against the configuration and the
reference's own SRS.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys
import time

from . import curve
from .field import P, inv, lagrange_to_coeff, omega
from .tinyram_cs import TinyRamCS, fixed_columns

# Lagrange commitments kept: rows 0 .. LINES-1, enough for any program of
# up to LINES lines; the rows from a program's end to the table's end
# repeat its last line and are committed through their sum
LINES = 32
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CACHE_DIR = os.path.join(ROOT, "build", "benchmark")


def _hex(pt):
    return None if pt is None else [f"{pt[0]:064x}", f"{pt[1]:064x}"]


def _point(h):
    return None if h is None else (int(h[0], 16), int(h[1], 16))


def srs_digest(g: list) -> str:
    return hashlib.sha256(curve._encode(g).tobytes()).hexdigest()


def compute(word_bits: int, reg_count: int, k: int, pool: int = 1,
            log=print) -> dict:
    """The configuration's constants (see the module's docstring)."""
    tcs = TinyRamCS(word_bits, reg_count, k=k)
    n, tl = tcs.n, tcs.table_len
    g, _, _ = curve.srs(k, CACHE_DIR, pool)
    t0 = time.time()
    by_index = {col.index: name for name, col in tcs.col.fixed.items()}
    values = fixed_columns(tcs)
    fixed = []
    for i in range(tcs.cs.num_fixed):
        coeff = lagrange_to_coeff([int(v) for v in values[by_index[i]]], k)
        fixed.append(curve.msm(coeff, g, pool))
        log(f"fixed {i} {by_index[i]}: {time.time() - t0:.1f}s")
    w_inv, n_inv = inv(omega(k)), inv(n)
    lagrange = []
    for i in range(min(LINES, tl)):
        step = pow(w_inv, i, P)
        coeff, c = [0] * n, n_inv
        for j in range(n):
            coeff[j] = c
            c = c * step % P
        lagrange.append(curve.msm(coeff, g, pool))
        log(f"lagrange {i}: {time.time() - t0:.1f}s")
    lines = len(lagrange)
    tail = [0] * lines + [1] * (tl - lines) + [0] * (n - tl)
    tail_sum = curve.msm(lagrange_to_coeff(tail, k), g, pool)
    return {"word_bits": word_bits, "reg_count": reg_count, "k": k,
            "table_len": tl, "srs_sha256": srs_digest(g),
            "fixed": [_hex(p) for p in fixed],
            "lagrange": [_hex(p) for p in lagrange],
            "tail_sum": _hex(tail_sum)}


class Constants:
    """A configuration's constants as points."""

    def __init__(self, data: dict):
        self.k = data["k"]
        self.table_len = data["table_len"]
        self.srs_sha256 = data["srs_sha256"]
        self.fixed = [_point(h) for h in data["fixed"]]
        self.lagrange = [_point(h) for h in data["lagrange"]]
        self.tail_sum = _point(data["tail_sum"])


def load(path: str, word_bits: int, reg_count: int, k: int,
         g: list) -> Constants:
    """The constants at `path`, checked to be those of (W, R, k) over the
    generators `g`."""
    with open(path) as f:
        data = json.load(f)
    got = (data["word_bits"], data["reg_count"], data["k"])
    if got != (word_bits, reg_count, k):
        raise ValueError(f"{path} holds the constants of (W, R, k) = {got}, "
                         f"not {(word_bits, reg_count, k)}")
    if data["srs_sha256"] != srs_digest(g):
        raise ValueError(f"{path} was made over other SRS generators")
    return Constants(data)


def path_for(config_file: str) -> str:
    return config_file[:-len(".json")] + ".constants.json"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("config", help="a configuration file, benchmark/configs/<name>.json")
    ap.add_argument("--pool", type=int, default=curve.workers(),
                    help="processes for the hashing and the MSMs")
    args = ap.parse_args()
    with open(args.config) as f:
        cfg = json.load(f)
    data = compute(cfg["word_bits"], cfg["reg_count"], cfg["k"], args.pool)
    out = path_for(args.config)
    with open(out, "w") as f:
        json.dump(data, f, indent=1)
        f.write("\n")
    print(f"wrote {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
