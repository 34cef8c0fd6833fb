"""Run one cell of BENCHMARK.json once on the card:

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

(or `python3 -m benchmark.run ...` from the checkout's root).  Earlier
lines say what happens; the last line of standard output is the result,
one JSON object; the last lines of standard error are the numbers that
decided `correct`, each beside its limit.  Exits non-zero, with no result,
without a card, without the port, or if a forbidden module was loaded.
"""

import time

T_START = time.time()

import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
# every build and kernel cache at a fixed path inside the checkout
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(ROOT, "build", "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = os.path.join(ROOT, "build", "triton")
# one host thread for the CPU's math libraries: the window's host work is
# one Python thread, and idle pools of one thread a core only add load
for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[_var] = "1"

if __name__ == "__main__":
    from benchmark.harness import main

    sys.exit(main(sys.argv[1:], T_START))
