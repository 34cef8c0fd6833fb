"""ntt_roofline_pct: the least time of the window's transforms on the card
(`work.proof_ntt_seconds`) over the device time of the transform kernels
in the trace (B2; M1 where launched)."""

from benchmark import work

KERNELS = ("ntt_rows_kernel", "mxu_dft_kernel")


def read(run):
    p = run.profile
    if p is None or not run.completed:
        return None
    device = p.seconds_of(KERNELS)
    if device <= 0:
        return None
    bound = len(run.completed) * work.proof_ntt_seconds(run.cs, run.k,
                                                         run.peaks)
    return 100.0 * bound / device
