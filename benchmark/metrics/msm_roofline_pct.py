"""msm_roofline_pct: the least time of the window's MSMs on the card
(`work.proof_msm_seconds`: every commitment an MSM of 2^k points, the
IPA's rounds) over the device time of the MSM's point kernels in the
trace (B3s, B4, B4s, B5, B5l, B6, B6h and B4s's layout pass; A1, A2)."""

from benchmark import work

KERNELS = ("madd_scan_kernel", "padd_select_kernel", "ladder_kernel",
           "padd_kernel", "suffix_scan_kernel", "step_major_kernel",
           "pdouble_kernel", "horner_kernel", "affine_scan_kernel",
           "batch_inv_kernel")


def read(run):
    p = run.profile
    if p is None or not run.completed:
        return None
    device = p.seconds_of(KERNELS)
    if device <= 0:
        return None
    bound = len(run.completed) * work.proof_msm_seconds(run.cs, run.k,
                                                         run.peaks)
    return 100.0 * bound / device
