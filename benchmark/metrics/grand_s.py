"""grand_s: seconds per request of the prover's phase "grand products"
(the permutation's and the lookups' grand products, the LogUp sums, their
interpolations and commitments)."""

from benchmark import spans


def read(run):
    return spans.phase_seconds(run, "grand products")
