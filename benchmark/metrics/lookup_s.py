"""lookup_s: seconds per request of the prover's phase "lookup
permute+commit" (the host's lookup permutation and its commitments)."""


def read(run):
    return run.per_request("prover.lookup permute+commit")
