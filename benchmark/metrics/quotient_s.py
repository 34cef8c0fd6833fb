"""quotient_s: seconds per request of the prover's phases "constraint ext
eval" and "quotient+commit" (domain, NTT and expressions)."""


def read(run):
    return run.per_request("prover.constraint ext eval",
                           "prover.quotient+commit")
