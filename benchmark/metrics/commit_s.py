"""commit_s: seconds per request of the prover's phase "commit
instance+advice" (the MSM layer)."""


def read(run):
    return run.per_request("prover.commit instance+advice")
