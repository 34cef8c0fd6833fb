"""open_s: seconds per request of the prover's phases "evaluations" and
"multiopen+ipa" (the IPA)."""


def read(run):
    return run.per_request("prover.evaluations", "prover.multiopen+ipa")
