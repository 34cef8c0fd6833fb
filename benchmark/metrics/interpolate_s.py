"""interpolate_s: seconds per request of the prover's phase "interpolate
instance+advice" (the blinding rows drawn and the instance and advice
columns interpolated, before their commitments)."""

from benchmark import spans


def read(run):
    return spans.phase_seconds(run, "interpolate instance+advice")
