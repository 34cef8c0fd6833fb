"""commit_busy_s: the card's busy seconds per request inside the phase
that `commit_s` reads, "commit instance+advice" (the union of the device's
intervals clipped to it; the phase ends in a synchronize, so `commit_s`
minus this is the host's share)."""

from benchmark import spans


def read(run):
    return spans.phase_busy(run, "commit instance+advice")
