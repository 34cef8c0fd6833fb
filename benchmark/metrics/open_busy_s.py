"""open_busy_s: the card's busy seconds per request inside the phases that
`open_s` reads, "evaluations" and "multiopen+ipa" (`open_s` minus this is
the host's share)."""

from benchmark import spans


def read(run):
    return spans.phase_busy(run, "evaluations", "multiopen+ipa")
