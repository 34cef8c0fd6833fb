"""quotient_busy_s: the card's busy seconds per request inside the phases
that `quotient_s` reads, "constraint ext eval" and "quotient+commit"
(`quotient_s` minus this is the host's share)."""

from benchmark import spans


def read(run):
    return spans.phase_busy(run, "constraint ext eval", "quotient+commit")
