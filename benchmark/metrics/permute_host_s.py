"""permute_host_s: seconds per request of the port's leaf spans
"lookup.permute" (the host's lookup permutation: limbs to integers, the
sort, the Montgomery tables) and "lookup.multiplicity" (the host's LogUp
counts), from the port's span log; None where the port has none or it
dropped entries in the window."""

from benchmark import spans


def read(run):
    return spans.per_request_seconds(
        run, ("lookup.permute", "lookup.multiplicity"))
