"""device_busy_s: the card's busy seconds per proof (the union of the
device's intervals over the traced window, divided by the proofs
completed in it).  It repeats far more closely than `proof_s`, which the
host's speed moves."""


def read(run):
    p, done = run.profile, len(run.completed)
    if p is None or not p.busy or not done:
        return None
    return p.busy_s / done
