"""proof_s: the window's wall time over the proofs completed in it (each
request emulates, builds the witness and proves, ending in a
synchronize)."""


def read(run):
    done = len(run.completed)
    return run.window_s / done if done else None
