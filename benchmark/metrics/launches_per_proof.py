"""launches_per_proof: the port's kernel launches per proof
(`kernels.total_launches()` before and after each `create_proof`)."""


def read(run):
    done = run.completed
    if not done:
        return None
    return sum(r.launches for r in done) / len(done)
