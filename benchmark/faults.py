"""Faults planted underneath the timed path, and the control: each wraps
one of the system's calls (`harness.System`) once the set-up is done, so
that the window runs as usual and its check has to come out false.  The
benchmark's own runs plant none; `control.py` and the tests do."""

from __future__ import annotations


def stale(system) -> None:
    """A step that returns its state unchanged: the prover hands back the
    last proof it made (the set-up's, then its own) for every request."""
    system.prove = lambda asg, rng, hook: system.last_proof


def answer(system) -> None:
    """The answer altered where it is produced: the emulator's."""
    emulate = system.emulate

    def wrapped(prog):
        trace = emulate(prog)
        trace.answer += 1
        return trace

    system.emulate = wrapped


def half(system) -> None:
    """Half of the witness left out: every other advice column zero."""
    assign = system.assign

    def wrapped(trace):
        asg = assign(trace)
        for i in range(0, len(asg.advice), 2):
            asg.advice[i] = system.torch.zeros_like(asg.advice[i])
        return asg

    system.assign = wrapped


def byte(system) -> None:
    """A proof altered where it is produced: one byte flipped."""
    prove = system.prove

    def wrapped(asg, rng, hook):
        proof = bytearray(prove(asg, rng, hook))
        proof[len(proof) // 3] ^= 0x10
        return bytes(proof)

    system.prove = wrapped


def control(system) -> None:
    """The control: the guarantee the configurations state (a proof
    verifies only for the program's true answer) broken.  The witness
    claims answer + 1; the emulator's trace is left as it is."""
    assign = system.assign

    def wrapped(trace):
        real = trace.answer
        trace.answer = real + 1
        try:
            return assign(trace)
        finally:
            trace.answer = real

    system.assign = wrapped


FAULTS = {"stale": stale, "answer": answer, "half": half, "byte": byte,
          "control": control}
