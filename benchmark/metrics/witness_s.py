"""witness_s: seconds per request of the harness's synchronized span
around the native emulator and `TinyRamCircuit.assignment`."""


def read(run):
    return run.per_request("emulate", "witness")
