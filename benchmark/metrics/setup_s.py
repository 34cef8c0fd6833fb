"""setup_s: seconds from the process's start to the first timed request
(imports, the kernels' library, the SRS, keygen, the warm-up requests)."""


def read(run):
    return run.setup_s
