"""setup_s: seconds from the process's start to the window (imports, the
kernel library's load or build, keys, public parameters, warm-up)."""


def read(run):
    return run.setup_s
