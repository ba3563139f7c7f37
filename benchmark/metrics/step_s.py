"""step_s: the timed interval over the fold steps completed in it."""


def read(run):
    return run.window.per_unit_s()
