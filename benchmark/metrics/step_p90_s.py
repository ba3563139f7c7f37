"""step_p90_s: the 90th percentile (nearest rank) of the window's single
fold steps."""


def read(run):
    return run.window.percentile_s(0.9)
