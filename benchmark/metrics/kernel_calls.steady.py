"""kernel_calls.steady: the program's hand-written kernels' C entry calls a
fold step inside its spans (the counters of `tracing.KERNELS` summed)."""

from harness.span_counts import kernel_names, per_unit


def read(run):
    return per_unit(run, kernel_names())
