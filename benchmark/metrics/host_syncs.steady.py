"""host_syncs.steady: the program's host waits on the card a fold step
(counter `host_sync`: each synchronizing call that torch's sync debug mode
flags inside a span, such as `.item()`, `bool(tensor)` or a copy between
host and card; the fences' `torch.cuda.synchronize()` is not one)."""

from harness.span_counts import per_unit


def read(run):
    return per_unit(run, ["host_sync"])
