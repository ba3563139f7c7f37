"""Counts a unit of the program's counters (mira_tpu_torch/utils/tracing.py
`count`), as charged to its spans: `span_counts(until=window end)` over the
window's units after the profiled ones, the units `span_ms` covers (the
runner's `tracing.reset()` clears the spans' counts with the spans; spans
the program opens after the window, as where the reference reads a lazy
commitment, are left out).  A program that keeps no such counts, or
counted none of the names, gives None."""

from __future__ import annotations


def per_unit(run, names):
    """The counts of the counters `names` summed, a unit; None where the
    program counted none of them inside its spans."""
    if not run.span_units:
        return None
    try:
        from mira_tpu_torch.utils import tracing
    except ImportError:
        return None
    read = getattr(tracing, "span_counts", None)
    if read is None:
        return None
    counts = read(until=run.window.end) if run.window is not None else read()
    found = [counts[k] for k in names if k in counts]
    return sum(found) / run.span_units if found else None


def kernel_names():
    """The program's kernel counters (`tracing.KERNELS`), or none."""
    try:
        from mira_tpu_torch.utils import tracing
    except ImportError:
        return ()
    return getattr(tracing, "KERNELS", ())
