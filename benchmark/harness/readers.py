"""What the metric readers (metrics/<name>.py) share: each reader names
its span, problem or harness timing and calls one of these.  A reader
that finds nothing to read returns None, and the metric is left out of
the line.  Which cells report a metric is the manifest's `workloads`."""

from __future__ import annotations

from . import counts


def span_ms(run, span: str):
    """Milliseconds a unit of the program's span `span`: tracing.totals()
    over the window's units after the profiled ones (fenced spans with
    MIRA_SYNC_SPANS=1)."""
    if span not in run.spans or not run.span_units:
        return None
    return 1e3 * run.spans[span][1] / run.span_units


def harness_ms(run, key: str):
    """Milliseconds a unit of a part the harness times itself, to
    torch.cuda.synchronize()."""
    xs = run.harness.get(key)
    return 1e3 * sum(xs) / len(xs) if xs else None


def idle_pct(run):
    """The share of the profiled window in which nothing ran on the device
    (no kernel, copy or fill), in %."""
    if run.trace is None:
        return None
    return 100.0 * (1.0 - run.trace.busy_s() / run.trace.window_s())


def busy_ms(run):
    """Milliseconds a profiled unit in which something ran on the device."""
    if run.trace is None or not run.profiled_units:
        return None
    return 1e3 * run.trace.busy_s() / run.profiled_units


def roofline_pct(run, problem: str, span: str, name: str):
    """The least time of the problem `problem` (harness/counts.py, counted
    over the profiled units) over the device time of every kernel launched
    under the program's span `span`, in %; a share over 100 % raises."""
    if run.trace is None:
        return None
    bound = run.problems.get(problem, 0.0)
    device_s = run.trace.span_device_s(span)
    if bound <= 0 or device_s <= 0:
        return None
    return counts.share_pct(bound, device_s, name)
