"""Span tracing for the port (port of mira_tpu/utils/tracing.py): the span
tree, its report and per-name aggregate, and a memory report.

    with span("fold_step"):
        ...
    print(report(min_runtime=0.1))

Env: MIRA_TRACE=json emits one JSON line per span close on stderr (mira_tpu's
keys); MIRA_TRACE=off disables collection.  While a torch profiler runs, each
span also opens a `torch.profiler.record_function` of its name, so the
profile's trace names the spans (mira_tpu opens a `jax.named_scope`).

Spans measure host wall time: work queued on the card is attributed to
whichever span waits for it.  With MIRA_SYNC_SPANS=1 the spans that end in
`fence` wait for the card there, so their time includes the device work
they queued.

Counters: `count(name)` adds to a process-wide total (`counts()`, never
cleared by `reset()`) and, while spans collect, to the innermost open span
(`span_counts()`, `counts_by_span()`).  The kernels' C entry calls count
under the names of `KERNELS`.  While spans collect on a CUDA device, torch's
sync debug mode is on and each host wait on the card it flags (`.item()`,
`bool(tensor)`, `.tolist()`, a copy between host and card, `nonzero`)
counts as `host_sync`, unprinted; `torch.cuda.synchronize()`, which the
fences call, is not flagged.
"""

from __future__ import annotations

import contextlib
import functools
import json
import os
import sys
import threading
import time
import warnings
from typing import Dict, List, Optional

import torch


# the kernels' counters: one count per C entry call
KERNELS = ("msm_bucket", "msm_fixed", "fixed_table", "fold_eval", "ntt_fourstep",
           "ntt_stage", "poseidon", "msm_pippenger", "msm_pippenger_u4", "msm_window",
           "msm_lane", "field_lincomb")
HOST_SYNC = "host_sync"
# the text of torch's warning in sync debug mode "warn"
SYNC_WARNING = "called a synchronizing CUDA operation"


class _Span:
    __slots__ = ("name", "start", "end", "children", "parent", "counts")

    def __init__(self, name: str, parent: Optional["_Span"]):
        self.name = name
        self.start = time.perf_counter()
        self.end: Optional[float] = None
        self.children: List[_Span] = []
        self.parent = parent
        self.counts: Optional[Dict[str, int]] = None  # charged to this span alone

    @property
    def total(self) -> float:
        return (self.end or time.perf_counter()) - self.start

    @property
    def busy(self) -> float:
        return self.total - sum(c.total for c in self.children)


class _Collector(threading.local):
    def __init__(self):
        self.roots: List[_Span] = []
        self.current: Optional[_Span] = None


_state = _Collector()
_totals: Dict[str, int] = {}


def _mode() -> str:
    return os.environ.get("MIRA_TRACE", "collect")


def count(name: str, n: int = 1):
    """Add n to the counter `name`: to its process-wide total and, while
    spans collect, to the innermost open span."""
    _totals[name] = _totals.get(name, 0) + n
    s = _state.current
    if s is not None:
        if s.counts is None:
            s.counts = {}
        s.counts[name] = s.counts.get(name, 0) + n


def counts() -> Dict[str, int]:
    """The process-wide totals of every counter (a copy)."""
    return dict(_totals)


def set_counts(values: Dict[str, int]):
    """Set the process-wide totals of the counters named in `values` (to put
    back totals saved from `counts()`, or to zero them)."""
    _totals.update(values)


def _show_warning(message, category, filename, lineno, file=None, line=None):
    if str(message).startswith(SYNC_WARNING):
        count(HOST_SYNC)
        return
    _shown_before(message, category, filename, lineno, file, line)


_shown_before = warnings.showwarning


def _route_sync_warnings():
    """Count torch's sync warnings as `host_sync` in place of showing them:
    every one of them reaches `_show_warning` (an "always" filter), which
    shows other warnings as before.  A warnings context that restores the
    warning hook on exit undoes this, and the next span redoes it."""
    global _shown_before
    _shown_before = warnings.showwarning
    warnings.showwarning = _show_warning
    warnings.filterwarnings("always", message=SYNC_WARNING)


@contextlib.contextmanager
def span(name: str):
    if _mode() == "off":
        yield
        return
    if warnings.showwarning is not _show_warning and torch.cuda.is_initialized():
        _route_sync_warnings()
        if torch.cuda.get_sync_debug_mode() == 0:
            with warnings.catch_warnings():  # torch's note that the mode is a prototype
                warnings.simplefilter("ignore", UserWarning)
                torch.cuda.set_sync_debug_mode("warn")
    s = _Span(name, _state.current)
    if _state.current is None:
        _state.roots.append(s)
    else:
        _state.current.children.append(s)
    _state.current = s
    scope = (torch.profiler.record_function(name)
             if torch.autograd._profiler_enabled() else contextlib.nullcontext())
    try:
        with scope:
            yield s
    finally:
        s.end = time.perf_counter()
        _state.current = s.parent
        if _mode() == "json":
            print(json.dumps({"span": name, "enter": s.start, "close": s.end,
                              "busy_s": round(s.busy, 6),
                              "total_s": round(s.total, 6)}), file=sys.stderr)


def fence(x):
    """With MIRA_SYNC_SPANS=1, wait for the card's work on x (a tensor or a
    tuple of tensors) before the enclosing span closes; returns x."""
    if os.environ.get("MIRA_SYNC_SPANS") == "1":
        t = x[0] if isinstance(x, (tuple, list)) else x
        if isinstance(t, torch.Tensor) and t.is_cuda:
            torch.cuda.synchronize(t.device)
    return x


def instrument(fn):
    """Decorator form of span, named after the function."""

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        with span(fn.__qualname__):
            return fn(*args, **kwargs)

    return wrapper


def reset():
    _state.roots = []
    _state.current = None


def counts_by_span(until: Optional[float] = None) -> Dict[str, Dict[str, int]]:
    """{span name: {counter: n}}: the counts charged to the spans of each
    name themselves (not to their children), over the collected tree; with
    `until` (a time.perf_counter() reading), over the spans opened before
    it."""
    out: Dict[str, Dict[str, int]] = {}

    def walk(s: _Span):
        if until is not None and s.start >= until:
            return
        if s.counts:
            entry = out.setdefault(s.name, {})
            for k, v in s.counts.items():
                entry[k] = entry.get(k, 0) + v
        for c in s.children:
            walk(c)

    for r in _state.roots:
        walk(r)
    return out


def span_counts(until: Optional[float] = None) -> Dict[str, int]:
    """{counter: n} summed over the collected span tree: what was counted
    inside some span since the last `reset()` (in spans opened before
    `until`, where given)."""
    out: Dict[str, int] = {}
    for per_span in counts_by_span(until).values():
        for k, v in per_span.items():
            out[k] = out.get(k, 0) + v
    return out


def totals() -> dict:
    """{name: [count, seconds]} over every span of the tree, for loops whose
    spans repeat too often to print one by one (a span's seconds include its
    children's)."""
    out: dict = {}

    def walk(s: _Span):
        entry = out.setdefault(s.name, [0, 0.0])
        entry[0] += 1
        entry[1] += s.total
        for c in s.children:
            walk(c)

    for r in _state.roots:
        walk(r)
    return out


def report(min_runtime: float = 0.0) -> str:
    """The span tree with per-span busy/total seconds, dropping spans faster
    than min_runtime."""
    lines: List[str] = []

    def walk(s: _Span, depth: int):
        if s.total < min_runtime:
            return
        lines.append(
            f"{'  ' * depth}{s.name}: total {s.total:.3f}s busy {s.busy:.3f}s")
        for c in s.children:
            walk(c, depth + 1)

    for r in _state.roots:
        walk(r, 0)
    return "\n".join(lines)


def aggregate(min_runtime: float = 0.0) -> str:
    """Per-span-name count, busy and total seconds over the tree, largest
    busy first, counting the spans of at least min_runtime."""
    stats = {}

    def walk(s: _Span):
        if s.total >= min_runtime:
            c, b, t = stats.get(s.name, (0, 0.0, 0.0))
            stats[s.name] = (c + 1, b + s.busy, t + s.total)
        for ch in s.children:
            walk(ch)

    for r in _state.roots:
        walk(r)
    return "\n".join(
        f"{name}: n={c} busy {b:.3f}s total {t:.3f}s"
        for name, (c, b, t) in sorted(stats.items(), key=lambda kv: -kv[1][1]))


def memory_report() -> str:
    """Host peak RSS, then for each visible CUDA device the bytes its
    tensors hold now and at peak, the card's total and what torch's caching
    allocator reserves; the host line alone where no card is visible."""
    import resource

    peak_kb = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
    lines = [f"host peak RSS: {peak_kb / 1048576:.2f} GB"]
    if torch.cuda.is_available():
        mb = 1048576
        for i in range(torch.cuda.device_count()):
            total = torch.cuda.mem_get_info(i)[1]
            lines.append(
                f"cuda:{i} in_use {torch.cuda.memory_allocated(i) / mb:.1f} MB "
                f"peak {torch.cuda.max_memory_allocated(i) / mb:.1f} MB "
                f"limit {total / mb:.1f} MB "
                f"reserved {torch.cuda.memory_reserved(i) / mb:.1f} MB")
    return "\n".join(lines)
