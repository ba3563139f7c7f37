"""Span tracing for the port: the span tree and report of
mira_tpu/utils/tracing.py, without its per-span jax import.

    with span("fold_step"):
        ...
    print(report(min_runtime=0.1))

MIRA_TRACE=off disables collection.  Spans measure host wall time; work
queued on the card is attributed to whichever span waits for it.
"""

from __future__ import annotations

import contextlib
import functools
import os
import threading
import time
from typing import List, Optional


class _Span:
    __slots__ = ("name", "start", "end", "children", "parent")

    def __init__(self, name: str, parent: Optional["_Span"]):
        self.name = name
        self.start = time.perf_counter()
        self.end: Optional[float] = None
        self.children: List[_Span] = []
        self.parent = parent

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


@contextlib.contextmanager
def span(name: str):
    if os.environ.get("MIRA_TRACE", "collect") == "off":
        yield
        return
    s = _Span(name, _state.current)
    if _state.current is None:
        _state.roots.append(s)
    else:
        _state.current.children.append(s)
    _state.current = s
    try:
        yield s
    finally:
        s.end = time.perf_counter()
        _state.current = s.parent


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
