"""The readers of the program's new spans and counters on hand-made runs:
a span reader gives milliseconds a unit, a counter reader a count a unit,
and each gives None where its span or counter is absent (the CPU route
makes no kernel calls and no host syncs) or where the program keeps no
counts charged to spans (a program from before them).  Spans opened after
the window (the reference reading a lazy commitment) are not counted."""

import os
import sys
import time

import pytest

from harness.cell import BENCH, load_module
from harness.runner import Run
from harness.window import Window

ROOT = os.path.dirname(BENCH)
if ROOT not in sys.path:  # the program, as benchmark/run.py finds it
    sys.path.insert(0, ROOT)

SPAN_READERS = {
    "nifs_challenge_ms.steady": "nifs_challenge",
    "instance_fold_ms.steady": "instance_fold",
    "step_inputs_ms.steady": "step_inputs",
    "tape_vm_ms.steady": "tape_vm",
    "ivc_zero_step_ms.proofs": "IVC.zero_step",
}


def reader(name):
    return load_module(os.path.join(BENCH, "metrics", f"{name}.py"), f"test_reader_{name}")


def hand_made(span_units=4, spans=None):
    return Run("cell", {}, {}, 0.0, None, spans=spans or {}, span_units=span_units)


@pytest.fixture
def tracing():
    from mira_tpu_torch.utils import tracing

    tracing.reset()
    yield tracing
    tracing.reset()


@pytest.mark.parametrize("name, span", sorted(SPAN_READERS.items()))
def test_span_readers_give_ms_a_unit(name, span):
    read = reader(name).read
    assert read(hand_made(4, {span: [8, 0.5], "other": [4, 9.0]})) == pytest.approx(125.0)
    assert read(hand_made(4, {"other": [4, 9.0]})) is None
    assert read(hand_made(0, {span: [8, 0.5]})) is None


def test_counter_readers_give_counts_a_unit(tracing, monkeypatch):
    monkeypatch.setenv("MIRA_TRACE", "collect")
    tracing.count("host_sync", 100)  # outside every span: not charged
    with tracing.span("step"):
        tracing.count("host_sync", 3)
        with tracing.span("combine"):
            tracing.count("host_sync", 5)
            tracing.count("msm_fixed", 6)
        tracing.count("fold_eval", 2)
        tracing.count("mira_test_not_a_kernel", 50)
    run = hand_made(2)
    assert reader("host_syncs.steady").read(run) == 4.0
    assert reader("kernel_calls.steady").read(run) == 4.0


def test_counter_readers_leave_out_spans_opened_after_the_window(tracing, monkeypatch):
    monkeypatch.setenv("MIRA_TRACE", "collect")
    start = time.perf_counter()
    with tracing.span("step"):
        tracing.count("host_sync", 6)
        tracing.count("msm_fixed", 2)
    run = hand_made(2)
    run.window = Window(start, time.perf_counter())
    with tracing.span("delta_decode"):  # after the window
        tracing.count("host_sync", 3)
        tracing.count("msm_fixed")
    assert reader("host_syncs.steady").read(run) == 3.0
    assert reader("kernel_calls.steady").read(run) == 1.0


def test_counter_readers_give_none_where_nothing_was_counted(tracing, monkeypatch):
    monkeypatch.setenv("MIRA_TRACE", "collect")
    with tracing.span("step"):
        tracing.count("mira_test_not_a_kernel")
    for name in ("host_syncs.steady", "kernel_calls.steady"):
        assert reader(name).read(hand_made(2)) is None
        assert reader(name).read(hand_made(0)) is None


def test_counter_readers_give_none_for_a_program_without_span_counts(tracing, monkeypatch):
    monkeypatch.setenv("MIRA_TRACE", "collect")
    with tracing.span("step"):
        tracing.count("host_sync")
        tracing.count("msm_fixed")
    monkeypatch.delattr(tracing, "span_counts")
    monkeypatch.delattr(tracing, "KERNELS")
    for name in ("host_syncs.steady", "kernel_calls.steady"):
        assert reader(name).read(hand_made(2)) is None
