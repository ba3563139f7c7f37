"""Reading device times from a Chrome trace: attribution of device work to
the span that launched it, the busy union, and idle gaps by host span; and
each metric reader (metrics/<name>.py) on one made-up run."""

import json

import pytest

from harness.profile import WINDOW, Trace


def X(cat, name, ts, dur, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


EVENTS = [
    X("user_annotation", WINDOW, 0, 100),
    X("user_annotation", "delta_msm", 10, 10),
    X("user_annotation", "fold", 5, 65),
    X("cuda_runtime", "cudaLaunchKernel", 15, 1, corr=1),
    X("kernel", "msm_fixed", 30, 10, corr=1),  # launched in delta_msm, runs after it
    X("cuda_runtime", "cudaLaunchKernel", 50, 1, corr=2),
    X("kernel", "fold_eval", 55, 5, corr=2),
    X("kernel", "fold_eval", 58, 4, corr=3),  # overlaps the one before
    X("gpu_memcpy", "Memcpy HtoD", 12, 3),  # no launch event: its own start decides
    X("kernel", "outside", 150, 10, corr=4),
    X("cpu_op", "aten::add", 0, 1),
]


@pytest.fixture
def trace():
    return Trace(EVENTS)


def test_window_and_busy_union(trace):
    assert trace.window_s() == pytest.approx(100e-6)
    assert trace.busy_intervals() == [(12, 15), (30, 40), (55, 62)]
    assert trace.busy_s() == pytest.approx(20e-6)


def test_device_time_belongs_to_the_launching_span(trace):
    assert trace.span_device_s("delta_msm") == pytest.approx(13e-6)  # 10 + the copy's 3
    assert trace.span_device_s("fold") == pytest.approx(13e-6 + 5e-6 + 4e-6)
    assert trace.span_device_s("nothing") == 0.0
    assert trace.launched_in_trace == 2


def test_top_ops_and_idle_gaps(trace):
    ops = dict(trace.top_ops())
    assert ops["fold_eval"] == pytest.approx(9e-6) and ops["msm_fixed"] == pytest.approx(10e-6)
    gaps = dict(trace.idle_gaps())
    # the gaps 0-12, 15-30 and 40-55 lie in "fold"; 62-100 has its middle past it
    assert gaps["fold"] == pytest.approx((12 + 15 + 15) * 1e-6)
    assert gaps["host"] == pytest.approx((100 - 62) * 1e-6)
    assert sum(gaps.values()) == pytest.approx(trace.window_s() - trace.busy_s())


def test_from_file_and_a_trace_without_window(tmp_path):
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": EVENTS}))
    assert Trace.from_file(str(path)).busy_s() == pytest.approx(20e-6)
    with pytest.raises(ValueError):
        Trace(EVENTS[1:])


def reader(name):
    from harness.cell import BENCH, load_module

    return load_module(f"{BENCH}/metrics/{name}.py", f"test_metric_{name}").read


def fake_run(trace):
    from harness.runner import Run
    from harness.window import Window

    return Run("cell", {}, {}, 12.5, Window(0.0, 3.0, [1.0, 0.5, 1.5]),
               spans={"synthesize": [4, 0.8], "witness_commit": [4, 0.2],
                      "VanillaFS.commit_cross_terms": [4, 0.6], "witness_fold": [4, 0.4]},
               harness={"zero_step_s": [0.1, 0.3], "verify_s": [0.2]}, trace=trace,
               profiled_units=2, problems={"delta_msm_s": 6.5e-6, "cross_terms_s": 4.5e-6},
               span_units_from=2, span_units=2)


@pytest.mark.parametrize("name,want", [
    ("setup_s", 12.5),
    ("step_s", 1.0),
    ("proof_s", 1.0),
    ("step_p90_s", 1.5),
    ("step_s.snarkstar", 1.5),  # the units after the 2 profiled ones
    ("synthesize_ms.steady", 400.0),
    ("witness_commit_ms.steady", 100.0),
    ("cross_terms_ms.steady", 300.0),
    ("witness_fold_ms.steady", 200.0),
    ("zero_step_ms.proofs", 200.0),
    ("verify_ms.proofs", 200.0),
    ("device_idle_pct.steady", 80.0),
    ("device_idle_pct.proofs", 80.0),
    ("device_busy_ms.steady", 0.01),
    ("delta_msm_roofline_pct.steady", 50.0),  # 6.5 of the 13 us launched under delta_msm
    ("cross_term_eval_roofline_pct.steady", None),  # no span cross_term_eval in the trace
])
def test_each_reader_reads_its_metric(trace, name, want):
    got = reader(name)(fake_run(trace))
    assert got == (None if want is None else pytest.approx(want))


@pytest.mark.parametrize("name", ["synthesize_ms.steady", "zero_step_ms.proofs",
                                  "step_s.snarkstar",
                                  "device_idle_pct.steady", "device_busy_ms.steady",
                                  "delta_msm_roofline_pct.steady"])
def test_a_reader_that_finds_nothing_returns_none(name):
    from harness.runner import Run
    from harness.window import Window

    assert reader(name)(Run("cell", {}, {}, 1.0, Window(0.0, 1.0, [1.0]))) is None


def test_a_roofline_above_100_pct_fails_the_run(trace):
    from harness.counts import StaleCount

    run = fake_run(trace)
    run.problems["delta_msm_s"] = 14e-6
    with pytest.raises(StaleCount):
        reader("delta_msm_roofline_pct.steady")(run)
