"""The port's span tracing (mira_tpu_torch/utils/tracing.py) against
mira_tpu/utils/tracing.py: `report` and `aggregate` of one fixed span tree
give mira_tpu's lines in mira_tpu's order, MIRA_TRACE=json writes one line
with mira_tpu's keys per span close, `memory_report` with no card gives the
host line alone, a running torch profiler sees each span by name, and
MIRA_SYNC_SPANS fences the five spans mira_tpu fences (on the CPU a fence
waits for nothing).  The counters: `count` charges the innermost open span,
`span_counts` sums the tree, `reset` clears the spans' counts and not the
process-wide totals, torch's sync warnings land in `host_sync`, the kernel
wrappers count under the names of `KERNELS`, and one k=17 fold step opens
the spans over its host work under the spans that hold them."""

import io
import json
import os
import re
import time
import types
import warnings
from contextlib import redirect_stderr

import numpy as np
import pytest
import torch

from mira_tpu.utils import tracing as mira_tracing
from mira_tpu_torch.curves.host import BN254_G1
from mira_tpu_torch.fields.limbs import limb_field
from mira_tpu_torch.ops import commitment
from mira_tpu_torch.table import packed
from mira_tpu_torch.utils import tracing

from torch_port_helpers import k17_trivial_pp

# (name, start, end, children): two roots, repeated names at several depths,
# spans shorter than the filters below
TREE = [
    ("fold_step", 0.0, 3.0, [
        ("synthesize", 0.0, 0.8, []),
        ("commit", 0.8, 1.9, [("msm", 0.9, 1.7, []), ("decode", 1.7, 1.705, [])]),
        ("cross_terms", 1.9, 2.9, [("msm", 2.0, 2.5, []), ("eval", 2.5, 2.8, [])]),
    ]),
    ("fold_step", 3.0, 5.5, [("synthesize", 3.0, 3.6, []),
                             ("commit", 3.6, 4.1, [("msm", 3.7, 4.0, [])])]),
    ("verify", 5.5, 5.5004, []),
]


def _load(module):
    """Put TREE into a tracing module's collector, by its own _Span class."""
    module.reset()

    def build(node, parent):
        name, start, end, children = node
        s = module._Span(name, parent)
        s.start, s.end = start, end
        s.children = [build(c, s) for c in children]
        return s

    module._state.roots = [build(n, None) for n in TREE]


@pytest.mark.parametrize("min_runtime", [0.0, 0.01, 0.5, 2.6])
def test_report_and_aggregate_match_mira(min_runtime):
    _load(mira_tracing)
    _load(tracing)
    try:
        assert tracing.report(min_runtime) == mira_tracing.report(min_runtime)
        got = tracing.aggregate(min_runtime)
        assert got == mira_tracing.aggregate(min_runtime)
    finally:
        tracing.reset()
        mira_tracing.reset()
    if min_runtime == 0.0:
        lines = got.splitlines()
        assert lines[:2] == ["msm: n=3 busy 1.600s total 1.600s",
                             "fold_step: n=2 busy 1.500s total 5.500s"]
        assert len(lines) == 8


def test_trace_json_lines(monkeypatch):
    monkeypatch.setenv("MIRA_TRACE", "json")
    err = io.StringIO()
    tracing.reset()
    with redirect_stderr(err):
        with tracing.span("outer"):
            with tracing.span("inner"):
                pass
    tracing.reset()
    rows = [json.loads(line) for line in err.getvalue().splitlines()]
    assert [r["span"] for r in rows] == ["inner", "outer"]
    for r in rows:
        assert set(r) == {"span", "enter", "close", "busy_s", "total_s"}
        assert r["close"] >= r["enter"]
        assert r["busy_s"] <= r["total_s"]
    monkeypatch.setenv("MIRA_TRACE", "off")
    with redirect_stderr(err):
        with tracing.span("off") as s:
            assert s is None
    assert not tracing._state.roots
    assert len(err.getvalue().splitlines()) == 2


def test_memory_report_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    lines = tracing.memory_report().splitlines()
    assert len(lines) == 1
    want = mira_tracing.memory_report().splitlines()[0]
    assert lines[0].split(":")[0] == want.split(":")[0] == "host peak RSS"
    assert lines[0].endswith(" GB")


def test_spans_named_in_a_profile():
    """Without a profiler a span opens no record_function; under one, each
    span is an event of its name."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with tracing.span("mira_span_outer"):
            with tracing.span("mira_span_inner"):
                torch.ones(4).sum()
    tracing.reset()
    names = {e.key for e in prof.key_averages()}
    assert {"mira_span_outer", "mira_span_inner"} <= names
    assert not torch.autograd._profiler_enabled()


def test_sync_spans_fence_the_five_spans(monkeypatch):
    """Each of delta_scalars, delta_msm, delta_decode (ops/commitment.py),
    vals_to_mont and witness_scatter (table/packed.py) calls `fence` inside
    itself; with MIRA_SYNC_SPANS=1 a fence on CPU tensors synchronizes
    nothing and returns its argument."""
    monkeypatch.setenv("MIRA_SYNC_SPANS", "1")
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda *a: pytest.fail("a CPU tensor was fenced on a card"))
    seen = []

    def recording(x):
        seen.append(tracing._state.current.name)
        return tracing.fence(x)

    monkeypatch.setattr(commitment, "fence", recording)
    monkeypatch.setattr(packed, "fence", recording)
    lf = limb_field(BN254_G1.scalar_modulus)
    rng = np.random.default_rng(3)
    p = lf.modulus
    ncols, nrow = 2, 16
    template = [int(x) % p for x in rng.integers(0, 1 << 62, size=ncols * nrow)]
    positions = np.sort(rng.choice(ncols * nrow, size=5, replace=False))
    vals = [int(x) % p for x in rng.integers(0, 1 << 62, size=len(positions))]
    tmpl = lf.encode(template)
    pos = torch.from_numpy(positions)
    token = types.SimpleNamespace(
        uid=17, packed_template=np.asarray(template, dtype=object).astype(str))
    dw = packed.DeviceWitness(lf, token, tmpl, tmpl[pos], pos, positions,
                              lf.to_plain(lf.encode(vals)), ncols, nrow)
    ck = commitment.CommitmentKey.setup(BN254_G1, 5, b"fence", device="cpu")
    tracing.reset()
    dw.encode_mont(lf)
    full = list(template)
    for i, v in zip(positions, vals):
        full[i] = v
    assert ck.commit_delta(dw) == ck.commit_ints(full)
    tracing.reset()
    assert sorted(seen) == sorted(["witness_scatter", "vals_to_mont",
                                   "delta_scalars", "delta_msm", "delta_decode"])
    x = torch.ones(3)
    assert tracing.fence(x) is x and tracing.fence((x, x))[0] is x


def _grown(before: dict) -> dict:
    """The process-wide totals that moved since `before`, by how much."""
    now = tracing.counts()
    return {k: v - before.get(k, 0) for k, v in now.items() if v != before.get(k, 0)}


def test_count_charges_the_innermost_span():
    tracing.reset()
    with tracing.span("outer"):
        tracing.count("mira_test_a")
        with tracing.span("inner"):
            tracing.count("mira_test_a", 2)
            tracing.count("mira_test_b")
        with tracing.span("inner"):
            tracing.count("mira_test_b", 3)
    try:
        assert tracing.counts_by_span() == {
            "outer": {"mira_test_a": 1},
            "inner": {"mira_test_a": 2, "mira_test_b": 4}}
    finally:
        tracing.reset()


def test_span_counts_sum_the_tree_and_skip_counts_outside_spans():
    tracing.reset()
    before = tracing.counts()
    tracing.count("mira_test_c", 5)  # outside every span
    with tracing.span("a"):
        tracing.count("mira_test_c")
        with tracing.span("b"):
            with tracing.span("c"):
                tracing.count("mira_test_c", 2)
    with tracing.span("d"):
        tracing.count("mira_test_d")
    try:
        assert tracing.span_counts() == {"mira_test_c": 3, "mira_test_d": 1}
        assert _grown(before) == {"mira_test_c": 8, "mira_test_d": 1}
    finally:
        tracing.reset()


def test_span_counts_until_leave_out_later_spans():
    """`until` keeps the counts of the spans opened before it and leaves out
    those of spans opened later, a later child of an earlier span too."""
    tracing.reset()
    with tracing.span("a"):
        tracing.count("mira_test_g")
        cut = time.perf_counter()
        with tracing.span("b"):
            tracing.count("mira_test_g", 2)
    with tracing.span("c"):
        tracing.count("mira_test_g", 4)
    try:
        assert tracing.span_counts(until=cut) == {"mira_test_g": 1}
        assert tracing.counts_by_span(until=time.perf_counter()) == {
            "a": {"mira_test_g": 1}, "b": {"mira_test_g": 2}, "c": {"mira_test_g": 4}}
        assert tracing.span_counts() == {"mira_test_g": 7}
    finally:
        tracing.reset()


def test_reset_clears_span_counts_but_not_totals():
    tracing.reset()
    before = tracing.counts()
    with tracing.span("a"):
        tracing.count("mira_test_e", 4)
    assert tracing.span_counts() == {"mira_test_e": 4}
    tracing.reset()
    assert tracing.span_counts() == {} and tracing.counts_by_span() == {}
    assert _grown(before) == {"mira_test_e": 4}
    # set_counts puts back saved totals, as chip_smoke.py's `uncounted` does
    saved = {"mira_test_e": tracing.counts()["mira_test_e"]}
    tracing.count("mira_test_e", 9)
    tracing.set_counts(saved)
    assert tracing.counts()["mira_test_e"] == saved["mira_test_e"]


def test_trace_off_keeps_totals_and_records_no_span(monkeypatch):
    monkeypatch.setenv("MIRA_TRACE", "off")
    tracing.reset()
    before = tracing.counts()
    with tracing.span("a"):
        tracing.count("mira_test_f")
        with tracing.span("b"):
            tracing.count("mira_test_f", 2)
    assert not tracing._state.roots and tracing.span_counts() == {}
    assert _grown(before) == {"mira_test_f": 3}


def test_sync_warnings_count_as_host_syncs():
    """torch's sync debug mode "warn" raises one UserWarning a sync, from
    the Python line that made it; sent by hand here (the CPU has no syncs):
    each one counts as `host_sync` (charged to the innermost span, or to the
    totals alone outside spans) and none is shown; other warnings are."""
    text = f"{tracing.SYNC_WARNING} (Triggered internally at CUDAFunctions.cpp:160.)"
    tracing.reset()
    before = tracing.counts()
    with warnings.catch_warnings(record=True) as shown:
        tracing._route_sync_warnings()
        with tracing.span("step"):
            with tracing.span("combine"):
                for _ in range(3):  # one line, so one warning registry entry
                    warnings.warn(text, UserWarning)
            warnings.warn(text, UserWarning)
            warnings.warn("mira_test another warning", UserWarning)
        warnings.warn(text, UserWarning)
    try:
        assert tracing.counts_by_span() == {"combine": {tracing.HOST_SYNC: 3},
                                            "step": {tracing.HOST_SYNC: 1}}
        assert tracing.span_counts() == {tracing.HOST_SYNC: 4}
        assert _grown(before) == {tracing.HOST_SYNC: 5}
        assert [str(w.message) for w in shown] == ["mira_test another warning"]
    finally:
        tracing.reset()


PACKAGE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                       "mira_tpu_torch")


def test_kernel_wrappers_count_the_named_kernels():
    """The names the kernel wrappers count under are `tracing.KERNELS`, each
    once, and no module keeps a launch counter of its own."""
    named = []
    for path in ("ops/cuda_msm.py", "ops/cuda_ntt.py", "ops/cuda_poseidon.py",
                 "polynomial/fold_evaluator.py", "ops/field_lincomb.py"):
        with open(os.path.join(PACKAGE, path)) as f:
            src = f.read()
        for call in re.findall(r"tracing\.count\(([^)]*)\)", src):
            named += re.findall(r'"([a-z0-9_]+)"', call)
        assert not re.search(r"^\w*launches\s*=", src, re.M), path
    assert sorted(named) == sorted(tracing.KERNELS)


def test_fold_step_spans_nest(monkeypatch):
    """One fold step of the k=17 trivial IVC (mock keys; the native row VM
    evaluates the cross terms) under MIRA_TRACE=collect: the zero step is the
    construction's one root, over both sides' synthesis and first trace; the
    NIFS challenge and the instance fold are children of VanillaFS.prove;
    the tape route's parts are children of synthesize.  Names and nesting
    only, never times."""
    from mira_tpu_torch.ivc.ivc import IVC
    from mira_tpu_torch.ivc.step_circuit import TrivialCircuit
    from mira_tpu_torch.ivc.tape_runner import uses_tape

    monkeypatch.setenv("MIRA_TRACE", "collect")
    monkeypatch.setenv("MIRA_FOLD_EVAL", "native")
    pp = k17_trivial_pp()
    tracing.reset()
    ivc = IVC(pp, TrivialCircuit(arity=1), [11], TrivialCircuit(arity=1), [22])
    roots = tracing._state.roots
    assert [r.name for r in roots] == ["IVC.zero_step"]
    assert [c.name for c in roots[0].children] == [
        "synthesize", "VanillaFS.generate_plonk_trace"] * 2
    tracing.reset()
    ivc.fold_step()
    (step,) = tracing._state.roots
    tracing.reset()
    assert step.name == "IVC.fold_step"
    proves = [c for c in step.children if c.name == "VanillaFS.prove"]
    synths = [c for c in step.children if c.name == "synthesize"]
    assert len(proves) == len(synths) == 2
    for prove in proves:
        assert [c.name for c in prove.children] == [
            "VanillaFS.commit_cross_terms", "nifs_challenge", "instance_fold",
            "witness_fold"]
    tape = uses_tape(TrivialCircuit(arity=1))
    for synth in synths:
        assert [c.name for c in synth.children] == (
            ["step_inputs", "tape_vm", "replay_pack", "replay_upload"] if tape else [])
