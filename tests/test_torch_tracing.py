"""The port's span tracing (mira_tpu_torch/utils/tracing.py) against
mira_tpu/utils/tracing.py: `report` and `aggregate` of one fixed span tree
give mira_tpu's lines in mira_tpu's order, MIRA_TRACE=json writes one line
with mira_tpu's keys per span close, `memory_report` with no card gives the
host line alone, a running torch profiler sees each span by name, and
MIRA_SYNC_SPANS fences the five spans mira_tpu fences (on the CPU a fence
waits for nothing)."""

import io
import json
import types
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
