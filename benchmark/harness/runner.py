"""One run of one cell: set-up, warm-up, the measured window, the check
that decides `correct`, the metrics, one result line.

The traffic mix names its unit of work:
- `fold_step`: one long IVC from a seeded z0, one fold step a unit;
- `proof`: a fresh IVC from a seeded z0 (its zero step), `folds_per_proof`
  fold steps, the program's strict verify; a proof the program refuses
  counts as failed.
A system draws its own z0 where it defines `draw_z0(rng)` (a start state
that is not a random field element, such as a tree's root), else one field
element a side is drawn here.
Units run whole, each ending in torch.cuda.synchronize().  With --trace 1
the program's spans are on (MIRA_SYNC_SPANS=1), and the first
`profile_units` units of the window run under torch.profiler.
"""

from __future__ import annotations

import inspect
import json
import os
import random
import shutil
import sys
import tempfile
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from . import guard, window
from .cell import Cell, ck_k
from .profile import WINDOW, Trace


@dataclass
class Run:
    """What the metric readers read."""

    cell: str
    config: dict
    traffic: dict
    setup_s: float
    window: window.Window
    spans: Dict[str, list] = field(default_factory=dict)
    harness: Dict[str, List[float]] = field(default_factory=dict)
    trace: Optional[Trace] = None
    profiled_units: int = 0
    problems: Dict[str, float] = field(default_factory=dict)
    span_units_from: int = 0  # the first unit the spans cover
    span_units: int = 0  # the units the spans cover


def draw_z0(rng: random.Random, moduli) -> dict:
    return {"primary": [rng.randrange(moduli[0])], "secondary": [rng.randrange(moduli[1])]}


def start_state(system, rng: random.Random) -> dict:
    """z0 of a new IVC: the system's own draw where it has one."""
    draw = getattr(system, "draw_z0", None)
    return draw(rng) if draw is not None else draw_z0(rng, system.moduli())


class Faults:
    """Faults planted in the program for the control and fault runs
    (`--fault`), never in the benchmark's own runs."""

    NAMES = ("none", "drop_cross_term", "unchanged_step", "altered_answer", "altered_z",
             "altered_gt")

    def __init__(self, name: str, seed: int):
        if name not in self.NAMES:
            raise ValueError(f"unknown fault {name!r}")
        self.name = name
        self.rng = random.Random(seed ^ 0x5EED)

    def plant(self):
        if self.name == "drop_cross_term":
            from mira_tpu_torch.plonk import structure

            fold = structure.RelaxedPlonkWitness.fold

            def fold_without_t1(self_, W2, cross_terms, r, mesh=None):
                terms = list(cross_terms)
                terms[0] = self_.lf.zero(tuple(terms[0].shape[:-1]), terms[0].device)
                return fold(self_, W2, terms, r, mesh=mesh)

            structure.RelaxedPlonkWitness.fold = fold_without_t1
        elif self.name == "unchanged_step":
            from mira_tpu_torch.ivc.ivc import IVC

            IVC.fold_step = lambda self_, mesh=None: None

    def after_fold(self, ivc):
        if self.name == "altered_answer":  # one word of the primary E
            E = ivc.primary.relaxed_trace.W.E
            row = self.rng.randrange(E.shape[0])
            E[row, 0] = E[row, 0] ^ 1
        elif self.name == "altered_z":  # the primary z_i, one bit
            ivc.primary.z_i = [ivc.primary.z_i[0] ^ 1] + list(ivc.primary.z_i[1:])
        elif self.name == "altered_gt":  # the primary Gt accumulator times a Gt element
            from mira_tpu_torch.curves.host import Tuple12

            U = ivc.primary.relaxed_trace.U
            U.gt_element = U.gt_element.mul(Tuple12.generator(U.gt_element.F))


def err(line: str):
    print(line, file=sys.stderr, flush=True)


def run(args, root: str, t_start: float, data_dirs=None):
    """Returns (exit code, result dict or None)."""
    from .cell import read_json

    manifest = read_json(args.manifest or os.path.join(root, "BENCHMARK.json"))
    cell = Cell(manifest, args.workload, data_dirs)
    chips = cell.entry["chips"]
    trace_on = bool(args.trace)

    import torch

    if args.device == "cuda":
        if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
            err(f"{cell.name} needs {chips} CUDA device(s); "
                f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} visible")
            return 3, None
        device = torch.device("cuda", 0)
        sync = torch.cuda.synchronize
    else:
        device = torch.device("cpu")
        sync = lambda: None  # noqa: E731

    rng = random.Random(args.seed)
    faults = Faults(args.fault, args.seed)
    faults.plant()
    system = cell.system().System(cell.config, device, root)
    _make_keys(system, cell.config)
    system.setup()
    traffic = cell.traffic
    unit = traffic["unit"]
    res = Run(cell.name, cell.config, traffic, 0.0, None)
    deltas: List[int] = []
    folds_profiled = [0]
    profiling = [False]
    if trace_on:
        for side in (system.pp.primary, system.pp.secondary):
            _watch_delta(side.ck, deltas, profiling)

    state = {}

    def fold(ivc):
        system.fold(ivc)
        faults.after_fold(ivc)
        if profiling[0]:
            folds_profiled[0] += 1

    if unit == "fold_step":
        z0 = start_state(system, rng)
        ivc = system.new_ivc(z0)
        for _ in range(traffic["warm_units"]):
            fold(ivc)
        sync()
        state.update(ivc=ivc, z0=z0, folds=traffic["warm_units"])

        def one(i):
            fold(state["ivc"])
            sync()
            state["folds"] += 1
    elif unit == "proof":
        keep_rng = random.Random(args.seed ^ 0x9E3779B9)
        res.harness = {"zero_step_s": [], "verify_s": []}
        proofs = state.setdefault("proofs", [])
        failed = [0]

        def prove(z0, record: bool):
            t0 = time.perf_counter()
            ivc = system.new_ivc(z0)
            sync()
            t1 = time.perf_counter()
            for _ in range(traffic["folds_per_proof"]):
                fold(ivc)
            sync()
            t2 = time.perf_counter()
            refused = system.verify(ivc)
            if refused:
                err(f"the program's verify refused a proof: {refused}")
            sync()
            t3 = time.perf_counter()
            if record and not profiling[0]:
                res.harness["zero_step_s"].append(t1 - t0)
                res.harness["verify_s"].append(t3 - t2)
            return ivc, not refused

        for _ in range(traffic["warm_units"]):
            prove(start_state(system, rng), False)

        def one(i):
            z0 = start_state(system, rng)
            ivc, ok = prove(z0, True)
            failed[0] += int(not ok)
            proofs.append((z0, [list(ivc.primary.z_i), list(ivc.secondary.z_i)], ivc.step))
            # one proof kept for the decider, uniformly among those made
            if keep_rng.randrange(len(proofs)) == 0:
                state["kept"] = (z0, ivc)
            del ivc

        state["failed"] = failed
    else:
        raise ValueError(f"unknown unit {unit!r}")
    sync()

    if trace_on:
        from mira_tpu_torch.utils import tracing

        tracing.reset()
    res.setup_s = time.perf_counter() - t_start
    n_prof = traffic["profile_units"] if trace_on else 0

    def unit_fn(i):
        if i < n_prof:
            profiling[0] = True
            _profiled_unit(one, i, i == 0, i == n_prof - 1, state)
            profiling[0] = False
            return
        if i == n_prof and trace_on:
            # the spans are read over the units after the profiled ones
            from mira_tpu_torch.utils import tracing

            tracing.reset()
            res.span_units_from = i
        one(i)

    res.window = window.run(args.seconds, unit_fn)
    bad = guard.loaded()
    if bad:
        err(f"loaded in this process: {', '.join(bad)}")
        return 4, None
    memory_peak = torch.cuda.max_memory_allocated(device) if args.device == "cuda" else 0

    if trace_on:
        from mira_tpu_torch.utils import tracing

        res.spans = tracing.totals()
        res.span_units = res.window.units - res.span_units_from
        prof = state.pop("profiler")
        tmp = tempfile.mkdtemp(prefix="bench-trace-")
        try:
            path = os.path.join(tmp, "trace.json")
            prof.export_chrome_trace(path)
            del prof
            res.trace = Trace.from_file(path)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        res.profiled_units = min(n_prof, res.window.units)
        res.problems = system.problems(folds_profiled[0], deltas)

    # -- correctness -------------------------------------------------------------
    t_ref = time.perf_counter()
    ref = cell.reference()
    checked = check(system, ref, cell, state, unit, trace_on)
    ref_s = time.perf_counter() - t_ref
    correct = all(v <= limit for v, limit in checked.values())

    # -- metrics --------------------------------------------------------------------
    kind = "per_layer" if trace_on else "end_to_end"
    metrics = {}
    for m in cell.metrics(kind):
        value = cell.reader(m["name"]).read(res)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if args.device == "cuda" else "cpu",
           "kind": torch.cuda.get_device_name(device) if args.device == "cuda" else "cpu",
           "count": chips, "memory_peak_bytes": int(memory_peak)}
    if trace_on:
        dev["busy_s"] = res.trace.busy_s()
        dev["window_s"] = res.trace.window_s()
    attempted = res.window.units
    failed = state["failed"][0] if "failed" in state else 0
    result = {"correct": correct, "attempted": attempted, "failed": failed,
              "metrics": metrics, "device": dev}
    if trace_on:
        result["breakdown"] = {"device_ops": [[n[:160], v] for n, v in res.trace.top_ops()],
                               "idle_gaps": res.trace.idle_gaps()}
    if trace_on:
        tr = res.trace
        err(f"trace: {len(tr.device)} device events, {tr.launched_in_trace} with their "
            f"launch; {res.profiled_units} units profiled; problems {res.problems}; "
            f"device s under delta_msm {tr.span_device_s('delta_msm'):.6f}, "
            f"cross_term_eval {tr.span_device_s('cross_term_eval'):.6f}")
        top = sorted(res.spans.items(), key=lambda kv: -kv[1][1])[:25]
        err("spans: " + "; ".join(f"{k} {c} {s:.3f}" for k, (c, s) in top))
    err(f"unit seconds: {[round(x, 4) for x in res.window.unit_s]}")
    err(f"set-up {res.setup_s:.3f} s; window {res.window.interval_s:.3f} s, "
        f"{attempted} units; reference {ref_s:.3f} s; peak device memory "
        f"{memory_peak / 2**30:.3f} GiB")
    result["compared"] = {k: {"value": v, "limit": limit} for k, (v, limit) in checked.items()}
    for k, (v, limit) in checked.items():
        err(f"compared {k}: {v} (limit {limit})")
    print(json.dumps(result), flush=True)
    return 0, result


def _make_keys(system, cfg):
    """The Pedersen key files, made by the benchmark (reference/keys.py)
    where the checkout has none, before the program reads them."""
    from reference import decider, keys

    for side in ("primary", "secondary"):
        s = cfg[side]
        if s["key"] != "mock":
            keys.ensure_key(decider.CURVES[s["curve"]], s["key_label"], ck_k(cfg, side),
                            system.key_file(side))


def _watch_delta(ck, widths: List[int], profiling):
    """Record the width of every delta commitment made while profiling
    (the problem size of the delta MSM)."""
    commit = ck.commit_delta

    def watched(dw):
        if profiling[0]:
            widths.append(int(len(dw.positions_np)))
        return commit(dw)

    ck.commit_delta = watched


def _profiled_unit(one, i, first, last, state):
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    if first:
        prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        prof.__enter__()
        scope = record_function(WINDOW)
        scope.__enter__()
        state["profiler"], state["scope"] = prof, scope
    one(i)
    if last:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        state.pop("scope").__exit__(None, None, None)
        state["profiler"].__exit__(None, None, None)


def check(system, ref, cell, state, unit, trace_on) -> Dict[str, tuple]:
    """Named (number, limit) pairs; every limit is 0: the comparison is exact.
    A reference whose `z_after` takes `inputs` gets what the system fed the
    judged IVC's steps (`system.step_inputs(ivc)`); one that defines
    `decide_more(ivc, system, cfg)` adds its configuration's own counts."""
    from reference import decider

    cfg = cell.config
    moduli = system.moduli()
    judged = state["ivc"] if unit == "fold_step" else state["kept"][1]
    extra = {}
    if "inputs" in inspect.signature(ref.z_after).parameters:
        extra["inputs"] = system.step_inputs(judged)

    def z_after(side, z0, steps):
        return ref.z_after(cfg, moduli, side, z0, steps, **extra)

    keys = {}
    for side in ("primary", "secondary"):
        s = cfg[side]
        curve = decider.CURVES[s["curve"]]
        if s["key"] == "mock":
            keys[side] = decider.Key(curve, mock_label=s["key_label"].encode(),
                                     mock_k=ck_k(cfg, side))
        else:
            import numpy as np

            keys[side] = decider.Key(curve, rows=np.load(system.key_file(side), mmap_mode="r"))
    out = {}
    if unit == "fold_step":
        found = decider.decide(state["ivc"], state["z0"], state["folds"], z_after, keys,
                               cfg["ro"], cfg["structure"])
    else:
        fp = cell.traffic["folds_per_proof"]
        wrong = 0
        for z0, zi, step in state["proofs"]:
            wrong += int(step != fp + 1)
            wrong += sum(int(zi[k] != z_after(side, z0[side], fp + 1))
                         for k, side in enumerate(("primary", "secondary")))
        out["proof_z_values"] = (wrong, 0)
        out["proofs_refused"] = (state["failed"][0], 0)
        z0, ivc = state["kept"]
        found = decider.decide(ivc, z0, fp, z_after, keys, cfg["ro"], cfg["structure"])
    if hasattr(ref, "decide_more"):
        found.update(ref.decide_more(judged, system, cfg))
    for k, v in found.items():
        out[k] = (v, 0)
    return out
