"""Capture/replay of StepFoldingCircuit synthesis via the witness tape
(table/tape.py).

The SFC's synthesis structure is identical for every fold step (the base
case is selected in-circuit, not by Python control flow — reference
step_folding_circuit.rs:294-548) so the first synthesis is captured as a
straight-line program over the step inputs and replayed for later steps,
replacing the dominant per-step Python cost with a VM pass.

Input binding: `_traverse_step_inputs` is the single source of truth for the
flattening order — capture wraps each signal as a tape input, replay
extracts the same flat list.  Host group elements use the chips' own
encodings (identity = all-zero coordinates), so `is_inf` branches move from
synthesis (structure!) to input extraction (values).

Port of mira_tpu/ivc/tape_runner.py: replay always yields a DeviceWitness on
the commitment key's device, filled by the native tape VM
(utils/native_lib.py).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List

from ..table.circuit import ConstraintSystem, RegionCtx, TableData
from ..table.tape import Tape

from .step_folding_circuit import StepFoldingCircuit, StepInputs


class _VF:
    """Duck-typed field element: just carries .v (int or TV)."""

    __slots__ = ("v",)

    def __init__(self, v):
        self.v = v


class _Pt:
    """Duck-typed AffinePoint; identity is encoded as (0, 0) coordinates —
    exactly what FoldRelaxedPlonkInstanceChip._assign_point writes."""

    __slots__ = ("x", "y", "is_inf")

    def __init__(self, x, y):
        self.x = _VF(x)
        self.y = _VF(y)
        self.is_inf = False


class _Fq2:
    __slots__ = ("c0", "c1")

    def __init__(self, c0, c1):
        self.c0 = _VF(c0)
        self.c1 = _VF(c1)


class _G2:
    __slots__ = ("x", "y", "is_inf")

    def __init__(self, x0, x1, y0, y1):
        self.x = _Fq2(x0, x1)
        self.y = _Fq2(y0, y1)
        self.is_inf = False


class _T12:
    __slots__ = ("elements",)

    def __init__(self, elements):
        self.elements = [_VF(e) for e in elements]


class _Instance:
    """Duck-typed (Relaxed)PlonkInstance view for the fold chip."""

    def __init__(self, **kw):
        self.__dict__.update(kw)


def _pt_coords(p):
    return (0, 0) if p.is_inf else (p.x.v, p.y.v)


def _g2_coords(p):
    if p.is_inf:
        return (0, 0, 0, 0)
    return (p.x.c0.v, p.x.c1.v, p.y.c0.v, p.y.c1.v)


def _traverse_step_inputs(si: StepInputs, emit: Callable[[int], object]):
    """Walk every per-step signal in canonical order, building a wrapped
    StepInputs whose values are whatever `emit` returns (TVs at capture,
    the ints themselves at extraction)."""

    def pt(p):
        x, y = _pt_coords(p)
        return _Pt(emit(x), emit(y))

    def g2(p):
        return _G2(*(emit(c) for c in _g2_coords(p)))

    def t12(t):
        return _T12([emit(e.v) for e in t.elements])

    step = emit(si.step)
    pp_hash = pt(si.public_params_hash)
    z_0 = [emit(v) for v in si.z_0]
    z_i = [emit(v) for v in si.z_i]

    U = si.U
    wU = _Instance(
        curve=U.curve,
        W_commitments=[pt(c) for c in U.W_commitments],
        E_commitment=pt(U.E_commitment),
        instance=[emit(v) for v in U.instance],
        challenges=[emit(c) for c in U.challenges],
        u=emit(U.u),
        g1_elements=[pt(g) for g in U.g1_elements],
        g2_elements=[g2(g) for g in U.g2_elements],
        gt_element=t12(U.gt_element),
    )
    u = si.u
    wu = _Instance(
        curve=u.curve,
        W_commitments=[pt(c) for c in u.W_commitments],
        instance=[emit(v) for v in u.instance],
        challenges=[emit(c) for c in u.challenges],
        g1_elements=[pt(g) for g in u.g1_elements],
        g2_elements=[g2(g) for g in u.g2_elements],
    )
    cross = [pt(c) for c in si.cross_term_commits]
    cross_gt = [t12(t) for t in si.cross_term_gt_commits]

    return StepInputs(
        step=step,
        step_pp=si.step_pp,
        public_params_hash=pp_hash,
        z_0=z_0,
        z_i=z_i,
        U=wU,
        u=wu,
        cross_term_commits=cross,
        cross_term_gt_commits=cross_gt,
    )


def flatten_step_inputs(si: StepInputs, step_circuit) -> List[int]:
    vals: List[int] = []

    def emit(v):
        vals.append(int(v))
        return v

    _traverse_step_inputs(si, emit)
    vals.extend(int(v) for v in step_circuit.tape_signals())
    return vals


_UID = __import__("itertools").count()


@dataclasses.dataclass
class CapturedSynthesis:
    tape: Tape
    advice_template: List[List[int]]  # captured columns incl. static cells
    num_advice: int
    k: int
    modulus: int = 0  # witness scalar field (for the device-resident path)
    packed_template: object = None  # lazy (num_advice*nrow, 16) uint32
    # device-resident replay (table/packed.py DeviceWitness), built lazily:
    dev_template_mont: object = None  # (num_advice*nrow, 16) Montgomery
    dev_template_vals: object = None  # (nwrites, 16) Montgomery @ positions
    dev_positions: object = None  # (nwrites,) int32, device
    dev_positions_np: object = None  # same, host
    dev_keep: object = None  # dedup (last-write-wins) index selector
    dev_static_slots: object = None  # [(input slot)] for static input writes
    uid: int = dataclasses.field(default_factory=lambda: next(_UID))


def uses_tape(step_circuit) -> bool:
    """Whether step-folding circuits over `step_circuit` are synthesized
    once and then replayed from the witness tape."""
    import os

    return (getattr(step_circuit, "tape_safe", False)
            and os.environ.get("MIRA_SYNTH", "tape") == "tape")


def capture_runner(runner):
    """Synthesize `runner`'s step-folding circuit once in capture mode and
    keep the captured table as the runner's synthesis (its structure and
    witness are a plain synthesis's: the same cells, fixed values and
    copies).  Returns the CapturedSynthesis, which later syntheses of the
    same circuit replay with their own inputs."""
    captured, cs, table = _capture(runner.k, runner.circuit, runner.instance,
                                   runner.curve)
    runner.use_synthesis(cs, table)
    return captured


def capture_sfc(k: int, sfc: StepFoldingCircuit, instance: List[int], curve):
    """Synthesize once in capture mode; returns (CapturedSynthesis, witness)."""
    captured, _cs, table = _capture(k, sfc, instance, curve)
    return captured, table.advice


def _capture(k: int, sfc: StepFoldingCircuit, instance: List[int], curve):
    tape = Tape()
    wrapped_inputs = _traverse_step_inputs(sfc.inputs, tape.input)
    wrapped_sc = sfc.step_circuit.wrap_for_tape(tape)
    traced_sfc = StepFoldingCircuit(wrapped_sc, wrapped_inputs)

    cs = ConstraintSystem()
    config = traced_sfc.configure(cs)
    table = TableData(k, cs, instance, curve.scalar_modulus)
    table.tape = tape
    traced_sfc.synthesize(config, RegionCtx(table))
    tape.frozen = True

    captured = CapturedSynthesis(
        tape=tape,
        advice_template=[col.copy() for col in table.advice],
        num_advice=cs.num_advice,
        k=k,
        modulus=curve.scalar_modulus,
    )
    return captured, cs, table


def replay_sfc(captured: CapturedSynthesis, sfc: StepFoldingCircuit, device):
    """Bind this step's inputs and run the tape VM; returns a DeviceWitness
    on `device`."""
    from ..utils.native_lib import tape_vm_available

    if not tape_vm_available():
        raise RuntimeError("witness-tape replay needs the native tape VM "
                           "(native/tape_vm.cpp), which did not load")
    inputs = flatten_step_inputs(sfc.inputs, sfc.step_circuit)
    return _replay_device(captured, inputs, device)


def _replay_device(captured: CapturedSynthesis, inputs: List[int], device):
    """Native VM -> DeviceWitness: per step only the dynamic cell values
    cross to the device; the Montgomery template and the write positions
    are built there once per tape, which enables
    CommitmentKey.commit_delta."""
    import numpy as np
    import torch

    from ..utils.native_lib import tape_vm_run_raw

    from ..fields.limbs import NUM_LIMBS, NUM_WORDS, limb_field
    from ..table.packed import DeviceWitness, pack_int_cols
    from ..utils.tracing import span

    nrow = 1 << captured.k
    lf = limb_field(captured.modulus)
    out_buf, prep = tape_vm_run_raw(captured.tape, inputs)

    if captured.dev_positions is None:  # one-time per tape
        writes = captured.tape.writes
        cells = np.fromiter((c * nrow + r for c, r, _slot in writes), np.int64,
                            len(writes))
        dyn_pos = cells[prep["dyn_writes"]]
        static_pos = cells[np.asarray(
            [w for w, _slot in prep["static_input_writes"]], dtype=np.int64)]
        combined = np.concatenate([dyn_pos, static_pos])
        # each position once, keeping the LAST write per cell (the
        # sequential host-scatter semantics), ordered by position
        _, keep = np.unique(combined[::-1], return_index=True)
        keep = len(combined) - 1 - keep
        captured.dev_keep = keep[np.argsort(combined[keep], kind="stable")]
        positions = combined[captured.dev_keep]
        captured.dev_positions_np = positions
        captured.dev_positions = torch.from_numpy(positions).to(device)
        captured.dev_static_slots = [
            slot for _w, slot in prep["static_input_writes"]
        ]
        if captured.packed_template is None:
            captured.packed_template = pack_int_cols(
                captured.advice_template, nrow
            )
        captured.dev_template_mont = lf.encode_raw16(
            captured.packed_template, device)
        captured.dev_template_vals = captured.dev_template_mont[
            captured.dev_positions
        ]

    # (ndyn, 16) uint16 view of the VM output (4 x 64-bit words per value)
    dyn16 = out_buf.view("<u2").reshape(-1, NUM_LIMBS)
    if captured.dev_static_slots:
        static16 = np.zeros(
            (len(captured.dev_static_slots), NUM_LIMBS), dtype="<u2"
        )
        for i, slot in enumerate(captured.dev_static_slots):
            v = int(inputs[slot])
            static16[i] = [(v >> (16 * j)) & 0xFFFF for j in range(NUM_LIMBS)]
        all16 = np.concatenate([dyn16, static16])
    else:
        all16 = dyn16
    all16 = np.ascontiguousarray(all16[captured.dev_keep])
    with span("replay_upload"):
        vals = torch.from_numpy(
            all16.view("<i4").reshape(-1, NUM_WORDS)).to(device)

    return DeviceWitness(
        lf,
        captured,
        captured.dev_template_mont,
        captured.dev_template_vals,
        captured.dev_positions,
        captured.dev_positions_np,
        vals,
        captured.num_advice,
        nrow,
    )
