"""The port's native tape VM preparation (utils/native_lib.py
`_tape_prepare`): mira_tpu's liveness renaming in numpy passes
(`_reuse_registers`), in place of its loop over the ops.  The registers
must be mira_tpu's, register for register, and the VM's cell writes must
equal the port's Python VM and mira_tpu's native VM on the same op soup,
at the capture inputs and at fresh ones, with writes of op outputs
(several per op), of inputs and of constants."""

import random

import numpy as np
import pytest

from mira_tpu.table.tape import Tape as MiraTape
from mira_tpu.utils import native_lib as mira_native
from mira_tpu_torch.table.tape import Tape
from mira_tpu_torch.utils import native_lib

from test_tape import BN254_FQ, BN254_FR, _op_soup


def _recorded(tape_cls, vals0):
    """A tape of the op soup over `vals0` whose every result is a cell
    write (the first two results twice), plus writes of an input and of a
    constant."""
    tape = tape_cls()
    tvs = [tape.input(v) for v in vals0]
    outs = _op_soup(tvs)
    for j, o in enumerate(outs):
        red = o % BN254_FQ if o.v >= 1 << 256 else o  # emits must fit 4 words
        tape.record_write(0, j, red.i)
        if j < 2:
            tape.record_write(1, j, red.i)
    tape.record_write(2, 0, tvs[3].i)
    tape.record_write(2, 1, tape.const(12345))
    tape.frozen = True
    return tape


def _by_write(vals, prep, n):
    out = [None] * n
    for i, w_idx in enumerate(prep["dyn_writes"]):
        out[int(w_idx)] = vals[i]
    return out


@pytest.mark.parametrize("trial", range(4))
def test_native_vm_matches_python_vm_and_mira(trial):
    if not native_lib.tape_vm_available():
        pytest.skip("no native toolchain")
    rng = random.Random(20 + trial)
    vals0 = [rng.randrange(BN254_FR) for _ in range(6)]
    tape, mira_tape = _recorded(Tape, vals0), _recorded(MiraTape, vals0)
    vals = vals0 if trial == 0 else [rng.randrange(BN254_FR) for _ in range(6)]
    if trial == 3:
        vals[2] = vals[0]  # invmod of zero
    slots = tape.execute(vals)
    want = [slots[s] for _c, _r, s in tape.writes]
    got, prep = native_lib.tape_vm_write_values(tape, vals)
    n = len(tape.writes)
    by_write = _by_write(got, prep, n)
    dyn = set(int(w) for w in prep["dyn_writes"])
    assert [v for i, v in enumerate(by_write) if i in dyn] == \
        [w for i, w in enumerate(want) if i in dyn]
    # the writes of inputs are listed with their slots; of constants, not
    assert [w for w, _s in prep["static_input_writes"]] == [n - 2]
    m_got, m_prep = mira_native.tape_vm_write_values(mira_tape, vals)
    # mira_tpu's liveness renaming, register for register
    assert prep["n_regs"] == m_prep["n_regs"] < prep["n_static"] + len(tape.op_code)
    for key in ("a_reg", "b_reg", "out_reg"):
        assert np.array_equal(prep[key], m_prep[key])
    assert _by_write(m_got, m_prep, n) == by_write
    assert [int(w) for w in prep["dyn_writes"]] == list(m_prep["dyn_writes"])
    assert np.array_equal(prep["emit_start"], m_prep["emit_start"])
    assert np.array_equal(prep["emit_dst"], m_prep["emit_dst"])


def _random_program(tape_cls, seed, n_ops):
    """`n_ops` modular adds, products and differences over five inputs,
    each operand drawn from the last 2, 5 or 50 values or from all of them
    (short and long lifetimes, operands used twice in one op, values read
    by no op), about a third of them written to cells."""
    rng = random.Random(seed)
    tape = tape_cls()
    live = [tape.input(rng.randrange(BN254_FR)) for _ in range(5)]
    p = tape.const(BN254_FR)
    for i in range(n_ops):
        a, b = (rng.choice(live[-rng.choice((2, 5, 50, len(live))):]) for _ in "ab")
        r = ((a + b) % p, (a * b) % p, (a - b) % p)[rng.randrange(3)]
        live.append(r)
        if rng.random() < 0.3:
            tape.record_write(0, i, r.i)
    tape.frozen = True
    return tape


@pytest.mark.parametrize("n_ops", [1, 3, 100, 4000])
def test_register_reuse_matches_mira_renaming(n_ops):
    """`_reuse_registers` gives mira_tpu's renaming loop's registers and
    register count on random programs, and the VM then writes the Python
    VM's values."""
    tape, mira_tape = (_random_program(cls, n_ops, n_ops) for cls in (Tape, MiraTape))
    prep = native_lib._tape_prepare(tape)
    m_prep = mira_native._tape_prepare(mira_tape)
    assert prep["n_regs"] == m_prep["n_regs"]
    for key in ("a_reg", "b_reg", "out_reg"):
        assert np.array_equal(prep[key], m_prep[key])
    if not native_lib.tape_vm_available():
        pytest.skip("no native toolchain")
    vals = [random.Random(n_ops).randrange(BN254_FR) for _ in range(5)]
    slots = tape.execute(vals)
    got, prep = native_lib.tape_vm_write_values(tape, vals)
    want = [slots[tape.writes[int(w)][2]] for w in prep["dyn_writes"]]
    assert got == want
