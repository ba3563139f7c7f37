"""The port's native tape VM preparation (utils/native_lib.py
`_tape_prepare`): mira_tpu's liveness renaming in numpy passes
(`_reuse_registers`), in place of its loop over the ops.  The registers
must be mira_tpu's, register for register, and the VM's cell writes must
equal the port's Python VM and mira_tpu's native VM on the same op soup,
at the capture inputs and at fresh ones, with writes of op outputs
(several per op), of inputs and of constants.

The port's VM (mira_tpu_torch/native/tape_vm.cpp) runs modular ops by an
odd divisor of at most 4 words, or by a power of two, on fast routes of its
own: on programs dense in MOD, ISZM and INVMOD its output must equal the
shared VM's word for word, its errors the shared VM's, and its route
counters must add up to the program's modular ops."""

import random

import numpy as np
import pytest

from mira_tpu.table.tape import Tape as MiraTape
from mira_tpu.table.tape import invmod_or_one as mira_invmod_or_one
from mira_tpu.table.tape import iszero_mod as mira_iszero_mod
from mira_tpu.utils import native_lib as mira_native
from mira_tpu_torch.table.tape import INVMOD, ISZM, MOD, Tape, invmod_or_one, iszero_mod
from mira_tpu_torch.utils import native_lib, tracing

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


# odd primes of 4 words (BN254's and one of 193 bits), 3, 2 and 1 words,
# powers of two, an even divisor, and an odd divisor wider than 4 words
P64 = (1 << 64) - 59
P127 = (1 << 127) - 1
P161 = (1 << 160) + 7
P193 = (1 << 192) + 133
WIDE_ODD = (1 << 300) + 1  # 17 x 241 x ...
PRIMES = (BN254_FR, BN254_FQ, P193, P161, P127, P64)
MODULI = PRIMES + (1 << 192, 1 << 300, 2 * BN254_FR, WIDE_ODD)


def _modop_program(tape_cls, moduli):
    """MOD, ISZM and (by the odd primes) INVMOD by each of `moduli` of
    eight operands an input, made from four inputs: the input, its
    negation, products of two (to 8 words, and past 8 words for inputs
    past 4), a shift past 8 words, a multiple of m and two neighbours of
    it.  Every result is a cell write (reduced by BN254 Fr where it could
    pass 4 words)."""
    iszm, inv = ((iszero_mod, invmod_or_one) if tape_cls is Tape
                 else (mira_iszero_mod, mira_invmod_or_one))
    tape = tape_cls()
    x = [tape.input(1) for _ in range(4)]
    j = 0
    for m in moduli:
        operands = []
        for a in x:
            operands += [a, -a, a * x[0], -(a * x[1]), (a << 320) + x[3],
                         a * m, a * m - x[2], a * m + x[1] * 3]
        for a in operands:
            outs = [a % m, iszm(a, m)]
            if m in PRIMES:
                outs.append(inv(a, m))
            for o in outs:
                tape.record_write(0, j, (o if m < 1 << 256 else o % BN254_FR).i)
                j += 1
    tape.frozen = True
    return tape


def _input_vectors(moduli, seed):
    """Input vectors of the program: 0, 1, m - 1, m and m + 1 of each
    modulus beside full-width draws, draws of 5 words, and zeros."""
    rng = random.Random(seed)
    vecs = [[0, 0, 0, 0], [1, 1, 1, 1]]
    for m in moduli:
        vecs.append([m - 1, 1, m, 0] if m > 1 else [1, 1, 1, 0])
        vecs.append([m + 1, m - 1, rng.randrange(1 << 256), m])
    for _ in range(4):
        vecs.append([rng.randrange(1 << 256) for _ in range(4)])
        vecs.append([rng.randrange(1 << 319) for _ in range(4)])
    return vecs


def _expected_routes(tape, inputs):
    """(fast, general) modular ops by the port VM's route rule, from the
    Python VM's operand values."""
    slots = tape.execute(inputs)
    fast = general = 0
    for c, a, b in zip(tape.op_code, tape.op_a, tape.op_b):
        if c not in (MOD, ISZM, INVMOD):
            continue
        m, wa = slots[b], (abs(slots[a]).bit_length() + 63) // 64
        wm = (m.bit_length() + 63) // 64
        odd = m & 1 and m != 1 and wm <= 4 and wa <= 2 * wm
        pow2 = m & (m - 1) == 0 and c != INVMOD
        fast += bool(odd or pow2)
        general += not (odd or pow2)
    return fast, general


def _run_both(tape, mira_tape, inputs):
    """Both VMs' out_buf, or both errors' messages; and the port's route
    counters for the run."""
    before = tracing.counts()
    try:
        got = native_lib.tape_vm_run_raw(tape, inputs)[0]
    except RuntimeError as e:
        got = str(e)
    after = tracing.counts()
    try:
        want = mira_native.tape_vm_run_raw(mira_tape, inputs)[0]
    except RuntimeError as e:
        want = str(e)
    routes = tuple(after.get(k, 0) - before.get(k, 0)
                   for k in ("tape_modop_fast", "tape_modop_general"))
    return got, want, routes


@pytest.mark.parametrize("moduli", [(m,) for m in MODULI] + [PRIMES + (1 << 192,)],
                         ids=lambda ms: "+".join(f"{m.bit_length()}b{m & 7}" for m in ms))
def test_modops_match_shared_vm(moduli):
    if not native_lib.tape_vm_available() or not mira_native.tape_vm_available():
        pytest.skip("no native toolchain")
    tape, mira_tape = _modop_program(Tape, moduli), _modop_program(MiraTape, moduli)
    n_modops = sum(c in (MOD, ISZM, INVMOD) for c in tape.op_code)
    for inputs in _input_vectors(moduli, seed=moduli[0] % 1000):
        got, want, routes = _run_both(tape, mira_tape, inputs)
        assert isinstance(got, np.ndarray) and np.array_equal(got, want)
        assert sum(routes) == n_modops
        assert routes == _expected_routes(tape, inputs)
        # and the Python VM's values
        slots = tape.execute(inputs)
        prep = tape._native_prep
        vals = [int.from_bytes(row.tobytes(), "little") for row in got]
        assert vals == [slots[tape.writes[int(w)][2]] for w in prep["dyn_writes"]]


@pytest.mark.parametrize("m, x, route", [
    (3 * BN254_FR, BN254_FR, "fast"),  # 4 words, odd, not a unit
    (15, 6, "fast"),
    (P127 * P64, P64 * 5, "fast"),  # 3 words
    (WIDE_ODD, 3 * 17, "general"),  # 5 words
    (2 * BN254_FR, 4, "general"),  # even divisor, even operand
    (2 * BN254_FR, 7, "general"),  # even divisor, odd operand
    (1 << 192, 5, "general"),
])
def test_invmod_errors_match_shared_vm(m, x, route):
    """INVMOD of a non-unit by a composite odd divisor fails with error 5 on
    both VMs, on the fast route as on the general one; by an even divisor
    both VMs give the same output or the same error."""
    if not native_lib.tape_vm_available() or not mira_native.tape_vm_available():
        pytest.skip("no native toolchain")

    def program(tape_cls, inv):
        tape = tape_cls()
        a = tape.input(1)
        tape.record_write(0, 0, (inv(a, m) % BN254_FR).i)
        tape.frozen = True
        return tape

    tape, mira_tape = program(Tape, invmod_or_one), program(MiraTape, mira_invmod_or_one)
    got, want, routes = _run_both(tape, mira_tape, [x])
    if isinstance(want, str):
        assert got == want
    else:
        assert np.array_equal(got, want)
        # the INVMOD, then the MOD by BN254 Fr (always fast)
        assert routes == ((2, 0) if route == "fast" else (1, 1))
    if m & 1:
        assert want == "tape VM error 5"
