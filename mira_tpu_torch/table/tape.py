"""Witness-generation tape: capture one synthesis as a straight-line program,
replay it per step without re-running Python synthesis.

The reference re-synthesizes the StepFoldingCircuit imperatively every fold
step (src/table/witness_data.rs + src/ivc/step_folding_circuit.rs:294-548);
all per-cell work is repeated although the circuit STRUCTURE never changes —
only the input values do.  Here the first synthesis runs with `TV` (traced
value) objects threaded through the gadget arithmetic; every arithmetic op
and every advice-cell write is recorded.  Subsequent steps bind fresh inputs
and execute the recorded program (Python VM here; native C++ VM in
mira_tpu_torch/native/tape_vm.cpp via utils/native_lib), then scatter the
computed values into a copy of the captured advice table.

Correctness contract: gadget synthesis control flow must depend only on
circuit structure (shapes, limb counts, bit widths), never on witness
values.  Value-dependent branches in gadgets are expressed as tape ops
(ISZM/INVMOD/arithmetic selects) — see gadgets/main_gate.py
invert_with_flag / le_num_to_bits.  `bool(TV)` raises to surface any
remaining data-dependent branch at capture time.

Copied from mira_tpu/table/tape.py; the port imports nothing of mira_tpu.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

# op codes (VM ops are (op, a, b) -> one new slot, in slot order)
ADD, SUB, MUL, MOD, DIV, INVMOD, ISZM, SHL, SHR, AND = range(10)

_OP_NAMES = ["ADD", "SUB", "MUL", "MOD", "DIV", "INVMOD", "ISZM", "SHL", "SHR", "AND"]


class Tape:
    """Recorder + program container.

    Slot space: [inputs][consts and op outputs interleaved in creation
    order].  `ops[i]` writes slot `op_out[i]`.
    """

    __slots__ = (
        "slots",  # concrete values during capture (list of int)
        "num_inputs",
        "op_code",
        "op_a",
        "op_b",
        "op_out",
        "_const_cache",
        "writes",  # list of (col, row, slot) advice-cell writes
        "frozen",
        "_native_prep",  # native-VM renaming cache (utils/native_lib.py)
    )

    def __init__(self):
        self.slots: List[int] = []
        self.num_inputs = 0
        self.op_code: List[int] = []
        self.op_a: List[int] = []
        self.op_b: List[int] = []
        self.op_out: List[int] = []
        self._const_cache: Dict[int, int] = {}
        self.writes: List[Tuple[int, int, int]] = []
        self.frozen = False

    # -- construction ---------------------------------------------------------
    def input(self, value: int) -> "TV":
        assert not self.frozen and not self.op_code, "inputs must precede ops"
        idx = len(self.slots)
        self.slots.append(int(value))
        self.num_inputs += 1
        return TV(self, idx, int(value))

    def const(self, value: int) -> int:
        """Slot index of a (deduplicated) constant."""
        value = int(value)
        idx = self._const_cache.get(value)
        if idx is None:
            idx = len(self.slots)
            self.slots.append(value)
            self._const_cache[value] = idx
        return idx

    def emit(self, code: int, a: int, b: int, value: int) -> int:
        # the native VM's registers are 640-bit (native/tape_vm.cpp W=10);
        # catch width escapes at capture time, not at replay
        assert value.bit_length() <= 640, "tape value exceeds VM register width"
        idx = len(self.slots)
        self.slots.append(value)
        self.op_code.append(code)
        self.op_a.append(a)
        self.op_b.append(b)
        self.op_out.append(idx)
        return idx

    def record_write(self, col: int, row: int, slot: int):
        self.writes.append((col, row, slot))

    # -- replay ---------------------------------------------------------------
    def execute(self, inputs: List[int]) -> List[int]:
        """Python VM: recompute all slots for fresh inputs."""
        assert len(inputs) == self.num_inputs, (
            f"input arity mismatch: {len(inputs)} != {self.num_inputs}"
        )
        slots = list(self.slots)
        slots[: self.num_inputs] = [int(v) for v in inputs]
        code, A, B, OUT = self.op_code, self.op_a, self.op_b, self.op_out
        for i in range(len(code)):
            c = code[i]
            a = slots[A[i]]
            b = slots[B[i]]
            if c == ADD:
                v = a + b
            elif c == SUB:
                v = a - b
            elif c == MUL:
                v = a * b
            elif c == MOD:
                v = a % b
            elif c == DIV:
                v = a // b
            elif c == INVMOD:
                x = a % b
                v = 1 if x == 0 else pow(x, -1, b)
            elif c == ISZM:
                v = 1 if a % b == 0 else 0
            elif c == SHL:
                v = a << b
            elif c == SHR:
                v = a >> b
            elif c == AND:
                v = a & b
            else:  # pragma: no cover
                raise ValueError(f"bad op {c}")
            slots[OUT[i]] = v
        return slots

    def stats(self) -> str:
        return (
            f"tape: {self.num_inputs} inputs, "
            f"{len(self.slots) - self.num_inputs - len(self.op_code)} consts, "
            f"{len(self.op_code)} ops, {len(self.writes)} cell writes"
        )


class TapeUnsafe(Exception):
    """Raised when synthesis control flow depends on a traced value."""


class TV:
    """A traced value: concrete int (`v`) + tape slot.  Supports the
    arithmetic the gadget layer performs on `.value`s.  Comparisons return
    concrete bools (capture-time asserts/guards); bool() raises because a
    data-dependent branch would make the captured program wrong."""

    __slots__ = ("t", "i", "v", "rm")

    def __init__(self, tape: Tape, idx: int, value: int, reduced_mod: int = 0):
        self.t = tape
        self.i = idx
        self.v = value
        self.rm = reduced_mod  # modulus this value is known-reduced by (0 = no)

    # -- helpers --------------------------------------------------------------
    def _coerce(self, other) -> Tuple[int, int]:
        """other -> (slot, concrete)."""
        if isinstance(other, TV):
            assert other.t is self.t, "mixing tapes"
            return other.i, other.v
        return self.t.const(other), int(other)

    def _bin(self, code: int, other, value: int, rm: int = 0) -> "TV":
        b, _ = self._coerce(other)
        idx = self.t.emit(code, self.i, b, value)
        return TV(self.t, idx, value, rm)

    def _rbin(self, code: int, other, value: int, rm: int = 0) -> "TV":
        a, _ = self._coerce(other)
        idx = self.t.emit(code, a, self.i, value)
        return TV(self.t, idx, value, rm)

    # -- arithmetic ------------------------------------------------------------
    def __add__(self, o):
        ov = o.v if isinstance(o, TV) else int(o)
        return self._bin(ADD, o, self.v + ov)

    def __radd__(self, o):
        return self._rbin(ADD, o, int(o) + self.v)

    def __sub__(self, o):
        ov = o.v if isinstance(o, TV) else int(o)
        return self._bin(SUB, o, self.v - ov)

    def __rsub__(self, o):
        return self._rbin(SUB, o, int(o) - self.v)

    def __mul__(self, o):
        ov = o.v if isinstance(o, TV) else int(o)
        return self._bin(MUL, o, self.v * ov)

    def __rmul__(self, o):
        return self._rbin(MUL, o, int(o) * self.v)

    def __mod__(self, o):
        ov = o.v if isinstance(o, TV) else int(o)
        if not isinstance(o, TV) and self.rm == ov:
            return self  # already reduced by this modulus
        return self._bin(MOD, o, self.v % ov, rm=0 if isinstance(o, TV) else ov)

    def __rmod__(self, o):
        return self._rbin(MOD, o, int(o) % self.v)

    def __floordiv__(self, o):
        ov = o.v if isinstance(o, TV) else int(o)
        return self._bin(DIV, o, self.v // ov)

    def __rfloordiv__(self, o):
        return self._rbin(DIV, o, int(o) // self.v)

    def __lshift__(self, o):
        ov = o.v if isinstance(o, TV) else int(o)
        return self._bin(SHL, o, self.v << ov)

    def __rshift__(self, o):
        ov = o.v if isinstance(o, TV) else int(o)
        return self._bin(SHR, o, self.v >> ov)

    def __and__(self, o):
        ov = o.v if isinstance(o, TV) else int(o)
        return self._bin(AND, o, self.v & ov)

    def __rand__(self, o):
        return self._rbin(AND, o, int(o) & self.v)

    def __neg__(self):
        return self._rbin(SUB, 0, -self.v)

    def __pow__(self, e, m=None):
        """pow(x, 5, p) (sbox) and pow(x, -1, p) (field inverse) are the two
        shapes the gadget layer uses."""
        if m is None:
            raise TapeUnsafe("2-arg pow on traced value")
        if isinstance(e, TV) or isinstance(m, TV):
            raise TapeUnsafe("traced exponent/modulus")
        if e == -1:
            # gadget semantics (invert_with_flag): inverse, or 1 when a==0
            v = self.v % m
            val = 1 if v == 0 else pow(v, -1, m)
            return self._bin(INVMOD, m, val)
        assert e >= 0
        # square-and-multiply expansion, reduced at every step so
        # intermediates stay under the VM's 640-bit register width
        result = None
        base = self % m
        ee = e
        while ee:
            if ee & 1:
                result = base if result is None else (result * base) % m
            ee >>= 1
            if ee:
                base = (base * base) % m
        if result is None:
            raise TapeUnsafe("pow(x, 0, m) on traced value")
        return result % m

    # -- comparisons: concrete (capture-time guards only) ----------------------
    def __eq__(self, o):
        return self.v == (o.v if isinstance(o, TV) else o)

    def __ne__(self, o):
        return not self.__eq__(o)

    def __lt__(self, o):
        return self.v < (o.v if isinstance(o, TV) else o)

    def __le__(self, o):
        return self.v <= (o.v if isinstance(o, TV) else o)

    def __gt__(self, o):
        return self.v > (o.v if isinstance(o, TV) else o)

    def __ge__(self, o):
        return self.v >= (o.v if isinstance(o, TV) else o)

    def __hash__(self):
        raise TapeUnsafe("hashing a traced value (dict/set keyed on witness)")

    def __bool__(self):
        raise TapeUnsafe("data-dependent branch on a traced value")

    def __int__(self):
        raise TapeUnsafe("int() on a traced value loses tracking")

    def __index__(self):
        raise TapeUnsafe("indexing by a traced value")

    def __repr__(self):
        return f"TV(slot={self.i}, v={self.v})"


def iszero_mod(value, modulus: int):
    """1 if value % modulus == 0 else 0 — tape-safe twin of the
    `if a.value % p == 0` branch in invert_with_flag."""
    if isinstance(value, TV):
        v = 1 if value.v % modulus == 0 else 0
        b = value.t.const(modulus)
        idx = value.t.emit(ISZM, value.i, b, v)
        return TV(value.t, idx, v)
    return 1 if value % modulus == 0 else 0


def invmod_or_one(value, modulus: int):
    """x^-1 mod m, or 1 when x == 0 (invert_with_flag semantics)."""
    if isinstance(value, TV):
        return pow(value, -1, modulus)
    x = value % modulus
    return 1 if x == 0 else pow(x, -1, modulus)


def getbit(value, i: int):
    """(value >> i) & 1 for int or TV."""
    return (value >> i) & 1


def as_int(value):
    """Concrete int view (for capture-time asserts)."""
    return value.v if isinstance(value, TV) else int(value)
