"""Prime-field arithmetic on torch tensors (port of mira_tpu/fields/limbs.py).

Storage layout: a field element is eight little-endian 32-bit words in an
int32 tensor of shape ``(..., 8)`` (the CUDA kernels read them as
``uint32_t[8]``), kept in Montgomery form with R = 2^256 — the same integer
mira_tpu stores as sixteen 16-bit limbs, so the byte image of a port tensor
is the byte image of mira_tpu's limb array packed to 16 bits.

The plain arithmetic (what runs on a CPU tensor, and the elementwise field
work on the card) works on a *lazy* form: 17 signed int64 limbs of 16 bits
whose value is only congruent to the element.  A product is a skew-sum of
limb products into 33 columns (17 fused multiply-adds over whole rows) and
one contraction with the table ``2^(16k) * R^-1 mod p``; carries are
settled by a few vectorised passes and a fold of the top columns by
``2^(16k) mod p``.  Canonical form is reached only where a value leaves the
lazy domain (outputs and zero tests).  A Montgomery product therefore costs
~40 tensor ops instead of the ~250 of a limb-serial CIOS loop.

Bounds (all magnitudes): a settled value has limbs 0..15 in [-8, 2^16+8]
and |limb 16| <= 2^16; ``Lz.w`` counts how many settled values were
summed into a lazy one (at most 32).  A product needs ``w_a * w_b <= 96``:
the limb products then sum to at most 289 * 96 * (2^16+8)^2 per output row
and the contraction columns stay below that times 2^16, < 2^62.8.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

LIMB_BITS = 16
NUM_LIMBS = 16
NUM_WORDS = 8
MASK = (1 << LIMB_BITS) - 1
R_BITS = LIMB_BITS * NUM_LIMBS
_LZ = NUM_LIMBS + 1  # lazy limb count (limb 16 carries the overflow)
_MAX_W = 32  # bound on the weight of a sum
_MAX_WW = 96  # bound on the product of a product's operand weights
_CHUNK = 1 << 16  # elements per chunk of a large product (bounds temporaries)
_TWO_64 = 1 << 64
_ROWS = 1 << 22  # elements per block of a whole-witness elementwise op (LimbField.rowwise)


def ints_to_words(vals) -> np.ndarray:
    """Python ints (< 2^256) / host field elements -> (n, 8) int32 words."""
    return int_list_words([v if type(v) is int else v.v for v in vals])


def int_list_words(vals: list) -> np.ndarray:
    """A list of Python ints in [0, 2^256) -> (n, 8) int32 words: zeros and
    values below 2^64 in a numpy pass, only the others one by one."""
    out = np.zeros((len(vals), 4), dtype="<u8")
    a = np.array(vals, dtype=object)
    nz = np.flatnonzero(a)
    if len(nz):
        v = a[nz]
        small = (v < _TWO_64).astype(bool)
        out[nz[small], 0] = v[small].astype(np.uint64)
        big = nz[~small]
        if len(big):
            buf = b"".join(x.to_bytes(32, "little") for x in a[big].tolist())
            out[big] = np.frombuffer(buf, dtype="<u8").reshape(len(big), 4)
    return out.view("<i4").reshape(len(vals), NUM_WORDS)


def words_to_ints(arr) -> list:
    """(..., 8) int32 words (tensor or array) -> list of Python ints."""
    if isinstance(arr, torch.Tensor):
        arr = arr.detach().cpu().numpy()
    flat = np.ascontiguousarray(arr, dtype="<i4").reshape(-1, NUM_WORDS)
    buf = flat.tobytes()
    return [
        int.from_bytes(buf[32 * i : 32 * (i + 1)], "little")
        for i in range(flat.shape[0])
    ]


def ints_to_limbs(vals) -> np.ndarray:
    """Python ints -> (n, 16) uint32 16-bit limbs, mira_tpu's host layout
    (copied from mira_tpu/fields/limbs.py)."""
    buf = b"".join(
        [(v if isinstance(v, int) else v.v).to_bytes(32, "little") for v in vals]
    )
    u16 = np.frombuffer(buf, dtype="<u2").reshape(len(vals), NUM_LIMBS)
    return u16.astype(np.uint32)


def limbs_to_ints(arr) -> list:
    """(n, 16) limb array -> Python ints (copied from mira_tpu/fields/limbs.py)."""
    flat = np.asarray(arr).reshape(-1, NUM_LIMBS).astype("<u2")
    buf = flat.tobytes()
    return [
        int.from_bytes(buf[32 * i : 32 * (i + 1)], "little") for i in range(len(flat))
    ]


def limbs_of(v: int, n: int = NUM_LIMBS) -> list:
    return [(v >> (LIMB_BITS * i)) & MASK for i in range(n)]


def words_to_limbs(t: torch.Tensor) -> torch.Tensor:
    """(..., 8) int32 words -> (..., 16) int64 16-bit limbs."""
    w = t.to(torch.int64) & 0xFFFFFFFF
    return torch.stack((w & MASK, w >> LIMB_BITS), dim=-1).reshape(
        *t.shape[:-1], NUM_LIMBS
    )


def limbs_to_words(x: torch.Tensor) -> torch.Tensor:
    """(..., 16) int64 canonical 16-bit limbs -> (..., 8) int32 words."""
    x = x.reshape(*x.shape[:-1], NUM_WORDS, 2)
    w = x[..., 0] | (x[..., 1] << LIMB_BITS)
    return (w - ((w >> 31) << 32)).to(torch.int32)


def _carry(x: torch.Tensor) -> torch.Tensor:
    """One vectorised carry pass; the top column is left unmasked so the
    value (signed) is preserved exactly."""
    c = x[..., :-1] >> LIMB_BITS
    out = x & _top_keep_mask(x.shape[-1], x.device)
    out[..., 1:] += c
    return out


@lru_cache(maxsize=None)
def _top_keep_mask(n: int, device) -> torch.Tensor:
    m = torch.full((n,), MASK, dtype=torch.int64, device=device)
    m[-1] = -1
    return m


def _contract(T: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """(n, 33) columns times the (33, 16) table, exactly in int64: one fused
    multiply-add per column (CUDA has no int64 matmul)."""
    out = torch.zeros(T.shape[0], table.shape[1], dtype=torch.int64,
                      device=T.device)
    for k in range(table.shape[0]):
        out.addcmul_(T[:, k : k + 1], table[k])
    return out


def _normalize(x: torch.Tensor, passes: int) -> torch.Tensor:
    """Exact carry normalisation: limbs 0..n-2 in [0, 2^16), the top limb
    signed.  `passes` vectorised passes settle the common case; a rare
    leftover carry chain is finished limb by limb."""
    for _ in range(passes):
        x = _carry(x)
    low = x[..., :-1]
    if bool(((low < 0) | (low > MASK)).any()):
        x = x.clone()
        for i in range(x.shape[-1] - 1):
            c = x[..., i] >> LIMB_BITS
            x[..., i] &= MASK
            x[..., i + 1] += c
    return x


class Lz:
    """A lazy field value: (..., 17) int64 limbs `t`, weight `w` (number of
    settled values summed into it).  Arithmetic operators stay lazy."""

    __slots__ = ("f", "t", "w")

    def __init__(self, f: "LimbField", t: torch.Tensor, w: int = 1):
        self.f = f
        self.t = t
        self.w = w

    def __add__(self, o: "Lz") -> "Lz":
        a, b = self.f._fit_sum(self, o)
        return Lz(self.f, a.t + b.t, a.w + b.w)

    def __sub__(self, o: "Lz") -> "Lz":
        a, b = self.f._fit_sum(self, o)
        return Lz(self.f, a.t - b.t, a.w + b.w)

    def __neg__(self) -> "Lz":
        return Lz(self.f, -self.t, self.w)

    def __mul__(self, o: "Lz") -> "Lz":
        return self.f.lmul(self, o)

    def double(self) -> "Lz":
        return self + self

    def square(self) -> "Lz":
        return self.f.lmul(self, self)

    def __getitem__(self, idx) -> "Lz":
        return Lz(self.f, self.t[idx], self.w)

    @property
    def shape(self):
        return self.t.shape[:-1]


class LimbField:
    """Montgomery arithmetic for one prime modulus on (..., 8) int32 word
    tensors; every public op takes and returns canonical values."""

    def __init__(self, modulus: int):
        assert modulus.bit_length() <= 254, "needs 4p < 2^256"
        self.modulus = modulus
        r = 1 << R_BITS
        self.r_mod_p = r % modulus
        self.r2 = (r * r) % modulus
        rinv = pow(r, -1, modulus)
        # contraction table of the Montgomery product: column k of a limb
        # product has weight 2^(16k); times R^-1, reduced mod p
        self._np_cmont = np.array(
            [limbs_of((pow(2, LIMB_BITS * k, modulus) * rinv) % modulus)
             for k in range(2 * _LZ - 1)],
            dtype=np.int64,
        )
        # fold table for overflow columns 16..19: 2^(16k) mod p
        self._np_cfold = np.array(
            [limbs_of(pow(2, LIMB_BITS * k, modulus)) for k in range(16, 20)],
            dtype=np.int64,
        )
        self._np_p = np.array(limbs_of(modulus, _LZ), dtype=np.int64)
        # p / 2^240 for the quotient estimate of canonicalisation
        self._p_hi = modulus / float(1 << 240)
        self._consts = {}

    # -- per-device constants ----------------------------------------------
    def _c(self, device):
        key = torch.device(device)
        c = self._consts.get(key)
        if c is None:
            c = {
                "cmont": torch.from_numpy(self._np_cmont).to(key),
                "cfold": torch.from_numpy(self._np_cfold).to(key),
                "p": torch.from_numpy(self._np_p).to(key),
            }
            self._consts[key] = c
        return c

    # -- lazy core -----------------------------------------------------------
    def lz(self, t: torch.Tensor) -> Lz:
        """Canonical (..., 8) words -> lazy."""
        x = words_to_limbs(t)
        return Lz(self, torch.cat((x, torch.zeros_like(x[..., :1])), dim=-1), 1)

    def lz_raw(self, v: int, shape, device) -> Lz:
        """Integer v (< 2^256, taken as is) -> broadcast lazy value."""
        t = torch.tensor(limbs_of(v, _LZ), dtype=torch.int64, device=device)
        return Lz(self, t.expand(*shape, _LZ), 1)

    def lz_const(self, v: int, shape, device) -> Lz:
        """Plain int -> broadcast lazy Montgomery constant."""
        mv = (v % self.modulus) * self.r_mod_p % self.modulus
        return self.lz_raw(mv, shape, device)

    def _fit_sum(self, a: Lz, b: Lz):
        if a.w + b.w > _MAX_W:
            if a.w >= b.w:
                a = self.settle(a)
            if a.w + b.w > _MAX_W:
                b = self.settle(b)
        return a, b

    def settle(self, a: Lz) -> Lz:
        """Bring a lazy value (a sum of <= 32 settled values) back to settled
        form (weight 1)."""
        if a.w == 1 and a.t.shape[-1] == _LZ:
            return a
        return Lz(self, self._settle(a.t, 1 if a.w <= 4 else 2 if a.w <= 16 else 3), 1)

    def _settle(self, x: torch.Tensor, rounds: int) -> torch.Tensor:
        """Carry passes, then `rounds` folds of the columns past 2^256 by
        2^(16k) mod p.  Each fold shrinks limb 16 by p / 2^256 ~ 2^-2.4; a
        product contraction (columns <= 2^61.2) needs one."""
        cf = self._c(x.device)["cfold"]
        x = torch.nn.functional.pad(x, (0, 20 - x.shape[-1]))
        for _ in range(3):
            x = _carry(x)
        low = x[..., :16] + (x[..., 16:20, None] * cf).sum(-2)
        for i in range(rounds):
            x = _carry(_carry(torch.nn.functional.pad(low, (0, 1))))
            if i + 1 < rounds:
                low = x[..., :16] + x[..., 16:17] * cf[0]
        return x

    def lmul(self, a: Lz, b: Lz) -> Lz:
        """Lazy Montgomery product a * b * R^-1."""
        if a.w * b.w > _MAX_WW:
            if a.w >= b.w:
                a = self.settle(a)
            if a.w * b.w > _MAX_WW:
                b = self.settle(b)
        A, B = torch.broadcast_tensors(a.t, b.t)
        shape = A.shape[:-1]
        A = A.reshape(-1, _LZ)
        B = B.reshape(-1, _LZ)
        n = A.shape[0]
        if n <= _CHUNK:
            out = self._mul_rows(A, B)
        else:
            out = torch.cat(
                [self._mul_rows(A[i : i + _CHUNK], B[i : i + _CHUNK])
                 for i in range(0, n, _CHUNK)]
            )
        return Lz(self, out.reshape(*shape, _LZ), 1)

    def _mul_rows(self, A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
        # skew-sum of the limb products: column i + j gets A_i * B_j
        T = torch.zeros(A.shape[0], 2 * _LZ - 1, dtype=torch.int64,
                        device=A.device)
        for i in range(_LZ):
            T[:, i : i + _LZ].addcmul_(B, A[:, i : i + 1])
        return self._settle(_contract(T, self._c(A.device)["cmont"]), 1)

    def canon_limbs(self, a: Lz) -> torch.Tensor:
        """Lazy -> canonical (..., 16) int64 limbs in [0, p)."""
        c = self._c(a.t.device)
        x = _normalize(self.settle(a).t, 2)  # limbs 0..15 exact, 16 signed
        # quotient estimate from the top 32 bits; biased low so that
        # V - q*p lands in [0, 2p)
        vhi = (x[..., 16] * (1 << 16) + x[..., 15]).to(torch.float64)
        q = torch.floor(vhi / self._p_hi - 2.0 ** -10).to(torch.int64)
        w = _normalize(x - q[..., None] * c["p"], 3)
        d = _normalize(w - c["p"], 2)
        keep = (d[..., 16] < 0)[..., None]
        return torch.where(keep, w, d)[..., :NUM_LIMBS]

    def canon(self, a: Lz) -> torch.Tensor:
        return limbs_to_words(self.canon_limbs(a))

    def is_zero_lz(self, a: Lz) -> torch.Tensor:
        return (self.canon_limbs(a) == 0).all(-1)

    def where(self, mask: torch.Tensor, a: Lz, b: Lz) -> Lz:
        t = torch.where(mask[..., None], a.t, b.t)
        return Lz(self, t, max(a.w, b.w))

    # -- host <-> tensor -----------------------------------------------------
    def encode(self, vals, device="cpu") -> torch.Tensor:
        """Python ints / host field elements -> Montgomery words."""
        m = self.modulus
        ints = [(v if type(v) is int else v.v) % m for v in vals]
        return self.from_plain(torch.from_numpy(int_list_words(ints)).to(device))

    def encode_raw16(self, raw16, device="cpu") -> torch.Tensor:
        """(n, 16) uint32 plain 16-bit limb planes (values < p), as mira_tpu
        keeps them, -> Montgomery words."""
        raw16 = np.ascontiguousarray(raw16, dtype=np.uint32)
        w = raw16.astype("<u2").view("<i4").reshape(raw16.shape[0], NUM_WORDS)
        return self.from_plain(torch.from_numpy(w).to(device))

    def decode(self, t: torch.Tensor) -> list:
        """Montgomery words -> canonical Python ints."""
        if t.numel() == 0:
            return []
        return words_to_ints(self.to_plain(t.reshape(-1, NUM_WORDS)))

    # -- constants -----------------------------------------------------------
    def zero(self, shape=(), device="cpu") -> torch.Tensor:
        return torch.zeros(*shape, NUM_WORDS, dtype=torch.int32, device=device)

    def const(self, v: int, shape=(), device="cpu") -> torch.Tensor:
        """Plain int -> broadcast Montgomery-form constant."""
        mv = (v % self.modulus) * self.r_mod_p % self.modulus
        w = torch.from_numpy(ints_to_words([mv])[0]).to(device)
        return w.expand(*shape, NUM_WORDS)

    def one(self, shape=(), device="cpu") -> torch.Tensor:
        return self.const(1, shape, device)

    # -- ring ops on canonical words -----------------------------------------
    def add(self, a, b):
        return self.canon(self.lz(a) + self.lz(b))

    def sub(self, a, b):
        return self.canon(self.lz(a) - self.lz(b))

    def neg(self, a):
        return self.canon(-self.lz(a))

    def double(self, a):
        return self.add(a, a)

    def mul(self, a, b):
        return self.canon(self.lz(a) * self.lz(b))

    def square(self, a):
        return self.mul(a, a)

    def pow_int(self, a, e: int):
        acc = self.lz(self.one(a.shape[:-1], a.device))
        base = self.lz(a)
        for i in range(e.bit_length()):
            if (e >> i) & 1:
                acc = acc * base
            base = base.square()
        return self.canon(acc)

    def inv(self, a):
        """Fermat inversion (maps 0 -> 0)."""
        return self.pow_int(a, self.modulus - 2)

    def rowwise(self, fn, *ts):
        """fn over blocks of at most _ROWS elements of (..., 8) word tensors
        of one shape (an elementwise fn): a product's lazy limbs take 17
        int64 an element, several at once, which over a whole 2^22-row
        witness would not fit the card."""
        shape = ts[0].shape
        flat = [t.reshape(-1, NUM_WORDS) for t in ts]
        n = flat[0].shape[0]
        if n <= _ROWS:
            return fn(*ts)
        out = torch.empty_like(flat[0])
        for lo in range(0, n, _ROWS):
            out[lo : lo + _ROWS] = fn(*(t[lo : lo + _ROWS] for t in flat))
        return out.reshape(shape)

    def to_plain(self, a):
        """Montgomery -> plain words (a * 1 * R^-1)."""
        return self.rowwise(lambda x: self.canon(
            self.lz(x) * self.lz_raw(1, x.shape[:-1], x.device)), a)

    def from_plain(self, a):
        """Plain words -> Montgomery (a * R^2 * R^-1)."""
        return self.rowwise(lambda x: self.canon(
            self.lz(x) * self.lz_raw(self.r2, x.shape[:-1], x.device)), a)

    def is_zero(self, a):
        return (a == 0).all(-1)

    def select(self, mask, a, b):
        """mask ? a : b  (mask shape (...,), operands (..., 8))."""
        return torch.where(mask[..., None], a, b)


@lru_cache(maxsize=None)
def limb_field(modulus: int) -> LimbField:
    return LimbField(modulus)
