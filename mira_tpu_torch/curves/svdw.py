"""Shallue–van de Woestijne (SVDW) hash-to-curve, RFC 9380 §6.6.1.

The reference derives commitment-key generators via halo2curves'
`C::CurveExt::hash_to_curve("from_uniform_bytes")` applied to 32-byte Shake256
XOF seeds (src/commitment.rs:52-76).  halo2curves implements
the RFC 9380 random-oracle suite: expand_message_xmd(SHA-256) ->
2 field elements (64 uniform bytes each, decoded LITTLE-endian, halo2curves'
`from_uniform_bytes`) -> SVDW map each -> point addition (cofactor 1 for
bn254/grumpkin).

Everything below is the deterministic RFC 9380 construction with constants
*computed* from the curve (find_z_svdw, §F.1), not copied: given the curve
equation the whole map is forced.  The DST string follows halo2curves'
`<domain_prefix>-<curve_id>_XMD:SHA-256_SVDW_RO_` convention; the curve-id
constants live on CurveParams consumers below and were reconstructed without
access to halo2curves source (recorded parity caveat).

Copied from mira_tpu/curves/svdw.py; the port imports nothing of mira_tpu.
"""

from __future__ import annotations

import hashlib
from functools import lru_cache

from ..fields.host import field
from .host import AffinePoint, CurveParams

CURVE_IDS = {
    "bn254": "bn256_g1",
    "grumpkin": "grumpkin_g1",
}


def expand_message_xmd(msg: bytes, dst: bytes, len_in_bytes: int) -> bytes:
    """RFC 9380 §5.3.1 with SHA-256."""
    b_in_bytes = 32
    s_in_bytes = 64
    ell = -(-len_in_bytes // b_in_bytes)
    assert ell <= 255 and len_in_bytes <= 65535 and len(dst) <= 255
    dst_prime = dst + len(dst).to_bytes(1, "big")
    z_pad = b"\x00" * s_in_bytes
    l_i_b_str = len_in_bytes.to_bytes(2, "big")
    msg_prime = z_pad + msg + l_i_b_str + b"\x00" + dst_prime
    b0 = hashlib.sha256(msg_prime).digest()
    b1 = hashlib.sha256(b0 + b"\x01" + dst_prime).digest()
    bs = [b1]
    for i in range(2, ell + 1):
        prev = bs[-1]
        xored = bytes(a ^ b for a, b in zip(b0, prev))
        bs.append(hashlib.sha256(xored + i.to_bytes(1, "big") + dst_prime).digest())
    return b"".join(bs)[:len_in_bytes]


def hash_to_field(msg: bytes, dst: bytes, modulus: int, count: int = 2,
                  length: int = 64) -> list:
    """count field elements from 64 uniform bytes each, LE decode
    (halo2curves `FromUniformBytes<64>` semantics, not the RFC's OS2IP-BE)."""
    uniform = expand_message_xmd(msg, dst, count * length)
    return [
        int.from_bytes(uniform[i * length:(i + 1) * length], "little") % modulus
        for i in range(count)
    ]


@lru_cache(maxsize=None)
def find_z_svdw(base_modulus: int, a: int, b: int) -> int:
    """RFC 9380 §F.1: smallest-|Z| nonzero Z meeting the SVDW criteria."""
    p = base_modulus
    F = field(p)

    def g(x):
        return (x * x * x + a * x + b) % p

    def is_square(v):
        return v % p == 0 or pow(v % p, (p - 1) // 2, p) == 1

    def crit(z):
        gz = g(z)
        if gz == 0:
            return False
        h = (-(3 * z * z + 4 * a) * pow(4 * gz, -1, p)) % p
        if h == 0 or not is_square(h):
            return False
        if not (is_square(gz) or is_square(g((-z * pow(2, -1, p)) % p))):
            return False
        return True

    ctr = 1
    while True:
        for z_cand in (ctr, -ctr):
            if crit(z_cand % p):
                return z_cand % p
        ctr += 1


@lru_cache(maxsize=None)
def svdw_constants(base_modulus: int, a: int, b: int):
    """RFC 9380 §6.6.1 precomputed constants c1..c4 and Z."""
    p = base_modulus
    F = field(p)
    Z = find_z_svdw(p, a, b)
    gZ = (Z * Z * Z + a * Z + b) % p
    c1 = gZ
    c2 = (-Z * pow(2, -1, p)) % p
    # c3 = sqrt(-gZ * (3Z^2 + 4A)), sgn0(c3) == 0
    t = (-gZ * (3 * Z * Z + 4 * a)) % p
    c3 = F(t).sqrt()
    assert c3 is not None, "SVDW c3 must be square"
    c3v = c3.v
    if c3v % 2 == 1:
        c3v = p - c3v
    c4 = (-4 * gZ * pow(3 * Z * Z + 4 * a, -1, p)) % p
    return Z, c1, c2, c3v, c4


def map_to_curve_svdw(curve: CurveParams, u: int) -> AffinePoint:
    """RFC 9380 §6.6.1 straight-line SVDW map (a=0 curves included)."""
    p = curve.base_modulus
    a, b = 0, curve.b
    Z, c1, c2, c3, c4 = svdw_constants(p, a, b)
    F = field(p)

    def is_square(v):
        return v % p == 0 or pow(v % p, (p - 1) // 2, p) == 1

    def inv0(v):
        return 0 if v % p == 0 else pow(v, -1, p)

    tv1 = (u * u) % p
    tv1 = (tv1 * c1) % p
    tv2 = (1 + tv1) % p
    tv1 = (1 - tv1) % p
    tv3 = (tv1 * tv2) % p
    tv3 = inv0(tv3)
    tv4 = (u * tv1) % p
    tv4 = (tv4 * tv3) % p
    tv4 = (tv4 * c3) % p
    x1 = (c2 - tv4) % p
    gx1 = (x1 * x1) % p
    gx1 = (gx1 + a) % p
    gx1 = (gx1 * x1) % p
    gx1 = (gx1 + b) % p
    e1 = is_square(gx1)
    x2 = (c2 + tv4) % p
    gx2 = (x2 * x2) % p
    gx2 = (gx2 + a) % p
    gx2 = (gx2 * x2) % p
    gx2 = (gx2 + b) % p
    e2 = is_square(gx2) and not e1
    x3 = (tv2 * tv2) % p
    x3 = (x3 * tv3) % p
    x3 = (x3 * x3) % p
    x3 = (x3 * c4) % p
    x3 = (x3 + Z) % p
    x = x1 if e1 else (x2 if e2 else x3)
    gx = (x * x) % p
    gx = (gx + a) % p
    gx = (gx * x) % p
    gx = (gx + b) % p
    y = F(gx).sqrt()
    assert y is not None
    yv = y.v
    if (u % 2) != (yv % 2):  # sgn0 match
        yv = p - yv
    return AffinePoint(curve, F(x), F(yv))


def hash_to_curve(curve: CurveParams, domain_prefix: str):
    """Returns msg -> point, the RFC 9380 random-oracle construction the
    reference invokes as `hash_to_curve("from_uniform_bytes")`
    (src/commitment.rs:67)."""
    curve_id = CURVE_IDS[curve.name]
    dst = f"{domain_prefix}-{curve_id}_XMD:SHA-256_SVDW_RO_".encode()

    def go(msg: bytes) -> AffinePoint:
        u0, u1 = hash_to_field(msg, dst, curve.base_modulus)
        q0 = map_to_curve_svdw(curve, u0)
        q1 = map_to_curve_svdw(curve, u1)
        return q0.add(q1)  # clear_cofactor is identity (h = 1)

    return go
