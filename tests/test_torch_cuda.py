"""Kernels against their plain versions on the card.  Every test here needs
a CUDA device and skips without one; the file imports nothing of jax, so it
runs where only the port is installed:

    python -m pytest tests/test_torch_cuda.py -q
"""

import ctypes
import random

import numpy as np
import pytest
import torch

from mira_tpu_torch.convert import msm_reference
from mira_tpu_torch.curves.host import BN254_G1, GRUMPKIN, AffinePoint
from mira_tpu_torch.fields.params import BN254_FQ, BN254_FR
from mira_tpu_torch.curves.torch_curve import jacobian_ops
from mira_tpu_torch.fields.limbs import limb_field, words_to_ints
from mira_tpu_torch.ops import cuda_msm
from mira_tpu_torch.ops.msm import (
    encode_scalars,
    msm,
    msm_fixed_plain,
    msm_lane_plain,
    msm_pippenger_plain,
    msm_plain,
    pippenger_msm_model,
    pippenger_windows,
    plain_engine,
    precompute_fixed_table_plain,
)
from mira_tpu_torch.table.runner import CircuitRunner
from mira_tpu_torch.utils import tracing

from torch_port_helpers import cuda_device  # noqa: F401

pytestmark = pytest.mark.cuda
CURVES = [BN254_G1, GRUMPKIN]
IDS = ["bn254", "grumpkin"]


def _vals(p, seed, n=257):
    rng = np.random.default_rng(seed)
    vals = [int.from_bytes(rng.bytes(32), "little") % p for _ in range(n)]
    vals[:5] = [0, 1, p - 1, p - 2, (1 << 256) % p]
    return vals


def test_field_kernel_matches_plain(cuda_device):  # noqa: F811
    from mira_tpu_torch import _build

    lib = _build.lib()
    for fid, p in ((0, BN254_FQ), (1, BN254_FR)):
        lf = limb_field(p)
        a = lf.encode(_vals(p, 7), cuda_device)
        b = lf.encode(_vals(p, 8), cuda_device)
        for op, want in ((0, lf.mul(a, b)), (1, lf.add(a, b)),
                         (2, lf.sub(a, b)), (3, lf.inv(a[:32]))):
            out = torch.empty_like(want)
            _build.check(lib.mira_field_test(
                fid, op, want.shape[0], a.data_ptr(), b.data_ptr(),
                out.data_ptr(), _build.stream_ptr(cuda_device)), "field_test")
            torch.cuda.synchronize()
            assert torch.equal(out, want)


def _adversarial(curve, n, seed):
    rng = random.Random(seed)
    base = [AffinePoint.random(curve, rng) for _ in range(8)]
    pts = [base[i % 7] for i in range(n - 1)] + [AffinePoint.identity(curve)]
    sc = [rng.randrange(curve.scalar_modulus) for _ in range(n)]
    sc[3] = sc[10]
    sc[5] = 0
    return sc, pts


def _launched(*names):
    """The kernels' call counts so far (the tracing layer's totals)."""
    totals = tracing.counts()
    return {k: totals.get(k, 0) for k in names}


def _run(fn, curve, sc, pts, dev):
    ops = jacobian_ops(curve.name)
    s = encode_scalars(sc, curve.scalar_modulus, dev)
    P = ops.encode_points(pts, dev)
    return ops.decode_points(tuple(c[None] for c in fn(s, P, curve)))[0], s, P


@pytest.mark.parametrize("curve", CURVES, ids=IDS)
@pytest.mark.parametrize("n", [1, 2, 255, 2117, 4096])
def test_bucket_kernel_matches_plain_and_host(curve, n, cuda_device):  # noqa: F811
    sc, pts = _adversarial(curve, max(n, 11), seed=n)
    sc, pts = sc[:n], pts[-n:]
    got, s, P = _run(msm, curve, sc, pts, cuda_device)
    assert got == _run(msm_plain, curve, sc, pts, cuda_device)[0]
    assert got == msm_reference(s, P, curve)


def test_bucket_kernel_identity_cases(cuda_device):  # noqa: F811
    P = AffinePoint.random(BN254_G1, random.Random(3))
    ident = AffinePoint.identity(BN254_G1)
    for sc, pts, want in (([0, 0], [P, P], ident), ([3], [ident], ident),
                          ([1, 1], [P, P], P.double()),
                          ([1, 1], [P, P.neg()], ident)):
        assert _run(msm, BN254_G1, sc, pts, cuda_device)[0] == want


class _Fibo:
    """q * (a + a.next - b) = 0: a rotated query, as tests/test_nifs.py."""

    @staticmethod
    def configure(cs):
        q = cs.fixed_column()
        a, b = cs.advice_column(), cs.advice_column()
        cs.create_gate("fibo", [cs.query(q) * (cs.query(a) + cs.query(a, 1)
                                               - cs.query(b))])
        return q, a, b

    def synthesize(self, config, ctx):
        q, a, b = config
        t = ctx.table
        f0, f1 = 3, 5
        for row in range(10):
            t.assign_fixed(q, row, 1)
            t.assign_advice(a, row, f0)
            t.assign_advice(b, row, f0 + f1)
            f0, f1 = f1, f0 + f1
        t.assign_advice(a, 10, f0)


def test_fold_eval_kernel_matches_plain(cuda_device):  # noqa: F811
    S = CircuitRunner(4, _Fibo(), [], BN254_G1).collect_structure()
    lf = limb_field(S.modulus)
    rng = np.random.default_rng(1)
    p = S.modulus
    Ws1, Ws2 = ([[int(x) % p for x in rng.integers(0, 1 << 62, size=sz)]
                 for sz in S.round_sizes] for _ in range(2))
    ch1 = [int(x) % p for x in rng.integers(0, 1 << 62, size=S.num_challenges + 1)]
    ch2 = list(reversed(ch1))
    js = list(range(S.get_degree_for_folding()))
    want = S.fold_evaluator("cpu").fold_eval_multi(
        [lf.encode(w) for w in Ws1], [lf.encode(w) for w in Ws2], js, ch1, ch2)
    got = S.fold_evaluator(cuda_device).fold_eval_multi(
        [lf.encode(w, cuda_device) for w in Ws1],
        [lf.encode(w, cuda_device) for w in Ws2], js, ch1, ch2)
    assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("rows", [(0, 16), (3, 11), (5, 6), (9, 16), (15, 16)],
                         ids=lambda r: f"{r[0]}-{r[1]}")
def test_fold_eval_kernel_row_ranges(rows, cuda_device):  # noqa: F811
    """A row range (a mesh rank's block): ends off the block, one row, the
    last rows, where the rotations wrap."""
    S = CircuitRunner(4, _Fibo(), [], BN254_G1).collect_structure()
    lf = limb_field(S.modulus)
    rng = np.random.default_rng(2)
    p = S.modulus
    Ws1, Ws2 = ([[int(x) % p for x in rng.integers(0, 1 << 62, size=sz)]
                 for sz in S.round_sizes] for _ in range(2))
    ch1 = [int(x) % p for x in rng.integers(0, 1 << 62, size=S.num_challenges + 1)]
    ch2 = list(reversed(ch1))
    js = list(range(S.get_degree_for_folding()))
    want = S.fold_evaluator("cpu").fold_eval_multi(
        [lf.encode(w) for w in Ws1], [lf.encode(w) for w in Ws2], js, ch1, ch2)
    got = S.fold_evaluator(cuda_device).fold_eval_multi(
        [lf.encode(w, cuda_device) for w in Ws1],
        [lf.encode(w, cuda_device) for w in Ws2], js, ch1, ch2, rows=rows)
    assert torch.equal(got.cpu(), want[:, rows[0]:rows[1]])


@pytest.mark.parametrize("n_regs, block", [(40, 128), (60, 64), (120, 32), (220, 32)])
def test_fold_eval_kernel_register_file_sizes(n_regs, block, cuda_device):  # noqa: F811
    """A hand-made program that keeps n_regs registers live (every load
    first, then their sum): blocks of 128, 64 and 32 rows."""
    from mira_tpu_torch import _build
    from mira_tpu_torch.polynomial import fold_evaluator as fe

    lf = limb_field(BN254_FR)
    nrow, n_static = 1000, 7
    rng = np.random.default_rng(n_regs)
    stat = lf.encode([int(x) for x in rng.integers(0, 1 << 62, size=n_static * nrow)],
                     cuda_device).reshape(n_static, nrow, 8)
    w = lf.encode([int(x) for x in rng.integers(0, 1 << 62, size=2 * nrow)],
                  cuda_device).reshape(2, 1, nrow, 8)
    ops = ([(fe.OP_LOAD_STATIC, i % n_static, -1, i) for i in range(n_regs - 1)]
           + [(fe.OP_LOAD_FOLD, 0, -1, n_regs - 1)]
           + [(fe.OP_MUL if i % 2 else fe.OP_ADD, 0, i, 0) for i in range(1, n_regs)]
           + [(fe.OP_OUTPUT, 0, -1, 0)])
    ops_t = torch.tensor(ops, dtype=torch.int32, device=cuda_device)
    jm = lf.encode([0, 1, 5], cuda_device)
    ch = torch.zeros(3, 1, 8, dtype=torch.int32, device=cuda_device)
    consts = torch.zeros(1, 8, dtype=torch.int32, device=cuda_device)
    assert _build.lib().mira_fold_eval_block(n_regs, len(ops)) == block
    assert fe.fold_eval_block(n_regs, len(ops)) == block  # the host mirror
    for rows in (None, (37, 1000)):
        got = fe.fold_eval_cuda(lf, ops_t, n_regs, stat, w[0], w[1], ch, jm,
                                consts, rows)
        want = fe.fold_eval_plain(lf, ops, stat, w[0], w[1], ch, jm, consts, rows)
        assert torch.equal(got, want)
    with pytest.raises(ValueError, match="shared memory"):  # 400 KB a 32-row block
        fe.fold_eval_cuda(lf, ops_t, 400, stat, w[0], w[1], ch, jm, consts)


@pytest.mark.parametrize("curve", CURVES, ids=IDS)
@pytest.mark.parametrize("window", [5, 6])
def test_fixed_table_kernel_identity_blocks(curve, window, cuda_device):  # noqa: F811
    """Kernel 3b's blocks of 128 lanes: one of live lanes, one with a single
    identity lane, one of identity lanes only, and a last block of five."""
    from mira_tpu_torch.ops.msm import TABLE_BLOCK

    rng = random.Random(window)
    base = [AffinePoint.random(curve, rng) for _ in range(9)]
    n = 3 * TABLE_BLOCK + 5
    ident = AffinePoint.identity(curve)
    pts = [base[i % 9] for i in range(n)]
    pts[TABLE_BLOCK + 17] = ident
    pts[2 * TABLE_BLOCK : 3 * TABLE_BLOCK] = [ident] * TABLE_BLOCK
    P = jacobian_ops(curve.name).encode_points(pts, cuda_device)
    table = cuda_msm.fixed_table_cuda(P, curve, window)
    torch.cuda.synchronize()
    assert torch.equal(table, precompute_fixed_table_plain(P, curve, window))
    assert not table[2 * TABLE_BLOCK : 3 * TABLE_BLOCK].any()


@pytest.mark.parametrize("curve", CURVES, ids=IDS)
def test_fixed_table_kernel_rejects_jacobian_bases(curve, cuda_device):  # noqa: F811
    """Kernel 3b takes affine bases and identities only: a base with Z = 2
    (a valid Jacobian point) raises instead of giving a wrong table."""
    p = curve.base_modulus
    pt = AffinePoint.random(curve, random.Random(3))
    x, y = int(pt.x.v), int(pt.y.v)
    jac = tuple(limb_field(p).encode([v % p] * 2, cuda_device)
                for v in (4 * x, 8 * y, 2))  # (x, y) with Z = 2
    with pytest.raises(ValueError, match="affine"):
        cuda_msm.fixed_table_cuda(jac, curve, 5)


@pytest.mark.parametrize("curve", CURVES, ids=IDS)
@pytest.mark.parametrize("window", [5, 6])
@pytest.mark.parametrize("n", [1, 255, 2117, 4096])
def test_fixed_kernels_match_plain_and_host(curve, window, n, cuda_device):  # noqa: F811
    """The multiples table and the fixed-base MSM against their plain
    versions and the host MSM: duplicate bases, a zero scalar, an identity
    lane, and scalars 1, r - 1 and 2^250 - 1 (every raw 5-bit digit
    maximal, so the carry runs into the extra window)."""
    sc, pts = _adversarial(curve, max(n, 11), seed=n + window)
    sc[:3] = [1, curve.scalar_modulus - 1, (1 << 250) - 1]
    sc, pts = sc[:n], pts[-n:]
    ops = jacobian_ops(curve.name)
    P = ops.encode_points(pts, cuda_device)
    table = cuda_msm.fixed_table_cuda(P, curve, window)
    plain_table = precompute_fixed_table_plain(P, curve, window)
    torch.cuda.synchronize()
    assert torch.equal(table, plain_table)
    s = encode_scalars(sc, curve.scalar_modulus, cuda_device)
    got = ops.decode_points(tuple(
        c[None] for c in cuda_msm.msm_fixed_cuda(s, table, curve, window)))[0]
    plain = ops.decode_points(tuple(
        c[None] for c in msm_fixed_plain(s, table, curve, window)))[0]
    assert got == plain == msm_reference(s, P, curve)


def test_fixed_kernel_identity_cases(cuda_device):  # noqa: F811
    P = AffinePoint.random(BN254_G1, random.Random(3))
    ident = AffinePoint.identity(BN254_G1)
    ops = jacobian_ops("bn254")
    for sc, pts, want in (([0, 0], [P, P], ident), ([3], [ident], ident),
                          ([1, 1], [P, P], P.double()),
                          ([1, 1], [P, P.neg()], ident)):
        table = cuda_msm.fixed_table(ops.encode_points(pts, cuda_device),
                                     BN254_G1, 5)
        s = encode_scalars(sc, BN254_G1.scalar_modulus, cuda_device)
        out = cuda_msm.msm_fixed(s, table, BN254_G1, 5)
        assert ops.decode_points(tuple(c[None] for c in out))[0] == want


def test_fixed_kernels_reject_other_windows(cuda_device):  # noqa: F811
    ops = jacobian_ops("bn254")
    P = ops.encode_points([AffinePoint.generator(BN254_G1)], cuda_device)
    with pytest.raises(ValueError):
        cuda_msm.fixed_table(P, BN254_G1, 4)


# -- the NTT kernels ----------------------------------------------------------
def _ntt_inputs(n, seed, dev):
    p = BN254_FR
    rng = np.random.default_rng(seed)
    vals = [int.from_bytes(rng.bytes(32), "little") % p for _ in range(n)]
    vals[: min(n, 4)] = [0, p - 1, 1, p - 1][: min(n, 4)]
    return vals, limb_field(p).encode(vals, dev)


@pytest.mark.parametrize("inverse", [False, True], ids=["forward", "inverse"])
@pytest.mark.parametrize("log_n", [1, 2, 3, 7, 11, 12, 13])
def test_ntt_kernels_match_plain_and_host(log_n, inverse, cuda_device):  # noqa: F811
    """Both engines, where the size admits them, against the plain version on
    the card and the host transform: even and odd log n, 0 and p - 1 among
    the inputs."""
    from mira_tpu_torch.ops import ntt

    p = BN254_FR
    vals, a = _ntt_inputs(1 << log_n, log_n, cuda_device)
    want = ntt.ntt_plain(a, p, inverse)
    assert limb_field(p).decode(want) == ntt.ntt_host(vals, p, inverse)
    engines = ["stage"] + (["fourstep"] if log_n >= 2 else [])
    for engine in engines + ["auto"]:
        got = ntt.ntt(a, p, inverse, engine=engine)
        torch.cuda.synchronize()
        assert torch.equal(got, want), engine
    assert torch.equal(a, limb_field(p).encode(vals, cuda_device))  # input kept


def test_ntt_stage_kernel_matches_plain_stage(cuda_device):  # noqa: F811
    from mira_tpu_torch.ops import cuda_ntt, ntt

    p = BN254_FR
    _, a = _ntt_inputs(1 << 10, 3, cuda_device)
    tw = ntt._twiddle_table(p, 10, False, str(cuda_device))
    for half in (1, 8, 512):
        got = cuda_ntt.stage_cuda(a, tw, half, p)
        torch.cuda.synchronize()
        assert torch.equal(got, ntt.stage_plain(a, tw, half, p))


def test_coset_round_trip_and_engine_limits(cuda_device):  # noqa: F811
    from mira_tpu_torch.ops import cuda_ntt, ntt

    p = BN254_FR
    vals, a = _ntt_inputs(1 << 12, 9, cuda_device)
    for engine in ("stage", "fourstep"):
        back = ntt.coset_intt(ntt.coset_ntt(a, p, engine), p, engine)
        assert torch.equal(back, a)
    with pytest.raises(ValueError):
        cuda_ntt.ntt_fourstep_cuda(a[:2], p)


@pytest.mark.parametrize("inverse", [False, True], ids=["forward", "inverse"])
@pytest.mark.parametrize("passes", [2, 3])
@pytest.mark.parametrize("log_n", [3, 4, 7, 8, 12, 13, 16])
def test_ntt_fourstep_every_split(log_n, passes, inverse, cuda_device):  # noqa: F811
    """Kernel 8 on both of its cuts (two and three column passes), odd and
    even log n, one array and a batch of three, against the plain version."""
    from mira_tpu_torch.ops import cuda_ntt, ntt

    p = BN254_FR
    split = cuda_ntt.fourstep_split(log_n, passes)
    _, a = _ntt_inputs(1 << log_n, 60 + log_n, cuda_device)
    got = cuda_ntt._fourstep(a, p, inverse, split)
    torch.cuda.synchronize()
    assert torch.equal(got, ntt.ntt_plain(a, p, inverse))
    rows = torch.stack([_ntt_inputs(1 << log_n, 70 + b, cuda_device)[1]
                        for b in range(3)])
    assert torch.equal(cuda_ntt._fourstep(rows, p, inverse, split),
                       ntt.ntt_plain(rows, p, inverse))


# -- the Poseidon kernel ------------------------------------------------------
@pytest.mark.parametrize("t,rate,length", [(3, 2, 2), (3, 2, 3), (5, 4, 4),
                                           (5, 4, 6), (2, 1, 1), (3, 2, 0),
                                           (4, 3, 7)])
def test_poseidon_kernel_matches_plain_and_host(t, rate, length, cuda_device):  # noqa: F811
    """N is not a multiple of the kernel's block; 0 and p - 1 rows."""
    from mira_tpu_torch.fields.host import field
    from mira_tpu_torch.ops.poseidon import PoseidonHash, get_spec
    from mira_tpu_torch.ops.poseidon_device import (
        poseidon_hash_batch,
        poseidon_hash_batch_plain,
    )

    p = BN254_FR
    lf = limb_field(p)
    n = 131
    rng = np.random.default_rng(t + length)
    vals = [[int.from_bytes(rng.bytes(32), "little") % p for _ in range(length)]
            for _ in range(n)]
    if length:
        vals[0], vals[1] = [0] * length, [p - 1] * length
    flat = lf.encode([v for row in vals for v in row], cuda_device).reshape(
        n, length, 8)
    got = poseidon_hash_batch(flat, p, t=t, rate=rate)
    torch.cuda.synchronize()
    assert torch.equal(got, poseidon_hash_batch_plain(flat, p, t=t, rate=rate))
    F = field(p)
    for i in (0, 1, n - 1):
        h = PoseidonHash(get_spec(p, t, rate, 10, 10))
        h.update([F(v) for v in vals[i]])
        buf, h.buf = h.buf, []
        for j in range(0, len(buf), rate):
            h.permutation(buf[j : j + rate])
        if len(buf) % rate == 0:
            h.permutation([])
        assert lf.decode(got[i : i + 1]) == [h.state[1].v]


@pytest.mark.parametrize("route", ["thread", "lanes"])
@pytest.mark.parametrize("t", [2, 3, 4, 5])
def test_poseidon_routes_match_plain(t, route, cuda_device):  # noqa: F811
    """Each route of kernel 10 forced, at every width, on empty, short, one
    chunk and several chunks of input, on 1, 33 and 131 hashes (the lane
    route's last warp partly past the batch)."""
    from mira_tpu_torch.ops import cuda_poseidon
    from mira_tpu_torch.ops.poseidon_device import poseidon_hash_batch_plain

    p = BN254_FR
    lf = limb_field(p)
    rng = np.random.default_rng(100 + t)
    for length in (0, 1, t - 1, 2 * t + 1):
        for n in (1, 33, 131):
            vals = [int.from_bytes(rng.bytes(32), "little") % p
                    for _ in range(n * length)]
            flat = lf.encode(vals, cuda_device).reshape(n, length, 8)
            got = cuda_poseidon._launch(flat, p, t, t - 1, 10, 10, route)
            torch.cuda.synchronize()
            want = poseidon_hash_batch_plain(flat, p, t=t, rate=t - 1)
            assert torch.equal(got, want), (length, n)


def test_poseidon_route_follows_the_rule(cuda_device):  # noqa: F811
    """`poseidon_hash_batch` takes the route the rule names for this card on
    either side of the crossover, and both routes agree there."""
    from mira_tpu_torch.ops import cuda_poseidon
    from mira_tpu_torch.ops.poseidon_device import poseidon_hash_batch

    sms = cuda_poseidon.card_sms(str(cuda_device))
    cross = cuda_poseidon.LANE_THREADS_PER_SM * sms // cuda_poseidon.lanes_per_hash(3)
    assert cuda_poseidon.poseidon_route(cross, 3, sms) == "lanes"
    assert cuda_poseidon.poseidon_route(cross + 1, 3, sms) == "thread"
    p = BN254_FR
    lf = limb_field(p)
    rng = np.random.default_rng(5)
    for n in (cross, cross + 1):
        vals = [int.from_bytes(rng.bytes(32), "little") % p for _ in range(2 * n)]
        flat = lf.encode(vals, cuda_device).reshape(n, 2, 8)
        before = _launched("poseidon")["poseidon"]
        got = poseidon_hash_batch(flat, p)
        assert _launched("poseidon")["poseidon"] == before + 1
        for route in cuda_poseidon.ROUTES:
            assert torch.equal(got, cuda_poseidon._launch(flat, p, 3, 2, 10, 10,
                                                          route))


def test_poseidon_kernel_rejects_wide_states(cuda_device):  # noqa: F811
    from mira_tpu_torch.ops.cuda_poseidon import poseidon_hash_batch_cuda

    flat = torch.zeros(4, 5, 8, dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError):
        poseidon_hash_batch_cuda(flat, BN254_FR, t=6, rate=5)


# -- the generic-base engines: Pippenger (kernels 4, 5), per lane (6, 7) ------
ENGINES = ["pippenger", "pippenger-u4", "window", "lane"]


def _edge_scalars(curve, sc):
    """0, 1, r - 1, 16 (the signed recoding's digit -16 with a carry), 16 in
    every window, and 2^250 - 1 (every raw digit maximal)."""
    r = curve.scalar_modulus
    every = sum(16 << (5 * k) for k in range(50))
    sc[:6] = [0, 1, r - 1, 16, every % r, (1 << 250) - 1]
    return sc


@pytest.mark.parametrize("curve", CURVES, ids=IDS)
@pytest.mark.parametrize("method", ENGINES)
@pytest.mark.parametrize("n", [1, 255, 300, 4096])
def test_msm_engine_kernels_match_plain_and_host(curve, method, n, cuda_device):  # noqa: F811
    """Kernels 4-7 against their plain versions on the card and the host
    MSM: duplicate bases (outside the TPU kernels' precondition, exact
    here), an identity lane, zero and edge scalars."""
    sc, pts = _adversarial(curve, max(n, 11), seed=n + len(method))
    sc = _edge_scalars(curve, sc)
    sc, pts = sc[:n], pts[-n:]
    got, s, P = _run(lambda s, P, c: msm(s, P, c, method), curve, sc, pts,
                     cuda_device)
    plain = _run(plain_engine(method), curve, sc, pts, cuda_device)[0]
    assert got == plain == msm_reference(s, P, curve)


@pytest.mark.parametrize("method", ENGINES)
def test_msm_engine_kernels_identity_cases(method, cuda_device):  # noqa: F811
    P = AffinePoint.random(BN254_G1, random.Random(3))
    ident = AffinePoint.identity(BN254_G1)
    for sc, pts, want in (([0, 0], [P, P], ident), ([3], [ident], ident),
                          ([1, 1], [P, P], P.double()),
                          ([1, 1], [P, P.neg()], ident),
                          ([16, 16], [P, P], P.scalar_mul(32))):
        got = _run(lambda s, Q, c: msm(s, Q, c, method), BN254_G1, sc, pts,
                   cuda_device)[0]
        assert got == want


def test_msm_engine_launch_counters(cuda_device):  # noqa: F811
    sc, pts = _adversarial(BN254_G1, 64, seed=5)
    names = {"pippenger": "msm_pippenger", "pippenger-u4": "msm_pippenger_u4",
             "window": "msm_window", "lane": "msm_lane"}
    for method, counter in names.items():
        before = _launched(counter)[counter]
        _run(lambda s, P, c: msm(s, P, c, method), BN254_G1, sc, pts, cuda_device)
        assert _launched(counter)[counter] == before + 1


@pytest.mark.parametrize("engine", ["stage", "fourstep"])
@pytest.mark.parametrize("log_n", [2, 5, 12])
def test_ntt_kernels_batched(engine, log_n, cuda_device):  # noqa: F811
    """A (B, n, 8) batch is one launch of each kernel and equals B separate
    transforms and the plain batched version, forward and inverse."""
    from mira_tpu_torch.ops import ntt

    p = BN254_FR
    rows = torch.stack([_ntt_inputs(1 << log_n, 40 + b, cuda_device)[1]
                        for b in range(5)])
    for inverse in (False, True):
        before = _launched("ntt_fourstep", "ntt_stage")
        got = ntt.ntt(rows, p, inverse, engine=engine)
        after = _launched("ntt_fourstep", "ntt_stage")
        assert after["ntt_fourstep"] - before["ntt_fourstep"] == (engine == "fourstep")
        assert after["ntt_stage"] - before["ntt_stage"] == (
            log_n if engine == "stage" else 0)
        torch.cuda.synchronize()
        assert torch.equal(got, ntt.ntt_plain(rows, p, inverse))
        for b in range(rows.shape[0]):
            assert torch.equal(got[b], ntt.ntt(rows[b], p, inverse, engine=engine))


# -- kernels 1 and 3 on the layout's edge cases and at 2^17 --------------------
LAYOUT_CASES = ["random", "all_equal", "all_zero", "below_2c", "r_minus_1",
                "dup_opposite", "identity_lanes"]


def _layout_case(curve, n, case, seed=0):
    """tests/test_torch_msm_layout.py's edge cases: all-equal scalars (one
    bucket per window holds every point), all zero, scalars below 2^c,
    r - 1, duplicate and opposite bases with equal scalars, identity lanes."""
    from mira_tpu_torch.ops.msm import bucket_window

    rng = random.Random(seed * 1000 + n)
    r = curve.scalar_modulus
    base = [AffinePoint.random(curve, rng) for _ in range(5)]
    pts = [base[i % 5] for i in range(n)]
    nrng = np.random.default_rng(seed * 1000 + n)
    sc = [int.from_bytes(nrng.bytes(32), "little") % r for _ in range(n)]
    if case == "all_equal":
        sc = [sc[0]] * n
    elif case == "all_zero":
        sc = [0] * n
    elif case == "below_2c":
        sc = [s % (1 << bucket_window(n)) for s in sc]
    elif case == "r_minus_1":
        sc = [r - 1] * n
    elif case == "dup_opposite":
        pts = [base[(i // 2) % 5].neg() if i % 4 == 1 else base[(i // 2) % 5]
               for i in range(n)]
        sc = [sc[i - i % 2] for i in range(n)]
    elif case == "identity_lanes":
        pts = [AffinePoint.identity(curve) if i % 3 == 0 else p
               for i, p in enumerate(pts)]
    return sc, pts


@pytest.mark.parametrize("curve", CURVES, ids=IDS)
@pytest.mark.parametrize("n", [1, 2, 255])
@pytest.mark.parametrize("case", LAYOUT_CASES)
def test_msm_kernels_on_layout_cases(curve, n, case, cuda_device):  # noqa: F811
    """The bucket kernel and the fixed-base kernel (both windows) against
    their plain versions and the host MSM on the layout's edge cases."""
    sc, pts = _layout_case(curve, n, case)
    got, s, P = _run(msm, curve, sc, pts, cuda_device)
    assert got == _run(msm_plain, curve, sc, pts, cuda_device)[0]
    ref = msm_reference(s, P, curve)
    assert got == ref
    ops = jacobian_ops(curve.name)
    for window in (5, 6):
        table = cuda_msm.fixed_table_cuda(P, curve, window)
        fixed = ops.decode_points(tuple(
            c[None] for c in cuda_msm.msm_fixed_cuda(s, table, curve, window)))[0]
        plain = ops.decode_points(tuple(
            c[None] for c in msm_fixed_plain(s, table, curve, window)))[0]
        assert fixed == plain == ref


@pytest.mark.parametrize("c", [2, 3, 7, 13, 16])
@pytest.mark.parametrize("case", ["random", "all_equal", "dup_opposite"])
def test_bucket_kernel_every_window_width(c, case, cuda_device):  # noqa: F811
    """The bucket kernel's phases at a window c other than its choice for the
    width (sparse buckets at c = 16, 128 windows at c = 2) against the host
    MSM."""
    sc, pts = _layout_case(BN254_G1, 300, case, seed=c)
    ops = jacobian_ops("bn254")
    s = encode_scalars(sc, BN254_G1.scalar_modulus, cuda_device)
    P = ops.encode_points(pts, cuda_device)
    phases, out = cuda_msm.bucket_phases(s, P, BN254_G1, c)
    for _, run in phases:
        assert run() == 0
    got = ops.decode_points(tuple(c_[None] for c_ in out))[0]
    assert got == msm_reference(s, P, BN254_G1)


@pytest.mark.parametrize("curve", CURVES, ids=IDS)
def test_msm_kernels_at_2_17(curve, cuda_device):  # noqa: F811
    """Both kernels at the cross-term width 2^17 over key points against
    their plain versions (the same function) and the host MSM, with the
    first scalars 0, 1, r - 1 and two equal ones."""
    from mira_tpu_torch.ops.commitment import CommitmentKey

    n = 1 << 17
    ck = CommitmentKey.setup(curve, 17, b"cuda-test", device=cuda_device)
    P = ck._enc_slice(n)
    rng = np.random.default_rng(17)
    r = curve.scalar_modulus
    sc = [int.from_bytes(rng.bytes(32), "little") % r for _ in range(n)]
    sc[:5] = [0, 1, r - 1, sc[9], sc[9]]
    s = encode_scalars(sc, r, cuda_device)
    ops = jacobian_ops(curve.name)

    def dec(out):
        return ops.decode_points(tuple(c[None] for c in out))[0]

    ref = msm_reference(s, P, curve)
    assert dec(msm(s, P, curve)) == dec(msm_plain(s, P, curve)) == ref
    table = cuda_msm.fixed_table_cuda(P, curve, 6)
    assert dec(cuda_msm.msm_fixed_cuda(s, table, curve, 6)) == dec(
        msm_fixed_plain(s, table, curve, 6)) == ref


def test_msm_kernel_launch_counters(cuda_device):  # noqa: F811
    """One MSM is one count, whatever the number of its C calls."""
    sc, pts = _adversarial(BN254_G1, 64, seed=6)
    before = _launched("msm_bucket", "msm_fixed")
    _, s, P = _run(msm, BN254_G1, sc, pts, cuda_device)
    cuda_msm.msm_fixed_cuda(s, cuda_msm.fixed_table_cuda(P, BN254_G1, 5),
                            BN254_G1, 5)
    assert _launched("msm_bucket", "msm_fixed") == {
        "msm_bucket": before["msm_bucket"] + 1, "msm_fixed": before["msm_fixed"] + 1}


# -- kernels 4 and 5: chunks of bases, launch counters, scratch ---------------
@pytest.mark.parametrize("curve", CURVES, ids=IDS)
@pytest.mark.parametrize("signed", [True, False], ids=["signed", "u4"])
@pytest.mark.parametrize("n", [255, 256, 257, 768])
def test_pippenger_kernels_at_chunk_borders(curve, signed, n, cuda_device):  # noqa: F811
    """Kernels 4 and 5 in chunks of 256 bases: one base either side of a
    chunk and a width of three chunks, with duplicate and opposite bases
    across the borders, an identity lane and edge scalars, against their
    plain versions, `pippenger_msm_model` and the host MSM."""
    sc, pts = _adversarial(curve, n, seed=n + signed)
    sc = _edge_scalars(curve, sc)
    pts[n // 2] = pts[1].neg()
    pts[n - 2] = pts[2]
    ops = jacobian_ops(curve.name)

    def dec(out):
        return ops.decode_points(tuple(c[None] for c in out))[0]

    s = encode_scalars(sc, curve.scalar_modulus, cuda_device)
    P = ops.encode_points(pts, cuda_device)
    got = dec(cuda_msm.msm_pippenger_cuda(s, P, curve, signed, chunk=256))
    assert got == dec(msm_pippenger_plain(s, P, curve, signed))
    assert got == dec(pippenger_msm_model(s, P, curve, signed, 256))
    assert got == msm_reference(s, P, curve)


def test_pippenger_kernel_counts_as_itself(cuda_device):  # noqa: F811
    """A kernel-4 call moves `msm_pippenger` alone and a kernel-5 call
    `msm_pippenger_u4` alone, over several chunks: never the counts of the
    table build and the fixed-base MSM whose code they run."""
    sc, pts = _adversarial(BN254_G1, 300, seed=9)
    names = ("msm_bucket", "msm_fixed", "fixed_table", "msm_pippenger",
             "msm_pippenger_u4")
    for signed, moved in ((True, "msm_pippenger"), (False, "msm_pippenger_u4")):
        before = _launched(*names)
        _run(lambda s, P, c: cuda_msm.msm_pippenger_cuda(s, P, c, signed, chunk=128),
             BN254_G1, sc, pts, cuda_device)
        after = _launched(*names)
        assert {k: after[k] - before[k] for k in names} == {
            k: int(k == moved) for k in names}


def test_pippenger_kernel_rejects_jacobian_bases(cuda_device):  # noqa: F811
    sc, pts = _adversarial(BN254_G1, 16, seed=4)
    ops = jacobian_ops("bn254")
    X, Y, Z = ops.encode_points(pts, cuda_device)
    Z = Z.clone()
    Z[2] = X[2]  # a base with Z != 0, 1
    s = encode_scalars(sc, BN254_G1.scalar_modulus, cuda_device)
    with pytest.raises(ValueError):
        cuda_msm.msm_pippenger_cuda(s, (X, Y, Z), BN254_G1)


def test_pippenger_kernel_scratch_is_one_chunks(cuda_device):  # noqa: F811
    """One 2^20-base call of kernel 4 in chunks of 2^18 allocates at most
    `pippenger_scratch_bytes` of its chunks (each buffer rounded to the
    allocator's 512 bytes), less than the whole width's table alone, and
    equals the bucket kernel.  The bases are 1,024 random points repeated
    (duplicates are exact)."""
    from mira_tpu_torch import _build

    n, chunk = 1 << 20, 1 << 18
    sc, pts = _adversarial(BN254_G1, 1024, seed=20)
    ops = jacobian_ops("bn254")
    P = tuple(c.repeat(n // 1024, 1) for c in ops.encode_points(pts, cuda_device))
    rng = np.random.default_rng(20)
    r = BN254_G1.scalar_modulus
    s = encode_scalars([int.from_bytes(rng.bytes(32), "little") % r for _ in range(n)],
                       r, cuda_device)
    nwin = pippenger_windows(254, True)
    nparts = cuda_msm.FIXED_BLOCK * sum(
        _build.lib().mira_msm_fixed_blocks(0, 5, nc, nwin)
        for _, nc in cuda_msm.pippenger_chunks(n, chunk))
    bound = cuda_msm.pippenger_scratch_bytes(nwin, chunk, nparts) + 16 * 512
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = cuda_msm.msm_pippenger_cuda(s, P, BN254_G1, True, chunk)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    assert peak <= bound < n * 1024

    def dec(o):
        return ops.decode_points(tuple(c[None] for c in o))[0]

    assert dec(out) == dec(cuda_msm.msm_cuda(s, P, BN254_G1))


# -- kernels 6 and 7: kernel 5's and kernel 1's C calls, kernel 7's parts -----
MSM_COUNTERS = ("msm_bucket", "msm_fixed", "fixed_table", "msm_pippenger",
                "msm_pippenger_u4", "msm_window", "msm_lane")


@pytest.mark.parametrize("window, moved", [(4, "msm_window"), (1, "msm_lane")])
def test_lane_kernels_count_as_themselves(window, moved, cuda_device):  # noqa: F811
    """A kernel-6 call moves `msm_window` alone and a kernel-7 call
    `msm_lane` alone, kernel 7 also over five parts of its bases: never the
    counts of kernels 1, 3, 3b, 4 or 5, whose C calls they make."""
    sc, pts = _adversarial(BN254_G1, 300, seed=11)
    for records in (cuda_msm.BUCKET_MAX_RECORDS, 4096):
        before = _launched(*MSM_COUNTERS)
        _run(lambda s, P, c: cuda_msm.msm_lane_cuda(s, P, c, window, records),
             BN254_G1, sc, pts, cuda_device)
        after = _launched(*MSM_COUNTERS)
        assert {k: after[k] - before[k] for k in MSM_COUNTERS} == {
            k: int(k == moved) for k in MSM_COUNTERS}


@pytest.mark.parametrize("curve", CURVES, ids=IDS)
@pytest.mark.parametrize("case, n", [("random", 120), ("opposite", 120),
                                     ("identity", 120), ("equal", 120),
                                     ("random", 300)])
def test_lane_kernel_parts_match_plain(curve, case, n, cuda_device):  # noqa: F811
    """Kernel 7 split into parts of 60 bases by a record limit of 4,096
    passed to the wrapper: two parts whose results are opposite, the
    identity and a point, or equal (the complete addition's doubling), and
    five parts of random bases, against `msm_lane_plain` (the per-lane
    double-and-add) and the host MSM."""
    sc, pts = _adversarial(curve, n, seed=n + len(case))
    if case == "opposite":
        sc[60:], pts[60:] = sc[:60], [p.neg() for p in pts[:60]]
    elif case == "identity":
        sc[60:] = [0] * 60
    elif case == "equal":
        sc[60:], pts[60:] = sc[:60], pts[:60]
    assert cuda_msm.lane_parts(n, 254, 4096) == [(c0, 60) for c0 in range(0, n, 60)]
    got, s, P = _run(lambda s, P, c: cuda_msm.msm_lane_cuda(s, P, c, 1, 4096),
                     curve, sc, pts, cuda_device)
    assert got == _run(lambda s, P, c: msm_lane_plain(s, P, c, 1), curve, sc, pts,
                       cuda_device)[0]
    assert got == msm_reference(s, P, curve)
    if case == "opposite":
        assert got == AffinePoint.identity(curve)


def test_window_kernel_rejects_jacobian_bases(cuda_device):  # noqa: F811
    """Kernel 6 runs kernel 3b's table build, which takes affine or
    identity bases only."""
    sc, pts = _adversarial(BN254_G1, 16, seed=4)
    X, Y, Z = jacobian_ops("bn254").encode_points(pts, cuda_device)
    Z = Z.clone()
    Z[2] = X[2]  # a base with Z != 0, 1
    s = encode_scalars(sc, BN254_G1.scalar_modulus, cuda_device)
    with pytest.raises(ValueError):
        cuda_msm.msm_lane_cuda(s, (X, Y, Z), BN254_G1, 4)


def test_tensorstar_mock_key_commit_on_the_card_equals_the_cpu(cuda_device):  # noqa: F811
    """TensorStar's mock key (2^26 weights, workloads/tensorstar.py) commits
    a witness on the card to the point the same key commits it to on the
    CPU, and to its Python-int inner product."""
    from mira_tpu_torch.ops.mock_commitment import MockCommitmentKey

    rng = np.random.default_rng(26)
    w = rng.integers(0, 1 << 32, size=(1 << 20, 8), dtype=np.uint64).astype(np.uint32)
    w[:, 7] &= 0x1FFFFFFF
    lf = limb_field(BN254_G1.scalar_modulus)
    mont = lf.from_plain(torch.from_numpy(w.view(np.int32)))
    card = MockCommitmentKey(BN254_G1, 26, b"bn256", cuda_device)
    cpu = MockCommitmentKey(BN254_G1, 26, b"bn256", "cpu")
    got = card.commit_device(mont.to(cuda_device))
    assert got == cpu.commit_device(mont)
    vals = lf.decode(mont[:4096])
    assert card.commit_device(mont[:4096].to(cuda_device)) == cpu.commit_ints(vals)


def test_checkpoint_round_trip_of_a_cuda_ivc(tmp_path, cuda_device):  # noqa: F811
    """A k=17 trivial IVC on the card (mock keys) saved and resumed onto the
    card: the resumed IVC's state equals the saved one's, its witnesses live
    on the card, it folds one more step to the uninterrupted IVC's
    accumulators and passes verify(strict=True)."""
    from mira_tpu_torch.ivc.ivc import IVC
    from mira_tpu_torch.ivc.public_params import CircuitSide, PublicParams
    from mira_tpu_torch.ivc.step_circuit import TrivialCircuit
    from mira_tpu_torch.ops.mock_commitment import MockCommitmentKey

    pp = PublicParams(
        CircuitSide(TrivialCircuit(arity=1),
                    MockCommitmentKey(BN254_G1, 21, b"bn256", cuda_device), 17),
        CircuitSide(TrivialCircuit(arity=1),
                    MockCommitmentKey(GRUMPKIN, 21, b"grumpkin", cuda_device), 17),
        BN254_G1, GRUMPKIN)
    ivc = IVC(pp, TrivialCircuit(arity=1), [11], TrivialCircuit(arity=1), [22])
    ivc.fold_step()
    path = str(tmp_path / "cuda.npz")
    ivc.save_checkpoint(path)
    resumed = IVC.resume(pp, TrivialCircuit(arity=1), TrivialCircuit(arity=1), path)
    for a, b in ((ivc.primary, resumed.primary), (ivc.secondary, resumed.secondary)):
        assert a.relaxed_trace.U == b.relaxed_trace.U
        assert b.relaxed_trace.W.E.device.type == "cuda"
        assert all(torch.equal(x, y) for x, y in
                   zip(a.relaxed_trace.W.W, b.relaxed_trace.W.W))
    ivc.fold_step()
    resumed.fold_step()
    for a, b in ((ivc.primary, resumed.primary), (ivc.secondary, resumed.secondary)):
        assert a.relaxed_trace.U == b.relaxed_trace.U
        assert torch.equal(a.relaxed_trace.W.E, b.relaxed_trace.W.E)
    resumed.verify(strict=True)


def _canonical_rows(p, n, seed, dev):
    """(n, 8) Montgomery words drawn below 2^252 < p (each one a field
    element), with the Montgomery forms of 0, 1 and p - 1 in rows that move
    with the seed."""
    rng = np.random.default_rng(seed)
    w = rng.integers(0, 1 << 32, size=(n, 8), dtype=np.uint64).astype(np.uint32)
    w[:, 7] &= 0x0FFFFFFF
    x = torch.from_numpy(w.view(np.int32)).to(dev)
    edges = limb_field(p).encode([0, 1, p - 1], dev)
    for i in range(3):
        x[(seed * 7919 + 104729 * i) % n] = edges[i]
    return x


LINCOMB_SHAPES = [(1, 2), (2, 3), (3, 4), (4, 5), (5, 6), (6, 7), (7, 8), (7, 2),
                  (1, 8)]


@pytest.mark.parametrize("p", [BN254_FQ, BN254_FR], ids=["fq", "fr"])
@pytest.mark.parametrize("K, J", LINCOMB_SHAPES)
@pytest.mark.parametrize("n", [1, (1 << 17) - 3, 1 << 17])
def test_field_lincomb_kernel_matches_plain_and_host(p, K, J, n, cuda_device):  # noqa: F811
    """csrc/field_lincomb.cu == its plain version on every row, Montgomery
    and plain outputs (one launch each), with coefficients 0, 1 and p - 1
    among them (the combines at d = 5 and 6 are K, J = 4, 5 and 5, 6); the
    plain outputs == `LimbField.to_plain` of the Montgomery ones; sampled
    rows (the edge values' among them) == host integers."""
    from mira_tpu_torch.ops import field_lincomb as fl

    lf = limb_field(p)
    xs = [_canonical_rows(p, n, 10 * J + j, cuda_device) for j in range(J)]
    rng = random.Random(K * 100 + J)
    cs = [[rng.randrange(p) for _ in range(J)] for _ in range(K)]
    cs[0][0], cs[-1][-1] = 0, p - 1
    if J > 1:
        cs[0][1] = 1
    before = tracing.counts().get("field_lincomb", 0)
    outs = fl.lincomb(p, xs, cs)
    plains = fl.lincomb(p, xs, cs, plain=True)
    assert tracing.counts().get("field_lincomb", 0) == before + 2
    want, want_plain = fl.lincomb_plain(p, xs, cs), fl.lincomb_plain(p, xs, cs, plain=True)
    torch.cuda.synchronize()
    for o, q, wo, wq in zip(outs, plains, want, want_plain):
        assert torch.equal(o, wo) and torch.equal(q, wq)
        assert torch.equal(q, lf.to_plain(o))
    rows = sorted({0, n - 1, n // 2} | {(10 * J + j) * 7919 % n for j in range(J)}
                  | {((10 * J + j) * 7919 + 104729 * i) % n for j in range(J)
                     for i in range(3)})
    vals = [lf.decode(x[rows]) for x in xs]
    for k, row in enumerate(cs):
        host = [sum(c * v[i] for c, v in zip(row, vals)) % p for i in range(len(rows))]
        assert lf.decode(outs[k][rows]) == host
        assert words_to_ints(plains[k][rows]) == host


@pytest.mark.parametrize("p", [BN254_FQ, BN254_FR], ids=["fq", "fr"])
def test_field_lincomb_kernel_copies_unaligned_inputs(p, cuda_device):  # noqa: F811
    """Non-contiguous and misaligned inputs are copied: one launch, equal to
    the plain version."""
    from mira_tpu_torch.ops import field_lincomb as fl

    before = tracing.counts().get("field_lincomb", 0)
    xs = [_canonical_rows(p, 1001, 20 + j, cuda_device) for j in range(6)]
    xs[1] = _canonical_rows(p, 1002, 9, cuda_device)[1:]  # 32-byte rows at an odd offset
    xs[2] = _canonical_rows(p, 2002, 8, cuda_device)[::2]  # strided
    rng = random.Random(17)
    cs = [[rng.randrange(p) for _ in range(6)] for _ in range(5)]
    got = fl.lincomb(p, xs, cs)
    assert tracing.counts().get("field_lincomb", 0) == before + 1
    want = fl.lincomb_plain(p, xs, cs)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("p", [BN254_FQ, BN254_FR], ids=["fq", "fr"])
@pytest.mark.parametrize("n", [1, (1 << 17) - 3, 1 << 17])
def test_field_lincomb_to_plain_matches_limb_field(p, n, cuda_device):  # noqa: F811
    """`to_plain` on the card (one launch) == `LimbField.to_plain`, the
    edge values 0, 1 and p - 1 among the rows."""
    from mira_tpu_torch.ops import field_lincomb as fl

    x = _canonical_rows(p, n, 5, cuda_device)
    before = tracing.counts().get("field_lincomb", 0)
    got = fl.to_plain(p, x)
    assert tracing.counts().get("field_lincomb", 0) == before + 1
    assert torch.equal(got, limb_field(p).to_plain(x))


def test_field_lincomb_kernel_refuses(cuda_device):  # noqa: F811
    """A field the kernel lacks, inputs on the card and on the host, and a
    parameter block of another size are refused."""
    from mira_tpu_torch import _build
    from mira_tpu_torch.ops import field_lincomb as fl

    x = torch.zeros(4, 8, dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError):
        fl.lincomb(2**61 - 1, [x], [[1]])
    with pytest.raises(ValueError):
        fl.lincomb(BN254_FR, [x, x.cpu()], [[1, 1]])
    args = fl.pack_args(BN254_FR, [[1]])
    args.n = 4
    args.inputs[0] = x.data_ptr()
    args.outs[0] = x.data_ptr()
    assert _build.lib().mira_field_lincomb(
        1, ctypes.addressof(args), ctypes.sizeof(args) - 8,
        _build.stream_ptr(cuda_device)) != 0


def test_fold_step_combine_and_witness_fold_make_no_host_sync(monkeypatch, cuda_device):  # noqa: F811
    """One k=17 fold step of the benchmark's IVC (Poseidon on BN254, trivial
    on Grumpkin, real 2^21 keys from the checkout's .cache/ck, made there on
    first use) under MIRA_TRACE=collect, after two warm steps (the cross-term
    widths' tables exist): no host sync is charged to `cross_term_combine`,
    `witness_fold` or `ct_msm_dispatch`; the combine is one `field_lincomb`
    call a side, the witness fold one a witness round and one for E, and
    each cross-term MSM's scalars one."""
    import os

    from mira_tpu_torch.ivc.ivc import IVC
    from mira_tpu_torch.ivc.public_params import CircuitSide, PublicParams
    from mira_tpu_torch.ivc.step_circuit import TrivialCircuit
    from mira_tpu_torch.ops.commitment import CommitmentKey
    from mira_tpu_torch.workloads.poseidon import PoseidonStepCircuit

    monkeypatch.setenv("MIRA_TRACE", "collect")
    cache = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                         ".cache", "ck")
    keys = [CommitmentKey.load_or_setup_cache(c, 21, label, cache_dir=cache,
                                              device=cuda_device)
            for c, label in ((BN254_G1, "bn256"), (GRUMPKIN, "grumpkin"))]
    sc1, sc2 = PoseidonStepCircuit(BN254_G1.scalar_modulus, 1), TrivialCircuit(arity=1)
    pp = PublicParams(CircuitSide(sc1, keys[0], 17), CircuitSide(sc2, keys[1], 17),
                      BN254_G1, GRUMPKIN)
    ivc = IVC(pp, sc1, [0], sc2, [0])
    try:
        for _ in range(2):
            ivc.fold_step()
        torch.cuda.synchronize()
        tracing.reset()
        ivc.fold_step()
        torch.cuda.synchronize()
        by_span = tracing.counts_by_span()
        tracing.reset()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    for name in ("cross_term_combine", "witness_fold", "ct_msm_dispatch"):
        assert by_span.get(name, {}).get(tracing.HOST_SYNC, 0) == 0, (name, by_span)
    rounds = [len(ivc.primary.relaxed_trace.W.W), len(ivc.secondary.relaxed_trace.W.W)]
    assert by_span["cross_term_combine"].get("field_lincomb") == 2
    assert by_span["witness_fold"].get("field_lincomb") == sum(r + 1 for r in rounds)
    assert by_span["ct_msm_dispatch"].get("msm_fixed") == 9
    assert by_span["ct_msm_dispatch"].get("field_lincomb") == 9
    ivc.verify(strict=True)
