"""The port's device NTT (mira_tpu_torch/ops/ntt.py) on the CPU against
mira_tpu: `ntt`, `coset_ntt` and `coset_intt` vs the reference's `ntt` (its
XLA route on the CPU) and `ntt_host` for log n 1..10, forward and inverse;
the reference's known-answer vector; and the four-step kernel's index
algebra (its two- and three-pass cuts, tiles, DIF groups and exchanges,
the mid twiddle as the kernel forms it, odd and even log n) as a
plain-PyTorch model held to `ntt_host`, so that only the CUDA itself is
left for the card.  Inputs come
from numpy seeds; all comparisons are on decoded integers, exact."""

import numpy as np
import pytest
import torch

from mira_tpu.fields.limbs import limb_field as jax_limb_field
from mira_tpu.ops import ntt as mira_ntt
from mira_tpu_torch.convert import limbs16_to_words
from mira_tpu_torch.fields.limbs import limb_field
from mira_tpu_torch.fields.params import BN254_FQ, BN254_FR
from mira_tpu_torch.ops import cuda_ntt, ntt

from test_ntt import REFERENCE_FFT_VECTOR
import torch_port_helpers  # noqa: F401  (sizes torch's thread pool)

P = BN254_FR
LF = limb_field(P)


def _vals(n, seed):
    rng = np.random.default_rng(seed)
    vals = [int.from_bytes(rng.bytes(32), "little") % P for _ in range(n)]
    vals[: min(n, 4)] = [0, P - 1, 1, P - 1][: min(n, 4)]
    return vals


@pytest.mark.parametrize("inverse", [False, True], ids=["forward", "inverse"])
@pytest.mark.parametrize("log_n", range(1, 11))
def test_ntt_matches_mira_and_host(log_n, inverse):
    vals = _vals(1 << log_n, log_n)
    got = ntt.ntt(LF.encode(vals), P, inverse)
    theirs = mira_ntt.ntt(jax_limb_field(P).encode(vals), P, inverse)
    assert torch.equal(got, limbs16_to_words(np.asarray(theirs)))
    assert LF.decode(got) == mira_ntt.ntt_host(vals, P, inverse)


def test_known_answer_vector():
    want = [int(s) for s in REFERENCE_FFT_VECTOR]
    assert LF.decode(ntt.ntt(LF.encode(list(range(8))), P)) == want
    assert ntt.ntt_host(list(range(8)), P) == want


@pytest.mark.parametrize("log_n", [1, 4, 7])
def test_coset_transforms_match_mira(log_n):
    vals = _vals(1 << log_n, 100 + log_n)
    jlf = jax_limb_field(P)
    into = ntt.coset_ntt(LF.encode(vals), P)
    assert torch.equal(into, limbs16_to_words(
        np.asarray(mira_ntt.coset_ntt(jlf.encode(vals), P))))
    back = ntt.coset_intt(LF.encode(vals), P)
    assert torch.equal(back, limbs16_to_words(
        np.asarray(mira_ntt.coset_intt(jlf.encode(vals), P))))
    assert LF.decode(ntt.coset_intt(into, P)) == vals


def test_sizes_and_engines_are_checked():
    a = LF.encode([1, 2, 3])
    with pytest.raises(ValueError):
        ntt.ntt(a, P)
    with pytest.raises(ValueError):
        ntt.ntt(LF.encode([1, 2]), P, engine="xla")
    with pytest.raises(ValueError):  # Fq has 2-adicity 1
        ntt.ntt(limb_field(BN254_FQ).encode([1, 2, 3, 4]), BN254_FQ)
    one = LF.encode([5])
    assert ntt.ntt(one, P) is one
    fq = limb_field(BN254_FQ)
    assert fq.decode(ntt.ntt(fq.encode([3, 5]), BN254_FQ)) == [8, BN254_FQ - 2]
    # the kernels' wrappers take CUDA tensors only, and nothing past 2^24
    with pytest.raises(ValueError):
        cuda_ntt.ntt_fourstep_cuda(LF.encode([1, 2, 3, 4]), P)
    with pytest.raises(ValueError):
        cuda_ntt.ntt_stage_cuda(LF.encode([1, 2]), P)


def test_long_power_table_is_the_outer_product():
    w = ntt.get_omega(P, 14)
    got = ntt.power_table(P, w, 1 << 13, "cpu")
    idx = [0, 1, 4095, 4096, 4097, 8191]
    assert LF.decode(got[idx]) == [pow(w, i, P) for i in idx]


def _rev(x, bits):
    """Bit reversal of the low `bits` bits of an int64 tensor (0 for none)."""
    out = torch.zeros_like(x)
    for b in range(bits):
        out |= ((x >> b) & 1) << (bits - 1 - b)
    return out


def _position(tid, lo, R, q):
    """Position of a thread's element q in a group of stages on bits
    [lo, lo + R) (csrc/ntt_fourstep.cu `position`)."""
    return (tid & ((1 << lo) - 1)) | ((tid >> lo) << (lo + R)) | (q << lo)


def _thread_map(cfast, C, tc, t):
    """(column in the tile, index in the column) of thread t."""
    return (t & (C - 1), t // C) if cfast else (t // tc, t & (tc - 1))


def _run_pass(lf, src, dst, par, tw, pw_lo, pw_hi):
    """One launch of csrc/ntt_fourstep.cu's pass kernel, block by block, all
    threads of a block at once; the shared-memory exchange is a dict of the
    tile's (column, position) slots (the kernel's swizzle is a bijection on
    them)."""
    lm, R, C = par["lm"], par["R"], par["C"]
    m, E = 1 << lm, 1 << R
    tc = m >> R
    n_groups = (lm - 1) // R + 1
    r0 = lm - R * (n_groups - 1)
    t = torch.arange(C * tc)

    def columns(c):
        col = block * C + c
        return col >> par["log_w"], col & ((1 << par["log_w"]) - 1)

    for block in range(par["ncols"] // C):
        c, tid = _thread_map(par["store_cfast"] if n_groups == 1
                             else par["load_cfast"], C, tc, t)
        hi, lo_c = columns(c)
        src_base = hi * par["sh_in"] + lo_c * par["sl_in"]
        x = [src[src_base + _position(tid, lm - R, R, q) * par["sp_in"]]
             for q in range(E)]
        lo = lm - R
        for g in range(n_groups - 1):
            base = _position(tid, lo, R, 0)
            for k in range(r0 if g == 0 else R):  # dif_group
                hb, b = 1 << (R - 1 - k), lo + R - 1 - k
                s = lm - 1 - b
                for q in range(E):
                    if q & hb:
                        continue
                    j = ((base & ((1 << b) - 1)) | ((q & (hb - 1)) << lo)) << s
                    u, v = x[q], x[q | hb]
                    x[q] = lf.add(u, v)
                    x[q | hb] = lf.mul(lf.sub(u, v), tw[j])
            smem = {}
            for q in range(E):
                for ci, pi, xi in zip(c.tolist(),
                                      _position(tid, lo, R, q).tolist(), x[q]):
                    smem[ci, pi] = xi
            lo = lm - r0 - R if g == 0 else lo - R
            c, tid = _thread_map(par["store_cfast"], C, tc, t)
            x = [torch.stack([smem[ci, pi] for ci, pi in zip(
                c.tolist(), _position(tid, lo, R, q).tolist())])
                for q in range(E)]
        for k in range(R):  # dif_last: twiddles known from q alone
            hb, s = 1 << (R - 1 - k), lm - R + k
            for q in range(E):
                if q & hb:
                    continue
                u, v = x[q], x[q | hb]
                x[q] = lf.add(u, v)
                d, jj = lf.sub(u, v), q & (hb - 1)
                x[q | hb] = d if jj == 0 else lf.mul(d, tw[jj << s][None])
        hi, lo_c = columns(c)
        if par["twiddle"]:  # w^e, e = (lo & lo_mask)(k kmul + hi hmul)
            n, log_lo = 1 << par["log_n"], par["log_lo"]
            cm = lo_c & par["lo_mask"]
            for q in range(E):
                k = _rev(tid * E + q, lm)
                e = (cm * (k * par["kmul"] + hi * par["hmul"])) & (n - 1)
                x[q] = lf.mul(x[q], pw_lo[e >> log_lo] if par["twiddle"] == 2
                              else lf.mul(pw_lo[e & ((1 << log_lo) - 1)],
                                          pw_hi[e >> log_lo]))
        dst_base = hi * par["sh_out"] + lo_c * par["sl_out"]
        for q in range(E):
            k = _rev(tid * E + q, lm)
            dst[dst_base + k * par["sp_out"]] = x[q]


def fourstep_model(a, modulus, inverse, split, radix=0):
    """csrc/ntt_fourstep.cu in plain PyTorch, index for index: the passes of
    `fourstep_passes` (strides, tiles of C columns, the thread mappings of
    the load and the store, DIF groups of R stages and their exchanges, the
    last group's compile-time twiddles, the mid twiddle as one power-table
    entry or the product of two with the inverse's 1/n folded into the first
    pass's table, the bit-reversed store) between two buffers, as `_fourstep` runs
    them."""
    lf = limb_field(modulus)
    n = a.shape[0]
    log_n = n.bit_length() - 1
    passes = cuda_ntt.fourstep_passes(log_n, split, radix)
    tables = cuda_ntt.fourstep_tables(modulus, log_n, split, inverse, "cpu")
    src = a
    bufs = [torch.empty_like(a), torch.empty_like(a)]
    for i, (par, (tw, pw_lo, pw_hi)) in enumerate(zip(passes, tables)):
        dst = bufs[(len(passes) - 1 - i) % 2]
        _run_pass(lf, src, dst, par, tw, pw_lo, pw_hi)
        src = dst
    return src


# every decomposition the kernel takes: two passes at every size, three
# (the rule's cut for the largest sizes) at every size that has one, each at
# 2 and 4 elements a thread
SPLITS = [(log_n, 2) for log_n in range(2, 13)] + [
    (log_n, 3) for log_n in range(3, 13)]


@pytest.mark.parametrize("inverse", [False, True], ids=["forward", "inverse"])
@pytest.mark.parametrize("radix", [1, 2], ids=["radix2", "radix4"])
@pytest.mark.parametrize("log_n, passes", SPLITS,
                         ids=[f"2^{ln}-{ps}pass" for ln, ps in SPLITS])
def test_fourstep_index_algebra_vs_host(log_n, passes, radix, inverse):
    vals = _vals(1 << log_n, 200 + log_n)
    split = cuda_ntt.fourstep_split(log_n, passes)
    assert len(split) == passes and sum(split) == log_n
    got = fourstep_model(LF.encode(vals), P, inverse, split, radix)
    assert LF.decode(got) == ntt.ntt_host(vals, P, inverse)


def test_fourstep_passes_fit_the_kernel():
    """Every pass of every size the kernel takes, under the rule and both
    cuts and radixes, stays inside csrc/ntt_fourstep.cu's limits (256
    threads at 2 or 4 elements a thread, 32 KiB of tile, whole tiles) and
    visits each element once in and once out; two passes from
    THREE_PASS_MIN_LOG on, which would need longer columns, raise."""
    for log_n in range(cuda_ntt.FOURSTEP_MIN_LOG, cuda_ntt.FOURSTEP_MAX_LOG + 1):
        for passes in (0, 2, 3):
            if passes == 3 and log_n < 3:
                continue
            if passes == 2 and log_n >= cuda_ntt.THREE_PASS_MIN_LOG:
                with pytest.raises(ValueError):
                    cuda_ntt.fourstep_split(log_n, passes)
                continue
            split = cuda_ntt.fourstep_split(log_n, passes)
            assert len(split) in (2, 3) and max(split) <= 10, split
            for radix in (0, 1, 2):
                for par in cuda_ntt.fourstep_passes(log_n, split, radix):
                    m = 1 << par["lm"]
                    assert 1 <= par["R"] <= min(2, par["lm"])
                    assert par["C"] * (m >> par["R"]) <= 256
                    assert par["C"] * m * 32 <= 32 * 1024
                    assert par["ncols"] % par["C"] == 0
                    assert par["ncols"] * m == 1 << log_n
    assert cuda_ntt.fourstep_split(24) == cuda_ntt.fourstep_split(
        24, 3 if cuda_ntt.THREE_PASS_MIN_LOG <= 24 else 2)
