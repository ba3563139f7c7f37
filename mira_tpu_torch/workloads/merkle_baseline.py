"""Non-IVC merkle baselines: prove the Merkle-update circuit's witness with
KZG (BN254, pairing-checked) or IPA (Grumpkin) polynomial commitments —
the reference proves the same circuit with halo2's KZG and IPA backends as
baselines (reference examples/merkle/{kzg,ipa}.rs).

The argument here is commit-and-open: synthesize the circuit, mock-check
satisfaction, commit each advice column as a polynomial, then open every
column at a Fiat-Shamir point derived from the commitments (binding the
witness).  It measures the same commit/open machinery the halo2 baselines
measure without re-implementing halo2's full vanishing argument.

Copied from mira_tpu/workloads/merkle_baseline.py (the port imports nothing
of mira_tpu): its MSMs run on the native host Pippenger, as mira_tpu's do;
`run` returns the column commitments and takes the device the IPA key is
loaded for.

    python -m mira_tpu_torch.workloads.merkle_baseline --backend kzg --k 13
"""

from __future__ import annotations

import random
import time


def _synthesize_merkle(k: int, modulus: int, batch_size: int, rng):
    from ..gadgets.main_gate import MainGate
    from ..table.circuit import ConstraintSystem, RegionCtx, TableData
    from ..table.mock import mock_check
    from .merkle import MerkleTreeUpdateCircuit

    sc = MerkleTreeUpdateCircuit(modulus, batch_size)
    sc.random_update_leaves(rng)
    cs = ConstraintSystem()
    config = sc.configure(cs)
    table = TableData(k, cs, [], modulus)
    ctx = RegionCtx(table)
    mg = MainGate(config)
    z0 = sc.front_proof_batch()[0].root().old
    z_in = [mg.assign_value(ctx, z0)]
    sc.synthesize_step(config, ctx, z_in)
    mock_check(cs, table)
    return table


def run(backend: str = "kzg", k: int = 13, batch_size: int = 1, seed: int = 0,
        device="cuda"):
    from ..curves.host import BN254_G1, GRUMPKIN
    from ..ops.poseidon import create_ro
    from ..fields.host import field

    curve = BN254_G1 if backend == "kzg" else GRUMPKIN
    modulus = curve.scalar_modulus
    rng = random.Random(seed)

    t0 = time.time()
    table = _synthesize_merkle(k, modulus, batch_size, rng)
    cols = [[v % modulus for v in col] for col in table.advice]
    print(f"synthesize+mock: {time.time() - t0:.1f}s "
          f"({len(cols)} advice cols x {table.nrow} rows)")

    t0 = time.time()
    if backend == "kzg":
        from ..pcs.kzg import KzgSrs, kzg_commit, kzg_open, kzg_verify

        srs = KzgSrs.load_or_setup_cache(table.nrow)
        commits = [kzg_commit(srs, c) for c in cols]
        print(f"srs+commit: {time.time() - t0:.1f}s")

        ro = create_ro(curve.base_modulus)
        for c in commits:
            ro.absorb_point(c)
        z = ro.squeeze(field(modulus), 127).v

        t0 = time.time()
        opens = [kzg_open(srs, c, z) for c in cols]
        print(f"open: {time.time() - t0:.1f}s")
        t0 = time.time()
        ok = all(
            kzg_verify(srs, cm, z, y, pi)
            for cm, (y, pi) in zip(commits, opens)
        )
        print(f"verify: {time.time() - t0:.1f}s")
    else:
        from ..pcs.ipa import IpaSrs, ipa_commit, ipa_open, ipa_verify

        srs = IpaSrs.setup(curve, k, device=device)
        commits = [ipa_commit(srs, c) for c in cols]
        print(f"srs+commit: {time.time() - t0:.1f}s")

        ro = create_ro(curve.base_modulus)
        for c in commits:
            ro.absorb_point(c)
        z = ro.squeeze(field(modulus), 127).v

        t0 = time.time()
        opens = [ipa_open(srs, c, z) for c in cols]
        print(f"open: {time.time() - t0:.1f}s")
        t0 = time.time()
        ok = all(
            ipa_verify(srs, cm, z, y, pf, len(c))
            for cm, c, (y, pf) in zip(commits, cols, opens)
        )
        print(f"verify: {time.time() - t0:.1f}s")

    if not ok:
        raise RuntimeError("baseline verification failed")
    print(f"merkle {backend} baseline OK (k={k}, batch={batch_size})")
    return commits


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--backend", choices=["kzg", "ipa"], default="kzg")
    ap.add_argument("--k", type=int, default=13)
    ap.add_argument("--batch-size", type=int, default=1)
    ap.add_argument("--device", default="cuda",
                    help="cuda or cpu: where the IPA key is loaded")
    args = ap.parse_args()
    run(args.backend, args.k, args.batch_size, device=args.device)
