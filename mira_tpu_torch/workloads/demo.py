"""Small built-in demo structure (port of mira_tpu/workloads/demo.py): a
two-gate Plonkish circuit (a mul gate and an add gate, one compression
challenge) at a configurable table size, the structure the multi-device
dryrun (parallel/dryrun.py) folds."""

from __future__ import annotations

import random
from functools import lru_cache

from ..curves.host import BN254_G1
from ..table.circuit import ConstraintSystem
from ..table.runner import CircuitRunner


class DemoTwoGateCircuit:
    def __init__(self, k: int, seed: int = 0):
        self.k = k
        self.seed = seed

    def configure(self, cs: ConstraintSystem):
        q1 = cs.fixed_column()
        q2 = cs.fixed_column()
        a, b, c = (cs.advice_column() for _ in range(3))
        q1e, q2e, ae, be, ce = (cs.query(x) for x in (q1, q2, a, b, c))
        cs.create_gate("mul", [q1e * (ae * be - ce)])
        cs.create_gate("add", [q2e * (ae + be - ce)])
        return (q1, q2, a, b, c)

    def synthesize(self, config, ctx):
        q1, q2, a, b, c = config
        rng = random.Random(self.seed)
        t = ctx.table
        p = t.modulus
        for row in range(t.nrow - 1):
            av, bv = rng.randrange(p), rng.randrange(p)
            t.assign_advice(a, row, av)
            t.assign_advice(b, row, bv)
            if row % 2 == 0:
                t.assign_fixed(q1, row, 1)
                t.assign_advice(c, row, av * bv % p)
            else:
                t.assign_fixed(q2, row, 1)
                t.assign_advice(c, row, (av + bv) % p)


@lru_cache(maxsize=None)
def demo_structure(k: int):
    runner = CircuitRunner(k, DemoTwoGateCircuit(k), [], BN254_G1)
    return runner.collect_structure(), runner.collect_witness()
