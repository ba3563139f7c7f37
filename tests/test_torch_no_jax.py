"""The port never imports jax: every mira_tpu_torch module imports, and a
tiny SPS trace + commitment + is_sat + fold evaluation, a commitment through
a multiples table and a Groth16 prove/verify run, in a process
where importing jax raises, and in a plain process jax stays unloaded; and
no import statement in the port's sources, inside functions included, names
jax or a jax-bound mira_tpu module."""

import ast
import glob
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# mira_tpu modules that import no jax, directly or indirectly (the blocked
# subprocess imports each); the port may import these and no others.
JAX_FREE = ("constants", "curves.host", "curves.pairing", "curves.svdw",
            "fields.host", "fields.native64", "fields.params", "gadgets",
            "ivc.step_circuit", "ops.native_keygen", "ops.native_msm",
            "ops.poseidon", "polynomial.expression", "table.circuit",
            "table.tape", "utils.native_lib", "workloads.poseidon")

BLOCKER = """
import sys
class _NoJax:
    def find_spec(self, name, path=None, target=None):
        if name.split('.')[0] in ('jax', 'jaxlib'):
            raise ImportError('jax is blocked: ' + name)
sys.meta_path.insert(0, _NoJax())
"""

WORKLOAD = """
import importlib, pkgutil, sys
sys.path.insert(0, ROOT)
import mira_tpu_torch
for m in pkgutil.walk_packages(mira_tpu_torch.__path__, 'mira_tpu_torch.'):
    importlib.import_module(m.name)
for name in JAX_FREE:  # the allow-list of test_port_sources_import_no_jax
    mod = importlib.import_module('mira_tpu.' + name)
    for m in pkgutil.walk_packages(getattr(mod, '__path__', []), mod.__name__ + '.'):
        importlib.import_module(m.name)

from mira_tpu.fields.params import BN254_FQ
from mira_tpu.ops.poseidon import create_ro
from mira_tpu_torch.ops.commitment import CommitmentKey
from mira_tpu_torch.table.runner import CircuitRunner
from mira_tpu_torch.workloads.poseidon import BN254_G1


class Mul:
    @staticmethod
    def configure(cs):
        q = cs.fixed_column()
        a, b, c = (cs.advice_column() for _ in range(3))
        qe, ae, be, ce = (cs.query(x) for x in (q, a, b, c))
        cs.create_gate("mul", [qe * (ae * be - ce)])
        return q, a, b, c

    def synthesize(self, config, ctx):
        q, a, b, c = config
        t = ctx.table
        for row in range(5):
            t.assign_fixed(q, row, 1)
            t.assign_advice(a, row, row + 2)
            t.assign_advice(b, row, 7)
            t.assign_advice(c, row, (row + 2) * 7)


runner = CircuitRunner(3, Mul(), [], BN254_G1)
S = runner.collect_structure()
ck = CommitmentKey.setup(BN254_G1, 5, b"no-jax")
trace = S.run_sps_protocol(ck, [], runner.collect_witness(), create_ro(BN254_FQ))
S.is_sat(ck, create_ro(BN254_FQ), trace.u, trace.w)
out = S.fold_evaluator("cpu").fold_eval_multi(trace.w.W, trace.w.W, [0, 1, 2],
                                              [1], [1])
assert out.shape == (3, 8, 8)
assert not trace.u.W_commitments[0].is_inf

# a recurring width through its multiples table, and a Groth16 proof
import random
from mira_tpu_torch.fields.limbs import limb_field
from mira_tpu_torch.snark import groth16

v = limb_field(BN254_G1.scalar_modulus).encode(list(range(256)))
ck8 = CommitmentKey.setup(BN254_G1, 8, b"no-jax")
assert ck8.commit_device_many([v, v]) == [ck8.commit_device(v)] * 2
assert set(ck8._fb_tables) == {256}
r1cs, z = groth16.benchmark_r1cs(4)
pk = groth16.setup(r1cs, random.Random(0))
assert groth16.verify(pk.vk, groth16.prove(pk, r1cs, z, random.Random(1)), z[1:3])
print("JAX_LOADED", "jax" in sys.modules)
"""


def _run(prefix: str) -> str:
    code = prefix + f"ROOT = {ROOT!r}\nJAX_FREE = {JAX_FREE!r}\n" + WORKLOAD
    env = {k: v for k, v in os.environ.items() if k != "MIRA_FORCE_CPU"}
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=ROOT, env=env, timeout=600)
    assert res.returncode == 0, res.stderr[-4000:]
    return res.stdout


@pytest.mark.parametrize("blocked", [True, False], ids=["jax-blocked", "plain"])
def test_port_runs_without_jax(blocked):
    out = _run(BLOCKER if blocked else "")
    assert "JAX_LOADED False" in out


def _imported_modules(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
            if node.module == "mira_tpu":
                yield from (f"mira_tpu.{a.name}" for a in node.names)


def test_port_sources_import_no_jax():
    """Every import statement in the port and in chip_smoke.py, at any depth
    of the file, names neither jax nor a jax-bound mira_tpu module."""
    files = glob.glob(os.path.join(ROOT, "mira_tpu_torch", "**", "*.py"),
                      recursive=True) + [os.path.join(ROOT, "chip_smoke.py")]
    bad = []
    for path in files:
        for mod in _imported_modules(path):
            top = mod.split(".")[0]
            if top in ("jax", "jaxlib"):
                bad.append((path, mod))
            elif top == "mira_tpu" and mod != "mira_tpu" and not any(
                    mod[len("mira_tpu."):] == ok
                    or mod[len("mira_tpu."):].startswith(ok + ".")
                    for ok in JAX_FREE):
                bad.append((path, mod))
    assert len(files) > 20
    assert not bad, bad
