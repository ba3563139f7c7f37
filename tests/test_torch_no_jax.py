"""The port imports neither jax nor mira_tpu: every mira_tpu_torch module
imports, and a tiny SPS trace + commitment + is_sat + fold evaluation, a
commitment through a multiples table, a Groth16 prove/verify, a NIFS fold
step (and, on a mesh of one, a sharded commit and fold step), an IVC
checkpoint saved and resumed and a KZG commitment and opening run, in a
process where importing jax or mira_tpu raises, and in a plain
process both stay unloaded; and no import statement in the port's sources or
in chip_smoke.py, inside functions included, names jax or mira_tpu."""

import ast
import glob
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

BLOCKER = """
import sys
class _Blocked:
    def find_spec(self, name, path=None, target=None):
        if name.split('.')[0] in ('jax', 'jaxlib', 'mira_tpu'):
            raise ImportError('blocked in this process: ' + name)
sys.meta_path.insert(0, _Blocked())
"""

WORKLOAD = """
import importlib, pkgutil, sys
sys.path.insert(0, ROOT)
import mira_tpu_torch
for m in pkgutil.walk_packages(mira_tpu_torch.__path__, 'mira_tpu_torch.'):
    importlib.import_module(m.name)

from mira_tpu_torch.curves.host import BN254_G1, AffinePoint
from mira_tpu_torch.fields.params import BN254_FQ
from mira_tpu_torch.nifs.vanilla import VanillaFS
from mira_tpu_torch.ops.commitment import CommitmentKey
from mira_tpu_torch.ops.poseidon import create_ro
from mira_tpu_torch.table.runner import CircuitRunner


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
ck = CommitmentKey.setup(BN254_G1, 5, b"no-jax", device="cpu")
trace = S.run_sps_protocol(ck, [], runner.collect_witness(), create_ro(BN254_FQ))
S.is_sat(ck, create_ro(BN254_FQ), trace.u, trace.w)
out = S.fold_evaluator("cpu").fold_eval_multi(trace.w.W, trace.w.W, [0, 1, 2],
                                              [1], [1])
assert out.shape == (3, 8, 8)
assert not trace.u.W_commitments[0].is_inf

# a NIFS fold step: the trace folded into itself, relaxed
pp, vp = VanillaFS.setup_params(AffinePoint.generator(BN254_G1), S)
acc = trace.to_relax(S.k)
folded, proof = VanillaFS.prove(ck, pp, create_ro(BN254_FQ), acc, trace)
S.is_sat_relaxed(ck, folded.U, folded.W)
assert VanillaFS.verify(vp, create_ro(BN254_FQ), create_ro(BN254_FQ), acc.U,
                        trace.u, proof) == folded.U

# a recurring width through its multiples table, and a Groth16 proof
import random
from mira_tpu_torch.fields.limbs import limb_field
from mira_tpu_torch.snark import groth16

v = limb_field(BN254_G1.scalar_modulus).encode(list(range(256)))
ck8 = CommitmentKey.setup(BN254_G1, 8, b"no-jax", device="cpu")
assert ck8.commit_device_many([v, v]) == [ck8.commit_device(v)] * 2
assert set(ck8._fb_tables) == {256}
# a sharded commit and a mesh fold step on a group of one (parallel/)
from mira_tpu_torch.parallel.mesh import make_mesh

mesh = make_mesh(1, "cpu")
assert ck8.commit_device(v, mesh=mesh) == ck8.commit_device(v)
folded_m, _ = VanillaFS.prove(ck, pp, create_ro(BN254_FQ), acc, trace, mesh=mesh)
assert folded_m.U == folded.U
mesh.close()
r1cs, z = groth16.benchmark_r1cs(4)
pk = groth16.setup(r1cs, random.Random(0))
assert groth16.verify(pk.vk, groth16.prove(pk, r1cs, z, random.Random(1)), z[1:3])

# an IVC checkpoint of the folded state saved and resumed (ivc/checkpoint.py)
import os, tempfile
from types import SimpleNamespace as ns
from mira_tpu_torch.ivc import checkpoint
from mira_tpu_torch.ivc.ivc import IVC
from mira_tpu_torch.ops.poseidon import get_spec

side = ns(S=S, ck=ck, params=ns(ro_spec=get_spec(BN254_FQ, 5, 4, 10, 10)))
g = AffinePoint.generator(BN254_G1)
pp_ns = ns(primary_curve=BN254_G1, secondary_curve=BN254_G1, primary=side,
           secondary=side, digest_1=g, digest_2=g, tapes={})
state = ns(pp=pp_ns, step=2, primary=ns(relaxed_trace=folded, z_0=[1], z_i=[2]),
           secondary=ns(relaxed_trace=acc, z_0=[3], z_i=[4]), secondary_trace=trace)
with tempfile.TemporaryDirectory() as d:
    checkpoint.save(state, os.path.join(d, "c.npz"))
    back = IVC.resume(pp_ns, None, None, os.path.join(d, "c.npz"))
assert back.step == 2 and back.primary.relaxed_trace.U == folded.U
assert back.secondary_trace.u == trace.u

# a KZG commitment, opening and pairing check (pcs/kzg.py)
from mira_tpu_torch.pcs import kzg

srs = kzg.KzgSrs.setup(4)
assert kzg.kzg_verify(srs, kzg.kzg_commit(srs, [1, 2, 3]), 5,
                      *kzg.kzg_open(srs, [1, 2, 3], 5))
print("JAX_LOADED", "jax" in sys.modules)
print("MIRA_LOADED", "mira_tpu" in sys.modules)
"""


def _run(prefix: str) -> str:
    code = prefix + f"ROOT = {ROOT!r}\n" + WORKLOAD
    env = {k: v for k, v in os.environ.items() if k != "MIRA_FORCE_CPU"}
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=ROOT, env=env, timeout=600)
    assert res.returncode == 0, res.stderr[-4000:]
    return res.stdout


@pytest.mark.parametrize("blocked", [True, False], ids=["jax-blocked", "plain"])
def test_port_runs_without_jax(blocked):
    out = _run(BLOCKER if blocked else "")
    assert "JAX_LOADED False" in out
    assert "MIRA_LOADED False" in out


def _imported_modules(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_sources_import_no_jax():
    """Every import statement in the port and in chip_smoke.py, at any depth
    of the file, names neither jax nor mira_tpu (mira_tpu_torch is the port
    itself)."""
    files = glob.glob(os.path.join(ROOT, "mira_tpu_torch", "**", "*.py"),
                      recursive=True) + [os.path.join(ROOT, "chip_smoke.py")]
    bad = [(path, mod) for path in files for mod in _imported_modules(path)
           if mod.split(".")[0] in ("jax", "jaxlib", "mira_tpu")]
    assert len(files) > 40
    assert not bad, bad
