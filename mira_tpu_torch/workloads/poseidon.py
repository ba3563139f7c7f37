"""The bench's IVC workload on the port: a Poseidon step circuit on BN254
paired with a trivial circuit on Grumpkin.  The step circuits and curves are
mira_tpu's own (they hold no jax code); the folding stack that runs them is
the port's (ivc/ivc.py, ivc/public_params.py)."""

from mira_tpu.curves.host import BN254_G1, GRUMPKIN
from mira_tpu.ivc.step_circuit import TrivialCircuit
from mira_tpu.workloads.poseidon import PoseidonStepCircuit

__all__ = ["BN254_G1", "GRUMPKIN", "PoseidonStepCircuit", "TrivialCircuit"]
