"""Shared helpers of the port's tests (tests/test_torch_*.py).

Importing this module also sizes torch's intra-op thread pool: under
pytest-xdist every worker would otherwise start one thread per core, and
several workers on one machine then oversubscribe the cores many times over.
"""

import os

import pytest
import torch

_workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
if _workers > 1:
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // _workers))


def relaxed_trace_to_mira(t):
    """Port RelaxedPlonkTrace -> mira_tpu's (loads jax, so it lives here and
    not in the port)."""
    import dataclasses

    import jax.numpy as jnp

    from mira_tpu.fields.limbs import limb_field as jax_limb_field
    from mira_tpu.plonk import structure as ms
    from mira_tpu_torch.convert import words_to_limbs16

    lf = jax_limb_field(t.W.lf.modulus)
    W = ms.RelaxedPlonkWitness(
        lf, [jnp.asarray(words_to_limbs16(x)) for x in t.W.W],
        jnp.asarray(words_to_limbs16(t.W.E)))
    U = ms.RelaxedPlonkInstance(**{
        f.name: getattr(t.U, f.name)
        for f in dataclasses.fields(ms.RelaxedPlonkInstance)})
    return ms.RelaxedPlonkTrace(U, W)


@pytest.fixture
def cuda_device():
    """The first CUDA device; skips the test where there is none.  Decided
    when the test runs, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda", 0)
