"""The batched Poseidon sponge on the card (csrc/poseidon.cu), the port of
mira_tpu/ops/pallas_poseidon.py `poseidon_hash_batch_pallas`.  Its plain
version is ops/poseidon_device.py `poseidon_hash_batch_plain`;
`poseidon_hash_batch` there dispatches here for CUDA tensors."""

from __future__ import annotations

from functools import lru_cache

import torch

from .. import _build
from ..fields.limbs import NUM_WORDS, limb_field
from .poseidon_device import IV, spec_constants

launches = 0  # sponge kernel launches (one per batch)
MAX_T = 5  # the kernel keeps the state in registers: built for t = 2..5


@lru_cache(maxsize=None)
def _constants(modulus: int, t: int, rate: int, r_f: int, r_p: int, device: str):
    """The kernel's constant table: one (count, 8) Montgomery tensor on the
    device, in the order csrc/poseidon.cu documents, the IV last."""
    c = spec_constants(modulus, t, rate, r_f, r_p)
    flat = []
    for key in ("start", "partial", "end", "mds", "pre", "rows", "cols"):
        part = c[key]
        flat += part if key == "partial" else [v for row in part for v in row]
    flat.append(IV)
    return limb_field(modulus).encode(flat, device).contiguous()


def poseidon_hash_batch_cuda(values: torch.Tensor, modulus: int, t: int = 3,
                             rate: int = 2, r_f: int = 10, r_p: int = 10):
    global launches
    field = _build.field_id(modulus)
    if (values.device.type != "cuda" or values.dtype != torch.int32
            or values.dim() != 3 or values.shape[2] != NUM_WORDS):
        raise ValueError("poseidon_hash_batch_cuda: expects an (N, L, 8) int32 "
                         "tensor on a CUDA device")
    if not 2 <= t <= MAX_T:
        raise ValueError(f"poseidon_hash_batch_cuda: t = {t} outside 2..{MAX_T}")
    if rate != t - 1 or r_f < 2 or r_f % 2 or r_p < 0:
        raise ValueError("poseidon_hash_batch_cuda: needs rate == t - 1, an "
                         "even r_f >= 2 and r_p >= 0")
    n, length = values.shape[0], values.shape[1]
    out = torch.empty(n, NUM_WORDS, dtype=torch.int32, device=values.device)
    if n == 0:
        return out
    consts = _constants(modulus, t, rate, r_f, r_p, str(values.device))
    values = values.contiguous()
    err = _build.lib().mira_poseidon(
        field, values.data_ptr(), out.data_ptr(), n, length, t, r_f, r_p,
        consts.data_ptr(), consts.shape[0], _build.stream_ptr(values.device))
    _build.check(err, "poseidon")
    launches += 1
    return out
