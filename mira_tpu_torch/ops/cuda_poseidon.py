"""The batched Poseidon sponge on the card (csrc/poseidon.cu), the port of
mira_tpu/ops/pallas_poseidon.py `poseidon_hash_batch_pallas`.  Its plain
version is ops/poseidon_device.py `poseidon_hash_batch_plain`;
`poseidon_hash_batch` there dispatches here for CUDA tensors.

The kernel has two routes, a thread per hash and a hash on the lanes of a
warp; `poseidon_route` picks one from the batch size, the state width and
the card's SM count, and both compute the same outputs."""

from __future__ import annotations

from functools import lru_cache

import torch

from .. import _build
from ..fields.limbs import NUM_WORDS, limb_field
from ..utils import tracing
from .poseidon_device import IV, spec_constants

MAX_T = 5  # the kernel keeps the state in registers: built for t = 2..5
ROUTES = ("thread", "lanes")  # csrc/poseidon.cu's `route` 0 and 1
# The lane route takes a batch whose lanes fill at most two warps on each of
# an SM's four sub-partitions; there a batch runs in one hash's latency, on
# the lane route about half the thread route's.  Past it the lane route's
# extra products cost more than they save.  The limit is the rate at which
# an SM starts instructions, not its occupancy: on an H100 (132 SMs) the thread route leaves one
# hash's latency from 2^15 hashes (248 threads an SM, of the 640 it holds)
# and the lane route from 2^14 (496 lanes, of 896), by chip_smoke.py's
# Poseidon levels.
LANE_THREADS_PER_SM = 256


def lanes_per_hash(t: int) -> int:
    """The lane route's lanes per hash: t rounded up to a power of two."""
    return 1 << (t - 1).bit_length()


def poseidon_route(n: int, t: int, sms: int) -> str:
    """The route for a batch of n hashes of width t on a card of `sms` SMs."""
    return "lanes" if n * lanes_per_hash(t) <= LANE_THREADS_PER_SM * sms else "thread"


@lru_cache(maxsize=None)
def card_sms(device: str) -> int:
    """The card's SM count (queried once)."""
    return torch.cuda.get_device_properties(torch.device(device)).multi_processor_count


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
    """N hashes on the route `poseidon_route` picks."""
    _check(values, t, rate, r_f, r_p)
    route = poseidon_route(values.shape[0], t, card_sms(str(values.device)))
    return _launch(values, modulus, t, rate, r_f, r_p, route)


def _check(values: torch.Tensor, t: int, rate: int, r_f: int, r_p: int):
    if (values.device.type != "cuda" or values.dtype != torch.int32
            or values.dim() != 3 or values.shape[2] != NUM_WORDS):
        raise ValueError("poseidon_hash_batch_cuda: expects an (N, L, 8) int32 "
                         "tensor on a CUDA device")
    if not 2 <= t <= MAX_T:
        raise ValueError(f"poseidon_hash_batch_cuda: t = {t} outside 2..{MAX_T}")
    if rate != t - 1 or r_f < 2 or r_f % 2 or r_p < 0:
        raise ValueError("poseidon_hash_batch_cuda: needs rate == t - 1, an "
                         "even r_f >= 2 and r_p >= 0")


def _launch(values: torch.Tensor, modulus: int, t: int, rate: int, r_f: int,
            r_p: int, route: str):
    """One launch of the sponge kernel on `route` ("thread" or "lanes")."""
    field = _build.field_id(modulus)
    _check(values, t, rate, r_f, r_p)
    n, length = values.shape[0], values.shape[1]
    out = torch.empty(n, NUM_WORDS, dtype=torch.int32, device=values.device)
    if n == 0:
        return out
    consts = _constants(modulus, t, rate, r_f, r_p, str(values.device))
    values = values.contiguous()
    err = _build.lib().mira_poseidon(
        field, values.data_ptr(), out.data_ptr(), n, length, t, r_f, r_p,
        consts.data_ptr(), consts.shape[0], ROUTES.index(route),
        _build.stream_ptr(values.device))
    _build.check(err, "poseidon")
    tracing.count("poseidon")
    return out
