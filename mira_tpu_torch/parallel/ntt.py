"""Multi-device NTT (port of mira_tpu/parallel/ntt.py): the four-step
decomposition n = n1 * n2 with the rows split across the mesh, batched local
transforms, a twiddle scaling and two all_to_all transposes.

With i = i2*n1 + i1 and k = k1*n2 + k2,

  X[k1*n2 + k2] = DFT_{n1,i1}( w_n^(i1*k2) * DFT_{n2,i2}(x[i2*n1 + i1])[k2] )[k1].

Each rank starts from its block of n2/world rows i2 of the (n2, n1) view,
swaps column blocks with every other rank (all_to_all) so that it holds all
i2 for its block of i1, transforms those n1/world columns of length n2 as one
batch (ops/ntt.py `ntt` on a (B, n2, 8) batch: one launch of kernel 8 or
the launches of kernel 9), scales by w_n^(i1*k2), swaps again so that it
holds all i1 for its block of k2, and transforms those as a second batch.
The inverse runs both batches inverse, whose divisors 1/n2 and 1/n1 make
the 1/n.  SPMD as the rest of parallel/: the input is whole on every rank,
and the result is gathered whole on every rank.
"""

from __future__ import annotations

from functools import lru_cache

import torch
import torch.distributed as dist

from ..fields.limbs import NUM_WORDS, limb_field
from ..ops.ntt import _log2, get_omega, ntt, power_table


@lru_cache(maxsize=None)
def _powers(modulus: int, log_n: int, inverse: bool, device: str) -> torch.Tensor:
    """w^0 .. w^(n-1) of the size-2^log_n domain's root (inverse root)."""
    return power_table(modulus, get_omega(modulus, log_n, inverse), 1 << log_n,
                       device)


def _all_to_all(send: torch.Tensor, mesh) -> torch.Tensor:
    """send[j] goes to rank j; returns recv with recv[j] from rank j."""
    if mesh.size == 1:
        return send
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=mesh.group)
    return recv


def distributed_ntt(a: torch.Tensor, modulus: int, mesh, inverse: bool = False):
    """NTT of an (n, 8) Montgomery word tensor across the mesh; natural
    order in and out, the inverse with its 1/n.  Both factors n1 = 2^(log n
    // 2) and n2 = n / n1 must be multiples of the mesh size."""
    if a.dim() != 2 or a.shape[1] != NUM_WORDS:
        raise ValueError("distributed_ntt: expects an (n, 8) word tensor")
    n = a.shape[0]
    log_n = _log2(n)
    log_n1 = log_n // 2
    n1, n2 = 1 << log_n1, 1 << (log_n - log_n1)
    W, r = mesh.size, mesh.rank
    if n1 % W or n2 % W:
        raise ValueError(f"distributed_ntt: a mesh of {W} must divide both "
                         f"factors {n1} and {n2} of {n}")
    b1, b2 = n1 // W, n2 // W
    lf = limb_field(modulus)
    dev = a.device
    # transpose 1: this rank's rows i2, cut into column blocks, one per rank
    x_block = a.reshape(n2, n1, NUM_WORDS)[r * b2 : (r + 1) * b2]
    send = x_block.reshape(b2, W, b1, NUM_WORDS).transpose(0, 1).contiguous()
    cols = _all_to_all(send, mesh).reshape(n2, b1, NUM_WORDS)  # all i2, i1 block
    inner = ntt(cols.transpose(0, 1).contiguous(), modulus, inverse)  # (b1, n2)
    # twiddles w_n^(i1*k2) of this rank's i1 block
    i1 = torch.arange(r * b1, (r + 1) * b1, device=dev)
    k2 = torch.arange(n2, device=dev)
    tw = _powers(modulus, log_n, inverse, str(dev))[(i1[:, None] * k2[None]) % n]
    scaled = lf.mul(inner, tw)
    # transpose 2: cut the k2 axis into blocks, one per rank
    send = scaled.reshape(b1, W, b2, NUM_WORDS).transpose(0, 1).contiguous()
    rows = _all_to_all(send, mesh).reshape(n1, b2, NUM_WORDS)  # all i1, k2 block
    outer = ntt(rows.transpose(0, 1).contiguous(), modulus, inverse)  # (b2, n1)
    full = mesh.gather_rows(outer, n2)  # (n2, n1): full[k2, k1] = X[k1*n2 + k2]
    return full.transpose(0, 1).reshape(n, NUM_WORDS)
