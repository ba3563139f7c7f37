"""Device-resident witnesses (port of mira_tpu/table/packed.py).

`DeviceWitness` keeps a Montgomery template of the advice table on the
device and carries only the witness tape's dynamic cell values per step,
which is what lets the commitment be a delta MSM over the write positions.
`pack_int_cols` builds the template's host image: one (num_cols * nrow, 16)
uint32 plane of plain 16-bit limbs, the tape VM's output format.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from ..fields.limbs import NUM_LIMBS
from ..utils.tracing import span


class DeviceWitness:
    """Witness held on the device end to end: the Montgomery template is
    built once per captured tape; per step only the dynamic cell values
    ((nwrites, 8) plain words) cross to the device."""

    __slots__ = ("lf", "cache_token", "template_mont", "template_vals_mont",
                 "positions", "positions_np", "vals", "num_cols", "nrow",
                 "_vals_mont", "_full")

    def __init__(self, lf, cache_token, template_mont, template_vals_mont,
                 positions, positions_np, vals, num_cols, nrow):
        self.lf = lf
        self.cache_token = cache_token
        self.template_mont = template_mont  # (num_cols*nrow, 8) Montgomery
        self.template_vals_mont = template_vals_mont  # (nwrites, 8) @ positions
        self.positions = positions  # (nwrites,) int64, device, sorted unique
        self.positions_np = positions_np  # same, host
        self.vals = vals  # (nwrites, 8) plain words, device (this step)
        self.num_cols = num_cols
        self.nrow = nrow
        self._vals_mont = None
        self._full = None

    def __len__(self):
        return self.num_cols

    @property
    def vals_mont(self) -> torch.Tensor:
        if self._vals_mont is None:
            with span("vals_to_mont"):
                self._vals_mont = self.lf.from_plain(self.vals)
        return self._vals_mont

    def delta_mont(self) -> torch.Tensor:
        """(nwrites, 8) Montgomery (value - template value) at positions."""
        return self.lf.sub(self.vals_mont, self.template_vals_mont)

    def encode_mont(self, lf, device=None) -> torch.Tensor:
        """Full table (num_cols*nrow, 8): one scatter into the template."""
        if self._full is None:
            with span("witness_scatter"):
                full = self.template_mont.clone()
                full[self.positions] = self.vals_mont
                self._full = full
        return self._full

    def to_int_cols(self) -> List[List[int]]:
        flat = self.lf.decode(self.encode_mont(self.lf))
        return [flat[c * self.nrow : (c + 1) * self.nrow]
                for c in range(self.num_cols)]


def _last_nonzero(col: List[int]) -> int:
    """Index after the last nonzero entry (coarse chunks scanned first)."""
    last = len(col)
    chunk = 4096
    while last > 0:
        lo = max(0, last - chunk)
        if any(col[lo:last]):
            for i in range(last - 1, lo - 1, -1):
                if col[i]:
                    return i + 1
        last = lo
    return 0


def pack_int_cols(cols: List[List[int]], nrow: int) -> np.ndarray:
    """Python-int columns -> (len(cols) * nrow, 16) uint32 plain 16-bit
    limbs, each column zero-padded to nrow (only nonzero prefixes are
    converted)."""
    from ..fields.limbs import int_list_words

    raw = np.zeros((len(cols) * nrow, NUM_LIMBS), dtype=np.uint32)
    for c, col in enumerate(cols):
        last = _last_nonzero(col)
        if last:
            raw[c * nrow : c * nrow + last] = int_list_words(col[:last]).view(
                "<u2").reshape(last, NUM_LIMBS)
    return raw
