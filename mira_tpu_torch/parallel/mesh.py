"""The device mesh of the multi-device fold (port of
mira_tpu/parallel/mesh.py), as SPMD on torch.distributed.

mira_tpu shards arrays over a `jax.sharding.Mesh` and lets shard_map or GSPMD
insert the collectives.  Here every rank runs the same program on the same
replicated inputs (the same seeds, transcript and structural-mode random
draws); each rank works on its block of rows or points only, and
`all_gather` makes the result whole again on every rank.  A `Mesh` stands in
for the reference's `mesh.devices.size` and `NamedSharding`: the world's
size, this rank, its device and the process group.

`make_mesh` joins the process group this process already belongs to, or
makes a group of one in the calling process (a one-card run), which
`Mesh.close` (or leaving a `with make_mesh(...) as mesh:` block) takes down
again.  `run_spmd`
starts a group of several ranks with torch.multiprocessing: gloo on the
CPU, NCCL on CUDA (rank r on cuda:r), meeting through a FileStore in a
temporary directory, so no network address is needed.
"""

from __future__ import annotations

import dataclasses
import os
import pickle
import shutil
import tempfile
from typing import Callable, Optional

import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class Mesh:
    size: int
    rank: int
    device: torch.device
    group: object = None  # None: the default (world) group
    # undoes what make_mesh set up for this mesh; None when it joined a group
    _teardown: Optional[Callable[[], None]] = dataclasses.field(
        default=None, compare=False, repr=False)

    def close(self):
        """Destroy the group of one that make_mesh started for this mesh,
        remove its store and restore the environment; a mesh that joined an
        existing group leaves it alone."""
        if self._teardown is not None:
            self._teardown()

    def __enter__(self) -> "Mesh":
        return self

    def __exit__(self, *exc):
        self.close()

    def rows(self, n: int):
        """This rank's block [lo, hi) of n rows or points; the whole range
        when n does not divide evenly (then every rank computes all of it,
        as mira_tpu leaves such an array replicated)."""
        if n % self.size:
            return 0, n
        m = n // self.size
        return self.rank * m, (self.rank + 1) * m

    def gather_rows(self, block: torch.Tensor, n: int) -> torch.Tensor:
        """The whole (n, ...) array from every rank's block (`rows(n)`):
        one all_gather, or the block itself when it already is the whole."""
        if n % self.size or self.size == 1:
            return block
        parts = [torch.empty_like(block) for _ in range(self.size)]
        dist.all_gather(parts, block.contiguous(), group=self.group)
        return torch.cat(parts)

    def rowwise(self, fn, *arrays):
        """fn over this rank's block of the arrays' rows, gathered: equal
        to fn(*arrays) for any fn that works row by row."""
        n = arrays[0].shape[0]
        lo, hi = self.rows(n)
        return self.gather_rows(fn(*(a[lo:hi] for a in arrays)), n)

    def all_gather_object(self, obj) -> list:
        out = [None] * self.size
        dist.all_gather_object(out, obj, group=self.group)
        return out


def _backend(device: torch.device) -> str:
    return "nccl" if device.type == "cuda" else "gloo"


def _init(device: torch.device, store_path: str, world: int, rank: int):
    """Join the group; returns the socket variable it set and that
    variable's earlier value (None where it had none)."""
    # every rank of a group is on this host: they meet over the loopback
    # interface only
    var = "GLOO_SOCKET_IFNAME" if device.type == "cpu" else "NCCL_SOCKET_IFNAME"
    old = os.environ.get(var)
    os.environ.setdefault(var, "lo")
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(_backend(device),
                            store=dist.FileStore(store_path, world),
                            rank=rank, world_size=world)
    return var, old


def make_mesh(n_devices: int | None = None, device="cuda") -> Mesh:
    """The mesh of this process's group, started as a group of one in the
    calling process when none exists.  `n_devices`, where given, must be the
    group's size (a group of several ranks is started by `run_spmd`).
    Close the mesh when done with it (`Mesh.close`, or a `with` block)."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    teardown = None
    if not dist.is_initialized():
        if n_devices not in (None, 1):
            raise ValueError(f"make_mesh({n_devices}): a group of several ranks "
                             "is started by run_spmd")
        tmp = tempfile.mkdtemp()
        var, old = _init(device, os.path.join(tmp, "store"), 1, 0)

        def teardown():
            if dist.is_initialized():
                dist.destroy_process_group()
            shutil.rmtree(tmp, ignore_errors=True)
            if old is None:
                os.environ.pop(var, None)
            else:
                os.environ[var] = old
    size = dist.get_world_size()
    if n_devices is not None and n_devices != size:
        raise ValueError(f"make_mesh({n_devices}): this process's group has "
                         f"{size} ranks")
    return Mesh(size, dist.get_rank(), device, _teardown=teardown)


def _rank_main(rank, world, device, store_path, out_dir, fn, args):
    dev = torch.device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", rank)
    else:
        torch.set_num_threads(1)  # the ranks are the parallelism
    _init(dev, store_path, world, rank)
    try:
        out = fn(Mesh(world, rank, dev), *args)
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
    finally:
        dist.destroy_process_group()


def run_spmd(fn, world: int, device, *args):
    """Run fn(mesh, *args) on `world` new processes, one rank each, and
    return rank 0's result (which must pickle).  fn must be importable by the
    children: a module-level function of this package."""
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory() as tmp:
        mp.spawn(_rank_main, nprocs=world, join=True,
                 args=(world, str(device), os.path.join(tmp, "store"), tmp, fn,
                       args))
        with open(os.path.join(tmp, "rank0.pkl"), "rb") as f:
            return pickle.load(f)
