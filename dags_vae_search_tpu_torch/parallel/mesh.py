"""A 1-D data-parallel group on ``torch.distributed`` (torch).

Counterpart of ``dags_vae_search_tpu/parallel/mesh.py``.  The JAX package
lays a 1-D ``data`` mesh over its chips and lets XLA insert the collectives.
Here every process (a rank) holds one device; a :class:`Mesh` names the
default process group, the rank, the world size and that device, and the
callers (``Trainer``, ``island_cem_search``) make the collectives
themselves: batches split over the ranks, parameters replicated, gradients
summed.

Backends (:func:`backend_for`): NCCL for CUDA devices, gloo for the CPU.
Neither stands in for the other silently: a CUDA mesh without NCCL raises.
gloo also moves CUDA tensors (through the host), which lets several ranks
share one card, which NCCL refuses; a caller asks for that explicitly by
initialising gloo and naming the device.

:func:`spawn` runs a function on ``world_size`` new processes that meet
through a ``file://`` store in a temporary directory, so no TCP port is
chosen and concurrent runs never collide.  Its ranks run on the cards
unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

import multiprocessing
import multiprocessing.connection
import os
import tempfile
import time
from typing import Any, Callable, List, NamedTuple, Optional

import numpy as np
import torch
import torch.distributed as dist


class Mesh(NamedTuple):
    """This rank's view of the data-parallel group."""

    group: Any  # the process group (the default one)
    rank: int
    world_size: int
    device: torch.device

    def local(self, size: int) -> slice:
        """This rank's contiguous block of ``size`` items split evenly."""
        if size % self.world_size:
            raise ValueError(f"{size} items do not split over {self.world_size} ranks")
        k = size // self.world_size
        return slice(self.rank * k, (self.rank + 1) * k)


def backend_for(device) -> str:
    """``"nccl"`` for a CUDA device (raises where this torch has no NCCL),
    ``"gloo"`` for the CPU."""
    device = torch.device(device)
    if device.type == "cuda":
        if not dist.is_nccl_available():
            raise RuntimeError("a CUDA mesh needs NCCL, which this torch build lacks")
        return "nccl"
    if device.type == "cpu":
        if not dist.is_gloo_available():
            raise RuntimeError("a CPU mesh needs gloo, which this torch build lacks")
        return "gloo"
    raise ValueError(f"no mesh backend for device {device}")


def make_mesh(num_devices: Optional[int] = None, device=None) -> Mesh:
    """The mesh of the default process group, which the caller (or
    :func:`spawn`) has initialised.  ``num_devices``, when given, must be
    the group's size.  ``device`` defaults to ``cuda:<rank % cards>`` on
    NCCL and to the CPU on gloo."""
    if not dist.is_initialized():
        raise RuntimeError("initialise the default process group first "
                           "(torch.distributed.init_process_group, or mesh.spawn)")
    rank, world = dist.get_rank(), dist.get_world_size()
    if num_devices is not None and num_devices != world:
        raise ValueError(f"num_devices={num_devices}, but the process group has {world} ranks")
    backend = dist.get_backend()
    if device is None:
        device = (torch.device("cuda", rank % torch.cuda.device_count()) if backend == "nccl"
                  else torch.device("cpu"))
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    if backend == "nccl" and device.type != "cuda":
        raise ValueError(f"NCCL moves CUDA tensors only, not {device}")
    return Mesh(dist.group.WORLD, rank, world, device)


def rank_seed(*keys: int) -> int:
    """A generator seed of its own for each tuple of keys, e.g. (seed,
    rank) or (seed, iteration, rank), the same on every machine."""
    return int(np.random.SeedSequence(list(keys)).generate_state(1, np.uint64)[0] >> 1)


def shard_batch(mesh: Mesh, *arrays):
    """This rank's contiguous slice of each array's leading (batch) axis,
    on the mesh's device; one array in, one tensor out."""
    out = tuple(torch.as_tensor(a[mesh.local(a.shape[0])]).to(mesh.device) for a in arrays)
    return out if len(out) > 1 else out[0]


def _map_leaves(fn, tree):
    if isinstance(tree, dict):
        return {k: _map_leaves(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_leaves(fn, v) for v in tree)
    return fn(tree)


def replicate_tree(mesh: Mesh, tree):
    """The tree's tensors on the mesh's device holding rank 0's values: each
    leaf is moved there (a tensor already there is overwritten in place)
    and broadcast from rank 0.  Lists, tuples and dicts keep their shape."""

    def replicate(leaf):
        t = torch.as_tensor(leaf).to(mesh.device)
        with torch.no_grad():
            dist.broadcast(t.detach(), src=0, group=mesh.group)
        return t

    return _map_leaves(replicate, tree)


def _rank_main(fn, rank, world_size, store_dir, device, backend, args) -> None:
    device = torch.device(device)
    if device.type == "cpu":  # the ranks share the host's cores
        torch.set_num_threads(max(1, torch.get_num_threads() // world_size))
    if device.type == "cuda":
        if device.index is None:
            device = torch.device("cuda", rank)
        torch.cuda.set_device(device)
    dist.init_process_group(backend or backend_for(device),
                            init_method=f"file://{os.path.join(store_dir, 'store')}",
                            rank=rank, world_size=world_size)
    try:
        result = fn(make_mesh(device=device), *args)
        torch.save(result, os.path.join(store_dir, f"result{rank}.pt"))
    finally:
        dist.destroy_process_group()


def spawn(fn: Callable, world_size: int, *args, device="cuda", backend: Optional[str] = None,
          timeout: float = 600.0) -> List[Any]:
    """``fn(mesh, *args)`` on ``world_size`` new processes; returns the
    ranks' results in rank order.

    ``device``: ``"cuda"`` (the default: rank r on ``cuda:r``), one card
    for every rank (``"cuda:0"``, with ``backend="gloo"``) or ``"cpu"``.
    ``backend`` defaults to :func:`backend_for` the device.  ``fn`` and ``args`` must
    pickle (a module-level function).  Raises when a rank fails or
    ``timeout`` seconds pass; every process has ended when it returns."""
    ctx = multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory() as store_dir:
        procs = [ctx.Process(target=_rank_main,
                             args=(fn, rank, world_size, store_dir, device, backend, args))
                 for rank in range(world_size)]
        try:
            for p in procs:
                p.start()
            deadline = time.monotonic() + timeout
            while True:
                codes = [p.exitcode for p in procs]
                failed = [(rank, c) for rank, c in enumerate(codes) if c not in (None, 0)]
                if failed:
                    # the other ranks may wait in a collective for it: end them
                    raise RuntimeError(f"spawn: rank {failed[0][0]} exited {failed[0][1]}")
                if all(c == 0 for c in codes):
                    break
                if time.monotonic() > deadline:
                    raise TimeoutError(f"spawn: ranks still running after {timeout:.0f} s")
                running = [p.sentinel for p, c in zip(procs, codes) if c is None]
                multiprocessing.connection.wait(running, timeout=0.5)
        finally:
            for p in procs:
                if p.pid is None:  # never started
                    continue
                if p.is_alive():
                    p.kill()
                p.join()
        return [torch.load(os.path.join(store_dir, f"result{rank}.pt"), weights_only=False)
                for rank in range(world_size)]
