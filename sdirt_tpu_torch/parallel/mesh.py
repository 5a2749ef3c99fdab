"""The process grid of the port's multi-GPU paths (PyTorch counterpart of
sdirt_tpu/parallel/mesh.py).

Ranks lie on a ('data', 'rays') grid, rank = data_index * n_rays +
rays_index (the order of the JAX mesh's devices):

  * 'data': batch and field-point parallelism. Each rank takes its slice
    of a host batch (``shard_batch``); gradients are averaged over the
    ranks of its data group.
  * 'rays': the Monte-Carlo rays of a PSF bundle split over the ranks of a
    rays group; their splat grids are summed there (dp/psf.py).

One process per rank: ``launch`` spawns them (the ``spawn`` start method),
each with ``torch.distributed`` initialised through a ``file://`` rendezvous
in a temporary directory, and joins them within a time limit. A group of one
rank is ``None``: its collectives are skipped. Backends: ``nccl`` with one
card per rank, ``gloo`` on the CPU (and for two ranks on one card, which
NCCL refuses).
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import queue as queue_mod
import tempfile
import time
import traceback
import warnings

import torch
import torch.distributed as dist


# the longest a rank waits in one collective (rank 0 validating while the
# others wait at a barrier included)
COLLECTIVE_TIMEOUT_S = 1800.0


@dataclasses.dataclass(frozen=True)
class Mesh:
    n_data: int
    n_rays: int
    rank: int = 0
    data_group: object = None
    rays_group: object = None

    @property
    def data_index(self) -> int:
        return self.rank // self.n_rays


def make_mesh(n_data: int, n_rays: int = 1) -> Mesh:
    """The ('data', 'rays') grid over the initialised process group (or the
    one process when none is); n_data * n_rays must be its world size.
    Every rank must call it: each creates every group, in one order."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    if n_data < 1 or n_rays < 1 or n_data * n_rays != world:
        raise ValueError(f"mesh ({n_data}, {n_rays}) does not cover a world of "
                         f"{world} rank(s)")
    if world == 1:
        return Mesh(1, 1)
    rank = dist.get_rank()
    data_group = rays_group = None
    for r in range(n_rays):
        ranks = [d * n_rays + r for d in range(n_data)]
        group = dist.new_group(ranks) if n_data > 1 else None
        if rank in ranks:
            data_group = group
    for d in range(n_data):
        ranks = [d * n_rays + r for r in range(n_rays)]
        group = dist.new_group(ranks) if n_rays > 1 else None
        if rank in ranks:
            rays_group = group
    return Mesh(n_data, n_rays, rank, data_group, rays_group)


def shard_batch(batch, mesh: Mesh):
    """This rank's slice of a host batch along the leading axis (its data
    index of n_data equal slices); lists and tuples slice item by item and
    None stays None."""
    if batch is None:
        return None
    if isinstance(batch, (list, tuple)):
        return type(batch)(shard_batch(b, mesh) for b in batch)
    n = batch.shape[0]
    if n % mesh.n_data:
        raise ValueError(f"a batch of {n} does not split over {mesh.n_data} data ranks")
    per = n // mesh.n_data
    return batch[mesh.data_index * per:(mesh.data_index + 1) * per]


def group_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def all_reduce_mean(t, group):
    """The mean of ``t`` over the group (a new tensor; ``t`` when the group
    is None)."""
    if group is None:
        return t
    out = t.clone()
    dist.all_reduce(out, group=group)
    return out / group_size(group)


def all_reduce_autograd(t, group):
    """The sum of ``t`` over the group, with autograd: the backward sums the
    group's gradients (torch.distributed.nn.functional.all_reduce, whose
    deprecation warning is silenced here)."""
    from torch.distributed.nn.functional import all_reduce

    with warnings.catch_warnings():
        warnings.simplefilter("ignore", FutureWarning)
        return all_reduce(t, group=group)


def average_gradients(params, group) -> None:
    """Replace every parameter's gradient by its mean over the group (one
    all_reduce of the gradients packed into one buffer)."""
    if group is None:
        return
    grads = [p.grad for p in params if p.grad is not None]
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat, group=group)
    flat /= group_size(group)
    offset = 0
    for g in grads:
        g.copy_(flat[offset:offset + g.numel()].view_as(g))
        offset += g.numel()


def broadcast_module(module: torch.nn.Module, src: int = 0) -> None:
    """Copy rank ``src``'s parameters and buffers to every rank."""
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return
    with torch.no_grad():
        for t in list(module.parameters()) + list(module.buffers()):
            dist.broadcast(t.data, src)


def rank_device(device: str, rank: int) -> torch.device:
    """``cuda``: one card per rank (cuda:<rank>); ``cuda:<i>``: every rank
    on that card; ``cpu``."""
    if device == "cuda":
        return torch.device("cuda", rank)
    return torch.device(device)


def _rank_main(fn, rank, world, backend, device, init, args, timeout, results):
    try:
        dev = rank_device(device, rank)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        else:
            torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
        # a collective that waits longer than this fails instead of hanging
        dist.init_process_group(backend, init_method=init, world_size=world,
                                rank=rank, timeout=datetime.timedelta(
                                    seconds=min(timeout, COLLECTIVE_TIMEOUT_S)))
        out = fn(rank, world, dev, *args)
        dist.barrier()
        dist.destroy_process_group()
        results.put((rank, True, out))
    except Exception:  # noqa: BLE001 - reported to the parent, which raises
        results.put((rank, False, traceback.format_exc()))


def launch(fn, world_size: int, backend: str | None = None, device: str = "cpu",
           args=(), timeout: float = 600.0) -> list:
    """Run ``fn(rank, world_size, device, *args)`` in ``world_size``
    processes with torch.distributed initialised, and return their results
    in rank order (each must pickle: plain numbers, lists, numpy arrays).

    backend: ``nccl`` for ``device="cuda"`` (one card per rank), else
    ``gloo``, unless given. Raises RuntimeError with the rank's traceback
    when a rank fails or dies, and TimeoutError when they have not all
    returned within ``timeout`` seconds; every process is ended before it
    returns or raises."""
    import torch.multiprocessing as mp

    if backend is None:
        backend = "nccl" if device == "cuda" else "gloo"
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    done, failed = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        init = "file://" + os.path.join(tmp, "rendezvous")
        procs = [ctx.Process(target=_rank_main, args=(
            fn, rank, world_size, backend, device, init, args, timeout, results))
            for rank in range(world_size)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        try:
            while len(done) < world_size and not failed:
                left = deadline - time.monotonic()
                if left <= 0:
                    raise TimeoutError(f"{world_size - len(done)} rank(s) still "
                                       f"running after {timeout:.0f} s")
                try:
                    rank, ok, out = results.get(timeout=min(left, 1.0))
                except queue_mod.Empty:
                    dead = [r for r, p in enumerate(procs) if r not in done
                            and p.exitcode is not None]
                    if dead:
                        raise RuntimeError(f"rank {dead[0]} exited with code "
                                           f"{procs[dead[0]].exitcode} without a result")
                    continue
                (done if ok else failed)[rank] = out
            if failed:
                rank = min(failed)
                raise RuntimeError(f"rank {rank} of {world_size} failed:\n{failed[rank]}")
        finally:
            for p in procs:
                p.join(timeout=10.0 if len(done) == world_size else 0.1)
                if p.is_alive():
                    p.kill()
                    p.join()
    return [done[r] for r in range(world_size)]
