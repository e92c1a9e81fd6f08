"""Process groups (the port's counterpart of ``irw_tpu/parallel/mesh.py``).

JAX runs one program over a ``Mesh`` of devices and places each array with a
``NamedSharding``: ``P("data")`` splits its leading axis into contiguous
blocks, one a device, and ``P()`` replicates it.  The port runs one process a
rank, each on its own card (or on the CPU with ``gloo``), under a
``torch.distributed`` process group:

- ``init_group`` joins the group that ``python -m torch.distributed.run``
  describes in the environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
  ``MASTER_ADDR``/``MASTER_PORT``), or one given by ``init_method`` (a
  ``file://`` rendezvous, as the tests use);
- ``local_rows`` is the block of a global batch that ``P("data")`` gives a
  rank; ``replicate`` broadcasts a module's parameters and buffers from rank
  0 (``device_put(variables, replicated(mesh))``); ``all_gather_rows``
  gathers the ranks' rows in rank order;
- ``agreed`` runs a step that may run out of device memory and makes every
  rank raise if any did, so no rank waits in a collective that another
  left.  Whatever a rank allocates on the card between two collectives runs
  inside one ``agreed`` step.

``NamedSharding`` itself has no counterpart: a tensor lives on one device,
so a sharded array is each rank's block and the collectives that join them.
Without a group (or with a group of one rank) every helper is the identity.
Nothing here runs at import time.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist


def init_group(backend: str | None = None, init_method: str | None = None,
               world_size: int | None = None, rank: int | None = None) -> int:
    """Join the process group (once); returns this process's rank.

    ``world_size`` and ``rank`` default to ``WORLD_SIZE`` and ``RANK``;
    ``init_method`` to ``env://`` (``MASTER_ADDR``/``MASTER_PORT``).  The
    backend is ``nccl`` where a card is available, else ``gloo``; give
    ``backend="gloo"`` for ranks that share one card, which NCCL refuses."""
    if dist.is_initialized():
        return dist.get_rank()
    world_size = int(os.environ["WORLD_SIZE"]) if world_size is None else world_size
    rank = int(os.environ["RANK"]) if rank is None else rank
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if backend == "nccl":  # NCCL binds a rank to the current device
        torch.cuda.set_device(local_rank(rank))
    dist.init_process_group(backend, init_method=init_method or "env://",
                            world_size=world_size, rank=rank)
    return rank


def close_group() -> None:
    if dist.is_initialized():
        dist.destroy_process_group()


def world_size() -> int:
    """Ranks in the group; 1 without one."""
    return dist.get_world_size() if dist.is_initialized() else 1


def rank() -> int:
    """This process's rank; 0 without a group."""
    return dist.get_rank() if dist.is_initialized() else 0


def local_rank(default: int | None = None) -> int:
    """The rank on this host (``LOCAL_RANK``, else the global rank): the card
    a rank takes when it is given none."""
    value = os.environ.get("LOCAL_RANK")
    if value is not None:
        return int(value)
    return rank() if default is None else default


def pad_to_multiple(array, multiple: int, axis: int = 0):
    """Pad ``axis`` with zeros to a multiple; returns (padded, n_real)."""
    n = array.shape[axis]
    pad = (-n) % multiple
    if pad == 0:
        return array, n
    widths = [(0, 0)] * np.ndim(array)
    widths[axis] = (0, pad)
    return np.pad(np.asarray(array), widths), n


def local_rows(n: int, rank: int, world: int) -> slice:
    """The rows of an ``n``-row batch that rank ``rank`` of ``world`` holds:
    the contiguous block ``P("data")`` gives it (``n`` a multiple of
    ``world``)."""
    if n % world:
        raise ValueError(f"{n} rows do not split evenly over {world} ranks")
    per = n // world
    return slice(rank * per, (rank + 1) * per)


def _through_host(t: torch.Tensor) -> bool:
    """gloo does not run every collective on CUDA tensors: they go through
    host copies."""
    return t.is_cuda and dist.get_backend() == "gloo"


def _collective_device() -> torch.device:
    """Where a collective's own small tensors live: NCCL takes CUDA tensors
    only (on the rank's current card), gloo host ones."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def _gather_buffers(t: torch.Tensor, host: bool):
    src = t.detach().contiguous()
    if host:
        src = src.cpu()
    return src, src.new_empty((world_size(),) + tuple(src.shape))


def all_gather_rows(t: torch.Tensor) -> torch.Tensor:
    """Every rank's ``t`` (one shape on every rank) concatenated along its
    first axis in rank order.  The buffers are allocated, and a gloo
    gather's host copy moved back to the card, each inside ``agreed``."""
    if world_size() == 1:
        return t
    host = _through_host(t)
    src, out = agreed(_gather_buffers, t, host)
    dist.all_gather(list(out.unbind(0)), src)
    out = out.flatten(0, 1)
    return agreed(out.to, t.device) if host else out


def replicate(module: torch.nn.Module) -> torch.nn.Module:
    """``module``'s parameters and buffers made rank 0's on every rank (one
    broadcast a dtype); returns the module."""
    if world_size() == 1:
        return module
    tensors = [t for t in list(module.parameters()) + list(module.buffers()) if t.numel()]
    by_dtype: dict = {}
    for t in tensors:
        by_dtype.setdefault((t.dtype, t.device), []).append(t)
    with torch.no_grad():
        for group in by_dtype.values():
            flat = agreed(lambda: torch.cat([t.detach().reshape(-1) for t in group]))
            host = _through_host(flat)
            buf = flat.cpu() if host else flat
            dist.broadcast(buf, src=0)
            if host:
                buf = agreed(buf.to, flat.device)
            offset = 0
            for t in group:
                t.copy_(buf[offset:offset + t.numel()].view_as(t))
                offset += t.numel()
    return module


def agreed(fn, *args, **kwargs):
    """``fn(*args, **kwargs)``, with every rank told whether any rank failed
    in it.  Where one ran out of device memory, each raises
    ``torch.OutOfMemoryError``, so all retry or none does; where one raised
    anything else, it re-raises its error and the others raise a
    ``RuntimeError``, so no rank is left waiting in the next collective.
    Without a group it is the plain call."""
    if world_size() == 1:
        return fn(*args, **kwargs)
    error, out = None, None
    try:
        out = fn(*args, **kwargs)
    except Exception as exc:  # noqa: BLE001 — told to every rank below
        error = exc
    oom = isinstance(error, torch.OutOfMemoryError)
    flag = torch.tensor([float(oom), float(error is not None and not oom)],
                        device=_collective_device())
    dist.all_reduce(flag, op=dist.ReduceOp.SUM)
    n_oom, n_other = (int(v) for v in flag.tolist())
    if n_other:
        if error is not None and not oom:
            raise error
        raise RuntimeError(f"{n_other} of {world_size()} ranks failed in {fn!r}")
    if n_oom:
        raise torch.OutOfMemoryError(
            f"out of device memory on {n_oom} of {world_size()} ranks "
            f"({'this one among them' if oom else 'not this one'})")
    return out


def refuse_group_training() -> None:
    """Training over more than one rank raises: it waits for ROADMAP A13b."""
    if world_size() > 1:
        raise NotImplementedError(
            f"training over a process group of {world_size()} ranks waits for ROADMAP A13b "
            "(data-parallel training: JAX's BatchNorm statistics, HashLoss pairs and XBM see "
            "the global batch)")
