"""Process groups for serving on a (data=D, model=T) mesh (port of
``repro.launch.mesh``).

A D x T mesh is D*T processes, one per rank, started with
``torch.multiprocessing.spawn`` (never fork: the parent may already hold
a CUDA context).  Global rank g sits at data index g // T and model
index g % T, as ``jax.make_mesh((D, T), ("data", "model"))`` lays its
devices out.  Rank g runs on ``cuda:{g % device_count}``, or on the CPU
when the caller asks for it.  Each rank's handle
(``models.common.TensorParallel``) carries its model group (the T ranks
of its data index: the model's collectives) and, as ``data``, its data
group (the D ranks of its model index, always gloo: the engine gathers
host copies over it).

Backend rule: NCCL when every rank has a card of its own; gloo
otherwise -- on the CPU, and when ranks share a card, which NCCL refuses.
Both run the same kernels on the card; gloo stages every collective
through the host.  Every collective times out after
``COLLECTIVE_TIMEOUT_S``, so a rank that hangs fails the run instead of
stalling it.
"""
from __future__ import annotations

import datetime
import os
import tempfile

import torch
import torch.distributed as dist
import torch.multiprocessing

from repro_torch.models.common import DataParallel, TensorParallel

COLLECTIVE_TIMEOUT_S = 120


def parse_mesh_shape(text: str) -> tuple[int, int]:
    """``"DxT"`` -> (D, T)."""
    try:
        d, t = (int(v) for v in text.lower().split("x"))
    except ValueError:
        raise ValueError(f"--mesh-shape takes DxT, e.g. 2x2, not {text!r}") from None
    if d < 1 or t < 1:
        raise ValueError(f"mesh axes must be >= 1, got {text!r}")
    return d, t


def rank_device(rank: int, device_type: str) -> torch.device:
    if device_type == "cpu":
        return torch.device("cpu")
    return torch.device(f"cuda:{rank % torch.cuda.device_count()}")


def backend(n: int, device_type: str) -> str:
    """NCCL when each of the ``n`` ranks has a card of its own, else gloo."""
    if device_type == "cuda" and torch.cuda.device_count() >= n:
        return "nccl"
    return "gloo"


def describe(n: int, device_type: str) -> str:
    be = backend(n, device_type)
    why = ("every rank has a card of its own" if be == "nccl" else
           "ranks on the CPU" if device_type == "cpu" else
           f"{n} ranks share {torch.cuda.device_count()} card(s), which NCCL refuses")
    return f"backend {be} ({why})"


def init(rank: int, d: int, t: int, device_type: str, init_method: str) -> TensorParallel:
    """Join the process group as global ``rank`` of a ``d`` x ``t`` mesh:
    the rank's handle."""
    n = d * t
    dev = rank_device(rank, device_type)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    be = backend(n, device_type)
    if be == "gloo":
        # all ranks run on this host: talk over the loopback interface
        os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    dist.init_process_group(be, init_method=init_method, world_size=n, rank=rank,
                            timeout=datetime.timedelta(seconds=COLLECTIVE_TIMEOUT_S))
    di, ti = divmod(rank, t)
    model_group = data_group = None
    if d > 1:
        # every rank creates every group, all in one order (torch requires
        # it even of the ranks outside a group)
        for i in range(d):
            g = dist.new_group(list(range(i * t, (i + 1) * t)))
            model_group = g if i == di else model_group
        for j in range(t):
            g = dist.new_group(list(range(j, n, t)), backend="gloo")
            data_group = g if j == ti else data_group
    return TensorParallel(ti, t, model_group if d > 1 else dist.group.WORLD, dev, be,
                          data=DataParallel(di, d, data_group))


def _rank_main(rank, fn, d, t, device_type, tmp, args):
    if device_type == "cpu":
        torch.set_num_threads(1)        # the ranks share the host's cores
    tp = init(rank, d, t, device_type, f"file://{tmp}/store")
    try:
        torch.save(fn(tp, *args), os.path.join(tmp, f"rank{rank}.pt"))
        # no rank tears its connections down while a peer is still in the
        # last collective: without this, gloo aborts a rank now and then
        dist.barrier()
    finally:
        dist.destroy_process_group()


def spawn(fn, n: int, *args, device="cuda", data: int = 1) -> list:
    """Run ``fn(tp, *args)`` in the ``data * n`` processes of a (data,
    model=n) mesh, global rank g with its handle ``tp``, and return their
    results in global rank order.  ``fn`` is a module-level function of
    this package (the children import it, and nothing else of the
    caller's).  Joins every rank and raises if any rank raised or exited
    non-zero."""
    device_type = torch.device(device).type
    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device found; pass device='cpu' to run the ranks on the CPU")
    with tempfile.TemporaryDirectory() as tmp:
        torch.multiprocessing.spawn(_rank_main, args=(fn, data, n, device_type, tmp, args),
                                    nprocs=data * n, join=True)
        return [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
                for r in range(data * n)]


def in_turn(tp, *calls):
    """A rank function that runs several in the same ranks, one after
    another: ``calls`` are ``(fn, *args)``; returns their results."""
    return [fn(tp, *args) for fn, *args in calls]
