"""Process groups for tensor-parallel serving (port of
``repro.launch.mesh``).

A (data=1, model=T) mesh is T processes, one per rank, started with
``torch.multiprocessing.spawn`` (never fork: the parent may already hold
a CUDA context).  Rank r runs on ``cuda:{r % device_count}``, or on the
CPU when the caller asks for it.  The data axis is not ported: D > 1
raises.

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

from repro_torch.models.common import TensorParallel

COLLECTIVE_TIMEOUT_S = 120


def parse_mesh_shape(text: str) -> tuple[int, int]:
    """``"DxT"`` -> (D, T); D > 1 (the data axis) is not ported."""
    try:
        d, t = (int(v) for v in text.lower().split("x"))
    except ValueError:
        raise ValueError(f"--mesh-shape takes DxT, e.g. 1x2, not {text!r}") from None
    if d < 1 or t < 1:
        raise ValueError(f"mesh axes must be >= 1, got {text!r}")
    if d != 1:
        raise NotImplementedError(
            f"the data axis is not ported (mesh {text}): only 1xT meshes run")
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


def init(rank: int, n: int, device_type: str, init_method: str) -> TensorParallel:
    """Join the process group as ``rank`` of ``n``: the rank's handle."""
    dev = rank_device(rank, device_type)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    be = backend(n, device_type)
    if be == "gloo":
        # all ranks run on this host: talk over the loopback interface
        os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    dist.init_process_group(be, init_method=init_method, world_size=n, rank=rank,
                            timeout=datetime.timedelta(seconds=COLLECTIVE_TIMEOUT_S))
    return TensorParallel(rank, n, dist.group.WORLD, dev, be)


def _rank_main(rank, fn, n, device_type, tmp, args):
    if device_type == "cpu":
        torch.set_num_threads(1)        # the ranks share the host's cores
    tp = init(rank, n, device_type, f"file://{tmp}/store")
    try:
        torch.save(fn(tp, *args), os.path.join(tmp, f"rank{rank}.pt"))
        # no rank tears its connections down while a peer is still in the
        # last collective: without this, gloo aborts a rank now and then
        dist.barrier()
    finally:
        dist.destroy_process_group()


def spawn(fn, n: int, *args, device="cuda") -> list:
    """Run ``fn(tp, *args)`` in ``n`` new processes, rank r with the
    handle ``tp`` of rank r, and return their results in rank order.
    ``fn`` is a module-level function of this package (the children
    import it, and nothing else of the caller's).  Joins every rank and
    raises if any rank raised or exited non-zero."""
    device_type = torch.device(device).type
    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device found; pass device='cpu' to run the ranks on the CPU")
    with tempfile.TemporaryDirectory() as tmp:
        torch.multiprocessing.spawn(_rank_main, args=(fn, n, device_type, tmp, args),
                                    nprocs=n, join=True)
        return [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
                for r in range(n)]


def in_turn(tp, *calls):
    """A rank function that runs several in the same ranks, one after
    another: ``calls`` are ``(fn, *args)``; returns their results."""
    return [fn(tp, *args) for fn, *args in calls]
