"""Process-group start-up (port of ``hgr_tpu/parallel/distributed.py:22-60``).

Where JAX's runtime joins the hosts and picks a transport itself, torch
needs the backend named: ``Config.dist_backend`` (``--dist_backend``),
``nccl`` by default. With NCCL each rank drives its own card,
``cuda:{device + local_rank}``. Only ``gloo`` lets ranks share one card
(or run on the CPU): NCCL refuses two ranks on one GPU.

Launch the CLI under ``python -m torch.distributed.run --standalone
--nproc_per_node N -m hgr_tpu_torch ...``: :func:`init_distributed` reads
torchrun's environment. :func:`run_ranks` starts a small gloo world of
spawned processes on one host, for tests and checks.
"""

from __future__ import annotations

import multiprocessing as mp
import os
import queue
import socket
import time
import traceback
from datetime import timedelta
from typing import Any, Callable, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from .mesh import part_rows

BACKENDS = ("nccl", "gloo")


def initialised() -> bool:
    return dist.is_available() and dist.is_initialized()


def rank_and_world() -> Tuple[int, int]:
    return (dist.get_rank(), dist.get_world_size()) if initialised() else (0, 1)


def is_writer() -> bool:
    """True on the one rank that logs and writes checkpoints (rank 0)."""
    return rank_and_world()[0] == 0


def any_rank(flag: bool, device) -> bool:
    """``flag`` on any rank (an all-reduce MAX over the world; ``flag``
    itself in a one-process run): a stop every rank takes at one step."""
    if not initialised():
        return flag
    t = torch.tensor([int(flag)], device=device)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return bool(t.item())


def from_rank0(obj: Any) -> Any:
    """Rank 0's ``obj`` on every rank (a broadcast; ``obj`` itself in a
    one-process run)."""
    if not initialised():
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def init_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    backend: str = "nccl",
    timeout_s: float = 600.0,
) -> Tuple[int, int]:
    """Join the process group when this is a multi-process run; a no-op
    otherwise. Returns ``(rank, world_size)``.

    A run is multi-process when ``coordinator_address`` (``host:port``) is
    given, with ``num_processes`` and ``process_id``, or when torchrun's
    ``MASTER_ADDR``, ``RANK`` and ``WORLD_SIZE`` are set. ``timeout_s``
    bounds the wait for a missing rank and every collective, so that a
    missing rank fails the run instead of hanging it."""
    if backend not in BACKENDS:
        raise ValueError(f"--dist_backend {backend!r} is not one of {BACKENDS}")
    if initialised():
        return rank_and_world()
    env = all(k in os.environ for k in ("MASTER_ADDR", "RANK", "WORLD_SIZE"))
    if not coordinator_address and not env:
        return 0, 1
    if backend == "nccl" and not torch.cuda.is_available():
        raise RuntimeError("--dist_backend nccl needs CUDA, which is not available; "
                           "use --dist_backend gloo")
    kw = dict(backend=backend, timeout=timedelta(seconds=timeout_s))
    if coordinator_address:
        addr = coordinator_address
        kw.update(init_method=addr if "://" in addr else f"tcp://{addr}",
                  world_size=num_processes, rank=process_id)
    else:
        kw.update(init_method="env://")
    dist.init_process_group(**kw)
    return rank_and_world()


def local_rank() -> int:
    """This rank's index on its host: torchrun's ``LOCAL_RANK``, else the
    global rank (one host)."""
    return int(os.environ.get("LOCAL_RANK", rank_and_world()[0]))


def rank_device(device: Optional[str], index: int, backend: str) -> Optional[str]:
    """The device this rank runs on: ``device`` when the caller names one;
    under NCCL in a multi-process run ``cuda:{index + local_rank}``, which
    must exist; else None (the entry point's ``cuda:{index}``)."""
    if device is not None or not initialised() or backend != "nccl":
        return device
    i = index + local_rank()
    if i >= torch.cuda.device_count():
        raise RuntimeError(f"rank {rank_and_world()[0]} needs cuda:{i} under NCCL, but this "
                           f"host has {torch.cuda.device_count()} cards; NCCL takes one card "
                           "a rank (use --dist_backend gloo to share one)")
    torch.cuda.set_device(i)
    return f"cuda:{i}"


def host_local_batch_slice(global_batch: int) -> slice:
    """This rank's contiguous slice of a ``[global_batch, ...]`` array (the
    slicing of ``Mesh.batch_shard``, over all the ranks)."""
    rank, world = rank_and_world()
    return part_rows(global_batch, world, rank)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_main(fn, rank, world, port, timeout_s, args, results):
    try:
        init_distributed(f"localhost:{port}", world, rank, backend="gloo", timeout_s=timeout_s)
        try:
            out = fn(rank, *args)
        finally:
            dist.destroy_process_group()
        results.put((rank, True, out))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        raise


def run_ranks(fn: Callable, world: int, args: Sequence[Any] = (),
              timeout_s: float = 300.0) -> List[Any]:
    """``fn(rank, *args)`` in ``world`` spawned processes joined into one
    gloo process group on this host; returns their results in rank order.
    ``fn`` must be importable by name (a module-level function). Raises
    when a rank fails, or when the world has not finished within
    ``timeout_s``: then every rank still running is killed."""
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=_rank_main,
                         args=(fn, r, world, port, timeout_s, args, results))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout_s
    got = {}
    try:
        while len(got) < world:
            try:  # drain the queue before joining: a full pipe blocks its writer
                rank, ok, out = results.get(timeout=1.0)
            except queue.Empty:
                # a rank's report is in the pipe before the rank exits
                dead = [p.exitcode for p in procs if p.exitcode not in (None, 0)]
                if dead:
                    raise RuntimeError(f"a rank exited with code {dead[0]} and no report") from None
                if time.monotonic() > deadline:
                    raise TimeoutError(f"{world - len(got)} of {world} ranks did not finish in "
                                       f"{timeout_s:.0f} s") from None
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} of {world} failed:\n{out}")
            got[rank] = out
        for p in procs:
            p.join(timeout=max(1.0, deadline - time.monotonic()))
        return [got[r] for r in range(world)]
    finally:
        for p in procs:  # the others, when one failed or the time ran out
            if p.is_alive():
                p.kill()
            p.join(10)
        results.close()
