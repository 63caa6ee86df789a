"""A world of ranks, one process a card: rank 0 is the calling process.

The others are spawned (``torch.multiprocessing``, ``spawn``) and meet rank 0
through a rendezvous file in a fresh directory under ``TMPDIR``, which is
removed when every rank has ended. A rank that has not ended by the
deadline is killed. :func:`joined` is one rank's part: its card, its process
group and its tear-down.
"""

from __future__ import annotations

import contextlib
import os
import shutil
import sys
import tempfile
import time
import traceback

JOIN_DEADLINE_S = 60.0
NCCL_TIMEOUT_S = 240.0


@contextlib.contextmanager
def joined(device: str, rank: int = 0, world: int = 1, init_file: str | None = None):
    """``(dist, dev)`` for rank ``rank`` of ``world``: its card (or the CPU)
    and, on several ranks, the process group joined through ``init_file``
    (NCCL on cards, gloo on the CPU), destroyed on the way out. ``dist`` is
    ``None`` on one rank."""
    import torch

    dist = None
    if world > 1:
        from datetime import timedelta

        import torch.distributed as dist

        if device == "cuda":
            torch.cuda.set_device(rank)
        dist.init_process_group("nccl" if device == "cuda" else "gloo",
                                init_method=f"file://{init_file}", rank=rank, world_size=world,
                                timeout=timedelta(seconds=NCCL_TIMEOUT_S))
    dev = torch.device(device, torch.cuda.current_device()) if device == "cuda" else \
        torch.device("cpu")
    try:
        yield dist, dev
    finally:
        if dist is not None and dist.is_initialized():
            dist.destroy_process_group()


def _rank(target, args: tuple, rank: int, world: int, init_file: str) -> None:
    try:
        target(*args, rank, world, init_file)
    except Exception:
        traceback.print_exc(file=sys.stderr)
        sys.exit(1)


def run(target, args: tuple, world: int):
    """``target(*args, rank, world, init_file)`` on every rank; rank 0's
    result once all have ended cleanly."""
    import torch.multiprocessing as mp

    tmp = tempfile.mkdtemp(prefix="portbench-")
    init_file = os.path.join(tmp, "rendezvous")
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_rank, args=(target, args, r, world, init_file))
             for r in range(1, world)]
    try:
        for p in procs:
            p.start()
        result = target(*args, 0, world, init_file)
        end = time.monotonic() + JOIN_DEADLINE_S
        for p in procs:
            p.join(max(0.0, end - time.monotonic()))
        bad = [r for r, p in enumerate(procs, 1) if p.exitcode != 0]
        if bad:
            raise RuntimeError(f"ranks {bad} did not end cleanly")
        return result
    finally:
        for p in procs:
            if p.pid is None:
                continue
            if p.is_alive():
                p.kill()
            p.join(30)
        shutil.rmtree(tmp, ignore_errors=True)
