"""Run a function as the ranks of a ``torch.distributed`` group on one
host.

:func:`run_ranks` starts ``world_size`` processes by ``spawn`` (never
``fork``: a forked child of a process that has touched CUDA cannot use
it). Each rank

- joins a group on a ``FileStore`` in a fresh temporary directory (no TCP
  port, so concurrent jobs cannot collide), with a timeout, so that a rank
  that hangs fails the job instead of stalling it;
- takes ``gloo`` as its backend, or ``nccl`` for one rank on the card (NCCL
  refuses two ranks on one GPU; several ranks on one card run gloo);
- runs with ``torch.set_num_threads(1)``;
- calls ``fn(*args, device=device)`` and hands its result back through a
  file (``torch.save``; keep it small, or on the CPU).

The parent joins the ranks or raises: a rank that raised, died or
outlived ``timeout_s`` fails the call with its traceback, and every rank
is stopped.
"""
from __future__ import annotations

import datetime
import multiprocessing as mp
import tempfile
import time
import traceback
from pathlib import Path

import torch


def backend_for(world_size: int, device) -> str:
    """``nccl`` for one rank on the card, ``gloo`` otherwise (the CPU, or
    several ranks sharing one card)."""
    on_card = torch.device(device).type == "cuda"
    return "nccl" if on_card and world_size == 1 else "gloo"


def _rank_main(workdir: str, rank: int, world_size: int, device: str,
               timeout_s: float) -> None:
    import torch.distributed as dist

    work = Path(workdir)
    try:
        torch.set_num_threads(1)
        dev = torch.device(device)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        fn, args = torch.load(work / "call.pt", weights_only=False)
        store = dist.FileStore(str(work / "store"), world_size)
        dist.init_process_group(
            backend_for(world_size, dev), store=store, rank=rank,
            world_size=world_size,
            timeout=datetime.timedelta(seconds=timeout_s))
        try:
            out = fn(*args, device=dev)
            dist.barrier()
        finally:
            dist.destroy_process_group()
        torch.save(out, work / f"result{rank}.pt")
    except BaseException:  # reported to the parent, which raises
        (work / f"error{rank}.txt").write_text(traceback.format_exc())
        raise SystemExit(1)


def run_ranks(fn, world_size: int, *args, device="cpu",
              timeout_s: float = 300.0):
    """``fn(*args, device=device)`` on each of ``world_size`` spawned ranks
    of one process group; returns the ranks' results in rank order.

    ``fn`` must be importable by name (a module-level function) and
    ``args`` picklable. ``device`` is every rank's device ("cpu", or
    "cuda"/"cuda:0": the ranks share the one card). Raises RuntimeError
    when a rank fails and TimeoutError after ``timeout_s`` seconds."""
    world_size = int(world_size)
    if world_size < 1:
        raise ValueError(f"world_size={world_size}")
    device = str(torch.device(device))
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="bft_ranks_") as workdir:
        work = Path(workdir)
        torch.save((fn, args), work / "call.pt")
        procs = [ctx.Process(target=_rank_main,
                             args=(workdir, r, world_size, device, timeout_s),
                             daemon=True)
                 for r in range(world_size)]
        for p in procs:
            p.start()
        # poll, so that one failed rank stops the others at once instead of
        # after the group's timeout
        deadline = time.monotonic() + timeout_s + 60.0
        try:
            while (any(p.is_alive() for p in procs)
                   and not any(p.exitcode for p in procs)
                   and time.monotonic() < deadline):
                time.sleep(0.02)
            late = [r for r, p in enumerate(procs)
                    if p.is_alive() and not any(q.exitcode for q in procs)]
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join()
        errors = [f"rank {r}:\n{(work / f'error{r}.txt').read_text()}"
                  if (work / f"error{r}.txt").exists()
                  else f"rank {r}: exit code {p.exitcode}"
                  for r, p in enumerate(procs)
                  if r not in late and p.exitcode != 0]
        if errors:
            raise RuntimeError("a rank failed:\n" + "\n".join(errors))
        if late:
            raise TimeoutError(f"ranks {late} did not finish within "
                               f"{timeout_s + 60.0:.0f} s")
        return [torch.load(work / f"result{r}.pt", map_location="cpu",
                           weights_only=False)
                for r in range(world_size)]


__all__ = ["run_ranks", "backend_for"]
