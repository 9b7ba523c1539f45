"""Start ranks of one torch.distributed world as new processes.

    results = spawn(fn, 2, backend="gloo", args=(...,), device="cpu")

runs fn(rank, *args) in each of `nprocs` processes made by
torch.multiprocessing's spawn context, each a rank of a process group of
`backend` whose rendezvous is a FileStore in a new temporary directory (no
TCP port, so worlds started side by side never collide), and returns the
ranks' return values in rank order. The backend is always the caller's:
"nccl" needs one GPU per rank; "gloo" serves ranks that share a device
(the CPU, or several ranks on one card).

Timeouts: the process group's (`timeout`, seconds), after which a rank
stuck in a collective raises; and the whole run's (`join_timeout`), after
which every rank still running is terminated and spawn raises
TimeoutError. A rank that raises makes spawn terminate the others and
raise RuntimeError with its traceback.

Where the ranks run on CUDA, the parent builds the kernel libraries into
``lvdgs_torch/_build`` first, and the ranks only load them: they never run
nvcc at the same time into one directory. `fn` must be importable by name
(a module-level function) and return a picklable value.
"""
from __future__ import annotations

import contextlib
import datetime
import math
import os
import pickle
import queue as queue_mod
import shutil
import tempfile
import time
import traceback
from typing import Callable, Optional, Sequence

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def _run_rank(rank: int, nprocs: int, backend: str, store_path: str, timeout: float, threads: int,
              fn: Callable, args: Sequence, results) -> None:
    os.environ["LOCAL_RANK"] = str(rank)
    os.environ["RANK"] = str(rank)
    os.environ["WORLD_SIZE"] = str(nprocs)
    torch.set_num_threads(threads)
    try:
        dist.init_process_group(backend, store=dist.FileStore(store_path, nprocs), rank=rank,
                                world_size=nprocs, timeout=datetime.timedelta(seconds=timeout))
        try:
            out = fn(rank, *args)
        finally:
            dist.destroy_process_group()
        results.put((rank, "ok", pickle.dumps(out)))
    except Exception:
        # the rank's boundary: its traceback goes to the parent, which
        # stops the other ranks and raises
        results.put((rank, "error", traceback.format_exc()))


def spawn(fn: Callable, nprocs: int, *, backend: str, args: Sequence = (), device=None,
          timeout: float = 120.0, join_timeout: Optional[float] = None) -> list:
    """Run fn(rank, *args) on `nprocs` new ranks (see the module doc).
    `device` names where the ranks run, for the kernel build: None or a
    CUDA device builds the kernels first, "cpu" does not. `join_timeout`
    defaults to twice `timeout`; math.inf waits as long as the ranks run."""
    if backend not in ("gloo", "nccl"):
        raise ValueError(f"backend must be 'gloo' or 'nccl', not {backend!r}")
    if device is None or torch.device(device).type == "cuda":
        from ..ops.rasterizer_cuda import build_libraries

        build_libraries()
    join_timeout = join_timeout if join_timeout is not None else 2 * timeout
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    store_dir = tempfile.mkdtemp(prefix="lvdgs_ranks_")
    threads = max(1, torch.get_num_threads() // nprocs)
    procs = [ctx.Process(target=_run_rank, daemon=True,
                         args=(r, nprocs, backend, os.path.join(store_dir, "store"), timeout, threads, fn,
                               tuple(args), results))
             for r in range(nprocs)]
    try:
        for p in procs:
            p.start()
        done: dict = {}
        deadline = time.monotonic() + join_timeout
        while len(done) < nprocs:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(f"ranks {sorted(set(range(nprocs)) - set(done))} still running after "
                                   f"{join_timeout:.0f} s")
            try:
                rank, status, payload = results.get(timeout=min(left, 1.0))
            except queue_mod.Empty:
                dead = [r for r, p in enumerate(procs) if r not in done and p.exitcode not in (None, 0)]
                if dead:
                    raise RuntimeError(f"ranks {dead} exited with codes "
                                       f"{[procs[r].exitcode for r in dead]} and no result")
                continue
            if status == "error":
                raise RuntimeError(f"rank {rank} of {nprocs} failed:\n{payload}")
            done[rank] = pickle.loads(payload)
        for p in procs:
            p.join(None if math.isinf(deadline) else max(deadline - time.monotonic(), 1.0))
        alive = [r for r, p in enumerate(procs) if p.is_alive()]
        if alive:
            raise TimeoutError(f"ranks {alive} did not exit after returning")
        return [done[r] for r in range(nprocs)]
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
        for p in procs:
            if p.pid is not None:
                p.join(5.0)
                if p.is_alive():
                    p.kill()
                    p.join(5.0)
        results.close()
        shutil.rmtree(store_dir, ignore_errors=True)


@contextlib.contextmanager
def world_of_one(backend: str, device=None):
    """This process as the one rank of a world of `backend` (a FileStore
    in a temporary directory) while the block runs: the world of a (1, 1)
    mesh. `device` is the rank's CUDA device, set first."""
    store_dir = tempfile.mkdtemp(prefix="lvdgs_rank_")
    if device is not None and torch.device(device).type == "cuda" and torch.device(device).index is not None:
        torch.cuda.set_device(torch.device(device))
    dist.init_process_group(backend, store=dist.FileStore(os.path.join(store_dir, "store"), 1),
                            rank=0, world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()
        shutil.rmtree(store_dir, ignore_errors=True)
