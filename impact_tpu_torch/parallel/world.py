"""Ranks in processes of their own, joined in one process group, that run
the jobs a parent sends them (``World.run``).

Each rank is a ``spawn`` child: it imports only the port, runs one thread,
joins the process group through a ``FileStore`` (no TCP port to
collide over), and then runs each job it receives, ``fn(ctx, *args)``, with
``fn`` a module-level function of the port (pickled by name) and ``ctx`` the
rank's :class:`RankContext`. Results travel back pickled, so jobs return
numpy arrays and plain Python values. A job that raises on any rank fails
the whole ``run``: the world is torn down, since the other ranks may be
waiting in a collective that will not complete.
"""

from __future__ import annotations

import multiprocessing as mp
import os
import queue
import shutil
import tempfile
import time
import traceback
from typing import NamedTuple

import torch
import torch.distributed as dist

from .comm import resolve_backend


class RankContext(NamedTuple):
    rank: int
    world_size: int
    device: torch.device
    backend: str


def _rank_main(rank, n, store_path, backend, device, tasks, results):
    torch.set_num_threads(1)  # n ranks share the host's cores
    dev = torch.device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, store=dist.FileStore(store_path, n), rank=rank,
                            world_size=n)
    ctx = RankContext(rank, n, dev, backend)
    try:
        while True:
            task = tasks.get()
            if task is None:
                break
            fn, args, kwargs = task
            try:
                results.put((rank, True, fn(ctx, *args, **kwargs)))
            except Exception:  # reported to the parent, which tears the world down
                results.put((rank, False, traceback.format_exc()))
    finally:
        dist.destroy_process_group()


class World:
    """``n_ranks`` ranks on ``device`` over the transport that
    ``comm.resolve_backend`` picks (``backend="gloo"`` to share one card).
    ``store_dir``: where the rendezvous file goes (a fresh temporary
    directory by default). Use as a context manager, or call ``close``."""

    def __init__(self, n_ranks: int, device="cuda", backend: str | None = None,
                 store_dir=None):
        self.n_ranks = n_ranks
        self.backend = resolve_backend(device, backend, n_ranks)
        self._tmp = None if store_dir is not None else tempfile.mkdtemp(prefix="world_")
        base = store_dir if store_dir is not None else self._tmp
        store_path = os.path.join(str(base), f"store_{os.getpid()}_{time.monotonic_ns()}")
        ctx = mp.get_context("spawn")
        self._tasks = [ctx.Queue() for _ in range(n_ranks)]
        self._results = ctx.Queue()
        self._procs = [ctx.Process(target=_rank_main,
                                   args=(r, n_ranks, store_path, self.backend, str(device),
                                         self._tasks[r], self._results), daemon=True)
                       for r in range(n_ranks)]
        for p in self._procs:
            p.start()

    def run(self, fn, *args, timeout: float = 600.0, **kwargs) -> list:
        """``fn(ctx, *args, **kwargs)`` on every rank → the results in rank
        order (``submit`` then ``collect``)."""
        self.submit(fn, *args, **kwargs)
        return self.collect(timeout)

    def submit(self, fn, *args, **kwargs):
        """Start ``fn(ctx, *args, **kwargs)`` on every rank; ``collect``
        returns its results (the parent is free meanwhile)."""
        self._pending = fn
        for q in self._tasks:
            q.put((fn, args, kwargs))

    def collect(self, timeout: float = 600.0) -> list:
        """The submitted job's results in rank order. Raises RuntimeError
        (with the rank's traceback) if a rank raised, TimeoutError if a rank
        exited or the ranks did not all finish in ``timeout`` seconds; either
        way the world is closed."""
        fn = self._pending
        out, deadline = {}, time.monotonic() + timeout
        while len(out) < self.n_ranks:
            try:
                rank, ok, value = self._results.get(timeout=1.0)
            except queue.Empty:
                missing = sorted(set(range(self.n_ranks)) - set(out))
                dead = [r for r in missing if not self._procs[r].is_alive()]
                if dead or time.monotonic() > deadline:
                    self.close(force=True)
                    why = (f"ranks {dead} exited" if dead
                           else f"ranks {missing} did not finish in {timeout} s")
                    raise TimeoutError(f"{fn.__name__}: {why}") from None
                continue
            if not ok:
                self.close(force=True)
                raise RuntimeError(f"{fn.__name__} failed on rank {rank}:\n{value}")
            out[rank] = value
        return [out[r] for r in range(self.n_ranks)]

    def close(self, force: bool = False):
        """Stop the ranks (at once with ``force``) and remove the rendezvous
        directory this world made."""
        if not force:
            for q in self._tasks:
                q.put(None)
            for p in self._procs:
                p.join(timeout=30)
        for p in self._procs:
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
        for q in (*self._tasks, self._results):
            q.close()
            q.cancel_join_thread()
        if self._tmp is not None:
            shutil.rmtree(self._tmp, ignore_errors=True)
            self._tmp = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close(force=exc[0] is not None)
