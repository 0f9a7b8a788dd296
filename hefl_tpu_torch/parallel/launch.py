"""A world of ranks spawned from one process, for tests and smoke runs.

`World(size, backend, device)` starts `size` processes (the `spawn` start
method: a fork after CUDA or OpenMP started hangs), each joining one
process group through `mesh.init_mesh` on a `file://` store in a
temporary directory (no TCP port to collide). `World.run(fn, *args)` runs
the module-level function `fn(*args)` on every rank and returns the ranks'
results in rank order; a rank that raises fails the call with its
traceback. Every rendezvous, collective and join has a time limit, so a
rank that dies fails the caller instead of hanging it. `torchrun` is the
launcher of a real run (`python -m hefl_tpu_torch.cli` under it).
"""

from __future__ import annotations

import os
import queue
import shutil
import tempfile
import time
import traceback

import torch.multiprocessing as mp

from hefl_tpu_torch.parallel.mesh import DEFAULT_TIMEOUT_S, init_mesh


def _serve(rank: int, size: int, backend: str, device: str, store: str, timeout_s: float,
           threads: int | None, tasks, results) -> None:
    import torch
    import torch.distributed as dist

    if threads is not None:
        torch.set_num_threads(threads)
    try:
        init_mesh(device, backend=backend, init_method=store, rank=rank, world_size=size,
                  timeout_s=timeout_s)
    except Exception:  # the caller reads the failure instead of waiting for it
        results.put((rank, False, traceback.format_exc()))
        return
    results.put((rank, True, None))
    while True:
        task = tasks.get()
        if task is None:
            break
        fn, args = task
        try:
            results.put((rank, True, fn(*args)))
        except Exception:  # reported to the caller, which raises it
            results.put((rank, False, traceback.format_exc()))
    dist.destroy_process_group()


class World:
    """`size` spawned ranks in one process group (see the module docstring).
    Use as a context manager, or call `close`."""

    def __init__(self, size: int, backend: str = "gloo", device: str = "cpu",
                 timeout_s: float = DEFAULT_TIMEOUT_S, threads: int | None = None):
        ctx = mp.get_context("spawn")
        self.size = int(size)
        self.timeout_s = timeout_s
        self._dir = tempfile.mkdtemp(prefix="hefl_world_")
        store = f"file://{os.path.join(self._dir, 'store')}"
        self._results = ctx.Queue()
        self._tasks = [ctx.Queue() for _ in range(self.size)]
        self._procs = [
            ctx.Process(target=_serve, daemon=True,
                        args=(r, self.size, backend, device, store, timeout_s, threads,
                              self._tasks[r], self._results))
            for r in range(self.size)]
        for proc in self._procs:
            proc.start()
        try:
            self._collect(timeout_s + 60)
        except BaseException:
            self.close()
            raise

    def _collect(self, timeout_s: float) -> list:
        got: dict = {}
        errors = []
        deadline = time.monotonic() + timeout_s
        while len(got) < self.size:
            try:
                rank, ok, value = self._results.get(timeout=1.0)
            except queue.Empty:
                missing = sorted(set(range(self.size)) - set(got))
                dead = [r for r in missing if not self._procs[r].is_alive()]
                if dead or time.monotonic() > deadline:
                    raise TimeoutError(
                        f"world of {self.size}: ranks {missing} gave no result "
                        f"(dead ranks {dead}, limit {timeout_s} s)") from None
                continue
            got[rank] = value
            if not ok:
                errors.append(f"rank {rank}:\n{value}")
        if errors:
            raise RuntimeError("\n".join(errors))
        return [got[r] for r in range(self.size)]

    def run(self, fn, *args, timeout_s: float = 600):
        """fn(*args) on every rank -> the results, in rank order."""
        for q in self._tasks:
            q.put((fn, args))
        return self._collect(timeout_s)

    def close(self) -> None:
        for q, proc in zip(self._tasks, self._procs):
            if proc.is_alive():
                q.put(None)
        for proc in self._procs:
            proc.join(self.timeout_s)
            if proc.is_alive():
                proc.kill()
                proc.join(self.timeout_s)
        shutil.rmtree(self._dir, ignore_errors=True)

    def __enter__(self) -> "World":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
