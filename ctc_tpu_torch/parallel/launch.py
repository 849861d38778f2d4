"""Starting a host's ranks: ``--data-parallel N`` needs no launcher of its
own (``ctc_tpu``'s ``--data-parallel 8`` needs none either).

:func:`spawn_ranks` runs a function in one process per local rank, started
with the ``spawn`` method (``fork`` after CUDA is initialized breaks), and
returns their results in rank order.  A rank that raises or dies fails the
launch: the other ranks, which may wait in a collective for it, are ended,
and the error carries the failed rank's traceback.
"""

from __future__ import annotations

import multiprocessing as mp
import os
import queue as queue_lib
import socket
import sys
import time
import traceback


def free_port() -> int:
    """A TCP port on the loopback interface that nothing listens on now."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_entry(target, local_rank, args, results):
    if local_rank:
        # one log a host: the other ranks would print the same lines
        sys.stdout = open(os.devnull, "w")
    try:
        results.put((local_rank, True, target(local_rank, *args)))
    except BaseException:
        results.put((local_rank, False, traceback.format_exc()))
        raise


def _end(procs) -> None:
    for p in procs:
        if p.is_alive():
            p.terminate()
    for p in procs:
        p.join(5)
        if p.is_alive():
            p.kill()
            p.join()


def spawn_ranks(target, args, nprocs: int, *,
                timeout: float | None = None) -> list:
    """``[target(r, *args) for r in range(nprocs)]``, each call in a
    process of its own; ``target`` and ``args`` must pickle (a module-level
    function).  The standard output of every rank but 0 goes to the null
    device.  ``timeout`` (seconds, None: none) bounds the whole launch;
    past it every rank is ended and ``TimeoutError`` raised."""
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_entry,
                         args=(target, r, args, results),
                         daemon=True)
             for r in range(nprocs)]
    for p in procs:
        p.start()
    deadline = None if timeout is None else time.monotonic() + timeout
    out: dict[int, object] = {}
    try:
        while len(out) < nprocs:
            try:
                rank, ok, value = results.get(timeout=0.2)
            except queue_lib.Empty:
                dead = [r for r, p in enumerate(procs)
                        if r not in out and p.exitcode is not None]
                if dead and results.empty():
                    raise RuntimeError(
                        f"rank {dead[0]} exited with code "
                        f"{procs[dead[0]].exitcode} without a result")
                if deadline is not None and time.monotonic() > deadline:
                    raise TimeoutError(
                        f"ranks {sorted(set(range(nprocs)) - set(out))} "
                        f"did not finish within {timeout} s")
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} failed:\n{value}")
            out[rank] = value
        for p in procs:
            p.join(60)
    finally:
        _end(procs)
    return [out[r] for r in range(nprocs)]
