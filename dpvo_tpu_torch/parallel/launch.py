"""Start ``world_size`` ranks of one function on this host.

    results = launch.spawn(fn, 2, args, rendezvous_dir, timeout=300)

Each rank is a process of the ``spawn`` context running
``fn(rank, world_size, init_method, *args)``; ``init_method`` is a
``file://`` store in ``rendezvous_dir`` (a fresh file per call, so no TCP
port is needed).  The return values come back in rank order (they are
pickled: return numpy, not CUDA tensors).  On the first failing rank the
others are terminated and its traceback is re-raised in a RuntimeError;
past ``timeout`` seconds every rank is terminated and a TimeoutError
raised.  ``fn`` must be importable by the children (a module-level function
of a module they can import); they start from a fresh interpreter and run
``torch.set_num_threads(threads)`` first.
"""
from __future__ import annotations

import multiprocessing as mp
import os
import queue
import time
import traceback
import uuid


def _child(rank, world_size, init_method, threads, fn, args, results):
    import torch
    import torch.distributed as dist
    torch.set_num_threads(threads)
    try:
        out = fn(rank, world_size, init_method, *args)
        results.put((rank, True, out))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn(fn, world_size, args=(), rendezvous_dir=".", timeout=600.0,
          threads=1):
    """Run ``fn`` on ``world_size`` ranks; -> list of results by rank."""
    ctx = mp.get_context("spawn")
    os.makedirs(rendezvous_dir, exist_ok=True)
    store = os.path.join(os.path.abspath(rendezvous_dir),
                         f"rendezvous_{uuid.uuid4().hex}")
    init_method = f"file://{store}"
    results = ctx.Queue()
    procs = [ctx.Process(target=_child, args=(r, world_size, init_method,
                                              threads, fn, args, results),
                         daemon=True)
             for r in range(world_size)]
    for p in procs:
        p.start()
    out, deadline = {}, time.monotonic() + timeout
    try:
        while len(out) < world_size:
            try:
                rank, ok, value = results.get(timeout=1.0)
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if r not in out and p.exitcode not in (None, 0)]
                if dead:
                    raise RuntimeError(
                        f"rank {dead[0]} exited with code "
                        f"{procs[dead[0]].exitcode} and no result")
                if time.monotonic() > deadline:
                    raise TimeoutError(f"{world_size} ranks did not finish "
                                       f"within {timeout} s")
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} failed:\n{value}")
            out[rank] = value
        for p in procs:
            p.join(timeout=max(deadline - time.monotonic(), 1.0))
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
        for p in procs:
            p.join(timeout=10.0)
        results.close()
        if os.path.exists(store):
            os.remove(store)
    return [out[r] for r in range(world_size)]
