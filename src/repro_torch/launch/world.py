"""Start a world of ranks on this host and collect what each returns.

``run_world(target, world, args)`` spawns ``world`` processes (the
``spawn`` start method, which CUDA needs), starts a ``gloo`` process
group among them over ``tcp://127.0.0.1:<free port>`` with a bounded
timeout, runs ``target(rank, world, *args)`` in each and returns the
results in rank order. ``target`` must be a module-level function (it
is pickled by name). A rank that raises fails the world: the parent
stops every rank and raises with the rank's traceback. The parent waits
at most ``timeout`` seconds in all, then kills the stragglers and
raises, so no world can hang its caller.

On one card every rank puts its tensors on ``cuda:0`` (gloo stages CUDA
tensors through pinned host memory); on the host, the CPU.
"""
from __future__ import annotations

import queue
import socket
import time
import traceback
from datetime import timedelta

import torch.distributed as dist
import torch.multiprocessing as mp

INIT_TIMEOUT_S = 90


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(target, rank: int, world: int, port: int, inq, out) -> None:
    try:
        args = inq.get(timeout=INIT_TIMEOUT_S)
        dist.init_process_group(
            "gloo", init_method=f"tcp://127.0.0.1:{port}",
            world_size=world, rank=rank,
            timeout=timedelta(seconds=INIT_TIMEOUT_S))
        try:
            result = target(rank, world, *args)
        finally:
            dist.destroy_process_group()
        out.put((rank, True, result))
    except BaseException:                  # reported to the parent
        out.put((rank, False, traceback.format_exc()))
        raise


def run_world(target, world: int, args=(), *, timeout: float = 300.0):
    """``[target(rank, world, *args) for rank in range(world)]``, each in
    its own process of one gloo world; raises if any rank fails or the
    world outlives ``timeout`` seconds."""
    ctx = mp.get_context("spawn")
    inq, out = ctx.Queue(), ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_rank_main,
                         args=(target, r, world, port, inq, out),
                         daemon=True)
             for r in range(world)]
    deadline = time.monotonic() + timeout
    results, errors = {}, []
    try:
        for p in procs:
            p.start()
        # the arguments go through a queue, not the processes' own
        # pipes: a large payload there blocks each start until that
        # child has imported its modules, which serialises the ranks
        for _ in procs:
            inq.put(args)
        while len(results) + len(errors) < world:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(f"a world of {world} ranks did not end "
                                   f"in {timeout:.0f} s; got "
                                   f"{sorted(results)}")
            try:
                rank, ok, value = out.get(timeout=min(left, 1.0))
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if p.exitcode not in (None, 0) and r not in results]
                if dead and out.empty():
                    raise RuntimeError(f"rank(s) {dead} exited with codes "
                                       f"{[procs[r].exitcode for r in dead]}"
                                       f" and no result")
                continue
            if ok:
                results[rank] = value
            else:
                errors.append(f"rank {rank}:\n{value}")
                break
        if errors:
            raise RuntimeError("a rank failed:\n" + "\n".join(errors))
        for p in procs:
            p.join(max(deadline - time.monotonic(), 1.0))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(5)
        inq.close()
        out.close()
    return [results[r] for r in range(world)]
