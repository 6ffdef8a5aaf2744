"""Start the ranks of a ``torch.distributed`` run on this host and collect their results.

``spawn_local(fn, world_size, backend, devices, args)`` starts ``world_size``
processes (the ``spawn`` start method), joins them into one process group on
a free localhost port and runs ``fn(*args)`` in each; it returns every
rank's result, indexed by rank. ``fn`` must be importable by name (a
module-level function) and its result picklable. If a rank raises or dies,
the others are stopped and ``spawn_local`` raises with the traceback of
every rank that failed within a second of the first (a peer's failure often
shows as a broken connection in the ranks waiting on it). A rank stuck in a
collective fails after ``timeout`` seconds (the process group's timeout), so
a broken run ends in seconds.

Each rank runs torch on one CPU thread; ``devices[rank]``, where given, is
the rank's current CUDA device. On several GPUs, launch with ``torchrun
--nproc_per_node=N`` and ``init_process_group('nccl')`` instead; this
launcher serves the tests (gloo ranks on the CPU) and the on-card witness
(two gloo ranks sharing one GPU, or one NCCL rank).

    from safe_control_gym_tpu_torch.parallel.launch import spawn_local
    results = spawn_local(my_module.train_case, 2, backend='gloo', args=(cfg,))
"""

from __future__ import annotations

import datetime
import multiprocessing as mp
import queue as queue_mod
import socket
import traceback

import torch
import torch.distributed as dist

__all__ = ['spawn_local', 'free_port']


def free_port() -> int:
    """A TCP port on localhost that is free now."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(('127.0.0.1', 0))
        return s.getsockname()[1]


def _rank_main(rank, world_size, backend, port, device, fn, args, timeout, results):
    try:
        torch.set_num_threads(1)
        if device is not None and torch.device(device).type == 'cuda':
            torch.cuda.set_device(torch.device(device))
        dist.init_process_group(backend, init_method=f'tcp://127.0.0.1:{port}', rank=rank,
                                world_size=world_size,
                                timeout=datetime.timedelta(seconds=timeout))
        try:
            out = fn(*args)
        finally:
            dist.destroy_process_group()
        results.put((rank, True, out))
    except Exception:    # the rank's boundary: report, and end the rank
        results.put((rank, False, traceback.format_exc()))


def _failures(results, world_size, failed, grace=1.0):
    """The message of a failed run: ``failed`` ({rank: traceback}) and the
    failures that arrive within ``grace`` seconds."""
    while True:
        try:
            rank, ok, payload = results.get(timeout=grace)
        except queue_mod.Empty:
            break
        if not ok:
            failed[rank] = payload
    return '\n'.join(f'rank {r} of {world_size} failed:\n{tb}'
                     for r, tb in sorted(failed.items()))


def spawn_local(fn, world_size: int, backend: str = 'gloo', devices=None, args=(),
                timeout: float = 60.0):
    """Run ``fn(*args)`` on ``world_size`` local ranks; their results by rank."""
    ctx = mp.get_context('spawn')
    results = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_rank_main,
                         args=(r, world_size, backend, port,
                               None if devices is None else devices[r], fn, args, timeout,
                               results), daemon=True)
             for r in range(world_size)]
    for p in procs:
        p.start()
    out = [None] * world_size
    pending = set(range(world_size))
    dead_seen = set()
    try:
        while pending:
            try:
                rank, ok, payload = results.get(timeout=1.0)
            except queue_mod.Empty:
                # A rank that exited is given one more wait for its result
                # (it may still be in the pipe).
                dead = [r for r in pending if procs[r].exitcode is not None]
                if any(r in dead_seen for r in dead):
                    r = next(r for r in dead if r in dead_seen)
                    raise RuntimeError(f'rank {r} exited with code {procs[r].exitcode} '
                                       'and no result')
                dead_seen.update(dead)
                continue
            if not ok:
                raise RuntimeError(_failures(results, world_size, {rank: payload}))
            out[rank] = payload
            pending.discard(rank)
    finally:
        for p in procs:
            p.join(timeout=10 if not pending else 0.1)
            if p.is_alive():
                p.terminate()
                p.join(timeout=10)
    return out
