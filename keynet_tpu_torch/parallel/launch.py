"""Run one function on every rank of a torch.distributed world.

keynet_tpu needs no launcher: one JAX process drives the whole mesh.  Here
each rank is a process, so the tests and chip_smoke.py start them with
``launch``: ``fn(rank, world, *args)`` in ``world`` spawned processes that
meet at a rendezvous file, each in a process group of the backend the
caller names, with a timeout on every collective and a deadline on the
whole run.  A rank's exception, a rank that dies and a missed deadline all
stop every rank and raise in the caller.  The ranks share the host's cores:
each gets cpu_count // world threads (OpenMP, OpenBLAS, MKL and torch)
unless the environment sets OMP_NUM_THREADS, since four conversions with
a full BLAS thread pool each run some twenty times slower than one.

    from keynet_tpu_torch.parallel import launch
    results = launch(fn, 4, args=(...,), backend="gloo", deadline=300)
"""

import datetime
import multiprocessing
import os
import queue
import shutil
import tempfile
import time
import traceback

# seconds a collective may wait for the other ranks of its group
PG_TIMEOUT_S = 300
# seconds to collect the other ranks' errors after the first
ERROR_GRACE_S = 2.0


def init_rank(rank, world, init_method, backend):
    """``torch.distributed.init_process_group`` for one rank, with the
    caller's backend ("gloo" on the CPU and for ranks that share a card,
    "nccl" for one rank a card) and a timeout of PG_TIMEOUT_S seconds."""
    import torch.distributed as dist
    if backend not in ("gloo", "nccl"):
        raise ValueError("backend must be 'gloo' or 'nccl', got %r" % (backend,))
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world,
                            timeout=datetime.timedelta(seconds=PG_TIMEOUT_S))


_THREAD_VARS = ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS")


def _rank_main(fn, rank, world, init_method, backend, args, results):
    # the error goes out before the process group closes: closing it fails
    # the other ranks' collectives, whose errors would otherwise come first
    import torch
    import torch.distributed as dist
    try:
        torch.set_num_threads(int(os.environ["OMP_NUM_THREADS"]))
        init_rank(rank, world, init_method, backend)
        results.put((rank, True, fn(rank, world, *args)))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _stop(procs):
    for p in procs:
        if p.is_alive():
            p.terminate()
    for p in procs:
        p.join(5)
        if p.is_alive():
            p.kill()
            p.join(5)


def launch(fn, world, *, backend, args=(), deadline=600):
    """Run ``fn(rank, world, *args)`` on ranks 0..world-1, each in its own
    spawned process (``fn`` and ``args`` are pickled: a function of a module,
    plain data) with its process group of ``backend`` initialised (no
    default: the caller knows whether its ranks share a card), and return
    the ranks' results in rank order.  ``deadline`` bounds the whole run in
    seconds, PG_TIMEOUT_S each collective.  Raises RuntimeError with the tracebacks
    of the ranks that raised (the first to report first, then those that
    report within ERROR_GRACE_S: a rank's failure fails its peers'
    collectives) or the exit code of a rank that died, TimeoutError past
    the deadline; either way every rank is stopped first."""
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    rdv = tempfile.mkdtemp(prefix="keynet_rdv_")
    init_method = "file://" + os.path.join(rdv, "rendezvous")
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(fn, r, world, init_method, backend, args, results))
             for r in range(world)]
    out, errors = {}, []
    saved = {k: os.environ.get(k) for k in _THREAD_VARS}
    if saved["OMP_NUM_THREADS"] is None:
        # the children take the environment as it is when they start
        os.environ.update({k: str(max(1, (os.cpu_count() or 1) // world))
                           for k in _THREAD_VARS})
    try:
        try:
            for p in procs:
                p.start()
        finally:
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
        end = time.monotonic() + deadline
        while len(out) + len(errors) < world:
            now = time.monotonic()
            limit = grace_end if errors else end
            if now >= limit:
                if errors:
                    break
                raise TimeoutError("launch: %d of %d ranks done after the %d s deadline"
                                   % (len(out), world, deadline))
            try:
                rank, ok, value = results.get(timeout=min(limit - now, 1.0))
            except queue.Empty:
                reported = set(out) | {r for r, _ in errors}
                dead = [r for r, p in enumerate(procs)
                        if r not in reported and p.exitcode not in (None, 0)]
                if dead and not errors:
                    # a rank that died without reporting (a signal, os._exit)
                    time.sleep(1.0)
                    if results.empty():
                        raise RuntimeError("launch: rank %d died with exit code %s"
                                           % (dead[0], procs[dead[0]].exitcode))
                continue
            if ok:
                out[rank] = value
                continue
            if not errors:
                grace_end = time.monotonic() + ERROR_GRACE_S
            errors.append((rank, value))
        if errors:
            raise RuntimeError("launch: %d of %d ranks raised:\n%s" % (
                len(errors), world, "\n".join("rank %d: %s" % e for e in errors)))
        for p in procs:
            p.join(max(1.0, end - time.monotonic()))
        return [out[r] for r in range(world)]
    finally:
        _stop(procs)
        shutil.rmtree(rdv, ignore_errors=True)
