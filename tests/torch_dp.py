"""Spawn ranks of the port over gloo for the data-parallel tests.

:func:`spawn` starts ``world`` processes (the ``spawn`` start method:
each a fresh interpreter), forms a gloo group over a ``file://`` store in
a temporary directory (no TCP port, so the suite's xdist workers cannot
clash), sets one torch thread in each, and runs ``fn(rank, world,
**kwargs)`` from :mod:`torch_dp_workers` there. It returns every rank's
result, raises the first rank's exception with its traceback, and kills
all ranks when they are not done within ``timeout`` seconds, so a hang
fails one test instead of the suite.
"""

import multiprocessing as mp
import os
import pickle
import tempfile
import time
import traceback


def _main(name, rank, world, store, out, kwargs):
    import torch
    torch.set_num_threads(1)
    import torch_dp_workers
    from deepspeed_tpu_torch import comm
    try:
        comm.init_distributed(init_method="file://" + store,
                              num_processes=world, process_id=rank,
                              device="cpu", timeout=150)
        res = ("ok", getattr(torch_dp_workers, name)(rank, world, **kwargs))
    except BaseException:                       # noqa: BLE001 — reported
        res = ("error", traceback.format_exc())
    with open(out, "wb") as fh:
        pickle.dump(res, fh)
    comm.destroy_distributed()


def spawn(name: str, world: int, timeout: float = 180.0, **kwargs):
    """Run ``torch_dp_workers.<name>`` on ``world`` gloo ranks; returns
    the list of their results."""
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory() as tmp:
        store = os.path.join(tmp, "store")
        outs = [os.path.join(tmp, f"rank{r}.pkl") for r in range(world)]
        procs = [ctx.Process(target=_main, args=(name, r, world, store,
                                                 outs[r], kwargs))
                 for r in range(world)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        for p in procs:
            p.join(max(0.0, deadline - time.monotonic()))
        hung = [r for r, p in enumerate(procs) if p.is_alive()]
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        if hung:
            raise TimeoutError(f"{name} at world {world}: ranks {hung} "
                               f"not done within {timeout} s")
        results, errors = [], []
        for r, path in enumerate(outs):
            if not os.path.exists(path):
                errors.append(f"rank {r} exited with code "
                              f"{procs[r].exitcode} and no result")
                continue
            with open(path, "rb") as fh:
                status, value = pickle.load(fh)
            if status != "ok":
                errors.append(f"rank {r} failed:\n{value}")
            results.append(value)
        if errors:
            raise RuntimeError(f"{name} at world {world}:\n"
                               + "\n".join(errors))
        return results
