"""Can two ranks share one card over gloo?

Spawns two processes on ``cuda:0``, forms a gloo group over a file store
and tries, on CUDA tensors, each collective that the tensor-parallel path
and the quantized ZeRO++ collectives call: ``all_reduce`` (sum, max),
``all_gather_into_tensor``, ``all_to_all_single``, ``broadcast`` and
``reduce_scatter_tensor``. Each result is checked against the value the
collective must give, and a 16 MiB bf16 ``all_reduce`` is timed. Prints
one JSON line per rank and, last, ``{"probe": {...}}`` with the outcome.

    python3 tools/gloo_cuda_probe.py
"""

import json
import os
import sys
import tempfile
import time

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def _try(name, fn, out):
    try:
        ok = bool(fn())
        out[name] = "ok" if ok else "wrong result"
    except Exception as e:                      # noqa: BLE001 - a probe
        out[name] = f"{type(e).__name__}: {str(e)[:160]}"


def _rank(rank, world, store, q):
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            world_size=world, rank=rank)
    dev = torch.device("cuda", 0)
    res = {}

    def allreduce_sum():
        x = torch.full((1024,), float(rank + 1), device=dev)
        dist.all_reduce(x)
        return torch.all(x == sum(range(1, world + 1))).item()

    def allreduce_max():
        x = torch.full((1024,), float(rank + 1), device=dev)
        dist.all_reduce(x, op=dist.ReduceOp.MAX)
        return torch.all(x == world).item()

    def all_gather():
        x = torch.full((4,), float(rank), device=dev)
        out = torch.empty(4 * world, device=dev)
        dist.all_gather_into_tensor(out, x)
        return torch.equal(out.cpu(), torch.arange(world).repeat_interleave(
            4).float())

    def all_to_all():
        x = torch.arange(world, device=dev, dtype=torch.float32) \
            + 10 * rank
        out = torch.empty_like(x)
        dist.all_to_all_single(out, x)
        return torch.equal(out.cpu(), torch.arange(world).float() * 10
                           + rank)

    def broadcast():
        x = torch.full((8,), float(rank + 5), device=dev)
        dist.broadcast(x, 0)
        return torch.all(x == 5).item()

    def reduce_scatter():
        x = torch.ones(4 * world, device=dev)
        out = torch.empty(4, device=dev)
        dist.reduce_scatter_tensor(out, x)
        return torch.all(out == world).item()

    for name, fn in [("all_reduce_sum", allreduce_sum),
                     ("all_reduce_max", allreduce_max),
                     ("all_gather_into_tensor", all_gather),
                     ("all_to_all_single", all_to_all),
                     ("broadcast", broadcast),
                     ("reduce_scatter_tensor", reduce_scatter)]:
        _try(name, fn, res)
        dist.barrier()
    if res["all_reduce_sum"] == "ok":
        x = torch.ones(8 << 20, dtype=torch.bfloat16, device=dev)
        for _ in range(2):
            dist.all_reduce(x)
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(5):
            dist.all_reduce(x)
        torch.cuda.synchronize()
        res["all_reduce_16MiB_bf16_ms"] = (time.perf_counter() - t) / 5 * 1e3
    q.put((rank, res))
    dist.destroy_process_group()


def main():
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    world = 2
    with tempfile.TemporaryDirectory() as d:
        ctx = mp.get_context("spawn")
        q = ctx.Queue()
        procs = [ctx.Process(target=_rank,
                             args=(r, world, os.path.join(d, "store"), q))
                 for r in range(world)]
        for p in procs:
            p.start()
        got = {}
        deadline = time.time() + 240
        while len(got) < world and time.time() < deadline:
            try:
                r, res = q.get(timeout=5)
                got[r] = res
            except Exception:                   # noqa: BLE001 - queue.Empty
                if not any(p.is_alive() for p in procs):
                    break
        for p in procs:
            p.join(timeout=10)
            if p.is_alive():
                p.kill()
    for r in sorted(got):
        print(json.dumps({"rank": r, **got[r]}))
    names = ("all_reduce_sum", "all_reduce_max", "all_gather_into_tensor",
             "all_to_all_single", "broadcast", "reduce_scatter_tensor")
    outcome = {n: all(got.get(r, {}).get(n) == "ok" for r in range(world))
               for n in names}
    print(json.dumps({"probe": {"world": world, "ranks_reported": len(got),
                                "card": torch.cuda.get_device_name(0),
                                **outcome}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
