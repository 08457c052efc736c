#!/usr/bin/env python3
"""Where the host time of a stepwise decode step goes: deepspeed_tpu_torch
on one NVIDIA GPU.

A stepwise decode step (``step_with_budget`` with ``max_steps=1``, the
serving frontend's default) is bound by the host: the device is idle most
of its wall time, so its wall moves with whatever else the host runs.
This tool measures the host side of that step so that two trees can be
compared by their work, not only by a wall that spreads between calls.

It builds the Llama-3 8B engine of ``torch_serving_profile.py`` (bf16,
random weights from a seeded generator, batch 8, prompts of 1024 tokens),
prefills, and decodes greedily one step at a time, in untraced windows of
16 steps, for the wall time and the process's CPU time a step. Where the
engine has a decode megastep it runs ``CYCLES`` cycles of: a stepwise
window while the engine holds no CUDA graph, one megastep window of 16
tokens (which captures the decode step), a stepwise window while the
graph exists, then the graphs dropped; so the two states alternate within
one process, one pair a cycle. An engine without a megastep runs two
stepwise windows a cycle. Then it runs one window of 16 steps under
``cProfile``: Python calls per step (exact, so a tree that does more host
work shows it) and the cumulative host ms per step of the engine's step,
the forward, the sampler, the page table, the scheduler and the wait in
the result's ``.cpu()`` (cProfile's own overhead is in these ms).

Run from the root of a checkout on a machine with one GPU:
``python3 tools/torch_decode_host_profile.py``. To compare two trees, run
it from the root of each in turns in one call.
"""

import cProfile
import gc
import json
import os
import pstats
import sys
import time

import numpy as np

BATCH, PROMPT, STEPS, CYCLES = 8, 1024, 16, 6
#: cProfile entries reported, by (file suffix, function name); the
#: ``.cpu()`` wait is a built-in method
_FUNCS = {"_run": ("inference/engine_v2.py", "_run"),
          "ragged_forward": ("inference/engine_v2.py", "ragged_forward"),
          "_sample_tokens": ("inference/engine_v2.py", "_sample_tokens"),
          "_page_table": ("inference/engine_v2.py", "_page_table"),
          "next_batch": ("inference/ragged.py", "next_batch"),
          "mark_scheduled": ("inference/ragged.py", "mark_scheduled"),
          "cpu_wait": ("~", "<method 'cpu' of 'torch._C.TensorBase' "
                            "objects>")}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("torch_decode_host_profile: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    from deepspeed_tpu_torch import RaggedInferenceEngine, llama3_config

    smi = os.popen("nvidia-smi --query-gpu=name,power.limit "
                   "--format=csv,noheader").read().strip()
    cfg = llama3_config("8b")
    eng = RaggedInferenceEngine(
        cfg, {"dtype": "bfloat16", "num_blocks": 512, "block_size": 128,
              "max_seq_len": 4096, "max_batch_tokens": 2048,
              "prefill_chunk": 256},
        generator=torch.Generator(device="cuda").manual_seed(0))
    rng = np.random.default_rng(0)

    def run(feed):
        eng.scheduler.put(list(feed), list(feed.values()))
        nxt = {}
        while True:
            out = eng.step_with_budget(mode=("argmax",))
            if out is None:
                return nxt
            nxt.update(out)

    def decode(cur, steps):
        for _ in range(steps):
            cur = run({u: [t] for u, t in cur.items()})
        return cur

    def timed(cur):
        torch.cuda.synchronize()
        w0, c0 = time.perf_counter(), time.process_time()
        cur = decode(cur, STEPS)
        torch.cuda.synchronize()
        return cur, {"wall_ms_per_step": 1e3 * (time.perf_counter() - w0)
                     / STEPS,
                     "cpu_ms_per_step": 1e3 * (time.process_time() - c0)
                     / STEPS}

    cur = run({i: rng.integers(0, cfg.vocab_size, size=PROMPT)
               .astype(np.int32) for i in range(BATCH)})
    cur = decode(cur, 3)                       # warm-up
    megastep = hasattr(eng, "graph_stats")
    cycles = []
    for _ in range(CYCLES):
        cur, plain = timed(cur)
        if not megastep:
            cur, again = timed(cur)
            cycles.append({"no_graph": plain, "no_graph_again": again})
            continue
        eng.scheduler.put(list(cur), [[t] for t in cur.values()])
        out = eng.step_with_budget(mode=("argmax",), max_steps=STEPS)
        cur = {u: t[-1] for u, t in out.items()}
        cur, graphed = timed(cur)
        cycles.append({"no_graph": plain, "graph": graphed})
        # drop the captured step and its pool: the next cycle starts with
        # no graph again
        eng._decode_states.clear()
        eng._graph_pool = None
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    prof = cProfile.Profile()
    torch.cuda.synchronize()
    prof.enable()
    cur = decode(cur, STEPS)
    torch.cuda.synchronize()
    prof.disable()
    stats = pstats.Stats(prof).stats
    calls = sum(v[1] for v in stats.values())
    host = {}
    for key, (suffix, name) in _FUNCS.items():
        host[key] = 1e3 * sum(v[3] for (f, _, n), v in stats.items()
                              if n == name and f.endswith(suffix)) / STEPS
    print(json.dumps({"card": smi, "model": "llama3-8b", "batch": BATCH,
                      "prompt_len": PROMPT, "steps": STEPS,
                      "cycles": cycles,
                      "profiled_python_calls_per_step": calls / STEPS,
                      "profiled_host_ms_per_step": host}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
