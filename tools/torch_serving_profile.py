#!/usr/bin/env python3
"""Where a serving step's time goes: deepspeed_tpu_torch on one NVIDIA GPU.

Builds the ragged engine for Llama-3 8B (bf16, random weights from a
seeded generator, the arena of ``chip_smoke.py``), prefills a batch of
prompts (``BATCH`` x ``PROMPT_LEN`` tokens) and decodes greedily
(``DECODE_STEPS`` steps) through ``step_with_budget`` (the serving
frontend's entry point). After a warm-up it runs one prefill window and
one decode window twice: untraced, and under ``torch.profiler``. For each
window it prints one JSON line: the untraced wall time per step, and from
the traced run alone the wall time per step, the device time per step by
kernel class (the port's two kernels, GEMMs, everything else) and the
device's idle share, 1 - device time / wall time of that same traced
window (one stream, so the device time cannot exceed the wall time). The
full per-kernel tables go to ``chiprun_out/torch_serving_profile.txt``.

Run from the root of a checkout on a machine with one GPU:
``python3 tools/torch_serving_profile.py``.
"""

import json
import os
import sys
import time

import numpy as np

BATCH = 8             # concurrent sequences
PROMPT_LEN = 1024     # tokens per prompt
DECODE_STEPS = 16     # greedy decode steps in the decode window


def _classify(name: str) -> str:
    low = name.lower()
    if "paged_attn_kernel" in name:
        return "paged_attention (K2)"
    if "flash_fwd_kernel" in name:
        return "flash_attention_fwd (K1)"
    if any(s in low for s in ("gemm", "cutlass", "nvjet", "sm90_xmma",
                              "cublas")):
        return "gemm (cuBLAS)"
    if "memcpy" in low or "memset" in low:
        return "memcpy/memset"
    return "other (elementwise, norms, rope, index_put, sampling)"


def _window(prof, wall_s: float, untraced_s: float, steps: int,
            tokens: int, label: str):
    from torch.autograd import DeviceType
    by_class = {}
    rows = []
    for avg in prof.key_averages():
        # device-side activities only: a CPU op (aten::mm) also reports
        # the device time of the kernels it launched
        if avg.device_type != DeviceType.CUDA:
            continue
        dev_us = avg.self_device_time_total
        if dev_us <= 0:
            continue
        rows.append((dev_us, avg.count, avg.key))
        cls = _classify(avg.key)
        by_class[cls] = by_class.get(cls, 0.0) + dev_us
    device_s = sum(by_class.values()) / 1e6
    rows.sort(reverse=True)
    return {"window": label, "steps": steps, "tokens": tokens,
            "wall_ms_per_step": 1e3 * wall_s / steps,
            "untraced_wall_ms_per_step": 1e3 * untraced_s / steps,
            "device_ms_per_step": 1e3 * device_s / steps,
            "idle_share": 1.0 - device_s / wall_s,
            "device_ms_per_step_by_class": {
                k: v / 1e3 / steps for k, v in sorted(
                    by_class.items(), key=lambda kv: -kv[1])}}, rows


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("torch_serving_profile: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    from deepspeed_tpu_torch import RaggedInferenceEngine, llama3_config
    from torch.profiler import ProfilerActivity, profile

    cfg = llama3_config("8b")
    eng = RaggedInferenceEngine(
        cfg, {"dtype": "bfloat16", "num_blocks": 512, "block_size": 128,
              "max_seq_len": 4096, "max_batch_tokens": 2048,
              "prefill_chunk": 256},
        generator=torch.Generator(device="cuda").manual_seed(0))
    rng = np.random.default_rng(0)
    smi = os.popen("nvidia-smi --query-gpu=name,power.limit "
                   "--format=csv,noheader").read().strip()

    def prompts(base):
        return {base + i: rng.integers(0, cfg.vocab_size,
                                       size=PROMPT_LEN).astype(np.int32)
                for i in range(BATCH)}

    def run(feed):
        """Queue ``feed`` ({uid: tokens}) and step until it is consumed;
        returns ({uid: next token}, steps)."""
        eng.scheduler.put(list(feed), list(feed.values()))
        nxt, steps = {}, 0
        while True:
            out = eng.step_with_budget(mode=("argmax",))
            if out is None:
                return nxt, steps
            nxt.update(out)
            steps += 1

    def prefill(base):
        return run(prompts(base))

    def decode(cur, steps):
        for _ in range(steps):
            cur, _ = run({u: [t] for u, t in cur.items()})
        return cur

    def flush_all():
        for u in list(eng.state.seqs):
            eng.flush(u)

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    # warm-up (kernel build, cuBLAS heuristics, allocator), then each
    # window untraced, and traced: the traced window gives both the wall
    # time and the device time of the idle share
    cur, _ = prefill(0)
    decode(cur, 3)
    flush_all()
    (cur, steps_p), bare_p = timed(lambda: prefill(100))
    _, bare_d = timed(lambda: decode(cur, DECODE_STEPS))
    flush_all()
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts) as prof_p:
        (cur, _), wall_p = timed(lambda: prefill(200))
    with profile(activities=acts) as prof_d:
        _, wall_d = timed(lambda: decode(cur, DECODE_STEPS))
    flush_all()

    res_p, rows_p = _window(prof_p, wall_p, bare_p, steps_p,
                            BATCH * PROMPT_LEN, "prefill")
    res_d, rows_d = _window(prof_d, wall_d, bare_d, DECODE_STEPS,
                            BATCH * DECODE_STEPS, "decode")
    for res in (res_p, res_d):
        res.update(card=smi, batch=BATCH, prompt_len=PROMPT_LEN)
        print(json.dumps(res), flush=True)
    os.makedirs("chiprun_out", exist_ok=True)
    with open("chiprun_out/torch_serving_profile.txt", "w") as f:
        for label, rows in (("prefill", rows_p), ("decode", rows_d)):
            f.write(f"== {label} ({smi}) device us, calls, kernel\n")
            for dev_us, count, key in rows[:40]:
                f.write(f"{dev_us:12.1f} {count:7d}  {key[:150]}\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
