#!/usr/bin/env python3
"""Where a serving step's time goes: deepspeed_tpu_torch on one NVIDIA GPU.

Builds the ragged engine for one model of ``MODELS`` (bf16, random
weights from a seeded generator, the arena of ``chip_smoke.py``),
prefills a batch of prompts (``batch`` x ``prompt`` tokens) and decodes
greedily through ``step_with_budget`` (the serving frontend's entry
point): ``decode`` steps one at a time (the stepwise window), then one
decode megastep of as many tokens a row, ``step_with_budget(max_steps=
decode)``: one window of ``decode`` replays of the captured decode step,
with one upload and one fetch. After a warm-up (which also captures the decode
step) it runs the prefill window and the two decode windows twice:
untraced, and under ``torch.profiler``. For each window it prints one JSON
line: the untraced wall time per step, and from the traced run alone the
wall time per step, the device time per step by class and the device's
idle share, 1 - device time / wall time of that same traced window (one
stream, so the device time cannot exceed the wall time). A decode step
emits one token a row, so the two decode lines compare the same tokens. The full per-kernel tables go to
``chiprun_out/torch_serving_profile_<model>.txt``.

Models: ``llama3-8b`` (the default: 8 prompts of 1024 tokens, 16 decode
steps) and ``mixtral-16L`` (Mixtral 8x7B at full width and 16 of its 32
layers: 8 prompts of 256 tokens, so the prefill window is ONE step of
2048 tokens through the dropless FFN, then 16 decode steps through the
capacity FFN); ``qwen1.5-moe`` (Qwen1.5-MoE-A2.7B, full, the same
windows); ``mixtral-32L-int8`` (Mixtral 8x7B at full width and all 32
layers, which fits one card only quantized: 2 prompts of 256 tokens, so
the prefill window is ONE 512-token step, then 4 decode steps, both
through the capacity FFN's quantized experts).

``--quant`` takes one or more of ``none`` (the engine dtype, the
default), ``int8``, ``fp8``, ``int4``, ``fp6``: each is profiled in turn
in the same process (an engine at a time, its weights drawn quantized by
``weight_quant``), so a bf16 and a quantized decode are compared within
one run on one card.

Classes: the port's kernels by name (K1, K2, the grouped GEMMs K4a
gate_up and K4b/c down in every form, as ``ops/grouped_matmul.kernel_entry``
names them, the
quantized matmuls K5a (int8/fp8), K5b (int4/fp6, dense and batched) and
K5c (the batched int8/fp8 experts): the format from the instantiation's
name, K5c from a profiler label this tool puts around ``qmatmul_batched``),
cuBLAS GEMMs by name, and for MoE models the rest of
each FFN path by the code that launched it (the capacity layer's einsums,
gating and combine; the dropless layer's routing, dispatch and combine),
read from two profiler labels this tool puts around the two MoE layers.

Run from the root of a checkout on a machine with one GPU:
``python3 tools/torch_serving_profile.py [--model mixtral-16L]
[--quant none int8]``.
"""

import json
import os
import re
import sys
import time

import numpy as np

#: model → (preset family, size, overrides, arena pages, batch, prompt
#: tokens, decode steps in the decode window, tokens per step)
MODELS = {
    "llama3-8b": ("llama3", "8b", {}, 512, 8, 1024, 16, 2048),
    "mixtral-16L": ("mixtral", "8x7b", {"num_layers": 16}, 512, 8, 256, 16,
                    2048),
    "qwen1.5-moe": ("qwen2_moe", "a2.7b", {}, 128, 8, 256, 16, 2048),
    "mixtral-32L-int8": ("mixtral", "8x7b", {}, 256, 2, 256, 4, 512),
}
#: the models a bf16 tree of does not fit one 80 GB card
_QUANT_ONLY = {"mixtral-32L-int8"}
_CAP, _DROP = "dstt::moe_capacity", "dstt::moe_dropless"
_QBATCHED = "dstt::qmatmul_batched"
_K5A, _K5C = "quantized matmul (K5a)", "quantized matmul batched (K5c)"


#: K4's two kernels by entry point, which ``grouped_matmul.kernel_entry``
#: reads off a kernel's name (every form)
_K4 = {"grouped_gate_up": "grouped gate_up (K4a)",
       "grouped_down": "grouped down (K4b/c)"}


def _classify(name: str) -> str:
    from deepspeed_tpu_torch.ops.grouped_matmul import kernel_entry
    low = name.lower()
    m = re.search(r"qmm_(?:fma|splitk|wgmma)_kernel<(\d)", name)
    if m:
        # the template's format, its first parameter: 0 int8, 1 fp8, 2
        # int4, 3 fp6 (an int8/fp8 launch under the qmatmul_batched label
        # is K5c, see _window); the form (FMA, split-K at decode, wgmma at
        # prefill) is in the kernel's name in the per-kernel table
        return "quantized matmul packed (K5b)" if m.group(1) in "23" \
            else _K5A
    if "paged_attn_" in name:
        # every form: paged_attn_kernel (fma), paged_attn_split_kernel,
        # paged_attn_mma_kernel
        return "paged_attention (K2)"
    if "flash_fwd_" in name:
        return "flash_attention_fwd (K1)"
    entry = kernel_entry(name)
    if entry in _K4:
        return _K4[entry]
    if any(s in low for s in ("gemm", "cutlass", "nvjet", "sm90_xmma",
                              "cublas")):
        return "gemm (cuBLAS)"
    if "memcpy" in low or "memset" in low:
        return "memcpy/memset"
    return "other (elementwise, norms, rope, index_put, sampling)"


def _window(prof, wall_s: float, untraced_s: float, steps: int,
            tokens: int, label: str):
    """Device time by class over the traced window. Kernels launched
    inside one of the two MoE labels (except the grouped GEMMs and the
    quantized matmuls) go to that FFN path's class; K5a kernels inside the
    qmatmul_batched label's device-side ranges go to K5c; the labels' own
    ranges are not counted, as they span kernels counted already."""
    from torch.autograd import DeviceType
    events = prof.events()
    by_class, per_kernel = {}, {}
    for e in events:
        if e.device_type != DeviceType.CUDA or \
                e.name in (_CAP, _DROP, _QBATCHED):
            continue
        dur = e.time_range.end - e.time_range.start
        cls = _classify(e.name)
        by_class[cls] = by_class.get(cls, 0.0) + dur
        n, c = per_kernel.get(e.name, (0.0, 0))
        per_kernel[e.name] = (n + dur, c + 1)
    # K5 launches through ctypes, which links them to no CPU op; the
    # label's device-side range spans them, so K5a kernels inside a
    # qmatmul_batched range are K5c
    spans = [(e.time_range.start, e.time_range.end) for e in events
             if e.device_type == DeviceType.CUDA and e.name == _QBATCHED]
    for e in events:
        if e.device_type == DeviceType.CUDA and _classify(e.name) == _K5A \
                and any(a <= e.time_range.start < b for a, b in spans):
            dur = e.time_range.end - e.time_range.start
            by_class[_K5A] -= dur
            by_class[_K5C] = by_class.get(_K5C, 0.0) + dur
    moved = {_CAP: 0.0, _DROP: 0.0}
    for e in events:
        if e.device_type != DeviceType.CPU or not e.kernels:
            continue
        a = e
        while a is not None and a.name not in moved:
            a = a.cpu_parent
        if a is None:
            continue
        for k in e.kernels:
            cls = _classify(k.name)
            if cls.startswith(("grouped", "quantized")):
                continue
            by_class[cls] = by_class.get(cls, 0.0) - k.duration
            moved[a.name] += k.duration
    by_class["capacity FFN (einsums, gating, combine)"] = moved[_CAP]
    by_class["dropless FFN around K4 (routing, dispatch, combine)"] = \
        moved[_DROP]
    by_class = {k: v for k, v in by_class.items() if v > 0}
    device_s = sum(by_class.values()) / 1e6
    rows = sorted(((v[0], v[1], k) for k, v in per_kernel.items()),
                  reverse=True)
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
    import argparse
    from torch.profiler import record_function
    from deepspeed_tpu_torch import RaggedInferenceEngine
    from deepspeed_tpu_torch.models import (llama3_config, mixtral_config,
                                            qwen2_moe_config)
    from deepspeed_tpu_torch.parallel import moe

    ap = argparse.ArgumentParser()
    ap.add_argument("--model", choices=sorted(MODELS), default="llama3-8b")
    ap.add_argument("--quant", nargs="+", default=["none"],
                    choices=["none", "int8", "fp8", "int4", "fp6"])
    args = ap.parse_args()
    model = args.model
    if model in _QUANT_ONLY and "none" in args.quant:
        ap.error(f"{model} fits one card only quantized: pass --quant")
    family, size, over, blocks, batch, prompt_len, decode_steps, \
        step_tokens = MODELS[model]
    cfg = {"llama3": llama3_config, "mixtral": mixtral_config,
           "qwen2_moe": qwen2_moe_config}[family](size, **over)
    # label the two MoE layers (before the engine binds them) so their
    # kernels can be told from the attention's, and the batched quantized
    # matmul so K5c can be told from K5a
    for fn, tag in (("moe_layer", _CAP), ("dropless_moe_layer", _DROP),
                    ("qmatmul_batched", _QBATCHED)):
        def labelled(*a, _f=getattr(moe, fn), _t=tag, **kw):
            with record_function(_t):
                return _f(*a, **kw)
        setattr(moe, fn, labelled)
    smi = os.popen("nvidia-smi --query-gpu=name,power.limit "
                   "--format=csv,noheader").read().strip()
    for quant in args.quant:
        _profile(RaggedInferenceEngine, cfg, model, quant, smi, blocks,
                 batch, prompt_len, decode_steps, step_tokens)
        torch.cuda.empty_cache()
    return 0


def _profile(engine_cls, cfg, model, quant, smi, blocks, batch, prompt_len,
             decode_steps, step_tokens) -> None:
    """Build one engine (``quant`` "none": the engine dtype), warm it up,
    then time and trace one prefill window, one stepwise decode window and
    one megastep window; prints their lines and writes the per-kernel
    tables."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.reset_peak_memory_stats()
    eng = engine_cls(
        cfg, {"dtype": "bfloat16", "num_blocks": blocks, "block_size": 128,
              "max_seq_len": 4096, "max_batch_tokens": step_tokens,
              "prefill_chunk": 256,
              "weight_quant": None if quant == "none" else quant},
        generator=torch.Generator(device="cuda").manual_seed(0))
    rng = np.random.default_rng(0)

    def prompts(base):
        return {base + i: rng.integers(0, cfg.vocab_size,
                                       size=prompt_len).astype(np.int32)
                for i in range(batch)}

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

    def mega(cur):
        """Feed each row's token and run ONE megastep of ``decode_steps``
        tokens a row; returns {uid: its last token}."""
        eng.scheduler.put(list(cur), [[t] for t in cur.values()])
        out = eng.step_with_budget(mode=("argmax",), max_steps=decode_steps)
        assert sorted(out) == sorted(cur) and all(
            len(t) == decode_steps for t in out.values()), out
        return {u: t[-1] for u, t in out.items()}

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
    mega(decode(cur, 3))               # captures the decode step
    flush_all()
    (cur, steps_p), bare_p = timed(lambda: prefill(100))
    cur, bare_d = timed(lambda: decode(cur, decode_steps))
    _, bare_m = timed(lambda: mega(cur))
    flush_all()
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts) as prof_p:
        (cur, _), wall_p = timed(lambda: prefill(200))
    with profile(activities=acts) as prof_d:
        cur, wall_d = timed(lambda: decode(cur, decode_steps))
    with profile(activities=acts) as prof_m:
        _, wall_m = timed(lambda: mega(cur))
    flush_all()

    res_p, rows_p = _window(prof_p, wall_p, bare_p, steps_p,
                            batch * prompt_len, "prefill")
    res_d, rows_d = _window(prof_d, wall_d, bare_d, decode_steps,
                            batch * decode_steps, "decode")
    res_m, rows_m = _window(prof_m, wall_m, bare_m, decode_steps,
                            batch * decode_steps, "decode_megastep")
    res_m["graphs"] = dict(eng.graph_stats)
    for res in (res_p, res_d, res_m):
        res.update(card=smi, model=model, weight_quant=quant, batch=batch,
                   prompt_len=prompt_len,
                   peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
        print(json.dumps(res), flush=True)
    os.makedirs("chiprun_out", exist_ok=True)
    name = model if quant == "none" else f"{model}_{quant}"
    with open(f"chiprun_out/torch_serving_profile_{name}.txt", "w") as f:
        for label, rows in (("prefill", rows_p), ("decode", rows_d),
                            ("decode_megastep", rows_m)):
            f.write(f"== {label} ({smi}) device us, calls, kernel\n")
            for dev_us, count, key in rows[:40]:
                f.write(f"{dev_us:12.1f} {count:7d}  {key[:150]}\n")
    del eng


if __name__ == "__main__":
    sys.exit(main())
