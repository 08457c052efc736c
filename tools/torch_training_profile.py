#!/usr/bin/env python3
"""Where a training step's time goes: deepspeed_tpu_torch on one NVIDIA GPU.

Builds a training engine through ``initialize``: by default (``--model
llama3-1b``) the one of ``chip_smoke.py`` phase 7 (Llama-3 1B, tied head,
bf16, random weights from a seeded generator; micro batch 4 x gas 2 x
2048 tokens, AdamW, clip 1.0, remat none, attention "auto"); with
``--model moe-1b-8e`` the MoE training phase's (the repo's MoE bench
model, 12 layers, 8 experts top-2, dropless; micro batch 8 x 2048
tokens, gas 1, chunked CE at 256 MB with bf16 logits). It warms up and
runs ``STEPS`` ``train_batch`` steps twice on one fixed batch: untraced,
and under ``torch.profiler``. It prints one JSON line: the untraced wall
time per step and, from the traced window alone, the wall time per step,
the device time per step by class and the device's idle share, 1 -
device time / wall time of that same window (one stream, so the device
time cannot exceed the wall time).

Classes: the port's kernels by name (K1 ``flash_fwd_*``, K3
``flash_bwd_*``: its delta pre-pass, dq and dk/dv kernels; the grouped
kernels by entry point, gate_up (K4a), down (K4b/c), dgdu, dxs and wgrad,
whatever their form, as ``ops/grouped_matmul.kernel_entry`` names them),
cuBLAS GEMMs by name, and the rest by the code that launched it: "ce" for
the chunked cross-entropy's non-GEMM kernels (its forward, its recompute
and the backward of its ops, linked through the autograd sequence
numbers), "moe routing/dispatch/gathers" likewise for the MoE layer's
top-k, aligned dispatch and gathers, "optimizer" for the update pass
(grad scaling, norm, clip, AdamW), and "other" (norms, RoPE, SiLU,
residuals, embedding, grad accumulation, copies). The per-kernel table
goes to ``chiprun_out/torch_training_profile_<model>.txt``.

``--zero-stage 1|2|3`` (the Llama model only) runs the engine at that
ZeRO stage over a one-rank NCCL group (``build_mesh(data=1)``, as
``chip_smoke.py`` phase 12 does), ``--overlap`` with stage 3's
``overlap_comm``; NCCL's kernels then form a class of their own, and the
table goes to ``..._<model>_stage<N>.txt``.

Run from the root of a checkout on a machine with one GPU:
``python3 tools/torch_training_profile.py [--model moe-1b-8e]
[--zero-stage N [--overlap]]``.
"""

import argparse
import json
import os
import sys
import time

import numpy as np

SEQ = 2048
WARMUP, STEPS = 2, 2
_CE, _OPT, _MOE = "dstt::ce", "dstt::optimizer", "dstt::moe_dispatch"
#: profiler label → class of the non-GEMM kernels launched under it (and,
#: for the two with a backward, by the backward of its ops)
_LABELS = {_OPT: "optimizer", _CE: "cross_entropy (non-GEMM)",
           _MOE: "moe routing/dispatch/gathers (non-GEMM)"}
#: the grouped kernels' classes by entry point, which
#: ``grouped_matmul.kernel_entry`` reads off a kernel's name (every form)
_GROUPED = {"grouped_gate_up": "grouped_gate_up (K4a)",
            "grouped_down": "grouped_down (K4b/c)",
            "grouped_dgdu": "grouped_dgdu", "grouped_dxs": "grouped_dxs",
            "grouped_wgrad": "grouped_wgrad"}


def _kernel_class(name: str) -> str:
    from deepspeed_tpu_torch.ops.grouped_matmul import kernel_entry
    low = name.lower()
    entry = kernel_entry(name)
    if entry is not None:
        return _GROUPED[entry]
    if "flash_fwd_" in name:
        return "flash_attention_fwd (K1)"
    if "flash_bwd_" in name:
        return "flash_attention_bwd (K3)"
    if "nccl" in low:
        return "nccl (collectives)"
    if any(s in low for s in ("gemm", "cutlass", "nvjet", "sm90_xmma",
                              "cublas")):
        return "gemm (cuBLAS)"
    if "memcpy" in low or "memset" in low:
        return "memcpy/memset"
    return "rest"


def _breakdown(prof, steps: int):
    """Device microseconds by class, and the per-kernel rows."""
    from torch.autograd import DeviceType
    events = prof.events()
    by_class, rows = {}, {}
    for e in events:
        # the two labels also appear as device-side annotation ranges that
        # span their kernels: counting them would count those kernels twice
        if e.device_type != DeviceType.CUDA or e.name in _LABELS:
            continue
        dur = e.time_range.end - e.time_range.start
        cls = _kernel_class(e.name)
        by_class[cls] = by_class.get(cls, 0.0) + dur
        n, c = rows.get(e.name, (0.0, 0))
        rows[e.name] = (n + dur, c + 1)

    def ancestors(e):
        while e is not None:
            yield e
            e = e.cpu_parent

    cpu = [e for e in events if e.device_type == DeviceType.CPU]
    # forward ops under a label: (thread, sequence number) of their
    # autograd nodes, which the backward's evaluate_function events carry
    # as (fwd_thread, sequence_nr)
    seq = {label: {(e.thread, e.sequence_nr) for e in cpu
                   if e.sequence_nr >= 0
                   and any(a.name == label for a in ancestors(e))}
           for label in _LABELS}
    split = {cls: 0.0 for cls in _LABELS.values()}
    for e in cpu:
        if not e.kernels:
            continue
        anc = list(ancestors(e))
        names = {a.name for a in anc}
        cls = next((c for label, c in _LABELS.items() if label in names or
                    any(a.name.startswith(
                        "autograd::engine::evaluate_function")
                        and (a.fwd_thread, a.sequence_nr) in seq[label]
                        for a in anc)), None)
        if cls is None:
            continue
        split[cls] += sum(k.duration for k in e.kernels
                          if _kernel_class(k.name) == "rest")
    rest = by_class.pop("rest", 0.0)
    by_class.update(split)
    by_class["other (norms, rope, silu, residuals, embedding, grad acc)"] = \
        rest - sum(split.values())
    per_step = {k: v / 1e3 / steps for k, v in sorted(
        by_class.items(), key=lambda kv: -kv[1])}
    return per_step, sorted(((v[0], v[1], k) for k, v in rows.items()),
                            reverse=True)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("torch_training_profile: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    from torch.profiler import ProfilerActivity, profile, record_function
    from deepspeed_tpu_torch import build_mesh, comm, initialize, llama3_config
    from deepspeed_tpu_torch.models import transformer
    from deepspeed_tpu_torch.models.mixtral import mixtral_config
    from deepspeed_tpu_torch.ops import grouped_matmul as gmm
    from deepspeed_tpu_torch.parallel import moe

    ap = argparse.ArgumentParser()
    ap.add_argument("--model", choices=("llama3-1b", "moe-1b-8e"),
                    default="llama3-1b")
    ap.add_argument("--zero-stage", type=int, choices=(0, 1, 2, 3),
                    default=0)
    ap.add_argument("--overlap", action="store_true")
    args = ap.parse_args()
    conf = {"optimizer": {"type": "adamw",
                          "params": {"lr": 1e-4, "weight_decay": 0.1}},
            "gradient_clipping": 1.0, "bf16": {"enabled": True},
            "activation_checkpointing": {"policy": "none"},
            "attention_impl": "auto"}
    if args.model == "llama3-1b":
        micro, gas = 4, 2
        cfg = llama3_config("1b", max_seq_len=SEQ, tie_embeddings=True)
    else:
        # the model and config of chip_smoke.py's MoE training phase
        micro, gas = 8, 1
        cfg = mixtral_config(
            "tiny", hidden_size=1024, num_layers=12, num_heads=8,
            num_kv_heads=4, intermediate_size=2816, num_experts=8,
            num_experts_per_tok=2, vocab_size=32000, max_seq_len=SEQ,
            tie_embeddings=True)
        conf.update(moe={"impl": "dropless"}, chunked_ce_budget_mb=256,
                    ce_logits_dtype="bf16")
    conf.update(train_micro_batch_size_per_gpu=micro,
                gradient_accumulation_steps=gas)
    mesh, tag = None, args.model
    if args.zero_stage:
        import tempfile
        store = tempfile.mkdtemp(prefix="profile_")
        comm.init_distributed(init_method=f"file://{store}/nccl",
                              num_processes=1, process_id=0)
        mesh = build_mesh(data=1)
        conf["zero_optimization"] = {"stage": args.zero_stage,
                                     "overlap_comm": args.overlap}
        tag += f"_stage{args.zero_stage}" + ("_overlap" if args.overlap
                                             else "")
    eng, _, _, _ = initialize(cfg, conf, generator=torch.Generator(
        device="cuda").manual_seed(0), mesh=mesh)
    smi = os.popen("nvidia-smi --query-gpu=name,power.limit "
                   "--format=csv,noheader").read().strip()

    # label the CE chunks, the MoE routing/dispatch/gathers and the update
    # pass for the profiler
    def traced(label, fn):
        def run(*a, **kw):
            with record_function(label):
                return fn(*a, **kw)
        return run

    transformer._ce_chunk = traced(_CE, transformer._ce_chunk)
    eng._apply_update = traced(_OPT, eng._apply_update)
    moe.topk_gates_t = traced(_MOE, moe.topk_gates_t)
    for name in ("aligned_dispatch", "gather_rows", "gather_sum"):
        setattr(gmm, name, traced(_MOE, getattr(gmm, name)))

    rng = np.random.default_rng(7)
    batch = [{"input_ids": rng.integers(0, cfg.vocab_size, size=(micro, SEQ))
              .astype(np.int32)} for _ in range(gas)]

    def steps(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            eng.train_batch(iter(batch))
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    steps(WARMUP)
    bare = steps(STEPS)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        wall = steps(STEPS)
    per_class, rows = _breakdown(prof, STEPS)
    device_ms = sum(per_class.values())
    tokens = micro * gas * SEQ
    print(json.dumps({
        "window": "train_batch", "card": smi, "model": args.model,
        "zero_stage": args.zero_stage, "overlap": args.overlap,
        "dtype": "bfloat16", "micro_batch": micro, "gas": gas, "seq": SEQ,
        "steps": STEPS, "tokens_per_step": tokens,
        "wall_ms_per_step": 1e3 * wall / STEPS,
        "untraced_wall_ms_per_step": 1e3 * bare / STEPS,
        "untraced_tokens_per_s": tokens * STEPS / bare,
        "device_ms_per_step": device_ms,
        "idle_share": 1.0 - device_ms / (1e3 * wall / STEPS),
        "device_ms_per_step_by_class": per_class}), flush=True)
    os.makedirs("chiprun_out", exist_ok=True)
    with open(f"chiprun_out/torch_training_profile_{tag}.txt", "w") as f:
        f.write(f"== train_batch x {STEPS} ({smi}) device us, calls, "
                f"kernel\n")
        for dev_us, count, key in rows[:60]:
            f.write(f"{dev_us:12.1f} {count:7d}  {key[:150]}\n")
    if args.zero_stage:
        comm.destroy_distributed()
    return 0


if __name__ == "__main__":
    sys.exit(main())
