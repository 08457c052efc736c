#!/usr/bin/env python3
"""What holds paged attention (K2, ``deepspeed_tpu_torch/ops/csrc/
paged_attention.cu``) on one NVIDIA GPU: its split form at decode shapes
under variants of the source and of the plan, and its mma form at the
split-prefill history's shapes. Every time is device time a call from a
CUDA graph of calls (``chip_smoke.graph_time_ms``: no host cost), bf16,
Llama-3 8B's heads (32 q / 8 kv, dh 128, pages of 128) unless a case says
otherwise; each result is held against ``paged_attention_ref`` on the
rows that see a key (``chip_smoke.TOL_BF16_ROW``).

Source variants, each the checked-in source with one text patch, built by
``nvcc`` into its own library under ``build/variants/paged_attention/``:

- ``base``: the source as it is (a 3-stage K/V ring in bf16);
- ``ring2``, ``ring4``: a 2- or 4-stage ring (3 or 1 blocks a SM fit).

Decode cases (split form, one new token a row, a page table 4096 keys
wide as the engine's at max_seq_len 4096): ``serve_n8`` / ``serve_n16``
(8 or 16 rows of ~1040 keys: the serving profile's decode), ``long_n16``
(ctx 1-4000), ``long_n8``, ``long_g1`` (16 rows, Qwen1.5-MoE's heads,
16 q / 16 kv), ``empty_n8`` (ctx 1: the launch's fixed cost).

Plan variants of ``base`` (no rebuild): ``SPLIT_BLOCKS_PER_SM`` 2, 8 and
16 (the plan's is 4) at the decode cases; one split (``nosplit``: each
block walks all its keys, no combine) at 8 rows of 64-1024 keys, which
gives a lone block's time a 64-key tile; the mma form on the
history-only read at the serving profile's chunk (8 rows of 256 queries,
histories of 256, 512 or 768 keys each, and 0/256/512/768 mixed), with its
TFLOP/s.

Run from the root of a checkout on a machine with one GPU:
``python3 tools/paged_attention_variants.py``; one JSON line a (variant,
case), also written to ``paged_attention_variants.jsonl`` in the
checkout's output directory.
"""

import json
import os
import shutil
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
_RING = "static constexpr int kStages = sizeof(T) == 2 ? 3 : 2;"
SOURCES = {"base": None, "ring2": _RING.replace("? 3", "? 2"),
           "ring4": _RING.replace("? 3", "? 4")}
HEADS = (32, 8, 128, 128)                     # H, KvH, dh, bs


def _use_source(op_builder, name: str, patch, csrc: Path,
                build: Path) -> None:
    """Point the builder at a patched copy of the sources ``csrc`` (or, with
    no patch, at them and their build directory ``build``) and build
    paged_attention there."""
    if patch is None:
        op_builder.CSRC, op_builder.BUILD_DIR = csrc, build
    else:
        root = HERE / "build" / "variants" / "paged_attention" / name
        shutil.rmtree(root, ignore_errors=True)
        shutil.copytree(csrc, root / "csrc")
        src = root / "csrc" / "paged_attention.cu"
        text = src.read_text()
        assert text.count(_RING) == 1, "the ring's line moved"
        src.write_text(text.replace(_RING, patch))
        op_builder.CSRC = root / "csrc"
        op_builder.BUILD_DIR = root / "kernels"
    op_builder._LIBS.pop("paged_attention", None)
    op_builder.build_all(["paged_attention"])


def _set_blocks_per_sm(pa, b: float) -> None:
    pa.SPLIT_BLOCKS_PER_SM = b
    pa.SPLIT_COUNTERS = max(1, int(b * pa.NUM_SMS))
    pa.SPLIT_WORKSPACE = 2 * 16 * pa.NUM_SMS * pa.SPLIT_MAX_ROWS * (128 + 1)
    pa._SPLIT_BUFFERS.clear()
    pa.plan.cache_clear()


def main() -> int:
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("paged_attention_variants: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(HERE))
    import chip_smoke as cs
    from deepspeed_tpu_torch.ops import op_builder
    from deepspeed_tpu_torch.ops import paged_attention as pa
    checked_in = (op_builder.CSRC, op_builder.BUILD_DIR)
    card = os.popen("nvidia-smi --query-gpu=name,power.limit "
                    "--format=csv,noheader").read().strip()
    dev = torch.device("cuda")
    bf16 = torch.bfloat16

    def run(variant, case, n, c, starts, counts, heads=HEADS, mb=32):
        h, kvh, dh, bs = heads
        rng = np.random.default_rng(0)
        q, ak, av, (pt, st, ct), _ = cs._paged_case(
            rng, n, c, h, kvh, dh, bs, starts, counts, bf16, dev, mb=mb)
        pl = pa.plan(n, c, h, kvh, dh, bs, pt.shape[1], bf16)
        fn = lambda _: pa.paged_attention_with_lse(q, ak, av, pt, st, ct)
        out, _ = fn(None)
        ref, _ = pa.paged_attention_ref(q, ak, av, pt, st, ct, with_lse=True)
        j = torch.arange(c, device=dev)[None]
        seen = torch.minimum(st.long()[:, None] + j + 1,
                             (st + ct).long()[:, None]) > 0
        rows = seen[:, :, None].expand(n, c, h)
        err = cs._row_rel_err(out[rows], ref[rows])
        assert err <= cs.TOL_BF16_ROW, (variant, case, err)
        ms = cs.graph_time_ms(fn, [None])
        vis = sum(min(s + jj + 1, s + k) for s, k in zip(starts, counts)
                  for jj in range(c))
        res = {"variant": variant, "case": case, "card": card,
               "form": pl.form, "splits": pl.splits, "device_ms": ms,
               "tflops": 4.0 * dh * h * vis / ms / 1e9,
               "row_rel_err": err}
        print(json.dumps(res), flush=True)
        results.append(res)

    results = []
    rng = np.random.default_rng(5)
    long16 = [1, 4000] + [int(x) for x in rng.integers(2, 4001, size=14)]
    long8 = [int(x) for x in rng.integers(1, 4001, size=8)]
    serve = [1030 + i for i in range(16)]
    decode = (("serve_n8", 8, serve[:8], HEADS),
              ("serve_n16", 16, serve, HEADS),
              ("long_n16", 16, long16, HEADS),
              ("long_n8", 8, long8, HEADS),
              ("long_g1", 16, long16, (16, 16, 128, 128)),
              ("empty_n8", 8, [1] * 8, HEADS))
    for name, patch in SOURCES.items():
        _use_source(op_builder, name, patch, *checked_in)
        for case, n, ctx, heads in decode:
            run(name, case, n, 1, [x - 1 for x in ctx], [1] * n, heads)
    _use_source(op_builder, "base", None, *checked_in)
    default = pa.SPLIT_BLOCKS_PER_SM
    for b in (2, 8, 16):
        _set_blocks_per_sm(pa, b)
        for case, n, ctx, heads in decode:
            run(f"blocks_per_sm_{b}", case, n, 1, [x - 1 for x in ctx],
                [1] * n, heads)
    _set_blocks_per_sm(pa, 1e-3)                 # one split a row
    for keys in (64, 128, 256, 512, 1024):
        run("nosplit", f"ctx{keys}_n8", 8, 1, [keys - 1] * 8, [1] * 8)
    _set_blocks_per_sm(pa, default)
    for hist in ((256,) * 8, (512,) * 8, (768,) * 8, (0, 256, 512, 768) * 2):
        run("base", "history_" + "_".join(map(str, sorted(set(hist)))), 8,
            256, list(hist), [0] * 8, mb=8)
    os.makedirs(HERE / "chiprun_out", exist_ok=True)
    with open(HERE / "chiprun_out" / "paged_attention_variants.jsonl",
              "w") as f:
        f.writelines(json.dumps(r) + "\n" for r in results)
    return 0


if __name__ == "__main__":
    sys.exit(main())
