#!/usr/bin/env python3
"""Smoke run of deepspeed_tpu_torch on one NVIDIA GPU.

Run from the root of a checkout: ``python3 chip_smoke.py``. It

1. prints the card (``nvidia-smi`` name and power limit);
2. builds the port's CUDA kernels from ``deepspeed_tpu_torch/ops/csrc``
   (the build line gives each flash-attention kernel's registers and
   spilled bytes);
3. holds each kernel against its plain PyTorch version on the card, at the
   serving and training paths' shapes in bf16 (paged attention through the
   serving phase's full-size arena, past element 2**31: its split form at
   decode, n 16 and the dense batch of 8, Qwen1.5-MoE's g 1, a page table
   as wide as max_seq_len so that splits start past ctx, an empty row; its
   mma form on 256-token chunks and the split-prefill history at the
   serving profile's shape; both at bs 16 and the mma form at dh 64; the
   split form on 16-row chunks whose rows end in different splits, in
   bf16 and fp32; each case asserts the form it took), in fp32 at a
   4000-token decode and at small fp32 shapes (flash attention at small
   shapes in
   bf16 too: its tensor-core kernels), and times the kernel, the plain
   version, the card's bound for the same work and, for flash attention,
   ``scaled_dot_product_attention`` (forward, and backward alone) as a
   yardstick (tolerances at ``TOL_F32``); the grouped GEMM kernels of the
   dropless MoE FFN (gate/up, down) in bf16 at the Mixtral 8x7B and
   Qwen1.5-MoE prefill shapes (2048 tokens, a random router) and the
   1B/8e training forward (16,384 tokens), in bf16 at edge shapes on
   their wgmma forms (an empty expert, all rows on one expert, 60
   experts, f off 64 and d off 256, w given and not), on their mma.sync
   forms (d and f off TMA's 8) and in fp32 at small shapes (w given and
   not, an empty expert, all rows on one expert, d and f off the tile and
   off the 16-byte vector), each kernel alone and the whole FFN, with
   ``torch._grouped_mm`` (or a dense matmul of the same rows) as the
   yardstick; and the backward grouped kernels (dgdu with gate/up
   recomputed and saved, dxs, wgrad) in bf16 at the 1B/8e MoE bench's and
   Mixtral 8x7B's training shapes (16,384 and 2,048 tokens, top-2 of 8),
   at the same bf16 edges (the wgmma forms of grouped_dxs and
   grouped_wgrad, scaled and not; an expert with no row gets a zero dW)
   and in fp32 at awkward shapes, each kernel fed the plain version's
   inputs, then the whole backward through autograd (dgdu on its wgmma
   form at every TMA-aligned bf16 edge and at a layout whose 128-row
   blocks each hold two experts' tiles; at the path shapes also its
   mma.sync form, held and timed through the C entry's form argument);
   each line prints the launch plans of gate_up, down, dgdu, dxs and wgrad
   and asserts the form each launched; the weight-only quantized matmuls (K5a int8/fp8, K5b
   int4/fp6, K5c the batched int8/fp8 experts) in bf16 at Llama-3 8B's linears and head
   (decode M 16 and prefill M 2048; the head with fp32 output) in all four
   formats and at Mixtral 8x7B's experts on capacity buffers (G 8, M 16 and
   512), each line with the launch plan (split-K at M ≤ 64, wgmma above)
   and, at M 16, device times from a CUDA graph with the weights L2-warm
   and L2-cold and the host's microseconds a call; then both forms' edges
   (M 1, 3, 16, 64, 65, 128, 300 at a K whose steps no slice count divides;
   G 8 with M 1, 64 and 100) and fp32 at awkward shapes, with bf16
   ``torch.matmul`` on the weight dequantized in advance (and
   ``torch._weight_int8pack_mm`` for int8 where the card's torch has it) as
   the yardstick; and the int8
   block quantizer (K6) on a bf16 tensor of Llama-3 1B's gradient size and
   on small ones, bit-identical to its plain version;
4. runs ``ragged_forward`` for a depth-2 model at Llama-3-8B width in fp32
   on the card (kernels) and on the CPU (plain versions) — a fresh chunk, a
   split chunk and a decode step — and compares the logits, then checks
   that the bf16 head returns unrounded fp32 logits; then the same for a
   depth-2 model at Mixtral 8x7B width: a fresh 4 x 256 chunk (1024
   tokens: the dropless FFN, grouped kernels) and a decode step (the
   capacity FFN); then from one quantized tree: depth 2 at Llama-3 8B
   width in int8, fp8, int4 and fp6 (fresh, split, decode) and at Mixtral
   width in int8 (a fresh 2 x 32 chunk and a decode step, both through the
   capacity layer);
5. decodes in fused windows on every serving model: each decode step is
   captured once per row bucket and sampling mode as a CUDA graph and
   replayed. Each run asserts replays and no decode step of its loops
   forced onto the stepwise path, holds paged attention's decode launches
   to layers x (decode steps + one warm-up step a capture), and prints the
   graphs, the seconds spent capturing, the graphs' pool bytes, the
   replays and the eager decode steps. First Llama-3 8B at full width and
   depth 2 in fp32, where ``generate`` and the stepwise loop give
   identical tokens over 32 new ones; then Llama-3 8B at full width and
   depth in bf16 (random weights from a seeded generator): ``generate`` on
   8 ragged prompts, ``serve`` on 16 requests and the serving frontend's
   loop over ``step_with_budget(max_steps=8)`` (the decode megastep) on
   the 8 prompts, with every kernel's launch count read around that run
   (each replay counts what its step's capture recorded); generate's
   windows, the megastep's and the stepwise loop give one token stream,
   and sampled, one window of 8 the same tokens as two of 4 and as the
   stepwise loop; one megastep window under ``torch.profiler`` shows the
   card ran as many K2 kernels as the replays counted (and, in the int8
   run below, as many K5 split-K kernels); then
   Mixtral 8x7B at full width and 16 of its 32 layers (``generate`` on 8
   prompts of 256-1024 tokens, whose first step of 8 x 256 tokens runs the
   grouped kernels, and ``serve`` on 16 requests) and Qwen1.5-MoE-A2.7B at
   full width and depth (``generate`` on 8 prompts of 256-512 tokens),
   each with prefill tokens/s, decode ms per step, peak memory and the
   launch counts read around its run (paged attention's by form: every
   decode launch takes the split form, every split-prefill launch the mma
   form); then quantized serving (the engine's
   ``weight_quant``, the tree drawn quantized slice by slice on the card):
   Llama-3 8B at full width and depth in int8, fp8, int4 and fp6
   (``generate`` on the 8 ragged prompts, 32 new tokens; ``serve`` on 16
   requests in int8), and Mixtral 8x7B at full width and all 32 layers in
   int8 (46.8 GB of weights; 256 arena pages, 512-token steps, 8 prompts of
   128-512 tokens, 16 new tokens), each with the same numbers, the
   quantized weights' bytes and K5's launches by form and by weight shape;
6. runs two ``train_batch`` steps of a depth-2 model at Llama-3-1B width in
   fp32 on the card (K1 + K3) and on the CPU (plain versions) from one
   parameter tree, and compares losses and updated parameters;
7. trains Llama-3 1B (the repo's training bench model) at full width and
   depth in bf16 through ``initialize``/``train_batch``: 2 warm-up and 10
   timed steps on one fixed batch, with tokens/s, ms per step, peak
   memory and each step's loss, and the kernels' launches read around it;
8. MoE training: the fp32 gradients of ``dropless_moe_layer`` at the
   1B/8e width and two fp32 ``train_batch`` steps of the 1B/8e model at
   depth 2, card against CPU; then the slice's main path, the repo's MoE
   training bench model (bench.py:251-285; 12 layers, 8 experts top-2,
   dropless) at full width and depth in bf16, 2 warm-up and 10 timed
   steps of 8 x 2048 tokens; and Mixtral 8x7B at full width and 2 of its
   32 layers (1 x 2048 tokens), each with ms per step, tokens/s, peak
   memory, loss and aux loss per step, and the launches read around it
   (grouped_gate_up's, grouped_down's, grouped_dgdu's, grouped_dxs's and
   grouped_wgrad's by form: the bf16 main paths launch only their wgmma
   forms).

Every phase prints one JSON line; any failure raises, so the script exits
non-zero. Without CUDA, or outside a checkout of the repository, it exits
non-zero before printing a result. The last three lines are the card, the
kernel table and ``{"ok": true, "device": ...}``.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np

#: device under test; the serving phase's model and arena
DEV = "cuda"
SERVE_MODEL = ("8b", {})
SERVE_BLOCKS = 512
SERVE_KERNELS = ("flash_attention_fwd", "paged_attention")
#: the MoE serving runs: (name, preset family, size, overrides, arena
#: pages, prompt lengths, new tokens, serve requests)
MOE_RUNS = (
    ("mixtral-8x7b-16L", "mixtral", "8x7b", {"num_layers": 16}, 512,
     [256, 1024, 512, 300, 768, 900, 400, 640], 32, 16),
    ("qwen1.5-moe-a2.7b", "qwen2_moe", "a2.7b", {}, 128,
     [256, 512, 300, 480, 384, 256, 400, 500], 16, 0))
GROUPED_KERNELS = ("grouped_gate_up", "grouped_down")
#: the planned grouped kernels' launches by form over the main paths (MoE
#: serving, MoE training), each run counted from 0
GROUPED_FORM_LAUNCHES = {k: {"fma": 0, "mma": 0, "wgmma": 0}
                         for k in ("grouped_gate_up", "grouped_down",
                                   "grouped_dgdu", "grouped_dxs",
                                   "grouped_wgrad")}
#: K2's launches by form over the serving paths (phase 5), each run
#: counted from 0
PAGED_FORM_LAUNCHES = {"fma": 0, "split": 0, "mma": 0}

HBM_BYTES_PER_S = 3.35e12          # H100 SXM device memory
PEAK_FLOPS = {"bfloat16": 989e12,  # dense bf16 tensor cores
              "float32": 67e12}    # fp32 outside the tensor cores


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def cuda_time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(nbytes: float, flops: float, dtype: str):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

def _paged_case(rng, n, c, h, kvh, dh, bs, starts, counts, dtype, dev,
                serve_arena=False, mb=None):
    """Random K/V and a page table listing each row's pages in a shuffled
    order. By default the arena holds one layer of just the pages the rows
    need. With ``serve_arena`` it is the serving phase's own arena
    (``init_arena(L, kvh, SERVE_BLOCKS, bs, dh)``) and the pages are the
    LAST layer's, drawn from the top of its region as the allocator hands
    them out: at Llama-3 8B's shape that region of the last kv head lies
    past element 2**31 of the K/V tensors. ``mb``: the page table's width
    (default: the longest row's pages), padded with the trash block as the
    engine pads its table to max_seq_len."""
    import torch
    from deepspeed_tpu_torch import llama3_config
    from deepspeed_tpu_torch.ops.paged_attention import (init_arena,
                                                         layer_page_offset)
    ctx = [s + k for s, k in zip(starts, counts)]
    need = [max(1, -(-x // bs)) for x in ctx]
    mb = max(need) if mb is None else mb
    assert mb >= max(need)
    g = torch.Generator(device=dev).manual_seed(int(rng.integers(1 << 30)))
    if serve_arena:
        layers = llama3_config(SERVE_MODEL[0], **SERVE_MODEL[1]).num_layers
        nb = SERVE_BLOCKS
        assert sum(need) <= nb
        arena = init_arena(layers, kvh, nb, bs, dh, dtype, dev)
        ak, av = arena["k"], arena["v"]
        off = layer_page_offset(layers - 1, nb)
        for a in (ak, av):             # the last layer's region, trash too
            a[:, off:off + nb + 1] = torch.randn(
                (kvh, nb + 1, bs, dh), generator=g, device=dev).to(dtype)
        ids = nb - 1 - rng.permutation(sum(need))
    else:
        nb, off = sum(need), 0
        ak = torch.randn((kvh, nb + 1, bs, dh), generator=g,
                         device=dev).to(dtype)
        av = torch.randn((kvh, nb + 1, bs, dh), generator=g,
                         device=dev).to(dtype)
        ids = rng.permutation(nb)
    pt = np.full((n, mb), nb, np.int64)
    at = 0
    for i, m in enumerate(need):
        pt[i, :m] = ids[at:at + m]
        at += m
    pt += off
    q = torch.randn((n, c, h, dh), generator=g, device=dev).to(dtype)
    ints = [torch.from_numpy(np.asarray(a, np.int32)).to(dev)
            for a in (pt, starts, counts)]
    return q, ak, av, ints, ctx


def _err(a, b) -> float:
    return float((a.float() - b.float()).abs().max()) if a.numel() else 0.0


def _row_rel_err(a, b) -> float:
    """Largest |a - b| / |b| over the last axis's vectors (one query row
    of one head)."""
    a, b = a.float(), b.float()
    if not a.numel():
        return 0.0
    num = (a - b).norm(dim=-1)
    return float((num / b.norm(dim=-1).clamp_min(1e-12)).max())


# Tolerances. fp32: atol/rtol 1e-4 (the kernel and the plain version sum
# in different orders). bf16 outputs: both sides accumulate in fp32 and
# round the result to bf16 once, a relative error of at most 2**-9 per
# element, so each row's relative error |out - ref| / |ref| stays below
# ~4e-3; the limit is 1e-2. A kernel that skipped one page of 128 keys
# in a 4000-key row would move that row by ~0.2 of its norm. lse is fp32
# from the same bf16 scores on both sides: atol/rtol 1e-3.
TOL_F32 = 1e-4
TOL_BF16_ROW = 1e-2
TOL_BF16_LSE = 1e-3


def _hold(name, out, ref_out, lse, ref_lse, res) -> None:
    """Record the errors in ``res`` and check the limits; on a miss print
    ``res`` before raising."""
    import torch
    f32 = out.dtype == torch.float32
    res["max_abs_err"] = _err(out, ref_out)
    if lse is not None:
        res["max_abs_err"] = max(res["max_abs_err"], _err(lse, ref_lse))
    ok = bool(torch.isfinite(out).all())
    if f32:
        res["tol"] = TOL_F32
        ok = ok and torch.allclose(out, ref_out, rtol=TOL_F32, atol=TOL_F32)
    else:
        res["row_rel_err"] = _row_rel_err(out, ref_out)
        res["tol"] = {"row_rel": TOL_BF16_ROW, "lse": TOL_BF16_LSE}
        ok = ok and res["row_rel_err"] <= TOL_BF16_ROW
    if lse is not None:
        tol = TOL_F32 if f32 else TOL_BF16_LSE
        ok = ok and torch.allclose(lse, ref_lse, rtol=tol, atol=tol)
    if not ok:
        emit(dict(res, failed=True))
        raise AssertionError(f"{name}: kernel disagrees with its plain "
                             f"version beyond the stated tolerance")


def check_paged(name, rng, n, c, starts, counts, dtype, with_lse, dims,
                form, time_it=True, serve_arena=False, mb=None):
    """Hold K2 against ``paged_attention_ref`` on one case and assert that
    the launch took ``form`` (its plan goes into the line)."""
    import torch
    from deepspeed_tpu_torch.ops import paged_attention as pa
    h, kvh, dh, bs = dims
    dev = torch.device(DEV)
    q, ak, av, (pt, st, ct), ctx = _paged_case(
        rng, n, c, h, kvh, dh, bs, starts, counts, dtype, dev, serve_arena,
        mb)
    pl = pa.plan(n, c, h, kvh, dh, bs, pt.shape[1], dtype)
    assert pl.form == form, (name, pl)
    forms = pa.form_launches["paged_attention"]
    before = pa.op_builder.launches["paged_attention"], forms[form]
    out, lse = pa.paged_attention_with_lse(q, ak, av, pt, st, ct) \
        if with_lse else (pa.paged_attention(q, ak, av, pt, st, ct), None)
    torch.cuda.synchronize()
    assert (pa.op_builder.launches["paged_attention"], forms[form]) == \
        (before[0] + 1, before[1] + 1), name
    ref_out, ref_lse = pa.paged_attention_ref(q, ak, av, pt, st, ct,
                                              with_lse=True)
    # rows that see at least one key: p <= start + j and p < start + count
    j = torch.arange(c, device=dev)[None]
    has_key = torch.minimum(st.long()[:, None] + j + 1,
                            (st + ct).long()[:, None]) > 0     # [n, c]
    rows = has_key[:, :, None].expand(n, c, h)
    res = {"phase": "kernels", "check": name, "kernel": "paged_attention",
           "dtype": str(dtype).replace("torch.", ""),
           "plan": {"form": pl.form, "splits": pl.splits,
                    "split_keys": pl.split_keys, "grid": list(pl.grid)},
           "shape": {"n": n, "c": c, "H": h, "KvH": kvh, "dh": dh, "bs": bs,
                     "mb": int(pt.shape[1]),
                     "ctx_min": min(ctx), "ctx_max": max(ctx),
                     "arena": list(ak.shape),
                     "max_page_element": int(
                         ((kvh - 1) * ak.shape[1] + int(pt.max()) + 1)
                         * bs * dh)}}
    _hold(name, out[rows], ref_out[rows], lse[rows] if with_lse else None,
          ref_lse[rows] if with_lse else None, res)
    if with_lse:
        empty = ~rows
        assert (out[empty[..., None].expand_as(out)] == 0).all()
        assert (lse[empty] == -1e30).all()
    if time_it:
        itemsize = q.element_size()
        # keys each row needs: history + visible part of the chunk
        vis = sum(min(s + jj + 1, x) for s, k, x in zip(starts, counts, ctx)
                  for jj in range(c))
        nbytes = (2 * sum(ctx) * kvh * dh * itemsize     # K and V read once
                  + 2 * q.numel() * itemsize             # q in, out
                  + (lse.numel() * 4 if with_lse else 0)
                  + pt.numel() * 4 + 8 * n)
        flops = 4.0 * dh * h * vis
        fn = (lambda: pa.paged_attention_with_lse(q, ak, av, pt, st, ct)) \
            if with_lse else (lambda: pa.paged_attention(q, ak, av, pt, st,
                                                         ct))
        res["kernel_ms"] = cuda_time_ms(fn)
        if form == "split":
            # a decode call is short next to the wrapper's host cost: the
            # device time a call from a CUDA graph, and the host's µs a call
            res["kernel_graph_ms"] = graph_time_ms(lambda _: fn(), [None])
            res["kernel_host_us"] = host_us(fn)
        res["plain_ms"] = cuda_time_ms(
            lambda: pa.paged_attention_ref(q, ak, av, pt, st, ct,
                                           with_lse=with_lse), iters=5)
        res["bound_ms"], res["bound_by"] = bound(
            nbytes, flops, res["dtype"])
        res["library_ms"] = None      # no single PyTorch call pages KV
    emit(res)
    return res


def _keys_per_row(tq, tk, causal, window, q_offset):
    """[tq]: how many keys each query row sees through the mask."""
    qpos = np.arange(tq) + q_offset
    hi = np.minimum(qpos + 1, tk) if causal else np.full(tq, tk)
    lo = np.maximum(qpos - window + 1, 0) if window else np.zeros(tq)
    return np.clip(hi - lo, 0, None)


def _visible_pairs(tq, tk, causal, window, q_offset, b, h) -> float:
    """(query, key) pairs the mask lets through, over batch and heads."""
    return float(_keys_per_row(tq, tk, causal, window, q_offset).sum()) \
        * b * h


def check_flash(name, rng, b, t, dims, dtype, with_lse, causal=True,
                window=None, q_offset=0, time_it=True):
    import torch
    import torch.nn.functional as F
    from deepspeed_tpu_torch.ops import flash_attention as fa
    h, kvh, d = dims
    dev = torch.device(DEV)
    g = torch.Generator(device=dev).manual_seed(int(rng.integers(1 << 30)))
    q = torch.randn((b, t, h, d), generator=g, device=dev).to(dtype)
    k = torch.randn((b, t, kvh, d), generator=g, device=dev).to(dtype)
    v = torch.randn((b, t, kvh, d), generator=g, device=dev).to(dtype)
    before = fa.op_builder.launches["flash_attention_fwd"]
    if with_lse:
        out, lse = fa.flash_attention_with_lse(q, k, v, causal=causal)
    else:
        out, lse = fa.flash_attention(q, k, v, causal=causal,
                                      q_offset=q_offset, window=window), None
    torch.cuda.synchronize()
    assert fa.op_builder.launches["flash_attention_fwd"] == before + 1
    ref_out, ref_lse = fa.flash_attention_ref(q, k, v, causal, q_offset,
                                              window)
    res = {"phase": "kernels", "check": name, "kernel": "flash_attention_fwd",
           "dtype": str(dtype).replace("torch.", ""),
           "shape": {"B": b, "T": t, "H": h, "KvH": kvh, "D": d,
                     "causal": causal, "window": window,
                     "q_offset": q_offset}}
    _hold(name, out, ref_out, lse, ref_lse if with_lse else None, res)
    if time_it:
        itemsize = q.element_size()
        vis = _visible_pairs(t, t, causal, window, q_offset, b, h)
        nbytes = (2 * q.numel() + 2 * k.numel()) * itemsize + \
            (b * t * h * 4 if with_lse else 0)
        flops = 4.0 * d * vis
        fn = (lambda: fa.flash_attention_with_lse(q, k, v, causal=causal)) \
            if with_lse else (lambda: fa.flash_attention(
                q, k, v, causal=causal, q_offset=q_offset, window=window))
        res["kernel_ms"] = cuda_time_ms(fn)
        res["plain_ms"] = cuda_time_ms(
            lambda: fa.flash_attention_ref(q, k, v, causal, q_offset, window),
            iters=5)
        res["bound_ms"], res["bound_by"] = bound(nbytes, flops, res["dtype"])
        res["library_ms"] = None
        if window is None and q_offset == 0:
            qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
            if h != kvh:
                kt = kt.repeat_interleave(h // kvh, dim=1)
                vt = vt.repeat_interleave(h // kvh, dim=1)
            res["library_ms"] = cuda_time_ms(
                lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                       is_causal=causal))
    emit(res)
    return res


def check_flash_bwd(name, rng, b, t, dims, dtype, causal=True, window=None,
                    q_offset=0, time_it=True):
    """K3 through autograd (K1 forward, K3 backward) and as a direct call,
    held against the fp32 plain backward on the same inputs (q, k, v, the
    forward's out and lse, dO): fp32 within TOL_F32, bf16 by each gradient
    row's relative error (both sides accumulate in fp32; the kernel rounds
    P and dS to bf16 for its products and dq/dk/dv once). A dq row that
    sees exactly one key is 0 in exact arithmetic (p = 1, dP = delta), so
    both sides hold only fp32 rounding noise there, in their own summation
    orders: those rows are held to TOL_F32 (absolute), not to a relative
    error of noise against noise. Rows that see no key must get exactly
    zero gradients."""
    import torch
    import torch.nn.functional as F
    from deepspeed_tpu_torch.ops import flash_attention as fa
    h, kvh, d = dims
    dev = torch.device(DEV)
    g = torch.Generator(device=dev).manual_seed(int(rng.integers(1 << 30)))
    q, k, v = (torch.randn((b, t, n, d), generator=g, device=dev).to(dtype)
               .requires_grad_() for n in (h, kvh, kvh))
    do = torch.randn((b, t, h, d), generator=g, device=dev).to(dtype)
    mask = (causal, q_offset, window)
    before = fa.op_builder.launches["flash_attention_bwd"]
    out = fa.flash_attention(q, k, v, *mask)
    grads = torch.autograd.grad(out, (q, k, v), do)
    torch.cuda.synchronize()
    assert fa.op_builder.launches["flash_attention_bwd"] == before + 1
    q, k, v, out = q.detach(), k.detach(), v.detach(), out.detach()
    _, lse = fa._forward(q, k, v, *mask)
    direct = fa.flash_attention_bwd(q, k, v, out, lse, do, *mask)
    for a, c in zip(grads, direct):
        assert torch.equal(a, c), f"{name}: autograd and direct K3 differ"
    # the backward's inputs are (q, k, v, out, lse, dO): the plain version
    # gets the same values, widened to fp32
    ref = fa.flash_attention_bwd_ref(*(x.float() for x in (q, k, v, out)),
                                     lse, do.float(), *mask)
    res = {"phase": "kernels", "check": name, "kernel": "flash_attention_bwd",
           "dtype": str(dtype).replace("torch.", ""),
           "shape": {"B": b, "T": t, "H": h, "KvH": kvh, "D": d,
                     "causal": causal, "window": window,
                     "q_offset": q_offset},
           "max_abs_err": max(_err(a, c) for a, c in zip(grads, ref))}
    ok = all(bool(torch.isfinite(a).all()) for a in grads)
    if dtype == torch.float32:
        res["tol"] = TOL_F32
        ok = ok and all(torch.allclose(a, c, rtol=TOL_F32, atol=TOL_F32)
                        for a, c in zip(grads, ref))
    else:
        one = torch.as_tensor(
            _keys_per_row(t, t, causal, window, q_offset) == 1, device=dev)
        res["row_rel_err"] = {n: _row_rel_err(a, c)
                              for n, a, c in zip("qkv", grads, ref)}
        res["row_rel_err"]["q"] = _row_rel_err(grads[0][:, ~one],
                                               ref[0][:, ~one])
        res["one_key_rows"] = int(one.sum()) * b * h
        res["one_key_max_abs_err"] = _err(grads[0][:, one], ref[0][:, one])
        res["tol"] = {"row_rel": TOL_BF16_ROW, "one_key_rows": TOL_F32}
        ok = ok and max(res["row_rel_err"].values()) <= TOL_BF16_ROW
        ok = ok and torch.allclose(grads[0][:, one].float(), ref[0][:, one],
                                   rtol=TOL_F32, atol=TOL_F32)
    dead = lse <= -1e29
    res["rows_without_key"] = int(dead.sum())
    if res["rows_without_key"]:
        ok = ok and bool((grads[0][dead] == 0).all())
    if not ok:
        emit(dict(res, failed=True))
        raise AssertionError(f"{name}: K3 disagrees with its plain version "
                             f"beyond the stated tolerance")
    if time_it:
        itemsize = q.element_size()
        vis = _visible_pairs(t, t, causal, window, q_offset, b, h)
        # q, k, v, out, dO and lse read once; dq, dk, dv written once
        nbytes = (3 * q.numel() + 3 * k.numel()) * itemsize \
            + 2 * q.numel() * itemsize + lse.numel() * 4
        # five products per visible pair: S, dP, dV, dK, dQ
        flops = 10.0 * d * vis
        res["kernel_ms"] = cuda_time_ms(
            lambda: fa.flash_attention_bwd(q, k, v, out, lse, do, *mask))
        res["plain_ms"] = cuda_time_ms(
            lambda: fa.flash_attention_bwd_ref(q, k, v, out, lse, do, *mask),
            iters=3)
        res["bound_ms"], res["bound_by"] = bound(nbytes, flops, res["dtype"])
        res["library_ms"] = None
        if window is None and q_offset == 0:
            # SDPA's backward alone: forward + backward minus forward
            qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                          for x in (q, k, v))
            dot = do.transpose(1, 2)

            def sdpa():
                return F.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=causal, enable_gqa=True)

            def sdpa_fwd_bwd():
                torch.autograd.grad(sdpa(), (qt, kt, vt), dot)

            with torch.no_grad():
                fwd_ms = cuda_time_ms(sdpa)
            res["library_ms"] = cuda_time_ms(sdpa_fwd_bwd) - fwd_ms
            res["library_fwd_ms"] = fwd_ms
    emit(res)
    return res


def _grouped_case(rng, s, k, e, d, f, dtype, kind):
    """One dropless FFN call as the MoE layer makes it: x [S, d] ~ N(0, 1)
    routed by a random router (top-k of softmax, renormalised) into the
    aligned layout; weights ~ N(0, 1/fan-in). ``kind``: "router"; "empty"
    (expert 0 never chosen); "one" (every slot on expert e - 1); "split"
    (slot j of token t on expert (t + j) % e, with the router's
    probabilities there: at S = 32·e and top-2 every expert holds one
    64-row tile, so every 128-row block of the wgmma forms holds two
    experts' tiles). Returns
    (xs, (wg, wi, wo), (group_of_tile, sizes, live), w, experts used)."""
    import torch
    from deepspeed_tpu_torch.ops import grouped_matmul as tg
    from deepspeed_tpu_torch.parallel.moe import GMM_BM, topk_gates_t
    dev = torch.device(DEV)
    g = torch.Generator(device=dev).manual_seed(int(rng.integers(1 << 30)))
    x = torch.randn((s, d), generator=g, device=dev)
    logits_t = (x @ torch.randn((d, e), generator=g, device=dev)).t()
    if kind == "empty":
        logits_t[0] = -1e30
    probs = torch.softmax(logits_t / d ** 0.5, 0)
    topv, topi = topk_gates_t(probs, k)
    if kind == "one":
        topi = torch.full_like(topi, e - 1)
    if kind == "split":
        topi = (torch.arange(s, device=dev)[None]
                + torch.arange(k, device=dev)[:, None]) % e
        topv = probs.gather(0, topi)
        topi = topi.to(torch.int32)
    topv = topv / topv.sum(0, keepdim=True)
    tok, w, got, sizes, pos, live = tg.aligned_dispatch(
        topi, topv.to(dtype), e, GMM_BM)
    xs = tg.gather_rows(torch.cat([x, x.new_zeros((1, d))]).to(dtype),
                        tok, pos)

    def weight(shape, fan_in):
        out = torch.empty(shape, dtype=dtype, device=dev)
        for i in range(shape[0]):
            out[i] = (torch.randn(shape[1:], generator=g, device=dev)
                      / fan_in ** 0.5).to(dtype)
        return out

    wg, wi = weight((e, d, f), d), weight((e, d, f), d)
    wo = weight((e, f, d), f)
    used = int(torch.unique(topi).numel())
    return xs, (wg, wi, wo), (got, sizes, live), w, used


def _hold_pair(res, key, out, ref) -> None:
    """Errors of one output pair into ``res[key]``; a miss prints ``res``
    and raises. fp32: allclose at TOL_F32; bf16: per-row relative error at
    TOL_BF16_ROW."""
    import torch
    r = {"max_abs_err": _err(out, ref)}
    ok = bool(torch.isfinite(out).all())
    if out.dtype == torch.float32:
        ok = ok and torch.allclose(out, ref, rtol=TOL_F32, atol=TOL_F32)
    else:
        r["row_rel_err"] = _row_rel_err(out, ref)
        ok = ok and r["row_rel_err"] <= TOL_BF16_ROW
    res[key] = r
    if not ok:
        emit(dict(res, failed=True))
        raise AssertionError(f"{res['check']}: {key} disagrees with its "
                             f"plain version beyond the stated tolerance")


def _grouped_mm_ms(a, b, ends):
    """The yardstick: one ``torch._grouped_mm`` of a [M, K] by the groups
    of b [G, K, N] (group rows ending at ``ends``) where this torch has it
    for these inputs, else one dense matmul of the same rows and FLOPs
    (a @ b[0]). Returns (ms, what). Timed here only; the port calls
    neither."""
    import torch
    if hasattr(torch, "_grouped_mm"):
        for bb in (b, b.transpose(-1, -2).contiguous().transpose(-1, -2)):
            try:
                torch._grouped_mm(a, bb, offs=ends)
                torch.cuda.synchronize()
            except (RuntimeError, TypeError, ValueError):
                continue
            return (cuda_time_ms(lambda: torch._grouped_mm(a, bb, offs=ends),
                                 iters=10), "torch._grouped_mm")
    return (cuda_time_ms(lambda: a @ b[0], iters=10),
            "torch.matmul dense (same rows and FLOPs)")


def _plan_line(pl) -> dict:
    """The launch plan of a planned grouped kernel's call, for a line."""
    return {"form": pl.form, "grid": list(pl.grid),
            "row_blocks": pl.row_blocks, "col_tiles": pl.col_tiles,
            "bm": pl.bm, "bn": pl.bn, "bk": pl.bk,
            "k_steps": list(pl.k_steps), "stages": pl.stages,
            "smem_bytes": pl.smem_bytes, "band": pl.band}


def _counted_forms(kernels, before, form, n):
    """Each of ``kernels`` launched n more times, all under ``form``,
    since ``before`` (a copy of tg.form_launches)."""
    from deepspeed_tpu_torch.ops import grouped_matmul as tg
    for k in kernels:
        assert tg.form_launches[k] == dict(
            before[k], **{form: before[k][form] + n}), (k, tg.form_launches)


def _tflops(flops: float, ms: float) -> float:
    return flops / ms / 1e9


def check_grouped(name, rng, s, k, e, d, f, dtype, fused, kind="router",
                  time_it=False, form="wgmma"):
    """grouped_gate_up and grouped_down on the card against their plain
    versions: each kernel alone (down fed the plain gate/up), then the
    whole FFN through grouped_glu_ffn, on the rows below live_tiles * bm
    (the rest is unspecified). The plans of both kernels must pick
    ``form``, and both launches of each here must count under it."""
    import torch
    import torch.nn.functional as F
    from deepspeed_tpu_torch.ops import grouped_matmul as tg
    from deepspeed_tpu_torch.parallel.moe import GMM_BM
    xs, (wg, wi, wo), (got, sizes, live), w, used = _grouped_case(
        rng, s, k, e, d, f, dtype, kind)
    w = w if fused else None
    end = int(live[0]) * GMM_BM
    pl = tg.plan("grouped_down", dtype, xs.shape[0], d, f, e)
    pl_gu = tg.plan("grouped_gate_up", dtype, xs.shape[0], d, f, e)
    res = {"phase": "kernels", "check": name, "kernel": "grouped_glu_ffn",
           "dtype": str(dtype).replace("torch.", ""),
           "shape": {"S": s, "k": k, "E": e, "d": d, "f": f, "bm": GMM_BM,
                     "R_pad": xs.shape[0], "live_rows": end,
                     "experts_used": used, "w": fused, "routing": kind},
           "gate_up_plan": _plan_line(pl_gu), "down_plan": _plan_line(pl)}
    assert pl.form == form and pl_gu.form == form, (name, pl, pl_gu)
    before = dict(tg.op_builder.launches)
    before_form = {k: dict(v) for k, v in tg.form_launches.items()}
    gate, up = tg.gate_up_kernel(xs, wg, wi, got, live, GMM_BM)
    rg, ru = tg.gate_up_ref(xs, wg, wi, sizes, live, GMM_BM)
    y = tg.down_kernel(rg, ru, wo, got, live, GMM_BM, w)
    ry = tg.down_ref(rg, ru, wo, sizes, live, GMM_BM, w)
    out = tg.grouped_glu_ffn(xs, wg, wi, wo, got, sizes, live, bm=GMM_BM,
                             w=w)
    torch.cuda.synchronize()
    for kname in GROUPED_KERNELS:
        assert tg.op_builder.launches[kname] == before[kname] + 2, kname
    _counted_forms(GROUPED_KERNELS, before_form, form, 2)
    ref = tg.grouped_glu_ffn_ref(xs, wg, wi, wo, got, sizes, live,
                                 bm=GMM_BM, w=w)
    _hold_pair(res, "gate", gate[:end], rg[:end])
    _hold_pair(res, "up", up[:end], ru[:end])
    _hold_pair(res, "down", y[:end], ry[:end])
    _hold_pair(res, "ffn", out[:end], ref[:end])
    res["max_abs_err"] = max(res[key]["max_abs_err"]
                             for key in ("gate", "up", "down", "ffn"))
    if time_it:
        rows, isz = s * k, xs.element_size()
        res["gate_up_ms"] = cuda_time_ms(
            lambda: tg.gate_up_kernel(xs, wg, wi, got, live, GMM_BM),
            iters=10)
        res["down_ms"] = cuda_time_ms(
            lambda: tg.down_kernel(gate, up, wo, got, live, GMM_BM, w),
            iters=10)
        res["gate_up_plain_ms"] = cuda_time_ms(
            lambda: tg.gate_up_ref(xs, wg, wi, sizes, live, GMM_BM),
            iters=3, warmup=1)
        res["down_plain_ms"] = cuda_time_ms(
            lambda: tg.down_ref(gate, up, wo, sizes, live, GMM_BM, w),
            iters=3, warmup=1)
        # the S·k real rows at 6·d·f FLOP each (gate/up 4·d·f, down 2·d·f);
        # bytes: the weights of every expert that got a row, xs, gate/up
        # written then read, w and y, each once
        res["gate_up_bound_ms"], res["gate_up_bound_by"] = bound(
            (2 * d * f * used + rows * d + 2 * rows * f) * isz,
            4.0 * d * f * rows, res["dtype"])
        res["down_bound_ms"], res["down_bound_by"] = bound(
            (f * d * used + 2 * rows * f + rows * d + rows) * isz,
            2.0 * d * f * rows, res["dtype"])
        if fused:
            # the same kernel without w: the form of _down_kernel (:341)
            res["down_unscaled_ms"] = cuda_time_ms(
                lambda: tg.down_kernel(gate, up, wo, got, live, GMM_BM),
                iters=10)
            res["down_unscaled_plain_ms"] = cuda_time_ms(
                lambda: tg.down_ref(gate, up, wo, sizes, live, GMM_BM),
                iters=3, warmup=1)
            res["down_unscaled_bound_ms"], _ = bound(
                (f * d * used + 2 * rows * f + rows * d) * isz,
                2.0 * d * f * rows, res["dtype"])
        ends = torch.cumsum(sizes, 0).clamp_max(end).to(torch.int32)
        wgi = torch.cat([wg, wi], dim=-1)
        res["gate_up_library_ms"], res["library"] = _grouped_mm_ms(
            xs[:end], wgi, ends)
        del wgi
        h = (F.silu(gate[:end].float()) * up[:end].float()).to(dtype)
        res["down_library_ms"], _ = _grouped_mm_ms(h, wo, ends)
        res["tflops_per_s"] = _tflops(6.0 * d * f * rows,
                                      res["gate_up_ms"] + res["down_ms"])
        res["gate_up_tflops_per_s"] = _tflops(4.0 * d * f * rows,
                                              res["gate_up_ms"])
        res["down_tflops_per_s"] = _tflops(2.0 * d * f * rows, res["down_ms"])
        res["down_library_tflops_per_s"] = _tflops(2.0 * d * f * rows,
                                                   res["down_library_ms"])
    emit(res)
    del xs, wg, wi, wo, gate, up, y, out, ref, rg, ru, ry
    torch.cuda.empty_cache()
    return res


def phase_grouped(rng):
    """Phase 3's grouped GEMM checks: bf16 at the path shapes (Mixtral
    8x7B and Qwen1.5-MoE prefill, the 1B/8e training forward), bf16 edges
    on the wgmma forms of grouped_gate_up and grouped_down (an empty
    expert, all rows on one expert, 60 experts, f off 64 and d off 256,
    with w and without), then
    the mma.sync form (d, f off TMA's 8) and fp32 (the FMA form) at awkward
    shapes. Returns the timed path-shape lines."""
    import torch
    bf16, f32 = torch.bfloat16, torch.float32
    out = {"mixtral": check_grouped("gmm_mixtral_path", rng, 2048, 2, 8,
                                    4096, 14336, bf16, True, time_it=True),
           "qwen": check_grouped("gmm_qwen_path", rng, 2048, 4, 60, 2048,
                                 1408, bf16, True, time_it=True),
           "moe_1b_8e": check_grouped("gmm_1b8e_path", rng, 16384, 2, 8,
                                      1024, 2816, bf16, True, time_it=True)}
    for name, s, k, e, d, f, dtype, fused, kind, form in (
            ("gmm_bf16_empty_expert", 400, 2, 6, 512, 384, bf16, True,
             "empty", "wgmma"),
            ("gmm_bf16_one_expert", 300, 2, 5, 256, 512, bf16, False, "one",
             "wgmma"),
            ("gmm_bf16_60_experts", 512, 4, 60, 256, 192, bf16, True,
             "router", "wgmma"),
            ("gmm_bf16_f1416_d1032", 600, 2, 8, 1032, 1416, bf16, True,
             "router", "wgmma"),
            ("gmm_bf16_f1416_d1032_unscaled", 600, 2, 8, 1032, 1416, bf16,
             False, "router", "wgmma"),
            ("gmm_bf16_odd_unscaled", 100, 2, 4, 100, 150, bf16, False,
             "router", "mma"),
            ("gmm_f32_unscaled", 300, 2, 4, 256, 200, f32, False, "router",
             "fma"),
            ("gmm_f32_fused", 300, 2, 4, 256, 200, f32, True, "router",
             "fma"),
            ("gmm_f32_empty_expert", 200, 2, 6, 128, 384, f32, True,
             "empty", "fma"),
            ("gmm_f32_one_expert", 150, 2, 5, 128, 130, f32, False, "one",
             "fma"),
            ("gmm_f32_odd", 90, 3, 4, 130, 70, f32, True, "router", "fma")):
        check_grouped(name, rng, s, k, e, d, f, dtype, fused, kind,
                      form=form)
    return out


def _wgrad_mm_ms(a, b, ends):
    """The dW yardstick: one ``torch._grouped_mm`` in its ragged-K form
    (out[g] = a[rows of g]ᵀ · b[rows of g]), trying row- and column-major
    copies of both operands. Returns ms, or None where this torch has no
    such form for these inputs. Timed here only; the port never calls
    it."""
    import torch
    if not hasattr(torch, "_grouped_mm"):
        return None
    for at in (a.t(), a.t().contiguous()):
        for bt in (b, b.t().contiguous().t()):
            try:
                torch._grouped_mm(at, bt, offs=ends)
                torch.cuda.synchronize()
            except (RuntimeError, TypeError, ValueError):
                continue
            return cuda_time_ms(
                lambda: torch._grouped_mm(at, bt, offs=ends), iters=10)
    return None


def _dgdu_form(dz, wo, got, live, bm, w, rc, form):
    """A call of grouped_dgdu in ``form`` through the C entry (the wrapper
    takes the plan's form and counts its launches; this counts none):
    returns a function that launches it and gives (dg, du, h)."""
    import torch
    from deepspeed_tpu_torch.ops import grouped_matmul as tg
    r_pad, d = dz.shape
    e, f, _ = wo.shape
    nf = -(-f // tg._OLD_BN[("grouped_dgdu", form)])
    dg, du, h = (torch.empty((r_pad, f), dtype=dz.dtype, device=dz.device)
                 for _ in range(3))
    dwp = None if w is None else torch.empty((nf, r_pad), device=dz.device)
    lib = tg.op_builder.load("grouped_matmul_bwd")
    st = torch.cuda.current_stream().cuda_stream

    def call():
        err = lib.dstt_grouped_dgdu(
            dz.data_ptr(), rc["xs"].data_ptr(), rc["wg"].data_ptr(),
            rc["wi"].data_ptr(), wo.data_ptr(), None, None, tg._ptr(w),
            dg.data_ptr(), du.data_ptr(), h.data_ptr(), tg._ptr(dwp),
            got.data_ptr(), live.data_ptr(), r_pad, d, f, bm, nf, e,
            tg._DTYPES[dz.dtype], tg.FORMS[form], 1, st)
        tg.op_builder.check(lib, err, f"grouped_dgdu ({form})")
        return dg, du, h
    return call


def check_grouped_bwd(name, rng, s, k, e, d, f, dtype, fused,
                      kind="router", time_it=False, form="wgmma"):
    """The backward kernels on the card against their plain versions, on
    one dropless FFN call (``_grouped_case``) and a random upstream
    gradient dz (zero on padding rows, as the combine's backward gives
    it): grouped_dgdu in both forms (gate/up recomputed from xs, and read
    from the saved forward), with w when ``fused`` (dg, du, h and the
    combine weights' gradient dw2) and without; grouped_dxs and the three
    grouped_wgrad products fed the plain dg/du/h; then the whole backward
    through autograd of grouped_glu_ffn. Rows at or past live_tiles * bm
    are unspecified in dg/du/h/dxs and skipped. The plans of grouped_dgdu
    (recomputed and saved), grouped_dxs and the three grouped_wgrad
    products must pick ``form``, and every launch of the three here must
    count under it. With ``kind`` "empty" the dW products also run with
    one expert more than the layout has, which owns no row: its dW must
    come back zero; with "split" some 128-row block must hold two
    experts' tiles. Timed (the path shapes), the line also holds and
    times grouped_dgdu's mma.sync form, called through the C entry's form
    argument (no launch is counted)."""
    import torch
    from deepspeed_tpu_torch.ops import grouped_matmul as tg
    from deepspeed_tpu_torch.parallel.moe import GMM_BM as bm
    xs, (wg, wi, wo), (got, sizes, live), w, used = _grouped_case(
        rng, s, k, e, d, f, dtype, kind)
    g = torch.Generator(device=DEV).manual_seed(int(rng.integers(1 << 30)))
    dz = torch.randn(xs.shape, generator=g, device=DEV).to(dtype)
    dz[w == 0] = 0                       # padding and dead rows
    w = w if fused else None
    end = int(live[0]) * bm
    res = {"phase": "kernels", "check": name, "kernel": "grouped_bwd",
           "dtype": str(dtype).replace("torch.", ""),
           "shape": {"S": s, "k": k, "E": e, "d": d, "f": f, "bm": bm,
                     "R_pad": xs.shape[0], "live_rows": end,
                     "experts_used": used, "w": fused, "routing": kind}}
    pl = tg.plan("grouped_dxs", dtype, xs.shape[0], d, f, e)
    res["dxs_plan"] = _plan_line(pl)
    pl_dg = tg.plan("grouped_dgdu", dtype, xs.shape[0], d, f, e)
    pl_dgs = tg.plan("grouped_dgdu", dtype, xs.shape[0], d, f, e,
                     saved=True)
    res["dgdu_plan"], res["dgdu_saved_plan"] = (_plan_line(pl_dg),
                                                _plan_line(pl_dgs))
    assert pl_dg.form == pl_dgs.form == form, (name, pl_dg, pl_dgs)
    if kind == "split":
        tiles = got[:int(live[0])].tolist()
        assert any(a != b for a, b in zip(tiles[::2], tiles[1::2])), tiles
    # dwg, dwi (a = xs [R, d], b = dg/du [R, f]); dwo (a = h, b = dz, w)
    pl_w = tg.plan("grouped_wgrad", dtype, xs.shape[0], d, f, e)
    pl_wo = tg.plan("grouped_wgrad", dtype, xs.shape[0], f, d, e,
                    scaled=fused)
    res["wgrad_plan"], res["wgrad_dwo_plan"] = (_plan_line(pl_w),
                                                _plan_line(pl_wo))
    assert pl.form == pl_w.form == pl_wo.form == form, (name, pl, pl_w,
                                                        pl_wo)
    before = dict(tg.op_builder.launches)
    before_form = {k: dict(v) for k, v in tg.form_launches.items()}
    rc = dict(xs=xs, wg=wg, wi=wi)
    rg, ru = tg.gate_up_ref(xs, wg, wi, sizes, live, bm)
    saved = dict(gate=rg, up=ru)
    ref = tg.dgdu_ref(dz, wo, sizes, live, bm, w=w, **rc)
    for how, kw in (("rc", rc), ("saved", saved)):
        out = tg.dgdu_kernel(dz, wo, got, live, bm, w=w, **kw)
        want = ref if how == "rc" else tg.dgdu_ref(dz, wo, sizes, live, bm,
                                                  w=w, **kw)
        for key, a, b in zip(("dg", "du", "h"), out[:3], want[:3]):
            _hold_pair(res, f"dgdu_{how}_{key}", a[:end], b[:end])
        if fused:
            _hold_pair(res, f"dgdu_{how}_dw2", out[3], want[3])
    rdg, rdu, rh, _ = ref
    _hold_pair(res, "dxs", tg.dxs_kernel(rdg, rdu, wg, wi, got, live,
                                         bm)[:end],
               tg.dxs_ref(rdg, rdu, wg, wi, sizes, live, bm)[:end])
    for key, a, b, sc in (("dwg", xs, rdg, None), ("dwi", xs, rdu, None),
                          ("dwo", rh, dz, w)):
        _hold_pair(res, key, tg.wgrad_kernel(a, b, got, live, e, bm, sc),
                   tg.wgrad_ref(a, b, sizes, live, bm, sc))
    n_wgrad = 6
    if kind == "empty":
        # expert e owns no tile: its block issues no load and writes zeros
        sizes1 = torch.cat([sizes, sizes.new_zeros(1)])
        for key, a, b, sc in (("dwg", xs, rdg, None), ("dwo", rh, dz, w)):
            out = tg.wgrad_kernel(a, b, got, live, e + 1, bm, sc)
            _hold_pair(res, key + "_rowless_expert", out,
                       tg.wgrad_ref(a, b, sizes1, live, bm, sc))
            assert not out[e].any(), (name, key)
        n_wgrad += 2
    # the whole backward through autograd: one dgdu, one dxs, three wgrad
    leaves = [t.clone().requires_grad_() for t in (xs, wg, wi, wo)]
    inputs = leaves + ([w.clone().requires_grad_()] if fused else [])
    mid = dict(tg.op_builder.launches)
    y = tg.grouped_glu_ffn(*leaves, got, sizes, live, bm=bm,
                           w=inputs[4] if fused else None)
    grads = torch.autograd.grad(y, inputs, dz)
    torch.cuda.synchronize()
    after = dict(tg.op_builder.launches)
    assert after["grouped_dgdu"] - mid["grouped_dgdu"] == 1, after
    assert after["grouped_dxs"] - mid["grouped_dxs"] == 1, after
    assert after["grouped_wgrad"] - mid["grouped_wgrad"] == 3, after
    assert after["grouped_dgdu"] - before["grouped_dgdu"] == 3, after
    _counted_forms(("grouped_dgdu",), before_form, form, 3)
    _counted_forms(("grouped_dxs",), before_form, form, 2)
    _counted_forms(("grouped_wgrad",), before_form, form, n_wgrad)
    dxs_ref = tg.dxs_ref(rdg, rdu, wg, wi, sizes, live, bm)
    _hold_pair(res, "autograd_dxs", grads[0][:end], dxs_ref[:end])
    for key, gr, (a, b, sc) in zip(
            ("autograd_dwg", "autograd_dwi", "autograd_dwo"), grads[1:4],
            ((xs, rdg, None), (xs, rdu, None), (rh, dz, w))):
        _hold_pair(res, key, gr, tg.wgrad_ref(a, b, sizes, live, bm, sc))
    if fused:
        _hold_pair(res, "autograd_dw2", grads[4], ref[3])
    res["max_abs_err"] = max(v["max_abs_err"] for v in res.values()
                             if isinstance(v, dict) and "max_abs_err" in v)
    if time_it:
        rows, isz = s * k, xs.element_size()
        ends = torch.cumsum(sizes, 0).clamp_max(end).to(torch.int32)
        t = {}
        t["dgdu_ms"] = cuda_time_ms(lambda: tg.dgdu_kernel(
            dz, wo, got, live, bm, w=w, **rc), iters=10)
        t["dgdu_saved_ms"] = cuda_time_ms(lambda: tg.dgdu_kernel(
            dz, wo, got, live, bm, w=w, **saved), iters=10)
        if form == "wgmma":
            # the kernel the wgmma form replaced on the main paths, held
            # and timed through the C entry's form argument
            mma = _dgdu_form(dz, wo, got, live, bm, w, rc, "mma")
            for key, a, b in zip(("dg", "du", "h"), mma()[:3], ref[:3]):
                _hold_pair(res, f"dgdu_mma_{key}", a[:end], b[:end])
            t["dgdu_mma_ms"] = cuda_time_ms(mma, iters=10)
        t["dxs_ms"] = cuda_time_ms(lambda: tg.dxs_kernel(
            rdg, rdu, wg, wi, got, live, bm), iters=10)
        t["dwg_ms"] = cuda_time_ms(lambda: tg.wgrad_kernel(
            xs, rdg, got, live, e, bm), iters=10)
        t["dwi_ms"] = cuda_time_ms(lambda: tg.wgrad_kernel(
            xs, rdu, got, live, e, bm), iters=10)
        t["dwo_ms"] = cuda_time_ms(lambda: tg.wgrad_kernel(
            rh, dz, got, live, e, bm, w), iters=10)
        t["wgrad_ms"] = t["dwg_ms"] + t["dwi_ms"] + t["dwo_ms"]
        t["dgdu_plain_ms"] = cuda_time_ms(lambda: tg.dgdu_ref(
            dz, wo, sizes, live, bm, w=w, **rc), iters=3, warmup=1)
        t["dxs_plain_ms"] = cuda_time_ms(lambda: tg.dxs_ref(
            rdg, rdu, wg, wi, sizes, live, bm), iters=3, warmup=1)
        t["wgrad_plain_ms"] = sum(cuda_time_ms(
            lambda a=a, b=b, sc=sc: tg.wgrad_ref(a, b, sizes, live, bm, sc),
            iters=3, warmup=1) for a, b, sc in ((xs, rdg, None),
                                                (xs, rdu, None), (rh, dz, w)))
        # bounds: the S·k real rows; dgdu 6·d·f FLOP per row (gate and up
        # recomputed, dh), dxs 4·d·f, the three dW products 6·d·f; bytes:
        # each input read once (the weights of the experts used), each
        # output written once (dW for every expert)
        wb = d * f * used * isz
        t["dgdu_bound_ms"], t["dgdu_bound_by"] = bound(
            3 * wb + 2 * rows * d * isz + 3 * rows * f * isz + rows * 4,
            6.0 * d * f * rows, res["dtype"])
        t["dxs_bound_ms"], t["dxs_bound_by"] = bound(
            2 * wb + 2 * rows * f * isz + rows * d * isz,
            4.0 * d * f * rows, res["dtype"])
        t["wgrad_bound_ms"], t["wgrad_bound_by"] = bound(
            3 * d * f * e * isz + 2 * rows * d * isz + 3 * rows * f * isz,
            6.0 * d * f * rows, res["dtype"])
        # yardsticks: torch._grouped_mm where it takes the shape; dgdu has
        # none (no call recomputes gate/up and applies the GLU backward):
        # its three products alone are timed beside it
        wgi_t = torch.cat([wg, wi], dim=-1).transpose(-1, -2)
        t["dxs_library_ms"], t["library"] = _grouped_mm_ms(
            torch.cat([rdg, rdu], dim=1)[:end], wgi_t, ends)
        dwgi = _wgrad_mm_ms(xs[:end], torch.cat([rdg, rdu], 1)[:end], ends)
        dzw = (dz.float() * w.float()[:, None]).to(dtype) if fused else dz
        dwo = _wgrad_mm_ms(rh[:end], dzw[:end], ends)
        t["wgrad_library_ms"] = None if dwgi is None or dwo is None \
            else dwgi + dwo
        prod_gu, _ = _grouped_mm_ms(xs[:end], torch.cat([wg, wi], -1), ends)
        prod_dh, _ = _grouped_mm_ms(dz[:end], wo.transpose(-1, -2), ends)
        t["dgdu_library_ms"] = None
        t["dgdu_products_library_ms"] = prod_gu + prod_dh
        for key in ("dgdu", "dgdu_mma", "dgdu_products_library"):
            if key + "_ms" in t:
                t[key + "_tflops_per_s"] = _tflops(6.0 * d * f * rows,
                                                   t[key + "_ms"])
        t["dxs_tflops_per_s"] = _tflops(4.0 * d * f * rows, t["dxs_ms"])
        t["dxs_library_tflops_per_s"] = _tflops(4.0 * d * f * rows,
                                                t["dxs_library_ms"])
        del wgi_t, dzw
        res.update(t)
    emit(res)
    del xs, wg, wi, wo, dz, ref, rg, ru, grads, leaves, inputs, y
    torch.cuda.empty_cache()
    return res


def phase_grouped_bwd(rng):
    """Phase 3's backward checks: bf16 at the two training shapes (the
    repo's 1B/8e MoE bench, 16,384 tokens; Mixtral 8x7B, 2,048 tokens;
    top-2 of 8), bf16 edges on the wgmma forms of grouped_dxs and
    grouped_wgrad (an empty expert and one with no row, all rows on one
    expert, 60 experts, f off 64 and d off 256, w given and not),
    then a bf16 shape off TMA's 8 (the mma.sync form) and fp32 (the FMA
    form) at awkward shapes. Returns the timed path-shape lines."""
    import torch
    bf16, f32 = torch.bfloat16, torch.float32
    out = {"moe_1b_8e": check_grouped_bwd(
               "gmm_bwd_1b8e_path", rng, 16384, 2, 8, 1024, 2816, bf16,
               True, time_it=True),
           "mixtral": check_grouped_bwd(
               "gmm_bwd_mixtral_path", rng, 2048, 2, 8, 4096, 14336, bf16,
               True, time_it=True)}
    for name, s, k, e, d, f, dtype, fused, kind, form in (
            ("gmm_bwd_bf16_empty_expert", 400, 2, 6, 512, 384, bf16, True,
             "empty", "wgmma"),
            ("gmm_bwd_bf16_one_expert", 300, 2, 5, 256, 512, bf16, False,
             "one", "wgmma"),
            ("gmm_bwd_bf16_60_experts", 512, 4, 60, 256, 192, bf16, True,
             "router", "wgmma"),
            ("gmm_bwd_bf16_f1416_d1032", 600, 2, 8, 1032, 1416, bf16, True,
             "router", "wgmma"),
            ("gmm_bwd_bf16_f1416_d1032_unscaled", 600, 2, 8, 1032, 1416,
             bf16, False, "router", "wgmma"),
            ("gmm_bwd_bf16_split_blocks", 320, 2, 10, 256, 384, bf16, True,
             "split", "wgmma"),
            ("gmm_bwd_bf16_odd_unscaled", 100, 2, 4, 100, 150, bf16, False,
             "router", "mma"),
            ("gmm_bwd_f32_fused", 300, 2, 4, 256, 200, f32, True, "router",
             "fma"),
            ("gmm_bwd_f32_unscaled", 300, 2, 4, 256, 200, f32, False,
             "router", "fma"),
            ("gmm_bwd_f32_empty_expert", 200, 2, 6, 128, 384, f32, True,
             "empty", "fma"),
            ("gmm_bwd_f32_one_expert", 150, 2, 5, 128, 130, f32, False,
             "one", "fma"),
            ("gmm_bwd_f32_one_expert_fused", 150, 2, 5, 128, 130, f32, True,
             "one", "fma"),
            ("gmm_bwd_f32_odd", 90, 3, 4, 130, 70, f32, True, "router",
             "fma")):
        check_grouped_bwd(name, rng, s, k, e, d, f, dtype, fused, kind,
                          form=form)
    return out


def phase_kernels(rng):
    import torch
    bf16, f32 = torch.bfloat16, torch.float32
    path = (32, 8, 128, 128)              # Llama-3 8B: H, KvH, dh, bs
    out = {}
    ctx = [1, 4000] + [int(x) for x in rng.integers(2, 4001, size=14)]
    # the path's shapes, through the serving phase's full-size arena: K2's
    # split form at decode (16 rows of 4000 keys and less; the dense
    # generate batch of 8; Qwen1.5-MoE's heads, g 1; a table as wide as
    # max_seq_len 4096, so that most splits start past their row's ctx,
    # and an empty row), its mma form at split prefill (chunks, and the
    # history-only read at the serving profile's shape)
    out["decode"] = check_paged(
        "paged_decode", rng, 16, 1, [x - 1 for x in ctx], [1] * 16, bf16,
        False, path, "split", serve_arena=True)
    check_paged("paged_decode_lse", rng, 16, 1, [x - 1 for x in ctx],
                [1] * 16, bf16, True, path, "split", time_it=False,
                serve_arena=True)
    ctx8 = [int(x) for x in rng.integers(1, 4001, size=8)]
    out["decode_n8"] = check_paged(
        "paged_decode_n8", rng, 8, 1, [x - 1 for x in ctx8], [1] * 8, bf16,
        True, path, "split", serve_arena=True, mb=32)
    out["decode_g1"] = check_paged(
        "paged_decode_g1", rng, 16, 1, [x - 1 for x in ctx], [1] * 16, bf16,
        True, (16, 16, 128, 128), "split")
    short = [0] + [int(x) for x in rng.integers(1, 2000, size=15)]
    check_paged("paged_decode_past_ctx", rng, 16, 1,
                [max(x - 1, 0) for x in short], [min(x, 1) for x in short],
                bf16, True, path, "split", time_it=False, serve_arena=True,
                mb=32)
    out["chunk"] = check_paged(
        "paged_chunk_lse", rng, 4, 256, [0, 700, 1500, 3000],
        [256, 256, 100, 0], bf16, True, path, "mma", serve_arena=True)
    check_paged("paged_history_lse", rng, 4, 256, [0, 512, 1300, 3000],
                [0, 0, 0, 0], bf16, True, path, "mma", time_it=False,
                serve_arena=True)
    out["history"] = check_paged(
        "paged_history_profile", rng, 8, 256, [0, 256, 512, 768] * 2,
        [0] * 8, bf16, True, path, "mma", serve_arena=True)
    # per-key page addressing (bs 16: a tile spans four pages) in both bf16
    # forms, and dh 64 on the tensor cores with a row block that straddles
    # two heads of the GQA group
    check_paged("paged_chunk_bs16", rng, 3, 40, [0, 37, 300], [40, 9, 0],
                bf16, True, (32, 8, 128, 16), "mma", time_it=False)
    check_paged("paged_decode_bs16", rng, 5, 1, [0, 3, 600, 999, 0],
                [1, 1, 1, 1, 0], bf16, True, (32, 8, 128, 16), "split",
                time_it=False, mb=70)
    check_paged("paged_chunk_dh64", rng, 3, 100, [0, 130, 64], [100, 50, 0],
                bf16, True, (8, 2, 64, 64), "mma", time_it=False)
    # the split form on chunks (g·c = 16 rows of different lengths): row
    # j = 0 of the first sequence ends where a split does, so the next
    # split's partial is empty for it and not for rows j >= 1
    check_paged("paged_chunk_c4_split", rng, 4, 4, [767, 100, 37, 0],
                [4, 2, 0, 3], bf16, True, path, "split", time_it=False,
                mb=32)
    out["fresh"] = check_flash("flash_fresh", rng, 8, 256, (32, 8, 128),
                               bf16, False)
    # the training path's attention: Llama-3 1B heads, micro batch 4 x 2048
    out["train_fwd"] = check_flash("flash_train", rng, 4, 2048,
                                   (16, 8, 128), bf16, False)
    check_flash("flash_with_lse", rng, 8, 256, (32, 8, 128), bf16, True)
    # fp32: long-context decode at the path's heads, then small shapes with
    # ragged lengths, windows, offsets, dh 64, bs 8 and 16, and a row tile
    # that straddles two heads of the GQA group; K1's small shapes in fp32
    # (its CUDA-core kernel) and in bf16 (its tensor-core kernel)
    check_paged("paged_decode_f32", rng, 16, 1, [x - 1 for x in ctx],
                [1] * 16, f32, True, path, "split", time_it=False)
    out["fma"] = check_paged(
        "paged_small_f32", rng, 3, 40, [0, 37, 5], [40, 9, 0], f32, True,
        (4, 2, 64, 16), "fma")
    check_paged("paged_small_decode_f32", rng, 5, 1, [0, 3, 16, 40, 0],
                [1, 1, 1, 1, 0], f32, True, (4, 2, 128, 8), "split",
                time_it=False, mb=40)
    check_paged("paged_chunk_c8_split_f32", rng, 3, 8, [255, 0, 64],
                [8, 5, 0], f32, True, (4, 2, 128, 16), "split",
                time_it=False, mb=40)
    for dtype, tag in ((f32, "f32"), (bf16, "bf16")):
        for name, b, t, dims, with_lse, kw in (
                ("flash_small", 2, 100, (4, 2, 64), True, {}),
                ("flash_small_window", 2, 100, (4, 2, 128), False,
                 {"window": 40, "q_offset": 3}),
                ("flash_small_noncausal", 1, 70, (2, 2, 64), False,
                 {"causal": False}),
                ("flash_small_no_key", 1, 80, (4, 2, 64), False,
                 {"q_offset": -20}),
                ("flash_small_gqa4", 1, 130, (8, 2, 128), False, {})):
            check_flash(f"{name}_{tag}", rng, b, t, dims, dtype, with_lse,
                        time_it=False, **kw)
    # K3: the training path's shape in bf16 (Llama-3 1B: 16 q / 8 kv heads,
    # dh 128, micro batch 4 x 2048), then small cases in fp32 (the CUDA-core
    # kernels) and bf16 (the tensor-core kernels): GQA, ragged T, dh 64,
    # non-causal, window, q_offset and rows that see no key
    out["bwd"] = check_flash_bwd("flash_bwd_path", rng, 4, 2048,
                                 (16, 8, 128), bf16)
    for dtype, tag in ((f32, "f32"), (bf16, "bf16")):
        for name, b, t, dims, kw in (
                ("flash_bwd_gqa", 2, 100, (4, 2, 64), {}),
                ("flash_bwd_noncausal", 1, 70, (4, 2, 128),
                 {"causal": False}),
                ("flash_bwd_window", 2, 150, (4, 2, 128),
                 {"window": 40, "q_offset": 3}),
                ("flash_bwd_q_offset", 1, 90, (2, 1, 64), {"q_offset": 5}),
                ("flash_bwd_no_key", 1, 80, (4, 2, 64), {"q_offset": -20}),
                ("flash_bwd_window_no_key", 2, 64, (4, 2, 128),
                 {"window": 8, "q_offset": 60})):
            check_flash_bwd(f"{name}_{tag}", rng, b, t, dims, dtype,
                            time_it=False, **kw)
    return out


# ---------------------------------------------------------------------------
# phase 3: the weight-only quantized matmuls (K5a/b/c) and the block
# quantizer (K6)
# ---------------------------------------------------------------------------

QUANT_MODES = ("int8", "fp8", "int4", "fp6")
#: Llama-3 8B's linears (K, N): wq/wo, wk/wv, wg/wi, the MLP's wo, the head
QUANT_DENSE_SHAPES = ((4096, 4096), (4096, 1024), (4096, 14336),
                      (14336, 4096), (4096, 128256))
#: Mixtral 8x7B's expert linears on capacity buffers: G 8, (K, N)
QUANT_EXPERT_SHAPES = ((4096, 14336), (14336, 4096))


def _quantized_weight(g, k, n, mode, groups=None):
    """Weights ~ N(0, 1/K) drawn on the card and quantized there, a block
    of at most 16M values at a time (the head is 525M)."""
    import torch
    from deepspeed_tpu_torch.ops.quantized_linear import quantize_weight
    qs, ss = [], []
    for _ in range(groups or 1):
        step = max(1, (1 << 24) // k)
        parts = [quantize_weight(torch.randn((k, min(step, n - j)),
                                             generator=g, device=DEV)
                                 / k ** 0.5, mode)
                 for j in range(0, n, step)]
        qs.append(torch.cat([p[0] for p in parts], dim=-1))
        ss.append(torch.cat([p[1] for p in parts], dim=-1))
    if groups is None:
        return qs[0], ss[0]
    return torch.stack(qs), torch.stack(ss)


def _library_int8pack_ms(x, q, s):
    """torch._weight_int8pack_mm (int8 weight [N, K], per-row scale) where
    this torch has a CUDA kernel for these inputs, else the reason."""
    import torch
    fn = getattr(torch, "_weight_int8pack_mm", None)
    if fn is None:
        return None, "torch has no _weight_int8pack_mm"
    wt = q.t().contiguous()
    sc = s.to(x.dtype)
    try:
        fn(x, wt, sc)
        torch.cuda.synchronize()
    except (RuntimeError, TypeError, NotImplementedError) as e:
        return None, f"no CUDA kernel for these inputs: {str(e)[:120]}"
    return cuda_time_ms(lambda: fn(x, wt, sc)), "torch._weight_int8pack_mm"


def graph_time_ms(fn, args, reps: int = 3) -> float:
    """Device time of fn(a) per call, without the host's per-call cost:
    one CUDA graph of at least 20 calls taking ``args`` in turn, replayed
    ``reps`` times between two events."""
    import torch
    n = -(-max(20, 2 * len(args)) // len(args)) * len(args)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for a in args[:2]:
            fn(a)              # builds, and allocates this stream's buffers
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side, capture_error_mode="relaxed"):
        for i in range(n):
            fn(args[i % len(args)])
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    torch.cuda.empty_cache()
    return start.elapsed_time(end) / (reps * n)


def host_us(fn, calls: int = 200) -> float:
    """The host's time per call of fn in microseconds: ``calls`` calls
    back to back, no synchronisation between them (the launch queue does
    not fill at this count)."""
    import torch
    for _ in range(20):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    us = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    return us


def _l2_cold_copies(w, l2_bytes: float = 50e6):
    """w and copies of it, together at least twice the L2: taken in turn,
    none is in L2 when it is read."""
    return [w] + [w.clone() for _ in range(
        max(1, -(-int(2 * l2_bytes) // (w.numel() * w.element_size())) - 1))]


def check_qmm(name, rng, mode, m, k, n, dtype, out_dtype=None, groups=None,
              time_it=True):
    """One quantized matmul on the card against its plain version: x [M,
    K] (or [G, M, K]) ~ N(0, 1) in ``dtype`` times a quantized N(0, 1/K)
    weight, through qmatmul / qmatmul_batched (which count the launch).
    Timed: the kernel, the plain version, the bound (weight bytes, x, the
    scale and out each moved once, or 2·M·K·N at the peak of x's type),
    and the GEMM quantization replaces: bf16 ``torch.matmul`` (``bmm``
    batched) on the weight dequantized in advance; for int8 also
    ``torch._weight_int8pack_mm`` where the card's torch has it."""
    import torch
    from deepspeed_tpu_torch.ops import quantized_linear as tq
    dev = torch.device(DEV)
    g = torch.Generator(device=dev).manual_seed(int(rng.integers(1 << 30)))
    q, s = _quantized_weight(g, k, n, mode, groups)
    lead = (m, k) if groups is None else (groups, m, k)
    x = torch.randn(lead, generator=g, device=dev).to(dtype)
    batched = groups is not None
    kernel = ("quantized_matmul_packed" if mode in ("int4", "fp6") else
              "quantized_matmul_batched" if batched else "quantized_matmul")
    fn = (lambda: tq.qmatmul_batched(x, q, s, out_dtype)) if batched else \
        (lambda: tq.qmatmul(x, q, s, out_dtype))
    pl = tq.plan(mode, dtype, groups or 1, m, k, n)
    before = dict(tq.op_builder.launches)
    before_form = tq.regime_launches[kernel][pl.regime]
    out = fn()
    torch.cuda.synchronize()
    assert tq.op_builder.launches[kernel] == before[kernel] + 1, kernel
    assert tq.regime_launches[kernel][pl.regime] == before_form + 1, pl
    plain = (lambda: tq.qmatmul_batched_ref(x, q, s, out_dtype)) \
        if batched else (lambda: tq.qmatmul_ref(x, q, s, out_dtype))
    ref = plain()
    res = {"phase": "kernels", "check": name, "kernel": kernel,
           "mode": mode, "dtype": str(dtype).replace("torch.", ""),
           "out_dtype": str(out.dtype).replace("torch.", ""),
           "shape": {"G": groups, "M": m, "K": k, "N": n},
           "plan": dict(pl._asdict(), grid=list(pl.grid))}
    _hold_pair(res, "out", out, ref)
    res["max_abs_err"] = res["out"]["max_abs_err"]
    if time_it:
        wbytes = q.numel() * q.element_size() + s.numel() * 4
        nbytes = wbytes + x.numel() * x.element_size() \
            + out.numel() * out.element_size()
        flops = 2.0 * m * k * n * (groups or 1)
        res["kernel_ms"] = cuda_time_ms(fn, iters=10)
        res["plain_ms"] = cuda_time_ms(plain, iters=2, warmup=1)
        res["bound_ms"], res["bound_by"] = bound(nbytes, flops, res["dtype"])
        res["weight_gb_per_s"] = wbytes / res["kernel_ms"] / 1e6
        res["tflops_per_s"] = flops / res["kernel_ms"] / 1e9
        res["blocks"] = pl.grid[0] * pl.grid[1] * pl.grid[2]
        res["blocks_per_sm"] = res["blocks"] / \
            torch.cuda.get_device_properties(0).multi_processor_count
        wd = tq.dequantize_weight(q, s).to(torch.bfloat16)
        xb = x.bfloat16()
        lib = (lambda w: torch.bmm(xb, w)) if batched else \
            (lambda w: torch.matmul(xb, w))
        res["library_ms"] = cuda_time_ms(lambda: lib(wd), iters=10)
        res["library"] = "bf16 torch.matmul on the weight dequantized " \
            "in advance" + (" (bmm)" if batched else "")
        if m == 16:
            # decode: device time without the host's per-call cost (a CUDA
            # graph of back-to-back calls), L2-warm (one weight) and
            # L2-cold (copies past the 50 MB L2 in turn: a served model
            # reads each layer's weights once a step, with no L2 hits)
            kfn = (lambda w: tq.qmatmul_batched(x, w, s, out_dtype)) \
                if batched else (lambda w: tq.qmatmul(x, w, s, out_dtype))
            res["kernel_graph_ms"] = graph_time_ms(kfn, [q])
            res["library_graph_ms"] = graph_time_ms(lib, [wd])
            res["kernel_cold_ms"] = graph_time_ms(kfn, _l2_cold_copies(q))
            res["library_cold_ms"] = graph_time_ms(lib, _l2_cold_copies(wd))
            res["cold_weight_gb_per_s"] = wbytes / res["kernel_cold_ms"] / 1e6
            # what a served decode step pays on the host for each call
            res["kernel_host_us"] = host_us(fn)
            res["library_host_us"] = host_us(lambda: lib(wd))
        del wd
        if mode == "int8" and not batched:
            res["int8pack_ms"], res["int8pack"] = _library_int8pack_ms(
                xb, q, s)
    emit(res)
    del q, s, x, out, ref
    torch.cuda.empty_cache()
    return res


def check_quantize_blocks(name, rng, n, dtype, block=256, offset=0,
                          time_it=False):
    """K6 on a flat tensor against its plain version: q bit-identical,
    the scales exact. ``offset`` starts x one element into a buffer (no
    16-byte loads); rows of zeros give scale 0."""
    import torch
    from deepspeed_tpu_torch.ops import quantizer as tqb
    dev = torch.device(DEV)
    g = torch.Generator(device=dev).manual_seed(int(rng.integers(1 << 30)))
    buf = torch.empty(n + offset, dtype=dtype, device=dev)
    step = 1 << 26
    for i in range(0, n + offset, step):
        j = min(i + step, n + offset)
        buf[i:j] = (torch.randn(j - i, generator=g, device=dev) * 3).to(dtype)
    x = buf[offset:]
    x[block:2 * block] = 0
    before = tqb.op_builder.launches["quantize_blocks"]
    q, s = tqb.quantize_blocks_pallas(x, block)
    torch.cuda.synchronize()
    assert tqb.op_builder.launches["quantize_blocks"] == before + 1
    rq, rs = tqb.quantize_blocks_ref(x, block)
    res = {"phase": "kernels", "check": name, "kernel": "quantize_blocks",
           "dtype": str(dtype).replace("torch.", ""),
           "shape": {"n": n, "block": block, "offset": offset},
           "q_mismatches": int((q != rq).sum()),
           "scale_mismatches": int((s != rs).sum()),
           "max_abs_err": float((q.float() - rq.float()).abs().max()),
           "tol": "bit-identical"}
    del rq, rs
    if res["q_mismatches"] or res["scale_mismatches"] or s[1] != 0:
        emit(dict(res, failed=True))
        raise AssertionError(f"{name}: quantize_blocks disagrees with its "
                             f"plain version")
    if time_it:
        res["kernel_ms"] = cuda_time_ms(
            lambda: tqb.quantize_blocks_pallas(x, block), iters=10)
        res["plain_ms"] = cuda_time_ms(
            lambda: tqb.quantize_blocks_ref(x, block), iters=2, warmup=1)
        res["bound_ms"], res["bound_by"] = bound(
            n * (x.element_size() + 1) + (n // block) * 4, 3.0 * n,
            "float32")
        res["library_ms"] = None      # no PyTorch call quantizes by blocks
    emit(res)
    del buf, x, q, s
    torch.cuda.empty_cache()
    return res


def phase_quant(rng):
    """Phase 3's quantized-matmul and quantizer checks. bf16 at Llama-3
    8B's linears in all four formats, decode (M 16) and prefill (M 2048),
    the head with fp32 output; Mixtral 8x7B's experts on capacity buffers
    (G 8, M 16 and 512); fp32 at awkward shapes (M 1 and 3, K and N off 16
    and off 256, dense and batched; bf16 too); K6 on Llama-3 1B's gradient
    (the size ZeRO++ quantizes) and small fp32/bf16 ones. Returns the
    lines of the kernels table's shapes."""
    import torch
    from deepspeed_tpu_torch import llama3_config
    torch.backends.cuda.matmul.allow_tf32 = False
    bf16, f32 = torch.bfloat16, torch.float32
    out = {}
    for mode in QUANT_MODES:
        for k, n in QUANT_DENSE_SHAPES:
            head = n == 128256
            for m in (16, 2048):
                res = check_qmm(f"qmm_{mode}_m{m}_{k}x{n}", rng, mode, m, k,
                                n, bf16, f32 if head else None)
                out[(mode, None, m, k, n)] = res
        for k, n in QUANT_EXPERT_SHAPES:
            for m in (16, 512):
                out[(mode, 8, m, k, n)] = check_qmm(
                    f"qmm_batched_{mode}_g8_m{m}_{k}x{n}", rng, mode, m, k,
                    n, bf16, groups=8)
        # the edges of both bf16 regimes (split-K up to M 64, wgmma above)
        # at K 4288, whose 67 steps of 64 rows no slice count divides and
        # whose last wgmma step is ragged in every format; a ragged last
        # x box of each group (G 8, M 100); the shapes TMA cannot address
        # (K and N off 16 and off 256: split-K unsplit above M 64)
        for name, m, k, n, dt, groups in (
                ("f32_m1", 1, 200, 77, f32, None),
                ("f32_m3", 3, 1000, 1030, f32, None),
                ("bf16_m3", 3, 1000, 1030, bf16, None),
                ("f32_batched", 5, 200, 77, f32, 3),
                ("bf16_batched", 70, 1000, 1030, bf16, 2),
                ("bf16_m1_k4288", 1, 4288, 4096, bf16, None),
                ("bf16_m3_k4288", 3, 4288, 4096, bf16, None),
                ("bf16_m16_k4288", 16, 4288, 4096, bf16, None),
                ("bf16_m64_k4288", 64, 4288, 4096, bf16, None),
                ("bf16_m65_k4288", 65, 4288, 4096, bf16, None),
                ("bf16_m128_k4288", 128, 4288, 4096, bf16, None),
                ("bf16_m300_k4288", 300, 4288, 4096, bf16, None),
                ("bf16_m16_k4288_n1024", 16, 4288, 1024, bf16, None),
                ("bf16_batched_g8_m1", 1, 4288, 2048, bf16, 8),
                ("bf16_batched_g8_m64", 64, 4288, 2048, bf16, 8),
                ("bf16_batched_g8_m100", 100, 4288, 2048, bf16, 8)):
            check_qmm(f"qmm_{mode}_{name}", rng, mode, m, k, n, dt,
                      groups=groups, time_it=False)
    cfg = llama3_config(TRAIN_MODEL[0], **TRAIN_MODEL[1])
    n_grad = cfg.num_params() // 256 * 256
    out["quantize_blocks"] = check_quantize_blocks(
        "quantize_blocks_llama3_1b_grad", rng, n_grad, bf16, time_it=True)
    for name, n, dt, block, offset in (
            ("quantize_blocks_f32", 256 * 1000, f32, 256, 0),
            ("quantize_blocks_f32_unaligned", 256 * 333, f32, 256, 1),
            ("quantize_blocks_bf16_block100", 100 * 999, bf16, 100, 0),
            ("quantize_blocks_f32_block128", 128 * 777, f32, 128, 0)):
        check_quantize_blocks(name, rng, n, dt, block, offset)
    return out


# ---------------------------------------------------------------------------
# phase 4: ragged_forward on the card against the CPU at full width
# ---------------------------------------------------------------------------

def phase_full_width():
    """Depth-2 Llama-3 8B width, fp32: one fresh chunk, one split chunk
    and one decode step through ragged_forward, on the card (kernels) and
    on the CPU (plain versions) with the same weights and inputs.

    Tolerance: atol 2e-3 and rtol 2e-3 on logits of magnitude ~1. Both
    sides are fp32 (TF32 off), so they differ only by summation order in
    GEMMs over 4096 / 14336 terms and in the attention reductions; a
    wrong mask, page or merge moves logits by O(0.1)."""
    import torch
    from deepspeed_tpu_torch import llama3_config
    from deepspeed_tpu_torch.inference.engine_v2 import ragged_forward
    from deepspeed_tpu_torch.models.transformer import init_params
    from deepspeed_tpu_torch.ops import op_builder
    from deepspeed_tpu_torch.ops.paged_attention import init_arena
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = llama3_config("8b", num_layers=2)
    gen = torch.Generator(device=DEV).manual_seed(1)
    t0 = time.perf_counter()
    p_gpu = init_params(cfg, gen, torch.float32, DEV)

    def to_cpu(tree):
        return {k: to_cpu(v) for k, v in tree.items()} \
            if isinstance(tree, dict) else tree.cpu()

    p_cpu = to_cpu(p_gpu)
    init_s = time.perf_counter() - t0
    nb, bs, mb = 16, 128, 8
    arenas = {d: init_arena(cfg.num_layers, cfg.kv_heads, nb, bs,
                            cfg.head_dim, torch.float32, d)
              for d in (DEV, "cpu")}
    pt = np.full((3, mb), nb, np.int32)
    pt[0, :2], pt[1, :3], pt[2, :5] = [3, 0], [7, 1, 12], [2, 9, 4, 15, 5]
    rng = np.random.default_rng(2)
    steps = [("fresh", 256, [0, 0, 0], [200, 256, 256]),
             ("split", 256, [200, 256, 256], [1, 100, 256]),
             ("decode", 1, [201, 356, 512], [1, 1, 1])]
    tol = 2e-3
    worst = 0.0
    for mode, c, starts, counts in steps:
        tokens = rng.integers(0, cfg.vocab_size, size=(3, c)).astype(np.int32)
        logits = {}
        op_builder.reset_launches()
        for d, params in (("card", p_gpu), ("cpu", p_cpu)):
            where = DEV if d == "card" else "cpu"
            args = [torch.from_numpy(np.asarray(a, np.int32)).to(where)
                    for a in (tokens, counts, starts, pt)]
            with torch.no_grad():
                lg, arenas[where] = ragged_forward(
                    cfg, params, arenas[where], *args,
                    fresh_prefill=False if mode == "decode" else mode)
            logits[d] = lg.cpu()
        launched = dict(op_builder.launches)
        want = {"fresh": {"flash_attention_fwd"},
                "split": {"flash_attention_fwd", "paged_attention"},
                "decode": {"paged_attention"}}[mode]
        assert {k for k, v in launched.items() if v} == want, \
            f"{mode} step launched {launched}"
        assert torch.isfinite(logits["card"]).all()
        err = _err(logits["card"], logits["cpu"])
        worst = max(worst, err)
        emit({"phase": "full_width", "mode": mode, "max_abs_err": err,
              "tol": tol, "logit_absmax": float(logits["cpu"].abs().max()),
              "launches": launched})
        torch.testing.assert_close(logits["card"], logits["cpu"], rtol=tol,
                                   atol=tol)

    # the bf16 head returns fp32 sums of the exact bf16 products, as the
    # JAX package's preferred_element_type=float32: held against the fp32
    # GEMM of the same bf16 values (summation order only, 1e-4), and it
    # must not be rounded to bf16 (whose step at |logit| ~ 1 is 8e-3)
    from deepspeed_tpu_torch.models.transformer import lm_logits
    x = torch.randn((8, 1, cfg.hidden_size), generator=gen,
                    device=DEV).bfloat16()
    head = {"lm_head": p_gpu["lm_head"].bfloat16()}
    lg = lm_logits(cfg, head, x)
    ref = x.float() @ head["lm_head"].float()
    head_err = _err(lg, ref)
    emit({"phase": "full_width", "check": "lm_logits_bf16",
          "dtype": str(lg.dtype), "max_abs_err": head_err, "tol": 1e-4,
          "logit_absmax": float(ref.abs().max())})
    assert lg.dtype == torch.float32
    torch.testing.assert_close(lg, ref, rtol=1e-4, atol=1e-4)
    assert not torch.equal(lg.bfloat16().float(), lg)
    del p_gpu, p_cpu, arenas, head
    torch.cuda.empty_cache()
    emit({"phase": "full_width", "init_seconds": init_s, "worst": worst})


def phase_full_width_moe():
    """Depth-2 Mixtral 8x7B width, fp32: a fresh 4 x 256 chunk (1024
    tokens, so the dropless FFN: grouped kernels on the card) and a decode
    step (4 tokens, the capacity FFN) through ragged_forward, on the card
    and on the CPU (plain versions) from one parameter tree. Tolerance as
    in phase_full_width (2e-3; sums over 4096 and 14336 terms in other
    orders)."""
    import torch
    from deepspeed_tpu_torch.inference.engine_v2 import ragged_forward
    from deepspeed_tpu_torch.models.mixtral import mixtral_config
    from deepspeed_tpu_torch.models.transformer import init_params
    from deepspeed_tpu_torch.ops import op_builder
    from deepspeed_tpu_torch.ops.paged_attention import init_arena
    from deepspeed_tpu_torch.parallel.moe import serving_moe_fn
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = mixtral_config("8x7b", num_layers=2)
    t0 = time.perf_counter()
    p_gpu = init_params(cfg, torch.Generator(device=DEV).manual_seed(4),
                        torch.float32, DEV)
    p_cpu = _to_cpu(p_gpu)
    init_s = time.perf_counter() - t0
    nb, bs, mb = 16, 128, 4
    arenas = {d: init_arena(cfg.num_layers, cfg.kv_heads, nb, bs,
                            cfg.head_dim, torch.float32, d)
              for d in (DEV, "cpu")}
    pt = np.full((4, mb), nb, np.int32)
    pt[0, :3], pt[1, :3], pt[2, :3], pt[3, :2] = \
        [3, 0, 8], [7, 1, 12], [2, 9, 4], [15, 5]
    rng = np.random.default_rng(5)
    tol, worst = 2e-3, 0.0
    for mode, c, starts, counts in (("fresh", 256, [0] * 4,
                                     [256, 256, 256, 200]),
                                    ("decode", 1, [256, 256, 256, 200],
                                     [1] * 4)):
        tokens = rng.integers(0, cfg.vocab_size, size=(4, c)).astype(np.int32)
        logits = {}
        op_builder.reset_launches()
        for where, params in ((DEV, p_gpu), ("cpu", p_cpu)):
            args = [torch.from_numpy(np.asarray(a, np.int32)).to(where)
                    for a in (tokens, counts, starts, pt)]
            with torch.no_grad():
                lg, arenas[where] = ragged_forward(
                    cfg, params, arenas[where], *args,
                    moe_fn=serving_moe_fn(cfg, None, params, ep=False),
                    fresh_prefill=False if mode == "decode" else mode)
            logits[where] = lg.cpu()
        launched = dict(op_builder.launches)
        want = {"fresh": {"flash_attention_fwd", *GROUPED_KERNELS},
                "decode": {"paged_attention"}}[mode]
        assert {k for k, v in launched.items() if v} == want, \
            f"{mode} step launched {launched}"
        assert torch.isfinite(logits[DEV]).all()
        err = _err(logits[DEV], logits["cpu"])
        worst = max(worst, err)
        emit({"phase": "full_width_moe", "model": "mixtral-8x7b-width-depth2",
              "mode": mode, "tokens": 4 * c, "max_abs_err": err, "tol": tol,
              "logit_absmax": float(logits["cpu"].abs().max()),
              "launches": launched})
        torch.testing.assert_close(logits[DEV], logits["cpu"], rtol=tol,
                                   atol=tol)
    del p_gpu, p_cpu, arenas
    torch.cuda.empty_cache()
    emit({"phase": "full_width_moe", "init_seconds": init_s, "worst": worst})


# ---------------------------------------------------------------------------
# phase 5: Llama-3 8B end to end
# ---------------------------------------------------------------------------

def _serve_loop(eng, prompts, new, k, mode=("argmax",)):
    """The serving frontend's entry point ``step_with_budget(max_steps=k)``
    (k 1: the stepwise loop; k > 1: decode megasteps, each a window of up
    to k replays of the captured step) driven as ``generate`` drives its
    own loop: every prompt prefilled first, then every row's last token
    fed back by ``scheduler.put`` until it has ``new`` tokens, so that each
    decode step holds the same rows as generate's. Returns the new tokens
    of each prompt."""
    base = max(eng.state.seqs.keys(), default=-1) + 1
    uids = [base + i for i in range(len(prompts))]
    eng.scheduler.put(uids, prompts)
    out = {u: [] for u in uids}

    def step():
        res = eng.step_with_budget(
            mode=mode, max_steps=k,
            row_limits={u: new - len(out[u]) for u in uids
                        if u in eng.state.seqs})
        for u, toks in (res or {}).items():
            toks = toks if isinstance(toks, list) else [toks]
            out[u].extend(int(t) for t in toks[:new - len(out[u])])
        return res

    while step() is not None:            # the prefill
        pass
    while eng.state.seqs.keys() & set(uids):
        for u in uids:
            if u not in eng.state.seqs:
                continue
            if len(out[u]) >= new:
                eng.flush(u)
            else:
                eng.scheduler.put([u], [[out[u][-1]]])
        if eng.state.seqs.keys() & set(uids):
            step()
    return [out[u] for u in uids]


def _graphs(eng, label: str) -> dict:
    """The engine's decode graphs since it was made, its stats counted
    from the same start. Every decode window of its generate/serve/
    megastep runs replayed a captured step: replays > 0, and no decode
    step of those loops was forced onto the stepwise path (phase 5's
    arenas hold every window). A replay's launches are counted from its
    capture's record, not at the wrappers, so the product is held to the
    steps: every decode step, replayed or eager, and the eager warm-up
    before each capture launch K2 once a layer."""
    gs = dict(eng.graph_stats)
    assert gs["graphs"] > 0 and gs["replays"] > 0, (label, gs)
    assert gs["fallback_steps"] == 0, (label, gs)
    dec = eng.stats["decode"]
    want = eng.model_config.num_layers * (dec["steps"] + gs["graphs"])
    assert dec["launches"]["paged_attention"] == want, (label, want, dec, gs)
    gs["eager_decode_steps"] = dec["steps"] - gs["replays"]
    return gs


def _profiled_window(eng, prompts, kernels: dict) -> dict:
    """The frontend's loop at K 8 on ``prompts`` for 9 new tokens (the
    prefill, then one decode megastep window of 8 replays) under
    ``torch.profiler``: for each kernel name of ``kernels`` (name → a
    function reading the wrapper's counter of that kernel), the kernels
    the card ran, read from the trace, equal what the counter counted.
    Launches the replays ran are counted from the capture's record, so
    this holds that record to the card."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    before = {name: get() for name, get in kernels.items()}
    r0 = eng.graph_stats["replays"]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _serve_loop(eng, prompts, 9, 8)
        torch.cuda.synchronize()
    replays = eng.graph_stats["replays"] - r0
    assert replays == 8, replays
    ran = {}
    for name, get in kernels.items():
        ran[name] = sum(1 for e in prof.events()
                        if e.device_type == DeviceType.CUDA
                        and name in e.name)
        counted = get() - before[name]
        assert ran[name] == counted > 0, (name, ran[name], counted)
    return {"replays": replays, "launches_traced_equal_counted": ran}


def phase_fused_fp32():
    """Fused decode = stepwise decode in fp32 on the card: Llama-3 8B at
    full width and depth 2, ``generate`` (windows of replays of the
    captured step) against the stepwise loop over 32 new tokens on 4
    ragged prompts, token for token."""
    import torch
    from deepspeed_tpu_torch import RaggedInferenceEngine, llama3_config
    cfg = llama3_config(SERVE_MODEL[0], **dict(SERVE_MODEL[1], num_layers=2))
    eng = RaggedInferenceEngine(
        cfg, {"dtype": "float32", "num_blocks": 64, "block_size": 128,
              "max_seq_len": 2048, "max_batch_tokens": 2048,
              "prefill_chunk": 256},
        generator=torch.Generator(device=DEV).manual_seed(5), device=DEV)
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, cfg.vocab_size, size=n).astype(np.int32)
               for n in (64, 300, 128, 513)]
    fused = [o[len(p):].tolist() for p, o in
             zip(prompts, eng.generate(prompts, max_new_tokens=32))]
    step = _serve_loop(eng, prompts, 32, 1)
    assert fused == step, "fp32: fused decode differs from stepwise"
    emit({"phase": "fused_decode_fp32", "model": "llama3-8b-2L",
          "dtype": "float32", "new_tokens": 32, "prompts": len(prompts),
          "identical": True, "graphs": _graphs(eng, "fp32")})
    del eng
    torch.cuda.empty_cache()


def phase_serve():
    import torch
    from deepspeed_tpu_torch import RaggedInferenceEngine, llama3_config
    from deepspeed_tpu_torch.inference.engine_v2 import (
        dispatch_counts, reset_dispatch_counts)
    from deepspeed_tpu_torch.ops import op_builder
    from deepspeed_tpu_torch.ops import paged_attention as pa
    cfg = llama3_config(SERVE_MODEL[0], **SERVE_MODEL[1])
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    eng = RaggedInferenceEngine(
        cfg, {"dtype": "bfloat16", "num_blocks": SERVE_BLOCKS,
              "block_size": 128,
              "max_seq_len": 4096, "max_sequences": 64,
              "max_batch_tokens": 2048, "prefill_chunk": 256},
        generator=torch.Generator(device=DEV).manual_seed(0), device=DEV)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    rng = np.random.default_rng(3)
    lens = [64, 1500, 300, 777, 128, 1024, 513, 900]
    prompts = [rng.integers(0, cfg.vocab_size, size=n).astype(np.int32)
               for n in lens]
    req_lens = rng.integers(16, 700, size=16)
    requests = [rng.integers(0, cfg.vocab_size, size=int(n)).astype(np.int32)
                for n in req_lens]
    budgets = [int(b) for b in rng.integers(8, 49, size=16)]

    # the main path: every count set to 0 just before, read just after
    op_builder.reset_launches()
    pa.reset_form_launches()
    reset_dispatch_counts()
    eng.stats.clear()
    t1 = time.perf_counter()
    outs = eng.generate(prompts, max_new_tokens=32)
    gen_s = time.perf_counter() - t1
    gen_stats = {k: dict(v, launches=dict(v["launches"]))
                 for k, v in eng.stats.items()}
    t2 = time.perf_counter()
    served = eng.serve(requests, max_new_tokens=budgets, max_concurrency=8)
    serve_s = time.perf_counter() - t2
    # the decode megastep: the frontend's loop at K 8 on the same prompts
    dec0 = dict(eng.stats["decode"])
    t3 = time.perf_counter()
    mega = _serve_loop(eng, prompts, 32, 8)
    mega_s = time.perf_counter() - t3
    mega_steps = eng.stats["decode"]["steps"] - dec0["steps"]
    mega_dec_s = eng.stats["decode"]["seconds"] - dec0["seconds"]
    launches = dict(op_builder.launches)
    paged_forms = _paged_forms(eng.stats)
    dispatch = dict(dispatch_counts)
    graphs = _graphs(eng, "serve")
    st = {k: dict(v, launches=dict(v["launches"]))
          for k, v in eng.stats.items()}
    assert dispatch["megastep_launches"] > 0, dispatch

    # fused = stepwise in bf16 at full depth: generate's windows (31
    # steps), the megastep's (8) and the stepwise loop give one stream
    fused = [o[len(p):].tolist() for p, o in zip(prompts, outs)]
    step = _serve_loop(eng, prompts, 32, 1)
    assert fused == mega == step, "bf16: fused decode differs from stepwise"
    # sampled: one window of 8 = two of 4 = the stepwise loop, from one
    # generator state (each decode step draws once, replayed or not)
    eng._temperature = 0.8
    sampled = []
    for k in (8, 4, 1):
        eng._generator.manual_seed(11)
        sampled.append(_serve_loop(eng, prompts[:4], 9, k,
                                   mode=("sample", 0, False)))
    assert sampled[0] == sampled[1] == sampled[2], sampled
    traced = _profiled_window(eng, prompts, {
        "paged_attn_split_kernel":
            lambda: pa.form_launches["paged_attention"]["split"]})
    assert traced["launches_traced_equal_counted"][
        "paged_attn_split_kernel"] == cfg.num_layers * 8, traced

    for p, o in zip(prompts, outs):
        assert len(o) == len(p) + 32 and (o[:len(p)] == p).all()
        assert ((o >= 0) & (o < cfg.vocab_size)).all()
    for p, o, m in zip(requests, served, budgets):
        assert len(o) == len(p) + m and (o[:len(p)] == p).all()
    assert not eng.state.seqs
    assert eng.state.allocator.free_blocks == SERVE_BLOCKS, "pages leaked"
    for mode in ("fresh", "split", "decode"):
        assert mode in st, f"no {mode} step ran"
    assert st["fresh"]["launches"]["flash_attention_fwd"] > 0
    assert st["split"]["launches"]["flash_attention_fwd"] > 0
    assert st["split"]["launches"]["paged_attention"] > 0
    assert st["decode"]["launches"]["paged_attention"] > 0
    assert st["decode"]["launches"]["flash_attention_fwd"] == 0
    assert all(launches[k] > 0 for k in SERVE_KERNELS), launches
    assert launches["flash_attention_bwd"] == 0, launches

    per_step = {k: v / st["decode"]["steps"]
                for k, v in st["decode"]["launches"].items()}
    emit({"phase": "serve", "model": "llama3-" + SERVE_MODEL[0],
          "dtype": "bfloat16",
          "init_seconds": init_s, "generate_seconds": gen_s,
          "serve_seconds": serve_s, "megastep_seconds": mega_s,
          "megastep_decode_ms_per_step": 1e3 * mega_dec_s / mega_steps,
          "fused_equals_stepwise": True, "sampled_8_equals_4_4": True,
          "decode_graphs": graphs, "traced_window": traced,
          "dispatch": dispatch,
          "generate_prefill_tok_s": _rate(("fresh", "split"), gen_stats),
          "generate_decode_tok_s": _rate(("decode",), gen_stats),
          "prefill_tok_s": _rate(("fresh", "split"), st),
          "decode_tok_s": _rate(("decode",), st),
          "decode_ms_per_step": 1e3 * st["decode"]["seconds"]
          / st["decode"]["steps"],
          "stats": st, "launches": launches,
          "paged_launches_by_form": paged_forms,
          "launches_per_decode_step": per_step,
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9})
    del eng                    # the MoE runs need the card's memory
    torch.cuda.empty_cache()
    return launches


def _grouped_forms(launches) -> dict:
    """The planned grouped kernels' launches by form (gate_up, down, dgdu,
    dxs, wgrad) since the last reset, added to GROUPED_FORM_LAUNCHES. A bf16
    main path (every shape of the repo's MoE models is TMA-aligned)
    launches the wgmma forms alone."""
    from deepspeed_tpu_torch.ops import grouped_matmul as tg
    forms = {k: dict(v) for k, v in tg.form_launches.items()}
    for k, v in forms.items():
        assert v["wgmma"] == launches[k] and v["fma"] == v["mma"] == 0, forms
        for f, c in v.items():
            GROUPED_FORM_LAUNCHES[k][f] += c
    return forms


def _paged_forms(stats) -> dict:
    """K2's launches by form since the last reset, added to
    PAGED_FORM_LAUNCHES. A bf16 serving run launches K2 in two modes:
    decode (one token a row: g <= 16 rows a kv head) takes the split form
    alone, the history read of split prefill (256-token chunks) the mma
    form alone; fresh prefill launches none."""
    from deepspeed_tpu_torch.ops import paged_attention as pa
    forms = dict(pa.form_launches["paged_attention"])
    want = {"fma": 0, "split": 0, "mma": 0}
    for mode, form in (("decode", "split"), ("split", "mma")):
        if mode in stats:
            want[form] = stats[mode]["launches"]["paged_attention"]
    assert forms == want and forms["split"] > 0, (forms, want)
    for f, c in forms.items():
        PAGED_FORM_LAUNCHES[f] += c
    return forms


def _rate(kinds, src):
    tok = sum(src[k]["tokens"] for k in kinds if k in src)
    sec = sum(src[k]["seconds"] for k in kinds if k in src)
    return tok / sec if sec else None


def phase_serve_moe():
    """The MoE serving runs of MOE_RUNS in bf16 with random weights from a
    seeded generator, one engine at a time: ``generate`` on 8 prompts (the
    first step 8 x 256 = 2048 tokens: the dropless FFN through the grouped
    kernels; decode steps take the capacity FFN), then, where asked,
    ``serve`` on 16 requests at max_concurrency=8. Returns the kernels'
    launch counts summed over the runs, each run counted from 0."""
    import torch
    from deepspeed_tpu_torch import RaggedInferenceEngine
    from deepspeed_tpu_torch.models.mixtral import mixtral_config
    from deepspeed_tpu_torch.models.qwen2_moe import qwen2_moe_config
    from deepspeed_tpu_torch.ops import grouped_matmul as tg
    from deepspeed_tpu_torch.ops import op_builder
    from deepspeed_tpu_torch.ops import paged_attention as pa
    presets = {"mixtral": mixtral_config, "qwen2_moe": qwen2_moe_config}
    total = {k: 0 for k in op_builder.launches}
    for i, (name, family, size, over, blocks, lens, new, n_req) in \
            enumerate(MOE_RUNS):
        cfg = presets[family](size, **over)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        eng = RaggedInferenceEngine(
            cfg, {"dtype": "bfloat16", "num_blocks": blocks,
                  "block_size": 128, "max_seq_len": 2048,
                  "max_sequences": 64, "max_batch_tokens": 2048,
                  "prefill_chunk": 256},
            generator=torch.Generator(device=DEV).manual_seed(10 + i),
            device=DEV)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        init_gb = torch.cuda.memory_allocated() / 1e9   # weights + arena
        rng = np.random.default_rng(20 + i)
        prompts = [rng.integers(0, cfg.vocab_size, size=n).astype(np.int32)
                   for n in lens]
        requests = [rng.integers(0, cfg.vocab_size, size=int(n))
                    .astype(np.int32) for n in rng.integers(16, 700, n_req)]
        budgets = [int(b) for b in rng.integers(8, 49, size=n_req)]

        # the main path: every count set to 0 just before, read just after
        op_builder.reset_launches()
        tg.reset_form_launches()
        pa.reset_form_launches()
        eng.stats.clear()
        t1 = time.perf_counter()
        outs = eng.generate(prompts, max_new_tokens=new)
        gen_s = time.perf_counter() - t1
        gen_stats = {k: dict(v, launches=dict(v["launches"]))
                     for k, v in eng.stats.items()}
        t2 = time.perf_counter()
        served = eng.serve(requests, max_new_tokens=budgets,
                           max_concurrency=8) if n_req else []
        serve_s = time.perf_counter() - t2
        launches = dict(op_builder.launches)
        forms = _grouped_forms(launches)
        paged_forms = _paged_forms(eng.stats)
        graphs = _graphs(eng, name)

        for p, o in zip(prompts, outs):
            assert len(o) == len(p) + new and (o[:len(p)] == p).all()
            assert ((o >= 0) & (o < cfg.vocab_size)).all()
        for p, o, m in zip(requests, served, budgets):
            assert len(o) == len(p) + m and (o[:len(p)] == p).all()
        assert not eng.state.seqs
        assert eng.state.allocator.free_blocks == blocks, "pages leaked"
        st = eng.stats
        # the 2048-token first step went through the grouped kernels;
        # decode (8 rows) took the capacity path and launched none
        assert all(st["fresh"]["launches"][k] >= cfg.num_layers
                   for k in GROUPED_KERNELS), st["fresh"]
        assert all(st["decode"]["launches"][k] == 0
                   for k in GROUPED_KERNELS), st["decode"]
        assert all(launches[k] > 0 for k in SERVE_KERNELS + GROUPED_KERNELS)
        emit({"phase": "serve_moe", "model": name, "dtype": "bfloat16",
              "params": cfg.num_params(), "layers": cfg.num_layers,
              "allocated_after_init_gb": init_gb, "arena_pages": blocks,
              "init_seconds": init_s, "generate_seconds": gen_s,
              "serve_seconds": serve_s,
              "generate_prefill_tok_s": _rate(("fresh", "split"), gen_stats),
              "generate_decode_ms_per_step": 1e3
              * gen_stats["decode"]["seconds"] / gen_stats["decode"]["steps"],
              "prefill_tok_s": _rate(("fresh", "split"), st),
              "decode_tok_s": _rate(("decode",), st),
              "decode_ms_per_step": 1e3 * st["decode"]["seconds"]
              / st["decode"]["steps"],
              "stats": st, "launches": launches,
              "grouped_launches_by_form": forms,
              "paged_launches_by_form": paged_forms,
              "decode_graphs": graphs,
              "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9})
        for k, v in launches.items():
            total[k] += v
        del eng
        torch.cuda.empty_cache()
    return total


def _quant_kernel(mode: str, batched: bool = False) -> str:
    """The launch counter of the kernel a format takes."""
    if mode in ("int4", "fp6"):
        return "quantized_matmul_packed"
    return "quantized_matmul_batched" if batched else "quantized_matmul"


def phase_full_width_quant():
    """Quantized ragged_forward, fp32, card against CPU from one quantized
    tree (drawn quantized on the card, copied to the CPU): depth 2 at
    Llama-3 8B width under each of the four formats (a fresh chunk, a
    split chunk and a decode step, the head included: (4096, 128256)),
    then depth 2 at Mixtral 8x7B width in int8 (a fresh 2 x 32 chunk and a
    decode step, both through the capacity layer's batched kernel).
    Tolerance as phase_full_width's (2e-3): the two sides sum the same
    decoded products in fp32 in other orders."""
    import torch
    from deepspeed_tpu_torch import llama3_config
    from deepspeed_tpu_torch.inference.engine_v2 import ragged_forward
    from deepspeed_tpu_torch.models.mixtral import mixtral_config
    from deepspeed_tpu_torch.models.transformer import init_params
    from deepspeed_tpu_torch.ops import op_builder
    from deepspeed_tpu_torch.ops.paged_attention import init_arena
    from deepspeed_tpu_torch.parallel.moe import serving_moe_fn
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    tol, worst = 2e-3, 0.0
    runs = [(mode, llama3_config("8b", num_layers=2), mode) for mode in
            QUANT_MODES] + [("mixtral-int8", mixtral_config(
                "8x7b", num_layers=2), "int8")]
    for name, cfg, mode in runs:
        moe = bool(cfg.num_experts)
        t0 = time.perf_counter()
        p_gpu = init_params(cfg, torch.Generator(device=DEV).manual_seed(31),
                            torch.float32, DEV, weight_quant=mode)
        p_cpu = _to_cpu(p_gpu)
        init_s = time.perf_counter() - t0
        nb, bs, mb = 16, 128, 8
        arenas = {d: init_arena(cfg.num_layers, cfg.kv_heads, nb, bs,
                                cfg.head_dim, torch.float32, d)
                  for d in (DEV, "cpu")}
        rng = np.random.default_rng(32)
        if moe:
            pt = np.full((2, mb), nb, np.int32)
            pt[0, :1], pt[1, :1] = [3], [7]
            steps = [("fresh", 32, [0, 0], [32, 20]),
                     ("decode", 1, [32, 20], [1, 1])]
        else:
            pt = np.full((3, mb), nb, np.int32)
            pt[0, :2], pt[1, :3], pt[2, :5] = [3, 0], [7, 1, 12], \
                [2, 9, 4, 15, 5]
            steps = [("fresh", 256, [0, 0, 0], [200, 256, 256]),
                     ("split", 256, [200, 256, 256], [1, 100, 256]),
                     ("decode", 1, [201, 356, 512], [1, 1, 1])]
        for step, c, starts, counts in steps:
            tokens = rng.integers(0, cfg.vocab_size,
                                  size=(len(starts), c)).astype(np.int32)
            logits = {}
            op_builder.reset_launches()
            for where, params in ((DEV, p_gpu), ("cpu", p_cpu)):
                args = [torch.from_numpy(np.asarray(a, np.int32)).to(where)
                        for a in (tokens, counts, starts, pt)]
                moe_fn = serving_moe_fn(cfg, None, params, ep=False) \
                    if moe else None
                with torch.no_grad():
                    lg, arenas[where] = ragged_forward(
                        cfg, params, arenas[where], *args, moe_fn=moe_fn,
                        fresh_prefill=False if step == "decode" else step)
                logits[where] = lg.cpu()
            launched = dict(op_builder.launches)
            want = {_quant_kernel(mode)} | (
                {"quantized_matmul_batched"} if moe else set()) | {
                "fresh": {"flash_attention_fwd"},
                "split": {"flash_attention_fwd", "paged_attention"},
                "decode": {"paged_attention"}}[step]
            assert {k for k, v in launched.items() if v} == want, \
                f"{name} {step} step launched {launched}"
            assert torch.isfinite(logits[DEV]).all()
            err = _err(logits[DEV], logits["cpu"])
            worst = max(worst, err)
            emit({"phase": "full_width_quant", "model": name + "-depth2",
                  "mode": step, "weight_quant": mode,
                  "tokens": len(starts) * c, "max_abs_err": err, "tol": tol,
                  "logit_absmax": float(logits["cpu"].abs().max()),
                  "init_seconds": init_s, "launches": launched})
            torch.testing.assert_close(logits[DEV], logits["cpu"], rtol=tol,
                                       atol=tol)
        del p_gpu, p_cpu, arenas
        torch.cuda.empty_cache()
    emit({"phase": "full_width_quant", "worst": worst})


#: phase 5's quantized runs: Llama-3 8B at full depth in each format (the
#: phase_serve prompts, 32 new tokens; ``serve`` on 16 requests in int8),
#: then Mixtral 8x7B at all 32 layers in int8 (quantized at init slice by
#: slice, 256 arena pages, max_batch_tokens 512, 8 prompts of 128-512
#: tokens, 16 new tokens)
QUANT_MIXTRAL_PROMPTS = [128, 512, 256, 384, 200, 448, 300, 160]
#: the quantized serving runs' K5 launches by kernel and form (split-K at
#: decode, wgmma at prefill), and by form and weight shape, summed over
#: phase 5's quantized runs
QUANT_FORM_LAUNCHES = {k: {"fma": 0, "splitk": 0, "wgmma": 0}
                       for k in ("quantized_matmul",
                                 "quantized_matmul_packed",
                                 "quantized_matmul_batched")}
QUANT_SHAPE_LAUNCHES = {k: {} for k in QUANT_FORM_LAUNCHES}


def _tree_bytes(tree) -> int:
    if isinstance(tree, dict):
        return sum(_tree_bytes(v) for v in tree.values())
    return tree.numel() * tree.element_size()


def phase_serve_quant():
    """The slice's main path in bf16: the ragged engine built with
    ``weight_quant`` (the tree drawn quantized slice by slice on the card)
    serving Llama-3 8B at full width and depth in int8, fp8, int4 and fp6,
    then Mixtral 8x7B at full width and all 32 layers in int8 (46.8 GB of
    weights: the whole model on one card). Each run's launch counts are
    read around its own generate/serve; returns their sums."""
    import torch
    from deepspeed_tpu_torch import RaggedInferenceEngine, llama3_config
    from deepspeed_tpu_torch.models.mixtral import mixtral_config
    from deepspeed_tpu_torch.ops import op_builder
    from deepspeed_tpu_torch.ops import paged_attention as pa
    from deepspeed_tpu_torch.ops import quantized_linear as tq
    total = {k: 0 for k in op_builder.launches}
    runs = [("llama3-8b-" + m, llama3_config("8b"), m,
             {"num_blocks": SERVE_BLOCKS, "max_seq_len": 4096,
              "max_batch_tokens": 2048},
             [64, 1500, 300, 777, 128, 1024, 513, 900], 32, m == "int8")
            for m in QUANT_MODES]
    runs.append(("mixtral-8x7b-32L-int8", mixtral_config("8x7b"), "int8",
                 {"num_blocks": 256, "max_seq_len": 1024,
                  "max_batch_tokens": 512}, QUANT_MIXTRAL_PROMPTS, 16,
                 False))
    for i, (name, cfg, mode, eng_over, lens, new, with_serve) in \
            enumerate(runs):
        rng = np.random.default_rng(3)
        prompts = [rng.integers(0, cfg.vocab_size, size=n).astype(np.int32)
                   for n in lens]
        requests = [rng.integers(0, cfg.vocab_size, size=int(n))
                    .astype(np.int32) for n in rng.integers(16, 700, 16)] \
            if with_serve else []
        budgets = [int(b) for b in rng.integers(8, 49, size=16)]
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        eng = RaggedInferenceEngine(
            cfg, dict({"dtype": "bfloat16", "block_size": 128,
                       "max_sequences": 64, "prefill_chunk": 256,
                       "weight_quant": mode}, **eng_over),
            generator=torch.Generator(device=DEV).manual_seed(40 + i),
            device=DEV)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        weight_gb = _tree_bytes(eng.params) / 1e9
        init_gb = torch.cuda.memory_allocated() / 1e9
        init_peak_gb = torch.cuda.max_memory_allocated() / 1e9

        # the main path: every count set to 0 just before, read just after
        op_builder.reset_launches()
        tq.reset_regime_launches()
        pa.reset_form_launches()
        eng.stats.clear()
        t1 = time.perf_counter()
        outs = eng.generate(prompts, max_new_tokens=new)
        gen_s = time.perf_counter() - t1
        gen_stats = {k: dict(v, launches=dict(v["launches"]))
                     for k, v in eng.stats.items()}
        t2 = time.perf_counter()
        served = eng.serve(requests, max_new_tokens=budgets,
                           max_concurrency=8) if with_serve else []
        serve_s = time.perf_counter() - t2
        launches = dict(op_builder.launches)
        forms = {k: dict(v) for k, v in tq.regime_launches.items()}
        shapes = {k: dict(v) for k, v in tq.shape_launches.items()}
        paged_forms = _paged_forms(eng.stats)
        graphs = _graphs(eng, name)

        for p, o in zip(prompts, outs):
            assert len(o) == len(p) + new and (o[:len(p)] == p).all()
            assert ((o >= 0) & (o < cfg.vocab_size)).all()
        for p, o, m in zip(requests, served, budgets):
            assert len(o) == len(p) + m and (o[:len(p)] == p).all()
        assert not eng.state.seqs
        assert eng.state.allocator.free_blocks == eng_over["num_blocks"]
        moe = bool(cfg.num_experts)
        kernel = _quant_kernel(mode)
        need = {kernel, "flash_attention_fwd", "paged_attention"} | (
            {"quantized_matmul_batched"} if moe else set())
        assert all(launches[k] > 0 for k in need), launches
        # every projection went through the kernels; MoE only through
        # the capacity layer (the grouped kernels of the dropless one
        # launched nothing)
        assert all(v == 0 for k, v in launches.items() if k not in need), \
            launches
        # bf16 serving takes split-K at decode, and the dense linears
        # wgmma at prefill; never the fp32 FMA kernel
        assert all(forms[k]["splitk"] > 0 and forms[k]["fma"] == 0
                   for k in need if k in forms), forms
        assert forms[kernel]["wgmma"] > 0, forms
        for k, v in forms.items():
            for r, c in v.items():
                QUANT_FORM_LAUNCHES[k][r] += c
            assert sum(shapes[k].values()) == sum(v.values()), (k, shapes)
            for key, c in shapes[k].items():
                QUANT_SHAPE_LAUNCHES[k][key] = \
                    QUANT_SHAPE_LAUNCHES[k].get(key, 0) + c
        st = {k: dict(v, launches=dict(v["launches"]))
              for k, v in eng.stats.items()}
        traced = _profiled_window(eng, prompts, {
            "paged_attn_split_kernel":
                lambda: pa.form_launches["paged_attention"]["split"],
            "qmm_splitk_kernel":
                lambda: tq.regime_launches[kernel]["splitk"]}) \
            if mode == "int8" and not moe else None
        emit({"phase": "serve_quant", "model": name, "dtype": "bfloat16",
              "weight_quant": mode, "params": cfg.num_params(),
              "layers": cfg.num_layers, "weight_gb": weight_gb,
              "allocated_after_init_gb": init_gb,
              "init_peak_gb": init_peak_gb,
              "arena_pages": eng_over["num_blocks"], "init_seconds": init_s,
              "generate_seconds": gen_s, "serve_seconds": serve_s,
              "generate_prefill_tok_s": _rate(("fresh", "split"), gen_stats),
              "generate_decode_ms_per_step": 1e3
              * gen_stats["decode"]["seconds"] / gen_stats["decode"]["steps"],
              "prefill_tok_s": _rate(("fresh", "split"), st),
              "decode_tok_s": _rate(("decode",), st),
              "decode_ms_per_step": 1e3 * st["decode"]["seconds"]
              / st["decode"]["steps"],
              "stats": st, "launches": launches,
              "launches_by_regime": forms,
              "launches_by_shape": shapes,
              "paged_launches_by_form": paged_forms,
              "decode_graphs": graphs, "traced_window": traced,
              "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9})
        for k, v in launches.items():
            total[k] += v
        del eng
        torch.cuda.empty_cache()
    return total


# ---------------------------------------------------------------------------
# phase 6: train_batch on the card against the CPU at full width
# ---------------------------------------------------------------------------

#: the training phases' model and config (bench.py:726-775 minus the
#: TPU-only knobs: no ZeRO, no save_attn_kernel remat, fp32 CE logits)
TRAIN_MODEL = ("1b", {"max_seq_len": 2048, "tie_embeddings": True})
TRAIN_MICRO, TRAIN_GAS, TRAIN_SEQ = 4, 2, 2048
TRAIN_WARMUP, TRAIN_STEPS = 2, 10
TRAIN_KERNELS = ("flash_attention_fwd", "flash_attention_bwd")


def _to_cpu(tree):
    return {k: _to_cpu(v) for k, v in tree.items()} \
        if isinstance(tree, dict) else tree.detach().cpu()


def phase_train_full_width():
    """Two train_batch steps of a depth-2 model at Llama-3-1B width (tied
    head), fp32: on the card (K1 + K3) and on the CPU (plain versions)
    from one seeded parameter tree and the same batches. AdamW, clip 1.0,
    gas 2, micro batch 1, T 256.

    Tolerances: losses 1e-4 relative, parameters 1e-4 absolute. Both sides
    are fp32 (TF32 off) and differ by summation order. The lr is 1e-5:
    Adam's update is ~lr × sign(m) wherever a gradient sits at rounding
    level, so two correct runs may differ by up to 2 lr per step there;
    at 1e-5 that stays inside the limit, while a wrong gradient moves the
    loss and the updates far beyond it."""
    import torch
    from deepspeed_tpu_torch import initialize, llama3_config
    from deepspeed_tpu_torch.models.transformer import init_params
    from deepspeed_tpu_torch.ops import op_builder
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = llama3_config("1b", num_layers=2, max_seq_len=256,
                        tie_embeddings=True)
    conf = {"train_micro_batch_size_per_gpu": 1,
            "gradient_accumulation_steps": 2,
            "optimizer": {"type": "adamw",
                          "params": {"lr": 1e-5, "weight_decay": 0.1}},
            "gradient_clipping": 1.0, "attention_impl": "auto"}
    init = init_params(cfg, torch.Generator(device=DEV).manual_seed(6),
                       torch.float32, DEV)
    init_cpu = _to_cpu(init)
    rng = np.random.default_rng(6)
    data = [{"input_ids": rng.integers(0, cfg.vocab_size, size=(1, 256))
             .astype(np.int32)} for _ in range(4)]
    runs = {}
    for where in ("card", "cpu"):
        dev = DEV if where == "card" else "cpu"
        eng, _, _, _ = initialize(cfg, dict(conf), params=(
            init if where == "card" else init_cpu), device=dev)
        op_builder.reset_launches()
        t0 = time.perf_counter()
        losses = [float(eng.train_batch(iter(data[2 * s:2 * s + 2])))
                  for s in range(2)]
        runs[where] = {"losses": losses, "params": _to_cpu(eng.params),
                       "seconds": time.perf_counter() - t0,
                       "launches": dict(op_builder.launches),
                       "grad_norm": eng.get_global_grad_norm()}
        del eng
    del init
    torch.cuda.empty_cache()
    card, cpu = runs["card"], runs["cpu"]
    assert all(card["launches"][k] == 2 * 2 * cfg.num_layers
               for k in TRAIN_KERNELS), card["launches"]
    assert not any(cpu["launches"].values()), cpu["launches"]
    loss_rel = max(abs(a - b) / abs(b)
                   for a, b in zip(card["losses"], cpu["losses"]))

    def leaves(tree):
        return [x for v in tree.values() for x in leaves(v)] \
            if isinstance(tree, dict) else [tree]

    param_err = max(_err(a, b) for a, b in zip(leaves(card["params"]),
                                               leaves(cpu["params"])))
    moved = max(_err(a, b) for a, b in zip(leaves(card["params"]),
                                           leaves(init_cpu)))
    res = {"phase": "train_full_width", "model": "llama3-1b-width-depth2",
           "dtype": "float32", "losses_card": card["losses"],
           "losses_cpu": cpu["losses"], "loss_rel_err": loss_rel,
           "param_max_abs_err": param_err, "param_max_update": moved,
           "grad_norm_card": card["grad_norm"],
           "grad_norm_cpu": cpu["grad_norm"], "tol": 1e-4,
           "seconds_card": card["seconds"], "seconds_cpu": cpu["seconds"],
           "launches": card["launches"]}
    emit(res)
    assert all(np.isfinite(card["losses"]))
    assert loss_rel <= 1e-4 and param_err <= 1e-4, res


# ---------------------------------------------------------------------------
# phase 7: train the bench model at full depth in bf16
# ---------------------------------------------------------------------------

def phase_train():
    """Llama-3 1B (the repo's training bench model, bench.py:726-775) at
    full width and depth in bf16 with random weights: 2 warm-up and 10
    timed train_batch steps on one fixed seeded batch (micro batch 4 x gas
    2 x 2048 tokens). The loss of a memorised batch must be finite at
    every step and fall from ~ln(128256) = 11.76. Returns the kernels'
    launch counts over the 12 steps."""
    import torch
    from deepspeed_tpu_torch import initialize, llama3_config
    from deepspeed_tpu_torch.ops import op_builder
    cfg = llama3_config(TRAIN_MODEL[0], **TRAIN_MODEL[1])
    conf = {"train_micro_batch_size_per_gpu": TRAIN_MICRO,
            "gradient_accumulation_steps": TRAIN_GAS,
            "optimizer": {"type": "adamw",
                          "params": {"lr": 1e-4, "weight_decay": 0.1}},
            "gradient_clipping": 1.0, "bf16": {"enabled": True},
            "activation_checkpointing": {"policy": "none"},
            "attention_impl": "auto", "steps_per_print": 1000}
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    eng, _, _, _ = initialize(cfg, conf, generator=torch.Generator(
        device=DEV).manual_seed(0), device=DEV)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    state_gb = torch.cuda.memory_allocated() / 1e9
    rng = np.random.default_rng(7)
    batch = [{"input_ids": rng.integers(0, cfg.vocab_size,
                                        size=(TRAIN_MICRO, TRAIN_SEQ))
              .astype(np.int32)} for _ in range(TRAIN_GAS)]

    # the main path: every count set to 0 just before, read just after
    op_builder.reset_launches()
    losses, step_s = [], []
    for step in range(TRAIN_WARMUP + TRAIN_STEPS):
        t1 = time.perf_counter()
        loss = eng.train_batch(iter(batch))
        losses.append(float(loss))           # syncs: the step is done
        step_s.append(time.perf_counter() - t1)
    launches = dict(op_builder.launches)

    timed = step_s[TRAIN_WARMUP:]
    ms = 1e3 * sum(timed) / len(timed)
    tokens = TRAIN_MICRO * TRAIN_GAS * TRAIN_SEQ
    res = {"phase": "train", "model": "llama3-" + TRAIN_MODEL[0],
           "dtype": "bfloat16", "params": cfg.num_params(),
           "micro_batch": TRAIN_MICRO, "gas": TRAIN_GAS, "seq": TRAIN_SEQ,
           "init_seconds": init_s, "state_gb": state_gb,
           "losses": losses, "step_seconds": step_s,
           "ms_per_step": ms, "ms_per_step_min": 1e3 * min(timed),
           "ms_per_step_max": 1e3 * max(timed),
           "tokens_per_s": tokens / (ms / 1e3),
           "model_tflops_per_s": 6.0 * cfg.num_params() * tokens
           / (ms / 1e3) / 1e12,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
           "grad_norm": eng.get_global_grad_norm(), "launches": launches}
    emit(res)
    steps = TRAIN_WARMUP + TRAIN_STEPS
    layers_micro = cfg.num_layers * TRAIN_GAS * steps
    assert all(np.isfinite(losses)), losses
    assert losses[-1] < losses[0], losses
    assert all(launches[k] == layers_micro for k in TRAIN_KERNELS), launches
    assert launches["paged_attention"] == 0, launches
    del eng
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# MoE training: fp32 card vs CPU, then the bench model and Mixtral in bf16
# ---------------------------------------------------------------------------

#: the repo's MoE training bench model (bench.py:251-285): ~0.90 B total,
#: ~0.28 B active parameters; its config minus the TPU-only knobs (no
#: save_attn_kernel_qkv remat), micro batch 8 x 2048 tokens, gas 1
MOE_TRAIN_MODEL = dict(hidden_size=1024, num_layers=12, num_heads=8,
                       num_kv_heads=4, intermediate_size=2816, num_experts=8,
                       num_experts_per_tok=2, vocab_size=32000,
                       max_seq_len=2048, tie_embeddings=True)
MOE_TRAIN_MICRO, MOE_TRAIN_SEQ = 8, 2048
MOE_TRAIN_WARMUP, MOE_TRAIN_STEPS = 2, 10
#: Mixtral 8x7B at full width and 2 of its 32 layers, micro batch 1 x 2048
MIXTRAL_TRAIN_LAYERS, MIXTRAL_TRAIN_WARMUP, MIXTRAL_TRAIN_STEPS = 2, 2, 3
#: the fp32 layer-gradient check: d, f, experts (top-2), tokens
MOE_LAYER_GRAD = (1024, 2816, 8, 1024)
#: grouped launches per MoE layer and micro-batch of a training step
MOE_LAYER_LAUNCHES = {"grouped_gate_up": 1, "grouped_down": 1,
                      "grouped_dgdu": 1, "grouped_dxs": 1, "grouped_wgrad": 3}


def _moe_train_conf(micro, gas, lr, bf16, **extra):
    conf = {"train_micro_batch_size_per_gpu": micro,
            "gradient_accumulation_steps": gas,
            "optimizer": {"type": "adamw",
                          "params": {"lr": lr, "weight_decay": 0.1}},
            "gradient_clipping": 1.0, "moe": {"impl": "dropless"},
            "attention_impl": "auto", "steps_per_print": 1000}
    if bf16:
        conf["bf16"] = {"enabled": True}
    conf.update(extra)
    return conf


def _rel(a, b) -> float:
    """max |a - b| over max |b|."""
    return _err(a, b) / max(float(b.float().abs().max()), 1e-30)


def phase_moe_layer_grad():
    """dropless_moe_layer forward and backward at the 1B/8e width (d 1024,
    f 2816, 8 experts, top-2) in fp32 with 1,024 tokens, on the card (the
    grouped kernels) and on the CPU (plain versions) from one parameter
    set and input: the gradients of x, the router and the three expert
    weights must agree within 1e-4 of each one's largest |value| (fp32 on
    both sides, TF32 off: sums over 1024-2816 terms and over an expert's
    rows in other orders), the output and aux likewise."""
    import torch
    from deepspeed_tpu_torch.ops import op_builder
    from deepspeed_tpu_torch.parallel.moe import dropless_moe_layer
    torch.backends.cuda.matmul.allow_tf32 = False
    d, f, e, tokens = MOE_LAYER_GRAD
    g = torch.Generator(device=DEV).manual_seed(9)
    p = {"router": torch.randn((d, e), generator=g, device=DEV) * 0.02,
         "wg": torch.randn((e, d, f), generator=g, device=DEV) * 0.02,
         "wi": torch.randn((e, d, f), generator=g, device=DEV) * 0.02,
         "wo": torch.randn((e, f, d), generator=g, device=DEV) * 0.02}
    x = torch.randn((2, tokens // 2, d), generator=g, device=DEV)
    cot = torch.randn((2, tokens // 2, d), generator=g, device=DEV)
    out = {}
    for where in (DEV, "cpu"):
        leaves = {k: v.to(where).clone().requires_grad_()
                  for k, v in p.items()}
        xx = x.to(where).clone().requires_grad_()
        op_builder.reset_launches()
        y, aux = dropless_moe_layer(None, leaves, xx)
        grads = torch.autograd.grad((y * cot.to(where)).sum() + aux,
                                    [xx] + list(leaves.values()))
        out[where] = {"y": y.detach().cpu(), "aux": aux.detach().cpu(),
                      "launches": dict(op_builder.launches),
                      **{k: gr.cpu() for k, gr in
                         zip(["x"] + list(leaves), grads)}}
    card, cpu = out[DEV], out["cpu"]
    errs = {k: _rel(card[k], cpu[k])
            for k in ("y", "aux", "x", "router", "wg", "wi", "wo")}
    res = {"phase": "moe_layer_grad", "dtype": "float32",
           "shape": {"tokens": tokens, "d": d, "f": f, "E": e, "k": 2},
           "rel_err": errs, "tol": 1e-4, "launches": card["launches"]}
    emit(res)
    assert all(card["launches"][k] == n
               for k, n in MOE_LAYER_LAUNCHES.items()), card["launches"]
    assert not any(cpu["launches"].values()), cpu["launches"]
    assert all(bool(torch.isfinite(card[k]).all()) for k in errs)
    assert max(errs.values()) <= 1e-4, res


def phase_moe_train_full_width():
    """Two fp32 train_batch steps of the 1B/8e bench model at depth 2
    (gas 2, micro batch 1 x 256 tokens, AdamW lr 1e-5, clip 1.0, dropless)
    on the card and on the CPU from one seeded parameter tree and the
    same batches: losses (CE + aux) and aux within 1e-4 relative,
    parameters within 1e-4 absolute (the lr argument of phase 6)."""
    import torch
    from deepspeed_tpu_torch import initialize
    from deepspeed_tpu_torch.models.mixtral import mixtral_config
    from deepspeed_tpu_torch.models.transformer import init_params
    from deepspeed_tpu_torch.ops import op_builder
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = mixtral_config("tiny", **dict(MOE_TRAIN_MODEL, num_layers=2,
                                        max_seq_len=256))
    conf = _moe_train_conf(1, 2, 1e-5, bf16=False)
    init = init_params(cfg, torch.Generator(device=DEV).manual_seed(10),
                       torch.float32, DEV)
    init_cpu = _to_cpu(init)
    rng = np.random.default_rng(10)
    data = [{"input_ids": rng.integers(0, cfg.vocab_size, size=(1, 256))
             .astype(np.int32)} for _ in range(4)]
    runs = {}
    for where in ("card", "cpu"):
        eng, _, _, _ = initialize(cfg, dict(conf), params=(
            init if where == "card" else init_cpu),
            device=DEV if where == "card" else "cpu")
        op_builder.reset_launches()
        losses, aux = [], []
        for step in range(2):
            losses.append(float(eng.train_batch(iter(data[2 * step:
                                                          2 * step + 2]))))
            aux.append(float(eng._last_metrics["aux_loss"]))
        runs[where] = {"losses": losses, "aux": aux,
                       "params": _to_cpu(eng.params),
                       "launches": dict(op_builder.launches)}
        del eng
    del init
    torch.cuda.empty_cache()
    card, cpu = runs["card"], runs["cpu"]

    def leaves(tree):
        return [x for v in tree.values() for x in leaves(v)] \
            if isinstance(tree, dict) else [tree]

    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(card["losses"],
                                                        cpu["losses"]))
    aux_rel = max(abs(a - b) / abs(b) for a, b in zip(card["aux"],
                                                       cpu["aux"]))
    param_err = max(_err(a, b) for a, b in zip(leaves(card["params"]),
                                               leaves(cpu["params"])))
    res = {"phase": "moe_train_full_width",
           "model": "moe-1b-8e-width-depth2", "dtype": "float32",
           "losses_card": card["losses"], "losses_cpu": cpu["losses"],
           "aux_card": card["aux"], "aux_cpu": cpu["aux"],
           "loss_rel_err": loss_rel, "aux_rel_err": aux_rel,
           "param_max_abs_err": param_err, "tol": 1e-4,
           "launches": card["launches"]}
    emit(res)
    micro_layers = 2 * 2 * cfg.num_layers
    assert all(card["launches"][k] == n * micro_layers
               for k, n in MOE_LAYER_LAUNCHES.items()), card["launches"]
    assert all(np.isfinite(card["losses"]))
    assert loss_rel <= 1e-4 and aux_rel <= 1e-4 and param_err <= 1e-4, res


def _train_run(cfg, conf, warmup, steps, seed, batch_shape):
    """initialize + warmup + steps train_batch steps on one fixed batch;
    returns (result dict, launches over all steps)."""
    import torch
    from deepspeed_tpu_torch import initialize
    from deepspeed_tpu_torch.ops import grouped_matmul as tg
    from deepspeed_tpu_torch.ops import op_builder
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    eng, _, _, _ = initialize(cfg, conf, generator=torch.Generator(
        device=DEV).manual_seed(seed), device=DEV)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    state_gb = torch.cuda.memory_allocated() / 1e9
    rng = np.random.default_rng(seed)
    batch = [{"input_ids": rng.integers(0, cfg.vocab_size, size=batch_shape)
              .astype(np.int32)}]

    # the main path: every count set to 0 just before, read just after
    op_builder.reset_launches()
    tg.reset_form_launches()
    losses, aux, step_s = [], [], []
    for _ in range(warmup + steps):
        t1 = time.perf_counter()
        loss = eng.train_batch(iter(batch))
        losses.append(float(loss))           # syncs: the step is done
        step_s.append(time.perf_counter() - t1)
        aux.append(float(eng._last_metrics["aux_loss"]))
    launches = dict(op_builder.launches)
    forms = _grouped_forms(launches)
    timed = step_s[warmup:]
    ms = 1e3 * sum(timed) / len(timed)
    tokens = batch_shape[0] * batch_shape[1]
    e, k = cfg.num_experts, cfg.num_experts_per_tok
    active = cfg.num_params() - (e - k) * 3 * cfg.hidden_size \
        * cfg.ffn_size * cfg.num_layers
    res = {"dtype": "bfloat16", "params": cfg.num_params(),
           "active_params": active, "layers": cfg.num_layers,
           "micro_batch": batch_shape[0], "seq": batch_shape[1],
           "init_seconds": init_s, "state_gb": state_gb,
           "losses": losses, "aux_losses": aux, "step_seconds": step_s,
           "ms_per_step": ms, "ms_per_step_min": 1e3 * min(timed),
           "ms_per_step_max": 1e3 * max(timed),
           "tokens_per_s": tokens / (ms / 1e3),
           "active_tflops_per_s": 6.0 * active * tokens / (ms / 1e3) / 1e12,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
           "grad_norm": eng.get_global_grad_norm(), "launches": launches,
           "grouped_launches_by_form": forms,
           "launches_per_step": {n: v / (warmup + steps)
                                 for n, v in launches.items()}}
    del eng
    torch.cuda.empty_cache()
    steps_all = warmup + steps
    assert all(np.isfinite(losses)) and all(np.isfinite(aux)), res
    assert launches["paged_attention"] == 0, launches
    for n, per in MOE_LAYER_LAUNCHES.items():
        assert launches[n] == per * cfg.num_layers * steps_all, launches
    for n in TRAIN_KERNELS:
        assert launches[n] == cfg.num_layers * steps_all, launches
    return res, launches


def phase_train_moe():
    """The slice's main path: the repo's MoE training bench model
    (bench.py:251-285) at full width and depth in bf16 with random
    weights, dropless, through initialize/train_batch: 2 warm-up and 10
    timed steps on one fixed batch of 8 x 2048 tokens. The loss of the
    memorised batch must fall; every grouped kernel runs once per layer
    and step (wgrad three times)."""
    from deepspeed_tpu_torch.models.mixtral import mixtral_config
    cfg = mixtral_config("tiny", **MOE_TRAIN_MODEL)
    conf = _moe_train_conf(MOE_TRAIN_MICRO, 1, 1e-4, bf16=True,
                           chunked_ce_budget_mb=256, ce_logits_dtype="bf16",
                           activation_checkpointing={"policy": "none"})
    res, launches = _train_run(cfg, conf, MOE_TRAIN_WARMUP, MOE_TRAIN_STEPS,
                               11, (MOE_TRAIN_MICRO, MOE_TRAIN_SEQ))
    emit(dict(res, phase="train_moe", model="moe-1b-8e (bench.py:251)"))
    assert res["losses"][-1] < res["losses"][0], res["losses"]
    return launches


def phase_train_mixtral():
    """Mixtral 8x7B at full width and MIXTRAL_TRAIN_LAYERS of its 32
    layers in bf16, dropless, micro batch 1 x 2048 tokens: 2 warm-up and 3
    timed train_batch steps. The engine holds ~20 bytes per parameter
    (bf16 params, fp32 master, Adam m and v, fp32 accumulated grads, bf16
    grads): printed as reckoned_state_gb beside the measured peak."""
    from deepspeed_tpu_torch.models.mixtral import mixtral_config
    cfg = mixtral_config("8x7b", num_layers=MIXTRAL_TRAIN_LAYERS,
                         max_seq_len=2048)
    conf = _moe_train_conf(1, 1, 1e-5, bf16=True,
                           activation_checkpointing={"policy": "none"})
    res, launches = _train_run(cfg, conf, MIXTRAL_TRAIN_WARMUP,
                               MIXTRAL_TRAIN_STEPS, 12, (1, 2048))
    emit(dict(res, phase="train_mixtral",
              model=f"mixtral-8x7b-{MIXTRAL_TRAIN_LAYERS}L",
              reckoned_state_gb=20 * cfg.num_params() / 1e9))
    return launches


def _ptxas_kernels(log: str) -> dict:
    """Registers and spilled bytes (stores + loads) of each kernel in an
    ``nvcc -Xptxas -v`` log, by a short name: the function, its element
    type (bf16 or f32) and its head_dim, e.g. ``flash_fwd_mma_kernel<bf16,
    128>``. Empty when the library came from an earlier run."""
    import re
    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties "
                      r"for) '?(\w+)", line)
        if m:
            mangled = m.group(1)
            fn = re.search(r"(flash_(?:fwd|bwd)\w*?_kernel)I", mangled)
            dim = re.search(r"Li(\d+)E", mangled)
            ty = "f32" if re.search(r"_kernelIf", mangled) else "bf16"
            name = (f"{fn.group(1) if fn else mangled}<{ty}, "
                    f"{dim.group(1) if dim else '?'}>")
            out.setdefault(name, {"registers": None, "spill_bytes": 0})
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and name:
            out[name]["spill_bytes"] = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out[name]["registers"] = int(m.group(1))
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 1
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    from deepspeed_tpu_torch.ops import op_builder   # fails outside a checkout

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    emit({"phase": "device", "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count()})

    t0 = time.perf_counter()
    libs = op_builder.build_all()
    ptxas = {n: [ln.strip() for ln in op_builder.build_log(n).splitlines()
                 if "registers" in ln or "spill" in ln]
             for n in libs}
    flash = {}
    for n in ("flash_attention", "flash_attention_bwd"):
        flash.update(_ptxas_kernels(op_builder.build_log(n)))
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "libraries": {n: str(p.name) for n, p in libs.items()},
          "ptxas": ptxas, "flash_kernels": flash,
          "flash_bf16_spill_bytes": sum(
              v["spill_bytes"] for k, v in flash.items() if "bf16" in k)})

    rng = np.random.default_rng(0)
    timed = phase_kernels(rng)
    grouped = phase_grouped(rng)
    grouped_bwd = phase_grouped_bwd(rng)
    quant = phase_quant(rng)
    if "--kernels-only" in sys.argv[1:]:
        return 0
    phase_full_width()
    phase_full_width_moe()
    phase_full_width_quant()
    phase_fused_fp32()
    paths = {"serve": phase_serve(), "serve_moe": phase_serve_moe(),
             "serve_quant": phase_serve_quant()}
    phase_train_full_width()
    paths["train"] = phase_train()
    phase_moe_layer_grad()
    phase_moe_train_full_width()
    paths["train_moe"] = phase_train_moe()
    paths["train_mixtral"] = phase_train_mixtral()

    # launches: over the main paths (dense serving and MoE serving, phase
    # 5; dense training, phase 7; MoE training of the 1B/8e bench model
    # and of Mixtral 8x7B at 2 layers, phase 8), each read around its own
    # run; K1's times are at the training shape (its serving-shape times
    # are in phase 3's flash_fresh line), the forward grouped kernels' at
    # the Mixtral prefill shape (the Qwen shape is in phase 3's
    # gmm_qwen_path line), the backward ones' at the 1B/8e training shape
    # (the Mixtral shape is in phase 3's gmm_bwd_mixtral_path line);
    # grouped_wgrad's numbers are its three launches of a layer together;
    # the quantized matmuls' at decode (M 16) on Llama-3 8B's MLP up
    # projection (4096 x 14336; int8 for K5a, int4 for K5b) and on
    # Mixtral's experts (G 8; int8 for K5c), every other shape and format
    # in phase 3's qmm_* lines; K6 at Llama-3 1B's gradient size, on no
    # path (it is held by phase 3 alone)
    rows = [("flash_attention_fwd",
             "deepspeed_tpu_torch/ops/csrc/flash_attention.cu",
             "deepspeed_tpu/ops/flash_attention.py:71", timed["train_fwd"],
             "kernel"),
            ("paged_attention",
             "deepspeed_tpu_torch/ops/csrc/paged_attention.cu",
             "deepspeed_tpu/ops/paged_attention.py:235", timed["decode"],
             "kernel"),
            ("flash_attention_bwd",
             "deepspeed_tpu_torch/ops/csrc/flash_attention_bwd.cu",
             "deepspeed_tpu/ops/flash_attention.py:330", timed["bwd"],
             "kernel"),
            ("grouped_gate_up",
             "deepspeed_tpu_torch/ops/csrc/grouped_matmul.cu",
             "deepspeed_tpu/ops/grouped_matmul.py:328", grouped["mixtral"],
             "gate_up"),
            ("grouped_down",
             "deepspeed_tpu_torch/ops/csrc/grouped_matmul.cu",
             "deepspeed_tpu/ops/grouped_matmul.py:352", grouped["mixtral"],
             "down")] + [
            (name, "deepspeed_tpu_torch/ops/csrc/grouped_matmul_bwd.cu",
             "deepspeed_tpu/ops/grouped_matmul.py:" + line,
             grouped_bwd["moe_1b_8e"], key)
            for name, line, key in (("grouped_dgdu", "411", "dgdu"),
                                    ("grouped_dxs", "488", "dxs"),
                                    ("grouped_wgrad", "502", "wgrad"))] + [
            ("quantized_matmul",
             "deepspeed_tpu_torch/ops/csrc/quantized_linear.cu",
             "deepspeed_tpu/ops/quantized_linear.py:227",
             quant[("int8", None, 16, 4096, 14336)], "kernel"),
            ("quantized_matmul_packed",
             "deepspeed_tpu_torch/ops/csrc/quantized_linear.cu",
             "deepspeed_tpu/ops/quantized_linear.py:295",
             quant[("int4", None, 16, 4096, 14336)], "kernel"),
            ("quantized_matmul_batched",
             "deepspeed_tpu_torch/ops/csrc/quantized_linear.cu",
             "deepspeed_tpu/ops/quantized_linear.py:498",
             quant[("int8", 8, 16, 4096, 14336)], "kernel"),
            ("quantize_blocks", "deepspeed_tpu_torch/ops/csrc/quantizer.cu",
             "deepspeed_tpu/ops/quantizer.py:131", quant["quantize_blocks"],
             "kernel")]
    #: which checks of a phase-3 line hold each backward kernel
    bwd_checks = {"dgdu": ("dgdu_", "autograd_dw2"),
                  "dxs": ("dxs", "autograd_dxs"),
                  "wgrad": ("dwg", "dwi", "dwo", "autograd_dwg",
                            "autograd_dwi", "autograd_dwo")}
    kernels = []
    for name, src, replaces, res, key in rows:
        if key == "kernel":
            times = {"max_abs_err": res["max_abs_err"],
                     "ms": res["kernel_ms"], "plain_ms": res["plain_ms"],
                     "bound_ms": res["bound_ms"],
                     "bound_by": res["bound_by"],
                     "library_ms": res["library_ms"]}
            if "library" in res:
                times["library"] = res["library"]
        elif key in bwd_checks:
            times = {"max_abs_err": max(
                         v["max_abs_err"] for c, v in res.items()
                         if isinstance(v, dict) and "max_abs_err" in v
                         and c.startswith(bwd_checks[key])),
                     "ms": res[key + "_ms"],
                     "plain_ms": res[key + "_plain_ms"],
                     "bound_ms": res[key + "_bound_ms"],
                     "bound_by": res[key + "_bound_by"],
                     "library_ms": res[key + "_library_ms"],
                     "library": "torch._grouped_mm" if res[key + "_library_ms"]
                     is not None else None}
        else:
            pair = ("gate", "up") if key == "gate_up" else ("down", "ffn")
            times = {"max_abs_err": max(res[p]["max_abs_err"] for p in pair),
                     "ms": res[key + "_ms"],
                     "plain_ms": res[key + "_plain_ms"],
                     "bound_ms": res[key + "_bound_ms"],
                     "bound_by": res[key + "_bound_by"],
                     "library_ms": res[key + "_library_ms"],
                     "library": res["library"]}
        kernels.append(dict({"name": name, "route": "cuda", "source": src,
                             "replaces": replaces,
                             "launches": sum(p[name] for p in
                                             paths.values()),
                             "launches_by_path": {k: p[name] for k, p in
                                                  paths.items()}},
                            **times))
    also = {"grouped_down": "deepspeed_tpu/ops/grouped_matmul.py:341",
            "grouped_dgdu": "deepspeed_tpu/ops/grouped_matmul.py:366"}
    for row in kernels:
        if row["name"] in also:
            row["also_replaces"] = also[row["name"]]
        if row["name"] in QUANT_FORM_LAUNCHES:
            row["launches_by_regime"] = QUANT_FORM_LAUNCHES[row["name"]]
            row["launches_by_shape"] = QUANT_SHAPE_LAUNCHES[row["name"]]
        if row["name"] == "paged_attention":
            # launches by form over the serving paths (the training paths
            # launch none), and each form's time at its path shape: split
            # at decode (the row's own numbers), mma at the split-prefill
            # history (the serving profile's shape), fma in fp32
            row["launches_by_form"] = PAGED_FORM_LAUNCHES
            assert sum(PAGED_FORM_LAUNCHES.values()) == row["launches"]
            row["forms"] = {
                form: {k: timed[key].get(k) for k in (
                    "check", "kernel_ms", "kernel_graph_ms", "plain_ms",
                    "bound_ms", "bound_by", "max_abs_err")}
                for form, key in (("split", "decode"), ("mma", "history"),
                                  ("fma", "fma"))}
        if row["name"] in GROUPED_FORM_LAUNCHES:
            row["launches_by_form"] = GROUPED_FORM_LAUNCHES[row["name"]]
            assert sum(row["launches_by_form"].values()) == row["launches"]
        if row["name"] == "grouped_dgdu":
            # each form's time at both training shapes: wgmma (the main
            # paths' form), the mma.sync kernel it replaced there (through
            # the C entry's form argument), and the three products alone by
            # torch._grouped_mm
            row["forms"] = {
                shape: {k: grouped_bwd[shape].get(k) for k in (
                    "dgdu_ms", "dgdu_tflops_per_s", "dgdu_mma_ms",
                    "dgdu_mma_tflops_per_s", "dgdu_saved_ms",
                    "dgdu_bound_ms", "dgdu_products_library_ms",
                    "dgdu_plan")}
                for shape in ("moe_1b_8e", "mixtral")}
    print(smi, flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
