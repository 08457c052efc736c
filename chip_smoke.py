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
   serving profile's shape; both forms at a radix prefix-cache hit's
   shape, histories of 1000-1512 keys that end mid-page, the first 7
   pages of every row aliased and the 8th a copy-on-write copy with junk
   past the history; both at bs 16 and the mma form at dh 64; the
   split form on 16-row chunks whose rows end in different splits, in
   bf16 and fp32; each case asserts the form it took), in fp32 at a
   4000-token decode and at small fp32 shapes (flash attention at small
   shapes in
   bf16 too: its tensor-core kernels); both at head dims 80, 96 and 256
   at the heads of Phi-2 (32/32), GPT-NeoX-20B (64/64) and Gemma-2B (8/1):
   flash attention's forward and forward with lse in bf16 at the fresh
   prefill chunk and at small bf16 and fp32 shapes, paged attention's
   split form at decode, its mma form at the split-prefill history and
   on per-key pages, and in fp32 its split and fma forms; flash
   attention's backward (K3) at head dims 80, 96 and 256 at the same
   heads, in bf16 at the training shape (micro batch 2 x 2048) and at
   small fp32 and bf16 shapes (GQA or MQA, ragged T, non-causal, a window
   with an offset, rows with no key); and times the
   kernel, the plain
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
   capacity FFN); then from one quantized tree: depth 1 at Llama-3 8B
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
   run below, as many K5 split-K kernels); then, on the same engine, the
   serving front end (``ServingFrontend``) on bench_inference.py's
   shared-prefix stream (a warm 1000-token prefix, then 24 requests of it
   plus 128-700 unique tokens, decode megasteps of 8) with the radix
   prefix cache on and off: the cache reuses 24 x 1000 tokens through 24
   copy-on-write pages, the prefill tokens computed fall by exactly that,
   every request ends on its budget, decode windows replay graphs with no
   window forced stepwise, K2 takes the split form at decode and the mma
   form over the adopted histories, every page comes back, and a
   copy-on-write hit's last-token logits sit within the bf16 spread of
   two cold prefills (requests/s, TTFT, TPOT, the pump's host ms a
   window and the streams identical on and off printed); in fp32 at
   depth 2 the front end gives ``generate``'s tokens with the cache on and
   off, and a handoff bundle adopted by a second engine serves the same
   tokens from its pages; then
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
   then the model families through HF checkpoints: Gemma-2B (head_dim
   256, MQA, GeGLU, tied 256k vocabulary) and Phi-2 (head_dim 80, partial
   rotary, parallel block, biased linears) at full width and depth in
   bf16, weights drawn on the card from a seeded generator,
   ``export_hf_checkpoint`` to a directory under ``build/`` and
   ``load_hf_checkpoint`` back (every leaf bitwise, Gemma's folded norm
   scales within one bf16 ulp; seconds, GB/s, bytes on disk), then
   ``generate`` on 8 prompts of 64-1500 tokens with 32 new ones from the
   loaded tree (decode windows on CUDA graphs; prefill tokens/s, ms a
   decode step, wall and, from one traced megastep window, device; K1's
   and K2's launches by form and head dim), and at depth 2 in fp32 the
   card's logits held to the CPU's (2e-3) with identical greedy tokens;
6. runs two ``train_batch`` steps of a depth-2 model at Llama-3-1B width in
   fp32 on the card (K1 + K3) and on the CPU (plain versions) from one
   parameter tree, and compares losses and updated parameters; then the
   same at Gemma-2B's and Phi-2's widths and head dims (256, 80) with a
   32,000-entry vocabulary and an FFN of 2048;
7. trains Llama-3 1B (the repo's training bench model) at full width and
   depth in bf16 through ``initialize``/``train_batch``: 2 warm-up and 10
   timed steps on one fixed batch, with tokens/s, ms per step, peak
   memory and each step's loss, and the kernels' launches read around it;
   after phase 9, trains Gemma-2B under ``save_attn_kernel`` and Phi-2
   under ``full`` at full width and depth in bf16 (micro batch 2 x 2048,
   2 warm-up and 5 timed steps: ms a step, tokens/s, peak memory,
   losses, K1's and K3's launches by head dim); sweeps the remat policies
   ``none``, ``full``, ``save_attn_kernel``, ``offload_full`` and
   ``ffn_chunk`` 512 on the 1B engine (peak memory, ms a step, K1 and K3
   launches a step: K1 runs half as often under save_attn_kernel as
   under full, and offload_full's forward and backward peak below
   full's); and parks the 1B
   engine's state with ``offload_states`` (the device memory it frees,
   GB/s each way) and brings it back with ``reload_states`` (every
   leaf's raw words unchanged);
8. MoE training: the fp32 gradients of ``dropless_moe_layer`` at the
   1B/8e width and two fp32 ``train_batch`` steps of the 1B/8e model at
   depth 2, card against CPU, dropless, under the capacity impl with
   random token selection (the JAX package's default MoE config) and
   under Residual-MoE; then the slice's main path, the repo's MoE
   training bench model (bench.py:251-285; 12 layers, 8 experts top-2,
   dropless) at full width and depth in bf16, 2 warm-up and 10 timed
   steps of 8 x 2048 tokens; and Mixtral 8x7B at full width and 2 of its
   32 layers (1 x 2048 tokens), each with ms per step, tokens/s, peak
   memory, loss and aux loss per step, and the launches read around it
   (grouped_gate_up's, grouped_down's, grouped_dgdu's, grouped_dxs's and
   grouped_wgrad's by form: the bf16 main paths launch only their wgmma
   forms);
9. checkpoint and resume (run right after phase 7), in a fresh directory
   under ``build/`` removed at the end: (a) at depth 2 and Llama-3 1B width
   (a 32,000-entry vocabulary, an FFN of 2048) in fp32, for AdamW, LAMB, Lion, Adagrad, SGD with momentum and Muon, 2
   steps on the card, ``save_checkpoint``, ``load_checkpoint`` into a
   fresh card engine and a CPU engine (every leaf bitwise the saved one),
   2 more steps on each, card against CPU; (c) ``step:3:preempt`` under
   ``DSElasticAgent``: ``Preempted`` with tag preempt_step4 and a black
   box, ``agent.resume()`` in a fresh engine, and its 2 steps against the
   uninterrupted run; (b) the slice's main path, Llama-3 1B at full width
   and depth in bf16: 2 steps, ``save_checkpoint(async_save=True)`` and a
   step before ``wait_pending()``, a fresh engine loads the state at the
   save bit for bit and its next 2 steps are held to the uninterrupted
   engine's, with the state's bytes on disk, the snapshot's seconds, the
   commit's and the load's seconds and GB/s, and the disk usage;
10. ZeRO-Offload (run right after phase 9): a probe line (MemAvailable,
   the process's resident set and the room left under the machine's
   limit, cores, free space under ``build/`` and in /dev/shm, ``ulimit
   -l``); (a) the slice's main path, Llama-3 8B at full width in bf16
   through ``initialize``/``train_batch`` with stage 2 and
   ``offload_optimizer.device`` 'cpu' (AdamW, remat full, micro batch 1 x
   2048, clip 1.0), at full depth when the host holds the fp32 master and
   moments, else on the NVMe tier when the disk holds it and its traffic
   fits, else with layers cut to what the host holds (printed under
   ``reduced``): 2 warm-up and 3 timed steps on one fixed batch with
   ``overlap`` off, then on, each with ms a step, the card's
   forward+backward ms, the host sweep's seconds, D2H and H2D GB/s, the
   host state's bytes, peak memory beside the on-card state the model
   would need, losses (finite, falling) and K1's and K3's launches; after
   the first step, the embedding, layer 0's wq and the final norm equal
   an AdamW step computed on the card from the same master slice and
   landed bf16 gradients within 1 bf16 ulp; (b) at depth 2 and Llama-3
   1B width in fp32, 2 steps of ZeRO-Offload (overlap off and on),
   SuperOffload (a clip that makes it roll back), the NVMe tier and the
   parameter tier under ``build/``, each on the card and the CPU, within
   1e-4 of each other and of the card's on-device AdamW engine; (c) the
   parameter tier at Llama-3 1B's full width in bf16 at two depths: the
   store's bytes, streaming GB/s and peak memory, flat across depths; (d)
   a host Adam sweep over 2^30 values in GB/s beside numpy copying them,
   and an O_DIRECT ``AsyncIOEngine`` write and read of 4 GiB under
   ``build/``, checked bit for bit;
11. v1 inference and the quantization tool (run right after phase 5's HF
   models), each part one ``v1_inference`` line with the card's
   ``nvidia-smi`` name and power limit: (a) Llama-3 8B at full width and
   depth in bf16 through ``init_inference``, 8 prompts of 512 tokens and
   128 new ones, greedy: the tokens of the decode step replayed as a CUDA
   graph equal the stepwise loop's; prefill ms, decode ms a token on the
   graph and stepwise, the capture's seconds, peak memory, one traced
   ``generate`` (device time, idle share, the heaviest kernels), and the
   prefill's last-token logits against the ragged engine's on the same
   weights, beside the same prefill run in two halves through the cache
   and the ragged engine's prefill in two chunks (reported, not gated); (b) the same model under ``weight_quant`` int8
   and int4: K5's launches by form and weight shape, decode ms a token
   beside (a)'s; (c) BLOOM-7b1 (ALiBi) at full width and depth in bf16,
   4 prompts of 256 tokens, 64 new, graph against stepwise, and
   BLOOM-560m through ``export_hf_checkpoint`` → ``load_hf_checkpoint``
   under ``build/`` (every leaf bitwise), serving the unexported tree's
   tokens; (d) BERT-large exported and loaded the same way,
   ``EncoderInference`` on 32 ragged sequences of 64-512 tokens in bf16
   and int8 (sequences/s with the logits fetched, and with the hidden
   states; int8 within cosine 0.99 of bf16, and K5a held against its
   plain version at each weight shape the int8 run launched it at, with
   the batch's rows); (e) Mixtral 8x7B's width at
   16 of its 32 layers (``reduced``) in bf16 (the 8 x 256 prefill through
   the grouped kernels) and int8 (K5c); (f) ``python -m
   deepspeed_tpu_torch.cli.dstpu_quantize``'s ``main`` on an exported
   Llama-3-width model of depth 2: the int4 npz, loaded back, serves the
   tokens of ``weight_quant`` applied at start-up; (g) fp32 at depth 2
   with TF32 off, card against CPU, at the widths of Llama-3 8B and
   BLOOM-7b1 (prefill logits within 1e-4 relative, greedy tokens
   identical) and BERT-large (hidden states and logits within 1e-4).

Every phase prints one JSON line; any failure raises, so the script exits
non-zero. Without CUDA, or outside a checkout of the repository, it exits
non-zero before printing a result. The last three lines are the card, the
kernel table (flash attention's rows with their launches by head dim)
and ``{"ok": true, "device": ...}``.
"""

import json
import os
import subprocess
import sys
import time
import weakref

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
#: K1's and K2's launches by head dim over the HF models' path (phase 5),
#: each run counted from 0; every other path's model has head_dim 128
HF_DIM_LAUNCHES = {k: {d: 0 for d in (64, 80, 96, 128, 256)}
                   for k in ("flash_attention_fwd", "paged_attention")}

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
                serve_arena=False, mb=None, shared=0):
    """Random K/V and a page table listing each row's pages in a shuffled
    order. By default the arena holds one layer of just the pages the rows
    need. With ``serve_arena`` it is the serving phase's own arena
    (``init_arena(L, kvh, SERVE_BLOCKS, bs, dh)``) and the pages are the
    LAST layer's, drawn from the top of its region as the allocator hands
    them out: at Llama-3 8B's shape that region of the last kv head lies
    past element 2**31 of the K/V tensors. ``mb``: the page table's width
    (default: the longest row's pages), padded with the trash block as the
    engine pads its table to max_seq_len. ``shared`` (serve_arena only):
    the first ``shared`` entries of every row name the SAME physical pages
    (a prefix-cache hit aliases them), and each row's next page is a
    private copy (``copy_pages``, as ``cow_block`` makes it) of row 0's,
    so that past a history ending mid-page it holds the inserter's
    junk."""
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
        distinct = sum(need) - (n - 1) * shared
        ids = nb - 1 - rng.permutation(distinct)
    else:
        assert not shared
        nb, off = sum(need), 0
        ak = torch.randn((kvh, nb + 1, bs, dh), generator=g,
                         device=dev).to(dtype)
        av = torch.randn((kvh, nb + 1, bs, dh), generator=g,
                         device=dev).to(dtype)
        ids = rng.permutation(nb)
    pt = np.full((n, mb), nb, np.int64)
    pt[:, :shared] = ids[:shared]
    at = shared
    for i, m in enumerate(need):
        assert m > shared
        pt[i, shared:m] = ids[at:at + m - shared]
        at += m - shared
    if shared:
        from deepspeed_tpu_torch.ops.paged_attention import copy_pages
        copy_pages({"k": ak, "v": av}, [int(pt[0, shared])] * (n - 1),
                   [int(x) for x in pt[1:, shared]], layers)
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
                form, time_it=True, serve_arena=False, mb=None, shared=0):
    """Hold K2 against ``paged_attention_ref`` on one case and assert that
    the launch took ``form`` (its plan goes into the line). ``shared``:
    aliased prefix pages (``_paged_case``)."""
    import torch
    from deepspeed_tpu_torch.ops import paged_attention as pa
    h, kvh, dh, bs = dims
    dev = torch.device(DEV)
    q, ak, av, (pt, st, ct), ctx = _paged_case(
        rng, n, c, h, kvh, dh, bs, starts, counts, dtype, dev, serve_arena,
        mb, shared)
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
                     "mb": int(pt.shape[1]), "shared_pages": shared,
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
        # K and V read once: an aliased page counts once
        keys = sum(ctx) - (n - 1) * shared * bs
        nbytes = (2 * keys * kvh * dh * itemsize
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
    # a radix prefix-cache hit of 1000 tokens (the front end's phase-5
    # traffic): histories that end mid-page, the first 7 pages of every
    # row aliased, the 8th a copy-on-write copy with junk past the history;
    # the chunk after the hit (history read, mma) and decode over the same
    # tables (split)
    hit = [1000, 1000, 1128, 1000, 1384, 1000, 1000, 1512]
    out["prefix_hit"] = check_paged(
        "paged_history_prefix_hit", rng, 8, 256, hit, [0] * 8, bf16, True,
        path, "mma", serve_arena=True, mb=32, shared=7)
    check_paged("paged_decode_prefix_hit", rng, 8, 1, hit, [1] * 8, bf16,
                True, path, "split", time_it=False, serve_arena=True, mb=32,
                shared=7)
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
    # head dims 80, 96 and 256 (the model families of slice 16), each at
    # its model's heads (NEW_DIM_HEADS): K1 at the fresh prefill chunk (8 x
    # 256) in bf16, forward (timed, with SDPA) and with lse, and at small
    # fp32 and bf16 shapes with a window and an offset; K2's split form at
    # decode over the 8 served prompts (timed) and its mma form at the
    # split-prefill history (timed), per-key pages (bs 16) in bf16, and in
    # fp32 its split form at decode and its fma form on small chunks (timed)
    ctx_hf = [n + 1 for n in HF_PROMPTS]
    for tag, (h, kvh, dh) in NEW_DIM_HEADS.items():
        out[f"fresh_{tag}"] = check_flash(f"flash_fresh_{tag}", rng, 8, 256,
                                          (h, kvh, dh), bf16, False)
        check_flash(f"flash_with_lse_{tag}", rng, 8, 256, (h, kvh, dh),
                    bf16, True, time_it=False)
        for dtype, dt_tag in ((f32, "f32"), (bf16, "bf16")):
            check_flash(f"flash_small_{tag}_{dt_tag}", rng, 2, 100,
                        (h, kvh, dh), dtype, True, time_it=False)
            check_flash(f"flash_small_window_{tag}_{dt_tag}", rng, 1, 130,
                        (h, kvh, dh), dtype, False, window=40, q_offset=3,
                        time_it=False)
        dims = (h, kvh, dh, 128)
        out[f"decode_{tag}"] = check_paged(
            f"paged_decode_{tag}", rng, 8, 1, [x - 1 for x in ctx_hf],
            [1] * 8, bf16, False, dims, "split", mb=16)
        out[f"history_{tag}"] = check_paged(
            f"paged_history_{tag}", rng, 8, 256, [0, 256, 512, 768] * 2,
            [0] * 8, bf16, True, dims, "mma")
        check_paged(f"paged_chunk_bs16_{tag}", rng, 3, 40, [0, 37, 300],
                    [40, 9, 0], bf16, True, (h, kvh, dh, 16), "mma",
                    time_it=False)
        check_paged(f"paged_decode_{tag}_f32", rng, 5, 1, [0, 3, 600, 999, 0],
                    [1, 1, 1, 1, 0], f32, True, (h, kvh, dh, 16), "split",
                    time_it=False, mb=70)
        out[f"fma_{tag}"] = check_paged(
            f"paged_small_{tag}_f32", rng, 3, 40, [0, 37, 5], [40, 9, 0],
            f32, True, (h, kvh, dh, 16), "fma")
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
    out.update(check_flash_bwd_new_dims(rng))
    return out


def check_flash_bwd_new_dims(rng) -> dict:
    """K3 at head dims 80, 96 and 256, each at its model's heads
    (NEW_DIM_HEADS): the training shape in bf16 (micro batch 2 x 2048,
    timed, with SDPA's backward), then small cases in fp32 and bf16 —
    GQA or MQA as the model has it, ragged T, non-causal, a window with an
    offset, rows that see no key."""
    import torch
    out = {}
    for tag, (h, kvh, dh) in NEW_DIM_HEADS.items():
        out[f"bwd_{tag}"] = check_flash_bwd(
            f"flash_bwd_train_{tag}", rng, 2, 2048, (h, kvh, dh),
            torch.bfloat16)
        small = (4, 1 if kvh == 1 else 4, dh)
        for dtype, dt_tag in ((torch.float32, "f32"),
                              (torch.bfloat16, "bf16")):
            for name, b, t, heads, kw in (
                    ("flash_bwd_small", 2, 100, small, {}),
                    ("flash_bwd_small_gqa", 1, 130, (4, 2, dh), {}),
                    ("flash_bwd_small_noncausal", 1, 70, small,
                     {"causal": False}),
                    ("flash_bwd_small_window", 2, 150, small,
                     {"window": 40, "q_offset": 3}),
                    ("flash_bwd_small_no_key", 1, 80, small,
                     {"q_offset": -20})):
                check_flash_bwd(f"{name}_{tag}_{dt_tag}", rng, b, t, heads,
                                dtype, time_it=False, **kw)
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


# ---------------------------------------------------------------------------
# phase 5: the serving front end (ServingFrontend, the radix prefix cache)
# ---------------------------------------------------------------------------

#: bench_inference.py's shared_prefix_stream at Llama-3 8B: one warm
#: request that is only the shared prefix, then FRONTEND_REQUESTS requests
#: of the prefix plus 128-700 unique tokens submitted at once, 16-48 new
#: tokens each, decode megasteps of up to 8 tokens
FRONTEND_PREFIX = 1000
FRONTEND_REQUESTS = 24
FRONTEND_MEGASTEP = 8


def _graph_delta(eng, gs0: dict, label: str) -> dict:
    """``_graphs`` for a run that starts from ``eng.stats`` cleared and
    ``gs0``, the graph stats before it: the run replayed graphs, no
    decode window of it ran stepwise for want of pages, and K2's decode
    launches are layers x (decode steps + the warm-up of each capture the
    run made)."""
    gs = {k: eng.graph_stats[k] - gs0[k] for k in gs0}
    assert gs["replays"] > 0 and gs["fallback_steps"] == 0, (label, gs)
    dec = eng.stats["decode"]
    want = eng.model_config.num_layers * (dec["steps"] + gs["graphs"])
    assert dec["launches"]["paged_attention"] == want, (label, want, dec, gs)
    gs["eager_decode_steps"] = dec["steps"] - gs["replays"]
    return gs


def _frontend_stream(eng, prefix, tails, budgets, cache: bool,
                     main_path: bool = True,
                     megastep: int = FRONTEND_MEGASTEP):
    """One ServingFrontend over ``eng``: the warm request (the prefix
    alone, 4 new tokens) runs to idle, then every request is submitted at
    once and the pump runs until all are done, each pump timed. Every
    count is set to 0 just before the stream and read just after it. A
    decode-megastep pump's wall against the engine's own seconds for its
    window (upload, replays, fetch) and any graph capture it made is the
    pump's host cost a window.
    ``main_path``: a bf16 run of the kernel table's serving paths, whose
    K2 launches by form go into PAGED_FORM_LAUNCHES (``_paged_forms``)."""
    import torch
    from deepspeed_tpu_torch.inference.engine_v2 import (
        dispatch_counts, reset_dispatch_counts)
    from deepspeed_tpu_torch.ops import op_builder
    from deepspeed_tpu_torch.ops import paged_attention as pa
    from deepspeed_tpu_torch.serving import ServingFrontend
    fe = ServingFrontend(eng, enable_prefix_cache=cache,
                         megastep_tokens=megastep)
    cows = []
    cow_block = eng.cow_block
    eng.cow_block = lambda src: cows.append(src) or cow_block(src)
    # the token slots each stepwise step computes: rows pad to a power of
    # two and a chunk step's rows (decode rows riding along too) to the
    # prefill chunk's width
    slots = {"chunk_steps": 0, "chunk_slots": 0, "decode_slots": 0}
    buckets = eng._buckets

    def count_slots(batch):
        nb, cb = buckets(batch)
        if cb > 1:
            slots["chunk_steps"] += 1
            slots["chunk_slots"] += nb * cb
        else:
            slots["decode_slots"] += nb
        return nb, cb

    eng._buckets = count_slots
    warm = fe.submit(prefix, max_new_tokens=4)
    fe.run_until_idle()
    assert warm.finish_reason == "length" and warm.cached_tokens == 0
    op_builder.reset_launches()
    pa.reset_form_launches()
    reset_dispatch_counts()
    eng.stats.clear()
    gs0 = dict(eng.graph_stats)
    del cows[:]
    slots.update(chunk_steps=0, chunk_slots=0, decode_slots=0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    reqs = [fe.submit(prefix + tail, max_new_tokens=b)
            for tail, b in zip(tails, budgets)]
    windows = []        # (pump wall s, engine window s, steps, capture s)
    while fe._running or len(fe.queue):
        ms0 = dispatch_counts["megastep_launches"]
        dec0 = dict(eng.stats.get("decode", {"seconds": 0.0, "steps": 0}))
        cap0 = eng.graph_stats["capture_seconds"]
        t = time.perf_counter()
        fe.step()
        dt = time.perf_counter() - t
        if dispatch_counts["megastep_launches"] > ms0:
            dec = eng.stats["decode"]
            windows.append((dt, dec["seconds"] - dec0["seconds"],
                            dec["steps"] - dec0["steps"],
                            eng.graph_stats["capture_seconds"] - cap0))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    del eng.cow_block, eng._buckets
    launches = dict(op_builder.launches)
    forms = _paged_forms(eng.stats) if main_path else \
        dict(pa.form_launches["paged_attention"])
    graphs = _graph_delta(eng, gs0, "frontend cache=" + str(cache))
    st = {k: dict(v, launches=dict(v["launches"]))
          for k, v in eng.stats.items()}
    for r, b in zip(reqs, budgets):
        assert r.finish_reason == "length" and len(r.tokens_out) == b, \
            (r.finish_reason, len(r.tokens_out), b)
    total = sum(v["tokens"] for v in st.values())
    # every computed token is a prompt token not served from the cache or
    # a fed-back decode token (each request's last token is never fed)
    prefill = total - sum(b - 1 for b in budgets)
    ttft = np.asarray([r.ttft for r in reqs])
    tpot = np.asarray([r.tpot for r in reqs])
    w = np.asarray(windows) if windows else np.zeros((0, 4))
    res = {"cache": cache, "requests": len(reqs), "wall_s": wall,
           "requests_per_s": len(reqs) / wall,
           "ttft_mean_ms": 1e3 * float(ttft.mean()),
           "ttft_p99_ms": 1e3 * float(np.percentile(ttft, 99)),
           "tpot_mean_ms": 1e3 * float(tpot.mean()),
           "prefill_tokens": prefill, "tokens_computed": total,
           "token_slots": slots,
           "chunk_step_slot_use": sum(
               st[m]["tokens"] for m in ("fresh", "split") if m in st)
           / max(1, slots["chunk_slots"]),
           "counters": dict(fe.metrics.counters),
           "cow_copies": len(cows),
           "dispatch": dict(dispatch_counts),
           "megastep_windows": len(windows),
           "window_decode_steps": int(w[:, 2].sum()),
           "frontend_decode_ms_per_step":
               1e3 * float((w[:, 0] - w[:, 3]).sum() / w[:, 2].sum())
               if windows else None,
           "engine_window_ms_per_step":
               1e3 * float(w[:, 1].sum() / w[:, 2].sum()) if windows
               else None,
           "pump_host_ms_per_window":
               1e3 * float((w[:, 0] - w[:, 1] - w[:, 3]).mean())
               if windows else None,
           "capture_ms_in_windows": 1e3 * float(w[:, 3].sum()),
           "decode_graphs": graphs, "paged_launches_by_form": forms,
           "launches": launches,
           "stats": {k: {kk: v[kk] for kk in ("steps", "tokens", "seconds")}
                     for k, v in st.items()}}
    return fe, reqs, res


def _logits_of(eng, uid):
    """Step the engine until ``uid``'s pending tokens are consumed;
    returns its last-token logits (fp32)."""
    out = {}
    while uid not in out:
        res = eng.step()
        assert res is not None
        out.update(res)
    eng.flush(uid)
    return out[uid]


def _cow_hit_logits(eng, cache, prefix, tail) -> dict:
    """The last-token logits of one copy-on-write prefix hit, taken as
    tests/test_serving.py:346 takes them (``adopt_cached``, then ``step``),
    against two cold prefills in the same engine: the prompt in one pass
    (A) and the prefix, then the tail (B, the hit's chunking). bf16
    tolerance from the spread the two cold runs show: the hit reads the
    prefix KV that the warm request wrote with B's chunks, so it must sit
    within twice max(|A - B|, one bf16 step at the logits' scale) of both
    cold runs."""
    from deepspeed_tpu_torch.serving import adopt_cached
    prompt = prefix + tail
    base = max(eng.state.seqs.keys(), default=-1) + 1
    matched = adopt_cached(eng, cache, base, prompt)
    assert matched == len(prefix), matched
    hit = _logits_of(eng, base)
    one_pass = eng.put([base + 1], [prompt])[base + 1]
    eng.flush(base + 1)
    eng.put([base + 2], [prefix])
    rechunked = eng.put([base + 2], [tail])[base + 2]
    eng.flush(base + 2)
    return {"hit": hit, "one_pass": one_pass, "rechunked": rechunked}


def phase_serve_frontend(eng, cfg) -> dict:
    """The serving front end on phase 5's Llama-3 8B bf16 engine (full
    width and depth, 512 pages of 128): bench_inference.py's
    shared_prefix_stream through one ServingFrontend with the radix
    prefix cache on, then through one with it off, each stream counted
    from 0 (``_frontend_stream``). With the cache on, every request
    adopts the 1000-token prefix (7 aliased pages and a copy-on-write
    copy of the 8th), so its first chunk is a split-prefill step whose
    history (K2's mma form) ends mid-page; decode windows replay the
    captured steps. Returns the two streams' launches together."""
    rng = np.random.default_rng(17)
    prefix = [int(t) for t in rng.integers(0, cfg.vocab_size,
                                           size=FRONTEND_PREFIX)]
    tails = [[int(t) for t in rng.integers(0, cfg.vocab_size, size=int(n))]
             for n in rng.integers(128, 701, size=FRONTEND_REQUESTS)]
    budgets = [int(b) for b in rng.integers(16, 49, size=FRONTEND_REQUESTS)]
    probe = [int(t) for t in rng.integers(0, cfg.vocab_size, size=300)]
    fe_on, reqs_on, on = _frontend_stream(eng, prefix, tails, budgets, True)
    n = FRONTEND_REQUESTS
    assert on["counters"]["prefix_tokens_reused"] == n * FRONTEND_PREFIX, on
    assert on["cow_copies"] == n, on["cow_copies"]
    assert all(r.cached_tokens == FRONTEND_PREFIX for r in reqs_on)
    assert on["paged_launches_by_form"]["mma"] > 0, on
    # one copy-on-write hit's logits against two cold prefills, while the
    # cache still holds the prefix (a tail no request had)
    lg = _cow_hit_logits(eng, fe_on.cache, prefix, probe)
    spread = float(np.abs(lg["one_pass"] - lg["rechunked"]).max())
    step = float(np.abs(lg["one_pass"]).max()) * 2.0 ** -8
    tol = 2 * max(spread, step)
    hit_err = {k: float(np.abs(lg["hit"] - lg[k]).max())
               for k in ("one_pass", "rechunked")}
    assert np.isfinite(lg["hit"]).all()
    assert max(hit_err.values()) <= tol, (hit_err, tol)
    fe_on.cache.evict(fe_on.cache.pages_cached)
    assert fe_on.cache.pages_cached == 0 and not eng.state.seqs
    assert eng.state.allocator.free_blocks == SERVE_BLOCKS, "pages leaked"
    _, reqs_off, off = _frontend_stream(eng, prefix, tails, budgets, False)
    assert off["counters"]["prefix_tokens_reused"] == 0
    assert off["cow_copies"] == 0
    assert off["prefill_tokens"] == sum(len(prefix) + len(t) for t in tails)
    assert on["prefill_tokens"] == off["prefill_tokens"] - \
        n * FRONTEND_PREFIX, (on["prefill_tokens"], off["prefill_tokens"])
    assert eng.state.allocator.free_blocks == SERVE_BLOCKS, "pages leaked"
    launches = {k: on["launches"][k] + off["launches"][k]
                for k in on["launches"]}
    emit({"phase": "serve_frontend", "model": "llama3-" + SERVE_MODEL[0],
          "dtype": "bfloat16", "prefix": FRONTEND_PREFIX,
          "tails": [len(t) for t in tails], "new_tokens": budgets,
          "megastep_tokens": FRONTEND_MEGASTEP,
          "cache_on": {k: v for k, v in on.items() if k != "launches"},
          "cache_off": {k: v for k, v in off.items() if k != "launches"},
          "streams_identical_on_off": sum(
              a.tokens_out == b.tokens_out
              for a, b in zip(reqs_on, reqs_off)),
          "cow_hit_logits": {"max_abs_err": hit_err,
                             "cold_chunking_spread": spread,
                             "bf16_step": step, "tol": tol},
          "launches": launches})
    return launches


def _frontend_fp32(eng, cfg) -> dict:
    """fp32 token identity of the front end on phase_fused_fp32's engine:
    a warm 300-token prefix, then 4 requests of that prefix plus 64-200
    unique tokens, 16 new tokens each, through a ServingFrontend with the
    cache on, one with it off, and ``engine.generate``: identical tokens.
    Then the cache-on frontend's pages of request 0's prompt go out as a
    handoff bundle (``export_bundle``) and into a second frontend on a
    fresh engine with the same weights (``adopt_bundle``), which serves
    that prompt from the bundle's pages with the same tokens."""
    import torch
    from deepspeed_tpu_torch import RaggedInferenceEngine
    from deepspeed_tpu_torch.serving import (ServingFrontend, adopt_bundle,
                                             export_bundle, verify_bundle)
    rng = np.random.default_rng(23)
    prefix = [int(t) for t in rng.integers(0, cfg.vocab_size, size=300)]
    tails = [[int(t) for t in rng.integers(0, cfg.vocab_size, size=int(n))]
             for n in rng.integers(64, 201, size=4)]
    budgets = [16] * 4
    fe_on, reqs_on, on = _frontend_stream(eng, prefix, tails, budgets, True,
                                          main_path=False)
    assert on["counters"]["prefix_tokens_reused"] == 4 * 300
    _, reqs_off, off = _frontend_stream(eng, prefix, tails, budgets, False,
                                        main_path=False)
    gen = eng.generate([np.asarray(prefix + t, np.int32) for t in tails],
                       max_new_tokens=16)
    gen = [g[len(prefix) + len(t):].tolist() for g, t in zip(gen, tails)]
    on_toks = [r.tokens_out for r in reqs_on]
    assert on_toks == [r.tokens_out for r in reqs_off] == gen, \
        "fp32: the front end's tokens differ (cache on / off / generate)"
    prompt = prefix + tails[0]
    bundle = export_bundle(fe_on, prompt)
    assert bundle is not None and verify_bundle(bundle)
    eng2 = RaggedInferenceEngine(
        cfg, eng.config, generator=torch.Generator(device=DEV).manual_seed(5),
        device=DEV)
    fe2 = ServingFrontend(eng2, megastep_tokens=FRONTEND_MEGASTEP)
    adopted = adopt_bundle(fe2, bundle)
    assert adopted == bundle.num_pages, (adopted, bundle.num_pages)
    req = fe2.submit(prompt, max_new_tokens=16)
    fe2.run_until_idle()
    assert req.cached_tokens == len(prompt) - 1, req.cached_tokens
    assert req.tokens_out == on_toks[0], "fp32: handoff changed the tokens"
    del fe2, eng2
    torch.cuda.empty_cache()
    return {"identical_cache_on_off_generate": True,
            "bundle_pages": bundle.num_pages,
            "bundle_bytes": bundle.nbytes,
            "page_nbytes": eng.kv_page_nbytes(),
            "handoff_cached_tokens": req.cached_tokens,
            "handoff_identical": True,
            "cache_on": {k: on[k] for k in ("prefill_tokens", "counters",
                                            "decode_graphs",
                                            "paged_launches_by_form")},
            "cache_off": {k: off[k] for k in ("prefill_tokens",
                                              "paged_launches_by_form")}}


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
    emit(dict({"phase": "serve_frontend_fp32", "model": "llama3-8b-2L",
               "dtype": "float32"}, **_frontend_fp32(eng, cfg)))
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
    frontend = phase_serve_frontend(eng, cfg)
    del eng                    # the MoE runs need the card's memory
    torch.cuda.empty_cache()
    return launches, frontend


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
    tree (drawn quantized on the card, copied to the CPU): depth 1 at
    Llama-3 8B width under each of the four formats (a fresh chunk, a
    split chunk and a decode step, the head included: (4096, 128256)),
    then depth 1 at Mixtral 8x7B width in int8 (a fresh 2 x 32 chunk and a
    decode step, both through the capacity layer's batched kernel). Depth
    1, not 2: the CPU side's plain dequantizing matmuls were the largest
    CPU cost of the script, and one layer runs every kernel shape that two
    do.
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
    runs = [(mode, llama3_config("8b", num_layers=1), mode) for mode in
            QUANT_MODES] + [("mixtral-int8", mixtral_config(
                "8x7b", num_layers=1), "int8")]
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
            emit({"phase": "full_width_quant", "model": name + "-depth1",
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
# phase 5: the model families through HF checkpoints (Gemma-2B, Phi-2)
# ---------------------------------------------------------------------------

#: the head dims the model families add, at the heads (H, KvH, dh) of the
#: model that brings each: Gemma-2B (MQA, dh 256), Phi-2 (dh 80),
#: GPT-NeoX-20B (dh 96)
NEW_DIM_HEADS = {"gemma2b_dh256": (8, 1, 256), "phi2_dh80": (32, 32, 80),
                 "neox20b_dh96": (64, 64, 96)}
#: the served HF models: name, preset function, size, seed, arena pages
HF_MODELS = (("gemma-2b", "gemma_config", "2b", 30, 128),
             ("phi-2", "phi_config", "2", 31, 96))
#: phase_serve's 8 prompt lengths, 32 new tokens
HF_PROMPTS = (64, 1500, 300, 777, 128, 1024, 513, 900)
HF_NEW = 32
#: the fp32 card-vs-CPU hold: depth 2, 4 prompts, 8 new tokens; logits
#: atol/rtol 2e-3 (phase_full_width's: fp32 on both sides, sums in other
#: orders over 2048-16384 terms; a wrong mask, page or layout moves a
#: logit by O(0.1))
HF_FP32 = dict(layers=2, prompts=(40, 300, 129, 7), new=8, tol=2e-3)


def _jitter(tree, gen):
    """Give the leaves that init_params draws as constants (norm scales
    1, biases 0) random values, so that a swapped or misfolded leaf
    shows in the export round trip."""
    import torch
    for k, v in tree.items():
        if isinstance(v, dict):
            _jitter(v, gen)
        elif k == "scale" or k == "bias" or k.startswith("b") or \
                k == "lm_head_bias":
            noise = torch.randn(v.shape, generator=gen, device=v.device)
            base = 1.0 if k == "scale" else 0.0
            tree[k] = (base + 0.1 * noise).to(v.dtype)


def _cast_tree(tree, dtype):
    """Every floating leaf in ``dtype`` (init_params keeps norm
    parameters in fp32; the engine casts them to its dtype, and an HF
    checkpoint holds one dtype)."""
    return {k: _cast_tree(v, dtype) if isinstance(v, dict) else
            (v.to(dtype) if v.is_floating_point() else v)
            for k, v in tree.items()}


def _leaf_map(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaf_map(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree}


def _hf_round_trip(cfg, params, root, name) -> dict:
    """export_hf_checkpoint then load_hf_checkpoint(dtype=bf16) on the
    card; every leaf held to the exported one: bitwise, except Gemma's
    (1 + w) norm scales within one bf16 ulp. Returns the loaded (cfg,
    params) and the line's numbers."""
    import shutil
    import torch
    from deepspeed_tpu_torch import export_hf_checkpoint, load_hf_checkpoint
    out_dir = os.path.join(root, name)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    export_hf_checkpoint(cfg, params, out_dir)
    export_s = time.perf_counter() - t0
    nbytes = _dir_bytes(out_dir)
    t0 = time.perf_counter()
    cfg2, loaded = load_hf_checkpoint(out_dir, dtype=torch.bfloat16,
                                      device=DEV)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    want, got = _leaf_map(params), _leaf_map(loaded)
    assert sorted(want) == sorted(got), (sorted(want), sorted(got))
    folded = cfg.activation == "gelu_glu" and cfg.scale_embeddings
    bitwise, ulp_leaves, worst_ulps = 0, 0, 0.0
    for k, w in want.items():
        g = got[k]
        assert g.dtype == torch.bfloat16 and g.device == w.device and \
            g.shape == w.shape, k
        if folded and k.endswith("/scale"):
            ulp = torch.finfo(torch.bfloat16).eps * w.float().abs()
            ulps = float(((g.float() - w.float()).abs() / ulp).max())
            worst_ulps = max(worst_ulps, ulps)
            assert ulps <= 1.0, (k, ulps)
            ulp_leaves += 1
        else:
            assert torch.equal(g, w), k
            bitwise += 1
    for f in ("hidden_size", "num_layers", "num_heads", "kv_heads",
              "head_dim", "ffn_size", "vocab_size", "rope_dim", "norm",
              "activation", "tie_embeddings", "parallel_block",
              "lm_head_bias", "scale_embeddings", "norm_eps"):
        assert getattr(cfg2, f) == getattr(cfg, f), f
    shutil.rmtree(out_dir)
    return cfg2, loaded, {
        "export_seconds": export_s, "export_gb_per_s": nbytes / export_s / 1e9,
        "bytes_on_disk": nbytes, "load_seconds": load_s,
        "load_gb_per_s": nbytes / load_s / 1e9,
        "load_page_cache": "warm (the file was just written)",
        "leaves_bitwise": bitwise, "leaves_within_1_ulp": ulp_leaves,
        "worst_folded_ulps": worst_ulps}


def _decode_device_ms(eng, prompts) -> dict:
    """Prefill ``prompts``, then ONE decode megastep window of 8 replays
    of the captured step under ``torch.profiler``: the window's wall and
    the device time of the kernels the card ran, a step each."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    base = max(eng.state.seqs.keys(), default=-1) + 1
    uids = [base + i for i in range(len(prompts))]
    eng.scheduler.put(uids, prompts)
    last = {}
    while True:
        res = eng.step_with_budget(mode=("argmax",))
        if res is None:
            break
        last.update(res)
    eng.scheduler.put(uids, [[int(last[u][-1] if isinstance(last[u], list)
                                  else last[u])] for u in uids])
    r0 = eng.graph_stats["replays"]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = eng.step_with_budget(mode=("argmax",), max_steps=8)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    assert eng.graph_stats["replays"] - r0 == 8, eng.graph_stats
    assert sorted(out) == uids and all(len(t) == 8 for t in out.values())
    for u in uids:
        eng.flush(u)
    dev_us = sum(e.time_range.end - e.time_range.start
                 for e in prof.events() if e.device_type == DeviceType.CUDA)
    return {"window_steps": 8, "wall_ms_per_step": 1e3 * wall / 8,
            "device_ms_per_step": dev_us / 1e3 / 8,
            "idle_share": 1.0 - dev_us / 1e6 / wall}


def _hf_fp32_hold(preset, size, seed) -> dict:
    """fp32 at depth 2, one seeded tree on the card (kernels) and on the
    CPU (plain versions): put logits within HF_FP32's tol, then greedy
    generate tokens identical (a fresh prefill chunk, a split chunk past
    256 tokens, decode steps)."""
    import torch
    from deepspeed_tpu_torch import RaggedInferenceEngine
    from deepspeed_tpu_torch.models.transformer import init_params
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = preset(size, num_layers=HF_FP32["layers"], max_seq_len=512)
    gen = torch.Generator(device=DEV).manual_seed(seed)
    params = init_params(cfg, gen, torch.float32, DEV)
    _jitter(params, gen)
    conf = {"dtype": "float32", "num_blocks": 32, "block_size": 128,
            "max_seq_len": 512, "max_batch_tokens": 1024,
            "prefill_chunk": 256}
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, cfg.vocab_size, size=n).astype(np.int32)
               for n in HF_FP32["prompts"]]
    got = {}
    for where, tree in (("card", params), ("cpu", _to_cpu(params))):
        eng = RaggedInferenceEngine(cfg, conf, params=tree,
                                    device=DEV if where == "card" else "cpu")
        logits = eng.put(list(range(len(prompts))), prompts)
        for u in range(len(prompts)):
            eng.flush(u)
        toks = eng.generate(prompts, max_new_tokens=HF_FP32["new"])
        got[where] = ({u: torch.as_tensor(v) for u, v in logits.items()},
                      [t.tolist() for t in toks])
        del eng
    del params
    torch.cuda.empty_cache()
    err = max(_err(got["card"][0][u], got["cpu"][0][u]) for u in got["cpu"][0])
    tol = HF_FP32["tol"]
    for u in got["cpu"][0]:
        torch.testing.assert_close(got["card"][0][u], got["cpu"][0][u],
                                   rtol=tol, atol=tol)
    same = got["card"][1] == got["cpu"][1]
    assert same, "fp32: card and CPU greedy tokens differ"
    return {"layers": cfg.num_layers, "max_abs_err": err, "tol": tol,
            "logit_absmax": max(float(v.abs().max())
                                for v in got["cpu"][0].values()),
            "tokens_identical": same, "new_tokens": HF_FP32["new"]}


def phase_hf_models() -> dict:
    """Gemma-2B and Phi-2 at full width and depth in bf16 through the
    port's HF checkpoint entry points: weights drawn on the card from a
    seeded generator, ``export_hf_checkpoint`` to a directory under
    ``build/`` (removed when the phase ends), ``load_hf_checkpoint(dtype=
    bf16)`` back onto the card, every leaf held to the exported tree; then
    ``RaggedInferenceEngine.generate`` on HF_PROMPTS with HF_NEW new
    tokens from the loaded tree (fused decode windows on CUDA graphs),
    K1's and K2's launches (by form and head dim) counted from 0 around
    it, and one megastep window traced for the decode step's device time;
    then the fp32 depth-2 hold against the CPU. Returns the launches of
    the two generate runs, the path's."""
    import shutil
    import tempfile
    import torch
    import deepspeed_tpu_torch as dt
    from deepspeed_tpu_torch import RaggedInferenceEngine
    from deepspeed_tpu_torch.models.transformer import init_params
    from deepspeed_tpu_torch.ops import flash_attention as fa
    from deepspeed_tpu_torch.ops import op_builder
    from deepspeed_tpu_torch.ops import paged_attention as pa
    here = os.path.dirname(os.path.abspath(__file__))
    os.makedirs(os.path.join(here, "build"), exist_ok=True)
    root = tempfile.mkdtemp(prefix="hf_", dir=os.path.join(here, "build"))
    total = {k: 0 for k in op_builder.launches}
    try:
        for name, preset_name, size, seed, blocks in HF_MODELS:
            preset = getattr(dt, preset_name)
            cfg = preset(size)
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            gen = torch.Generator(device=DEV).manual_seed(seed)
            t0 = time.perf_counter()
            params = init_params(cfg, gen, torch.bfloat16, DEV)
            _jitter(params, gen)
            params = _cast_tree(params, torch.bfloat16)
            torch.cuda.synchronize()
            draw_s = time.perf_counter() - t0
            cfg2, loaded, trip = _hf_round_trip(cfg, params, root, name)
            del params
            torch.cuda.empty_cache()
            eng = RaggedInferenceEngine(
                cfg2, {"dtype": "bfloat16", "num_blocks": blocks,
                       "block_size": 128, "max_seq_len": 2048,
                       "max_sequences": 64, "max_batch_tokens": 2048,
                       "prefill_chunk": 256}, params=loaded, device=DEV)
            del loaded
            rng = np.random.default_rng(seed)
            prompts = [rng.integers(0, cfg.vocab_size, size=n)
                       .astype(np.int32) for n in HF_PROMPTS]

            # the main path: every count set to 0 just before, read just
            # after
            op_builder.reset_launches()
            pa.reset_form_launches()
            pa.reset_head_dim_launches()
            fa.reset_head_dim_launches()
            eng.stats.clear()
            t1 = time.perf_counter()
            outs = eng.generate(prompts, max_new_tokens=HF_NEW)
            gen_s = time.perf_counter() - t1
            launches = dict(op_builder.launches)
            paged_forms = _paged_forms(eng.stats)
            dims = {"flash_attention_fwd": dict(
                        fa.head_dim_launches["flash_attention_fwd"]),
                    "paged_attention": dict(
                        pa.head_dim_launches["paged_attention"])}
            st = {k: dict(v, launches=dict(v["launches"]))
                  for k, v in eng.stats.items()}
            graphs = _graphs(eng, name)
            for k, by_dim in dims.items():
                assert by_dim[cfg.head_dim] == launches[k] > 0, (k, dims)
                HF_DIM_LAUNCHES[k][cfg.head_dim] += launches[k]
            for p, o in zip(prompts, outs):
                assert len(o) == len(p) + HF_NEW and (o[:len(p)] == p).all()
                assert ((o >= 0) & (o < cfg.vocab_size)).all()
            assert not eng.state.seqs
            assert eng.state.allocator.free_blocks == blocks, "pages leaked"
            for mode in ("fresh", "split", "decode"):
                assert mode in st, f"{name}: no {mode} step ran"
            assert launches["flash_attention_bwd"] == 0, launches
            window = _decode_device_ms(eng, prompts)
            res = {"phase": "hf_models", "model": name, "dtype": "bfloat16",
                   "params": cfg.num_params(), "layers": cfg.num_layers,
                   "head_dim": cfg.head_dim, "heads": [cfg.num_heads,
                                                       cfg.kv_heads],
                   "draw_seconds": draw_s, **trip,
                   "generate_seconds": gen_s,
                   "prefill_tok_s": _rate(("fresh", "split"), st),
                   "decode_ms_per_step": 1e3 * st["decode"]["seconds"]
                   / st["decode"]["steps"],
                   "decode_window": window, "decode_graphs": graphs,
                   "stats": st, "launches": launches,
                   "paged_launches_by_form": paged_forms,
                   "launches_by_head_dim": dims,
                   "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
            del eng
            torch.cuda.empty_cache()
            res["fp32_vs_cpu"] = _hf_fp32_hold(preset, size, seed)
            emit(res)
            for k, v in launches.items():
                total[k] += v
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return total


# ---------------------------------------------------------------------------
# phase 11: v1 inference and the quantization tool (run after phase 5)
# ---------------------------------------------------------------------------

#: (a)/(b): Llama-3 8B at full width and depth, 8 prompts of 512 tokens,
#: 128 new tokens, greedy; (b) in each of V1_QUANT
V1_LLAMA = ("8b", {})
V1_BATCH, V1_PROMPT, V1_NEW = 8, 512, 128
#: new tokens of (a)'s traced ``generate`` (its trace's event count keeps
#: the profiler's own processing short)
V1_TRACED_NEW = 16
V1_QUANT = ("int8", "int4")
#: (c): BLOOM-7b1 at full width and depth, 4 prompts of 256 tokens, 64 new
#: tokens; BLOOM-560m through the HF export/load round trip
V1_BLOOM = ("7b1", {})
V1_BLOOM_SMALL = ("560m", {})
V1_BLOOM_BATCH, V1_BLOOM_PROMPT, V1_BLOOM_NEW = 4, 256, 64
#: (d): BERT-large, exported and loaded, 32 sequences of 64-512 tokens
V1_BERT = ("large", {})
V1_BERT_SEQS = 32
#: (e): Mixtral 8x7B's width cut to 16 of its 32 layers (phase 5's cut:
#: the bf16 weights, 47 GB, fit beside the rest), 8 prompts of 256 tokens
#: (the 2048-token prefill takes the dropless grouped FFN), 16 new
#: tokens, bf16 then int8 (K5c)
V1_MIXTRAL = ("8x7b", {"num_layers": 16})
V1_MOE_BATCH, V1_MOE_PROMPT, V1_MOE_NEW = 8, 256, 16
#: (f): the quantizer CLI on an exported Llama-3-width model of depth 2
V1_CLI = ("8b", {"num_layers": 2})
V1_CLI_MODE = "int4"
#: (g): fp32 at depth 2, card against CPU, 2 prompts of 32 tokens, 4 new
V1_FP32 = {"layers": 2, "batch": 2, "prompt": 32, "new": 4, "tol": 1e-4}


def _v1_rel(a, b) -> float:
    """Largest |a - b| over the largest |b|."""
    a, b = a.float(), b.float()
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


def _v1_prefill_ms(eng, prompts, new) -> float:
    """The prefill generate runs first (forward_with_cache over the
    prompts into an empty cache), timed alone on a cache of its own, of
    generate's length, after a warm-up call."""
    import torch
    from deepspeed_tpu_torch.models.transformer import init_kv_cache
    b, t = prompts.shape
    cache = init_kv_cache(eng.model_config, b, eng._cache_rows(t + new),
                          eng.dtype, eng.device)
    tok = torch.from_numpy(prompts).to(eng.device)
    with torch.no_grad():
        eng._step(tok, cache, 0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng._step(tok, cache, 0)
        torch.cuda.synchronize()
    del cache
    return 1e3 * (time.perf_counter() - t0)


def _v1_generate(eng, prompts, new, stepwise: bool = False) -> tuple:
    """The prefill alone, then the main path: ``generate`` twice (the
    first captures the decode step's graph), tokens equal, every launch
    count set to 0 just before and read just after; decode ms a token of
    the graph path (and of the stepwise loop, its tokens held to the
    graph's). Returns (tokens, numbers, launches)."""
    import torch
    from deepspeed_tpu_torch.ops import op_builder
    prefill_ms = _v1_prefill_ms(eng, prompts, new)
    g0 = dict(eng.graph_stats)
    _v1_reset()
    t0 = time.perf_counter()
    first = eng.generate(prompts, max_new_tokens=new)
    first_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    out = eng.generate(prompts, max_new_tokens=new)
    gen_s = time.perf_counter() - t0
    launches = dict(op_builder.launches)
    assert (first == out).all(), "greedy generate is not repeatable"
    assert out.shape == (prompts.shape[0], prompts.shape[1] + new)
    assert (out[:, :prompts.shape[1]] == prompts).all()
    assert ((out >= 0) & (out < eng.model_config.vocab_size)).all()
    gs = {k: eng.graph_stats[k] - g0[k] for k in ("graphs", "replays")}
    assert gs == {"graphs": 1, "replays": 2 * (new - 1)}, gs
    res = {"prefill_ms": prefill_ms,
           "prefill_tok_s": prompts.size / prefill_ms * 1e3,
           "generate_first_seconds": first_s, "generate_seconds": gen_s,
           "decode_ms_per_token_graph": (1e3 * gen_s - prefill_ms)
           / (new - 1),
           "graph_capture_seconds": eng.graph_stats["capture_seconds"],
           "graph_pool_bytes": eng.graph_stats["pool_bytes"]}
    if stepwise:
        t0 = time.perf_counter()
        step = eng._generate_stepwise(prompts, max_new_tokens=new)
        step_s = time.perf_counter() - t0
        assert (step == out).all(), "graph tokens differ from stepwise"
        res["graph_tokens_equal_stepwise"] = True
        res["decode_ms_per_token_stepwise"] = (1e3 * step_s - prefill_ms) \
            / (new - 1)
    torch.cuda.synchronize()
    return out, res, launches


def _v1_quant_forms(launches, kernels, decode: bool = True) -> dict:
    """K5's launches by form and by weight shape since the last reset,
    added to QUANT_FORM_LAUNCHES / QUANT_SHAPE_LAUNCHES: in bf16 the
    prefill's projections take wgmma, decode (M = batch) split-K, never
    the fp32 FMA kernel."""
    from deepspeed_tpu_torch.ops import quantized_linear as tq
    forms = {k: dict(v) for k, v in tq.regime_launches.items()}
    shapes = {k: dict(v) for k, v in tq.shape_launches.items()}
    for k in kernels:
        assert launches[k] > 0 and forms[k]["fma"] == 0 and \
            forms[k]["wgmma"] > 0 and (forms[k]["splitk"] > 0) == decode, \
            (k, forms)
    for k, v in forms.items():
        assert sum(v.values()) == launches[k], (k, v, launches)
        for r, c in v.items():
            QUANT_FORM_LAUNCHES[k][r] += c
        for key, c in shapes[k].items():
            QUANT_SHAPE_LAUNCHES[k][key] = \
                QUANT_SHAPE_LAUNCHES[k].get(key, 0) + c
    return {"by_form": forms, "by_shape": shapes}


def _v1_mem_start() -> float:
    """Free what earlier parts left (garbage included), reset the peak,
    and return the GB still allocated: each line's peak counts from it."""
    import gc
    import torch
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    return torch.cuda.memory_allocated() / 1e9


def _v1_freed(ref) -> bool:
    """Whether the engine behind the weak reference ``ref`` went with its
    last reference (no cycle held it); the garbage is collected either
    way."""
    import gc
    import torch
    freed = ref() is None
    gc.collect()
    torch.cuda.empty_cache()
    return freed


def _v1_profiled(eng, prompts, new) -> dict:
    """One ``generate`` under ``torch.profiler``: the wall, the device time
    of the kernels the card ran (prefill and the graph's replays) and the
    idle share, and the kernels with the most device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.generate(prompts, max_new_tokens=new)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            us = e.time_range.end - e.time_range.start
            by_name[e.name] = by_name.get(e.name, 0.0) + us
    dev = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    return {"new": new, "wall_ms": 1e3 * wall, "device_ms": dev / 1e3,
            "idle_share": 1.0 - dev / 1e6 / wall,
            "top_kernels_ms": {k[:80]: v / 1e3 for k, v in top}}


def _v1_reset():
    from deepspeed_tpu_torch.ops import grouped_matmul as tg
    from deepspeed_tpu_torch.ops import op_builder
    from deepspeed_tpu_torch.ops import quantized_linear as tq
    op_builder.reset_launches()
    tq.reset_regime_launches()
    tg.reset_form_launches()


def _v1_add(total, launches):
    for k, v in launches.items():
        total[k] += v


def _v1_llama(smi, total) -> dict:
    """(a) and (b): Llama-3 8B through ``init_inference`` in bf16, then
    in each V1_QUANT format."""
    import torch
    from deepspeed_tpu_torch import (RaggedInferenceEngine, init_inference,
                                     llama3_config)
    cfg = llama3_config(V1_LLAMA[0], **V1_LLAMA[1])
    rng = np.random.default_rng(60)
    prompts = rng.integers(0, cfg.vocab_size,
                           size=(V1_BATCH, V1_PROMPT)).astype(np.int32)
    before = _v1_mem_start()
    t0 = time.perf_counter()
    eng = init_inference(cfg, {"dtype": "bfloat16"},
                         generator=torch.Generator(device=DEV).manual_seed(61),
                         device=DEV)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    out, res, launches = _v1_generate(eng, prompts, V1_NEW, stepwise=True)
    assert not any(launches.values()), launches   # plain attention, GEMMs
    peak = torch.cuda.max_memory_allocated() / 1e9
    # the prefill's last-token logits against the ragged engine's (K1's
    # flash prefill) on the same weights: reported, not gated
    from deepspeed_tpu_torch.models.transformer import init_kv_cache
    cache = init_kv_cache(cfg, V1_BATCH, V1_PROMPT, eng.dtype, DEV)
    tok = torch.from_numpy(prompts).to(DEV)
    half = V1_PROMPT // 2
    with torch.no_grad():
        v1_logits, _ = eng._step(tok, cache, 0)
        # the same prefill in two halves through the cache: the bf16
        # spread of v1 itself, beside the gap to the ragged engine
        eng._step(tok[:, :half], cache, 0)
        halves, _ = eng._step(tok[:, half:], cache, half)
    del cache
    spread = [_row_rel_err(halves[i:i + 1].cpu(), v1_logits[i:i + 1].cpu())
              for i in range(V1_BATCH)]
    # the ragged engine's prefill logits with the prompt as one chunk
    # (K1) and as two chunks of 256 (K1 and K2's history): the second is
    # the bf16 spread of the ragged engine's own arithmetic
    rag_logits, rag_freed = [], []
    for chunk in (V1_PROMPT, V1_PROMPT // 2):
        rag = RaggedInferenceEngine(
            cfg, {"dtype": "bfloat16", "num_blocks": 40, "block_size": 128,
                  "max_seq_len": 1024, "max_sequences": 16,
                  "max_batch_tokens": 4096, "prefill_chunk": chunk},
            params=eng.params, device=DEV)
        got = rag.put(list(range(V1_BATCH)), list(prompts))
        rag_logits.append(torch.stack([torch.as_tensor(got[i]) for i in
                                       range(V1_BATCH)]))
        rref = weakref.ref(rag)
        del rag
        rag_freed.append(_v1_freed(rref))
    rows = [_row_rel_err(v1_logits[i:i + 1].cpu(), rag_logits[0][i:i + 1])
            for i in range(V1_BATCH)]
    rag_spread = [_row_rel_err(rag_logits[1][i:i + 1],
                               rag_logits[0][i:i + 1])
                  for i in range(V1_BATCH)]
    traced = _v1_profiled(eng, prompts, V1_TRACED_NEW)
    ref = weakref.ref(eng)
    del eng
    emit({"phase": "v1_inference", "part": "a", "model": "llama3-8b",
          "dtype": "bfloat16", "nvidia_smi": smi, "layers": cfg.num_layers,
          "batch": V1_BATCH, "prompt": V1_PROMPT, "new": V1_NEW,
          "init_seconds": init_s, **res, "allocated_before_gb": before,
          "peak_mem_gb": peak, "launches": launches, "traced": traced,
          "prefill_logits_row_rel_err_vs_ragged_max": max(rows),
          "prefill_logits_row_rel_err_vs_ragged": rows,
          "prefill_logits_row_rel_err_two_halves_max": max(spread),
          "prefill_logits_row_rel_err_ragged_two_chunks_max":
              max(rag_spread),
          "ragged_engines_freed_by_refcount": rag_freed,
          "engine_freed_by_refcount": _v1_freed(ref)})
    base_ms = res["decode_ms_per_token_graph"]
    for mode in V1_QUANT:
        before = _v1_mem_start()
        t0 = time.perf_counter()
        eng = init_inference(
            cfg, {"dtype": "bfloat16", "weight_quant": mode},
            generator=torch.Generator(device=DEV).manual_seed(61),
            device=DEV)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        _, qres, launches = _v1_generate(eng, prompts, V1_NEW)
        kernel = _quant_kernel(mode)
        assert {k for k, v in launches.items() if v} == {kernel}, launches
        forms = _v1_quant_forms(launches, (kernel,))
        _v1_add(total, launches)
        weight_gb = _tree_bytes(eng.params) / 1e9
        ref = weakref.ref(eng)
        del eng
        emit({"phase": "v1_inference", "part": "b", "model": "llama3-8b",
              "weight_quant": mode, "nvidia_smi": smi,
              "weight_gb": weight_gb, "init_seconds": init_s, **qres,
              "decode_ms_per_token_bf16": base_ms,
              "allocated_before_gb": before,
              "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
              "launches": launches, "k5_launches": forms,
              "engine_freed_by_refcount": _v1_freed(ref)})
    return {"a_prefill_ms": res["prefill_ms"], "a_decode_ms": base_ms}


def _v1_bloom(smi, root, total) -> None:
    """(c): BLOOM-7b1 (ALiBi) at full width and depth in bf16; BLOOM-560m
    exported, loaded back and served."""
    import torch
    from deepspeed_tpu_torch import InferenceEngine, bloom_config
    from deepspeed_tpu_torch.models.transformer import init_params
    from deepspeed_tpu_torch.ops import op_builder
    cfg = bloom_config(V1_BLOOM[0], **V1_BLOOM[1])
    rng = np.random.default_rng(62)
    prompts = rng.integers(0, cfg.vocab_size, size=(
        V1_BLOOM_BATCH, V1_BLOOM_PROMPT)).astype(np.int32)
    before = _v1_mem_start()
    eng = InferenceEngine(cfg, {"dtype": "bfloat16"},
                          generator=torch.Generator(device=DEV).manual_seed(63),
                          device=DEV)
    _, res, launches = _v1_generate(eng, prompts, V1_BLOOM_NEW,
                                    stepwise=True)
    assert not any(launches.values()), launches
    emit({"phase": "v1_inference", "part": "c", "model": "bloom-7b1",
          "dtype": "bfloat16", "nvidia_smi": smi, "layers": cfg.num_layers,
          "params": cfg.num_params(), "batch": V1_BLOOM_BATCH,
          "prompt": V1_BLOOM_PROMPT, "new": V1_BLOOM_NEW, **res,
          "allocated_before_gb": before,
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
          "launches": launches})
    ref = weakref.ref(eng)
    del eng
    freed = _v1_freed(ref)
    cfg = bloom_config(V1_BLOOM_SMALL[0], **V1_BLOOM_SMALL[1])
    gen = torch.Generator(device=DEV).manual_seed(64)
    params = init_params(cfg, gen, torch.bfloat16, DEV)
    _jitter(params, gen)
    params = _cast_tree(params, torch.bfloat16)
    cfg2, loaded, trip = _hf_round_trip(cfg, params, root, "bloom-560m")
    small = prompts[:, :64]
    want = InferenceEngine(cfg, {"dtype": "bfloat16"}, params=params,
                           device=DEV).generate(small, max_new_tokens=16)
    _v1_reset()
    got = InferenceEngine(cfg2, {"dtype": "bfloat16"}, params=loaded,
                          device=DEV).generate(small, max_new_tokens=16)
    _v1_add(total, dict(op_builder.launches))
    assert (got == want).all(), "loaded BLOOM-560m serves other tokens"
    emit({"phase": "v1_inference", "part": "c", "model": "bloom-560m",
          "nvidia_smi": smi, "round_trip": trip,
          "tokens_equal_unexported": True,
          "bloom_7b1_engine_freed_by_refcount": freed})
    del params, loaded
    torch.cuda.empty_cache()


def _v1_bert(smi, root, total) -> None:
    """(d): BERT-large exported and loaded, then EncoderInference on a
    ragged batch, bf16 and int8."""
    import torch
    from deepspeed_tpu_torch import EncoderInference, bert_config
    from deepspeed_tpu_torch.models.transformer import init_params
    from deepspeed_tpu_torch.ops import op_builder
    cfg = bert_config(V1_BERT[0], **V1_BERT[1])
    gen = torch.Generator(device=DEV).manual_seed(65)
    params = init_params(cfg, gen, torch.bfloat16, DEV)
    _jitter(params, gen)
    params = _cast_tree(params, torch.bfloat16)
    cfg2, loaded, trip = _hf_round_trip(cfg, params, root, "bert-large")
    del params
    rng = np.random.default_rng(66)
    seqs = [rng.integers(1, cfg.vocab_size, size=int(n)).tolist()
            for n in rng.integers(64, 513, size=V1_BERT_SEQS)]
    ntok = sum(len(s) for s in seqs)
    outs, lines, shapes = {}, {}, {}
    for mode in (None, "int8"):
        before = _v1_mem_start()
        eng = EncoderInference(cfg2, {"dtype": "bfloat16",
                                      "weight_quant": mode},
                               params=loaded, device=DEV)
        eng(seqs[:2])                     # warm-up
        torch.cuda.synchronize()
        _v1_reset()
        t0 = time.perf_counter()
        outs[mode] = eng(seqs)
        sec = time.perf_counter() - t0
        launches = dict(op_builder.launches)
        if mode:
            shapes = _v1_quant_forms(launches, ("quantized_matmul",),
                                     decode=False)["by_shape"]
            assert {k for k, v in launches.items() if v} == \
                {"quantized_matmul"}, launches
        else:
            assert not any(launches.values()), launches
        _v1_add(total, launches)
        for s, o in zip(seqs, outs[mode]):
            assert o.shape == (len(s), cfg.vocab_size) and \
                np.isfinite(o).all()
        # the final hidden states alone: the same forward without the
        # masked-LM head and without fetching [B, T, V] fp32 logits
        t0 = time.perf_counter()
        eng(seqs, output="hidden")
        hid_s = time.perf_counter() - t0
        lines[mode or "bf16"] = {
            "seconds": sec, "sequences_per_s": len(seqs) / sec,
            "tokens_per_s": ntok / sec, "hidden_seconds": hid_s,
            "hidden_sequences_per_s": len(seqs) / hid_s,
            "launches": launches, "allocated_before_gb": before,
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
        del eng
    cos = min(float(np.sum(a * b) / (np.linalg.norm(a) * np.linalg.norm(b)))
              for a, b in zip(outs[None], outs["int8"]))
    assert cos > 0.99, cos
    # K5a held against its plain version at every weight shape the int8
    # scoring launched it at, with the batch's rows (B x the longest
    # sequence): the cosine above alone would miss a wrong tile
    rows = len(seqs) * max(len(s) for s in seqs)
    held = {}
    for key in sorted(shapes["quantized_matmul"]):
        k, n = (int(d) for d in key.split()[1].split("x"))
        res = check_qmm(f"qmm_int8_bert_large_m{rows}_{k}x{n}", rng, "int8",
                        rows, k, n, torch.bfloat16, time_it=False)
        held[f"{rows}x{k}x{n}"] = res["max_abs_err"]
    assert held, shapes
    emit({"phase": "v1_inference", "part": "d", "model": "bert-large",
          "nvidia_smi": smi, "sequences": len(seqs), "tokens": ntok,
          "longest": max(len(s) for s in seqs), "round_trip": trip,
          **lines, "int8_vs_bf16_min_cosine": cos,
          "k5a_held_at_path_shapes_max_abs_err": held})
    del loaded
    torch.cuda.empty_cache()


def _v1_moe(smi, total) -> None:
    """(e): Mixtral's width at V1_MIXTRAL's depth through init_inference,
    bf16 (the prefill's dropless grouped FFN, the capacity layer at
    decode) and int8 (the capacity layer's batched quantized matmul)."""
    import torch
    from deepspeed_tpu_torch import init_inference
    from deepspeed_tpu_torch.models.mixtral import mixtral_config
    cfg = mixtral_config(V1_MIXTRAL[0], **V1_MIXTRAL[1])
    rng = np.random.default_rng(67)
    prompts = rng.integers(0, cfg.vocab_size, size=(
        V1_MOE_BATCH, V1_MOE_PROMPT)).astype(np.int32)
    for mode in (None, "int8"):
        before = _v1_mem_start()
        eng = init_inference(
            cfg, {"dtype": "bfloat16", "weight_quant": mode},
            generator=torch.Generator(device=DEV).manual_seed(68),
            device=DEV)
        _, res, launches = _v1_generate(eng, prompts, V1_MOE_NEW)
        line = {}
        if mode is None:
            # two prefills of 2048 tokens: the dropless grouped FFN a
            # layer each; decode (8 tokens) the capacity einsums
            assert {k for k, v in launches.items() if v} == \
                set(GROUPED_KERNELS), launches
            assert all(launches[k] == 2 * cfg.num_layers
                       for k in GROUPED_KERNELS), launches
            line["grouped_launches_by_form"] = _grouped_forms(launches)
        else:
            need = {"quantized_matmul", "quantized_matmul_batched"}
            assert {k for k, v in launches.items() if v} == need, launches
            line["k5_launches"] = _v1_quant_forms(launches, need)
        _v1_add(total, launches)
        emit({"phase": "v1_inference", "part": "e", "model":
              f"mixtral-8x7b-{cfg.num_layers}L", "weight_quant": mode,
              "nvidia_smi": smi, "reduced": {"num_layers": [32,
                                                            cfg.num_layers]},
              "batch": V1_MOE_BATCH, "prompt": V1_MOE_PROMPT,
              "new": V1_MOE_NEW, **res, "launches": launches, **line,
              "allocated_before_gb": before,
              "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9})
        ref = weakref.ref(eng)
        del eng
        _v1_freed(ref)


def _v1_cli(smi, root, total) -> None:
    """(f): the quantizer CLI (``main``, as ``python -m`` runs it) on an
    exported Llama-3-width model of depth 2; its npz served by
    InferenceEngine gives the tokens of ``weight_quant`` applied at
    start-up to the float tree."""
    import torch
    from deepspeed_tpu_torch import (InferenceEngine, export_hf_checkpoint,
                                     llama3_config)
    from deepspeed_tpu_torch.cli import dstpu_quantize
    from deepspeed_tpu_torch.models.transformer import init_params
    from deepspeed_tpu_torch.ops import op_builder
    cfg = llama3_config(V1_CLI[0], **V1_CLI[1])
    gen = torch.Generator(device=DEV).manual_seed(69)
    params = _cast_tree(init_params(cfg, gen, torch.bfloat16, DEV),
                        torch.bfloat16)
    d = os.path.join(root, "llama3-8b-width-d2")
    npz = os.path.join(root, "llama3-8b-width-d2.npz")
    t0 = time.perf_counter()
    export_hf_checkpoint(cfg, params, d)
    export_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    assert dstpu_quantize.main(["--model-dir", d, "--mode", V1_CLI_MODE,
                                "--out", npz, "--device", DEV]) == 0
    cli_s = time.perf_counter() - t0
    npz_bytes = os.path.getsize(npz)
    t0 = time.perf_counter()
    qcfg, qp = dstpu_quantize.load_quantized_npz(npz, device=DEV)
    load_s = time.perf_counter() - t0
    for f in ("hidden_size", "num_layers", "num_heads", "kv_heads",
              "ffn_size", "vocab_size", "tie_embeddings", "rope_theta"):
        assert getattr(qcfg, f) == getattr(cfg, f), f
    prompts = np.random.default_rng(70).integers(
        0, cfg.vocab_size, size=(4, 64)).astype(np.int32)
    want = InferenceEngine(qcfg, {"dtype": "bfloat16",
                                 "weight_quant": V1_CLI_MODE},
                           params=params, device=DEV).generate(
        prompts, max_new_tokens=16)
    del params
    _v1_reset()
    got = InferenceEngine(qcfg, {"dtype": "bfloat16"}, params=qp,
                          device=DEV).generate(prompts, max_new_tokens=16)
    launches = dict(op_builder.launches)
    kernel = _quant_kernel(V1_CLI_MODE)
    assert {k for k, v in launches.items() if v} == {kernel}, launches
    _v1_quant_forms(launches, (kernel,))
    _v1_add(total, launches)
    assert (got == want).all(), "npz tokens differ from start-up quantization"
    emit({"phase": "v1_inference", "part": "f", "model": "llama3-8b-width",
          "layers": cfg.num_layers, "mode": V1_CLI_MODE, "nvidia_smi": smi,
          "export_seconds": export_s, "cli_seconds": cli_s,
          "npz_bytes": npz_bytes, "npz_load_seconds": load_s,
          "tokens_equal_startup_quant": True, "launches": launches})
    del qp
    torch.cuda.empty_cache()


def _v1_fp32(smi) -> None:
    """(g): fp32 at depth 2, TF32 off, one seeded tree on the card and on
    the CPU: Llama-3 8B's and BLOOM-7b1's width through InferenceEngine
    (prefill logits within V1_FP32's tol relative, greedy tokens
    identical), BERT-large's through EncoderInference (hidden states and
    logits within the tol)."""
    import torch
    import deepspeed_tpu_torch as dt
    from deepspeed_tpu_torch.models.transformer import (init_kv_cache,
                                                        init_params)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    f = V1_FP32
    res = {}
    for name, preset, size in (("llama3-8b", "llama3_config", "8b"),
                               ("bloom-7b1", "bloom_config", "7b1"),
                               ("bert-large", "bert_config", "large")):
        cfg = getattr(dt, preset)(size, num_layers=f["layers"])
        gen = torch.Generator(device=DEV).manual_seed(71)
        params = init_params(cfg, gen, torch.float32, DEV)
        _jitter(params, gen)
        trees = {"card": params, "cpu": _to_cpu(params)}
        rng = np.random.default_rng(72)
        got = {}
        if cfg.causal:
            prompts = rng.integers(0, cfg.vocab_size, size=(
                f["batch"], f["prompt"])).astype(np.int32)
            for where, tree in trees.items():
                dev = DEV if where == "card" else "cpu"
                eng = dt.InferenceEngine(cfg, {"dtype": "float32"},
                                         params=tree, device=dev)
                cache = init_kv_cache(cfg, f["batch"], f["prompt"],
                                      torch.float32, dev)
                with torch.no_grad():
                    lg, _ = eng._step(torch.from_numpy(prompts).to(dev),
                                      cache, 0)
                got[where] = (lg.cpu(), eng.generate(
                    prompts, max_new_tokens=f["new"]))
                del eng, cache
            err = _v1_rel(got["card"][0], got["cpu"][0])
            same = (got["card"][1] == got["cpu"][1]).all()
            assert same, f"{name}: card and CPU greedy tokens differ"
            res[name] = {"logits_rel_err": err, "tokens_identical": True}
        else:
            seqs = [rng.integers(1, cfg.vocab_size, size=n).tolist()
                    for n in (64, 100, 128)]
            for where, tree in trees.items():
                eng = dt.EncoderInference(
                    cfg, {"dtype": "float32"}, params=tree,
                    device=DEV if where == "card" else "cpu")
                got[where] = (eng(seqs, output="hidden"), eng(seqs))
                del eng
            err = max(_v1_rel(torch.from_numpy(a), torch.from_numpy(b))
                      for i in range(2) for a, b in zip(got["card"][i],
                                                        got["cpu"][i]))
            res[name] = {"hidden_and_logits_rel_err": err}
        assert err <= f["tol"], (name, err)
        del params, trees
        torch.cuda.empty_cache()
    emit({"phase": "v1_inference", "part": "g", "nvidia_smi": smi,
          "layers": f["layers"], "tol": f["tol"], **res})


def phase_v1_inference(smi: str) -> dict:
    """Phase 11: the v1 engine and the quantization tool (see the module
    docstring's item 11). Each part's launches are counted from 0 around
    its own serving calls; returns their sum, the path's. Exports under
    a directory of ``build/`` removed when the phase ends."""
    import shutil
    import tempfile
    from deepspeed_tpu_torch.ops import op_builder
    here = os.path.dirname(os.path.abspath(__file__))
    os.makedirs(os.path.join(here, "build"), exist_ok=True)
    root = tempfile.mkdtemp(prefix="v1_", dir=os.path.join(here, "build"))
    total = {k: 0 for k in op_builder.launches}
    seconds = {}
    try:
        for part, fn, args in (("a_b", _v1_llama, (smi, total)),
                               ("c", _v1_bloom, (smi, root, total)),
                               ("d", _v1_bert, (smi, root, total)),
                               ("e", _v1_moe, (smi, total)),
                               ("f", _v1_cli, (smi, root, total)),
                               ("g", _v1_fp32, (smi,))):
            t0 = time.perf_counter()
            fn(*args)
            seconds[part] = time.perf_counter() - t0
    finally:
        shutil.rmtree(root, ignore_errors=True)
    for k in GROUPED_KERNELS + ("quantized_matmul", "quantized_matmul_packed",
                                "quantized_matmul_batched"):
        assert total[k] > 0, (k, total)
    emit({"phase": "v1_inference", "part": "total", "nvidia_smi": smi,
          "seconds": seconds, "launches": total})
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


#: phase 6's models, each at depth 2 and T 256 in fp32: Llama-3 1B's width
#: (tied head), then the head dims of the model families, Gemma-2B's
#: (MQA 8/1, dh 256, GeGLU) and Phi-2's (32/32, dh 80, partial rotary,
#: parallel block, biased linears), each with a 32,000-entry vocabulary
#: and an FFN of 2048: only the attention's head dim matters there
TRAIN_FULL_WIDTH = (("llama3-1b-width-depth2", "llama3_config", "1b",
                     {"tie_embeddings": True}),
                    ("gemma-2b-width-depth2", "gemma_config", "2b",
                     {"vocab_size": 32000, "intermediate_size": 2048}),
                    ("phi-2-width-depth2", "phi_config", "2",
                     {"vocab_size": 32000, "intermediate_size": 2048}))


def phase_train_full_width():
    """Two train_batch steps of a depth-2 model at Llama-3-1B width (tied
    head), fp32: on the card (K1 + K3) and on the CPU (plain versions)
    from one seeded parameter tree and the same batches. AdamW, clip 1.0,
    gas 2, micro batch 1, T 256. Then the same at the widths and head
    dims of Gemma-2B (K1/K3 at dh 256) and Phi-2 (dh 80)
    (``TRAIN_FULL_WIDTH``).

    Tolerances: losses 1e-4 relative, parameters 1e-4 absolute. Both sides
    are fp32 (TF32 off) and differ by summation order. The lr is 1e-5:
    Adam's update is ~lr × sign(m) wherever a gradient sits at rounding
    level, so two correct runs may differ by up to 2 lr per step there;
    at 1e-5 that stays inside the limit, while a wrong gradient moves the
    loss and the updates far beyond it."""
    import torch
    import deepspeed_tpu_torch as dt
    from deepspeed_tpu_torch.models.transformer import init_params
    from deepspeed_tpu_torch.ops import flash_attention as fa
    from deepspeed_tpu_torch.ops import op_builder
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    conf = {"train_micro_batch_size_per_gpu": 1,
            "gradient_accumulation_steps": 2,
            "optimizer": {"type": "adamw",
                          "params": {"lr": 1e-5, "weight_decay": 0.1}},
            "gradient_clipping": 1.0, "attention_impl": "auto"}
    for seed, (label, preset, size, kw) in enumerate(TRAIN_FULL_WIDTH):
        cfg = getattr(dt, preset)(size, num_layers=2, max_seq_len=256, **kw)
        init = init_params(cfg, torch.Generator(device=DEV).manual_seed(
            6 + seed), torch.float32, DEV)
        init_cpu = _to_cpu(init)
        rng = np.random.default_rng(6 + seed)
        data = [{"input_ids": rng.integers(0, cfg.vocab_size, size=(1, 256))
                 .astype(np.int32)} for _ in range(4)]
        runs = {}
        for where in ("card", "cpu"):
            dev = DEV if where == "card" else "cpu"
            eng, _, _, _ = dt.initialize(cfg, dict(conf), params=(
                init if where == "card" else init_cpu), device=dev)
            op_builder.reset_launches()
            fa.reset_head_dim_launches()
            t0 = time.perf_counter()
            losses = [float(eng.train_batch(iter(data[2 * s:2 * s + 2])))
                      for s in range(2)]
            runs[where] = {"losses": losses, "params": _to_cpu(eng.params),
                           "seconds": time.perf_counter() - t0,
                           "launches": dict(op_builder.launches),
                           "by_head_dim": {k: dict(v) for k, v in
                                           fa.head_dim_launches.items()},
                           "grad_norm": eng.get_global_grad_norm()}
            del eng
        del init
        torch.cuda.empty_cache()
        card, cpu = runs["card"], runs["cpu"]
        want = 2 * 2 * cfg.num_layers
        assert all(card["launches"][k] == want
                   for k in TRAIN_KERNELS), card["launches"]
        assert all(card["by_head_dim"][k][cfg.head_dim] == want
                   for k in TRAIN_KERNELS), card["by_head_dim"]
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
        res = {"phase": "train_full_width", "model": label,
               "head_dim": cfg.head_dim, "dtype": "float32",
               "losses_card": card["losses"], "losses_cpu": cpu["losses"],
               "loss_rel_err": loss_rel, "param_max_abs_err": param_err,
               "param_max_update": moved,
               "grad_norm_card": card["grad_norm"],
               "grad_norm_cpu": cpu["grad_norm"], "tol": 1e-4,
               "seconds_card": card["seconds"],
               "seconds_cpu": cpu["seconds"], "launches": card["launches"]}
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


#: phase 7's model families: Gemma-2B under save_attn_kernel (K1 once a
#: layer and micro-step, its residuals kept) and Phi-2 under full (K1 twice),
#: at full width and depth in bf16, micro batch 2 x 2048, gas 1, AdamW;
#: 2 warm-up and 5 timed steps on one fixed batch
FAMILY_TRAIN = (("gemma-2b", "gemma_config", "2b", "save_attn_kernel", 1),
                ("phi-2", "phi_config", "2", "full", 2))
FAMILY_MICRO, FAMILY_SEQ, FAMILY_WARMUP, FAMILY_STEPS = 2, 2048, 2, 5
#: the remat sweep on the Llama-3 1B engine: micro batch 4 x 2048, gas 1,
#: 1 warm-up and 3 timed steps a policy; ffn_chunk 512 runs under 'none'
POLICY_SWEEP = (("none", {"policy": "none"}), ("full", {"policy": "full"}),
                ("save_attn_kernel", {"policy": "save_attn_kernel"}),
                ("offload_full", {"policy": "offload_full"}),
                ("ffn_chunk_512", {"policy": "none", "ffn_chunk": 512}))
POLICY_MICRO, POLICY_WARMUP, POLICY_STEPS = 4, 1, 3


def _timed_steps(eng, batch, warmup, steps):
    """(losses, seconds a step) of warmup + steps train_batch calls."""
    losses, step_s = [], []
    for _ in range(warmup + steps):
        t1 = time.perf_counter()
        losses.append(float(eng.train_batch(iter(batch))))
        step_s.append(time.perf_counter() - t1)
    return losses, step_s


def phase_train_families() -> dict:
    """Gemma-2B and Phi-2 (FAMILY_TRAIN) trained through
    ``initialize``/``train_batch`` at full width and depth in bf16, random
    weights from a seeded generator: ms a step, tokens/s, peak memory,
    losses, and K1's and K3's launches by head dim, read around the timed
    run. Every loss is finite; K3 runs once a layer and micro-step at the
    model's head dim (256, 80), K1 as often as its policy says. Returns
    the launches and the head-dim launches over the runs."""
    import torch
    import deepspeed_tpu_torch as dt
    from deepspeed_tpu_torch.ops import flash_attention as fa
    from deepspeed_tpu_torch.ops import op_builder
    total = {k: 0 for k in op_builder.launches}
    by_dim = {k: {d: 0 for d in fa.HEAD_DIMS} for k in TRAIN_KERNELS}
    for label, preset, size, policy, k1_per in FAMILY_TRAIN:
        cfg = getattr(dt, preset)(size, max_seq_len=FAMILY_SEQ)
        conf = {"train_micro_batch_size_per_gpu": FAMILY_MICRO,
                "gradient_accumulation_steps": 1,
                "optimizer": {"type": "adamw",
                              "params": {"lr": 1e-4, "weight_decay": 0.1}},
                "gradient_clipping": 1.0, "bf16": {"enabled": True},
                "activation_checkpointing": {"policy": policy},
                "attention_impl": "auto", "steps_per_print": 1000}
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        eng, *_ = dt.initialize(cfg, conf, generator=torch.Generator(
            device=DEV).manual_seed(17), device=DEV)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        state_gb = torch.cuda.memory_allocated() / 1e9
        rng = np.random.default_rng(17)
        batch = [{"input_ids": rng.integers(0, cfg.vocab_size, size=(
            FAMILY_MICRO, FAMILY_SEQ)).astype(np.int32)}]
        op_builder.reset_launches()
        fa.reset_head_dim_launches()
        losses, step_s = _timed_steps(eng, batch, FAMILY_WARMUP,
                                      FAMILY_STEPS)
        launches = dict(op_builder.launches)
        dims = {k: dict(fa.head_dim_launches[k]) for k in TRAIN_KERNELS}
        timed = step_s[FAMILY_WARMUP:]
        ms = 1e3 * sum(timed) / len(timed)
        tokens = FAMILY_MICRO * FAMILY_SEQ
        res = {"phase": "train_families", "model": label,
               "dtype": "bfloat16", "remat": policy,
               "params": cfg.num_params(), "head_dim": cfg.head_dim,
               "heads": [cfg.num_heads, cfg.kv_heads],
               "micro_batch": FAMILY_MICRO, "gas": 1, "seq": FAMILY_SEQ,
               "init_seconds": init_s, "state_gb": state_gb,
               "losses": losses, "step_seconds": step_s, "ms_per_step": ms,
               "ms_per_step_min": 1e3 * min(timed),
               "ms_per_step_max": 1e3 * max(timed),
               "tokens_per_s": tokens / (ms / 1e3),
               "model_tflops_per_s": 6.0 * cfg.num_params() * tokens
               / (ms / 1e3) / 1e12,
               "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
               "launches": launches, "launches_by_head_dim": dims}
        emit(res)
        steps = FAMILY_WARMUP + FAMILY_STEPS
        assert all(np.isfinite(losses)), losses
        assert dims["flash_attention_bwd"][cfg.head_dim] == \
            launches["flash_attention_bwd"] == cfg.num_layers * steps, dims
        assert dims["flash_attention_fwd"][cfg.head_dim] == \
            launches["flash_attention_fwd"] == \
            k1_per * cfg.num_layers * steps, dims
        for k in total:
            total[k] += launches[k]
        for k in TRAIN_KERNELS:
            for d in by_dim[k]:
                by_dim[k][d] += dims[k][d]
        del eng
        torch.cuda.empty_cache()
    return {"launches": total, "by_head_dim": by_dim}


def _fingerprints(leaves) -> list:
    """Per leaf, the sum and a position-weighted sum of its raw 16-bit
    words as exact int64 (wrapping): a changed bit changes them."""
    import torch
    out = []
    for x in leaves:
        w = x.detach().reshape(-1).view(torch.int16).to(torch.int64)
        pos = torch.arange(w.numel(), device=w.device, dtype=torch.int64)
        out.append((int(w.sum()), int((w * (pos % 65521 + 1)).sum())))
    return out


def _state_tensors(eng) -> list:
    from deepspeed_tpu_torch.ops.optimizers import tree_leaves
    return [x for x in tree_leaves(eng.params) + tree_leaves(eng.opt_state)
            if hasattr(x, "nbytes")]


def phase_offload_states(eng) -> dict:
    """``offload_states``/``reload_states`` on the 1B bf16 engine after a
    step: the device memory the engine holds falls by at least 90 % of its
    state's bytes, the copies' GB/s each way (pinned host buffers), and
    every leaf comes back in its dtype with the same raw words (their
    exact sums); a step after the reload trains on."""
    import torch
    state = _state_tensors(eng)
    nbytes = sum(x.nbytes for x in state)
    before_fp = _fingerprints(state)
    dtypes = [(x.dtype, tuple(x.shape)) for x in state]
    del state
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    eng.offload_states()
    off_s = time.perf_counter() - t0
    freed = held - torch.cuda.memory_allocated()
    assert eng.params is None and eng.opt_state is None
    t0 = time.perf_counter()
    eng.reload_states()
    on_s = time.perf_counter() - t0
    state = _state_tensors(eng)
    same = _fingerprints(state) == before_fp and \
        [(x.dtype, tuple(x.shape)) for x in state] == dtypes and \
        all(x.device == eng.device for x in state)
    res = {"phase": "offload_states", "model": "llama3-" + TRAIN_MODEL[0],
           "state_bytes": nbytes, "freed_bytes": freed,
           "freed_share": freed / nbytes, "offload_seconds": off_s,
           "reload_seconds": on_s, "offload_gb_per_s": nbytes / off_s / 1e9,
           "reload_gb_per_s": nbytes / on_s / 1e9,
           "leaves": len(state), "leaves_same_words": same}
    emit(res)
    assert freed >= 0.9 * nbytes, res
    assert same, res
    return res


def phase_train_policies(smi: str) -> dict:
    """The remat sweep (POLICY_SWEEP) on the Llama-3 1B engine in bf16,
    each policy a fresh engine from the same seeded weights: peak memory
    of a step and of a forward and backward alone (one more micro-step
    through ``forward``/``backward``/``step``), ms a step and K1's and
    K3's launches a step. K1 runs half as often under save_attn_kernel as
    under full; offload_full's forward and backward peak below full's (a
    step's peak is the optimizer update's, the same under every policy);
    every policy's first loss is the same forward. Then
    ``offload_states``/``reload_states`` on the last engine (phase
    ``offload_states``). Returns the launches over the sweep."""
    import torch
    from deepspeed_tpu_torch import initialize, llama3_config
    from deepspeed_tpu_torch.ops import op_builder
    cfg = llama3_config(TRAIN_MODEL[0], **TRAIN_MODEL[1])
    rng = np.random.default_rng(8)
    batch = [{"input_ids": rng.integers(0, cfg.vocab_size, size=(
        POLICY_MICRO, TRAIN_SEQ)).astype(np.int32)}]
    total = {k: 0 for k in op_builder.launches}
    out = {}
    eng = None
    for label, block in POLICY_SWEEP:
        del eng
        torch.cuda.empty_cache()
        conf = {"train_micro_batch_size_per_gpu": POLICY_MICRO,
                "gradient_accumulation_steps": 1,
                "optimizer": {"type": "adamw",
                              "params": {"lr": 1e-4, "weight_decay": 0.1}},
                "gradient_clipping": 1.0, "bf16": {"enabled": True},
                "activation_checkpointing": block,
                "attention_impl": "auto", "steps_per_print": 1000}
        eng, *_ = initialize(cfg, conf, generator=torch.Generator(
            device=DEV).manual_seed(0), device=DEV)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        op_builder.reset_launches()
        losses, step_s = _timed_steps(eng, batch, POLICY_WARMUP,
                                      POLICY_STEPS)
        launches = dict(op_builder.launches)
        steps = POLICY_WARMUP + POLICY_STEPS
        timed = step_s[POLICY_WARMUP:]
        peak = torch.cuda.max_memory_allocated() / 1e9
        # the forward and backward's own peak, before the update: the
        # step's peak is the optimizer's, over the fp32 master, moments
        # and gradients, whatever the policy
        torch.cuda.reset_peak_memory_stats()
        loss = eng.forward(batch[0])
        torch.cuda.synchronize()
        fwd_bwd_peak = torch.cuda.max_memory_allocated() / 1e9
        eng.backward(loss)
        eng.step()
        out[label] = {"ms_per_step": 1e3 * sum(timed) / len(timed),
                      "peak_mem_gb": peak, "fwd_bwd_peak_gb": fwd_bwd_peak,
                      "k1_per_step": launches["flash_attention_fwd"] / steps,
                      "k3_per_step": launches["flash_attention_bwd"] / steps,
                      "losses": losses}
        for k in total:
            total[k] += launches[k]
    emit({"phase": "train_policies", "model": "llama3-" + TRAIN_MODEL[0],
          "dtype": "bfloat16", "micro_batch": POLICY_MICRO, "gas": 1,
          "seq": TRAIN_SEQ, "nvidia_smi": smi, "policies": out})
    layers = cfg.num_layers
    assert out["save_attn_kernel"]["k1_per_step"] == layers, out
    assert out["full"]["k1_per_step"] == 2 * layers, out
    assert all(v["k3_per_step"] == layers for v in out.values()), out
    assert out["offload_full"]["fwd_bwd_peak_gb"] < \
        out["full"]["fwd_bwd_peak_gb"], out
    first = out["none"]["losses"][0]
    assert all(np.isfinite(v["losses"]).all() and
               abs(v["losses"][0] - first) <= 1e-3 * abs(first)
               for v in out.values()), out
    phase_offload_states(eng)
    eng.train_batch(iter(batch))
    del eng
    torch.cuda.empty_cache()
    return total


# ---------------------------------------------------------------------------
# phase 9: checkpoint and resume — save, load, preempt, resume
# ---------------------------------------------------------------------------

#: phase_train_full_width's model and config (depth 2 at Llama-3 1B width,
#: tied head, fp32, gas 2, T 256) for checkpoint checks (a) and (c), with a
#: 32,000-entry vocabulary and an FFN of 2048: no check of (a) or (c) needs
#: Llama-3's 128,256 entries (68 % of the parameters the CPU side of (a)
#: steps, saves and loads for each optimizer) or the 8192-wide FFN (whose
#: matrices hold most of the CPU's bf16 Newton-Schulz work for Muon)
CKPT_VOCAB, CKPT_FFN = 32000, 2048
CKPT_CONF = {"train_micro_batch_size_per_gpu": 1,
             "gradient_accumulation_steps": 2,
             "gradient_clipping": 1.0, "attention_impl": "auto"}
#: (a)'s optimizers and their params. The adaptive ones take lr 1e-5 (see
#: phase_train_full_width: an update of ~lr x sign wherever a gradient sits
#: at rounding level keeps two correct runs within 2 lr per step); SGD's
#: update is lr x momentum buffer, which rounding barely moves
CKPT_OPTIMIZERS = (
    ("adamw", {"lr": 1e-5, "weight_decay": 0.1}),
    ("lamb", {"lr": 1e-5, "weight_decay": 0.01}),
    ("lion", {"lr": 1e-5, "weight_decay": 0.1}),
    ("adagrad", {"lr": 1e-5}),
    ("sgd", {"lr": 1e-2, "momentum": 0.9}),
    ("muon", {"lr": 1e-5, "weight_decay": 0.01}))
#: card against CPU after the 2 steps that follow a load: losses relative,
#: parameters absolute (phase_train_full_width's tolerances for every
#: optimizer); Muon's orthogonalized matrices are also held by their
#: update, within CKPT_MUON_UPDATE of its largest element: Newton-Schulz
#: runs in bf16 on both sides, and cuBLAS and the CPU's bf16 GEMMs sum in
#: other orders (a few bf16 ulps of the largest element, ~3 % in a CPU
#: comparison of two summation orders at 2048-wide matrices)
CKPT_TOL = 1e-4
CKPT_MUON_UPDATE = 0.1
#: (b): the bf16 1B resume against the uninterrupted run. Bitwise when
#: every kernel and GEMM of a step is deterministic (printed); the limit
#: allows a one-ulp bf16 flip of some weights from a reordered sum
CKPT_RESUME_LOSS_TOL = 5e-3


def _state_leaves(eng) -> dict:
    """group/key -> leaf of the engine's checkpointed state."""
    from deepspeed_tpu_torch.checkpoint.store import _leaf_paths
    return {f"{g}/{k}": v for g, tree in (
        ("params", eng.params), ("opt_state", eng.opt_state),
        ("loss_scale", eng.loss_scale_state))
        for k, v in _leaf_paths(tree).items()}


def _host_bits(x):
    """A host copy of a leaf as integer bits (bitwise comparison)."""
    import torch
    if not isinstance(x, torch.Tensor):
        return x
    t = x.detach().to("cpu", copy=True).contiguous()
    return t.view({1: torch.uint8, 2: torch.int16, 4: torch.int32,
                   8: torch.int64}[t.element_size()])


def _bitwise_mismatches(want: dict, eng) -> list:
    """Keys whose leaf in ``eng`` differs from ``want`` (host bits) in
    dtype, shape or any bit."""
    import torch
    got = _state_leaves(eng)
    bad = sorted(set(want) ^ set(got))
    for key, w in want.items():
        g = got.get(key)
        if g is None:
            continue
        if isinstance(w, torch.Tensor):
            if g.dtype.itemsize != w.element_size() or \
                    tuple(g.shape) != tuple(w.shape) or \
                    not torch.equal(_host_bits(g), w):
                bad.append(key)
        elif g != w:
            bad.append(key)
    return bad


def _ckpt_train(eng, batches, counts=None) -> list:
    """One train_batch per pair of micro-batches; K1/K3 launches of the
    steps alone are added to ``counts``."""
    from deepspeed_tpu_torch.ops import op_builder
    losses = []
    for mbs in batches:
        op_builder.reset_launches()
        losses.append(float(eng.train_batch(iter(mbs))))
        if counts is not None:
            for k in TRAIN_KERNELS:
                counts[k] = counts.get(k, 0) + op_builder.launches[k]
    return losses


def _disk(path: str) -> dict:
    import shutil
    u = shutil.disk_usage(path)
    return {"total_gb": u.total / 1e9, "used_gb": u.used / 1e9,
            "free_gb": u.free / 1e9}


def _dir_bytes(path: str) -> int:
    return sum(os.path.getsize(os.path.join(d, f))
               for d, _, files in os.walk(path) for f in files)


def _ckpt_optimizers(root, cfg, init, init_cpu, data) -> None:
    """(a): for each optimizer, 2 steps on the card, save; load into a
    fresh card engine and a CPU engine (every leaf bitwise the saved
    one); 2 more steps on each, card against CPU."""
    import shutil
    import torch
    from deepspeed_tpu_torch import initialize
    steps = [data[2 * s:2 * s + 2] for s in range(4)]
    for name, params in CKPT_OPTIMIZERS:
        conf = dict(CKPT_CONF, optimizer={"type": name, "params": params})
        counts = {}
        eng, _, _, _ = initialize(cfg, dict(conf), params=init, device=DEV)
        first = _ckpt_train(eng, steps[:2], counts)
        t0 = time.perf_counter()
        eng.save_checkpoint(root, tag=name)
        save_s = time.perf_counter() - t0
        nbytes = _dir_bytes(os.path.join(root, name))
        saved = {k: _host_bits(v) for k, v in _state_leaves(eng).items()}
        del eng
        torch.cuda.empty_cache()
        runs = {}
        for where in ("card", "cpu"):
            dev = DEV if where == "card" else "cpu"
            t_side = time.perf_counter()
            eng, _, _, _ = initialize(cfg, dict(conf), params=(
                init if where == "card" else init_cpu), device=dev)
            t0 = time.perf_counter()
            tag, _ = eng.load_checkpoint(root)
            load_s = time.perf_counter() - t0
            assert tag == name and eng.global_steps == 2, (tag, name)
            bad = _bitwise_mismatches(saved, eng)
            before = {k: v.detach().to("cpu", copy=True) for k, v in
                      _state_leaves(eng).items() if k.startswith("params/")}
            losses = _ckpt_train(eng, steps[2:],
                                 counts if where == "card" else None)
            runs[where] = {"losses": losses, "params": _to_cpu(eng.params),
                           "seconds": time.perf_counter() - t_side,
                           "before": before, "load_s": load_s,
                           "mismatches": bad,
                           "momentum": eng.opt_state.get("momentum")
                           if name == "muon" else None}
            del eng
            torch.cuda.empty_cache()
        shutil.rmtree(os.path.join(root, name))
        card, cpu = runs["card"], runs["cpu"]
        from deepspeed_tpu_torch.checkpoint.store import _leaf_paths
        pc, pp = (_leaf_paths(r) for r in (card["params"], cpu["params"]))
        p0 = {k[len("params/"):]: v for k, v in card["before"].items()}
        loss_rel = max(abs(a - b) / abs(b)
                       for a, b in zip(card["losses"], cpu["losses"]))
        param_err = max(_err(pc[k], pp[k]) for k in pc)
        moved = max(_err(pc[k], p0[k]) for k in pc)
        res = {"phase": "checkpoint_optimizer", "optimizer": name,
               "model": "llama3-1b-width-depth2-vocab32k-ffn2048",
               "dtype": "float32", "params": params, "losses_before_save": first,
               "losses_card": card["losses"], "losses_cpu": cpu["losses"],
               "loss_rel_err": loss_rel, "param_max_abs_err": param_err,
               "param_max_update": moved, "tol": CKPT_TOL,
               "leaves": len(saved),
               "bitwise_mismatches_card": card["mismatches"],
               "bitwise_mismatches_cpu": cpu["mismatches"],
               "ckpt_bytes": nbytes, "save_seconds": save_s,
               "load_seconds_card": card["load_s"],
               "load_seconds_cpu": cpu["load_s"],
               "seconds_card": card["seconds"],
               "seconds_cpu": cpu["seconds"], "launches": counts}
        if name == "muon":
            # the orthogonalized leaves: momentum is no 0-d placeholder
            mom = _leaf_paths(_to_cpu(runs["cpu"]["momentum"]))
            keys = [k for k, m in mom.items() if m.ndim >= 2]
            upd = max(_err(pc[k] - p0[k], pp[k] - p0[k]) /
                      float((pp[k] - p0[k]).abs().max()) for k in keys)
            res.update(muon_leaves=keys, muon_update_rel_err=upd,
                       muon_update_tol=CKPT_MUON_UPDATE)
            assert upd <= CKPT_MUON_UPDATE, res
        emit(res)
        assert not card["mismatches"] and not cpu["mismatches"], res
        assert all(np.isfinite(card["losses"] + cpu["losses"])), res
        assert loss_rel <= CKPT_TOL and param_err <= CKPT_TOL, res
        want = 4 * 2 * cfg.num_layers
        assert all(counts[k] == want for k in TRAIN_KERNELS), counts


def _ckpt_preempt(root, cfg, init) -> None:
    """(c): ``step:3:preempt`` in the depth-2 engine under DSElasticAgent:
    Preempted with tag preempt_step4 and a black box; a fresh engine
    resumes through agent.resume() (the dataloader cursor included) and
    its next 2 steps match the uninterrupted run's."""
    import torch
    from deepspeed_tpu_torch import initialize
    from deepspeed_tpu_torch.elasticity import DSElasticAgent, Preempted
    from deepspeed_tpu_torch.resilience.faults import fault_injector
    rng = np.random.default_rng(9)
    dataset = [{"input_ids": rng.integers(0, cfg.vocab_size, size=256)
                .astype(np.int32)} for _ in range(16)]
    conf = dict(CKPT_CONF, optimizer={"type": "adamw",
                                      "params": {"lr": 1e-5,
                                                 "weight_decay": 0.1}})
    counts = {}

    def steps(eng, n):
        from deepspeed_tpu_torch.ops import op_builder
        out = []
        for _ in range(n):
            op_builder.reset_launches()
            out.append(float(eng.train_batch()))
            for k in TRAIN_KERNELS:
                counts[k] = counts.get(k, 0) + op_builder.launches[k]
        return out

    ref, _, _, _ = initialize(cfg, dict(conf), params=init,
                              training_data=dataset, device=DEV)
    want = steps(ref, 6)
    want_params = _to_cpu(ref.params)
    del ref
    eng, _, _, _ = initialize(cfg, dict(conf, resilience={
        "fault_plan": "step:3:preempt"}), params=init,
        training_data=dataset, device=DEV)
    agent = DSElasticAgent(eng, root)
    agent.install()
    got, tag, box = [], None, None
    t0 = time.perf_counter()
    try:
        for _ in range(6):
            got += steps(eng, 1)
            agent.step_boundary()
    except Preempted as e:
        tag, box = e.tag, e.blackbox_path
    finally:
        agent.uninstall()
        fault_injector.disarm()
    preempt_s = time.perf_counter() - t0
    del eng
    torch.cuda.empty_cache()
    eng, _, _, _ = initialize(cfg, dict(conf), params=init,
                              training_data=dataset, device=DEV)
    agent = DSElasticAgent(eng, root)
    t0 = time.perf_counter()
    resumed = agent.resume()
    resume_s = time.perf_counter() - t0
    step_after = eng.global_steps
    got += steps(eng, 2)
    from deepspeed_tpu_torch.checkpoint.store import _leaf_paths
    pg, pw = _leaf_paths(_to_cpu(eng.params)), _leaf_paths(want_params)
    del eng
    torch.cuda.empty_cache()
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(got, want))
    param_err = max(_err(pg[k], pw[k]) for k in pw)
    res = {"phase": "checkpoint_preempt",
           "model": "llama3-1b-width-depth2-vocab32k-ffn2048",
           "dtype": "float32", "fault_plan": "step:3:preempt",
           "preempted_tag": tag, "blackbox": box is not None and
           os.path.exists(box), "resumed_tag": resumed,
           "resumed_at_step": step_after, "losses": got,
           "losses_uninterrupted": want, "bitwise": got == want,
           "loss_rel_err": loss_rel, "param_max_abs_err": param_err,
           "tol": CKPT_TOL, "preempt_run_seconds": preempt_s,
           "resume_seconds": resume_s, "launches": counts}
    emit(res)
    assert tag == "preempt_step4" and res["blackbox"], res
    assert resumed == "preempt_step4" and step_after == 4, res
    assert len(got) == 6 and loss_rel <= CKPT_TOL and \
        param_err <= CKPT_TOL, res
    want_k = (6 + 4 + 2) * 2 * cfg.num_layers
    assert all(counts[k] == want_k for k in TRAIN_KERNELS), counts


def _ckpt_full_size(root, smi) -> dict:
    """(b): Llama-3 1B at full width and depth in bf16 (phase_train's
    engine): 2 steps, save_checkpoint(async_save=True) and a third step
    before wait_pending(); a fresh engine loads the tag and holds, bit for
    bit, the state at the save; its next 2 steps against the uninterrupted
    engine's. Returns the K1/K3 launches of this path's steps."""
    import torch
    from deepspeed_tpu_torch import initialize, llama3_config
    from deepspeed_tpu_torch.checkpoint import store
    from deepspeed_tpu_torch.ops import op_builder
    cfg = llama3_config(TRAIN_MODEL[0], **TRAIN_MODEL[1])
    conf = {"train_micro_batch_size_per_gpu": TRAIN_MICRO,
            "gradient_accumulation_steps": TRAIN_GAS,
            "optimizer": {"type": "adamw",
                          "params": {"lr": 1e-4, "weight_decay": 0.1}},
            "gradient_clipping": 1.0, "bf16": {"enabled": True},
            "activation_checkpointing": {"policy": "none"},
            "attention_impl": "auto", "steps_per_print": 1000}
    rng = np.random.default_rng(11)
    steps = [[{"input_ids": rng.integers(0, cfg.vocab_size,
                                         size=(TRAIN_MICRO, TRAIN_SEQ))
               .astype(np.int32)} for _ in range(TRAIN_GAS)]
             for _ in range(4)]
    torch.cuda.empty_cache()
    eng, _, _, _ = initialize(cfg, conf, generator=torch.Generator(
        device=DEV).manual_seed(0), device=DEV)
    # the main path: every count set to 0 just before, read just after
    counts = {}
    first = _ckpt_train(eng, steps[:2], counts)
    at_save = {k: _host_bits(v) for k, v in _state_leaves(eng).items()}
    state_bytes = sum(v.numel() * v.element_size()
                      for v in at_save.values() if isinstance(v, torch.Tensor))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.save_checkpoint(root, tag="full", async_save=True)
    snapshot_s = time.perf_counter() - t0
    during = _ckpt_train(eng, steps[2:3], counts)     # while files are written
    store.wait_pending()
    commit_s = time.perf_counter() - t0 - snapshot_s
    after = _ckpt_train(eng, steps[3:4], counts)
    ckpt_bytes = _dir_bytes(os.path.join(root, "full"))
    disk = _disk(root)
    del eng
    torch.cuda.empty_cache()
    eng, _, _, _ = initialize(cfg, conf, generator=torch.Generator(
        device=DEV).manual_seed(1), device=DEV)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tag, _ = eng.load_checkpoint(root)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    bad = _bitwise_mismatches(at_save, eng)
    n_leaves = len(at_save)
    del at_save
    resumed = _ckpt_train(eng, steps[2:4], counts)
    del eng
    torch.cuda.empty_cache()
    want = during + after
    rel = max(abs(a - b) / abs(b) for a, b in zip(resumed, want))
    res = {"phase": "checkpoint_full_size", "model": "llama3-" +
           TRAIN_MODEL[0], "dtype": "bfloat16", "params": cfg.num_params(),
           "nvidia_smi": smi, "micro_batch": TRAIN_MICRO, "gas": TRAIN_GAS,
           "seq": TRAIN_SEQ, "losses_before_save": first,
           "losses_uninterrupted": want, "losses_resumed": resumed,
           "bitwise": resumed == want, "loss_rel_err": rel,
           "tol": CKPT_RESUME_LOSS_TOL, "tag": tag,
           "leaves": n_leaves, "bitwise_mismatches": bad,
           "state_bytes": state_bytes,
           "ckpt_bytes_on_disk": ckpt_bytes, "snapshot_seconds": snapshot_s,
           "commit_seconds": commit_s,
           "commit_gb_per_s": ckpt_bytes / commit_s / 1e9,
           "load_seconds": load_s, "load_gb_per_s": ckpt_bytes / load_s / 1e9,
           "disk_usage": disk, "launches": counts}
    emit(res)
    assert tag == "full" and not bad, res
    assert all(np.isfinite(first + want + resumed)), res
    assert rel <= CKPT_RESUME_LOSS_TOL, res
    want_k = 6 * TRAIN_GAS * cfg.num_layers
    assert all(counts[k] == want_k for k in TRAIN_KERNELS), counts
    return {k: counts.get(k, 0) for k in op_builder.launches}


def phase_checkpoint(smi: str) -> dict:
    """Checkpoint and resume through the port's own entry points
    (``save_checkpoint``/``load_checkpoint``, ``DSElasticAgent``) on the
    card, in a fresh directory under ``build/`` that is removed when the
    phase ends: (a) each optimizer at depth 2 and Llama-3 1B width in
    fp32, card against CPU after a load; (b) Llama-3 1B at full size in
    bf16 with an async save that a step races; (c) preemption at step 3
    and resume. Returns (b)'s launches, the slice's main path."""
    import shutil
    import tempfile
    import torch
    from deepspeed_tpu_torch import llama3_config
    from deepspeed_tpu_torch.models.transformer import init_params
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    here = os.path.dirname(os.path.abspath(__file__))
    os.makedirs(os.path.join(here, "build"), exist_ok=True)
    root = tempfile.mkdtemp(prefix="ckpt_", dir=os.path.join(here, "build"))
    try:
        emit({"phase": "checkpoint_dir", "disk_usage": _disk(root)})
        cfg = llama3_config("1b", num_layers=2, max_seq_len=256,
                            tie_embeddings=True, vocab_size=CKPT_VOCAB,
                            intermediate_size=CKPT_FFN)
        init = init_params(cfg, torch.Generator(device=DEV).manual_seed(6),
                           torch.float32, DEV)
        init_cpu = _to_cpu(init)
        rng = np.random.default_rng(6)
        data = [{"input_ids": rng.integers(0, cfg.vocab_size, size=(1, 256))
                 .astype(np.int32)} for _ in range(8)]
        _ckpt_optimizers(os.path.join(root, "a"), cfg, init, init_cpu, data)
        _ckpt_preempt(os.path.join(root, "c"), cfg, init)
        del init, init_cpu
        torch.cuda.empty_cache()
        return _ckpt_full_size(os.path.join(root, "b"), smi)
    finally:
        shutil.rmtree(root)


# ---------------------------------------------------------------------------
# phase 10: ZeRO-Offload — host Adam, SuperOffload, the NVMe tier, the
# layer-streamed parameter tier
# ---------------------------------------------------------------------------

#: the main path: Llama-3 8B in bf16 under offload_optimizer 'cpu', stage
#: 2, AdamW, remat full, micro batch 1 x 2048, gas 1, clip 1.0; 2 warm-up
#: and 3 timed steps with overlap off, then on
OFFLOAD_MODEL = ("8b", {"max_seq_len": 2048})
OFFLOAD_SEQ, OFFLOAD_WARMUP, OFFLOAD_STEPS = 2048, 2, 3
#: host bytes a parameter of the 'cpu' tier holds: fp32 master and two
#: moments, the pinned bf16 landing and output buffers
OFFLOAD_HOST_BYTES = 16
#: the host memory a run may use (a container's limit can sit below the
#: MemTotal that /proc/meminfo reports), what the container holds beside
#: this process, and what (a) leaves to the process's transients and
#: checks; where memory a process frees returns to its own later
#: allocations but not to MemAvailable, room is counted from the
#: process's resident set
OFFLOAD_HOST_LIMIT = 96 * 2 ** 30
OFFLOAD_HOST_OTHER = 10e9
OFFLOAD_HOST_RESERVE = 12e9
#: the NVMe tier runs (a) only if its file traffic for all its steps would
#: take less than this at the rates (d) measured
OFFLOAD_NVME_BUDGET_S = 240.0
#: (b): depth 2 at Llama-3 1B width in fp32, phase 9 (a)'s vocabulary
#: and FFN; AdamW at lr 1e-5 (see phase_train_full_width), a clip of 0.05
#: that fires every step (SuperOffload rolls back), 2 steps of gas 2
OFFLOAD_SMALL = dict(num_layers=2, max_seq_len=256, tie_embeddings=True,
                     vocab_size=32000, intermediate_size=2048)
OFFLOAD_SMALL_RUNS = (
    ("offload", {"device": "cpu"}, None),
    ("offload_overlap", {"device": "cpu", "overlap": True}, None),
    ("superoffload", {"device": "cpu", "superoffload": True,
                      "buffer_size": 1 << 22}, None),
    ("nvme", {"device": "nvme", "buffer_size": 1 << 22}, None),
    ("param_tier", {"device": "nvme", "buffer_size": 1 << 24}, "nvme"))
OFFLOAD_SMALL_TOL = 1e-4
#: (c): the parameter tier at Llama-3 1B's full width in bf16, two depths
OFFLOAD_TIER_DEPTHS = (4, 8)
OFFLOAD_TIER_MICRO = 2
#: (d): a host Adam sweep and its conversions over this many values, and
#: an AsyncIOEngine write and read of this many bytes
OFFLOAD_HOST_VALUES = 1 << 30
OFFLOAD_AIO_BYTES = 4 << 30


def _meminfo() -> dict:
    out = {}
    with open("/proc/meminfo") as fh:
        for line in fh:
            k, v = line.split(":", 1)
            out[k] = int(v.split()[0]) * 1024
    return out


def _max_rss() -> int:
    import resource
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024


def _rss() -> int:
    with open("/proc/self/status") as fh:
        for line in fh:
            if line.startswith("VmRSS:"):
                return int(line.split()[1]) * 1024
    return 0


def _free_bytes(path: str) -> int:
    st = os.statvfs(path)
    return st.f_bavail * st.f_frsize


def _offload_probe(build: str) -> dict:
    """What the host offers the tiers, before anything is allocated."""
    import resource
    mem = _meminfo()
    lim = resource.getrlimit(resource.RLIMIT_MEMLOCK)[0]
    res = {"phase": "offload_probe", "mem_available": mem["MemAvailable"],
           "mem_total": mem["MemTotal"], "nproc": os.cpu_count(),
           "build_free_bytes": _free_bytes(build),
           "dev_shm_free_bytes": (_free_bytes("/dev/shm")
                                  if os.path.isdir("/dev/shm") else None),
           "ulimit_l": "unlimited" if lim == resource.RLIM_INFINITY
           else lim, "host_rss_bytes": _rss(),
           "host_max_rss_bytes": _max_rss()}
    res["host_room_bytes"] = (min(res["mem_total"], OFFLOAD_HOST_LIMIT)
                              - res["host_rss_bytes"] - OFFLOAD_HOST_OTHER)
    emit(res)
    return res


def _gbps(nbytes: float, seconds: float) -> float:
    return nbytes / seconds / 1e9 if seconds > 0 else float("inf")


def _offload_host_ops(build: str) -> dict:
    """(d): the host pieces alone. A host Adam sweep (``HostAdam.step``)
    over OFFLOAD_HOST_VALUES fp32 values, 28 bytes a value moved (p, g,
    m, v read; p, m, v written), its conversions and sum of squares,
    beside numpy copying the same values (8 bytes a value); then an
    AsyncIOEngine with O_DIRECT writes OFFLOAD_AIO_BYTES under build/ in
    64 MiB requests and reads them back, bit for bit."""
    import torch
    from deepspeed_tpu_torch.io.async_io import AsyncIOEngine, aligned_empty
    from deepspeed_tpu_torch.ops import host_adam
    n = OFFLOAD_HOST_VALUES
    block = torch.randn(1 << 24, generator=torch.Generator().manual_seed(3))

    def tiled(src, count):
        return src.repeat(-(-count // src.numel()))[:count].contiguous()
    p = tiled(block, n)
    g = tiled(block * 1e-3, n)
    adam = host_adam.HostAdam(n, weight_decay=0.1)
    adam.step(p, g, lr=1e-4)                     # first touch of m, v
    t0 = time.perf_counter()
    adam.step(p, g, lr=1e-4)
    adam_s = time.perf_counter() - t0
    src, dst = adam.exp_avg.numpy(), adam.exp_avg_sq.numpy()
    np.copyto(dst, src)
    t0 = time.perf_counter()
    np.copyto(dst, src)
    copy_s = time.perf_counter() - t0
    half = torch.empty(n, dtype=torch.bfloat16)
    host_adam.f32_to_bf16(p, half)
    t0 = time.perf_counter()
    host_adam.f32_to_bf16(p, half)
    narrow_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    host_adam.bf16_to_f32(half, g)
    widen_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    host_adam.l2_norm_sq(g)
    norm_s = time.perf_counter() - t0
    del p, g, adam, src, dst, half
    nb = OFFLOAD_AIO_BYTES
    buf = aligned_empty(nb)
    buf.view(torch.float32).copy_(tiled(block, nb // 4))
    back = aligned_empty(nb)
    path = os.path.join(build, "offload_aio.bin")
    aio = AsyncIOEngine(num_threads=8, o_direct=True)
    req = 64 << 20
    try:
        t0 = time.perf_counter()
        for off in range(0, nb, req):
            aio.pwrite(path, buf[off:off + req], off)
        werr = aio.drain()
        os.sync()
        write_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        for off in range(0, nb, req):
            aio.pread(path, back[off:off + req], off)
        rerr = aio.drain()
        read_s = time.perf_counter() - t0
        same = bool(torch.equal(buf, back))
    finally:
        os.remove(path)
    res = {"phase": "offload_host_ops", "values": n,
           "adam_s": adam_s, "adam_gb_per_s": _gbps(28 * n, adam_s),
           "numpy_copy_s": copy_s,
           "numpy_copy_gb_per_s": _gbps(8 * n, copy_s),
           "narrow_gb_per_s": _gbps(6 * n, narrow_s),
           "widen_gb_per_s": _gbps(6 * n, widen_s),
           "l2_norm_sq_gb_per_s": _gbps(4 * n, norm_s),
           "aio_bytes": nb, "aio_o_direct": True,
           "aio_write_s": write_s, "aio_write_gb_per_s": _gbps(nb, write_s),
           "aio_read_s": read_s, "aio_read_gb_per_s": _gbps(nb, read_s),
           "aio_errors": werr + rerr, "aio_bitwise": same}
    emit(res)
    assert werr == 0 and rerr == 0 and same, res
    return res


def _ulp_err(got, want) -> float:
    """Largest |got - want| in units of want's bf16 ulp (2^(e-8) for
    want = m 2^e, m in [0.5, 1)); 0 where both are equal."""
    import torch
    got, want = got.float(), want.float()
    _, e = torch.frexp(want)
    ulp = torch.ldexp(torch.ones_like(want), e - 8)
    ulp = torch.where(want == 0, torch.full_like(want, 2.0 ** -133), ulp)
    return float(((got - want).abs() / ulp).max())


def _offload_leaf_check(eng, captured) -> dict:
    """After the first step: each captured leaf (embed, layer 0's wq, the
    final norm) equals a torch AdamW step computed on the card from the
    same fp32 master slice and the same landed bf16 gradients (clipped by
    the step's coefficient), narrowed to bf16, within 1 bf16 ulp."""
    import torch
    opt = eng.host_optimizer
    p = opt.hyperparams
    cfg = eng.config.optimizer.params
    out = {}
    norm, lr = captured["grad_norm"], captured["lr"]
    clip = float(eng.config.gradient_clipping)
    coef = clip / (norm + 1e-6) if clip > 0 and norm > clip else None
    for name, (master, grad) in captured["leaves"].items():
        w = torch.nn.Parameter(master.to(DEV))
        g = grad.to(DEV).float()
        if coef is not None:
            g = g * coef
        w.grad = g
        ref = torch.optim.AdamW([w], lr=lr, betas=tuple(p["betas"]),
                                eps=float(cfg.get("eps", 1e-8)),
                                weight_decay=float(cfg["weight_decay"]))
        ref.step()
        want = w.detach().to(torch.bfloat16)
        got = captured["after"][name].to(DEV)
        out[name] = {"numel": want.numel(), "ulp_err": _ulp_err(got, want),
                     "moved": float((want.float() - master.to(DEV))
                                    .abs().max())}
        del w, g, ref, want, got
    return out


def _master_slice(opt, off: int, n: int):
    """A copy of the host optimizer's fp32 master [off, off + n): from
    memory, or from the NVMe tier's file."""
    import torch
    if opt.master is not None:
        return opt.master[off:off + n].clone()
    buf = torch.empty(n)
    opt.aio.pread(opt.files["master"], buf, off * 4)
    opt._drain()
    return buf


def _disk_rate(build: str) -> float:
    """min(write, read) bytes/s of a 1 GiB O_DIRECT round trip under
    build/."""
    from deepspeed_tpu_torch.io.async_io import AsyncIOEngine, aligned_empty
    nb, req = 1 << 30, 64 << 20
    buf = aligned_empty(nb)
    path = os.path.join(build, "offload_rate.bin")
    aio = AsyncIOEngine(num_threads=8, o_direct=True)
    try:
        secs = []
        for fn in (aio.pwrite, aio.pread):
            t0 = time.perf_counter()
            for off in range(0, nb, req):
                fn(path, buf[off:off + req], off)
            assert aio.drain() == 0
            secs.append(time.perf_counter() - t0)
    finally:
        os.remove(path)
    return nb / max(secs)


#: the three leaves (embed, layer 0's wq, the final norm) whose first
#: step (a) holds to an AdamW step on the card
OFFLOAD_CHECK_LEAVES = {"embed": ("embed", "tokens"),
                        "layer0_wq": ("layers", "attn", "wq"),
                        "final_norm": ("final_norm", "scale")}


def _offload_engine_run(cfg, conf, batch, overlap: bool, meta: dict) -> dict:
    """One (a) engine: built, OFFLOAD_WARMUP + OFFLOAD_STEPS steps on one
    batch, its line printed; without overlap, the first step's three
    leaves captured (master slice and landed gradients, through a one-shot
    wrapper of the host optimizer's ``step``) and checked."""
    import torch
    from deepspeed_tpu_torch import initialize
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    eng, _, _, _ = initialize(cfg, conf, generator=torch.Generator(
        device=DEV).manual_seed(0), device=DEV)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    init_peak = torch.cuda.max_memory_allocated() / 1e9
    torch.cuda.reset_peak_memory_stats()
    opt = eng.host_optimizer
    captured = None
    if not overlap:
        lay = opt.layout
        sl = {}
        for nm, path in OFFLOAD_CHECK_LEAVES.items():
            i = lay.paths.index(path)
            sl[nm] = (lay.offsets[i], lay.sizes[i] // cfg.num_layers
                      if path[0] == "layers" else lay.sizes[i])
        captured = {"leaves": {}}
        orig = opt.step

        def spy(*a, **k):
            # the landed gradients and the master before the step
            for nm, (o, n) in sl.items():
                captured["leaves"][nm] = (_master_slice(opt, o, n),
                                          opt._landing()[o:o + n].clone())
            del opt.step        # the class's method again
            return orig(*a, **k)
        opt.step = spy
    losses, step_s, parts = [], [], []
    for s in range(OFFLOAD_WARMUP + OFFLOAD_STEPS):
        t1 = time.perf_counter()
        losses.append(float(eng.train_batch(iter(batch))))
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t1)
        parts.append(dict(opt.timings))
        if captured is not None and s == 0:
            m = eng._last_metrics
            captured.update(grad_norm=float(m["grad_norm"]),
                            lr=float(m["lr"]))
            captured["after"] = {}
            for nm, path in OFFLOAD_CHECK_LEAVES.items():
                leaf = eng.params
                for k in path:
                    leaf = leaf[k]
                if path[0] == "layers":
                    leaf = leaf[0]
                captured["after"][nm] = leaf.detach().reshape(-1).clone()
    eng._drain_host_step()          # overlap: the last update lands
    timed = step_s[OFFLOAD_WARMUP:]
    tparts = parts[OFFLOAD_WARMUP:]

    def mean(key):
        vals = [p[key] for p in tparts if key in p]
        return sum(vals) / len(vals) if vals else None
    nbytes = opt.layout.total * 2
    res = {"phase": "offload_main", "model": "llama3-" + OFFLOAD_MODEL[0],
           "dtype": "bfloat16", "overlap": overlap,
           "params": cfg.num_params(), "micro_batch": 1, "seq": OFFLOAD_SEQ,
           "init_seconds": init_s, "init_peak_hbm_gb": init_peak,
           "losses": losses, "step_seconds": step_s,
           "ms_per_step": 1e3 * sum(timed) / len(timed),
           "fwd_bwd_ms": mean("fwd_bwd_ms"), "sweep_s": mean("sweep_s"),
           "d2h_gb_per_s": (nbytes / mean("d2h_ms") / 1e6
                            if mean("d2h_ms") else None),
           "h2d_gb_per_s": (nbytes / mean("h2d_ms") / 1e6
                            if mean("h2d_ms") else None),
           "host_state_bytes": opt.host_bytes(),
           "peak_hbm_gb": torch.cuda.max_memory_allocated() / 1e9,
           "card_state_this_depth_gb": 14 * cfg.num_params() / 1e9,
           "tokens_per_s": OFFLOAD_SEQ / (sum(timed) / len(timed)),
           "grad_norm": eng.get_global_grad_norm(),
           "host_max_rss_bytes": _max_rss(),
           "mem_available_now": _meminfo()["MemAvailable"], **meta}
    if captured is not None:
        res["leaf_check"] = _offload_leaf_check(eng, captured)
    emit(res)
    return res


def _offload_main(build: str, probe: dict, smi: str) -> dict:
    """(a): Llama-3 8B through initialize/train_batch with the optimizer
    state in host memory; full depth if the host holds the 'cpu' tier, else
    the NVMe tier if the disk holds it and its traffic fits
    OFFLOAD_NVME_BUDGET_S, else the 'cpu' tier with layers cut until it
    fits (printed under ``reduced``)."""
    import gc
    import torch
    from deepspeed_tpu_torch import initialize, llama3_config
    from deepspeed_tpu_torch.ops import op_builder
    full = llama3_config(OFFLOAD_MODEL[0], **OFFLOAD_MODEL[1])
    n_full = full.num_params()
    one, two = (llama3_config(OFFLOAD_MODEL[0], num_layers=k,
                              **OFFLOAD_MODEL[1]).num_params()
                for k in (1, 2))
    per_layer, fixed = two - one, 2 * one - two
    budget = probe["host_room_bytes"] - OFFLOAD_HOST_RESERVE
    layers, device, reduced, nvme_s, rate = full.num_layers, "cpu", None, \
        None, None
    if OFFLOAD_HOST_BYTES * n_full > budget:
        if probe["build_free_bytes"] > 12 * n_full * 1.1 \
                and 4 * n_full < budget:
            rate = _disk_rate(build)
            nvme_s = 2 * (OFFLOAD_WARMUP + OFFLOAD_STEPS) * 24 * n_full / rate
        if nvme_s is not None and nvme_s < OFFLOAD_NVME_BUDGET_S:
            device = "nvme"
        else:
            layers = int((budget / OFFLOAD_HOST_BYTES - fixed) // per_layer)
            assert layers >= 1, (probe, budget)
            reduced = {"num_layers": [full.num_layers, layers],
                       "why": "host memory: the 'cpu' tier holds "
                              f"{OFFLOAD_HOST_BYTES} B a parameter "
                              f"({OFFLOAD_HOST_BYTES * n_full / 1e9:.1f} GB "
                              f"at full depth) and the room left is "
                              f"{budget / 1e9:.1f} GB; the NVMe tier needs "
                              f"{12 * n_full / 1e9:.0f} GB of disk (free: "
                              f"{probe['build_free_bytes'] / 1e9:.0f} GB) "
                              f"and moves {24 * n_full / 1e9:.0f} GB a step"
                              + (f", {nvme_s:.0f} s for its steps at "
                                 f"{rate / 1e9:.2f} GB/s" if rate else "")}
    cfg = llama3_config(OFFLOAD_MODEL[0], num_layers=layers,
                        **OFFLOAD_MODEL[1])
    off = {"device": device}
    if device == "nvme":
        off["nvme_path"] = os.path.join(build, "offload_main")
    conf = {"train_micro_batch_size_per_gpu": 1,
            "gradient_accumulation_steps": 1,
            "optimizer": {"type": "adamw",
                          "params": {"lr": 1e-4, "weight_decay": 0.1}},
            "gradient_clipping": 1.0, "bf16": {"enabled": True},
            "activation_checkpointing": {"policy": "full"},
            "zero_optimization": {"stage": 2, "offload_optimizer": off},
            "attention_impl": "auto", "steps_per_print": 1000}
    rng = np.random.default_rng(10)
    batch = [{"input_ids": rng.integers(0, cfg.vocab_size,
                                        size=(1, OFFLOAD_SEQ))
              .astype(np.int32)}]
    runs = {}
    meta = {"device": device, "num_layers": layers, "reduced": reduced,
            "card_state_full_depth_gb": 14 * n_full / 1e9, "nvidia_smi": smi}
    op_builder.reset_launches()
    for overlap in (False, True):
        conf["zero_optimization"]["offload_optimizer"]["overlap"] = overlap
        runs[overlap] = _offload_engine_run(cfg, conf, batch, overlap, meta)
        # the engine is gone with the call's frame: its host state is
        # free before the next engine takes the same amount
        gc.collect()
        torch.cuda.empty_cache()
    launches = dict(op_builder.launches)
    steps = 2 * (OFFLOAD_WARMUP + OFFLOAD_STEPS)
    for res in runs.values():
        assert all(np.isfinite(res["losses"])), res["losses"]
        assert res["losses"][-1] < res["losses"][0], res["losses"]
        assert res["peak_hbm_gb"] < 80.0, res
    assert all(v["ulp_err"] <= 1.0 for v in runs[False]["leaf_check"]
               .values()), runs[False]["leaf_check"]
    # remat full: K1 twice a layer (forward, recompute), K3 once
    assert launches["flash_attention_fwd"] == 2 * layers * steps, launches
    assert launches["flash_attention_bwd"] == layers * steps, launches
    return launches


def _small_run(label, cfg, conf, init, data, dev, root):
    import torch
    from deepspeed_tpu_torch import initialize
    from deepspeed_tpu_torch.ops import op_builder
    eng, _, _, _ = initialize(cfg, conf, params=init, device=dev)
    op_builder.reset_launches()
    losses = [float(eng.train_batch(iter(data[2 * s:2 * s + 2])))
              for s in range(2)]
    eng._drain_host_step()
    params = eng._param_stream.full_params() \
        if eng._param_stream is not None else _to_cpu(eng.params)
    out = {"losses": losses, "params": params,
           "launches": dict(op_builder.launches),
           "rollbacks": getattr(eng.host_optimizer, "speculative_rollbacks",
                                None),
           "grad_norm": eng.get_global_grad_norm()}
    del eng
    import gc
    gc.collect()
    if dev != "cpu":
        torch.cuda.empty_cache()
    return out


def _offload_small(build: str) -> dict:
    """(b): each tier at depth 2 and Llama-3 1B width in fp32, 2 steps on
    the card and on the CPU from one seeded tree, against each other and
    against the card's on-device AdamW engine (overlap's losses against
    its CPU run only: its second step sees the first weights)."""
    import shutil
    import torch
    from deepspeed_tpu_torch import llama3_config
    from deepspeed_tpu_torch.models.transformer import init_params
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = llama3_config("1b", **OFFLOAD_SMALL)
    init = init_params(cfg, torch.Generator(device=DEV).manual_seed(8),
                       torch.float32, DEV)
    init_cpu = _to_cpu(init)
    rng = np.random.default_rng(8)
    data = [{"input_ids": rng.integers(0, cfg.vocab_size, size=(1, 256))
             .astype(np.int32)} for _ in range(4)]
    base = {"train_micro_batch_size_per_gpu": 1,
            "gradient_accumulation_steps": 2,
            "optimizer": {"type": "adamw",
                          "params": {"lr": 1e-5, "weight_decay": 0.1}},
            "gradient_clipping": 0.05, "attention_impl": "auto"}
    root = os.path.join(build, "offload_small")
    device_run = _small_run("device", cfg, dict(base), init, data, DEV, root)
    out = {}

    def leaves(tree):
        return [x for k in sorted(tree) for x in leaves(tree[k])] \
            if isinstance(tree, dict) else [tree]
    try:
        for label, off, param_dev in OFFLOAD_SMALL_RUNS:
            runs = {}
            for where, dev, tree in (("card", DEV, init),
                                     ("cpu", "cpu", init_cpu)):
                o = dict(off)
                path = os.path.join(root, f"{label}_{where}")
                if o["device"] == "nvme":
                    o["nvme_path"] = path
                zero = {"stage": 3 if param_dev else 2,
                        "offload_optimizer": o}
                if param_dev:
                    zero["offload_param"] = {"device": param_dev,
                                             "nvme_path": path}
                t0 = time.perf_counter()
                runs[where] = _small_run(label, cfg, dict(
                    base, zero_optimization=zero), tree, data, dev, path)
                runs[where]["seconds"] = time.perf_counter() - t0
            card, cpu = runs["card"], runs["cpu"]
            pc, pp, pd = (leaves(card["params"]), leaves(cpu["params"]),
                          leaves(device_run["params"]))
            res = {"phase": "offload_small", "run": label,
                   "losses_card": card["losses"], "losses_cpu": cpu["losses"],
                   "losses_device_engine": device_run["losses"],
                   "loss_rel_err_cpu": max(
                       abs(a - b) / abs(b) for a, b in
                       zip(card["losses"], cpu["losses"])),
                   "loss_rel_err_device": max(
                       abs(a - b) / abs(b) for a, b in
                       zip(card["losses"], device_run["losses"])),
                   "param_max_abs_err_cpu": max(
                       _err(a, b) for a, b in zip(pc, pp)),
                   "param_max_abs_err_device": max(
                       _err(a, b) for a, b in zip(pc, pd)),
                   "rollbacks_card": card["rollbacks"],
                   "grad_norm_card": card["grad_norm"],
                   "grad_norm_cpu": cpu["grad_norm"],
                   "seconds_card": card["seconds"],
                   "seconds_cpu": cpu["seconds"],
                   "launches": card["launches"], "tol": OFFLOAD_SMALL_TOL}
            emit(res)
            out[label] = res
            tol = OFFLOAD_SMALL_TOL
            assert all(np.isfinite(card["losses"]))
            assert res["loss_rel_err_cpu"] <= tol, res
            assert res["param_max_abs_err_cpu"] <= tol, res
            assert res["param_max_abs_err_device"] <= tol, res
            if label != "offload_overlap":
                assert res["loss_rel_err_device"] <= tol, res
            if label == "superoffload":
                assert card["rollbacks"] == 2, res
            assert card["launches"]["flash_attention_fwd"] > 0, res
            assert not any(cpu["launches"].values()), cpu["launches"]
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return out


def _offload_param_tier(build: str, probe: dict) -> dict:
    """(c): the parameter tier at Llama-3 1B's full width in bf16 at two
    depths: the store's bytes, its streaming GB/s (bytes read and written
    a step over the step's seconds) and the card's peak memory, which is
    one layer, the activations and the tail at either depth."""
    import gc
    import shutil
    import torch
    from deepspeed_tpu_torch import initialize, llama3_config
    out = {}
    root = os.path.join(build, "offload_tier")
    depths = list(OFFLOAD_TIER_DEPTHS)
    per = llama3_config("1b", num_layers=2).num_params() - \
        llama3_config("1b", num_layers=1).num_params()
    fixed = llama3_config("1b", num_layers=1).num_params() - per
    room = min(probe["build_free_bytes"], probe["mem_available"]) * 0.5
    while depths[1] > 2 * depths[0] and \
            18 * (fixed + depths[1] * per) > room:
        depths[1] //= 2
    try:
        for depth in depths:
            cfg = llama3_config("1b", num_layers=depth, max_seq_len=2048)
            path = os.path.join(root, f"d{depth}")
            conf = {"train_micro_batch_size_per_gpu": OFFLOAD_TIER_MICRO,
                    "optimizer": {"type": "adamw",
                                  "params": {"lr": 1e-4,
                                             "weight_decay": 0.1}},
                    "gradient_clipping": 1.0, "bf16": {"enabled": True},
                    "zero_optimization": {
                        "stage": 3,
                        "offload_optimizer": {"device": "nvme",
                                              "nvme_path": path},
                        "offload_param": {"device": "nvme",
                                          "nvme_path": path}},
                    "attention_impl": "auto", "steps_per_print": 1000}
            eng, _, _, _ = initialize(cfg, conf, generator=torch.Generator(
                device=DEV).manual_seed(1), device=DEV)
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            rng = np.random.default_rng(11)
            batch = [{"input_ids": rng.integers(
                0, cfg.vocab_size, size=(OFFLOAD_TIER_MICRO, 2048))
                .astype(np.int32)}]
            losses, secs = [], []
            for _ in range(2):
                t0 = time.perf_counter()
                losses.append(float(eng.train_batch(iter(batch))))
                torch.cuda.synchronize()
                secs.append(time.perf_counter() - t0)
            st = eng._param_stream
            res = {"phase": "offload_param_tier", "depth": depth,
                   "params": cfg.num_params(), "losses": losses,
                   "step_seconds": secs,
                   "store_bytes": st.store_bytes(),
                   "bytes_moved_per_step": st.bytes_moved,
                   "stream_gb_per_s": _gbps(st.bytes_moved, secs[-1]),
                   "peak_hbm_gb": torch.cuda.max_memory_allocated() / 1e9,
                   "tokens_per_s": OFFLOAD_TIER_MICRO * 2048 / secs[-1]}
            emit(res)
            out[depth] = res
            del eng, st
            gc.collect()
            torch.cuda.empty_cache()
            shutil.rmtree(path, ignore_errors=True)
            assert all(np.isfinite(losses)), losses
    finally:
        shutil.rmtree(root, ignore_errors=True)
    lo, hi = (out[d]["peak_hbm_gb"] for d in depths)
    assert hi <= 1.1 * lo, out
    return out


def phase_offload(smi: str) -> dict:
    """ZeRO-Offload on one card (phase 10): the probe line, then (a) the
    main path — Llama-3 8B at full width in bf16 with its AdamW state in
    host memory, sync and overlapped, with the three-leaf check against an
    AdamW step on the card, (b) every tier at depth 2 in fp32 card against
    CPU, (c) the parameter tier at two depths, (d) the host pieces alone
    (last: their buffers reuse (a)'s freed memory). Returns (a)'s
    launches."""
    here = os.path.dirname(os.path.abspath(__file__))
    build = os.path.join(here, "build")
    os.makedirs(build, exist_ok=True)
    probe = _offload_probe(build)
    launches = _offload_main(build, probe, smi)
    _offload_small(build)
    _offload_param_tier(build, probe)
    _offload_host_ops(build)
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


#: phase 8's depth-2 fp32 card-vs-CPU runs of the 1B/8e model: the
#: dropless main path, the JAX package's default MoE training config
#: (capacity impl with random token selection and drop_tokens; capacity
#: factor 1.0 drops tokens at 256 tokens a micro-batch, so the order
#: matters) and Residual-MoE on the dropless layer
MOE_WIDTH_RUNS = (("dropless", {"impl": "dropless"}, False),
                  ("capacity_rts", {"impl": "capacity", "use_rts": True,
                                    "drop_tokens": True,
                                    "capacity_factor": 1.0}, False),
                  ("residual", {"impl": "dropless", "use_residual": True},
                   True))


def phase_moe_train_full_width():
    """Two fp32 train_batch steps of the 1B/8e bench model at depth 2
    (gas 2, micro batch 1 x 256 tokens, AdamW lr 1e-5, clip 1.0) on the
    card and on the CPU from one seeded parameter tree and the same
    batches, for each MoE config of MOE_WIDTH_RUNS: losses (CE + aux) and
    aux within 1e-4 relative, parameters within 1e-4 absolute (the lr
    argument of phase 6). Random token selection draws each layer's
    permutation from a CPU generator, so both sides drop the same
    tokens."""
    import dataclasses
    import torch
    from deepspeed_tpu_torch import initialize
    from deepspeed_tpu_torch.models.mixtral import mixtral_config
    from deepspeed_tpu_torch.models.transformer import init_params
    from deepspeed_tpu_torch.ops import op_builder
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = mixtral_config("tiny", **dict(MOE_TRAIN_MODEL, num_layers=2,
                                        max_seq_len=256))
    for label, moe, residual in MOE_WIDTH_RUNS:
        conf = _moe_train_conf(1, 2, 1e-5, bf16=False, moe=moe)
        init = init_params(dataclasses.replace(cfg, moe_residual=residual),
                           torch.Generator(device=DEV).manual_seed(10),
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
                losses.append(float(eng.train_batch(
                    iter(data[2 * step:2 * step + 2]))))
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
               "model": "moe-1b-8e-width-depth2", "moe": label,
               "dtype": "float32",
               "losses_card": card["losses"], "losses_cpu": cpu["losses"],
               "aux_card": card["aux"], "aux_cpu": cpu["aux"],
               "loss_rel_err": loss_rel, "aux_rel_err": aux_rel,
               "param_max_abs_err": param_err, "tol": 1e-4,
               "launches": card["launches"]}
        emit(res)
        micro_layers = 2 * 2 * cfg.num_layers
        grouped = MOE_LAYER_LAUNCHES if moe["impl"] == "dropless" else \
            {k: 0 for k in MOE_LAYER_LAUNCHES}
        assert all(card["launches"][k] == n * micro_layers
                   for k, n in grouped.items()), card["launches"]
        assert all(card["launches"][k] == micro_layers
                   for k in TRAIN_KERNELS), card["launches"]
        assert not any(cpu["launches"].values()), cpu["launches"]
        assert all(np.isfinite(card["losses"]))
        assert loss_rel <= 1e-4 and aux_rel <= 1e-4 and param_err <= 1e-4, \
            res


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
    type (bf16 or f32), its head_dim and any further integer template
    argument (K3's dk/dv pass at D 256), e.g. ``flash_fwd_mma_kernel<bf16,
    128>``, ``flash_bwd_dkv_mma_kernel<bf16, 256, 2>``. Empty when the
    library came from an earlier run."""
    import re
    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties "
                      r"for) '?(\w+)", line)
        if m:
            mangled = m.group(1)
            fn = re.search(r"(flash_(?:fwd|bwd)\w*?_kernel)I", mangled)
            ints = re.findall(r"Li(\d+)E", mangled) or ["?"]
            ty = "f32" if re.search(r"_kernelIf", mangled) else "bf16"
            name = (f"{fn.group(1) if fn else mangled}<{ty}, "
                    f"{', '.join(ints)}>")
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

    #: each phase's wall seconds, printed before the kernel table
    seconds = {"build": time.perf_counter() - t0}

    def run(fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        seconds[fn.__name__] = time.perf_counter() - t
        return out

    rng = np.random.default_rng(0)
    timed = run(phase_kernels, rng)
    grouped = run(phase_grouped, rng)
    grouped_bwd = run(phase_grouped_bwd, rng)
    quant = run(phase_quant, rng)
    if "--kernels-only" in sys.argv[1:]:
        emit({"phase": "seconds", **seconds})
        return 0
    run(phase_full_width)
    run(phase_full_width_moe)
    run(phase_full_width_quant)
    run(phase_fused_fp32)
    serve, serve_frontend = run(phase_serve)
    paths = {"serve": serve, "serve_frontend": serve_frontend,
             "serve_moe": run(phase_serve_moe),
             "serve_quant": run(phase_serve_quant),
             "serve_hf": run(phase_hf_models),
             "v1_inference": run(phase_v1_inference, smi)}
    run(phase_train_full_width)
    paths["train"] = run(phase_train)
    paths["train_resume"] = run(phase_checkpoint, smi)
    paths["train_offload"] = run(phase_offload, smi)
    families = run(phase_train_families)
    paths["train_families"] = families["launches"]
    paths["train_policies"] = run(phase_train_policies, smi)
    run(phase_moe_layer_grad)
    run(phase_moe_train_full_width)
    paths["train_moe"] = run(phase_train_moe)
    paths["train_mixtral"] = run(phase_train_mixtral)
    emit({"phase": "seconds", **seconds})

    # launches: over the main paths (dense serving and MoE serving, phase
    # 5; v1 inference, phase 11's serving calls; dense training, phase 7; train → save → resume → train, phase 9
    # (b); MoE training of the 1B/8e bench model
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
        dim_paths = {"serve_hf": HF_DIM_LAUNCHES,
                     "train_families": families["by_head_dim"]}
        if any(row["name"] in c for c in dim_paths.values()):
            # launches by head dim: the HF models' serving path and the
            # model families' training path counted by the wrappers'
            # head-dim counters, every other path's model at 128; each new
            # instance's times at its model's path shapes
            by_dim = {d: 0 for d in (64, 80, 96, 128, 256)}
            counted = 0
            for path, counts in dim_paths.items():
                for d, n in counts.get(row["name"], {}).items():
                    by_dim[d] += n
                counted += row["launches_by_path"][path]
            by_dim[128] += row["launches"] - counted
            assert sum(by_dim.values()) == row["launches"], by_dim
            row["launches_by_head_dim"] = by_dim
            keys = {"flash_attention_fwd": (("fresh", "flash"),),
                    "flash_attention_bwd": (("bwd", "kernel"),),
                    "paged_attention": (("decode", "split"),
                                        ("history", "mma"),
                                        ("fma", "fma"))}[row["name"]]
            row["head_dims"] = {
                NEW_DIM_HEADS[tag][2]: {"heads": NEW_DIM_HEADS[tag][:2],
                                        "launches": by_dim[
                                            NEW_DIM_HEADS[tag][2]], **{
                    form: {k: timed[f"{key}_{tag}"].get(k) for k in (
                        "check", "kernel_ms", "kernel_graph_ms",
                        "plain_ms", "bound_ms", "bound_by", "library_ms",
                        "max_abs_err")} for key, form in keys}}
                for tag in NEW_DIM_HEADS}
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
