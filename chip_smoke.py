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
4. runs ``ragged_forward`` for a model of CPU_HOLD_DEPTH (2) at
   Llama-3-8B width in fp32
   on the card (kernels) and on the CPU (plain versions) — a fresh chunk, a
   split chunk and a decode step — and compares the logits, then checks
   that the bf16 head returns unrounded fp32 logits; then the same for a
   CPU_HOLD_DEPTH_CUT model at Mixtral 8x7B width: a fresh 4 x 256 chunk (1024
   tokens: the dropless FFN, grouped kernels) and a decode step (the
   capacity FFN); then from one quantized tree: depth 1 at Llama-3 8B
   width in int8, fp8, int4 and fp6 (fresh, split, decode; chunks of 128
   tokens, ``reduced`` from 256: the CPU side's time) and at Mixtral
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
6. runs two ``train_batch`` steps of a CPU_HOLD_DEPTH model at Llama-3-1B
   width in
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
   CPU_HOLD_DEPTH_CUT, card against CPU, dropless, under the capacity impl with
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
   under ``build/`` removed at the end: (a) at depth 1 (``reduced``) and
   Llama-3 1B width (a 32,000-entry vocabulary, an FFN of 2048) in fp32,
   for AdamW, LAMB, Lion, Adagrad, SGD with momentum and Muon, a step
   on the card, ``save_checkpoint``, ``load_checkpoint`` into a fresh card
   engine and a CPU engine (every leaf bitwise the saved one), a step on
   each from the loaded state, card against CPU (``reduced`` from 2 steps
   each side of the save); (c) ``step:3:preempt`` under
   ``DSElasticAgent``: ``Preempted`` with tag preempt_step4 and a black
   box, ``agent.resume()`` in a fresh engine, and its 2 steps against the
   uninterrupted run; (b) the slice's main path, Llama-3 1B at full width
   and 4 of its 16 layers (``reduced``) in bf16: 2 steps, ``save_checkpoint(async_save=True)`` and a
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
   fits, else with layers cut to what the host holds, and at most
   OFFLOAD_MAX_LAYERS (4) layers (printed under ``reduced``): 2 warm-up
   steps and 1 timed (``reduced`` from 3) on one
   fixed batch with ``overlap`` off, then on, each with ms a step, the card's
   forward+backward ms, the host sweep's seconds, D2H and H2D GB/s, the
   host state's bytes, peak memory beside the on-card state the model
   would need, losses (finite, falling) and K1's and K3's launches; after
   the first step, the embedding, layer 0's wq and the final norm equal
   an AdamW step computed on the card from the same master slice and
   landed bf16 gradients within 1 bf16 ulp; (b) at CPU_HOLD_DEPTH_CUT and Llama-3
   1B width in fp32, 2 steps of ZeRO-Offload (overlap off and on),
   SuperOffload (a clip that makes it roll back), the NVMe tier and the
   parameter tier under ``build/``, each on the card and the CPU, within
   1e-4 of each other and of the card's on-device AdamW engine; (c) the
   parameter tier at Llama-3 1B's full width in bf16 at depths 2 and 4
   (``reduced`` from 4 and 8): the
   store's bytes, streaming GB/s and peak memory, flat across depths; (d)
   a host Adam sweep over 2^30 values in GB/s beside numpy copying them,
   and an O_DIRECT ``AsyncIOEngine`` write and read of 4 GiB under
   ``build/``, checked bit for bit;
11. v1 inference and the quantization tool (run right after phase 5's HF
   models), each part one ``v1_inference`` line with the card's
   ``nvidia-smi`` name and power limit: (a) Llama-3 8B at full width and
   16 of 32 layers (``reduced``) in bf16 through ``init_inference``, 8
   prompts of 512 tokens and 128 new ones, greedy: the tokens of the decode step replayed as a CUDA
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
   Llama-3-width model of depth 1 (``reduced``): the int4 npz, loaded
   back, serves the tokens of ``weight_quant`` applied at start-up; (g) fp32 at depth 2
   with TF32 off, card against CPU, at the widths of Llama-3 8B and
   BLOOM-7b1 (prefill logits within 1e-4 relative, greedy tokens
   identical) and BERT-large (hidden states and logits within 1e-4).
12. data parallel and ZeRO-1/2/3 (``train_dp``, run last) over a real NCCL
   group of one rank (one card; NCCL refuses two ranks on it): (a)
   phase 7's Llama-3 1B engine in bf16 at stages 0, 1, 2, 3 and 3 with
   ``overlap_comm``, 3 steps each from one seed on one batch (ms a step,
   peak HBM, the comms logger's bytes a step by op, K1/K3 launches;
   losses within 1e-2 of stage 0's); (b) Llama-3 1B's width at CPU_HOLD_DEPTH
   (vocabulary 32,000) in fp32, the card at world 1 against the port on
   the CPU at dp 2 over gloo, two ranks this phase starts (losses within
   1e-4); (c) the card resumes the CPU ranks' dp-2 save through
   ``elastic_resume`` (losses within 1e-4 of the uninterrupted CPU run).
   ``--train-dp-only`` runs the build and this phase alone. Since the
   stage-3 repair (C6) stage 3 runs each block's forward once (K1 as many
   launches as stage 0), and two runs under remat 'full' hold stage 3
   against stage 0 (each forward twice: the loop, the replay).
13. tensor parallelism and ZeRO++ (``tp_zeropp``, after 12): two ranks on
   the card over gloo (NCCL refuses two ranks on one card;
   tools/gloo_cuda_probe.py found gloo's collectives working on CUDA
   tensors), each holding its 'model' shards: (a) Llama-3 8B (16 of 32
   layers, phase 11's cut) through
   ``init_inference`` at tp 2 in bf16 and int8 (``qmatmul_tp`` over K5a),
   phase 11's 8 x 512 prompts and seed, against tp 1 on the same weights
   (prefill logits within 8e-2 of the largest, the bf16 spread phase 11
   measures between two engines; greedy tokens matched of 16; ms a
   token, peak HBM per rank, bytes a token by collective);
   the same at depth 2 in fp32 (logits within 1e-4, tokens identical);
   (b) phase 7's engine at tp 2, stage 0, 2 steps, against phase 12's
   tp-1 run (losses within 1e-2; K1/K3 at 8 of 16 heads a rank); (b')
   fp32 at CPU_HOLD_DEPTH, the card's ranks against two CPU ranks, both tp 2
   (1e-4); (c) ZeRO++ on phase 7's engine at stage 2 over one NCCL rank,
   exact against qwZ + qgZ (K6 twice a step, its device ms inside the
   step; losses within 2e-2), then one more step in which each K6 call,
   on the bf16 parameter buffer and the fp32 gradient (1.269 B values
   each), is held against its plain version, bit for bit.
   ``--tp-zeropp-only`` runs the build, 8, 11 (e), 12, 13 and 14.
14. expert parallelism (``ep``), in phase 13's two card ranks after
   their phase-13 parts: (a) phase 11 (e)'s Mixtral (16 of 32 layers,
   ``reduced``) in int8 through ``init_inference`` at ep 2, each rank
   drawing only its 4 experts, 8 x 256 prompts split 4 a rank, 16 new
   tokens: prefill logits within 8e-2 of phase 11 (e)'s int8 run, greedy
   tokens matched, ms a token, all_to_all bytes and peak HBM a rank, K5c's
   launches at G 4 by shape; after the counted window K5c at those
   shapes against its plain version; (a') its width at depth 2 in fp32
   against ep 1 (2e-4, tokens identical); (b) the 1B/8e bench model with
   the capacity layer (capacity factor 1.0, tokens dropped) at ep 2,
   stage 1, a global batch of 2 x 2048, against ep 1 at world 1 on the
   same batches (losses within 1e-2; tokens dropped a step, ms a step,
   the all_to_all record, peak); (b') its width at depth 2 in fp32, the
   card's ranks against two CPU ranks at ep 2 (1e-4); (c) the 1B/8e
   dropless at tp 2, stage 0, against phase 8's run (losses within 1e-2;
   the five grouped kernels at f 1408 and K1/K3 at 4/2 heads a rank,
   counted), and after the counted window the five grouped kernels at f
   1408 against their plain versions.
15. sequence parallelism (``sp``): (a) in phase 13's two card ranks after
   phase 14, Llama-3 1B at full width, depth 2 and a 32,000-entry
   vocabulary (``reduced``), bf16, stage 1, 1 x 4096 tokens a step, 2
   steps each of Ulysses and ring at sp 2 against sp 1 at world 1 on the
   same batches (losses within 1e-2; ms a step and peak HBM a rank; the
   all_to_all and ppermute bytes a step against the JAX package's
   records; Ulysses' K1/K3 launched at 8/4 heads a rank, counted by
   shape); (b) the long-context step on one card: Llama-3 1B at full
   width and 4 of its 16 layers (``reduced``) at 131,072 tokens on
   bench.py's long-context configuration (remat
   offload_save_attn_kernel_host, ffn_chunk 8192, bf16 CE logits at a
   256 MB budget), a warm-up step and a step under torch.profiler: ms a
   step, tokens/s, peak HBM, finite losses, K1/K3 launched at T 131072
   and their device ms; (c) FPDT at one layer's shapes (1 x 131072, heads
   16/8 of 128, chunk 4096) with its KV store in pinned host memory,
   against K1 on the same q/k/v (each row within 1e-2), its ms, H2D
   GB/s, chunk reads and peak device bytes against K1's call; K1 and K3
   at T 131072 against their plain versions on the last 4096 query rows,
   and ``scaled_dot_product_attention``'s forward and backward timed at
   those shapes (its fused backends only); and K1/K3 at Ulysses' 8/4
   heads held and timed alone.
   ``--sp-only`` runs the build and phase 15 alone ((a) on two card ranks
   of its own).
16. pipeline parallelism (``pp``), in phase 13's two card ranks after
   phase 15 (a), one stage a rank: (a) Llama-3 1B at full width, depth 4
   (two layers a stage) and a 32,000-entry vocabulary (``reduced``),
   bf16, stage 1, remat 'full', 8 microbatches of 1 x 2048 a step, 2
   steps each of GPipe and 1F1B at pipe 2 against pipe 1 at world 1 with
   the same gas on the same batches (losses within 1e-2; ms a step and
   peak HBM a rank; the bytes each rank sent over 'pipe' a step against
   the schedule's formula; K1/K3 launched at 16/8/2048 in the stages,
   counted by shape); (b) one step of each schedule under remat 'none':
   peak HBM a rank, 1F1B's below GPipe's; (c) depth 3 (the balanced
   partition's padding row) in fp32 at T 256, the card's ranks against
   two CPU ranks at pipe 2 (1e-4). A card rank that has not finished the
   phase in PP_RANK_TIMEOUT_S dumps its stacks and exits.
   ``--pipe-only`` runs the build and phase 16 alone (two card ranks and
   two CPU ranks of its own).
17. the data axes (``data_axes``): (a) in phase 13's two card ranks after
   phase 16, Llama-3 1B at full width, depth 2 and a 32,000-entry
   vocabulary (``reduced``), bf16, 1 x 2048 tokens a rank a step: 1-bit
   Adam at data 2 over freeze_step 2 and 3 compressed steps (the
   warmup against AdamW at world 1; the compressed all-reduce's bytes
   n // 8 + 4 a call against the fp32 all-reduce's 4n; the error
   buffers nonzero after the freeze; K1/K3 launched), LAMB and Muon at
   data 2 stage 3 and at pipe 2 (1F1B), 2 steps each, against world-1
   runs on the same data; (b) MiCS at data 2 x data_inner 2 on four
   card ranks of its own (when the host holds them; else the line says
   why and MiCS stays a CPU result) against plain stage 3 at world 4,
   each rank's param-gather bytes a step equal to the sub-group
   formula, and the MiCS checkpoint loaded into a plain stage-3 engine
   bitwise. Each comparison holds the losses within DA_LOSS_TOL (1e-4)
   and the fp32 update, sketched on random directions without a gather
   (``_da_sketch``), within DA_UPDATE_TOL of its reference's. Step ms
   (gloo through the host) and peak HBM a rank. ``--data-axes-only``
   runs the build and phase 17 alone ((a) on two card ranks of its
   own).

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
#: the depth of the fp32 card-against-CPU holds at full width that keep
#: the faults which cross layers in view: phase 4's dense ragged_forward
#: (the KV arena's layer offsets), phase 6 (indexing into the stacked
#: layer leaves) and phase 12 (b) (the stage-3 loop carrying and
#: prefetching across chunks; phase 13 (b') shares its model)
CPU_HOLD_DEPTH = 2
#: the depth of the other fp32 card-against-CPU holds at full width
#: (phase 4's MoE and quantized models, 8, 10 (b); ``reduced`` from 2: the
#: CPU side's time scales with depth, and the holds above cross layers)
CPU_HOLD_DEPTH_CUT = 1
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
    cfg = llama3_config("8b", num_layers=CPU_HOLD_DEPTH)
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
    cfg = mixtral_config("8x7b", num_layers=CPU_HOLD_DEPTH_CUT)
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
        emit({"phase": "full_width_moe",
              "model": f"mixtral-8x7b-width-depth{CPU_HOLD_DEPTH_CUT}",
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
    split chunk and a decode step of 3 rows, chunks of 128 tokens, the
    head included: (4096, 128256)),
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
            # chunks of 128 (``reduced`` from 256: the CPU side's
            # dequantizing products, the head's above all, scale with the
            # tokens): a partial fresh chunk, a split chunk from mid-page,
            # one across a page boundary and one a whole page, decode
            steps = [("fresh", 128, [0, 0, 0], [100, 96, 128]),
                     ("split", 128, [100, 96, 128], [1, 100, 128]),
                     ("decode", 1, [101, 196, 256], [1, 1, 1])]
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
                  "reduced": None if moe else {"chunk_tokens": [256, 128]},
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

#: (a)/(b): Llama-3 8B at full width and 16 of its 32 layers (``reduced``:
#: the script's time limit; phase 13 (a) serves the same cut at tp 2), 8
#: prompts of 512 tokens, 128 new tokens, greedy; (b) in each of V1_QUANT
V1_LLAMA = ("8b", {"num_layers": 16})
V1_LLAMA_REDUCED = {"num_layers": [32, 16]}
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
#: (f): the quantizer CLI on an exported Llama-3-width model of depth 1
#: (``reduced`` from 2: the export, the CLI's numpy quantization and the
#: load scale with it)
V1_CLI = ("8b", {"num_layers": 1})
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
          "reduced": V1_LLAMA_REDUCED,
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
              "reduced": V1_LLAMA_REDUCED,
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
    # the router's fp32 logits without TF32 (phase 14 (a) holds its ep-2
    # run to this one's, with the same setting)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for mode in (None, "int8"):
        before = _v1_mem_start()
        eng = init_inference(
            cfg, {"dtype": "bfloat16", "weight_quant": mode},
            generator=torch.Generator(device=DEV).manual_seed(68),
            device=DEV)
        tokens, res, launches = _v1_generate(eng, prompts, V1_MOE_NEW)
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
            # phase 14 (a)'s reference, after the counted window
            with torch.no_grad():
                logits = eng.forward(prompts)[:, -1].float().cpu().numpy()
            _V1_MOE_INT8.update(logits=logits,
                                tokens=tokens[:, V1_MOE_PROMPT:])
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
    exported Llama-3-width model of depth 1; its npz served by
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
    d = os.path.join(root, "llama3-8b-width")
    npz = os.path.join(root, "llama3-8b-width.npz")
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


#: phase 6's models, each at CPU_HOLD_DEPTH and T 256 in fp32: Llama-3 1B's
#: width
#: (tied head), then the head dims of the model families, Gemma-2B's
#: (MQA 8/1, dh 256, GeGLU) and Phi-2's (32/32, dh 80, partial rotary,
#: parallel block, biased linears), each with a 32,000-entry vocabulary
#: and an FFN of 2048: only the attention's head dim matters there
TRAIN_FULL_WIDTH = (("llama3-1b-width", "llama3_config", "1b",
                     {"tie_embeddings": True}),
                    ("gemma-2b-width", "gemma_config", "2b",
                     {"vocab_size": 32000, "intermediate_size": 2048}),
                    ("phi-2-width", "phi_config", "2",
                     {"vocab_size": 32000, "intermediate_size": 2048}))


def phase_train_full_width():
    """Two train_batch steps of a CPU_HOLD_DEPTH model at Llama-3-1B width (tied
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
        cfg = getattr(dt, preset)(size, num_layers=CPU_HOLD_DEPTH,
                                  max_seq_len=256, **kw)
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
        res = {"phase": "train_full_width",
               "model": f"{label}-depth{CPU_HOLD_DEPTH}",
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

#: phase_train_full_width's model and config (Llama-3 1B width, tied
#: head, fp32, gas 2, T 256) for checkpoint checks (a) and (c), with a
#: 32,000-entry vocabulary and an FFN of 2048: no check of (a) or (c) needs
#: Llama-3's 128,256 entries (68 % of the parameters the CPU side of (a)
#: steps, saves and loads for each optimizer) or the 8192-wide FFN (whose
#: matrices hold most of the CPU's bf16 Newton-Schulz work for Muon); at
#: depth 1 (``reduced``: a second layer repeats every leaf and check of
#: the first, and the CPU side's steps, Muon's above all, scale with it)
CKPT_VOCAB, CKPT_FFN, CKPT_DEPTH = 32000, 2048, 1
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
#: (a)'s steps before the save and again after the load (``reduced`` from
#: 2: the first step after the load reads every restored moment, and the
#: CPU side's steps, Muon's above all, were the phase's largest cost)
CKPT_STEPS = 1
#: (b): Llama-3 1B's full width at 4 of its 16 layers (``reduced``: the
#: script's time limit; the save's and load's GB/s do not depend on it)
CKPT_FULL_LAYERS = 4
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
    """(a): for each optimizer, CKPT_STEPS steps on the card, save; load
    into a fresh card engine and a CPU engine (every leaf bitwise the
    saved one); CKPT_STEPS more steps on each, card against CPU."""
    import shutil
    import torch
    from deepspeed_tpu_torch import initialize
    steps = [data[2 * s:2 * s + 2] for s in range(2 * CKPT_STEPS)]
    for name, params in CKPT_OPTIMIZERS:
        conf = dict(CKPT_CONF, optimizer={"type": name, "params": params})
        counts = {}
        eng, _, _, _ = initialize(cfg, dict(conf), params=init, device=DEV)
        first = _ckpt_train(eng, steps[:CKPT_STEPS], counts)
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
            assert tag == name and eng.global_steps == CKPT_STEPS, \
                (tag, name)
            bad = _bitwise_mismatches(saved, eng)
            before = {k: v.detach().to("cpu", copy=True) for k, v in
                      _state_leaves(eng).items() if k.startswith("params/")}
            losses = _ckpt_train(eng, steps[CKPT_STEPS:],
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
               "model": f"llama3-1b-width-depth{CKPT_DEPTH}-vocab32k-ffn2048",
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
        want = 2 * CKPT_STEPS * 2 * cfg.num_layers
        assert all(counts[k] == want for k in TRAIN_KERNELS), counts


def _ckpt_preempt(root, cfg, init) -> None:
    """(c): ``step:3:preempt`` in (a)'s engine under DSElasticAgent:
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
           "model": f"llama3-1b-width-depth{CKPT_DEPTH}-vocab32k-ffn2048",
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
    """(b): Llama-3 1B at full width and CKPT_FULL_LAYERS (phase_train's
    engine): 2 steps, save_checkpoint(async_save=True) and a third step
    before wait_pending(); a fresh engine loads the tag and holds, bit for
    bit, the state at the save; its next 2 steps against the uninterrupted
    engine's. Returns the K1/K3 launches of this path's steps."""
    import torch
    from deepspeed_tpu_torch import initialize, llama3_config
    from deepspeed_tpu_torch.checkpoint import store
    from deepspeed_tpu_torch.ops import op_builder
    cfg = llama3_config(TRAIN_MODEL[0], **dict(TRAIN_MODEL[1],
                                               num_layers=CKPT_FULL_LAYERS))
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
           TRAIN_MODEL[0], "reduced": {"num_layers": [16, cfg.num_layers]},
           "dtype": "bfloat16", "params": cfg.num_params(),
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
    phase ends: (a) each optimizer at CKPT_DEPTH and Llama-3 1B width in
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
        cfg = llama3_config("1b", num_layers=CKPT_DEPTH, max_seq_len=256,
                            tie_embeddings=True, vocab_size=CKPT_VOCAB,
                            intermediate_size=CKPT_FFN)
        emit({"phase": "checkpoint", "reduced": {
            "num_layers": [2, CKPT_DEPTH],
            "optimizer_steps": [2, CKPT_STEPS],
            "why": "(a) and (c): the CPU side's steps scale with depth; "
                   "(a): one step each side of the save"}})
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
#: steps and 1 timed (``reduced`` from 3: a step is 7-12 s of host sweep;
#: the overlapped run's second step still waits for the first sweep) with
#: overlap off, then on
OFFLOAD_MODEL = ("8b", {"max_seq_len": 2048})
OFFLOAD_SEQ, OFFLOAD_WARMUP, OFFLOAD_STEPS = 2048, 2, 1
#: (a)'s depth at most (``reduced`` from the 15-18 layers the host holds:
#: the host sweep is 93 % of a step and scales with the layers; phases 15
#: and 16 pay for their time with this cut)
OFFLOAD_MAX_LAYERS = 4
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
#: (b): CPU_HOLD_DEPTH_CUT at Llama-3 1B width in fp32, phase 9 (a)'s vocabulary
#: and FFN; AdamW at lr 1e-5 (see phase_train_full_width), a clip of 0.05
#: that fires every step (SuperOffload rolls back), 2 steps of gas 2
OFFLOAD_SMALL = dict(num_layers=CPU_HOLD_DEPTH_CUT, max_seq_len=256,
                     tie_embeddings=True,
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
#: (``reduced`` from 4 and 8: the peak is flat across any two)
OFFLOAD_TIER_DEPTHS = (2, 4)
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
           "timed_steps": {"reduced": [3, OFFLOAD_STEPS]},
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
    if layers > OFFLOAD_MAX_LAYERS:
        reduced = {"num_layers": [full.num_layers, OFFLOAD_MAX_LAYERS],
                   "why": "the script's time limit: a step is 93 % host "
                          "sweep, which scales with the layers (the host "
                          f"holds {layers})"}
        layers, device = OFFLOAD_MAX_LAYERS, "cpu"
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
    """(b): each tier at CPU_HOLD_DEPTH_CUT and Llama-3 1B width in fp32, 2 steps on
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
    AdamW step on the card, (b) every tier at CPU_HOLD_DEPTH_CUT in fp32 card against
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


#: phase 8's CPU_HOLD_DEPTH_CUT fp32 card-vs-CPU runs of the 1B/8e model: the
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
    cfg = mixtral_config("tiny", **dict(MOE_TRAIN_MODEL,
                                        num_layers=CPU_HOLD_DEPTH_CUT,
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
               "model": f"moe-1b-8e-width-depth{CPU_HOLD_DEPTH_CUT}",
               "moe": label,
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
    _MOE_TP1.update(res)                 # phase 14 (c)'s tp-1 reference
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


# ---------------------------------------------------------------------------
# phase 12: data parallel and ZeRO-1/2/3 over torch.distributed
# ---------------------------------------------------------------------------

#: (a): phase 7's engine (Llama-3 1B, bf16, micro 4 x gas 2 x 2048) at
#: each ZeRO stage, DP_STEPS steps from one seed on one batch, over a real
#: NCCL group of one rank
DP_RUNS = (("stage0", 0, {}, "none"), ("stage1", 1, {}, "none"),
           ("stage2", 2, {}, "none"), ("stage3", 3, {}, "none"),
           ("stage3_overlap", 3, {"overlap_comm": True}, "none"),
           # stage 3 keeps its activations: under remat 'full' a block's
           # forward runs twice (the loop, the replay), as at stage 0
           ("stage0_remat_full", 0, {}, "full"),
           ("stage3_remat_full", 3, {"overlap_comm": True}, "full"))
DP_STEPS = 3
#: each stage's bf16 losses against stage 0's (a remat run against stage
#: 0 under the same policy), relative: at one rank the stages compute the
#: same function, and K3 accumulates dq/dk in a different order between
#: runs
DP_LOSS_TOL = 1e-2
#: (b)/(c): Llama-3 1B's width (d 2048, FFN 8192, heads 32/8) at CPU_HOLD_DEPTH
#: with a 32,000-entry vocabulary (phase 6's Gemma/Phi runs' cut: the
#: 128,256-entry head made the CPU ranks' steps and save ~70 s), fp32, T
#: 256, 2 rows a step; the CPU side is 2 gloo ranks (DP_CPU_THREADS torch
#: threads each), started by the phase, saving after their first step
DP_SMALL = dict(num_layers=CPU_HOLD_DEPTH, max_seq_len=256,
                tie_embeddings=True,
                vocab_size=32000)
DP_SMALL_TOL = 1e-4
DP_CPU_THREADS = 4
DP_CPU_TIMEOUT_S = 600.0
#: host bytes the two CPU ranks may take (each: the tree, a copy, its
#: shards' Adam state, gradients, the save's snapshot); the phase refuses
#: to start them when the container's limit (OFFLOAD_HOST_LIMIT) less this
#: process's resident set and what else the container holds
#: (OFFLOAD_HOST_OTHER) leaves less
DP_CPU_HOST_BYTES = 16e9


def _dp_small_conf():
    """fp32 AdamW at lr 1e-5 (phase 6's reason), ZeRO-3 with the overlap
    loop; the elastic block gives micro 1 at dp 2 and micro 2 at dp 1."""
    return {"train_micro_batch_size_per_gpu": 1,
            "gradient_accumulation_steps": 1,
            "optimizer": {"type": "adamw",
                          "params": {"lr": 1e-5, "weight_decay": 0.1}},
            "gradient_clipping": 1.0, "attention_impl": "auto",
            "zero_optimization": {"stage": 3, "overlap_comm": True},
            "elasticity": {"enabled": True, "micro_batch_sizes": [1, 2],
                           "max_train_batch_size": 2, "max_gpus": 2}}


def _dp_small_model():
    from deepspeed_tpu_torch import llama3_config
    return llama3_config(TRAIN_MODEL[0], **DP_SMALL)


def _dp_small_data(vocab):
    rng = np.random.default_rng(12)
    return [{"input_ids": rng.integers(0, vocab, size=(2, 256))
             .astype(np.int32)} for _ in range(DP_STEPS)]


def _dp_small_init(cfg):
    import torch
    from deepspeed_tpu_torch.models.transformer import init_params
    return init_params(cfg, torch.Generator().manual_seed(12),
                       torch.float32, "cpu")


def _dp_cpu_rank(rank, world, store, save_dir, out):
    """(b)/(c)'s CPU side: one of ``world`` gloo ranks trains DP_STEPS
    steps from the seeded tree and saves after the first (per-rank
    fragments); writes its losses to ``out``."""
    import pickle
    import traceback
    import torch
    torch.set_num_threads(DP_CPU_THREADS)
    from deepspeed_tpu_torch import build_mesh, comm, initialize
    from deepspeed_tpu_torch.ops import op_builder
    try:
        comm.init_distributed(init_method="file://" + store,
                              num_processes=world, process_id=rank,
                              device="cpu", timeout=int(DP_CPU_TIMEOUT_S))
        cfg = _dp_small_model()
        eng = initialize(cfg, _dp_small_conf(), params=_dp_small_init(cfg),
                         device="cpu", mesh=build_mesh(data=world))[0]
        t0 = time.perf_counter()
        losses = []
        for s, batch in enumerate(_dp_small_data(cfg.vocab_size)):
            losses.append(float(eng.train_batch(iter([batch]))))
            if s == 0:
                eng.save_checkpoint(save_dir)
        res = {"losses": losses, "seconds": time.perf_counter() - t0,
               "launches": sum(op_builder.launches.values())}
        comm.destroy_distributed()
    except BaseException:                       # noqa: BLE001 — reported
        res = {"error": traceback.format_exc()}
    with open(out, "wb") as fh:
        pickle.dump(res, fh)


def _train_conf(stage: int, zero=None, remat: str = "none",
                **extra) -> dict:
    """Phase 12's configuration of phase 7's engine (phase 13's too)."""
    conf = {"train_micro_batch_size_per_gpu": TRAIN_MICRO,
            "gradient_accumulation_steps": TRAIN_GAS,
            "optimizer": {"type": "adamw", "params": {
                "lr": 1e-4, "weight_decay": 0.1}},
            "gradient_clipping": 1.0, "bf16": {"enabled": True},
            "activation_checkpointing": {"policy": remat},
            "attention_impl": "auto", "steps_per_print": 1000,
            "zero_optimization": dict({"stage": stage}, **(zero or {})),
            "comms_logger": {"enabled": True}}
    conf.update(extra)
    return conf


def _train_batch(vocab):
    """Phase 7's fixed batch: TRAIN_GAS micro-batches of TRAIN_MICRO x
    TRAIN_SEQ tokens."""
    rng = np.random.default_rng(7)
    return [{"input_ids": rng.integers(0, vocab, size=(
        TRAIN_MICRO, TRAIN_SEQ)).astype(np.int32)} for _ in range(TRAIN_GAS)]


def phase_train_dp(smi: str) -> dict:
    """Data parallel and ZeRO-1/2/3 over torch.distributed. The card is one
    rank of a real NCCL group (NCCL refuses two ranks on one card), so
    every collective the engine issues runs at world 1; dp 2 runs on the
    CPU over gloo. (a) phase 7's Llama-3 1B engine in bf16 at stages 0, 1,
    2, 3 and 3 with ``overlap_comm``: ms a step, peak HBM, the comms
    logger's bytes a step by op, K1/K3 launches; losses against stage
    0's within DP_LOSS_TOL. (b) Llama-3 1B's width at CPU_HOLD_DEPTH in fp32: the
    card at world 1 against the port on the CPU at dp 2 over gloo, whose
    ranks this phase starts while (a) runs (vocabulary cut to 32,000:
    ``DP_SMALL``); losses within DP_SMALL_TOL.
    (c) the card resumes the CPU's dp-2 save through ``elastic_resume`` at
    world 1; the resumed losses within DP_SMALL_TOL of the uninterrupted
    CPU run. Returns (a)'s launches (the phase's main path)."""
    import gc
    import multiprocessing as mp
    import pickle
    import tempfile
    import torch
    from deepspeed_tpu_torch import (build_mesh, comm, initialize,
                                     llama3_config)
    from deepspeed_tpu_torch.comm.comms_logger import comms_logger
    from deepspeed_tpu_torch.elasticity import elastic_resume
    from deepspeed_tpu_torch.ops import op_builder
    gc.collect()
    room = OFFLOAD_HOST_LIMIT - _rss() - OFFLOAD_HOST_OTHER
    emit({"phase": "train_dp_host", "rss_bytes": _rss(),
          "mem_available": _meminfo()["MemAvailable"], "room_bytes": room,
          "cpu_ranks_need_bytes": DP_CPU_HOST_BYTES})
    assert room >= DP_CPU_HOST_BYTES, (
        f"phase 12: {room / 1e9:.1f} GB of host room for the CPU ranks, "
        f"{DP_CPU_HOST_BYTES / 1e9:.0f} GB needed")
    here = os.path.dirname(os.path.abspath(__file__))
    os.makedirs(os.path.join(here, "build"), exist_ok=True)
    work = tempfile.mkdtemp(prefix="train_dp_", dir=os.path.join(
        here, "build"))
    save_dir = os.path.join(work, "ckpt")
    outs = [os.path.join(work, f"cpu{r}.pkl") for r in range(2)]
    ctx = mp.get_context("spawn")
    cpu = [ctx.Process(target=_dp_cpu_rank, args=(
        r, 2, os.path.join(work, "gloo_store"), save_dir, outs[r]))
        for r in range(2)]
    t_cpu = time.perf_counter()
    for p in cpu:
        p.start()
    try:
        comm.init_distributed(init_method="file://" + os.path.join(
            work, "nccl_store"), num_processes=1, process_id=0)
        assert torch.distributed.get_backend() == "nccl"
        mesh = build_mesh(data=1)
        # (a) the stages on phase 7's engine
        cfg = llama3_config(TRAIN_MODEL[0], **TRAIN_MODEL[1])
        batch = _train_batch(cfg.vocab_size)
        runs = {}
        op_builder.reset_launches()
        for name, stage, zero, remat in DP_RUNS:
            conf = _train_conf(stage, zero, remat)
            gc.collect()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            before = dict(op_builder.launches)
            eng = initialize(cfg, conf, generator=torch.Generator(
                device=DEV).manual_seed(0), device=DEV, mesh=mesh)[0]
            comms_logger.reset()
            losses, step_s = [], []
            for _ in range(DP_STEPS):
                t1 = time.perf_counter()
                losses.append(float(eng.train_batch(iter(batch))))
                step_s.append(time.perf_counter() - t1)
            plan = eng._overlap_plan
            runs[name] = {
                "stage": stage, "remat": remat, "losses": losses,
                "step_seconds": step_s,
                "ms_per_step": 1e3 * sum(step_s[1:]) / (DP_STEPS - 1),
                "peak_hbm_gb": torch.cuda.max_memory_allocated() / 1e9,
                "comm_bytes_per_step": {
                    op: b / DP_STEPS for op, b in
                    comms_logger.bytes_by_op().items()},
                "launches": {k: op_builder.launches[k] - before.get(k, 0)
                             for k in TRAIN_KERNELS},
                "overlap": None if plan is None else plan.describe()}
            del eng, plan
        launches = dict(op_builder.launches)
        comms_logger.enabled = False
        _TP1_TRAIN.update({n: runs[n] for n, _ in TP_TRAIN_STAGES})
        for name, run in runs.items():
            base = runs["stage0_remat_full" if run["remat"] == "full"
                        else "stage0"]["losses"]
            run["loss_rel_err"] = max(abs(a - b) / abs(b) for a, b in
                                      zip(run["losses"], base))
            emit(dict(run, phase="train_dp", run=name,
                      model="llama3-" + TRAIN_MODEL[0], dtype="bfloat16",
                      world=1, backend="nccl", nvidia_smi=smi))
        gc.collect()
        torch.cuda.empty_cache()
        # (b) the card at world 1 against the CPU at dp 2
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        small = _dp_small_model()
        data = _dp_small_data(small.vocab_size)
        conf = dict(_dp_small_conf(), train_micro_batch_size_per_gpu=2)
        before = dict(op_builder.launches)
        eng = initialize(small, conf, params=_dp_small_init(small),
                         device=DEV, mesh=mesh)[0]
        card = [float(eng.train_batch(iter([b]))) for b in data]
        card_launches = {k: op_builder.launches[k] - before.get(k, 0)
                         for k in TRAIN_KERNELS}
        del eng
        for p in cpu:
            p.join(max(0.0, DP_CPU_TIMEOUT_S - (time.perf_counter()
                                                - t_cpu)))
        cpu_res = []
        for r, (p, out) in enumerate(zip(cpu, outs)):
            assert not p.is_alive(), f"CPU rank {r} still running"
            with open(out, "rb") as fh:
                res = pickle.load(fh)
            assert "error" not in res, res["error"]
            cpu_res.append(res)
        want = cpu_res[0]["losses"]
        assert cpu_res[1]["losses"] == want, cpu_res
        # (c) resume the CPU's dp-2 save on the card at world 1
        fresh, agent, tag = elastic_resume(small, _dp_small_conf(),
                                           save_dir, world_size=1,
                                           device=DEV)
        agent.uninstall()
        resumed = [float(fresh.train_batch(iter([b]))) for b in data[1:]]
        resumed_geometry = (fresh.train_micro_batch_size_per_gpu,
                            fresh.gradient_accumulation_steps())
        del fresh
    finally:
        for p in cpu:
            if p.is_alive():
                p.kill()
                p.join()
        comm.destroy_distributed()
        import shutil
        shutil.rmtree(work, ignore_errors=True)
    rel = max(abs(a - b) / abs(b) for a, b in zip(card, want))
    rel_resume = max(abs(a - b) / abs(b) for a, b in zip(resumed, want[1:]))
    res = {"phase": "train_dp", "run": "card_vs_cpu_dp2",
           "model": f"llama3-1b-width-depth{CPU_HOLD_DEPTH}-vocab32k",
           "dtype": "float32",
           "losses_card": card, "losses_cpu_dp2": want,
           "loss_rel_err": rel, "resume_tag": tag,
           "resume_micro_gas": resumed_geometry,
           "losses_resumed": resumed, "resume_rel_err": rel_resume,
           "tol": DP_SMALL_TOL, "cpu_seconds": cpu_res[0]["seconds"],
           "cpu_launches": cpu_res[0]["launches"],
           "card_launches": card_launches}
    emit(res)
    for name, run in runs.items():
        assert all(np.isfinite(run["losses"])), (name, run["losses"])
        assert run["loss_rel_err"] <= DP_LOSS_TOL, (name, run)
        # each block's forward once a micro-batch (C6: stage 3 included),
        # twice under remat 'full' (the loop and the replay)
        want_fwd = cfg.num_layers * TRAIN_GAS * DP_STEPS * (
            2 if run["remat"] == "full" else 1)
        assert run["launches"]["flash_attention_fwd"] == want_fwd, run
        assert run["launches"]["flash_attention_bwd"] == \
            cfg.num_layers * TRAIN_GAS * DP_STEPS, run
        ops = run["comm_bytes_per_step"]
        assert ops.get("all_reduce", 0) > 0, (name, ops)
        if run["stage"] == 3:
            assert ops.get("all_gather", 0) > 0 and \
                ops.get("reduce_scatter", 0) > 0, (name, ops)
    assert runs["stage0"]["losses"][-1] < runs["stage0"]["losses"][0]
    assert tag == "global_step1" and resumed_geometry == (2, 1), res
    assert all(v > 0 for v in card_launches.values()), card_launches
    assert cpu_res[0]["launches"] == 0, cpu_res
    assert rel <= DP_SMALL_TOL and rel_resume <= DP_SMALL_TOL, res
    return launches


# ---------------------------------------------------------------------------
# 13. tensor parallelism and ZeRO++ (tp_zeropp)
# ---------------------------------------------------------------------------

#: phase 12's tp-1 runs of phase 7's engine, the reference of (b) and
#: (c)
_TP1_TRAIN: dict = {}
#: K6's calls inside the last ZeRO++ step of (c): (device ms, values,
#: dtype) each, for the kernel table
_K6_IN_STEP: list = []
#: (a) Llama-3 8B at phase 11's V1_LLAMA (full width, 16 of 32 layers),
#: its prompts (8 x 512) and seed, 16 greedy tokens, tp 2 against tp 1
TP_SERVE_NEW = 16
#: bf16 logits at tp 2 against tp 1: max |delta| over max
#: |logit|. Two right computations of these random-weight logits differ
#: by this much in bf16: phase 11 measured 4.8-6.1 % between the v1 and
#: the ragged engines on the same weights, 5.3 % between one prefill
#: chunk and two; tp 2 sums two bf16 partial products after each row-
#: parallel GEMM. Exactness is held in fp32 (TP_FP32)
TP_LOGIT_TOL = 8e-2
#: (a') Llama-3 8B's width at depth 2 in fp32 with TF32 off, 2 prompts of
#: 32 tokens, 4 greedy tokens: tp 2 against tp 1, logits within 1e-4
#: relative (the row-parallel sums in another order), tokens identical
TP_FP32 = {"layers": 2, "batch": 2, "prompt": 32, "new": 4, "tol": 1e-4}
#: (b) phase 7's engine at tp 2, stage 0, TP_TRAIN_STEPS steps (ms a
#: step: the last; the script's time limit); losses against phase 12's
#: tp-1 run's first steps within DP_LOSS_TOL. Stage 3 under TP (the
#: stage-3 loop over 'model'-sharded leaves) is held against the JAX
#: engine on the CPU (tests/test_torch_tensor_parallel.py), not here: on
#: gloo a step takes 7-9 s of the script's 1200 s
TP_TRAIN_STAGES = (("stage0", 0),)
TP_TRAIN_STEPS = 2
#: (b') DP_SMALL's model (Llama-3 1B width, CPU_HOLD_DEPTH, vocabulary 32,000)
#: in fp32 at stage 0: the card's two ranks against two CPU ranks, both
#: at tp 2 over gloo
TP_SMALL_TOL = 1e-4
#: (c) ZeRO++ on phase 7's engine at stage 2, exact against qwZ + qgZ,
#: DP_STEPS steps each; quantized losses within 2e-2 of the exact ones
ZEROPP_LOSS_TOL = 2e-2
TP_RANK_TIMEOUT_S = 900.0
#: torch threads of each (b') CPU rank: they run beside the card's ranks,
#: whose gloo collectives stage every tensor through the host's cores
TP_CPU_THREADS = 2


# ---------------------------------------------------------------------------
# phase 14: expert parallelism, in phase 13's two card ranks
# ---------------------------------------------------------------------------

#: (a): phase 11 (e)'s int8 Mixtral (16 of 32 layers, 8 x 256 prompts,
#: seeds 67/68, 16 new tokens) through init_inference at ep 2, each rank
#: drawing only its experts; prefill logits against phase 11 (e)'s within
#: TP_LOGIT_TOL (the bf16 spread two right engines show on these
#: weights), greedy tokens matched reported
EP_SERVE_NEW = V1_MOE_NEW
#: (a'): Mixtral's width at depth 2 in fp32 with TF32 off, 2 prompts of
#: 32 tokens, 4 greedy tokens: ep 2 against ep 1, logits within 2e-4
EP_FP32 = {"layers": 2, "batch": 2, "prompt": 32, "new": 4, "tol": 2e-4}
#: (b): the 1B/8e bench model with the capacity layer (capacity factor
#: 1.0, tokens dropped) at stage 1, ep 2, a global batch of 2 x 2048 (one
#: row a rank), against ep 1 at world 1 on the same batches; bf16 losses
#: within DP_LOSS_TOL
EP_TRAIN_ROWS, EP_TRAIN_STEPS = 2, 2
EP_CAPACITY = {"impl": "capacity", "capacity_factor": 1.0,
               "drop_tokens": True, "use_rts": False}
#: (b'): its width at depth 2 in fp32, a global batch of 2 x 128, the
#: card's ranks against two CPU ranks at ep 2 (TP_SMALL_TOL)
EP_SMALL = dict(MOE_TRAIN_MODEL, num_layers=2, max_seq_len=256)
EP_SMALL_SEQ = 128
#: (c): phase 8's engine (the 1B/8e, dropless, 8 x 2048) at tp 2, stage
#: 0, 2 steps, against phase 8's tp-1 run: bf16 losses within DP_LOSS_TOL
EP_TP_STEPS = 2
#: the references phase 14 holds its ranks to: phase 11 (e)'s int8 run
#: (prefill logits of the last position, greedy tokens) and phase 8's run
_V1_MOE_INT8: dict = {}
_MOE_TP1: dict = {}
#: phase 14's launches (the ``ep`` path of the kernel table)
_EP_LAUNCHES: dict = {}


def _ep_conf(micro, ep, stage, bf16=True, **extra):
    conf = _moe_train_conf(micro, 1, 1e-4, bf16=bf16,
                           activation_checkpointing={"policy": "none"},
                           **extra)
    conf["moe"] = dict(EP_CAPACITY, enabled=True, ep_size=ep)
    conf["zero_optimization"] = {"stage": stage}
    return conf


def _ep_train_batches(vocab, rows, seq, steps, seed):
    rng = np.random.default_rng(seed)
    return [[{"input_ids": rng.integers(0, vocab, size=(rows, seq))
              .astype(np.int32)}] for _ in range(steps)]


def _ep_small_data():
    from deepspeed_tpu_torch.models.mixtral import mixtral_config
    cfg = mixtral_config("tiny", **EP_SMALL)
    return _ep_train_batches(cfg.vocab_size, 2, EP_SMALL_SEQ, DP_STEPS, 14)


def _ep_small_run(device):
    """(b')'s run on the live mesh (ep 2): fp32 losses."""
    import torch
    from deepspeed_tpu_torch import initialize
    from deepspeed_tpu_torch.models.mixtral import mixtral_config
    from deepspeed_tpu_torch.models.transformer import init_params
    cfg = mixtral_config("tiny", **EP_SMALL)
    init = init_params(cfg, torch.Generator().manual_seed(14),
                       torch.float32, "cpu")
    eng = initialize(cfg, _ep_conf(1, 2, 1, bf16=False), params=init,
                     device=device)[0]
    return [float(eng.train_batch(iter(b))) for b in _ep_small_data()]


class _DropCount:
    """Counts the capacity slots kept and the choices routed by the split
    batch's gating (``parallel.moe.topk_gating_rows``) while installed."""

    def __init__(self):
        from deepspeed_tpu_torch.parallel import moe as tm
        self.tm, self.inner, self.kept, self.routed = tm, \
            tm.topk_gating_rows, 0, 0

    def __enter__(self):
        def spy(logits_all, logits, lo, k, capacity, **kw):
            d, c, a = self.inner(logits_all, logits, lo, k, capacity, **kw)
            self.kept += int(d.sum())
            self.routed += logits.shape[0] * k
            return d, c, a
        self.tm.topk_gating_rows = spy
        return self

    def __exit__(self, *exc):
        self.tm.topk_gating_rows = self.inner


def _ep_counts():
    """Every launch counter (totals, forms, K5's regimes and shapes) and
    the comms logger, set to 0."""
    from deepspeed_tpu_torch.comm.comms_logger import comms_logger
    from deepspeed_tpu_torch.ops import grouped_matmul as tg
    from deepspeed_tpu_torch.ops import op_builder
    from deepspeed_tpu_torch.ops import quantized_linear as tq
    op_builder.reset_launches()
    tq.reset_regime_launches()
    tg.reset_form_launches()
    comms_logger.enabled = True
    comms_logger.reset()


def _ep_read():
    """The counters since :func:`_ep_counts`."""
    from deepspeed_tpu_torch.comm.comms_logger import comms_logger
    from deepspeed_tpu_torch.ops import grouped_matmul as tg
    from deepspeed_tpu_torch.ops import op_builder
    from deepspeed_tpu_torch.ops import quantized_linear as tq
    return {"launches": dict(op_builder.launches),
            "forms": {k: dict(v) for k, v in tg.form_launches.items()},
            "regimes": {k: dict(v) for k, v in tq.regime_launches.items()},
            "shapes": {k: dict(v) for k, v in tq.shape_launches.items()},
            "bytes": comms_logger.bytes_by_op()}


def _ep_card(rank, world):
    """Phase 14 on a card rank: (a) EP serving, (a') its fp32 twin, (b)
    EP training, (b') its fp32 twin against the CPU ranks, (c) MoE under
    TP. Each part's counters are read around its own calls; after the
    counted windows rank 0 holds K5c at (a)'s G 4 shapes and the five
    grouped kernels at (c)'s f 1408 against their plain versions."""
    import gc
    import torch
    from deepspeed_tpu_torch import build_mesh, init_inference, initialize
    from deepspeed_tpu_torch.comm.comms_logger import comms_logger
    from deepspeed_tpu_torch.models.mixtral import mixtral_config
    t0 = time.perf_counter()
    out = {}
    build_mesh(expert=world)
    # (a) serving at ep 2, the router's fp32 logits without TF32, as
    # phase 11 (e) computes them (TF32 moves near-tied routing choices)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = mixtral_config(V1_MIXTRAL[0], **V1_MIXTRAL[1])
    prompts = np.random.default_rng(67).integers(0, cfg.vocab_size, size=(
        V1_MOE_BATCH, V1_MOE_PROMPT)).astype(np.int32)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    eng = init_inference(cfg, {"dtype": "bfloat16", "weight_quant": "int8"},
                         generator=torch.Generator(device=DEV)
                         .manual_seed(68), device=DEV)
    _ep_counts()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    with torch.no_grad():
        logits = eng.forward(prompts)[:, -1].float().cpu().numpy()
    t2 = time.perf_counter()
    prefill_a2a = comms_logger.bytes_by_op().get("all_to_all", 0)
    tokens = eng.generate(prompts, max_new_tokens=EP_SERVE_NEW)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    counts = _ep_read()
    comms_logger.enabled = False
    out["serve"] = {
        "logits": logits, "tokens": tokens[:, V1_MOE_PROMPT:],
        "prefill_ms": 1e3 * (t2 - t1),
        "decode_ms_per_token": 1e3 * ((t3 - t2) - (t2 - t1))
        / (EP_SERVE_NEW - 1),
        # generate prefills the same rows again before its decode steps
        "prefill_a2a_bytes": prefill_a2a,
        "a2a_bytes_per_token": (counts["bytes"].get("all_to_all", 0)
                                - 2 * prefill_a2a) / (EP_SERVE_NEW - 1),
        "peak_hbm_gb": torch.cuda.max_memory_allocated() / 1e9,
        "wg_local": tuple(eng.params["layers"]["moe"]["wg"].shape),
        "counts": {k: counts[k] for k in ("launches", "regimes",
                                          "shapes")}}
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    if rank == 0:
        # after the counted window: K5c at (a)'s shapes (G 4 a rank; M the
        # exchanged slots of a layer: 2 ranks x 1024 prefill, 2 x 4 decode)
        rng = np.random.default_rng(69)
        out["k5c_vs_plain"] = [
            check_qmm(f"k5c_ep_g4_m{m}_{k}x{n}", rng, "int8", m, k, n,
                      torch.bfloat16, groups=4, time_it=False)
            for m, k, n in ((2048, 4096, 14336), (2048, 14336, 4096),
                            (8, 4096, 14336))]
    # (a') fp32 at depth 2
    out["fp32"] = _ep_fp32_serve()
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    # (b) training at ep 2, stage 1
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    tcfg = mixtral_config("tiny", **MOE_TRAIN_MODEL)
    eng = initialize(tcfg, _ep_conf(EP_TRAIN_ROWS // world, world, 1),
                     generator=torch.Generator(device=DEV).manual_seed(13),
                     device=DEV)[0]
    batches = _ep_train_batches(tcfg.vocab_size, EP_TRAIN_ROWS,
                                MOE_TRAIN_SEQ, EP_TRAIN_STEPS, 13)
    _ep_counts()
    losses, step_s = [], []
    with _DropCount() as drops:
        for b in batches:
            t1 = time.perf_counter()
            losses.append(float(eng.train_batch(iter(b))))
            step_s.append(time.perf_counter() - t1)
    train = _ep_read()
    comms_logger.enabled = False
    out["train"] = {
        "losses": losses, "step_seconds": step_s,
        "ms_per_step": 1e3 * step_s[-1],
        "peak_hbm_gb": torch.cuda.max_memory_allocated() / 1e9,
        "dropped_per_step": (drops.routed - drops.kept) / EP_TRAIN_STEPS,
        "routed_per_step": drops.routed / EP_TRAIN_STEPS,
        "comm_bytes_per_step": {op: b / EP_TRAIN_STEPS
                                for op, b in train["bytes"].items()},
        "wg_local": tuple(eng.params["layers"]["moe"]["wg"].shape),
        "counts": {k: train[k] for k in ("launches", "forms")}}
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    # (b') fp32 at depth 2 against the CPU ranks
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out["small"] = _ep_small_run(DEV)
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    # (c) MoE under TP: phase 8's engine at tp 2
    build_mesh(model=world)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    conf = _moe_train_conf(MOE_TRAIN_MICRO, 1, 1e-4, bf16=True,
                           chunked_ce_budget_mb=256, ce_logits_dtype="bf16",
                           activation_checkpointing={"policy": "none"},
                           tensor_parallel={"tp_size": world})
    eng = initialize(tcfg, conf, generator=torch.Generator(
        device=DEV).manual_seed(11), device=DEV)[0]
    rng = np.random.default_rng(11)
    batch = [{"input_ids": rng.integers(0, tcfg.vocab_size, size=(
        MOE_TRAIN_MICRO, MOE_TRAIN_SEQ)).astype(np.int32)}]
    _ep_counts()
    losses, step_s = [], []
    for _ in range(EP_TP_STEPS):
        t1 = time.perf_counter()
        losses.append(float(eng.train_batch(iter(batch))))
        step_s.append(time.perf_counter() - t1)
    tp = _ep_read()
    comms_logger.enabled = False
    moe = eng.params["layers"]["moe"]
    out["tp"] = {
        "losses": losses, "step_seconds": step_s,
        "ms_per_step": 1e3 * step_s[-1],
        "peak_hbm_gb": torch.cuda.max_memory_allocated() / 1e9,
        "comm_bytes_per_step": {op: b / EP_TP_STEPS
                                for op, b in tp["bytes"].items()},
        "f_local": moe["wg"].shape[-1],
        "local_heads": eng.params["layers"]["attn"]["wq"].shape[-1]
        // tcfg.head_dim,
        "local_kv_heads": eng.params["layers"]["attn"]["wk"].shape[-1]
        // tcfg.head_dim,
        "counts": {k: tp[k] for k in ("launches", "forms")}}
    del eng, moe
    gc.collect()
    torch.cuda.empty_cache()
    if rank == 0:
        # after the counted window: the five grouped kernels at f 1408
        rng = np.random.default_rng(70)
        out["grouped_vs_plain"] = {
            "fwd": check_grouped("gmm_tp2_1b8e_f1408", rng, 16384, 2, 8,
                                 1024, 1408, torch.bfloat16, True),
            "bwd": check_grouped_bwd("gmm_bwd_tp2_1b8e_f1408", rng, 16384,
                                     2, 8, 1024, 1408, torch.bfloat16,
                                     True)}
    out["seconds"] = time.perf_counter() - t0
    return out


def _ep_fp32_serve() -> dict:
    """(a'): fp32 logits of the last prompt position and greedy tokens of
    Mixtral's width at depth 2 on the live mesh (ep 1 without one)."""
    import torch
    from deepspeed_tpu_torch import init_inference
    from deepspeed_tpu_torch.models.mixtral import mixtral_config
    cfg = mixtral_config(V1_MIXTRAL[0], num_layers=EP_FP32["layers"])
    prompts = np.random.default_rng(64).integers(
        0, cfg.vocab_size, size=(EP_FP32["batch"], EP_FP32["prompt"])
    ).astype(np.int32)
    eng = init_inference(cfg, {"dtype": "float32"}, generator=torch.Generator(
        device=DEV).manual_seed(65), device=DEV)
    with torch.no_grad():
        logits = eng.forward(prompts)[:, -1].float().cpu().numpy()
    tokens = eng.generate(prompts, max_new_tokens=EP_FP32["new"])
    del eng
    return {"logits": logits, "tokens": tokens}


def _ep_references() -> dict:
    """Phase 14's ep-1 references, made in the main process at world 1:
    (a')'s fp32 serve and (b)'s training run on the same batches."""
    import gc
    import torch
    from deepspeed_tpu_torch import initialize
    from deepspeed_tpu_torch.models.mixtral import mixtral_config
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    fp32 = _ep_fp32_serve()
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    tcfg = mixtral_config("tiny", **MOE_TRAIN_MODEL)
    eng = initialize(tcfg, _ep_conf(EP_TRAIN_ROWS, 1, 1),
                     generator=torch.Generator(device=DEV).manual_seed(13),
                     device=DEV)[0]
    losses, step_s = [], []
    for b in _ep_train_batches(tcfg.vocab_size, EP_TRAIN_ROWS,
                               MOE_TRAIN_SEQ, EP_TRAIN_STEPS, 13):
        t1 = time.perf_counter()
        losses.append(float(eng.train_batch(iter(b))))
        step_s.append(time.perf_counter() - t1)
    train = {"losses": losses, "ms_per_step": 1e3 * step_s[-1],
             "peak_hbm_gb": torch.cuda.max_memory_allocated() / 1e9}
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    return {"fp32": fp32, "train": train}


def _ep_report(smi, ranks, cpu_res, refs) -> dict:
    """Phase 14's lines and gates from the card ranks' results; returns
    the path's launches (both ranks) and adds its forms and K5 shapes to
    the kernel table's counters."""
    from deepspeed_tpu_torch.ops import op_builder
    launches = {k: 0 for k in op_builder.launches}
    r0 = ranks[0]["ep"]
    # (a)
    want = _V1_MOE_INT8
    rel = float(np.abs(r0["serve"]["logits"] - want["logits"]).max()
                / np.abs(want["logits"]).max())
    serve = {
        "prefill_logits_rel_err_vs_ep1": rel, "tol": TP_LOGIT_TOL,
        "greedy_tokens_matched": int((r0["serve"]["tokens"]
                                      == want["tokens"]).sum()),
        "greedy_tokens": int(want["tokens"].size),
        "ranks_agree": bool(np.array_equal(
            r0["serve"]["tokens"], ranks[1]["ep"]["serve"]["tokens"])),
        "prefill_ms_per_rank": [r["ep"]["serve"]["prefill_ms"]
                                for r in ranks],
        "decode_ms_per_token_per_rank": [
            r["ep"]["serve"]["decode_ms_per_token"] for r in ranks],
        "prefill_all_to_all_bytes": r0["serve"]["prefill_a2a_bytes"],
        "all_to_all_bytes_per_token": r0["serve"]["a2a_bytes_per_token"],
        "peak_hbm_gb_per_rank": [r["ep"]["serve"]["peak_hbm_gb"]
                                 for r in ranks],
        "wg_local": r0["serve"]["wg_local"],
        "k5c_by_shape": r0["serve"]["counts"]["shapes"][
            "quantized_matmul_batched"],
        "launches_per_rank": [{k: v for k, v in r["ep"]["serve"]["counts"][
            "launches"].items() if v} for r in ranks],
        "k5c_vs_plain": [{k: c[k] for k in ("check", "shape",
                                            "max_abs_err")}
                         for c in r0["k5c_vs_plain"]]}
    emit(dict(serve, phase="ep", part="a", model=f"mixtral-8x7b-"
              f"{V1_MIXTRAL[1]['num_layers']}L", ep=2, weight_quant="int8",
              batch=V1_MOE_BATCH, prompt=V1_MOE_PROMPT, new=EP_SERVE_NEW,
              backend="gloo", nvidia_smi=smi))
    # (a')
    f0, fref = r0["fp32"], refs["fp32"]
    fp32_rel = float(np.abs(f0["logits"] - fref["logits"]).max()
                     / np.abs(fref["logits"]).max())
    emit({"phase": "ep", "part": "a_fp32", "ep": 2,
          "model": "mixtral-8x7b-width-depth2", "dtype": "float32",
          "logits_rel_err_vs_ep1": fp32_rel, "tol": EP_FP32["tol"],
          "tokens_equal": bool(np.array_equal(f0["tokens"],
                                              fref["tokens"]))})
    # (b)
    tr, tref = r0["train"], refs["train"]
    train_rel = max(abs(a - b) / abs(b)
                    for a, b in zip(tr["losses"], tref["losses"]))
    train = {
        "losses": tr["losses"], "losses_ep1": tref["losses"],
        "loss_rel_err_vs_ep1": train_rel, "tol": DP_LOSS_TOL,
        "ranks_agree": tr["losses"] == ranks[1]["ep"]["train"]["losses"],
        "dropped_per_step_per_rank": [r["ep"]["train"]["dropped_per_step"]
                                      for r in ranks],
        "routed_per_step_per_rank": [r["ep"]["train"]["routed_per_step"]
                                     for r in ranks],
        "ms_per_step_per_rank": [r["ep"]["train"]["ms_per_step"]
                                 for r in ranks],
        "ms_per_step_ep1": tref["ms_per_step"],
        "peak_hbm_gb_per_rank": [r["ep"]["train"]["peak_hbm_gb"]
                                 for r in ranks],
        "peak_hbm_gb_ep1": tref["peak_hbm_gb"],
        "comm_bytes_per_step": tr["comm_bytes_per_step"],
        "wg_local": tr["wg_local"],
        "launches_per_rank": [{k: v for k, v in r["ep"]["train"]["counts"][
            "launches"].items() if v} for r in ranks]}
    emit(dict(train, phase="ep", part="b", model="moe-1b-8e (bench.py:251)",
              ep=2, stage=1, moe=EP_CAPACITY, rows=EP_TRAIN_ROWS,
              seq=MOE_TRAIN_SEQ, dtype="bfloat16", backend="gloo",
              nvidia_smi=smi))
    # (b')
    small_rel = max(abs(a - b) / abs(b) for a, b in
                    zip(r0["small"], cpu_res[0]["ep_losses"]))
    emit({"phase": "ep", "part": "b_fp32", "ep": 2,
          "model": "moe-1b-8e-width-depth2", "dtype": "float32",
          "losses_card": r0["small"], "losses_cpu": cpu_res[0]["ep_losses"],
          "loss_rel_err": small_rel, "tol": TP_SMALL_TOL})
    # (c)
    tp, base = r0["tp"], _MOE_TP1["losses"][:EP_TP_STEPS]
    tp_rel = max(abs(a - b) / abs(b) for a, b in zip(tp["losses"], base))
    tpl = {
        "losses": tp["losses"], "losses_tp1": base,
        "loss_rel_err_vs_tp1": tp_rel, "tol": DP_LOSS_TOL,
        "ranks_agree": tp["losses"] == ranks[1]["ep"]["tp"]["losses"],
        "ms_per_step_per_rank": [r["ep"]["tp"]["ms_per_step"]
                                 for r in ranks],
        "ms_per_step_tp1": _MOE_TP1["ms_per_step"],
        "peak_hbm_gb_per_rank": [r["ep"]["tp"]["peak_hbm_gb"]
                                 for r in ranks],
        "peak_hbm_gb_tp1": _MOE_TP1["peak_mem_gb"],
        "comm_bytes_per_step": tp["comm_bytes_per_step"],
        "f_local": tp["f_local"], "local_heads": tp["local_heads"],
        "local_kv_heads": tp["local_kv_heads"],
        "launches_per_rank": [{k: v for k, v in r["ep"]["tp"]["counts"][
            "launches"].items() if v} for r in ranks],
        "grouped_forms_rank0": tp["counts"]["forms"],
        "grouped_vs_plain": {
            k: {c: v["max_abs_err"] for c, v in r0["grouped_vs_plain"][
                k].items() if isinstance(v, dict) and "max_abs_err" in v}
            for k in ("fwd", "bwd")}}
    emit(dict(tpl, phase="ep", part="c", model="moe-1b-8e (bench.py:251)",
              tp=2, stage=0, moe="dropless", dtype="bfloat16",
              backend="gloo", nvidia_smi=smi))
    emit({"phase": "ep", "part": "reduced",
          "cuts": ["(a) Mixtral at 16 of 32 layers (phase 11 (e)'s cut), "
                   "16 new tokens, decode eager on gloo",
                   "(b) a global batch of 2 x 2048 (the capacity layer's "
                   "[S, E, C] masks), 2 steps",
                   "(b') depth 2, 2 x 128 tokens (CPU time)",
                   "(c) 2 steps (gloo through the host)"],
          "seconds_per_rank": [r["ep"]["seconds"] for r in ranks]})
    # the launches of every part on both ranks, by form and K5 shape too
    for r in ranks:
        ep = r["ep"]
        for part in (ep["serve"], ep["train"], ep["tp"]):
            for k, v in part["counts"]["launches"].items():
                launches[k] += v
            for k, forms in part["counts"].get("forms", {}).items():
                if k in GROUPED_FORM_LAUNCHES:
                    for f, c in forms.items():
                        GROUPED_FORM_LAUNCHES[k][f] += c
        for k, v in ep["serve"]["counts"]["regimes"].items():
            for f, c in v.items():
                QUANT_FORM_LAUNCHES[k][f] += c
        for k, v in ep["serve"]["counts"]["shapes"].items():
            for key, c in v.items():
                QUANT_SHAPE_LAUNCHES[k][key] = \
                    QUANT_SHAPE_LAUNCHES[k].get(key, 0) + c
    # gates
    assert rel <= TP_LOGIT_TOL and serve["ranks_agree"], serve
    assert serve["wg_local"][1] == 4, serve
    assert any(k.endswith("G4") for k in serve["k5c_by_shape"]), serve
    assert fp32_rel <= EP_FP32["tol"], fp32_rel
    assert np.array_equal(f0["tokens"], fref["tokens"])
    assert all(np.isfinite(tr["losses"])) and train["ranks_agree"], train
    assert train_rel <= DP_LOSS_TOL, train
    assert sum(train["dropped_per_step_per_rank"]) > 0, train
    assert small_rel <= TP_SMALL_TOL and cpu_res[0]["ep_launches"] == 0
    assert tp_rel <= DP_LOSS_TOL and tpl["ranks_agree"], tpl
    assert tp["f_local"] == MOE_TRAIN_MODEL["intermediate_size"] // 2
    assert (tp["local_heads"], tp["local_kv_heads"]) == (4, 2), tpl
    for lr in tpl["launches_per_rank"]:
        for k, per in MOE_LAYER_LAUNCHES.items():
            assert lr[k] == per * MOE_TRAIN_MODEL["num_layers"] \
                * EP_TP_STEPS, (k, lr)
        for k in TRAIN_KERNELS:
            assert lr[k] == MOE_TRAIN_MODEL["num_layers"] * EP_TP_STEPS, lr
    return launches


def _tp_small_conf(tp: int):
    return {"train_micro_batch_size_per_gpu": 2,
            "gradient_accumulation_steps": 1,
            "optimizer": {"type": "adamw",
                          "params": {"lr": 1e-5, "weight_decay": 0.1}},
            "gradient_clipping": 1.0, "attention_impl": "auto",
            "zero_optimization": {"stage": 0},
            "tensor_parallel": {"tp_size": tp}}


def _tp_serve(eng, prompts, new) -> dict:
    """Prefill logits of the last position and the prefill's ms (at tp 1
    after a warm-up generate that captures the decode graph; a gloo
    group's eager decode has nothing to capture), greedy tokens, ms a
    decode token (a generate of ``new`` tokens less one prefill), and the
    bytes a decode token moves, by collective."""
    import torch
    from deepspeed_tpu_torch.comm.comms_logger import comms_logger
    from deepspeed_tpu_torch.models.transformer import init_kv_cache
    b, t = prompts.shape
    tok = torch.from_numpy(prompts).to(DEV)
    if eng._graphs:
        eng.generate(prompts, max_new_tokens=2)
    cache = init_kv_cache(eng.model_config, b, t, eng.dtype, DEV,
                          eng._kv_heads)
    comms_logger.enabled = True
    comms_logger.reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.no_grad():
        logits, _ = eng._step(tok, cache, 0)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    del cache
    b1 = comms_logger.bytes_by_op()
    comms_logger.reset()
    out = eng.generate(prompts, max_new_tokens=new)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    b2 = comms_logger.bytes_by_op()
    comms_logger.enabled = False
    return {"logits": logits.float().cpu().numpy(),
            "tokens": out[:, t:], "first": out[:, t:t + 1],
            "prefill_ms": 1e3 * (t1 - t0),
            "decode_ms_per_token": 1e3 * ((t2 - t1) - (t1 - t0))
            / (new - 1),
            "comm_bytes_per_token": {op: (v - b1.get(op, 0)) / (new - 1)
                                     for op, v in b2.items()}}


def _tp_fp32_serve(cfg_fn, tp: int) -> dict:
    """(a'): fp32 logits of the last prompt position and greedy tokens of
    Llama-3 8B's width at depth 2 at ``tp``."""
    import torch
    from deepspeed_tpu_torch import init_inference
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = cfg_fn(V1_LLAMA[0], num_layers=TP_FP32["layers"])
    prompts = np.random.default_rng(62).integers(
        0, cfg.vocab_size, size=(TP_FP32["batch"], TP_FP32["prompt"])
    ).astype(np.int32)
    conf = {"dtype": "float32"}
    if tp > 1:
        conf["tensor_parallel"] = {"tp_size": tp}
    eng = init_inference(cfg, conf, generator=torch.Generator(
        device=DEV).manual_seed(63), device=DEV)
    with torch.no_grad():
        logits = eng.forward(prompts)[:, -1].float().cpu().numpy()
    tokens = eng.generate(prompts, max_new_tokens=TP_FP32["new"])
    del eng
    return {"logits": logits, "tokens": tokens}


def _tp_card_rank(rank, world, store, out, runs_small):
    """A tensor-parallel rank on the card, over gloo (the probe of
    tools/gloo_cuda_probe.py: NCCL refuses two ranks on one card, gloo
    takes CUDA tensors): (a) Llama-3 8B served at tp 2, bf16 and int8;
    (b) phase 7's engine at tp 2, stage 0; (b') DP_SMALL's model
    in fp32 at tp 2. Writes its results to ``out``."""
    import gc
    import pickle
    import traceback
    import torch
    torch.set_num_threads(2)
    try:
        torch.cuda.set_device(0)
        from deepspeed_tpu_torch import (build_mesh, comm, init_inference,
                                         initialize, llama3_config)
        from deepspeed_tpu_torch.comm.comms_logger import comms_logger
        from deepspeed_tpu_torch.ops import op_builder
        comm.init_distributed(dist_backend="gloo",
                              init_method="file://" + store,
                              num_processes=world, process_id=rank,
                              device=DEV, timeout=int(TP_RANK_TIMEOUT_S))
        build_mesh(model=world)
        res = {"serve": {}, "train": {}, "launches": {}}
        # (a) serving
        cfg = llama3_config(V1_LLAMA[0], **V1_LLAMA[1])
        prompts = np.random.default_rng(60).integers(
            0, cfg.vocab_size, size=(V1_BATCH, V1_PROMPT)).astype(np.int32)
        for mode in (None, "int8"):
            gc.collect()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            op_builder.reset_launches()
            conf = {"dtype": "bfloat16", "tensor_parallel": {"tp_size": 2}}
            if mode:
                conf["weight_quant"] = mode
            eng = init_inference(cfg, conf, generator=torch.Generator(
                device=DEV).manual_seed(61), device=DEV)
            got = _tp_serve(eng, prompts, TP_SERVE_NEW)
            got.update(peak_hbm_gb=torch.cuda.max_memory_allocated() / 1e9,
                       launches=dict(op_builder.launches),
                       wq_local=tuple(eng.params["layers"]["attn"]["wq"]
                                      .shape), graphs=eng._graphs)
            res["serve"][mode or "bf16"] = got
            del eng
        gc.collect()
        torch.cuda.empty_cache()
        res["fp32"] = _tp_fp32_serve(llama3_config, world)
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True
        # (b) training, phase 7's engine at tp 2
        cfg = llama3_config(TRAIN_MODEL[0], **TRAIN_MODEL[1])
        batch = _train_batch(cfg.vocab_size)
        for name, stage in TP_TRAIN_STAGES:
            gc.collect()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            op_builder.reset_launches()
            eng = initialize(cfg, _train_conf(
                stage, tensor_parallel={"tp_size": world}),
                generator=torch.Generator(device=DEV).manual_seed(0),
                device=DEV)[0]
            comms_logger.reset()
            losses, step_s = [], []
            for _ in range(TP_TRAIN_STEPS):
                t1 = time.perf_counter()
                losses.append(float(eng.train_batch(iter(batch))))
                step_s.append(time.perf_counter() - t1)
            res["train"][name] = {
                "losses": losses, "step_seconds": step_s,
                "ms_per_step": 1e3 * sum(step_s[1:]) / (TP_TRAIN_STEPS - 1),
                "peak_hbm_gb": torch.cuda.max_memory_allocated() / 1e9,
                "comm_bytes_per_step": {
                    op: b / TP_TRAIN_STEPS for op, b in
                    comms_logger.bytes_by_op().items()},
                "launches": dict(op_builder.launches),
                "local_heads": eng.params["layers"]["attn"]["wq"].shape[-1]
                // cfg.head_dim}
            del eng
        comms_logger.enabled = False
        # (b') fp32 at depth 2 against the CPU ranks
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        small = _dp_small_model()
        eng = initialize(small, _tp_small_conf(world),
                         params=_dp_small_init(small), device=DEV)[0]
        res["small"] = [float(eng.train_batch(iter([b])))
                        for b in runs_small]
        del eng
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True
        # phase 14 in the same two ranks
        res["ep"] = _ep_card(rank, world)
        # phase 15 (a) in the same two ranks
        res["sp"] = _sp_card(rank, world)
        # phase 16 in the same two ranks
        res["pp"] = _pp_card(rank, world)
        # phase 17 (a) in the same two ranks
        res["da"] = _da_card(rank, world)
        comm.destroy_distributed()
    except BaseException:                       # noqa: BLE001 — reported
        res = {"error": traceback.format_exc()}
    with open(out, "wb") as fh:
        pickle.dump(res, fh)


def _tp_cpu_rank(rank, world, store, out, runs_small):
    """(b')'s CPU side: the same fp32 run at tp 2 on two gloo ranks."""
    import pickle
    import traceback
    import torch
    torch.set_num_threads(TP_CPU_THREADS)
    from deepspeed_tpu_torch import build_mesh, comm, initialize
    from deepspeed_tpu_torch.ops import op_builder
    try:
        comm.init_distributed(init_method="file://" + store,
                              num_processes=world, process_id=rank,
                              device="cpu", timeout=int(TP_RANK_TIMEOUT_S))
        build_mesh(model=world)
        small = _dp_small_model()
        eng = initialize(small, _tp_small_conf(world),
                         params=_dp_small_init(small), device="cpu")[0]
        res = {"losses": [float(eng.train_batch(iter([b])))
                          for b in runs_small]}
        del eng
        # phase 14 (b'): the same ranks at ep 2
        build_mesh(expert=world)
        res["ep_losses"] = _ep_small_run("cpu")
        res["launches"] = res["ep_launches"] = sum(
            op_builder.launches.values())
        # phase 16 (c): the same ranks at pipe 2
        build_mesh(pipe=world)
        res["pp"] = _pp_small_run("cpu")
        comm.destroy_distributed()
    except BaseException:                       # noqa: BLE001 — reported
        res = {"error": traceback.format_exc()}
    with open(out, "wb") as fh:
        pickle.dump(res, fh)


def _k6_against_plain(x, q, s, block) -> dict:
    """K6's (q, scales) of a ZeRO++ buffer ``x`` against
    ``quantize_blocks_ref`` on the same values, bit for bit (phase 3's
    tolerance), a chunk of blocks at a time: blocks are independent, so
    the chunks give the plain version's output on the whole buffer."""
    from deepspeed_tpu_torch.ops.quantizer import quantize_blocks_ref
    n, step = x.numel(), block << 20
    qm = sm = 0
    err = 0.0
    for i in range(0, n, step):
        j = min(i + step, n)
        rq, rs = quantize_blocks_ref(x[i:j], block)
        qm += int((q[i:j] != rq).sum())
        sm += int((s[i // block:j // block] != rs).sum())
        err = max(err, float((q[i:j].float() - rq.float()).abs().max()))
        del rq, rs
    return {"dtype": str(x.dtype).replace("torch.", ""), "values": n,
            "block": block, "q_mismatches": qm, "scale_mismatches": sm,
            "max_abs_err": err, "tol": "bit-identical"}


def _zeropp_runs(smi: str) -> tuple:
    """(c): ZeRO++ on phase 7's engine at stage 2 over one NCCL rank,
    exact and qwZ + qgZ; K6's launches and device ms inside each step
    (CUDA events around each launch). After the counted steps of qwZ +
    qgZ, one more step holds each K6 call on that step's buffers (the
    bf16 parameters that qwZ gathers, the fp32 gradient that qgZ
    reduces) against its plain version."""
    import gc
    import torch
    from deepspeed_tpu_torch import build_mesh, initialize, llama3_config
    from deepspeed_tpu_torch.comm.comms_logger import comms_logger
    from deepspeed_tpu_torch.ops import op_builder, quantizer
    cfg = llama3_config(TRAIN_MODEL[0], **TRAIN_MODEL[1])
    batch = _train_batch(cfg.vocab_size)
    build_mesh(data=1)
    k6 = quantizer.quantize_blocks_kernel
    events = []
    #: K6 against its plain version on the step's buffers, when on
    checks = {"on": False, "done": []}

    def timed_k6(x, block=256):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        out = k6(x, block)
        ev[1].record()
        events.append((ev, x.numel(), str(x.dtype)))
        if checks["on"]:
            checks["done"].append(_k6_against_plain(x, *out, block))
        return out
    runs = {}
    launches = {k: 0 for k in op_builder.launches}
    quantizer.quantize_blocks_kernel = timed_k6
    try:
        for name, zero in (("exact", {}),
                           ("qwz_qgz", {"zero_quantized_weights": True,
                                        "zero_quantized_gradients": True})):
            gc.collect()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            eng = initialize(cfg, _train_conf(2, zero), generator=torch.Generator(
                device=DEV).manual_seed(0), device=DEV)[0]
            comms_logger.reset()
            op_builder.reset_launches()
            events.clear()
            losses, step_s, k6_ms = [], [], []
            for _ in range(DP_STEPS):
                t1 = time.perf_counter()
                losses.append(float(eng.train_batch(iter(batch))))
                torch.cuda.synchronize()
                step_s.append(time.perf_counter() - t1)
                k6_ms.append([(ev[0].elapsed_time(ev[1]), n, dt)
                              for ev, n, dt in events])
                events.clear()
            for k, v in op_builder.launches.items():
                launches[k] += v
            runs[name] = {
                "losses": losses, "step_seconds": step_s,
                "ms_per_step": 1e3 * sum(step_s[1:]) / (DP_STEPS - 1),
                "peak_hbm_gb": torch.cuda.max_memory_allocated() / 1e9,
                "comm_bytes_per_step": {
                    op: b / DP_STEPS for op, b in
                    comms_logger.bytes_by_op().items()},
                "k6_launches_per_step": op_builder.launches[
                    "quantize_blocks"] / DP_STEPS,
                "k6_calls": k6_ms[-1],
                "flat_values": eng._zeropp_padded if eng._zeropp else None}
            if eng._zeropp:
                # after the counts: K6 on this step's buffers against its
                # plain version (these launches are the comparison's)
                checks["on"] = True
                eng.train_batch(iter(batch))
                checks["on"] = False
                runs[name]["k6_vs_plain"] = list(checks["done"])
            del eng
    finally:
        quantizer.quantize_blocks_kernel = k6
        comms_logger.enabled = False
    exact, quant = runs["exact"], runs["qwz_qgz"]
    _K6_IN_STEP[:] = [{"ms": ms, "values": n, "dtype": dt}
                      for ms, n, dt in quant["k6_calls"]]
    quant["loss_rel_err_vs_exact"] = max(
        abs(a - b) / abs(b) for a, b in zip(quant["losses"],
                                            exact["losses"]))
    base = _TP1_TRAIN.get("stage0")
    for name, run in runs.items():
        if base is not None and name == "exact":
            run["loss_rel_err_vs_engine_stage0"] = max(
                abs(a - b) / abs(b) for a, b in zip(run["losses"],
                                                    base["losses"]))
        emit(dict(run, phase="tp_zeropp", part="c", run=name,
                  model="llama3-" + TRAIN_MODEL[0], dtype="bfloat16",
                  world=1, backend="nccl", nvidia_smi=smi))
    return runs, launches


def phase_tp_zeropp(smi: str) -> dict:
    """Tensor parallelism and ZeRO++. Two ranks share the card over gloo
    (tools/gloo_cuda_probe.py found every collective the TP path calls
    working on CUDA tensors; NCCL refuses two ranks on one card), so tp 2
    runs as two processes on it, each holding its shards. (a) Llama-3 8B
    through ``init_inference`` at tp 2, bf16 and int8 (``qmatmul_tp`` over
    K5a), against tp 1 on the same weights: prefill logits within
    TP_LOGIT_TOL of the largest, greedy tokens matched of TP_SERVE_NEW
    (reported: random-weight logits are nearly flat), the same at depth 2
    in fp32 within TP_FP32's tolerance with identical tokens, ms
    a token per rank (eager: a gloo group's collectives cannot be
    captured), peak HBM per rank, all-reduce bytes a token. (b) phase 7's
    engine at tp 2, stage 0, against phase 12's tp-1 run; K1/K3
    launches at 8 local heads. (b') fp32 at depth 2, the card's ranks
    against two CPU ranks, both tp 2, losses within TP_SMALL_TOL. (c)
    ZeRO++ at stage 2 on one NCCL rank: exact against qwZ + qgZ, K6
    inside the step, and K6 on the step's own buffers against its plain
    version. Returns the launches of (a)-(c)."""
    import gc
    import multiprocessing as mp
    import pickle
    import tempfile
    import torch
    from deepspeed_tpu_torch import comm, init_inference, llama3_config
    from deepspeed_tpu_torch.ops import op_builder
    here = os.path.dirname(os.path.abspath(__file__))
    os.makedirs(os.path.join(here, "build"), exist_ok=True)
    work = tempfile.mkdtemp(prefix="tp_", dir=os.path.join(here, "build"))
    small_data = _dp_small_data(_dp_small_model().vocab_size)
    ctx = mp.get_context("spawn")
    cpu_outs = [os.path.join(work, f"cpu{r}.pkl") for r in range(2)]
    cpu = [ctx.Process(target=_tp_cpu_rank, args=(
        r, 2, os.path.join(work, "cpu_store"), cpu_outs[r], small_data))
        for r in range(2)]
    card_outs = [os.path.join(work, f"card{r}.pkl") for r in range(2)]
    card = [ctx.Process(target=_tp_card_rank, args=(
        r, 2, os.path.join(work, "card_store"), card_outs[r], small_data))
        for r in range(2)]
    launches = {k: 0 for k in op_builder.launches}
    t_start = time.perf_counter()
    for p in cpu:
        p.start()
    try:
        # (c) ZeRO++ in this process, over one NCCL rank
        comm.init_distributed(init_method="file://" + os.path.join(
            work, "nccl_store"), num_processes=1, process_id=0)
        zpp, zl = _zeropp_runs(smi)
        for k, v in zl.items():
            launches[k] += v
        comm.destroy_distributed()
        gc.collect()
        torch.cuda.empty_cache()
        # (a)'s tp-1 reference in this process (one device, no group)
        cfg = llama3_config(V1_LLAMA[0], **V1_LLAMA[1])
        prompts = np.random.default_rng(60).integers(
            0, cfg.vocab_size, size=(V1_BATCH, V1_PROMPT)).astype(np.int32)
        t_ref = time.perf_counter()
        ref = {}
        for mode in (None, "int8"):
            conf = {"dtype": "bfloat16"}
            if mode:
                conf["weight_quant"] = mode
            torch.cuda.reset_peak_memory_stats()
            eng = init_inference(cfg, conf, generator=torch.Generator(
                device=DEV).manual_seed(61), device=DEV)
            ref[mode or "bf16"] = dict(
                _tp_serve(eng, prompts, TP_SERVE_NEW),
                peak_hbm_gb=torch.cuda.max_memory_allocated() / 1e9)
            del eng
            gc.collect()
            torch.cuda.empty_cache()
        ref_fp32 = _tp_fp32_serve(llama3_config, 1)
        ref_seconds = time.perf_counter() - t_ref
        gc.collect()
        torch.cuda.empty_cache()
        # phase 14's ep-1 references, and those of earlier phases
        t_ref = time.perf_counter()
        ep_refs = _ep_references()
        ep_ref_seconds = time.perf_counter() - t_ref
        gc.collect()
        torch.cuda.empty_cache()
        # phase 15 (a)'s sp-1 reference
        _SP1.clear()
        _SP1.update(_sp_reference())
        gc.collect()
        torch.cuda.empty_cache()
        # phase 16 (a)'s pipe-1 reference
        _PP1.clear()
        _PP1.update(_pp_reference())
        gc.collect()
        torch.cuda.empty_cache()
        # phase 17 (a)'s world-1 references
        _DA1.clear()
        _DA1.update(_da_reference())
        gc.collect()
        torch.cuda.empty_cache()
        # (a), (b), (b') on the card's two ranks
        for p in card:
            p.start()
        for p in card + cpu:
            p.join(max(0.0, TP_RANK_TIMEOUT_S - (time.perf_counter()
                                                 - t_start)))
        got = []
        for p, out in zip(card + cpu, card_outs + cpu_outs):
            assert not p.is_alive(), "a tensor-parallel rank still runs"
            with open(out, "rb") as fh:
                r = pickle.load(fh)
            assert "error" not in r, r["error"]
            got.append(r)
    finally:
        for p in card + cpu:
            if p.is_alive():
                p.kill()
                p.join()
        comm.destroy_distributed()
        import shutil
        shutil.rmtree(work, ignore_errors=True)
    ranks, cpu_res = got[:2], got[2:]
    # (a)
    serve = {}
    for mode, want in ref.items():
        r0 = ranks[0]["serve"][mode]
        rel = float(np.abs(r0["logits"] - want["logits"]).max()
                    / np.abs(want["logits"]).max())
        match = int((r0["tokens"] == want["tokens"]).sum())
        serve[mode] = {
            "prefill_logits_rel_err_vs_tp1": rel,
            "greedy_tokens_matched": match,
            "greedy_tokens": int(want["tokens"].size),
            "first_token_matched": int((r0["first"] == want["first"]).sum()),
            "ranks_agree": bool(np.array_equal(
                r0["tokens"], ranks[1]["serve"][mode]["tokens"])),
            "decode_ms_per_token_per_rank": [
                r["serve"][mode]["decode_ms_per_token"] for r in ranks],
            "decode_ms_per_token_tp1": want["decode_ms_per_token"],
            "prefill_ms_per_rank": [r["serve"][mode]["prefill_ms"]
                                    for r in ranks],
            "prefill_ms_tp1": want["prefill_ms"],
            "peak_hbm_gb_per_rank": [r["serve"][mode]["peak_hbm_gb"]
                                     for r in ranks],
            "peak_hbm_gb_tp1": want["peak_hbm_gb"],
            "comm_bytes_per_token": r0["comm_bytes_per_token"],
            "wq_local": r0["wq_local"], "graphs": r0["graphs"],
            "launches_per_rank": [{k: v for k, v in
                                   r["serve"][mode]["launches"].items()
                                   if v} for r in ranks]}
        emit(dict(serve[mode], phase="tp_zeropp", part="a",
                  model="llama3-8b", tp=2, weight_quant=mode,
                  batch=V1_BATCH, prompt=V1_PROMPT, new=TP_SERVE_NEW,
                  backend="gloo", nvidia_smi=smi))
    # (a')
    f0 = ranks[0]["fp32"]
    fp32_rel = float(np.abs(f0["logits"] - ref_fp32["logits"]).max()
                     / np.abs(ref_fp32["logits"]).max())
    emit({"phase": "tp_zeropp", "part": "a_fp32", "tp": 2,
          "model": "llama3-8b-width-depth2", "dtype": "float32",
          "logits_rel_err_vs_tp1": fp32_rel, "tol": TP_FP32["tol"],
          "tp1_reference_seconds": ref_seconds,
          "tokens_equal": bool(np.array_equal(f0["tokens"],
                                              ref_fp32["tokens"])),
          "ranks_agree": bool(np.array_equal(
              f0["tokens"], ranks[1]["fp32"]["tokens"]))})
    # (b)
    train_heads = llama3_config(TRAIN_MODEL[0], **TRAIN_MODEL[1]).num_heads
    train = {}
    for name, _ in TP_TRAIN_STAGES:
        r0 = ranks[0]["train"][name]
        base = _TP1_TRAIN[name]["losses"][:TP_TRAIN_STEPS]
        train[name] = {
            "losses": r0["losses"], "losses_tp1": base,
            "loss_rel_err_vs_tp1": max(abs(a - b) / abs(b)
                                       for a, b in zip(r0["losses"], base)),
            "ranks_agree": r0["losses"] == ranks[1]["train"][name]["losses"],
            "ms_per_step_per_rank": [r["train"][name]["ms_per_step"]
                                     for r in ranks],
            "ms_per_step_tp1": _TP1_TRAIN[name]["ms_per_step"],
            "peak_hbm_gb_per_rank": [r["train"][name]["peak_hbm_gb"]
                                     for r in ranks],
            "peak_hbm_gb_tp1": _TP1_TRAIN[name]["peak_hbm_gb"],
            "comm_bytes_per_step": r0["comm_bytes_per_step"],
            "local_heads": r0["local_heads"],
            "launches_per_rank": [{k: r["train"][name]["launches"][k]
                                   for k in TRAIN_KERNELS} for r in ranks]}
        emit(dict(train[name], phase="tp_zeropp", part="b",
                  model="llama3-" + TRAIN_MODEL[0], tp=2, stage=name,
                  dtype="bfloat16", backend="gloo", nvidia_smi=smi))
    # (b')
    small_rel = max(abs(a - b) / abs(b) for a, b in
                    zip(ranks[0]["small"], cpu_res[0]["losses"]))
    emit({"phase": "tp_zeropp", "part": "b_fp32", "tp": 2,
          "model": f"llama3-1b-width-depth{CPU_HOLD_DEPTH}-vocab32k",
          "dtype": "float32", "losses_card": ranks[0]["small"], "losses_cpu": cpu_res[0][
              "losses"], "loss_rel_err": small_rel, "tol": TP_SMALL_TOL,
          "cpu_launches": cpu_res[0]["launches"]})
    emit({"phase": "tp_zeropp", "part": "reduced",
          "cuts": [f"(b') depth {CPU_HOLD_DEPTH} and vocabulary 32,000 "
                   "(DP_SMALL: CPU time)",
                   "(a) 16 of 32 layers (phase 11's V1_LLAMA), 16 new "
                   "tokens (phase 11: 128), decode eager on gloo",
                   "(b) stage 0 only, 2 steps (the script's time limit; "
                   "stage 3 under TP is held on the CPU)"]})
    # the launches of (a) and (b) on both ranks, and (c)'s
    for r in ranks:
        for part in list(r["serve"].values()) + list(r["train"].values()):
            for k, v in part["launches"].items():
                launches[k] += v
    for mode, s in serve.items():
        assert s["prefill_logits_rel_err_vs_tp1"] <= TP_LOGIT_TOL, (mode, s)
        assert s["ranks_agree"], s
        assert s["wq_local"][-1] * 2 == cfg.q_dim, s
    assert fp32_rel <= TP_FP32["tol"], fp32_rel
    assert np.array_equal(f0["tokens"], ref_fp32["tokens"])
    assert ranks[0]["serve"]["int8"]["launches"]["quantized_matmul"] > 0
    for name, t in train.items():
        assert all(np.isfinite(t["losses"])) and t["ranks_agree"], t
        assert t["loss_rel_err_vs_tp1"] <= DP_LOSS_TOL, (name, t)
        assert t["local_heads"] == train_heads // 2, t
        for lr in t["launches_per_rank"]:
            assert lr["flash_attention_fwd"] > 0 and \
                lr["flash_attention_bwd"] > 0, t
    assert small_rel <= TP_SMALL_TOL and cpu_res[0]["launches"] == 0
    exact, quant = zpp["exact"], zpp["qwz_qgz"]
    assert quant["k6_launches_per_step"] == 2, quant
    # K6 on the step's 1.269 B-value buffers, bf16 (qwZ) and fp32 (qgZ)
    assert sorted(c["dtype"] for c in quant["k6_vs_plain"]) == [
        "bfloat16", "float32"], quant["k6_vs_plain"]
    for c in quant["k6_vs_plain"]:
        assert c["values"] == quant["flat_values"], c
        assert c["q_mismatches"] == 0 and c["scale_mismatches"] == 0, c
    assert quant["loss_rel_err_vs_exact"] <= ZEROPP_LOSS_TOL, quant
    assert exact["k6_launches_per_step"] == 0, exact
    # phase 14 from the same ranks
    emit({"phase": "ep", "part": "references",
          "ep1_reference_seconds": ep_ref_seconds})
    _EP_LAUNCHES.clear()
    _EP_LAUNCHES.update(_ep_report(smi, ranks, cpu_res, ep_refs))
    # phase 15 (a) from the same ranks
    emit({"phase": "sp", "part": "references",
          "sp1_reference_seconds": _SP1["seconds"],
          "card_rank_seconds": [r["sp"]["seconds"] for r in ranks]})
    _SP_LAUNCHES.clear()
    _SP_LAUNCHES.update(_sp_report(smi, ranks))
    # phase 16 from the same ranks
    emit({"phase": "pp", "part": "references",
          "pipe1_reference_seconds": _PP1["seconds"]})
    _PP_LAUNCHES.clear()
    _PP_LAUNCHES.update(_pp_report(smi, ranks, cpu_res))
    # phase 17 (a) from the same ranks
    emit({"phase": "data_axes", "part": "references",
          "world1_reference_seconds": _DA1["seconds"],
          "card_rank_seconds": [r["da"]["seconds"] for r in ranks]})
    _DA_LAUNCHES.clear()
    _DA_LAUNCHES.update(_da_report(smi, ranks))
    return launches


# ---------------------------------------------------------------------------
# phase 15: sequence parallelism — Ulysses and ring in phase 13's two card
# ranks, the long-context step on one card, FPDT at one layer's shapes
# ---------------------------------------------------------------------------

#: (a): Llama-3 1B at full width (heads 16/8 of 128), depth 2 (``reduced``
#: from 16) and phase 12's 32,000-entry vocabulary (``reduced`` from
#: 128,256), bf16, ZeRO stage 1, remat off, a global batch of 1 x 4096 a
#: step, SP_STEPS steps each of Ulysses and ring at sp 2 (one rank a half
#: of the sequence; Ulysses' K1/K3 at 8/4 heads a rank) against sp 1 at
#: world 1 on the same batches: bf16 losses within DP_LOSS_TOL
SP_MODEL = dict(num_layers=2, max_seq_len=4096, tie_embeddings=True,
                vocab_size=32000)
SP_SEQ, SP_STEPS = 4096, 2
#: (b): Llama-3 1B at full width and vocabulary, 131,072 tokens, batch 1,
#: depth 4 (``reduced`` from 16: the JAX bench ran 16), bench.py's
#: long-context configuration (bench.py:751-775 at seq >= 65536); one
#: warm-up step, one timed step under torch.profiler
LONG_MODEL = dict(num_layers=4, max_seq_len=131072, tie_embeddings=True)
LONG_SEQ = 131072
#: (c): one layer's attention at (b)'s shapes (1 x 131072, heads 16/8 of
#: 128, bf16): FPDT with chunk 4096 and its KV store in pinned host memory
#: against K1 on the same q/k/v, each output row's relative error within
#: TOL_BF16_ROW (both bf16 outputs of fp32 softmaxes; K1 multiplies bf16
#: probabilities by V, FPDT fp32 ones). Then K1 and K3 at T 131072
#: against their plain versions on the last FPDT_CHUNK query rows (dO
#: zero on the others, whose dq must be exactly zero): the plain versions
#: of those rows against every key, one kv head at a time
FPDT_CHUNK = 4096
#: (a)'s sp-1 reference, made in phase 13's main process
_SP1: dict = {}
#: phase 15's launches: (a) on both ranks, (b)
_SP_LAUNCHES: dict = {}
_LONG_LAUNCHES: dict = {}
#: K1's and K3's numbers on phase 15's shapes for the kernel table: at T
#: 131072 ((b)'s traced device time a launch, its bound) and at Ulysses'
#: local heads ((a)'s 8/4 heads of 128 at T 4096, held and timed alone)
_SP_TIMES: dict = {}


def _sp_conf(sp: int, mode: str = "ulysses") -> dict:
    return {"train_micro_batch_size_per_gpu": 1,
            "gradient_accumulation_steps": 1,
            "optimizer": {"type": "adamw", "params": {
                "lr": 1e-4, "weight_decay": 0.1}},
            "gradient_clipping": 1.0, "bf16": {"enabled": True},
            "activation_checkpointing": {"policy": "none"},
            "attention_impl": "auto", "steps_per_print": 1000,
            "zero_optimization": {"stage": 1},
            "sequence_parallel": {"size": sp, "mode": mode},
            "comms_logger": {"enabled": True}}


def _sp_batches(vocab):
    rng = np.random.default_rng(15)
    return [[{"input_ids": rng.integers(0, vocab, size=(1, SP_SEQ))
              .astype(np.int32)}] for _ in range(SP_STEPS)]


def _sp_train(mode: str, sp: int) -> dict:
    """One (a) engine's SP_STEPS steps: losses, seconds a step, peak HBM,
    collective bytes a step, K1/K3 launches by shape."""
    import gc
    import torch
    from deepspeed_tpu_torch import initialize, llama3_config
    from deepspeed_tpu_torch.comm.comms_logger import comms_logger
    from deepspeed_tpu_torch.ops import flash_attention as fa
    from deepspeed_tpu_torch.ops import op_builder
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg = llama3_config(TRAIN_MODEL[0], **SP_MODEL)
    eng = initialize(cfg, _sp_conf(sp, mode), generator=torch.Generator(
        device=DEV).manual_seed(15), device=DEV)[0]
    op_builder.reset_launches()
    fa.reset_head_dim_launches()
    comms_logger.reset()
    losses, step_s = [], []
    for b in _sp_batches(cfg.vocab_size):
        t1 = time.perf_counter()
        losses.append(float(eng.train_batch(iter(b))))
        step_s.append(time.perf_counter() - t1)
    out = {"losses": losses, "step_seconds": step_s,
           "ms_per_step": 1e3 * step_s[-1],
           "peak_hbm_gb": torch.cuda.max_memory_allocated() / 1e9,
           "comm_bytes_per_step": {op: b / SP_STEPS for op, b in
                                   comms_logger.bytes_by_op().items()},
           "launches": dict(op_builder.launches),
           "shape_launches": {k: dict(v) for k, v in
                              fa.shape_launches.items()}}
    comms_logger.enabled = False
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _sp_reference() -> dict:
    """(a)'s sp-1 run at world 1 (no process group) in phase 13's main
    process, on (a)'s batches and seed."""
    import torch
    from deepspeed_tpu_torch.parallel.mesh import set_mesh
    set_mesh(None)
    torch.backends.cuda.matmul.allow_tf32 = True
    t0 = time.perf_counter()
    ref = _sp_train("ulysses", 1)
    ref["seconds"] = time.perf_counter() - t0
    return ref


def _sp_card(rank, world) -> dict:
    """Phase 15 (a) on a card rank of phase 13 (two gloo ranks on the
    card): Ulysses, then ring, at sp 2 over the ranks."""
    from deepspeed_tpu_torch import build_mesh
    t0 = time.perf_counter()
    build_mesh(seq=world)
    out = {mode: _sp_train(mode, world) for mode in ("ulysses", "ring")}
    out["seconds"] = time.perf_counter() - t0
    return out


def _sp_report(smi, ranks) -> dict:
    """Phase 15 (a)'s lines and gates; returns the launches of both
    ranks (the ``sp`` path of the kernel table)."""
    from deepspeed_tpu_torch import llama3_config
    from deepspeed_tpu_torch.ops import op_builder
    cfg = llama3_config(TRAIN_MODEL[0], **SP_MODEL)
    ref = _SP1
    launches = {k: 0 for k in op_builder.launches}
    sp = len(ranks)
    h, kvh, dh = cfg.num_heads, cfg.kv_heads, cfg.head_dim
    # the JAX package's records (ulysses.py:115-116, ring.py:112-114):
    # the global q once a call, the global k and v x (sp - 1) a call; a
    # call a layer a step (remat off: no replay)
    jax_bytes = {"ulysses": {"all_to_all": cfg.num_layers * SP_SEQ * h
                             * dh * 2},
                 "ring": {"ppermute": cfg.num_layers * 2 * SP_SEQ * kvh
                          * dh * 2 * (sp - 1)}}
    local = f"{h // sp}/{kvh // sp}/{SP_SEQ}"
    for mode in ("ulysses", "ring"):
        r0 = ranks[0]["sp"][mode]
        rel = max(abs(a - b) / abs(b) for a, b in zip(r0["losses"],
                                                      ref["losses"]))
        op = next(iter(jax_bytes[mode]))
        line = {
            "phase": "sp", "part": "a", "mode": mode, "sp": sp,
            "model": f"llama3-1b-width-depth{cfg.num_layers}-vocab32k",
            "batch": 1, "seq": SP_SEQ, "dtype": "bfloat16", "stage": 1,
            "losses": r0["losses"], "losses_sp1": ref["losses"],
            "loss_rel_err_vs_sp1": rel, "tol": DP_LOSS_TOL,
            "ranks_agree": r0["losses"] == ranks[1]["sp"][mode]["losses"],
            "ms_per_step_per_rank": [r["sp"][mode]["ms_per_step"]
                                     for r in ranks],
            "ms_per_step_sp1": ref["ms_per_step"],
            "peak_hbm_gb_per_rank": [r["sp"][mode]["peak_hbm_gb"]
                                     for r in ranks],
            "peak_hbm_gb_sp1": ref["peak_hbm_gb"],
            "comm_bytes_per_step": r0["comm_bytes_per_step"],
            "jax_formula_bytes_per_step": jax_bytes[mode],
            "k1_k3_launches_by_shape_per_rank": [
                r["sp"][mode]["shape_launches"] for r in ranks],
            "k1_k3_launches_sp1": ref["shape_launches"],
            "backend": "gloo", "speed_claim": None, "nvidia_smi": smi}
        emit(line)
        assert all(np.isfinite(r0["losses"])) and line["ranks_agree"], line
        assert rel <= DP_LOSS_TOL, line
        assert r0["comm_bytes_per_step"].get(op) == jax_bytes[mode][op], \
            line
        for r in ranks:
            got = r["sp"][mode]["shape_launches"]
            if mode == "ulysses":
                # K1 and K3 once a layer a step, at this rank's heads
                for k in TRAIN_KERNELS:
                    assert got[k] == {local: cfg.num_layers * SP_STEPS}, got
            else:
                assert not any(got.values()), got
            for k, v in r["sp"][mode]["launches"].items():
                launches[k] += v
    emit({"phase": "sp", "part": "reduced", "cuts": [
        f"(a) depth {SP_MODEL['num_layers']} of 16 and vocabulary 32,000 "
        f"(phase 12's), {SP_STEPS} steps of 1 x {SP_SEQ}: gloo on one "
        f"card, no speed claim",
        f"(b) depth {LONG_MODEL['num_layers']} of 16 (the JAX bench ran "
        f"16), 1 warm-up + 1 timed step",
        "(c) one layer's attention, one call each"]})
    return launches


def _gloo_rank(rank, world, store, out, group):
    """One gloo rank of a phase's own spawn (:func:`_spawn_ranks`): joins
    the group through the file ``store`` and writes ``group["fn"](rank,
    world)`` (under ``group["key"]``, where there is one) or its traceback
    to ``out``; a rank not done in ``group["timeout"]`` seconds dumps its
    stacks and exits."""
    import faulthandler
    import pickle
    import traceback
    import torch
    torch.set_num_threads(group.get("threads", 2))
    device = group.get("device", DEV)
    faulthandler.dump_traceback_later(group["timeout"], exit=True)
    try:
        if device != "cpu":
            torch.cuda.set_device(0)
        from deepspeed_tpu_torch import comm
        comm.init_distributed(dist_backend="gloo",
                              init_method="file://" + store,
                              num_processes=world, process_id=rank,
                              device=device, timeout=int(group["timeout"]))
        res = group["fn"](rank, world)
        if group.get("key"):
            res = {group["key"]: res}
        comm.destroy_distributed()
    except Exception:                           # noqa: BLE001 — reported
        res = {"error": traceback.format_exc()}
    faulthandler.cancel_dump_traceback_later()
    with open(out, "wb") as fh:
        pickle.dump(res, fh)


def _spawn_ranks(what: str, groups, before=None) -> list:
    """Each group ({"fn", "world", "timeout", "key", "device", "threads",
    "early"}) as ``world`` processes of :func:`_gloo_rank` over a file
    store of its own: the ``early`` groups start, ``before()`` runs here,
    the others start. Waits for every rank up to its timeout + 60 s,
    kills what still runs, and returns the ranks' results, group by
    group."""
    import multiprocessing as mp
    import pickle
    import shutil
    import tempfile
    here = os.path.dirname(os.path.abspath(__file__))
    os.makedirs(os.path.join(here, "build"), exist_ok=True)
    work = tempfile.mkdtemp(prefix=what.replace(" ", "_") + "_",
                            dir=os.path.join(here, "build"))
    ctx = mp.get_context("spawn")
    ranks = []                                 # (process, out, group)
    for g, group in enumerate(groups):
        store = os.path.join(work, f"store{g}")
        for r in range(group["world"]):
            out = os.path.join(work, f"g{g}_rank{r}.pkl")
            ranks.append((ctx.Process(target=_gloo_rank, args=(
                r, group["world"], store, out, group)), out, group))
    try:
        for p, _, group in ranks:
            if group.get("early"):
                p.start()
        if before is not None:
            before()
        for p, _, group in ranks:
            if not group.get("early"):
                p.start()
        got = []
        t0 = time.perf_counter()
        for p, out, group in ranks:
            p.join(max(0.0, group["timeout"] + 60
                       - (time.perf_counter() - t0)))
            assert not p.is_alive(), f"a {what} rank still runs"
            with open(out, "rb") as fh:
                r = pickle.load(fh)
            assert "error" not in r, r["error"]
            got.append(r)
    finally:
        for p, _, _ in ranks:
            if p.is_alive():
                p.kill()
                p.join()
        shutil.rmtree(work, ignore_errors=True)
    return got


def _sp_spawn(smi) -> dict:
    """``--sp-only``'s (a): its sp-1 reference here, then two card ranks."""
    _SP1.clear()
    _SP1.update(_sp_reference())
    ranks = _spawn_ranks("sequence-parallel", [
        {"fn": _sp_card, "key": "sp", "world": 2,
         "timeout": TP_RANK_TIMEOUT_S}])
    return _sp_report(smi, ranks)


def _kernel_device_ms(prof) -> dict:
    """Device milliseconds of K1 (``flash_fwd_*``), K3 (``flash_bwd_*``)
    and of every kernel, from a torch.profiler trace."""
    from torch.autograd import DeviceType
    out = {"flash_attention_fwd": 0.0, "flash_attention_bwd": 0.0,
           "all_kernels": 0.0}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        dur = (e.time_range.end - e.time_range.start) / 1e3
        out["all_kernels"] += dur
        if "flash_fwd_" in e.name:
            out["flash_attention_fwd"] += dur
        elif "flash_bwd_" in e.name:
            out["flash_attention_bwd"] += dur
    return out


def _long_context(smi) -> dict:
    """(b): one warm-up step and one timed step of LONG_MODEL at
    LONG_SEQ tokens on K1/K3; returns the timed step's launches."""
    import gc
    import torch
    from torch.profiler import ProfilerActivity, profile
    from deepspeed_tpu_torch import initialize, llama3_config
    from deepspeed_tpu_torch.ops import flash_attention as fa
    from deepspeed_tpu_torch.ops import op_builder
    from deepspeed_tpu_torch.parallel.mesh import set_mesh
    set_mesh(None)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg = llama3_config(TRAIN_MODEL[0], **LONG_MODEL)
    conf = {"train_micro_batch_size_per_gpu": 1,
            "gradient_accumulation_steps": 1,
            "optimizer": {"type": "adamw", "params": {
                "lr": 1e-4, "weight_decay": 0.1}},
            "gradient_clipping": 1.0, "bf16": {"enabled": True},
            "activation_checkpointing": {
                "policy": "offload_save_attn_kernel_host",
                "ffn_chunk": 8192},
            "ce_logits_dtype": "bf16", "chunked_ce_budget_mb": 256,
            "attention_impl": "auto", "steps_per_print": 1000,
            "zero_optimization": {"stage": 0}}
    eng = initialize(cfg, conf, generator=torch.Generator(
        device=DEV).manual_seed(16), device=DEV)[0]
    batch = [{"input_ids": np.random.default_rng(16).integers(
        0, cfg.vocab_size, size=(1, LONG_SEQ)).astype(np.int32)}]
    t1 = time.perf_counter()
    losses = [float(eng.train_batch(iter(batch)))]
    warm_s = time.perf_counter() - t1
    op_builder.reset_launches()
    fa.reset_head_dim_launches()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t1 = time.perf_counter()
        losses.append(float(eng.train_batch(iter(batch))))
        torch.cuda.synchronize()
        step_s = time.perf_counter() - t1
    launches = dict(op_builder.launches)
    shapes = {k: dict(v) for k, v in fa.shape_launches.items()}
    dev_ms = _kernel_device_ms(prof)
    peak = torch.cuda.max_memory_allocated() / 1e9
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    h, kvh, dh = cfg.num_heads, cfg.kv_heads, cfg.head_dim
    # causal attention: 2·T²·H·dh forward a layer (QK and PV over half
    # the square), K3 2.5 times that
    fwd_flops = 2.0 * LONG_SEQ * LONG_SEQ * h * dh
    line = {"phase": "sp", "part": "b", "model": "llama3-1b-width-depth"
            f"{cfg.num_layers}", "seq": LONG_SEQ, "batch": 1,
            "dtype": "bfloat16", "policy": conf["activation_checkpointing"],
            "ce_logits_dtype": "bf16", "chunked_ce_budget_mb": 256,
            "losses": losses, "warmup_seconds": warm_s,
            "ms_per_step": 1e3 * step_s,
            "tokens_per_s": LONG_SEQ / step_s, "peak_hbm_gb": peak,
            "k1_k3_launches_by_shape": shapes,
            "device_ms": dev_ms,
            "k1_tflops_per_s": cfg.num_layers * fwd_flops
            / (dev_ms["flash_attention_fwd"] / 1e3) / 1e12
            if dev_ms["flash_attention_fwd"] else None,
            "k3_tflops_per_s": 2.5 * cfg.num_layers * fwd_flops
            / (dev_ms["flash_attention_bwd"] / 1e3) / 1e12
            if dev_ms["flash_attention_bwd"] else None,
            "traced": True, "nvidia_smi": smi}
    emit(line)
    # a launch's bound at T 131072: causal pairs T(T+1)/2 a head; K1 reads
    # q, k, v and writes out and lse, K3 reads q, k, v, out, dO, lse and
    # writes dq, dk, dv (check_flash/check_flash_bwd's counts)
    pairs = LONG_SEQ * (LONG_SEQ + 1) / 2 * h
    qb, kb = LONG_SEQ * h * dh * 2, LONG_SEQ * kvh * dh * 2
    for k, flops, nbytes in (
            ("flash_attention_fwd", 4.0 * dh * pairs,
             2 * qb + 2 * kb + LONG_SEQ * h * 4),
            ("flash_attention_bwd", 10.0 * dh * pairs,
             3 * qb + 3 * kb + 2 * qb + LONG_SEQ * h * 4)):
        n = shapes[k].get(f"{h}/{kvh}/{LONG_SEQ}", 0)
        bms, by = bound(nbytes, flops, "bfloat16")
        _SP_TIMES.setdefault("t131072", {})[k] = {
            "shape": {"B": 1, "T": LONG_SEQ, "H": h, "KvH": kvh, "D": dh},
            "launches": n, "device_ms_per_launch":
            dev_ms[k] / n if n else None, "bound_ms": bms, "bound_by": by,
            "tflops_per_s": flops * n / (dev_ms[k] / 1e3) / 1e12
            if dev_ms[k] else None, "source": "phase sp (b), traced"}
    assert all(np.isfinite(losses)), losses
    key = f"{h}/{kvh}/{LONG_SEQ}"
    # offload_save_attn_kernel_host keeps K1's (out, lse): one K1 and one
    # K3 a layer
    for k in TRAIN_KERNELS:
        assert shapes[k] == {key: cfg.num_layers}, shapes
    assert dev_ms["flash_attention_fwd"] > 0 and \
        dev_ms["flash_attention_bwd"] > 0, dev_ms
    return launches


def _fpdt_vs_k1(smi) -> dict:
    """(c): FPDT at (b)'s attention shapes with its KV store in pinned
    host memory, against K1 on the same q/k/v; peak device bytes of each
    call, inputs on the card included (K1 needs q, k and v there, FPDT
    only q)."""
    import gc
    import torch
    from deepspeed_tpu_torch import llama3_config
    from deepspeed_tpu_torch.ops import flash_attention as fa
    from deepspeed_tpu_torch.parallel import fpdt
    gc.collect()
    torch.cuda.empty_cache()
    cfg = llama3_config(TRAIN_MODEL[0], **LONG_MODEL)
    h, kvh, dh = cfg.num_heads, cfg.kv_heads, cfg.head_dim
    g = torch.Generator(device=DEV).manual_seed(17)
    shape = (1, LONG_SEQ)
    # drawn on the card, the K/V store copied out to pinned host memory
    kh, vh = (torch.randn(shape + (kvh, dh), generator=g, device=DEV).to(
        torch.bfloat16).cpu().pin_memory() for _ in range(2))
    qh = torch.randn(shape + (h, dh), generator=g, device=DEV).to(
        torch.bfloat16).cpu()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    # K1: q, k, v on the card
    torch.cuda.reset_peak_memory_stats()
    q, k, v = (x.to(DEV) for x in (qh, kh, vh))
    with torch.no_grad():
        t1 = time.perf_counter()
        ref = fa.flash_attention(q, k, v, causal=True)
        torch.cuda.synchronize()
        k1_s = time.perf_counter() - t1
    k1_peak = torch.cuda.max_memory_allocated() - base
    del k, v
    torch.cuda.empty_cache()
    ref_host = ref.cpu()
    del ref
    # FPDT: q on the card, K/V in the pinned store
    base = torch.cuda.memory_allocated() - q.numel() * q.element_size()
    torch.cuda.reset_peak_memory_stats()
    with torch.no_grad():
        fpdt.fpdt_attention(q[:, :2 * FPDT_CHUNK], kh[:, :2 * FPDT_CHUNK],
                            vh[:, :2 * FPDT_CHUNK], chunk=FPDT_CHUNK)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        out = fpdt.fpdt_attention(q, kh, vh, chunk=FPDT_CHUNK)
        torch.cuda.synchronize()
        fpdt_s = time.perf_counter() - t1
    fpdt_peak = torch.cuda.max_memory_allocated() - base
    traffic = dict(fpdt.last_call)
    out_host = out.cpu()
    err = _err(out_host, ref_host)
    row_rel = _row_rel_err(out_host, ref_host)
    scale = float(ref_host.float().abs().max())
    del out
    k, v = kh.to(DEV), vh.to(DEV)
    long_t = _k1_k3_at_long_t(q, k, v)
    del q, k, v
    gc.collect()
    torch.cuda.empty_cache()
    nc = LONG_SEQ // FPDT_CHUNK
    line = {"phase": "sp", "part": "c", "seq": LONG_SEQ, "heads": [h, kvh],
            "head_dim": dh, "dtype": "bfloat16", "chunk": FPDT_CHUNK,
            "kv_store": "pinned host", "max_abs_err_vs_k1": err,
            "row_rel_err_vs_k1": row_rel, "max_abs_k1": scale,
            "tol": {"row_rel": TOL_BF16_ROW},
            "fpdt_ms": 1e3 * fpdt_s, "k1_ms": 1e3 * k1_s,
            "h2d_bytes": traffic["h2d_bytes"],
            "chunk_reads": traffic["chunk_reads"],
            "chunk_reads_causal": nc * (nc + 1) // 2,
            "h2d_gb_per_s": traffic["h2d_bytes"] / fpdt_s / 1e9,
            "peak_device_bytes_fpdt": fpdt_peak,
            "peak_device_bytes_k1": k1_peak,
            "kv_bytes": 2 * kh.numel() * kh.element_size(),
            "k1_k3_at_t131072_vs_plain": long_t, "nvidia_smi": smi}
    emit(line)
    assert row_rel <= TOL_BF16_ROW and np.isfinite(err), line
    assert traffic["chunk_reads"] == nc * (nc + 1) // 2, line
    assert fpdt_peak < k1_peak, line
    return line


def _k1_k3_at_long_t(q, k, v) -> dict:
    """K1 and K3 at q's full length (131072) held against their plain
    versions on the last FPDT_CHUNK query rows: dO is random there and
    zero elsewhere, so those rows' out/lse/dq and every key's dk/dv are
    the plain versions' of those rows against all keys (computed one kv
    head at a time, fp32), and the other rows' dq is exactly zero."""
    import torch
    from deepspeed_tpu_torch.ops import flash_attention as fa
    b, t, h, dh = q.shape
    kvh = k.shape[2]
    tl, g = FPDT_CHUNK, h // kvh
    with torch.no_grad():
        out, lse = fa._forward(q, k, v, True, 0, None)
        do = torch.zeros_like(q)
        do[:, -tl:] = torch.randn(do[:, -tl:].shape, device=q.device,
                                  generator=torch.Generator(
                                      device=q.device).manual_seed(18)
                                  ).to(q.dtype)
        dq, dk, dv = fa.flash_attention_bwd(q, k, v, out, lse, do, True, 0)
        torch.cuda.synchronize()
        errs = {"out": 0.0, "dq": 0.0, "dk": 0.0, "dv": 0.0, "lse": 0.0}
        for j in range(kvh):
            hs = slice(j * g, (j + 1) * g)
            qs = q[:, -tl:, hs].float()
            ks, vs = k[:, :, j:j + 1].float(), v[:, :, j:j + 1].float()
            ro, rl = fa.flash_attention_ref(qs, ks, vs, True, t - tl, None)
            rdq, rdk, rdv = fa.flash_attention_bwd_ref(
                qs, ks, vs, out[:, -tl:, hs].float(), lse[:, -tl:, hs],
                do[:, -tl:, hs].float(), True, t - tl, None)
            for key, a, c in (("out", out[:, -tl:, hs], ro),
                              ("dq", dq[:, -tl:, hs], rdq),
                              ("dk", dk[:, :, j:j + 1], rdk),
                              ("dv", dv[:, :, j:j + 1], rdv)):
                errs[key] = max(errs[key], _row_rel_err(a, c))
            errs["lse"] = max(errs["lse"], float(
                ((lse[:, -tl:, hs] - rl).abs() / (1 + rl.abs())).max()))
            del ro, rl, rdq, rdk, rdv, qs, ks, vs
            torch.cuda.empty_cache()
        rest_zero = bool((dq[:, :-tl] == 0).all())
        finite = all(bool(torch.isfinite(x).all()) for x in (dq, dk, dv))
        del dq, dk, dv
    # SDPA at the same shapes, timed as phase 3 times it (forward, and
    # forward + backward less forward), its k/v repeated to the query
    # heads and held to the fused backends: its math backend would form
    # the [T, T] scores
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel
    qt, kt, vt = (x.transpose(1, 2).detach() for x in (
        q, k.repeat_interleave(g, dim=2), v.repeat_interleave(g, dim=2)))
    qt, kt, vt = (x.requires_grad_() for x in (qt, kt, vt))
    dot = do.transpose(1, 2)

    def sdpa():
        return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)

    with sdpa_kernel([SDPBackend.FLASH_ATTENTION,
                      SDPBackend.EFFICIENT_ATTENTION,
                      SDPBackend.CUDNN_ATTENTION]):
        with torch.no_grad():
            fwd_ms = cuda_time_ms(sdpa, iters=3, warmup=1)
        both_ms = cuda_time_ms(
            lambda: torch.autograd.grad(sdpa(), (qt, kt, vt), dot),
            iters=3, warmup=1)
    library = {"flash_attention_fwd": fwd_ms,
               "flash_attention_bwd": both_ms - fwd_ms}
    for key, ms in library.items():
        _SP_TIMES.setdefault("t131072", {}).setdefault(key, {}).update(
            library_ms=ms, library="torch.nn.functional."
            "scaled_dot_product_attention (flash/efficient/cuDNN backends)")
    del qt, kt, vt, dot
    torch.cuda.empty_cache()
    res = {"T": t, "rows_held": tl, "row_rel_err": errs,
           "sdpa_fwd_ms": fwd_ms, "sdpa_bwd_ms": both_ms - fwd_ms,
           "tol": {"row_rel": TOL_BF16_ROW, "lse": TOL_BF16_LSE},
           "dq_zero_off_the_held_rows": rest_zero, "finite": finite}
    assert finite and rest_zero, res
    assert max(v for k_, v in errs.items() if k_ != "lse") \
        <= TOL_BF16_ROW and errs["lse"] <= TOL_BF16_LSE, res
    return res


def phase_sp(smi: str) -> dict:
    """Sequence parallelism. (a) Ulysses and ring at sp 2 ran in phase
    13's two gloo card ranks (reported there, launches in _SP_LAUNCHES);
    (b) the long-context step on one card at 131,072 tokens, K1/K3 at
    T 131072; (c) FPDT against K1 at one layer's shapes. Returns (b)'s
    launches (the ``long_context`` path)."""
    import torch
    from deepspeed_tpu_torch import llama3_config
    _LONG_LAUNCHES.clear()
    _LONG_LAUNCHES.update(_long_context(smi))
    _fpdt_vs_k1(smi)
    # K1 and K3 at Ulysses' local heads, held and timed alone
    cfg = llama3_config(TRAIN_MODEL[0], **SP_MODEL)
    local = (cfg.num_heads // 2, cfg.kv_heads // 2, cfg.head_dim)
    rng = np.random.default_rng(19)
    _SP_TIMES["ulysses_local_heads"] = {
        "flash_attention_fwd": check_flash(
            "sp_local_heads", rng, 1, SP_SEQ, local, torch.bfloat16, False),
        "flash_attention_bwd": check_flash_bwd(
            "sp_local_heads_bwd", rng, 1, SP_SEQ, local, torch.bfloat16)}
    return dict(_LONG_LAUNCHES)


# ---------------------------------------------------------------------------
# phase 16: pipeline parallelism — GPipe and 1F1B in phase 13's two card
# ranks
# ---------------------------------------------------------------------------

#: (a): Llama-3 1B at full width (d 2048, heads 16/8 of 128, FFN 8192),
#: depth 4 (``reduced`` from 16: two layers a stage) and phase 12's
#: 32,000-entry vocabulary (``reduced`` from 128,256), bf16, ZeRO stage 1,
#: remat 'full', PP_GAS microbatches of 1 x PP_SEQ a step, PP_STEPS steps
#: each of GPipe and 1F1B at pipe 2 (one stage a rank) against pipe 1 at
#: world 1 with the same gas on the same batches: losses within
#: DP_LOSS_TOL. (b): one step of each schedule under remat 'none' (the
#: stash's memory). (c): depth 3 (three layers over two stages: the
#: padding row) in fp32 at T 256, gas 2: the card's ranks against two CPU
#: ranks at pipe 2 within TP_SMALL_TOL over 2 steps
PP_MODEL = dict(num_layers=4, max_seq_len=2048, tie_embeddings=True,
                vocab_size=32000)
PP_SEQ, PP_GAS, PP_STEPS = 2048, 8, 2
PP_SMALL = dict(num_layers=3, max_seq_len=256, tie_embeddings=True,
                vocab_size=32000)
PP_SMALL_GAS = 2
#: a card rank that has not finished phase 16 in this many seconds dumps
#: its stacks and exits (a pipeline whose stages disagree on a hop hangs
#: in gloo without an error)
PP_RANK_TIMEOUT_S = 240.0
#: (a)'s pipe-1 reference, made in phase 13's main process
_PP1: dict = {}
#: phase 16's launches on both card ranks ((a) and (b))
_PP_LAUNCHES: dict = {}


def _pp_conf(stages: int, schedule: str, remat: str) -> dict:
    return {"train_micro_batch_size_per_gpu": 1,
            "gradient_accumulation_steps": PP_GAS,
            "optimizer": {"type": "adamw", "params": {
                "lr": 1e-4, "weight_decay": 0.1}},
            "gradient_clipping": 1.0, "bf16": {"enabled": True},
            "activation_checkpointing": {"policy": remat},
            "attention_impl": "auto", "steps_per_print": 1000,
            "zero_optimization": {"stage": 1},
            "pipeline": {"stages": stages, "schedule": schedule},
            "comms_logger": {"enabled": True}}


def _pp_batches(vocab, steps):
    rng = np.random.default_rng(16)
    return [[{"input_ids": rng.integers(0, vocab, size=(1, PP_SEQ))
              .astype(np.int32)} for _ in range(PP_GAS)]
            for _ in range(steps)]


def _pp_train(stages: int, schedule: str, remat: str, steps: int) -> dict:
    """One engine's steps: losses, seconds a step, peak HBM (of the run,
    and of the last step over what was allocated before it), the bytes
    this rank sent over 'pipe' a step, collective bytes a step, K1/K3
    launches by shape."""
    import gc
    import torch
    from deepspeed_tpu_torch import initialize, llama3_config
    from deepspeed_tpu_torch.comm.comms_logger import comms_logger
    from deepspeed_tpu_torch.ops import flash_attention as fa
    from deepspeed_tpu_torch.ops import op_builder
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg = llama3_config(TRAIN_MODEL[0], **PP_MODEL)
    eng = initialize(cfg, _pp_conf(stages, schedule, remat),
                     generator=torch.Generator(device=DEV).manual_seed(16),
                     device=DEV)[0]
    op_builder.reset_launches()
    fa.reset_head_dim_launches()
    comms_logger.reset()
    losses, step_s = [], []
    for b in _pp_batches(cfg.vocab_size, steps):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t1 = time.perf_counter()
        losses.append(float(eng.train_batch(iter(b))))
        step_s.append(time.perf_counter() - t1)
        step_peak = torch.cuda.max_memory_allocated() - base
    by_op = comms_logger.bytes_by_op()
    out = {"losses": losses, "step_seconds": step_s,
           "ms_per_step": 1e3 * step_s[-1],
           "peak_hbm_gb": torch.cuda.max_memory_allocated() / 1e9,
           "step_peak_over_base_gb": step_peak / 1e9,
           "base_gb": base / 1e9,
           "hop_bytes_per_step": by_op.get("ppermute", 0) / steps,
           "comm_bytes_per_step": {op: b / steps for op, b in
                                   by_op.items()},
           "launches": dict(op_builder.launches),
           "shape_launches": {k: dict(v) for k, v in
                              fa.shape_launches.items()}}
    comms_logger.enabled = False
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _pp_reference() -> dict:
    """(a)'s pipe-1 run at world 1 (no process group) in phase 13's main
    process, on (a)'s batches and seed."""
    import torch
    from deepspeed_tpu_torch.parallel.mesh import set_mesh
    set_mesh(None)
    torch.backends.cuda.matmul.allow_tf32 = True
    t0 = time.perf_counter()
    ref = _pp_train(1, "1f1b", "full", PP_STEPS)
    ref["seconds"] = time.perf_counter() - t0
    return ref


def _pp_small_run(device) -> dict:
    """(c): PP_SMALL at pipe 2 (1F1B) in fp32 over the current mesh, from
    a seeded CPU tree padded to four rows by the model spec's init."""
    import torch
    from deepspeed_tpu_torch import initialize, llama3_config
    from deepspeed_tpu_torch.config.config import DeepSpeedConfig
    from deepspeed_tpu_torch.ops import op_builder
    from deepspeed_tpu_torch.runtime.model_factory import decoder_model_spec
    cfg = llama3_config(TRAIN_MODEL[0], **PP_SMALL)
    conf = {"train_micro_batch_size_per_gpu": 1,
            "gradient_accumulation_steps": PP_SMALL_GAS,
            "optimizer": {"type": "adamw",
                          "params": {"lr": 1e-5, "weight_decay": 0.1}},
            "gradient_clipping": 1.0, "attention_impl": "auto",
            "zero_optimization": {"stage": 1},
            "pipeline": {"stages": 2}}
    spec = decoder_model_spec(cfg, DeepSpeedConfig.from_any(conf))
    init = spec.init_fn(torch.Generator().manual_seed(16), "cpu")
    eng = initialize(spec, conf, params=init, device=device)[0]
    rng = np.random.default_rng(16)
    n0 = sum(op_builder.launches.values())
    losses = []
    for _ in range(2):
        step = [{"input_ids": rng.integers(0, cfg.vocab_size, size=(
            1, PP_SMALL["max_seq_len"])).astype(np.int32)}
            for _ in range(PP_SMALL_GAS)]
        losses.append(float(eng.train_batch(iter(step))))
    rows = {tuple(x.shape)[0] for x in
            eng.params["layers"]["attn"].values()}
    return {"losses": losses, "local_rows": sorted(rows),
            "launches": sum(op_builder.launches.values()) - n0}


def _pp_card(rank, world) -> dict:
    """Phase 16 on a card rank of phase 13 (two gloo ranks on the card):
    (a) GPipe and 1F1B at pipe 2, (b) both under remat 'none', (c) fp32
    at depth 3. A rank still here after PP_RANK_TIMEOUT_S dumps its
    stacks and exits."""
    import faulthandler
    import torch
    from deepspeed_tpu_torch import build_mesh
    t0 = time.perf_counter()
    faulthandler.dump_traceback_later(PP_RANK_TIMEOUT_S, exit=True)
    try:
        build_mesh(pipe=world)
        out = {f"a_{s}": _pp_train(world, s, "full", PP_STEPS)
               for s in ("gpipe", "1f1b")}
        out.update({f"b_{s}": _pp_train(world, s, "none", 1)
                    for s in ("gpipe", "1f1b")})
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        out["c"] = _pp_small_run(DEV)
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True
    finally:
        faulthandler.cancel_dump_traceback_later()
    out["seconds"] = time.perf_counter() - t0
    return out


def _pp_report(smi, ranks, cpu_res) -> dict:
    """Phase 16's lines and gates; returns the launches of (a) and (b) on
    both ranks (the ``pp`` path of the kernel table)."""
    from deepspeed_tpu_torch import llama3_config
    from deepspeed_tpu_torch.ops import op_builder
    cfg = llama3_config(TRAIN_MODEL[0], **PP_MODEL)
    ref = _PP1
    launches = {k: 0 for k in op_builder.launches}
    S, M, d = len(ranks), PP_GAS, cfg.hidden_size
    block = PP_SEQ * d                          # B·T·d, B = 1
    heads = f"{cfg.num_heads}/{cfg.kv_heads}/{PP_SEQ}"
    per_stage = cfg.num_layers // S
    for sched in ("gpipe", "1f1b"):
        got = [r["pp"][f"a_{sched}"] for r in ranks]
        rel = max(abs(a - b) / abs(b) for a, b in zip(got[0]["losses"],
                                                      ref["losses"]))
        # stage s < S-1 sends M activations (bf16) a step, stage s > 0 M
        # gradients back: bf16 under GPipe (autograd's, the tensor's
        # dtype), fp32 under 1F1B (the JAX dbuf)
        want = [(M * block * 2 if s < S - 1 else 0)
                + (M * block * (2 if sched == "gpipe" else 4) if s > 0
                   else 0) for s in range(S)]
        line = {
            "phase": "pp", "part": "a", "schedule": sched, "pipe": S,
            "model": f"llama3-1b-width-depth{cfg.num_layers}-vocab32k",
            "microbatches": M, "batch": 1, "seq": PP_SEQ,
            "dtype": "bfloat16", "stage": 1, "remat": "full",
            "losses": got[0]["losses"], "losses_pipe1": ref["losses"],
            "loss_rel_err_vs_pipe1": rel, "tol": DP_LOSS_TOL,
            "ranks_agree": got[0]["losses"] == got[1]["losses"],
            "ms_per_step_per_rank": [g["ms_per_step"] for g in got],
            "ms_per_step_pipe1": ref["ms_per_step"],
            "peak_hbm_gb_per_rank": [g["peak_hbm_gb"] for g in got],
            "peak_hbm_gb_pipe1": ref["peak_hbm_gb"],
            "hop_bytes_per_step_per_rank": [g["hop_bytes_per_step"]
                                            for g in got],
            "hop_bytes_formula_per_rank": want,
            "comm_bytes_per_step_per_rank": [g["comm_bytes_per_step"]
                                             for g in got],
            "k1_k3_launches_by_shape_per_rank": [g["shape_launches"]
                                                 for g in got],
            "k1_k3_launches_pipe1": ref["shape_launches"],
            "backend": "gloo", "speed_claim": None, "nvidia_smi": smi}
        emit(line)
        assert all(np.isfinite(got[0]["losses"])) and line["ranks_agree"], \
            line
        assert rel <= DP_LOSS_TOL, line
        assert line["hop_bytes_per_step_per_rank"] == want, line
        for g in got:
            sl = g["shape_launches"]
            # every stage's K3 once a layer a microbatch, at the model's
            # heads, and K1 in the forward and the recompute
            assert sl["flash_attention_bwd"] == {
                heads: M * per_stage * PP_STEPS}, sl
            assert set(sl["flash_attention_fwd"]) == {heads} and \
                sl["flash_attention_fwd"][heads] >= 2 * M * per_stage \
                * PP_STEPS, sl
            for k, v in g["launches"].items():
                launches[k] += v
    b = {s: [r["pp"][f"b_{s}"] for r in ranks] for s in ("gpipe", "1f1b")}
    line = {"phase": "pp", "part": "b", "remat": "none", "steps": 1,
            "peak_hbm_gb_per_rank": {s: [g["peak_hbm_gb"] for g in v]
                                     for s, v in b.items()},
            "step_peak_over_base_gb_per_rank": {
                s: [g["step_peak_over_base_gb"] for g in v]
                for s, v in b.items()},
            "base_gb_per_rank": {s: [g["base_gb"] for g in v]
                                 for s, v in b.items()},
            "losses": {s: v[0]["losses"] for s, v in b.items()},
            "nvidia_smi": smi}
    emit(line)
    for r in range(S):
        assert b["1f1b"][r]["peak_hbm_gb"] < b["gpipe"][r]["peak_hbm_gb"], \
            line
    for v in b.values():
        for g in v:
            for k, n in g["launches"].items():
                launches[k] += n
    c = [r["pp"]["c"] for r in ranks]
    rel = max(abs(a - b_) / abs(b_) for a, b_ in zip(
        c[0]["losses"], cpu_res[0]["pp"]["losses"]))
    line = {"phase": "pp", "part": "c", "pipe": S, "dtype": "float32",
            "model": f"llama3-1b-width-depth{PP_SMALL['num_layers']}"
            "-vocab32k", "seq": PP_SMALL["max_seq_len"],
            "microbatches": PP_SMALL_GAS, "losses_card": c[0]["losses"],
            "losses_cpu": cpu_res[0]["pp"]["losses"],
            "loss_rel_err": rel, "tol": TP_SMALL_TOL,
            "local_rows": [x["local_rows"] for x in c],
            "cpu_launches": cpu_res[0]["pp"]["launches"],
            "card_rank_seconds": [r["pp"]["seconds"] for r in ranks]}
    emit(line)
    assert rel <= TP_SMALL_TOL and cpu_res[0]["pp"]["launches"] == 0, line
    assert all(x["local_rows"] == [2] for x in c), line
    assert c[0]["losses"] == c[1]["losses"], line
    emit({"phase": "pp", "part": "reduced", "cuts": [
        f"(a) depth {PP_MODEL['num_layers']} of 16 (two layers a stage) "
        f"and vocabulary 32,000 (phase 12's), {PP_STEPS} steps of "
        f"{PP_GAS} x 1 x {PP_SEQ}: gloo on one card, no speed claim",
        "(b) one step each",
        f"(c) depth {PP_SMALL['num_layers']}, T "
        f"{PP_SMALL['max_seq_len']}, gas {PP_SMALL_GAS}, 2 steps (the CPU "
        "ranks' time)"]})
    return launches


def _pp_cpu_card(rank, world) -> dict:
    """``--pipe-only``: (c)'s CPU side on one of two gloo CPU ranks."""
    from deepspeed_tpu_torch import build_mesh
    build_mesh(pipe=world)
    return _pp_small_run("cpu")


def _pp_spawn(smi) -> dict:
    """``--pipe-only``: two CPU ranks, (a)'s pipe-1 reference here while
    they start, then two card ranks."""
    def reference():
        _PP1.clear()
        _PP1.update(_pp_reference())
    got = _spawn_ranks("pipeline", [
        {"fn": _pp_card, "key": "pp", "world": 2,
         "timeout": PP_RANK_TIMEOUT_S},
        {"fn": _pp_cpu_card, "key": "pp", "world": 2, "device": "cpu",
         "threads": TP_CPU_THREADS, "timeout": PP_RANK_TIMEOUT_S,
         "early": True}], before=reference)
    emit({"phase": "pp", "part": "references",
          "pipe1_reference_seconds": _PP1["seconds"]})
    return _pp_report(smi, got[:2], got[2:])


# ---------------------------------------------------------------------------
# phase 17: the data axes — 1-bit Adam over the compressed all-reduce, LAMB
# and Muon at stage 3 and under a pipeline (phase 13's two card ranks), and
# MiCS on the 'data_inner' axis (four card ranks of its own)
# ---------------------------------------------------------------------------

#: Llama-3 1B at full width (heads 16/8 of 128), depth 2 (``reduced`` from
#: 16) and phase 12's 32,000-entry vocabulary (``reduced`` from 128,256),
#: bf16, 1 x 2048 tokens a rank a step (a global batch of 2 x 2048)
DA_MODEL = dict(num_layers=2, max_seq_len=2048, tie_embeddings=True,
                vocab_size=32000)
DA_SEQ = 2048
#: 1-bit Adam: DA_FREEZE exact warmup steps, then DA_COMPRESSED compressed
DA_FREEZE, DA_COMPRESSED = 2, 3
#: the steps of each LAMB / Muon run and of (b)'s runs
DA_STEPS = 2
DA_LR = 1e-4
#: phase 17's limit on a loss's relative error against its reference:
#: one update at DA_LR moves the loss by ~2e-3 relative, so DP_LOSS_TOL
#: (1e-2) could not see a wrong update; the spread seen on the H100 was
#: at most 1.2e-5 (the 1-bit warmup against AdamW)
DA_LOSS_TOL = 1e-4
#: random directions of the update sketch (_da_sketch)
DA_SKETCH = 8
#: limits on the sketched relative error of a leaf's update against its
#: reference's (_da_update_err, the worst leaf), by run: about 3x the
#: spread on the H100 (1-bit warmup 0.034, LAMB 0.009, Muon 0.032-0.044,
#: MiCS 0.032); an update 10 % off reads ~0.1, a wrong direction ~1
DA_UPDATE_TOL = {"onebit": 0.1, "lamb": 0.03, "muon": 0.15, "mics": 0.1}
#: a card rank not done with (b) in this many seconds dumps its stacks
DA_RANK_TIMEOUT_S = 300.0
#: host bytes (b)'s four card ranks may take (each: the seeded tree, its
#: shards' Adam state, the checkpoint's snapshot); below it (b) stays a
#: CPU result (tests/test_torch_mics.py) and the line says why
DA_MICS_HOST_BYTES = 24e9
#: (a)'s world-1 references, made in phase 13's main process
_DA1: dict = {}
#: phase 17's launches on the card ranks ((a) and (b))
_DA_LAUNCHES: dict = {}


def _da_conf(opt: str, micro: int, stage: int = 0, gas: int = 1,
             pipe: int = 1, **extra) -> dict:
    params = {"lr": DA_LR}
    if opt in ("lamb", "muon"):
        params["weight_decay"] = 0.01
    if opt == "onebitadam":
        params["freeze_step"] = DA_FREEZE
    conf = {"train_micro_batch_size_per_gpu": micro,
            "gradient_accumulation_steps": gas,
            "optimizer": {"type": opt, "params": params},
            "bf16": {"enabled": True}, "attention_impl": "auto",
            "activation_checkpointing": {"policy": "none"},
            "steps_per_print": 1000,
            "zero_optimization": {"stage": stage},
            "comms_logger": {"enabled": True}}
    if pipe > 1:
        conf["pipeline"] = {"stages": pipe, "schedule": "1f1b"}
    conf.update(extra)
    return conf


def _da_batches(vocab, steps, pipe: int = 1, rows: int = 2):
    """A step's global batch: ``rows`` x DA_SEQ tokens (one micro-batch of
    all rows, or under a pipeline one micro-batch a row)."""
    rng = np.random.default_rng(17)
    out = []
    for _ in range(steps):
        ids = rng.integers(0, vocab, size=(rows, DA_SEQ)).astype(np.int32)
        out.append([{"input_ids": ids[i:i + 1]} for i in range(rows)]
                   if pipe > 1 else [{"input_ids": ids}])
    return out


def _da_master(eng) -> dict:
    """The engine's fp32 update targets by leaf path, in the order of its
    leaves: bf16 training's master tree, or 1-bit's flat master cut by
    its layout."""
    m = eng.opt_state["master"]
    if not isinstance(m, dict):
        lay = eng._onebit_layout
        return {"/".join(p): m[lo:lo + n].view(sh) for p, lo, n, sh in zip(
            lay.paths, lay.offsets, lay.sizes, lay.shapes)}
    out = {}

    def walk(t, p):
        if isinstance(t, dict):
            for k, v in t.items():
                walk(v, f"{p}/{k}" if p else k)
        else:
            out[p] = t
    walk(m, "")
    return out


def _da_sketch(eng, before: dict) -> dict:
    """Each update target's change since ``before`` projected on
    DA_SKETCH Gaussian directions drawn over the whole leaf (seeded by
    its path, so every run of the model draws the same), and its squared
    norm: this rank's piece cut from the directions as the engine cut it
    from the leaf (``ShardLayout.cuts``), the pieces' sums added over the
    leaf's axes. For two runs, E[(p - p')^2] = ||d - d'||^2, so the
    sketches hold two runs' updates against each other without gathering
    either."""
    import zlib
    import torch
    from deepspeed_tpu_torch.runtime.zero.sharding import shard_of
    layout = getattr(eng, "_opt_layout", None) if eng._dist else None
    if not isinstance(eng.opt_state["master"], dict):
        layout = None                      # 1-bit: a whole master a rank
    paths, vals = [], []
    for i, (path, w) in enumerate(_da_master(eng).items()):
        d = w.detach().float() - before[path].to(w.device)
        cuts = layout.cuts[i] if layout is not None else []
        full = list(d.shape)
        for dim, _, n, _ in cuts:
            full[dim] *= n
        g = torch.Generator(device=d.device).manual_seed(
            zlib.crc32(path.encode()))
        v = []
        for _ in range(DA_SKETCH):
            r = torch.randn(full, generator=g, device=d.device)
            for dim, _, n, idx in cuts:
                r = shard_of(r, dim, idx, n)
            v.append((d * r).sum())
        v.append((d * d).sum())
        paths.append(path)
        vals.append(torch.stack(v))
    if layout is not None:
        vals = layout.sum_sq(vals)
    return {p: v.tolist() for p, v in zip(paths, vals)}


def _da_update_err(got: dict, want: dict) -> dict:
    """The sketched relative error of ``got``'s update against
    ``want``'s: per leaf sqrt(mean_k (p_k - q_k)^2) / ||d_want||; the
    worst leaf, the whole model's, and the worst leaf's norm ratio."""
    num = den = 0.0
    worst, worst_norm, at = 0.0, 0.0, None
    for path, q in want.items():
        p = got[path]
        e2 = float(np.mean((np.asarray(p[:DA_SKETCH])
                            - np.asarray(q[:DA_SKETCH])) ** 2))
        num, den = num + e2, den + q[DA_SKETCH]
        err = (e2 / q[DA_SKETCH]) ** 0.5 if q[DA_SKETCH] else float(e2 > 0)
        if err >= worst:
            worst, at = err, path
        worst_norm = max(worst_norm, abs(
            (p[DA_SKETCH] / q[DA_SKETCH]) ** 0.5 - 1) if q[DA_SKETCH]
            else float(p[DA_SKETCH] > 0))
    return {"worst_leaf": worst, "worst_leaf_path": at,
            "whole_model": (num / den) ** 0.5,
            "worst_leaf_norm_rel_err": worst_norm}


def _da_train(conf, steps: int, pipe: int = 1, save: str = None,
              load: str = None, rows: int = 2, mark: int = None) -> dict:
    """One engine's steps from the seeded tree: losses, ms a step, peak
    HBM, collective bytes by op and by (op, axis), the K1/K3 launches,
    (1-bit) the error buffers' sums, and the sketch of the update after
    ``mark`` steps (default: all); ``save`` writes a checkpoint after the
    steps and returns the gathered params; ``load`` loads one into the
    fresh engine and returns its gathered params."""
    import gc
    import torch
    from deepspeed_tpu_torch import initialize, llama3_config
    from deepspeed_tpu_torch.comm.comms_logger import comms_logger
    from deepspeed_tpu_torch.ops import op_builder
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg = llama3_config(TRAIN_MODEL[0], **DA_MODEL)
    eng = initialize(cfg, conf, generator=torch.Generator(
        device=DEV).manual_seed(17), device=DEV)[0]
    out = {}
    if load:
        out["tag"] = eng.load_checkpoint(load)[0]
        out["loaded"] = _da_host(eng.gathered_params())
    mark = steps if mark is None else mark
    # the starting update targets, on the host: off the card's peak
    w0 = {k: v.detach().float().cpu() for k, v in _da_master(eng).items()}
    op_builder.reset_launches()
    comms_logger.reset()
    losses, step_s = [], []
    for i, b in enumerate(_da_batches(cfg.vocab_size, steps, pipe, rows)):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        losses.append(float(eng.train_batch(iter(b))))
        step_s.append(time.perf_counter() - t1)
        if i + 1 == mark:
            # the sketch's all-reduces and buffers stay out of the step's
            # records
            comms_logger.enabled = False
            peak = torch.cuda.max_memory_allocated()
            out["sketch"] = _da_sketch(eng, w0)
            torch.cuda.reset_peak_memory_stats()
            comms_logger.enabled = True
    del w0
    peak = max(peak, torch.cuda.max_memory_allocated()) if steps else \
        torch.cuda.max_memory_allocated()
    out.update({
        "losses": losses, "step_seconds": step_s,
        "ms_per_step": 1e3 * step_s[-1] if steps else None,
        "peak_hbm_gb": peak / 1e9,
        "comm_bytes": comms_logger.bytes_by_op(),
        "comm_bytes_by_axis": {f"{op}/{ax}": b for (op, ax), b in
                               comms_logger.bytes_by_axis().items()},
        "launches": dict(op_builder.launches)})
    if "werr" in (eng.opt_state or {}):
        out["werr_abs_sum"] = float(eng.opt_state["werr"].abs().sum())
        out["serr_abs_sum"] = float(eng.opt_state["serr"].abs().sum())
        out["flat_values"] = int(eng.opt_state["master"].numel())
        out["padded"] = int(eng.opt_state["werr"].shape[1])
    if eng.zero_stage == 3:
        # a rank's stage-3 shards: the stacked layers' and the others'
        out["mics_leaves"] = int(sum(getattr(eng, "_mics", ())))
        out["param_shard_bytes"] = {
            "layers": sum(x.numel() * x.element_size() for x, d in zip(
                eng._leaves, eng._pdim) if d is not None and x.dim() == 3),
            "other": sum(x.numel() * x.element_size() for x, d in zip(
                eng._leaves, eng._pdim) if d is not None and x.dim() != 3)}
    if save:
        eng.save_checkpoint(save)
        out["saved"] = _da_host(eng.gathered_params())
    comms_logger.enabled = False
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _da_host(tree):
    """A parameter tree's leaves on the host, as raw bits (bf16 as
    int16), keyed by path."""
    import torch
    out = {}

    def walk(t, p):
        if isinstance(t, dict):
            for k, v in t.items():
                walk(v, f"{p}/{k}" if p else k)
        else:
            x = t.detach().cpu().contiguous()
            out[p] = (x.view(torch.int16) if x.dtype == torch.bfloat16
                      else x).numpy().copy()
    walk(tree, "")
    return out


def _da_reference() -> dict:
    """(a)'s world-1 runs (no process group) in phase 13's main process:
    AdamW over the 1-bit run's steps, LAMB and Muon, on (a)'s batches."""
    import torch
    from deepspeed_tpu_torch.parallel.mesh import set_mesh
    set_mesh(None)
    torch.backends.cuda.matmul.allow_tf32 = True
    t0 = time.perf_counter()
    out = {"adamw": _da_train(_da_conf("adamw", 2), DA_FREEZE
                              + DA_COMPRESSED, mark=DA_FREEZE)}
    for opt in ("lamb", "muon"):
        out[opt] = _da_train(_da_conf(opt, 2), DA_STEPS)
    out["seconds"] = time.perf_counter() - t0
    return out


def _da_card(rank, world) -> dict:
    """Phase 17 (a) on a card rank of phase 13 (two gloo ranks on the
    card): 1-bit Adam at data 2, LAMB and Muon at data 2 stage 3 and at
    pipe 2."""
    from deepspeed_tpu_torch import build_mesh
    t0 = time.perf_counter()
    build_mesh(data=world)
    out = {"onebit": _da_train(_da_conf("onebitadam", 1),
                               DA_FREEZE + DA_COMPRESSED, mark=DA_FREEZE)}
    for opt in ("lamb", "muon"):
        out[f"{opt}_s3"] = _da_train(_da_conf(opt, 1, stage=3), DA_STEPS)
    build_mesh(pipe=world)
    for opt in ("lamb", "muon"):
        out[f"{opt}_pipe"] = _da_train(_da_conf(opt, 1, gas=2, pipe=world),
                                       DA_STEPS, pipe=world)
    out["seconds"] = time.perf_counter() - t0
    return out


def _da_report(smi, ranks) -> dict:
    """Phase 17 (a)'s lines and gates; returns its launches on both
    ranks."""
    from deepspeed_tpu_torch.ops import op_builder
    ref = _DA1
    launches = {k: 0 for k in op_builder.launches}
    model = "llama3-1b-width-depth2-vocab32k"
    got = [r["da"]["onebit"] for r in ranks]
    n, padded = got[0]["flat_values"], got[0]["padded"]
    rel = [abs(a - b) / abs(b) for a, b in zip(got[0]["losses"],
                                               ref["adamw"]["losses"])]
    upd = [_da_update_err(g["sketch"], ref["adamw"]["sketch"]) for g in got]
    line = {"phase": "data_axes", "part": "a_onebit", "model": model,
            "data": len(ranks), "dtype": "bfloat16", "seq": DA_SEQ,
            "freeze_step": DA_FREEZE, "compressed_steps": DA_COMPRESSED,
            "losses": got[0]["losses"],
            "losses_adamw_world1": ref["adamw"]["losses"],
            "warmup_loss_rel_err_vs_adamw": max(rel[:DA_FREEZE + 1]),
            "tol": DA_LOSS_TOL,
            "warmup_update_err_vs_adamw_per_rank": upd,
            "update_tol": DA_UPDATE_TOL["onebit"],
            "ranks_agree": got[0]["losses"] == got[1]["losses"],
            "flat_values": n, "padded": padded,
            "compressed_bytes_per_call": padded // 8 + 4,
            "fp32_allreduce_bytes_per_call": 4 * n,
            "comm_bytes_per_rank": [g["comm_bytes"] for g in got],
            "werr_abs_sum_per_rank": [g["werr_abs_sum"] for g in got],
            "serr_abs_sum_per_rank": [g["serr_abs_sum"] for g in got],
            "ms_per_step_per_rank": [g["ms_per_step"] for g in got],
            "step_ms_rank0": [1e3 * t for t in got[0]["step_seconds"]],
            "ms_per_step_adamw_world1": ref["adamw"]["ms_per_step"],
            "peak_hbm_gb_per_rank": [g["peak_hbm_gb"] for g in got],
            "k1_k3_launches_per_rank": [{k: g["launches"][k] for k in
                                         TRAIN_KERNELS} for g in got],
            "backend": "gloo through the host", "speed_claim": None,
            "nvidia_smi": smi}
    emit(line)
    assert all(np.isfinite(got[0]["losses"])) and line["ranks_agree"], line
    assert line["warmup_loss_rel_err_vs_adamw"] <= DA_LOSS_TOL, line
    assert all(u["worst_leaf"] <= DA_UPDATE_TOL["onebit"] for u in upd), \
        line
    for g in got:
        cb = g["comm_bytes"]
        assert cb["compressed_allreduce"] == DA_COMPRESSED * (
            padded // 8 + 4), line
        # the warmup's fp32 gradient all-reduces, and the 4-byte losses
        assert cb["all_reduce"] == DA_FREEZE * 4 * n + 4 * (
            DA_FREEZE + DA_COMPRESSED), line
        assert g["werr_abs_sum"] > 0 and g["serr_abs_sum"] > 0, line
        for k in TRAIN_KERNELS:
            assert g["launches"][k] > 0, line
    for r in ranks:
        for part in r["da"].values():
            if isinstance(part, dict):
                for k, v in part["launches"].items():
                    launches[k] += v
    for opt in ("lamb", "muon"):
        for where in ("s3", "pipe"):
            got = [r["da"][f"{opt}_{where}"] for r in ranks]
            want = ref[opt]
            rel = max(abs(a - b) / abs(b) for a, b in
                      zip(got[0]["losses"], want["losses"]))
            upd = [_da_update_err(g["sketch"], want["sketch"]) for g in got]
            line = {"phase": "data_axes", "part": f"a_{opt}_{where}",
                    "model": model, "dtype": "bfloat16",
                    "mesh": {"data": 2} if where == "s3" else {"pipe": 2},
                    "zero_stage": 3 if where == "s3" else 0,
                    "losses": got[0]["losses"],
                    "losses_world1": want["losses"],
                    "loss_rel_err_vs_world1": rel, "tol": DA_LOSS_TOL,
                    "update_err_vs_world1_per_rank": upd,
                    "update_tol": DA_UPDATE_TOL[opt],
                    "ranks_agree": got[0]["losses"] == got[1]["losses"],
                    "ms_per_step_per_rank": [g["ms_per_step"] for g in got],
                    "ms_per_step_world1": want["ms_per_step"],
                    "peak_hbm_gb_per_rank": [g["peak_hbm_gb"] for g in got],
                    "comm_bytes_per_rank": [g["comm_bytes"] for g in got],
                    "k1_k3_launches_per_rank": [
                        {k: g["launches"][k] for k in TRAIN_KERNELS}
                        for g in got],
                    "backend": "gloo through the host", "nvidia_smi": smi}
            emit(line)
            assert all(np.isfinite(got[0]["losses"])), line
            assert line["ranks_agree"] and rel <= DA_LOSS_TOL, line
            assert all(u["worst_leaf"] <= DA_UPDATE_TOL[opt]
                       for u in upd), line
            for g in got:
                for k in TRAIN_KERNELS:
                    assert g["launches"][k] > 0, line
    return launches


def _da_mics_card(root, rank, world) -> dict:
    """Phase 17 (b) on one of four gloo card ranks: MiCS at data 2 x
    data_inner 2 (saving to ``root``), plain stage 3 at data 4, and a
    plain stage-3 engine loading the MiCS save."""
    from deepspeed_tpu_torch import build_mesh
    t0 = time.perf_counter()
    build_mesh(data=2, data_inner=2)
    res = {"mics": _da_train(_da_conf(
        "adamw", 1, zero_optimization={"stage": 3, "mics_shard_size": 2}),
        DA_STEPS, save=root, rows=world)}
    build_mesh(data=world)
    res["plain"] = _da_train(_da_conf("adamw", 1, stage=3), DA_STEPS,
                             rows=world)
    res["load"] = _da_train(_da_conf("adamw", 1, stage=3), 0, load=root,
                            rows=world)
    res["seconds"] = time.perf_counter() - t0
    return res


def _da_mics(smi) -> dict:
    """Phase 17 (b): four card ranks of their own, when the host holds
    them; returns their launches."""
    import functools
    import shutil
    import tempfile
    from deepspeed_tpu_torch.ops import op_builder
    avail = _meminfo().get("MemAvailable", 0)
    if avail < DA_MICS_HOST_BYTES:
        emit({"phase": "data_axes", "part": "b_mics", "ran": False,
              "why": f"the host has {avail / 1e9:.1f} GB available, under "
                     f"the {DA_MICS_HOST_BYTES / 1e9:.0f} GB four card "
                     "ranks take; MiCS stays a CPU result "
                     "(tests/test_torch_mics.py)"})
        return {}
    here = os.path.dirname(os.path.abspath(__file__))
    os.makedirs(os.path.join(here, "build"), exist_ok=True)
    root = tempfile.mkdtemp(prefix="mics_ckpt_",
                            dir=os.path.join(here, "build"))
    t0 = time.perf_counter()
    try:
        got = _spawn_ranks("MiCS", [
            {"fn": functools.partial(_da_mics_card, root), "world": 4,
             "timeout": DA_RANK_TIMEOUT_S}])
    finally:
        shutil.rmtree(root, ignore_errors=True)
    mics, plain = [r["mics"] for r in got], [r["plain"] for r in got]
    rel = max(abs(a - b) / abs(b) for a, b in zip(mics[0]["losses"],
                                                  plain[0]["losses"]))
    upd = [_da_update_err(m["sketch"], p["sketch"])
           for m, p in zip(mics, plain)]
    # a rank sends its 1/2 share of each stage-3 weight a gather: each
    # layer twice a step (the forward, the backward's re-gather), every
    # other sharded leaf once; plain stage 3 sends its 1/4 share as often
    sub = {k: 2 * v if k == "layers" else v
           for k, v in mics[0]["param_shard_bytes"].items()}
    want_sub = sum(sub.values())
    got_sub = [m["comm_bytes_by_axis"].get("all_gather/data_inner", 0)
               / DA_STEPS for m in mics]
    bitwise = all(
        np.array_equal(r["load"]["loaded"][k], r["mics"]["saved"][k])
        for r in got for k in r["mics"]["saved"])
    line = {"phase": "data_axes", "part": "b_mics", "ran": True,
            "model": "llama3-1b-width-depth2-vocab32k", "dtype": "bfloat16",
            "mesh": {"data": 2, "data_inner": 2}, "mics_shard_size": 2,
            "losses": mics[0]["losses"], "losses_plain_stage3_world4":
            plain[0]["losses"], "loss_rel_err_vs_plain": rel,
            "tol": DA_LOSS_TOL, "update_err_vs_plain_per_rank": upd,
            "update_tol": DA_UPDATE_TOL["mics"],
            "ranks_agree": all(m["losses"] == mics[0]["losses"]
                               for m in mics),
            "mics_leaves": mics[0]["mics_leaves"],
            "param_gather_bytes_sent_per_step_per_rank": got_sub,
            "param_gather_bytes_formula": want_sub,
            "plain_comm_bytes_by_axis_per_step": {
                k: v / DA_STEPS for k, v in
                plain[0]["comm_bytes_by_axis"].items()},
            "plain_param_shard_bytes": plain[0]["param_shard_bytes"],
            "comm_bytes_by_axis_per_step": {
                k: v / DA_STEPS for k, v in
                mics[0]["comm_bytes_by_axis"].items()},
            "checkpoint_loads_into_plain_stage3_bitwise": bitwise,
            "ms_per_step_per_rank": [m["ms_per_step"] for m in mics],
            "ms_per_step_plain_per_rank": [p["ms_per_step"] for p in plain],
            "peak_hbm_gb_per_rank": [m["peak_hbm_gb"] for m in mics],
            "peak_hbm_gb_plain_per_rank": [p["peak_hbm_gb"] for p in plain],
            "k1_k3_launches_per_rank": [{k: m["launches"][k] for k in
                                         TRAIN_KERNELS} for m in mics],
            "card_rank_seconds": [r["seconds"] for r in got],
            "seconds": time.perf_counter() - t0,
            "backend": "gloo through the host", "speed_claim": None,
            "nvidia_smi": smi}
    emit(line)
    assert all(np.isfinite(mics[0]["losses"])) and line["ranks_agree"], line
    assert rel <= DA_LOSS_TOL, line
    assert all(u["worst_leaf"] <= DA_UPDATE_TOL["mics"] for u in upd), line
    assert got_sub == [want_sub] * 4, line
    assert bitwise, line
    launches = {k: 0 for k in op_builder.launches}
    for r in got:
        for part in ("mics", "plain"):
            for k, v in r[part]["launches"].items():
                launches[k] += v
    for m in mics:
        for k in TRAIN_KERNELS:
            assert m["launches"][k] > 0, line
    return launches


def _da_reduced() -> None:
    emit({"phase": "data_axes", "part": "reduced", "cuts": [
        f"depth {DA_MODEL['num_layers']} of 16 and vocabulary 32,000 "
        "(phases 15-16's cut), 1 x 2048 tokens a rank",
        f"(a) 1-bit Adam: {DA_FREEZE} warmup and {DA_COMPRESSED} "
        f"compressed steps; LAMB and Muon {DA_STEPS} steps each",
        f"(b) {DA_STEPS} steps of each run: gloo on one card, no speed "
        "claim"]})


def phase_data_axes(smi: str) -> dict:
    """Phase 17 (b) after phase 13 reported (a); returns the launches of
    (a) and (b)."""
    launches = dict(_DA_LAUNCHES)
    for k, v in _da_mics(smi).items():
        launches[k] = launches.get(k, 0) + v
    _da_reduced()
    return launches


def _da_spawn(smi) -> dict:
    """``--data-axes-only``: (a)'s world-1 references here, then two card
    ranks; returns (a)'s launches."""
    _DA1.clear()
    _DA1.update(_da_reference())
    got = _spawn_ranks("data-axes", [
        {"fn": _da_card, "key": "da", "world": 2,
         "timeout": DA_RANK_TIMEOUT_S}])
    emit({"phase": "data_axes", "part": "references",
          "world1_reference_seconds": _DA1["seconds"],
          "card_rank_seconds": [r["da"]["seconds"] for r in got]})
    return _da_report(smi, got)


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

    if "--train-dp-only" in sys.argv[1:]:
        # phase 12 alone (its kernels build on first use)
        run(phase_train_dp, smi)
        emit({"phase": "seconds", **seconds})
        return 0
    if "--sp-only" in sys.argv[1:]:
        # phase 15 alone: (a) on two card ranks of its own, (b), (c)
        _SP_LAUNCHES.update(run(_sp_spawn, smi))
        run(phase_sp, smi)
        emit({"phase": "seconds", **seconds})
        return 0
    if "--pipe-only" in sys.argv[1:]:
        # phase 16 alone: two card ranks and two CPU ranks of its own
        run(_pp_spawn, smi)
        emit({"phase": "seconds", **seconds})
        return 0
    if "--data-axes-only" in sys.argv[1:]:
        # phase 17 alone: (a) on two card ranks of its own, then (b)
        _DA_LAUNCHES.update(run(_da_spawn, smi))
        run(phase_data_axes, smi)
        emit({"phase": "seconds", **seconds})
        return 0
    if "--tp-zeropp-only" in sys.argv[1:]:
        # phases 12, 13 and 14 (13 holds tp 2 against 12's tp-1 runs; 14
        # its ranks against phase 8's run and phase 11 (e)'s int8 one)
        run(phase_train_moe)
        _v1_moe(smi, {k: 0 for k in op_builder.launches})
        run(phase_train_dp, smi)
        run(phase_tp_zeropp, smi)
        emit({"phase": "seconds", **seconds})
        return 0
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
    paths["train_dp"] = run(phase_train_dp, smi)
    paths["tp_zeropp"] = run(phase_tp_zeropp, smi)
    paths["ep"] = dict(_EP_LAUNCHES)
    paths["sp"] = dict(_SP_LAUNCHES)
    paths["pp"] = dict(_PP_LAUNCHES)
    paths["data_axes"] = run(phase_data_axes, smi)
    paths["long_context"] = run(phase_sp, smi)
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
    # in phase 3's qmm_* lines; K6 at Llama-3 1B's gradient size (phase
    # 3), its launches on ZeRO++'s path (phase 13 (c)), with its device
    # ms inside that step beside them
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
        if row["name"] == "quantize_blocks":
            row["in_zeropp_step"] = _K6_IN_STEP
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
        if row["name"] in TRAIN_KERNELS and _SP_TIMES:
            # phase 15: launches on the sp paths by shape, the time and
            # bound at T 131072 and at Ulysses' local heads
            row["sp"] = {
                "t131072": _SP_TIMES["t131072"][row["name"]],
                "ulysses_local_heads": {
                    k: _SP_TIMES["ulysses_local_heads"][row["name"]].get(k)
                    for k in ("shape", "kernel_ms", "plain_ms", "bound_ms",
                              "bound_by", "library_ms", "max_abs_err")}}
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
