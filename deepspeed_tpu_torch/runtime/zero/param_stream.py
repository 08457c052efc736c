"""ZeRO-Infinity parameter tier: train a decoder whose weights stay off the
card, streamed one layer at a time.

Port of ``deepspeed_tpu/runtime/zero/param_stream.py`` (reference
``runtime/zero/stage3.py:703`` → ``runtime/swap_tensor/
partitioned_param_swapper.py``: partitioned parameters swapped between
NVMe/DRAM and the device, fetched right before use), at one device. The
unit of streaming is a layer of the stacked decoder:

* The authoritative weights live in ``params.bin`` in the compute dtype,
  beside the NVMe optimizer tier's master and moment files
  (``runtime/zero/infinity.py``); ``engine.params`` is None.
  ``offload_param.device: 'nvme'`` puts it on disk, ``'cpu'`` on
  ``/dev/shm`` (host memory) unless ``nvme_path`` names a directory.
* Forward: the embedding runs from the resident tail (every top-level
  leaf but ``layers``, kept on the card); each layer's weights are read
  from the store into a pinned buffer, put on the card and applied with
  :func:`models.transformer.decoder_block` (K1 on CUDA), and the layer's
  input is kept. The next layer's reads are issued while the card
  computes. Peak card memory is one layer, the activations and the tail,
  whatever the depth.
* Backward: the layers stream again in reverse; each is recomputed from
  its kept input under ``torch.enable_grad()`` and ``torch.autograd.grad``
  gives dx and the layer's gradients (K3 on CUDA). The gradients go to
  ``grads.bin`` in fp32 with a running sum of squares, so global-norm
  clipping is exact; micro-batches after the first accumulate into
  ``grads.bin`` by read, add and write.
* Update: a windowed Adam sweep over the master, moment and gradient
  files narrows the new master into ``params.bin``; the tail is uploaded
  again.

Dense decoders only, bf16 or fp32 (no fp16 loss scaling), one device: the
reference's construction checks.
"""

import math
import os
from typing import Any, Dict, List, Optional, Tuple

import torch

from deepspeed_tpu_torch.models import transformer
from deepspeed_tpu_torch.ops import host_adam
from deepspeed_tpu_torch.runtime.zero.offload import (FlatLayout,
                                                      host_buffer)
from deepspeed_tpu_torch.utils.logging import log_dist

Params = Any


class _LayerRanges:
    """Flat-file ranges of one layer's leaves inside the stacked layout
    (param_stream.py:65). A stacked leaf [L, ...] occupies one contiguous
    block, so layer l of leaf k is ``leaf_off[k] + l * per_layer[k]`` for
    ``per_layer[k]`` elements."""

    def __init__(self, layout: FlatLayout):
        idx = [i for i, p in enumerate(layout.paths) if p[0] == "layers"]
        self.paths = [layout.paths[i][1:] for i in idx]
        self.num_layers = layout.shapes[idx[0]][0]
        self.leaf_off = [layout.offsets[i] for i in idx]
        self.shapes = [layout.shapes[i][1:] for i in idx]
        self.per_layer = [math.prod(s) for s in self.shapes]
        self.layer_elems = sum(self.per_layer)

    def ranges(self, l: int) -> List[Tuple[int, int]]:
        return [(off + l * n, n)
                for off, n in zip(self.leaf_off, self.per_layer)]

    def tree(self, leaves: List[torch.Tensor]) -> Params:
        out: Dict[str, Any] = {}
        for path, leaf in zip(self.paths, leaves):
            node = out
            for k in path[:-1]:
                node = node.setdefault(k, {})
            node[path[-1]] = leaf
        return out


class _FileStore:
    """A flat file of ``total`` items through the async I/O engine."""

    def __init__(self, path: str, total: int, itemsize: int, aio):
        self.path = path
        self.itemsize = itemsize
        self.aio = aio
        with open(path, "wb") as fh:
            fh.truncate(total * itemsize)

    def read(self, out: torch.Tensor, elem_off: int) -> None:
        self.aio.pread(self.path, out, elem_off * self.itemsize)

    def write(self, arr: torch.Tensor, elem_off: int) -> None:
        self.aio.pwrite(self.path, arr, elem_off * self.itemsize)

    def drain(self) -> None:
        errs = self.aio.drain()
        if errs:
            raise OSError(f"parameter tier store {self.path}: {errs} I/O "
                          f"requests failed")


class ParamStreamCoordinator:
    """Layer-streamed train path for ``offload_param.device != none``
    (param_stream.py:105)."""

    def __init__(self, engine, mesh=None):
        from deepspeed_tpu_torch.runtime.model_factory import \
            select_attention
        from deepspeed_tpu_torch.runtime.zero.infinity import \
            NVMeOffloadOptimizer
        if mesh is not None and mesh.shape["data"] > 1:
            raise NotImplementedError(
                "the parameter tier at dp > 1 is not ported to "
                "deepspeed_tpu_torch yet (ROADMAP A, 'Offload')")
        self.engine = engine
        dec = engine.model.decoder_config
        if dec is None:
            raise ValueError("offload_param requires a DecoderConfig model "
                             "(the layer-streamed path is model-aware)")
        if dec.num_experts:
            raise ValueError("offload_param does not compose with MoE yet")
        if engine.fp16_enabled:
            raise ValueError("offload_param requires bf16/fp32")
        if not isinstance(engine.host_optimizer, NVMeOffloadOptimizer):
            raise ValueError(
                "offload_param requires offload_optimizer.device 'nvme' "
                "(or 'cpu', which maps to the same tier on /dev/shm) — "
                "the master weights live in the tiered store")
        self.dec = dec
        self.gas = int(engine.config.gradient_accumulation_steps)
        self.opt = engine.host_optimizer
        self.layout: FlatLayout = self.opt.layout
        self.device = engine.device
        self.pin = self.device.type == "cuda"
        self.attn_fn = select_attention(engine.config, dec)
        self.windows = dec.window_per_layer() if dec.layer_window_pattern \
            else [None] * dec.num_layers
        self.lr_ranges = _LayerRanges(self.layout)
        self.compute_dtype = engine.compute_dtype
        self._p_item = torch.empty((), dtype=self.compute_dtype) \
            .element_size()
        root = os.path.dirname(self.opt.files["master"])
        self.params_store = _FileStore(
            os.path.join(root, "params.bin"), self.layout.total,
            self._p_item, self.opt.aio)
        self.grads_store = _FileStore(
            os.path.join(root, "grads.bin"), self.layout.total, 4,
            self.opt.aio)
        self._res_idx = [i for i, p in enumerate(self.layout.paths)
                         if p[0] != "layers"]
        # two pinned layer buffers: layer l+1 is read into one while the
        # card computes from the other; each remembers its last upload
        self._hbufs = [host_buffer(self.lr_ranges.layer_elems,
                                   self.compute_dtype, self.pin)
                       for _ in range(2)]
        self._hbuf_events: List[Optional[Any]] = [None, None]
        self._seed_store(engine.params)
        # the store is authoritative now: keep only the resident tail
        self.resident = {k: v for k, v in engine.params.items()
                         if k != "layers"}
        for leaf in self._resident_leaves():
            leaf.requires_grad_(False)
        #: bytes read from and written to the store by the last step
        self.bytes_moved = 0
        log_dist(
            f"ZeRO-Infinity param tier: "
            f"{self.layout.total * self._p_item / 2**30:.2f} GiB params + "
            f"{self.layout.total * 4 / 2**30:.2f} GiB grads in {root} "
            f"({self.lr_ranges.num_layers} streamed layers, "
            f"{self.lr_ranges.layer_elems / 1e6:.1f}M elements a layer)")

    def store_bytes(self) -> int:
        """Bytes of the tier's files: weights, gradients, master and
        moments."""
        return self.layout.total * (self._p_item + 4 + 12)

    # ------------------------------------------------------------ setup
    def _seed_store(self, params: Params) -> None:
        """Weights → ``params.bin``, leaf by leaf in the compute dtype."""
        for leaf, off in zip(self.layout.leaves(params), self.layout.offsets):
            host = leaf.detach().reshape(-1).to("cpu", self.compute_dtype)
            self.params_store.write(host.contiguous(), off)
            self.params_store.drain()

    def _resident_leaves(self) -> List[torch.Tensor]:
        out = []
        for i in self._res_idx:
            node = self.resident
            for k in self.layout.paths[i]:
                node = node[k]
            out.append(node)
        return out

    # --------------------------------------------------------- layer IO
    def _issue_layer(self, l: int) -> Tuple[int, int]:
        """Submit layer ``l``'s reads into a free pinned buffer without
        waiting (param_stream.py:259); :meth:`_complete_layer` finishes
        it. The I/O drain is a global barrier, so no issued layer may stay
        pending across the optimizer sweep (it rewrites params.bin)."""
        k = l % 2
        ev = self._hbuf_events[k]
        if ev is not None:
            ev.synchronize()      # the buffer's last upload has finished
            self._hbuf_events[k] = None
        buf, pos = self._hbufs[k], 0
        for off, n in self.lr_ranges.ranges(l):
            self.params_store.read(buf[pos:pos + n], off)
            pos += n
        self.bytes_moved += pos * self._p_item
        return l, k

    def _complete_layer(self, issued: Tuple[int, int]) -> Params:
        _l, k = issued
        self.params_store.drain()
        dev = self._hbufs[k].to(self.device, non_blocking=self.pin)
        if self.pin:
            ev = torch.cuda.Event()
            ev.record()
            self._hbuf_events[k] = ev
        leaves, pos = [], 0
        for n, shape in zip(self.lr_ranges.per_layer, self.lr_ranges.shapes):
            leaves.append(dev[pos:pos + n].view(shape))
            pos += n
        return leaves

    def _write_layer_grads(self, l: int, grads: List[torch.Tensor],
                           accumulate: bool, want_ssq: bool) -> float:
        """Layer gradients → grads.bin in fp32; ``accumulate`` adds to what
        the store holds (micro-batches 2..gas). Returns the sum of squares
        of the written values when ``want_ssq`` (the last micro-batch's
        values are the step's gradient)."""
        ranges = self.lr_ranges.ranges(l)
        return self._write_grads(list(zip(ranges, grads)), accumulate,
                                 want_ssq)

    def _write_grads(self, items, accumulate: bool, want_ssq: bool
                     ) -> float:
        prevs = None
        if accumulate:
            # the whole batch's reads behind one drain
            prevs = [torch.empty(n) for (_off, n), _g in items]
            for ((off, _n), _g), buf in zip(items, prevs):
                self.grads_store.read(buf, off)
            self.grads_store.drain()
        ssq = 0.0
        for i, ((off, _n), g) in enumerate(items):
            g = g.detach().reshape(-1).to("cpu", torch.float32).contiguous()
            if prevs is not None:
                g += prevs[i]
            if want_ssq:
                ssq += host_adam.l2_norm_sq(g)
            self.grads_store.write(g, off)
            self.bytes_moved += g.numel() * 4 * (2 if accumulate else 1)
        self.grads_store.drain()
        return ssq

    # ------------------------------------------------------- train step
    def _tokens_labels(self, micro: Dict[str, torch.Tensor]):
        tokens = micro["input_ids"]
        labels = micro.get("labels")
        if labels is None:
            labels = torch.cat([tokens[:, 1:],
                                torch.full_like(tokens[:, :1], -100)], dim=1)
        return tokens, labels

    def _rope(self, tokens: torch.Tensor):
        b, t = tokens.shape
        positions = torch.arange(t, dtype=torch.int32,
                                 device=tokens.device)[None].expand(b, t)
        if self.dec.pos_emb == "rope":
            sin, cos = transformer.rope_table(self.dec, positions)
        else:
            sin = cos = torch.zeros((b, t, 0), dtype=torch.float32,
                                    device=tokens.device)
        return positions, sin, cos

    def _embed(self, res: Params, tokens, positions) -> torch.Tensor:
        return transformer.embed_tokens(self.dec, res["embed"], tokens,
                                        positions, res.get("embed_norm"))

    def _head_loss(self, res: Params, x: torch.Tensor,
                   labels: torch.Tensor) -> torch.Tensor:
        xn = transformer._norm(self.dec, res["final_norm"], x) \
            if self.dec.has_final_norm else x
        return transformer.chunked_cross_entropy(self.dec, res, xn, labels)

    def _layer(self, leaves, x, sin, cos, l: int) -> torch.Tensor:
        out, _aux = transformer.decoder_block(
            self.dec, self.lr_ranges.tree(leaves), x, sin, cos, self.attn_fn,
            None, self.windows[l])
        return out

    def _resident_with_grad(self) -> Tuple[Params, List[torch.Tensor]]:
        """A copy of the tail's tree whose leaves require grad (views of
        the resident tensors)."""
        leaves = [t.detach().requires_grad_() for t in
                  self._resident_leaves()]
        tree: Dict[str, Any] = {}
        for i, leaf in zip(self._res_idx, leaves):
            node = tree
            path = self.layout.paths[i]
            for k in path[:-1]:
                node = node.setdefault(k, {})
            node[path[-1]] = leaf
        return tree, leaves

    def train_step(self, micros: List[Dict[str, torch.Tensor]]
                   ) -> torch.Tensor:
        """One optimizer step over ``gas`` micro-batches (on the engine's
        device); returns the mean loss and sets the engine's metrics."""
        eng = self.engine
        L = self.lr_ranges.num_layers
        gas = self.gas
        self.bytes_moved = 0
        loss_sum = None
        dres: Optional[List[torch.Tensor]] = None
        ssq = 0.0
        for m, micro in enumerate(micros):
            tokens, labels = self._tokens_labels(micro)
            positions, sin, cos = self._rope(tokens)
            last = m == gas - 1
            # forward: stream layers, keep their inputs; layer l+1's reads
            # are issued right after layer l's compute is queued, and the
            # last issue is layer L-1 again: the first backward layer,
            # read under the head's backward
            with torch.no_grad():
                x = self._embed(self.resident, tokens, positions)
                stash = [x]
                pending = self._issue_layer(0)
                for l in range(L):
                    leaves = self._complete_layer(pending)
                    x = self._layer(leaves, x, sin, cos, l)
                    stash.append(x)
                    pending = self._issue_layer(l + 1 if l + 1 < L
                                                else L - 1)
            res, res_leaves = self._resident_with_grad()
            x_top = stash[-1].detach().requires_grad_()
            with torch.enable_grad():
                loss = self._head_loss(res, x_top, labels)
                # the seed 1/gas makes the accumulated gradients the mean
                # over micro-batches, as the fused engine's
                seed = torch.full((), 1.0 / gas, dtype=loss.dtype,
                                  device=loss.device)
                g = torch.autograd.grad(loss, [x_top] + res_leaves, seed,
                                        allow_unused=True)
            dx, dres_m = g[0], list(g[1:])
            loss_sum = loss.detach() if loss_sum is None \
                else loss_sum + loss.detach()
            # backward: stream layers in reverse, recompute from the kept
            # input; micro-batches past the first accumulate in grads.bin
            for l in reversed(range(L)):
                leaves = [t.detach().requires_grad_()
                          for t in self._complete_layer(pending)]
                x_in = stash[l].detach().requires_grad_()
                with torch.enable_grad():
                    out = self._layer(leaves, x_in, sin, cos, l)
                    g = torch.autograd.grad(out, [x_in] + leaves, dx)
                dx = g[0]
                if l > 0:
                    pending = self._issue_layer(l - 1)
                ssq_l = self._write_layer_grads(l, list(g[1:]),
                                                accumulate=m > 0,
                                                want_ssq=last)
                if last:
                    ssq += ssq_l
                del g, leaves, out, x_in
                stash[l + 1] = None
            with torch.enable_grad():
                emb = self._embed(res, tokens, positions)
                g_emb = torch.autograd.grad(emb, res_leaves, dx,
                                            allow_unused=True)
            dres_m = [_add(a, b) for a, b in zip(dres_m, g_emb)]
            dres = dres_m if dres is None else \
                [_add(a, b) for a, b in zip(dres, dres_m)]
            del stash
        loss = loss_sum / gas
        items = [((self.layout.offsets[i], self.layout.sizes[i]),
                  g if g is not None else torch.zeros(self.layout.sizes[i]))
                 for i, g in zip(self._res_idx, dres)]
        ssq += self._write_grads(items, False, True)

        gnorm = math.sqrt(ssq)
        lr = float(eng.lr_schedule(eng.global_steps))
        clip = float(eng.config.gradient_clipping or 0.0)
        scale = clip / (gnorm + 1e-6) if clip > 0 and gnorm > clip else 1.0
        self._optimizer_sweep(lr, scale)
        self._reload_resident()
        eng._last_metrics = {"grad_norm": gnorm, "overflow": 0, "lr": lr,
                             "loss": loss}
        return loss

    @torch.no_grad()
    def eval_step(self, micro: Dict[str, torch.Tensor]) -> torch.Tensor:
        """Forward-only streamed loss (param_stream.py:425)."""
        tokens, labels = self._tokens_labels(micro)
        positions, sin, cos = self._rope(tokens)
        L = self.lr_ranges.num_layers
        x = self._embed(self.resident, tokens, positions)
        pending = self._issue_layer(0)
        for l in range(L):
            leaves = self._complete_layer(pending)
            x = self._layer(leaves, x, sin, cos, l)
            if l + 1 < L:
                pending = self._issue_layer(l + 1)
        return self._head_loss(self.resident, x, labels)

    # ----------------------------------------------------------- update
    def _optimizer_sweep(self, lr: float, clip_scale: float) -> None:
        """Windowed Adam over the tiered (master, m, v, grads) files,
        narrowing the new master into params.bin (param_stream.py:446)."""
        opt = self.opt
        opt.adam.step_count += 1
        total, W = self.layout.total, opt.window
        gbuf = opt._scratch
        pbuf = torch.empty(W, dtype=self.compute_dtype)
        for off in range(0, total, W):
            n = min(W, total - off)
            b = {k: opt._bufs[k][0][:n] for k in opt.files}
            for name in opt.files:
                opt.aio.pread(opt.files[name], b[name], off * 4)
            self.grads_store.read(gbuf[:n], off)
            opt._drain()
            g = gbuf[:n]
            if clip_scale != 1.0:
                g.mul_(clip_scale)
            opt.adam.step_buffers(b["master"], g, b["exp_avg"],
                                  b["exp_avg_sq"], opt.adam.step_count, lr)
            for name in opt.files:
                opt.aio.pwrite(opt.files[name], b[name], off * 4)
            opt._narrow(b["master"], pbuf, 0)
            self.params_store.write(pbuf[:n], off)
            opt._drain()
        self.bytes_moved += total * (4 * 7 + self._p_item)

    def _reload_resident(self) -> None:
        """Upload the tail again from the updated store, in place."""
        for i, leaf in zip(self._res_idx, self._resident_leaves()):
            n = self.layout.sizes[i]
            buf = torch.empty(n, dtype=self.compute_dtype)
            self.params_store.read(buf, self.layout.offsets[i])
            self.params_store.drain()
            with torch.no_grad():
                leaf.copy_(buf.view(leaf.shape))

    # ------------------------------------------------------- checkpoint
    def full_params(self) -> Params:
        """The whole parameter tree from the store, as host tensors in the
        compute dtype (``full_params_np``, param_stream.py:486:
        checkpoint time only)."""
        flat = torch.empty(self.layout.total, dtype=self.compute_dtype)
        W = self.opt.window
        for off in range(0, self.layout.total, W):
            n = min(W, self.layout.total - off)
            self.params_store.read(flat[off:off + n], off)
        self.params_store.drain()
        return self.layout.unflatten(flat)


def _add(a: Optional[torch.Tensor], b: Optional[torch.Tensor]):
    if a is None:
        return b
    return a if b is None else a + b
