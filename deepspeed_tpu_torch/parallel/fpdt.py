"""FPDT — the Fully Pipelined Distributed Transformer's long-context tier.

Port of ``deepspeed_tpu/parallel/fpdt.py`` (``host_offload_supported``
:34, ``fpdt_attention`` :51, ``fpdt_ffn`` :147; reference
``sequence/fpdt_layer.py``: ``_FPDTGPUOffloadingAttentionImpl_`` :510,
``update_out_and_lse`` :58, ``FPDT_FFN`` :1056).

:func:`fpdt_attention` is chunked online-softmax attention whose K/V
chunk store lives in host memory. On the card the store is pinned, and
each chunk a query chunk needs is copied to one of two device buffers on
a side stream while the previous chunk's math runs on the compute stream
— the reference's manual double buffer (the JAX package leaves that
overlap to XLA's scheduler, ``jax.device_put`` into ``pinned_host``). A
query chunk reads only the chunks at or below the causal diagonal: the
JAX version computes the ones above it and masks them to nothing, so the
result is the same. Keys and values may be handed in on the host (the
store is then read where it lies) or on the card (copied out to the
store first). The block math is plain matmuls, as in the JAX module,
whose FPDT runs outside any Pallas kernel.

:func:`fpdt_ffn` runs the MLP one sequence tile at a time
(``activation_checkpointing.ffn_chunk``).
"""

import math
from typing import Callable, List, Optional

import torch
from torch.utils.checkpoint import checkpoint

_NEG_INF = -1e30

#: the fp32 bytes of one score block (a query chunk × a key chunk × the
#: heads of one pass); a chunk's kv heads are taken in groups that fit
SCORE_BLOCK_BYTES = 128 << 20

#: the last :func:`fpdt_attention` call's K/V traffic to its device: the
#: bytes copied from the host store and the chunk reads
last_call = {"h2d_bytes": 0, "chunk_reads": 0}


def host_offload_supported() -> bool:
    """Whether the KV store can be pinned host memory: pinning needs the
    CUDA driver (fpdt.py:34's ``pinned_host`` memory kind)."""
    return torch.cuda.is_available()


def _pad_seq(x: torch.Tensor, pad: int) -> torch.Tensor:
    if not pad:
        return x
    return torch.cat([x, x.new_zeros((x.shape[0], pad) + x.shape[2:])],
                     dim=1)


def _store(x: torch.Tensor, nc: int, chunk: int, pinned: bool
           ) -> torch.Tensor:
    """The chunk store [nc, B, chunk, KvH, Dh] in host memory: ``x``
    itself where it already lies there chunk-major (one row), else a
    copy — pinned on the card's path (a failure to pin raises; the JAX
    package warns and keeps KV on the device instead)."""
    b = x.shape[0]
    view = x.reshape((b, nc, chunk) + x.shape[2:]).transpose(0, 1)
    if not pinned:
        return view.contiguous()
    if x.device.type == "cpu" and x.is_pinned() and b == 1 \
            and not torch.is_grad_enabled():
        return view                     # read where it lies
    try:
        store = torch.empty(view.shape, dtype=x.dtype, pin_memory=True)
    except RuntimeError as e:
        raise RuntimeError(
            f"fpdt_attention: could not pin {_nbytes(view)} bytes of host "
            f"memory for the KV store: {e}") from e
    store.copy_(view)
    return store


def _nbytes(x: torch.Tensor) -> int:
    return x.numel() * x.element_size()


def _attend_chunk(qg, kj, vj, acc, m, l, mask, scale, inplace: bool):
    """Fold one key chunk into one query chunk's online softmax
    (fpdt.py:109-129), fp32 scores and sums: qg [B, c, KvH, G, Dh],
    kj/vj [B, s, KvH, Dh]; acc [B, KvH, G, c, Dh] fp32, m/l [B, KvH, G,
    c] fp32; ``mask`` [c, s] bool (True: visible) or None (the block is
    visible whole). ``inplace`` (no autograd): the score block is reused
    for the probabilities, so one [.., c, s] fp32 block is live at a
    time."""
    s = torch.einsum("bckgd,bskd->bkgcs", qg.float(), kj.float())
    if inplace:
        s.mul_(scale)
        if mask is not None:
            s.masked_fill_(~mask, _NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        # at or below the diagonal every row sees a key: nothing is dead
        p = s.sub_(m_new[..., None]).exp_()
        corr = (m - m_new).exp_()
        l.mul_(corr).add_(p.sum(dim=-1))
        acc.mul_(corr[..., None]).add_(torch.einsum(
            "bkgcs,bskd->bkgcd", p, vj.float()))
        return acc, m_new, l
    s = s * scale
    if mask is not None:
        s = torch.where(mask[None, None, None], s,
                        torch.full((), _NEG_INF, device=s.device))
    m_new = torch.maximum(m, s.amax(dim=-1))
    p = torch.exp(s - m_new[..., None])
    alive = m_new > _NEG_INF / 2
    zero = torch.zeros((), dtype=torch.float32, device=s.device)
    p = torch.where(alive[..., None], p, zero)
    corr = torch.where(alive, torch.exp(m - m_new), zero)
    acc = acc * corr[..., None] + torch.einsum("bkgcs,bskd->bkgcd", p,
                                               vj.float())
    l = l * corr + p.sum(dim=-1)
    return acc, m_new, l


def fpdt_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   chunk: int = 1024, causal: bool = True,
                   offload: Optional[bool] = None) -> torch.Tensor:
    """Chunked online-softmax attention with host-resident KV.

    q: [B, T, H, Dh] on the device that computes; k/v: [B, T, KvH, Dh],
    on that device or on the host. The device holds one query chunk's
    accumulators and two KV chunks at a time, whatever T. ``offload``
    None puts the store in pinned host memory when q is on the card;
    False on the card keeps K/V there (the chunks are read in place). On
    CPU tensors the store is plain host memory. T not divisible by
    ``chunk`` is zero-padded at the sequence end (exact: padded keys sit
    above every real query's causal horizon; padded query rows are sliced
    off).

    TRAINING CAUTION: reverse-mode AD through the chunk loops stores
    per-iteration softmax intermediates (O(T²) bytes across the loop) —
    fine at the lengths the tests cover, ruinous at 100K+. For
    long-context TRAINING use the Pallas flash path with the
    ``offload_save_attn_kernel_host`` remat policy (its custom VJP
    recomputes scores from out/lse); fpdt attention serves forward/
    serving paths and shapes the flash kernel does not support.
    """
    dev = q.device
    t_real = q.shape[1]
    pad = (-t_real) % chunk
    q, k, v = _pad_seq(q, pad), _pad_seq(k, pad), _pad_seq(v, pad)
    b, t, h, dh = q.shape
    kvh = k.shape[2]
    groups = h // kvh
    nc = t // chunk
    on_card = dev.type == "cuda"
    if offload is None:
        offload = on_card
    grad = torch.is_grad_enabled() and any(
        x.requires_grad for x in (q, k, v))
    if on_card and not offload:
        kc = k.reshape(b, nc, chunk, kvh, dh).transpose(0, 1)
        vc = v.reshape(b, nc, chunk, kvh, dh).transpose(0, 1)
    else:
        kc, vc = (_store(x, nc, chunk, on_card) for x in (k, v))
    scale = 1.0 / math.sqrt(dh)
    # kv heads a pass: the score block stays within SCORE_BLOCK_BYTES
    hg = max(1, min(kvh, SCORE_BLOCK_BYTES // (b * groups * chunk * chunk
                                               * 4)))
    while kvh % hg:
        hg -= 1
    passes = kvh // hg
    feed = _ChunkFeed(kc, vc, dev, overlap=on_card and offload and not grad)
    out = None if grad else q.new_empty((b, t, h, dh))
    outs: List[torch.Tensor] = []
    arange = torch.arange(chunk, device=dev)
    #: the diagonal block's causal mask, and the last chunk's real keys
    #: (without the causal mask the padded keys would be seen)
    tri = arange[:, None] >= arange[None, :]
    tail = (arange < t_real - (nc - 1) * chunk)[None, :].expand(chunk, chunk) \
        if pad and not causal else None
    for i in range(nc):
        qg = q[:, i * chunk:(i + 1) * chunk].reshape(b, chunk, kvh, groups,
                                                     dh)
        acc = [torch.zeros((b, hg, groups, chunk, dh), dtype=torch.float32,
                           device=dev) for _ in range(passes)]
        m = [torch.full((b, hg, groups, chunk), _NEG_INF,
                        dtype=torch.float32, device=dev)
             for _ in range(passes)]
        l = [torch.zeros((b, hg, groups, chunk), dtype=torch.float32,
                         device=dev) for _ in range(passes)]
        last = i if causal else nc - 1
        for j in range(last + 1):
            kj, vj = feed.get(j, j == last, i + 1 < nc)
            mask = tri if causal and j == i else \
                tail if j == nc - 1 else None
            for n in range(passes):
                sl = slice(n * hg, (n + 1) * hg)
                acc[n], m[n], l[n] = _attend_chunk(
                    qg[:, :, sl], kj[:, :, sl], vj[:, :, sl], acc[n], m[n],
                    l[n], mask, scale, inplace=not grad)
            feed.done()
        a = torch.cat(acc, dim=1) if passes > 1 else acc[0]
        ll = torch.cat(l, dim=1) if passes > 1 else l[0]
        o = a / ll.clamp_min(1e-30)[..., None]
        # [b, kvh, g, c, dh] -> [b, c, h, dh]
        o = o.permute(0, 3, 1, 2, 4).reshape(b, chunk, h, dh).to(q.dtype)
        if out is None:
            outs.append(o)
        else:
            out[:, i * chunk:(i + 1) * chunk] = o
        del acc, m, l, a, ll, o
    feed.close()
    last_call.update(h2d_bytes=feed.h2d_bytes, chunk_reads=feed.reads)
    if out is None:
        out = torch.cat(outs, dim=1)
    return out[:, :t_real] if pad else out


class _ChunkFeed:
    """The K/V chunks on the computing device, in the order the loops
    read them (row i: chunks 0..last). From a pinned store on the card
    with ``overlap``: two device buffers, each filled on a side stream
    while the other is read; the copy into a buffer waits for the compute
    stream to be done with its previous chunk. Otherwise each chunk is
    read where it lies or copied on the current stream (under autograd,
    which records the copy there)."""

    def __init__(self, kc, vc, dev, overlap: bool):
        self.kc, self.vc, self.dev, self.overlap = kc, vc, dev, overlap
        self.h2d_bytes = self.reads = 0
        if not overlap:
            return
        self.stream = torch.cuda.Stream(device=dev)
        self.bufs = [(torch.empty(kc.shape[1:], dtype=kc.dtype, device=dev),
                      torch.empty(vc.shape[1:], dtype=vc.dtype, device=dev))
                     for _ in range(2)]
        self.ready = [torch.cuda.Event() for _ in range(2)]
        self.free = [None, None]
        self.slot = {}              # chunk index -> buffer, this row
        self.turn = 0
        self.queued = []            # chunks issued, in read order

    def _issue(self, j: int) -> None:
        s = self.turn
        self.turn ^= 1
        with torch.cuda.stream(self.stream):
            if self.free[s] is not None:
                self.stream.wait_event(self.free[s])
            kb, vb = self.bufs[s]
            kb.copy_(self.kc[j], non_blocking=True)
            vb.copy_(self.vc[j], non_blocking=True)
            self.ready[s].record(self.stream)
        self.h2d_bytes += _nbytes(kb) + _nbytes(vb)
        self.queued.append((j, s))

    def get(self, j: int, last_for_row: bool, more_rows: bool):
        self.reads += 1
        if not self.overlap:
            kj, vj = self.kc[j], self.vc[j]
            if kj.device != self.dev:
                self.h2d_bytes += _nbytes(kj) + _nbytes(vj)
                kj, vj = kj.to(self.dev), vj.to(self.dev)
            return kj, vj
        if not self.queued:
            self._issue(j)
        qj, s = self.queued.pop(0)
        assert qj == j, (qj, j)
        # prefetch the next chunk the loops read into the other buffer
        nxt = j + 1 if not last_for_row else (0 if more_rows else None)
        if nxt is not None:
            self._issue(nxt)
        torch.cuda.current_stream(self.dev).wait_event(self.ready[s])
        self.cur = s
        return self.bufs[s]

    def done(self) -> None:
        if not self.overlap:
            return
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(self.dev))
        self.free[self.cur] = ev

    def close(self) -> None:
        if self.overlap:
            torch.cuda.current_stream(self.dev).wait_stream(self.stream)


def fpdt_ffn(mlp_fn: Callable[[torch.Tensor], torch.Tensor],
             x: torch.Tensor, chunk: int = 1024,
             remat: bool = True) -> torch.Tensor:
    """The MLP one sequence tile of ``chunk`` tokens at a time, each tile
    under ``torch.utils.checkpoint`` when gradients are on, so the
    [T, ffn]-sized activations become [chunk, ffn]-sized. x [B, T, D]; a
    T that ``chunk`` does not divide zero-pads the last tile (the MLP is
    per token, so the padding is exact and is cut off again)."""
    t = x.shape[1]
    pad = (-t) % chunk
    tiles = _pad_seq(x, pad).split(chunk, dim=1)
    if remat and torch.is_grad_enabled():
        outs = [checkpoint(mlp_fn, xc, use_reentrant=False) for xc in tiles]
    else:
        outs = [mlp_fn(xc) for xc in tiles]
    out = torch.cat(outs, dim=1)
    return out[:, :t] if pad else out
