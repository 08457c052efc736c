"""KV-page handoff between disaggregated prefill and decode replicas.

Prefill and decode sit on opposite corners of the roofline (compute-bound
ragged prefill vs bandwidth-bound decode), so the router can run them on
separate replica pools — but only if a finished prefill's KV pages can
move. This module is that move: serialize the radix-cached pages covering
a prompt out of the prefill replica's arena (``engine.export_pages``),
ship them as a checksummed :class:`PageBundle`, and adopt them into the
decode replica's arena + radix cache (``engine.import_pages`` +
``PrefixCache.insert``), where the decode leg's normal ``adopt_cached``
admission aliases them and re-prefills only the folded first token.

The failure domain is deliberately boring: a bundle that is torn
(checksum mismatch — ``handoff_torn``), timed out (``handoff_stall``),
or simply absent adopts ZERO pages, and the decode replica re-prefills
the folded prompt from scratch. Tokens are never carried in the bundle —
they ride the router's fold — so a failed handoff costs recompute, never
correctness.

Ownership protocol (the accounting the round-trip test pins down):
``adopt_bundle`` allocates destination pages (refcount 1, ours), imports
the KV, offers them to the destination cache (``insert`` increfs what it
keeps), then drops its own ref — pages the cache kept end at refcount 1
owned by the cache; pages it declined (already cached, page-cap) return
to the pool. The source side then ``invalidate``s the shipped subtree, so
neither arena leaks a page and no page is double-freed.

Copy of ``deepspeed_tpu/serving/handoff.py`` (pure Python).
"""

import zlib
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np


@dataclass
class PageBundle:
    """One prefill's cached KV pages in transit.

    ``tokens`` are the prompt tokens the pages cover (full pages first,
    then the partial last page's span); ``pages`` is the
    ``engine.export_pages`` payload (``{"k","v"}: [kvh, L, m, bs, dh]``);
    ``checksum`` is CRC32 over the payload bytes — :func:`verify_bundle`
    is the torn-transfer detector."""
    tokens: List[int]
    block_size: int
    pages: Dict[str, np.ndarray] = field(repr=False)
    checksum: int = 0

    @property
    def num_pages(self) -> int:
        return int(self.pages["k"].shape[2]) if self.pages else 0

    @property
    def nbytes(self) -> int:
        return sum(int(a.nbytes) for a in self.pages.values())


def _checksum(pages: Dict[str, np.ndarray]) -> int:
    crc = 0
    for key in sorted(pages):
        crc = zlib.crc32(np.ascontiguousarray(pages[key]).tobytes(), crc)
    return crc


def verify_bundle(bundle: PageBundle) -> bool:
    """True when the payload still matches its checksum (not torn)."""
    return bundle.checksum == _checksum(bundle.pages)


def export_bundle(frontend, prompt: List[int]) -> Optional[PageBundle]:
    """Serialize the radix-cached pages covering ``prompt`` from a
    prefill replica. Returns ``None`` when nothing is cached (no prefix
    cache, or the prompt's pages were already evicted) — the caller
    falls back to decode-side re-prefill.

    Read-only on the source: pages stay cached (and refcounted) until
    the caller invalidates the subtree after the ship."""
    cache = getattr(frontend, "cache", None)
    if cache is None:
        return None
    bs = cache.block_size
    m = cache.match(prompt)
    blocks = list(m.full_blocks)
    covered = len(blocks) * bs
    if m.partial_block is not None:
        blocks.append(m.partial_block)
        covered += m.partial_len
    if not blocks:
        return None
    pages = frontend.engine.export_pages(blocks)
    return PageBundle(tokens=[int(t) for t in prompt[:covered]],
                      block_size=bs, pages=pages,
                      checksum=_checksum(pages))


def adopt_bundle(frontend, bundle: PageBundle) -> int:
    """Adopt a shipped bundle into a decode replica's arena + radix
    cache; returns pages the destination cache now holds (0 → caller
    falls back to plain re-prefill). Never leaks: destination pages are
    allocated, imported, offered to the cache, and this function's own
    ref is dropped whether or not the cache kept them."""
    cache = getattr(frontend, "cache", None)
    n = bundle.num_pages
    if cache is None or n == 0:
        return 0
    alloc = frontend.engine.state.allocator
    if n > alloc.free_blocks:
        cache.evict(n - alloc.free_blocks)
    if n > alloc.free_blocks:
        return 0
    blocks = alloc.allocate(n)
    try:
        frontend.engine.import_pages(bundle.pages, blocks)
        added = cache.insert(bundle.tokens, blocks)
    finally:
        alloc.free(blocks)
    return added
