"""Radix prefix cache: token prefixes → ref-counted KV pages.

Real serving traffic is dominated by shared prompts (system prompts,
few-shot prefixes); this trie maps page-sized token chunks to physical KV
pages so a request whose prompt shares a cached prefix skips prefill for
the shared pages entirely (the single biggest serving-throughput lever —
SGLang's RadixAttention, vLLM automatic prefix caching).

Granularity is one KV page (``block_size`` tokens): a trie edge is the
exact token chunk that filled a page. FULL pages are immutable once their
owner's prefill wrote them, so a hit aliases them in the new sequence's
page table (``BlockedAllocator.incref``). The last PARTIAL page of a
cached prompt is also stored (with its token span); its bytes beyond the
labeled span may later be overwritten by the inserter's decode, so a hit
on it is handed out copy-on-write (``engine.cow_block``) — the copy's
labeled span is valid prompt KV and everything past it is junk the
attention masks (``kpos < start``) can never read.

The cache is an OWNER of every page it holds (one ref each); eviction
drops that ref, and the page returns to the pool only when no live
sequence still shares it.

Copy of ``deepspeed_tpu/serving/prefix_cache.py`` (pure Python).
"""

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple


class _Node:
    __slots__ = ("chunk", "block", "children", "partials", "parent",
                 "last_used")

    def __init__(self, chunk: Tuple[int, ...], block: Optional[int],
                 parent: "Optional[_Node]"):
        self.chunk = chunk
        self.block = block            # physical page id (None for root)
        self.children: Dict[Tuple[int, ...], _Node] = {}
        # partial last pages: token-span → (block, last_used clock)
        self.partials: Dict[Tuple[int, ...], List[int]] = {}
        self.parent = parent
        self.last_used = 0


@dataclass
class PrefixMatch:
    """Result of a lookup. ``full_blocks`` alias as-is; ``partial_block``
    (if any) must be handed out copy-on-write. ``matched`` counts tokens
    covered (``len(full_blocks) * block_size + partial_len``)."""
    full_blocks: List[int] = field(default_factory=list)
    partial_block: Optional[int] = None
    partial_len: int = 0

    def matched(self, block_size: int) -> int:
        return len(self.full_blocks) * block_size + self.partial_len


class PrefixCache:

    def __init__(self, allocator, max_pages: Optional[int] = None,
                 tier=None):
        self.allocator = allocator
        self.block_size = allocator.block_size
        #: soft page cap; None → up to half the arena
        self.max_pages = (max_pages if max_pages is not None
                          else max(1, allocator.num_blocks // 2))
        #: optional vertical page tier (the reference's serving/kvtier.
        #: KVTier): eviction captures the page host-side BEFORE the
        #: allocator ref drops. The port has no KVTier yet, so the front
        #: end leaves it None.
        self.tier = tier
        self._root = _Node((), None, None)
        self._clock = 0
        self.pages_cached = 0
        self.lookups = 0
        self.hits = 0
        self.tokens_hit = 0
        #: eviction accounting, kept separately so a page that moved to
        #: the tier AND returned to the pool is never counted twice as
        #: "freed": ``pages_released`` counts pages the allocator
        #: actually reclaimed (refcount hit zero — free_blocks grew by
        #: exactly this much); ``pages_tiered`` counts pages whose KV
        #: entered the tier. A shared CoW prefix can be tiered while a
        #: live sequence keeps the physical page (tiered +1, released +0).
        self.pages_released = 0
        self.pages_tiered = 0

    # -- lookup ------------------------------------------------------------

    def match(self, tokens: List[int]) -> PrefixMatch:
        """Longest cached prefix of ``tokens`` at page granularity."""
        self.lookups += 1
        self._clock += 1
        bs = self.block_size
        node = self._root
        out = PrefixMatch()
        i = 0
        while i + bs <= len(tokens):
            key = tuple(tokens[i:i + bs])
            child = node.children.get(key)
            if child is None:
                break
            child.last_used = self._clock
            out.full_blocks.append(child.block)
            node = child
            i += bs
        # longest partial continuation under the deepest full node
        best: Optional[Tuple[Tuple[int, ...], List[int]]] = None
        for span, rec in node.partials.items():
            if len(span) <= len(tokens) - i and \
                    tuple(tokens[i:i + len(span)]) == span:
                if best is None or len(span) > len(best[0]):
                    best = (span, rec)
        if best is not None:
            best[1][1] = self._clock
            out.partial_block = best[1][0]
            out.partial_len = len(best[0])
        if out.matched(bs) > 0:
            self.hits += 1
            self.tokens_hit += out.matched(bs)
        return out

    @property
    def hit_rate(self) -> float:
        return self.hits / self.lookups if self.lookups else 0.0

    # -- insert ------------------------------------------------------------

    def insert(self, tokens: List[int], blocks: List[int]) -> int:
        """Cache the pages covering ``tokens`` (a fully-prefilled prompt
        whose KV lives in ``blocks``). Increfs every NEWLY cached page;
        already-cached chunks are left alone. Returns pages added."""
        bs = self.block_size
        self._clock += 1
        node = self._root
        added = 0
        n_full = len(tokens) // bs
        path = set()
        for i in range(n_full):
            key = tuple(tokens[i * bs:(i + 1) * bs])
            child = node.children.get(key)
            if child is None:
                # never evict a page on the path being inserted — the new
                # child would attach to a detached node and leak its ref
                if self.pages_cached >= self.max_pages and \
                        self.evict(1, exclude_blocks=path) == 0:
                    return added
                blk = blocks[i]
                self.allocator.incref([blk])
                child = _Node(key, blk, node)
                node.children[key] = child
                self.pages_cached += 1
                added += 1
            child.last_used = self._clock
            path.add(child.block)
            node = child
        rem = tokens[n_full * bs:]
        if rem and len(blocks) > n_full:
            span = tuple(rem)
            if span not in node.partials:
                if self.pages_cached >= self.max_pages and \
                        self.evict(1, exclude_blocks=path) == 0:
                    return added
                blk = blocks[n_full]
                self.allocator.incref([blk])
                node.partials[span] = [blk, self._clock]
                self.pages_cached += 1
                added += 1
            else:
                node.partials[span][1] = self._clock
        return added

    # -- eviction ----------------------------------------------------------

    def _token_path(self, node: _Node) -> List[int]:
        """Reconstruct the exact token prefix a trie node's page covers
        (root → node chunk concatenation) — the tier key for a captured
        page."""
        chunks: List[Tuple[int, ...]] = []
        while node is not None and node.parent is not None:
            chunks.append(node.chunk)
            node = node.parent
        return [t for chunk in reversed(chunks) for t in chunk]

    def _release(self, block: int, tokens: Optional[List[int]]) -> None:
        """Drop the cache's ref on one page, optionally capturing its KV
        into the tier first (the export must happen while the page is
        still live in the arena). Updates the split eviction accounting."""
        if self.tier is not None and tokens:
            if self.tier.capture(tokens, block):
                self.pages_tiered += 1
        self.pages_released += self.allocator.free([block])

    def _leaves(self, node: _Node, out: List[Tuple[int, object, object]]):
        for span, rec in node.partials.items():
            out.append((rec[1], node, span))
        for child in node.children.values():
            if not child.children and not child.partials:
                out.append((child.last_used, node, child))
            else:
                self._leaves(child, out)

    def evict(self, n_pages: int, exclude_blocks=()) -> int:
        """Drop the ``n_pages`` least-recently-used LEAF pages (inner trie
        pages are prefixes of live leaves and must outlive them);
        ``exclude_blocks`` protects pages an in-flight match/insert is
        about to hand out. Returns pages dropped; the allocator reclaims
        each page only once every sequence sharing it has also let go."""
        exclude = set(b for b in exclude_blocks if b is not None)
        dropped = 0
        while dropped < n_pages:
            leaves: List[Tuple[int, object, object]] = []
            self._leaves(self._root, leaves)
            leaves = [t for t in leaves
                      if (t[2].block if isinstance(t[2], _Node)
                          else t[1].partials[t[2]][0]) not in exclude]
            if not leaves:
                break
            leaves.sort(key=lambda t: t[0])
            _, parent, what = leaves[0]
            if isinstance(what, _Node):
                self._release(what.block, self._token_path(what))
                del parent.children[what.chunk]
            else:                           # partial span key
                self._release(parent.partials[what][0],
                              self._token_path(parent) + list(what))
                del parent.partials[what]
            self.pages_cached -= 1
            dropped += 1
        return dropped

    def _free_subtree(self, node: _Node) -> Tuple[int, int]:
        """Drop the cache's ref on every page below ``node`` (not
        ``node`` itself). Returns ``(dropped, released)``: refs this
        cache let go vs pages the ALLOCATOR actually reclaimed
        (refcount hit zero). The two must be reported separately —
        a page a live sequence still shares is dropped-but-not-released,
        and conflating them double-counts the pool. Fault path: pages
        are NEVER captured to the tier here (their KV is suspect)."""
        n = rel = 0
        for rec in node.partials.values():
            rel += self.allocator.free([rec[0]])
            n += 1
        node.partials.clear()
        for child in node.children.values():
            cn, crel = self._free_subtree(child)
            n += cn
            rel += crel
            rel += self.allocator.free([child.block])
            n += 1
        node.children.clear()
        return n, rel

    def invalidate(self, tokens: List[int]) -> int:
        """Drop every cached page reachable through ``tokens``' first
        chunk — the serving failure domain calls this when an engine
        fault may have left a request's KV suspect. A corrupt prefix
        page poisons every cached extension of it, so the whole subtree
        goes (over-invalidation only costs recompute; serving stale KV
        costs correctness). The tier's copies of the prefix are exactly
        as suspect, so they go too (and are never re-captured from
        here). Returns pages dropped; pages the allocator actually
        reclaimed accrue to ``pages_released``."""
        self._clock += 1
        dropped = 0
        root = self._root
        key = (tuple(tokens[:self.block_size])
               if len(tokens) >= self.block_size else None)
        child = root.children.get(key) if key is not None else None
        if child is not None:
            sub_n, sub_rel = self._free_subtree(child)
            dropped += sub_n
            self.pages_released += sub_rel
            self.pages_released += self.allocator.free([child.block])
            del root.children[key]
            dropped += 1
        for span in [s for s in list(root.partials)
                     if len(s) <= len(tokens)
                     and tuple(tokens[:len(s)]) == s]:
            self.pages_released += self.allocator.free(
                [root.partials[span][0]])
            del root.partials[span]
            dropped += 1
        self.pages_cached -= dropped
        if self.tier is not None:
            self.tier.invalidate(tokens)
        return dropped

    def owned_blocks(self) -> List[int]:
        """Every physical page id this cache holds a ref on (full trie
        pages + partial last pages). The handoff/accounting seam: a
        serialize→adopt→invalidate round trip must leave
        ``len(owned_blocks()) == pages_cached`` on both sides with no
        page double-counted."""
        out: List[int] = []

        def walk(node: _Node) -> None:
            for rec in node.partials.values():
                out.append(rec[0])
            for child in node.children.values():
                out.append(child.block)
                walk(child)

        walk(self._root)
        return out

    def evictable_pages(self) -> int:
        """Pages the cache could give back under arena pressure (all of
        them — eviction recurses leaf-inward)."""
        return self.pages_cached

    def clear(self) -> int:
        return self.evict(self.pages_cached)
