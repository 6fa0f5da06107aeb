"""Cross-request prefix reuse: a radix index over resident KV blocks.

The JAX package's ``inference/serve/prefix_cache.py``, which imports no
jax, copied over the port's ref-counted ``BlockAllocator``: the same
radix walk, the same eviction order and the same ``serve.prefix``
journal records.  The keys differ in one way: a LoRA tenant's keys are
seeded with its adapter's name (:func:`block_hashes`), so a tenant never
reuses KV that the base model or another tenant computed (the JAX
package keys on tokens alone and matches across tenants); base-model
keys are the JAX package's.

Production serving traffic is prefix-heavy — thousands of tenants share
one system prompt or few-shot preamble, and re-prefilling that preamble
per request is redundant compute.  The paged pool already
stores KV block-granularly; this module adds the missing piece: an
index from *prompt content* to *resident blocks*, so a new request's
prompt is matched block-by-block against KV some earlier request
already computed and only the uncached suffix is prefilled.

Granularity is the FULL block: a block is reusable only when every one
of its ``block_size`` token positions is determined by the prompt
prefix it covers.  Keys are **chained content hashes** — block ``i``'s
key hashes its own token ids together with block ``i-1``'s key, so a
key names the entire prefix up to and including the block, never just
its local tokens (two prompts sharing block 3's tokens but differing in
block 0 must not collide).  The chain makes the index a radix tree over
block-sized token runs: each node is one (prefix-hash -> block id)
mapping, children extend the prefix by one block.

Reference discipline (the allocator is ref-counted, kv_pool):

- the index holds exactly ONE reference per cached block, taken at
  ``insert`` and dropped at eviction;
- ``match`` takes NO references — the caller (scheduler admission)
  refs each matched block into the request's table;
- a node is *evictable* only when it is a leaf (no children — dropping
  an interior node would orphan the chained keys below it) and the
  index holds the block's only reference (refcount == 1, i.e. no live
  request's table points at it).  ``evict`` drops evictable leaves
  LRU-first by last hit; freeing a leaf may expose its parent, so one
  call can reclaim a whole cold chain.

The index stores block *ids*, never KV payloads — pool memory is
shared, not copied, which is the whole point.  Host-side metadata is
O(live blocks) small (a hash string, a couple of pointers and a
timestamp per node).
"""

from __future__ import annotations

import hashlib
import time
from typing import Callable

from .kv_pool import BlockAllocator, NULL_BLOCK


def block_hashes(tokens: list[int], block_size: int,
                 adapter: str | None = None) -> list[str]:
    """Chained content keys of every FULL block of ``tokens``.

    ``h_i = H(h_{i-1} || tokens[i*bs : (i+1)*bs])`` — each key commits
    to the whole prefix through its block.  Trailing partial blocks
    get no key (their positions are not fully prompt-determined).

    The chain's seed commits to the LoRA ``adapter`` the KV was computed
    through (None: the base model, the JAX package's seed): an adapter
    changes the k/v projections, so one tenant's blocks are not
    another's, whatever the tokens."""
    keys: list[str] = []
    prev = b"root" if adapter is None else (
        b"root|adapter|" + adapter.encode())
    for i in range(len(tokens) // block_size):
        blk = tokens[i * block_size:(i + 1) * block_size]
        h = hashlib.sha256(
            prev + b"|" + ",".join(map(str, blk)).encode())
        keys.append(h.hexdigest()[:24])
        prev = h.digest()
    return keys


class _Node:
    __slots__ = ("key", "block", "parent", "children", "last_hit",
                 "expires_at")

    def __init__(self, key: str, block: int, parent: "_Node | None",
                 last_hit: float, expires_at: float | None = None):
        self.key = key
        self.block = block
        self.parent = parent
        self.children: dict[str, _Node] = {}
        self.last_hit = last_hit
        # lease expiry (clock units); None = pinned until evicted by
        # pressure.  An expired node is dead to ``match`` immediately
        # and physically reclaimed lazily (match/evict sweeps).
        self.expires_at = expires_at


class PrefixCache:
    """Radix index of resident prompt-prefix KV blocks.

    Owns one allocator reference per indexed block; all block ids point
    into the engine's :class:`~.kv_pool.PagedKVPool`.
    """

    def __init__(self, *, block_size: int, allocator: BlockAllocator,
                 clock: Callable[[], float] = time.monotonic,
                 journal=None):
        self.block_size = int(block_size)
        self.allocator = allocator
        self.clock = clock
        # optional obs.journal.Journal: TTL reclamation emits
        # ``serve.prefix kind=expire`` events through it
        self.journal = journal
        self._root = _Node("", NULL_BLOCK, None, 0.0)
        self._nodes: dict[str, _Node] = {}
        # earliest lease expiry across the index, or None when no node
        # carries a TTL — lets the expiry sweep short-circuit on the
        # (default) TTL-free hot path
        self._next_expiry: float | None = None
        # lifetime counters (report/bench surface these)
        self.queries = 0
        self.hit_requests = 0
        self.hit_tokens = 0
        self.inserted_blocks = 0
        self.evicted_blocks = 0
        self.expired_blocks = 0

    # -- introspection -------------------------------------------------------

    @property
    def n_blocks(self) -> int:
        """Blocks currently indexed."""
        return len(self._nodes)

    def blocks(self) -> set[int]:
        """The indexed block ids (invariant checks)."""
        return {n.block for n in self._nodes.values()}

    def n_evictable(self) -> int:
        """Blocks reclaimable RIGHT NOW: unreferenced leaves plus the
        chain links they would expose — i.e. every block whose whole
        subtree is index-only.  This is the slack admission control may
        plan against on top of the allocator's free list."""

        def count(node: _Node) -> tuple[int, bool]:
            n = 0
            all_evictable = True
            for c in node.children.values():
                cn, ce = count(c)
                n += cn
                all_evictable &= ce
            if node is self._root:
                return n, all_evictable
            mine = (all_evictable
                    and self.allocator.refcount(node.block) == 1)
            return n + (1 if mine else 0), mine

        return count(self._root)[0]

    # -- lookup / publish ----------------------------------------------------

    def match(self, tokens: list[int], *, max_tokens: int | None = None,
              keys: list[str] | None = None) -> tuple[list[int], int]:
        """Longest indexed prefix of ``tokens``: (block ids, n tokens).

        Walks the chained keys from the root; stops at the first miss.
        ``max_tokens`` caps the match (the caller passes ``n_prompt - 1``
        rounded down to its alignment unit, so at least one prompt
        token is always recomputed — first-token logits must exist —
        and, in int8 mode, reuse stays on prefill-chunk boundaries for
        bit-exact parity with the uncached path).  Takes no block
        references and does not bump counters — ``record_query`` does,
        once per admitted request.  ``keys`` supplies precomputed
        chained hashes (admission planning matches every queued request
        every step; the scheduler memoizes them per request).
        """
        limit = len(tokens) if max_tokens is None else max_tokens
        if keys is None:
            keys = block_hashes(tokens, self.block_size)
        self.expire()
        blocks: list[int] = []
        node = self._root
        now = self.clock()
        for i, key in enumerate(keys):
            if (i + 1) * self.block_size > limit:
                break
            child = node.children.get(key)
            if child is None:
                break
            if child.expires_at is not None and now >= child.expires_at:
                # lease lapsed but the block is still pinned by a live
                # table (the sweep could not drop it): dead to matching
                # regardless — stale content must not extend its own
                # residency by being re-hit
                break
            child.last_hit = now
            blocks.append(child.block)
            node = child
        return blocks, len(blocks) * self.block_size

    def record_query(self, n_cached_tokens: int) -> None:
        """Bump hit/miss counters for one admitted request."""
        self.queries += 1
        if n_cached_tokens:
            self.hit_requests += 1
            self.hit_tokens += n_cached_tokens

    def insert(self, tokens: list[int], blocks: list[int], *,
               ttl_s: float | None = None,
               adapter: str | None = None) -> int:
        """Publish a prefill's full prompt blocks; returns how many new
        nodes were indexed.  ``blocks[i]`` must hold the KV of tokens
        ``[i*bs, (i+1)*bs)`` (the caller passes a committed table
        prefix).  Prefixes already indexed are left as-is — the first
        publisher wins, even if this request recomputed the same
        content into different blocks — and each NEWLY indexed block
        gains one allocator reference owned by the index.

        ``ttl_s`` bounds residency: nodes published with a TTL stop
        matching ``ttl_s`` clock units after their LAST publish and are
        reclaimed lazily (the match/evict expiry sweeps) — one tenant's
        stale system prompts cannot pin index leaves forever.  A
        re-publish of already-indexed content renews its lease (the
        content is demonstrably still live traffic).  ``adapter``: the
        LoRA tenant whose weights computed the blocks (None: the base
        model), part of every key."""
        new = 0
        node = self._root
        now = self.clock()
        expires = None if ttl_s is None else now + float(ttl_s)
        for i, key in enumerate(block_hashes(tokens, self.block_size,
                                             adapter)):
            if i >= len(blocks):
                break
            child = node.children.get(key)
            if child is None:
                child = _Node(key, blocks[i], node, now, expires)
                node.children[key] = child
                self._nodes[key] = child
                self.allocator.ref(blocks[i])
                new += 1
            elif ttl_s is not None:
                child.last_hit = now
                if child.expires_at is not None:
                    child.expires_at = max(child.expires_at, expires)
            node = child
        if expires is not None and new:
            if self._next_expiry is None or expires < self._next_expiry:
                self._next_expiry = expires
        self.inserted_blocks += new
        return new

    # -- eviction ------------------------------------------------------------

    def _evictable_leaves(self) -> list[_Node]:
        return [n for n in self._nodes.values()
                if not n.children
                and self.allocator.refcount(n.block) == 1]

    def expire(self) -> int:
        """Reclaim every expired-lease block that is droppable right
        now (unreferenced leaf, walking up exposed parents); returns
        how many were freed.  Lazy: runs at the top of ``match`` and
        ``evict``, never on a timer, and short-circuits to a no-op
        until the earliest lease in the index has actually lapsed.
        Expired nodes still pinned by a live table stay resident (the
        pool reference discipline owns them) but never match; they are
        picked up by a later sweep once released."""
        now = self.clock()
        if self._next_expiry is None or now < self._next_expiry:
            return 0
        freed = 0
        while True:
            victims = [node for node in self._evictable_leaves()
                       if node.expires_at is not None
                       and now >= node.expires_at]
            if not victims:
                break
            for node in victims:
                self._drop(node)
            freed += len(victims)
        self._next_expiry = min(
            (node.expires_at for node in self._nodes.values()
             if node.expires_at is not None), default=None)
        if freed:
            self.expired_blocks += freed
            if self.journal is not None:
                self.journal.event("serve.prefix", kind="expire",
                                   n_blocks=freed,
                                   index_blocks=len(self._nodes))
        return freed

    def evict(self, n: int) -> int:
        """Reclaim up to ``n`` blocks, expired leases first, then the
        coldest (least-recent hit) unreferenced leaves; returns how
        many were freed.  Runs under allocator pressure BEFORE any live
        slot is preempted — dropping cold reusable KV is strictly
        cheaper than recomputing a live request."""
        freed = 0
        expired = self.expire()
        if expired >= n:
            return expired
        n -= expired
        while freed < n:
            leaves = self._evictable_leaves()
            if not leaves:
                break
            victim = min(leaves, key=lambda x: (x.last_hit, x.key))
            self._drop(victim)
            freed += 1
        self.evicted_blocks += freed
        return expired + freed

    def _drop(self, node: _Node) -> None:
        assert not node.children, "evicting an interior radix node"
        assert node.parent is not None
        del node.parent.children[node.key]
        del self._nodes[node.key]
        self.allocator.release([node.block])

    def clear(self) -> int:
        """Drop every index-only chain (shutdown/tests)."""
        total = 0
        while True:
            got = self.evict(len(self._nodes) or 1)
            total += got
            if not got:
                return total
