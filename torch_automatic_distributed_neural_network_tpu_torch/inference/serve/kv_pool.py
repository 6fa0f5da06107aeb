"""Paged KV cache: block-granular storage with per-request block tables.

The pool owns ONE block-granular store per side,

    k, v: [L, num_blocks, block_size, kvH, hd]

and each live request holds an ordered list of block ids (its *block
table*).  Token ``p`` of a request lives at ``(table[p // bs], p % bs)``.
Memory is O(tokens actually cached), blocks return to the free list the
step a request finishes, and a new prefill can reuse them immediately.

Block 0 is the **null block**: never allocated, never read through an
active mask.  Inactive decode slots keep a table of zeros, so the
slot-padded decode step can scatter their (garbage) token writes
somewhere harmless without per-slot branching.

int8 mode (``quantize=True``) stores ``{"q": int8, "scale": fp32}`` per
side via :func:`..quant.quantize_kv`: per-token-per-head scales, written
at the same (block, offset) the token lands in.

The pool is updated IN PLACE: ``pool.k[l]`` / ``pool.v[l]`` are views of
layer ``l`` of the stored tensors (dicts of views in int8 mode), and the
decode step writes each token into them directly.
"""

from __future__ import annotations

import math
from typing import Any

import torch

from ...utils.device import resolve_device
from ..quant import is_quantized_leaf, kv_leaf_parts, quantize_kv

NULL_BLOCK = 0  # reserved scratch target for inactive-slot writes


def blocks_for_tokens(n_tokens: int, block_size: int) -> int:
    """Blocks needed to hold ``n_tokens`` cache entries."""
    return max(1, math.ceil(n_tokens / block_size))


class BlockAllocator:
    """Ref-counted free-list allocator over ``num_blocks`` block ids.

    Block 0 (:data:`NULL_BLOCK`) is reserved and never handed out.
    ``acquire`` is all-or-nothing (returns None rather than a partial
    grant — admission control wants a clean fit check) and hands out
    blocks at refcount 1; ``ref`` adds a reference so a block can back
    several owners at once; ``release`` decrements and returns the block
    to the free list only at refcount 0.  A release of a block with no
    outstanding reference raises loudly: silent over-release is
    cross-request cache corruption.  ``alloc``/``free`` are aliases for
    the single-owner call sites.
    """

    def __init__(self, num_blocks: int):
        if num_blocks < 2:
            raise ValueError(
                f"need >= 2 blocks (one is the reserved null block), "
                f"got {num_blocks}")
        self.num_blocks = num_blocks
        # LIFO free list: recently-freed blocks are re-used first
        self._free = list(range(num_blocks - 1, 0, -1))
        self._refs: dict[int, int] = {}

    @property
    def n_free(self) -> int:
        return len(self._free)

    @property
    def n_live(self) -> int:
        return len(self._refs)

    @property
    def _live(self) -> set[int]:
        """Live block ids (refcount >= 1) — invariant-check view."""
        return set(self._refs)

    def refcount(self, block: int) -> int:
        """Outstanding references on ``block`` (0 when free)."""
        return self._refs.get(block, 0)

    def acquire(self, n: int) -> list[int] | None:
        """``n`` fresh block ids at refcount 1, or None if the pool
        cannot cover them."""
        if n < 0:
            raise ValueError(f"acquire({n})")
        if n > len(self._free):
            return None
        got = [self._free.pop() for _ in range(n)]
        for b in got:
            self._refs[b] = 1
        return got

    def ref(self, block: int) -> None:
        """Add a reference to an already-live block (a new owner)."""
        if block not in self._refs:
            raise ValueError(
                f"ref of block {block} not currently allocated")
        self._refs[block] += 1

    def release(self, blocks: list[int]) -> None:
        for b in blocks:
            n = self._refs.get(b, 0)
            if n <= 0:
                raise ValueError(
                    f"release of block {b} with no outstanding "
                    f"reference (double-free or foreign id)")
            if n == 1:
                del self._refs[b]
                self._free.append(b)
            else:
                self._refs[b] = n - 1

    # single-owner aliases
    alloc = acquire
    free = release


def pool_kv_bytes(cfg, num_blocks: int, block_size: int,
                  dtype=torch.bfloat16, quantize: bool = False) -> int:
    """Bytes of the k+v pool tensors (scales included in int8 mode)."""
    n_cells = cfg.n_layers * num_blocks * block_size * cfg.kv_heads
    if quantize:
        per_cell = cfg.head_dim * 1 + 4  # int8 payload + fp32 scale
    else:
        per_cell = cfg.head_dim * torch.empty((), dtype=dtype).element_size()
    return 2 * n_cells * per_cell  # k and v


def _zeros_side(shape, dtype, quantize: bool, device):
    if not quantize:
        return torch.zeros(shape, dtype=dtype, device=device)
    return {
        "q": torch.zeros(shape, dtype=torch.int8, device=device),
        "scale": torch.ones(shape[:-1] + (1,), dtype=torch.float32,
                            device=device),
    }


def _layer_views(leaf: Any, n_layers: int) -> list:
    if is_quantized_leaf(leaf):
        return [{"q": leaf["q"][i], "scale": leaf["scale"][i]}
                for i in range(n_layers)]
    return [leaf[i] for i in range(n_layers)]


def gather_blocks(kv_layer: Any, table: torch.Tensor,
                  dtype=torch.bfloat16) -> torch.Tensor:
    """Dense per-slot view of one layer's paged KV — the REFERENCE path.

    ``kv_layer``: [NB, bs, kvH, hd] (or its ``{"q","scale"}`` int8
    form); ``table``: [S, max_blocks] int32 -> [S, max_blocks*bs, kvH,
    hd].  Table rows are padded with :data:`NULL_BLOCK`; the garbage
    gathered from those pages sits beyond each slot's context length and
    the attention mask never admits it.  An fp pool that already stores
    ``dtype`` skips the conversion."""
    payload, scale = kv_leaf_parts(kv_layer)
    idx = table.to(torch.int64)
    if scale is not None:
        g = (payload[idx].to(torch.float32) * scale[idx]).to(dtype)
    else:
        g = payload[idx]
        if g.dtype != dtype:
            g = g.to(dtype)
    S, MB, bs, H, hd = g.shape
    return g.reshape(S, MB * bs, H, hd)


def write_token(kv_layer: Any, table: torch.Tensor, pos: torch.Tensor,
                new: torch.Tensor) -> None:
    """Scatter one token per slot into its paged position, in place.

    ``new``: [S, kvH, hd] (this step's k or v), ``pos``: [S] absolute
    context positions.  The target is ``(table[s, pos // bs], pos % bs)``
    per slot; inactive slots carry all-null tables so their writes land
    in the scratch block.  int8 mode quantizes the token with its own
    per-head scale."""
    bs = kv_leaf_parts(kv_layer)[0].shape[1]
    pos = pos.to(torch.int64)
    blk = torch.gather(table.to(torch.int64), 1, (pos // bs)[:, None])[:, 0]
    off = pos % bs
    if is_quantized_leaf(kv_layer):
        q = quantize_kv(new)
        kv_layer["q"][blk, off] = q["q"]
        kv_layer["scale"][blk, off] = q["scale"]
        return
    kv_layer[blk, off] = new.to(kv_layer.dtype)


class PagedKVPool:
    """Device storage + allocator + host-side table building.

    ``self.kv`` holds the stacked ``{"k": .., "v": ..}`` tensors with a
    leading layer axis; ``self.k[l]`` / ``self.v[l]`` are layer ``l``'s
    views of them, which the decode step updates in place.  ``device``
    defaults to ``cuda`` and raises without it."""

    def __init__(self, cfg, *, num_blocks: int, block_size: int,
                 dtype=torch.bfloat16, quantize: bool = False,
                 device=None):
        self.cfg = cfg
        self.block_size = int(block_size)
        self.dtype = dtype
        self.quantize = bool(quantize)
        self.device = resolve_device(device)
        self.allocator = BlockAllocator(num_blocks)
        # prefill->decode block-transfer accounting (ship_prefill)
        self.n_transfers = 0
        self.transferred_blocks = 0
        self.transferred_bytes = 0
        shape = (cfg.n_layers, num_blocks, block_size,
                 cfg.kv_heads, cfg.head_dim)
        self.kv = {side: _zeros_side(shape, dtype, quantize, self.device)
                   for side in ("k", "v")}
        self.k = _layer_views(self.kv["k"], cfg.n_layers)
        self.v = _layer_views(self.kv["v"], cfg.n_layers)

    @property
    def num_blocks(self) -> int:
        return self.allocator.num_blocks

    @property
    def total_bytes(self) -> int:
        return pool_kv_bytes(self.cfg, self.num_blocks, self.block_size,
                             self.dtype, self.quantize)

    @property
    def bytes_per_block(self) -> int:
        """Bytes one block id holds across all layers, k and v (scales
        included in int8 mode)."""
        return pool_kv_bytes(self.cfg, 1, self.block_size,
                             self.dtype, self.quantize)

    def alloc(self, n: int) -> list[int] | None:
        return self.allocator.alloc(n)

    def free(self, blocks: list[int]) -> None:
        self.allocator.free(blocks)

    def _leaves(self):
        for leaf in self.kv.values():
            if is_quantized_leaf(leaf):
                yield leaf["q"]
                yield leaf["scale"]
            else:
                yield leaf

    def fork_block(self, src: int) -> int | None:
        """Copy-on-write fork: acquire a fresh block, copy ``src``'s
        content into it, return the new id (None when the pool is
        exhausted).  The caller owns the table update and the release of
        its reference on ``src``."""
        got = self.allocator.acquire(1)
        if got is None:
            return None
        dst = got[0]
        for t in self._leaves():
            t[:, dst] = t[:, src]
        return dst

    def read_blocks(self, blocks: list[int], max_blocks: int,
                    dtype=torch.bfloat16
                    ) -> tuple[torch.Tensor, torch.Tensor]:
        """Dense dequantized view of a block list, padded to a fixed
        width: (k, v) each ``[L, max_blocks * bs, kvH, hd]``; rows past
        the real blocks hold null-block garbage."""
        table = torch.tensor(self.table_row(blocks, max_blocks),
                             dtype=torch.int64, device=self.device)
        out = []
        for side in ("k", "v"):
            payload, scale = kv_leaf_parts(self.kv[side])
            g = payload[:, table]  # [L, MB, bs, H, hd]
            if scale is not None:
                g = (g.to(torch.float32) * scale[:, table]).to(dtype)
            elif g.dtype != dtype:
                g = g.to(dtype)
            L, MB, bs, H, hd = g.shape
            out.append(g.reshape(L, MB * bs, H, hd))
        return out[0], out[1]

    def table_row(self, blocks: list[int], max_blocks: int) -> list[int]:
        """Fixed-width table row: allocated ids then null padding."""
        if len(blocks) > max_blocks:
            raise ValueError(
                f"{len(blocks)} blocks exceed table width {max_blocks}")
        return list(blocks) + [NULL_BLOCK] * (max_blocks - len(blocks))

    def write_prefill(self, blocks: list[int], k, v) -> None:
        """Copy a dense prefill cache slice into allocated blocks.

        ``k``/``v``: [L, P, kvH, hd] (the batch-1 prefill cache row,
        squeezed) — or, in int8 mode, the already-quantized
        ``{"q", "scale"}`` form of those rows, committed verbatim.  P is
        right-padded (zeros; scales with 1) to a whole number of blocks;
        the pad cells are dead until the decode steps overwrite them."""
        if is_quantized_leaf(k) != is_quantized_leaf(v):
            raise ValueError("k/v must both be dense or both quantized")
        if is_quantized_leaf(k):
            if not self.quantize:
                raise ValueError(
                    "quantized prefill rows into a dense pool")
            L, P, H, hd = k["q"].shape
        else:
            L, P, H, hd = k.shape
        n = len(blocks)
        pad = n * self.block_size - P
        if pad < 0:
            raise ValueError(
                f"{P} prefill tokens need "
                f"{blocks_for_tokens(P, self.block_size)} blocks, "
                f"got {n}")
        idx = torch.tensor(blocks, dtype=torch.int64, device=self.device)

        def blocked(x, fill=0):
            x = x.to(self.device)
            filler = torch.full((L, pad, H, x.shape[-1]), fill,
                                dtype=x.dtype, device=self.device)
            x = torch.cat([x, filler], dim=1)
            return x.reshape(L, n, self.block_size, H, x.shape[-1])

        for side, rows in (("k", k), ("v", v)):
            leaf = self.kv[side]
            if is_quantized_leaf(rows):
                leaf["q"][:, idx] = blocked(rows["q"])
                leaf["scale"][:, idx] = blocked(rows["scale"], fill=1)
            elif self.quantize:
                q = quantize_kv(blocked(rows))
                leaf["q"][:, idx] = q["q"]
                leaf["scale"][:, idx] = q["scale"]
            else:
                leaf[:, idx] = blocked(rows).to(leaf.dtype)

    def ship_prefill(self, blocks: list[int], k, v) -> int:
        """``write_prefill`` plus block-transfer accounting: blocks and
        bytes shipped at pool storage precision.  Returns the bytes
        moved."""
        self.write_prefill(blocks, k, v)
        moved = len(blocks) * self.bytes_per_block
        self.n_transfers += 1
        self.transferred_blocks += len(blocks)
        self.transferred_bytes += moved
        return moved
