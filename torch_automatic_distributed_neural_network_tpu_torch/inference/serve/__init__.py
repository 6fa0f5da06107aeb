"""Continuous-batching serving: paged KV cache, iteration-level
scheduler, prefix cache, slot-padded decode engine (``serve``)."""

from .engine import ServeEngine
from .kv_pool import (
    NULL_BLOCK,
    BlockAllocator,
    PagedKVPool,
    blocks_for_tokens,
    gather_blocks,
    pool_kv_bytes,
    write_token,
)
from .prefix_cache import PrefixCache, block_hashes
from .scheduler import (
    IDENTITY_ADAPTER,
    Request,
    Scheduler,
    admission_plan,
    blocks_at_admission,
    decode_needs_block,
    preemption_victim,
    prefill_schedule,
)

__all__ = [
    "IDENTITY_ADAPTER",
    "NULL_BLOCK",
    "BlockAllocator",
    "PagedKVPool",
    "PrefixCache",
    "Request",
    "Scheduler",
    "ServeEngine",
    "admission_plan",
    "block_hashes",
    "blocks_at_admission",
    "blocks_for_tokens",
    "decode_needs_block",
    "gather_blocks",
    "pool_kv_bytes",
    "preemption_victim",
    "prefill_schedule",
    "write_token",
]
