"""Continuous-batching serving: paged KV cache, iteration-level
scheduler, slot-padded decode engine (``serve``)."""

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
    "Request",
    "Scheduler",
    "ServeEngine",
    "admission_plan",
    "blocks_at_admission",
    "blocks_for_tokens",
    "decode_needs_block",
    "gather_blocks",
    "pool_kv_bytes",
    "preemption_victim",
    "prefill_schedule",
    "write_token",
]
