"""Continuous-batching serving: paged KV cache, iteration-level
scheduler, prefix cache, LoRA adapter pool, slot-padded decode engine
(``serve``)."""

from .adapters import (
    AdapterAllocator,
    AdapterPool,
    factor_rows,
    pool_adapter_bytes,
    random_adapter,
)
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
    "AdapterAllocator",
    "AdapterPool",
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
    "factor_rows",
    "gather_blocks",
    "pool_adapter_bytes",
    "pool_kv_bytes",
    "preemption_victim",
    "prefill_schedule",
    "random_adapter",
    "write_token",
]
