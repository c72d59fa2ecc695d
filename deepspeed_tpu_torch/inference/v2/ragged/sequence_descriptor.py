"""Sequence bookkeeping (port of
``deepspeed_tpu/inference/v2/ragged/sequence_descriptor.py``)."""

import dataclasses
from typing import List


@dataclasses.dataclass
class DSSequenceDescriptor:
    uid: int
    seen_tokens: int = 0          # tokens already resident in the KV cache
    in_flight_tokens: int = 0     # tokens scheduled in the current forward
    kv_blocks: List[int] = dataclasses.field(default_factory=list)
    # host handle while the sequence's KV lives in the swap tier
    # (ragged/kv_cache.py swap_out) — kv_blocks is empty meanwhile
    swap_handle: object = None
    # prefix-cache bookkeeping, populated only when prefix_caching is on:
    # every token routed through the sequence (prompt + generated), and the
    # chain digest of each committed full block (digests[i] commits to
    # tokens[:(i+1)*block_size] and labels kv_blocks[i] in the cache)
    tokens: List[int] = dataclasses.field(default_factory=list)
    digests: List[bytes] = dataclasses.field(default_factory=list)

    @property
    def is_swapped(self) -> bool:
        return self.swap_handle is not None

    @property
    def cur_allocated_blocks(self) -> int:
        return len(self.kv_blocks)

    def extend_blocks(self, blocks):
        self.kv_blocks.extend(blocks)

    def post_forward(self):
        """Commit in-flight tokens after a forward (reference
        ``sequence_descriptor.py`` seen_tokens update)."""
        self.seen_tokens += self.in_flight_tokens
        self.in_flight_tokens = 0
