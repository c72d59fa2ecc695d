"""Block-granular prefix cache over the paged KV pool (port of
``deepspeed_tpu/inference/v2/ragged/prefix_cache.py``; vLLM-style automatic
prefix caching adapted to the blocked allocator).

Every FULL block of a sequence's token stream gets a chain digest
``H(parent_digest, block_tokens)`` — the digest of block *i* therefore
commits to the entire token prefix ``tokens[:(i+1)*block_size]``, so a single
dict lookup per block walks the longest cached prefix. The cache maps
digests to physical block ids; matching sequences take an extra reference on
the shared block (``BlockedAllocator.ref``) and simply list it in their block
table — paged attention indirects through block ids, so kernels never notice
the sharing.

COW boundary: only FULL blocks are ever shared. The ragged engine only
writes a sequence's *partial tail* block (new tokens append there), so a
shared full block is immutable by construction and no device copy is needed.
A match is additionally capped at ``len(prompt) - 1`` tokens so the final
prompt token always runs through a forward — that forward produces the
logits for the first generated token.

Lifecycle of a cached block:

  * **insert** — registered when a sequence fills it (live, refcount >= 1);
    the cache map itself holds no reference.
  * **park** — when the last referencing sequence flushes,
    ``BlockedAllocator.free`` asks ``park_if_cached``: cached blocks are
    held out of the free list with their KV contents warm.
  * **revive** — a later prefix hit on a parked block takes it live again.
  * **spill** — under pool pressure ``BlockedAllocator.allocate`` reclaims
    parked blocks LRU-first. With a bound spiller (the ``BlockedKVCache``)
    and room in the host-DRAM tier, the block's pages move to a host payload
    and the digest stays matchable (host-resident); otherwise the block is
    **evicted** outright (contents dropped, digest forgotten). Either way
    the device id returns to the free list, and both run *before* the
    scheduler's ``_preempt_for_progress`` host-swaps any live victim —
    pressure order: spill-to-host, evict-to-free, preempt-live.
  * **restore** — a later prefix match on a host-resident digest allocates
    a fresh device block and swaps the pages back in transparently inside
    ``acquire_chain`` (callers just see a hit).

The fleet's delta shipping asks a destination pool how much of a chain it
holds (``held_prefix_len``) and pins that chain at bind time
(``acquire_known``).

The digest is SHA-256 over the parent digest + the raw int32 token bytes —
a collision would silently serve another prompt's KV, so a cryptographic
hash (not Python ``hash``) is the right tool despite costing a bit more.
"""

import hashlib
from collections import OrderedDict

import numpy as np

_ROOT = b""  # parent digest of the first block in every chain


class PrefixCache:

    def __init__(self, allocator, block_size: int):
        self._alloc = allocator
        self.block_size = block_size
        self._map = {}        # digest -> physical block id
        self._by_block = {}   # physical block id -> digest
        # parked (refcount-0) digests in park order == LRU order; flush
        # parks a chain children-first so eviction orphans no ancestors
        self._lru = OrderedDict()
        # host-resident digests: digest -> allocator spill handle. Entries
        # here hold NO device block; a match restores into a fresh one.
        self._host_map = {}
        self._spiller = None  # bound BlockedKVCache (spill_block/restore_block)
        self.hits = 0             # requests that matched >= 1 cached block
        self.misses = 0
        self.tokens_saved = 0     # cumulative prefill tokens skipped
        self.insertions = 0
        self.evictions = 0
        self.spills = 0           # parked blocks demoted to the host tier
        self.restores = 0         # host-resident blocks revived on a match
        allocator.bind_cache(self)

    def bind_spiller(self, spiller):
        """Attach the page mover (``BlockedKVCache``): eviction pressure then
        demotes LRU parked blocks to the host-DRAM tier (while the allocator
        has spill room) instead of dropping their KV."""
        self._spiller = spiller

    @staticmethod
    def chain_digest(parent: bytes, block_tokens) -> bytes:
        h = hashlib.sha256(parent)
        h.update(np.asarray(block_tokens, np.int32).tobytes())
        return h.digest()

    @property
    def cached_blocks(self) -> int:
        """Device blocks registered in the cache (live shared + parked)."""
        return len(self._map)

    @property
    def host_cached_blocks(self) -> int:
        """Digests whose pages live in the host-DRAM tier (still matchable)."""
        return len(self._host_map)

    @property
    def evictable_blocks(self) -> int:
        """Parked (refcount-0) blocks reclaimable without preempting."""
        return len(self._lru)

    @property
    def hit_rate(self) -> float:
        n = self.hits + self.misses
        return self.hits / n if n else 0.0

    # -- matching ----------------------------------------------------------
    def lookup_chain(self, token_ids):
        """Longest chain of cached FULL blocks covering a strict prefix of
        ``token_ids``. Pure read — takes no references, counts no stats.
        Returns (block_ids, digests); a host-resident link appears as
        ``None`` in ``block_ids`` (``acquire_chain`` swaps it back in)."""
        bs = self.block_size
        limit = (len(token_ids) - 1) // bs  # strict prefix: tail must run
        parent = _ROOT
        blocks, digests = [], []
        for i in range(limit):
            d = self.chain_digest(parent, token_ids[i * bs:(i + 1) * bs])
            b = self._map.get(d)
            if b is None and d not in self._host_map:
                break
            blocks.append(b)
            digests.append(d)
            parent = d
        return blocks, digests

    def acquire_chain(self, blocks, digests):
        """Take references on a matched chain (parked blocks revive,
        host-resident blocks swap back into fresh device blocks) and record
        the hit — or a miss when nothing resolves. Returns the resolved
        device block ids — a prefix of the match when the pool can't hold a
        restore (the chain truncates there and the dropped tail simply
        re-prefills).

        Device-resident links are pinned live BEFORE any restore runs:
        ``_restore`` allocates, and allocation pressure re-enters ``evict``,
        which may spill/free any still-parked block — including a
        not-yet-acquired link of this very chain, leaving ``blocks`` holding
        a stale id. Pinned links have refcount >= 1 and sit outside the LRU,
        so reentrant eviction cannot touch them; links past a truncation
        point are un-pinned (re-parked)."""
        resolved = self._acquire_links(blocks, digests)
        if not resolved:
            self.misses += 1
            return []
        self.hits += 1
        self.tokens_saved += len(resolved) * self.block_size
        return resolved

    def _acquire_links(self, blocks, digests):
        """Pin-then-restore core shared by ``acquire_chain`` and
        ``acquire_known`` (see ``acquire_chain`` for the ordering
        invariant). Stats-neutral."""
        for b, d in zip(blocks, digests):
            if b is not None:
                self._acquire(b, d)
        resolved = []
        for b, d in zip(blocks, digests):
            if b is None:
                b = self._restore(d)
                if b is None:
                    break  # no device room: truncate the match here
            resolved.append(b)
        for b in blocks[len(resolved):]:
            if b is not None:
                self._alloc.free([b])  # un-pin: refcount-0 links re-park
        return resolved

    # -- delta shipping (cross-pool state transfer) ------------------------
    def held_prefix_len(self, digests) -> int:
        """How many leading links of ``digests`` this cache holds (device or
        host resident). A pure read for the delta-shipping digest exchange;
        the answer is advisory — links may evict between the query and the
        ship, so the importer re-resolves through ``acquire_known`` and
        aborts on a shortfall."""
        n = 0
        for d in digests:
            if d not in self._map and d not in self._host_map:
                break
            n += 1
        return n

    def acquire_known(self, digests):
        """Pin an already-held chain for a delta-shipped sequence: device
        links take a reference (parked links revive), host-resident links
        restore into fresh device blocks. The same pin-before-restore order
        as ``acquire_chain`` but stats-neutral: this is state transfer, not
        a prompt match. Returns the resolved device ids; a result shorter
        than ``digests`` means the chain is no longer fully held, and the
        caller frees the result and falls back to a full ship or a
        re-prefill."""
        blocks = []
        for d in digests:
            b = self._map.get(d)
            if b is None and d not in self._host_map:
                break
            blocks.append(b)
        return self._acquire_links(blocks, digests[:len(blocks)])

    def _restore(self, digest):
        """Swap a host-resident block back in under a fresh device id
        (refcount 1 for the acquiring sequence). Returns None when the pool
        has no room even after eviction — the record stays host-resident."""
        try:
            nb = self._alloc.allocate(1)[0]
        except ValueError:
            return None
        ref = self._host_map.pop(digest)
        payload = self._alloc.restore(ref)
        self._spiller.restore_block(payload, nb)
        self._map[digest] = nb
        self._by_block[nb] = digest
        self.restores += 1
        return nb

    def _acquire(self, block, digest):
        if digest in self._lru:
            del self._lru[digest]
            self._alloc.revive(block)
        else:
            self._alloc.ref([block])

    # -- registration ------------------------------------------------------
    def insert(self, parent: bytes, block_tokens, block: int):
        """Register a freshly written full block under its chain digest.
        Returns ``(digest, canonical_block)``: when the digest is already
        cached (another sequence prefilled identical content concurrently),
        the existing block is acquired and returned so the caller can dedup
        its block table and free the private copy; otherwise ``block``
        becomes the cached canonical copy."""
        d = self.chain_digest(parent, block_tokens)
        cur = self._map.get(d)
        if cur is not None:
            if cur != block:
                self._acquire(cur, d)
            return d, cur
        if d in self._host_map:
            # the sequence re-prefilled identical content on the device (its
            # match predated the spill or a restore found no room) — the
            # host copy is now a stale duplicate
            payload = self._alloc.drop_host(self._host_map.pop(d))
            # a spiller that keeps copies elsewhere (a tensor-parallel
            # controller's) takes the drop too
            drop = getattr(self._spiller, "drop_block", None)
            if payload is not None and drop is not None:
                drop(payload)
        self._map[d] = block
        self._by_block[block] = d
        self.insertions += 1
        return d, block

    # -- allocator callbacks ----------------------------------------------
    def park_if_cached(self, block: int) -> bool:
        """Allocator callback at refcount 0: cached blocks park in the LRU
        (contents stay warm) instead of returning to the free list."""
        d = self._by_block.get(block)
        if d is None:
            return False
        self._lru[d] = block
        self._lru.move_to_end(d)
        return True

    def evict(self, n: int) -> int:
        """Reclaim up to ``n`` least-recently-parked refcount-0 device
        blocks. With a bound spiller and room in the host tier each block's
        pages demote to host DRAM (digest stays matchable); otherwise the
        block is released outright. Returns device blocks freed either way."""
        freed = 0
        released = []
        while self._lru and freed < n:
            d, b = self._lru.popitem(last=False)
            del self._map[d]
            del self._by_block[b]
            if self._spiller is not None and self._alloc.can_spill():
                # gather the pages BEFORE the id returns to the free list
                payload = self._spiller.spill_block(b)
                self._host_map[d] = self._alloc.spill(b, payload)
                self.spills += 1
            else:
                released.append(b)
            freed += 1
        if released:
            self.evictions += len(released)
            self._alloc.release(released)
        return freed

    def stats(self):
        return {"cached_blocks": self.cached_blocks,
                "host_cached_blocks": self.host_cached_blocks,
                "evictable_blocks": self.evictable_blocks,
                "prefix_hits": self.hits, "prefix_misses": self.misses,
                "prefix_hit_rate": self.hit_rate,
                "prefill_tokens_saved": self.tokens_saved,
                "insertions": self.insertions, "evictions": self.evictions,
                "prefix_spills": self.spills,
                "prefix_restores": self.restores}
