"""Host-side free-list allocator for KV-cache blocks (port of
``deepspeed_tpu/inference/v2/ragged/blocked_allocator.py``, itself mirroring
the reference ``deepspeed/inference/v2/ragged/blocked_allocator.py``), with
its second, draft-page class (``DraftPageAllocator``, speculative decode).

Pure Python on the host: block ids index into the device-resident KV pool.
The reference keeps the free list in a torch tensor; here a deque is simpler
and never touches the device.

Blocks are reference counted so one physical block can appear in many
sequences' block tables (prefix sharing — paged attention indirects through
block ids, so the kernels never notice). A block is in exactly one of four
states:

  * **free**   — on the free list, refcount 0, allocatable
  * **live**   — refcount >= 1, held by one or more sequences
  * **cached** — refcount 0 but *parked* by a bound ``PrefixCache``: its KV
    contents are still valid for reuse and it is held out of the free list
    until the cache spills/evicts it (LRU, under pool pressure) or revives
    it on a prefix hit
  * **host**   — spilled to the host-DRAM tier (ZeRO-Inference/Infinity
    offload analog): the *contents* live in a host payload under a spill
    handle while the device id has returned to the free list. Host blocks
    therefore don't occupy HBM — the census counts them against a grown
    ``total``: ``free + live + cached + host == num_blocks + host`` always
    (device side, ``free + live + cached == num_blocks``, stays a hard
    invariant; ``counts`` exposes all the terms and the property test pins
    them)

and, when an NVMe store is bound (``bind_nvme``), a fifth:

  * **nvme**   — demoted from the host tier to disk (ZeRO-Infinity's NVMe
    rung, the 1M-token regime): when a spill finds the host tier full, the
    *oldest* host payload is written through the store and its handle moves
    tiers; the handle itself stays valid and ``restore`` reads it back
    transparently. The census total grows by both off-device tiers
    (``free + live + cached + host + nvme == num_blocks + host + nvme``)
    and the swap identity extends to
    ``spilled == restored + dropped + host + nvme``.

A spill handle is single-shot: ``restore`` consumes it, and a second restore
(or any restore of a dropped handle) raises — swapped-out refs cannot be
resurrected.
"""

from collections import deque


class BlockedAllocator:

    def __init__(self, num_blocks: int, host_capacity: int = 0):
        if num_blocks < 1:
            raise ValueError(f"need at least 1 block, got {num_blocks}")
        self._num_blocks = num_blocks
        self._free = deque(range(num_blocks))
        # mirror of _free for O(1) membership and O(free) run-structure stats
        self._free_set = set(range(num_blocks))
        self._refs = [0] * num_blocks
        self._parked = 0        # refcount-0 blocks held by the prefix cache
        self._cache = None      # bound PrefixCache (park_if_cached / evict)
        self._stats_cache = None
        # host-DRAM spill tier: handle -> opaque payload (set by the caller —
        # typically the kv_cache's host copy of the block's pages)
        self._host_capacity = host_capacity
        self._host = {}
        self._next_host_ref = 0
        self._host_spills = 0    # cumulative blocks spilled (swapped out)
        self._host_restores = 0  # cumulative blocks restored (swapped in)
        self._host_drops = 0     # cumulative records invalidated unread
        # NVMe tier (bind_nvme): handle -> store key. Handles share the host
        # namespace — a record is in _host XOR _nvme, never both.
        self._nvme_store = None
        self._nvme_capacity = 0
        self._nvme = {}
        self._nvme_demotions = 0  # cumulative host -> NVMe writes

    def bind_cache(self, cache):
        """Attach a prefix cache: refcount-0 blocks it recognises are parked
        (kept warm) instead of freed, and ``allocate`` evicts its LRU parked
        blocks before declaring the pool exhausted."""
        self._cache = cache

    @property
    def free_blocks(self) -> int:
        return len(self._free)

    @property
    def cached_blocks(self) -> int:
        return self._parked

    @property
    def live_blocks(self) -> int:
        return self._num_blocks - len(self._free) - self._parked

    @property
    def num_blocks(self) -> int:
        return self._num_blocks

    @property
    def host_blocks(self) -> int:
        """Blocks currently resident in the host-DRAM spill tier."""
        return len(self._host)

    @property
    def host_capacity(self) -> int:
        return self._host_capacity

    @property
    def nvme_blocks(self) -> int:
        """Blocks currently resident in the NVMe spill tier."""
        return len(self._nvme)

    @property
    def nvme_capacity(self) -> int:
        return self._nvme_capacity

    def counts(self):
        """State census for the allocator invariant: device side
        ``free + live + cached == num_blocks`` is hard, and with the spill
        tiers ``free + live + cached + host + nvme == total`` where ``total``
        grows by the off-device resident counts (spilled blocks hold no
        device id)."""
        host = len(self._host)
        nvme = len(self._nvme)
        return {"free": len(self._free), "live": self.live_blocks,
                "cached": self._parked, "host": host, "nvme": nvme,
                "total": self._num_blocks + host + nvme}

    def refcount(self, block: int) -> int:
        return self._refs[block]

    def allocate(self, num_blocks: int):
        """Allocate ``num_blocks`` block ids (refcount 1 each); raises
        ValueError if exhausted. When a prefix cache is bound, its idle
        (refcount-0) cached blocks are evicted first — the free tier that
        runs *before* the scheduler host-swaps any live victim."""
        if num_blocks > len(self._free) and self._cache is not None:
            self._cache.evict(num_blocks - len(self._free))
        if num_blocks > len(self._free):
            raise ValueError(
                f"requested {num_blocks} blocks, only {len(self._free)} free")
        out = []
        for _ in range(num_blocks):
            b = self._free.popleft()
            self._free_set.discard(b)
            self._refs[b] = 1
            out.append(b)
        self._stats_cache = None
        return out

    def ref(self, blocks):
        """Take an extra reference on live blocks (prefix sharing)."""
        for b in blocks:
            self._check_range(b)
            if self._refs[b] < 1:
                raise ValueError(f"ref of non-live block {b}")
            self._refs[b] += 1

    def deref(self, blocks):
        """Drop one reference per block; returns the blocks that hit
        refcount 0 WITHOUT disposing of them (caller decides: free list or
        cache park). Double-deref raises."""
        zeroed = []
        for b in blocks:
            self._check_range(b)
            if self._refs[b] < 1:
                raise ValueError(f"double free of block {b}")
            self._refs[b] -= 1
            if self._refs[b] == 0:
                zeroed.append(b)
        return zeroed

    def free(self, blocks):
        """Drop one reference per block; blocks reaching refcount 0 return to
        the free list unless a bound prefix cache parks them (their KV stays
        warm and evictable). Shared blocks (refcount still > 0) stay live."""
        for b in self.deref(blocks):
            if self._cache is not None and self._cache.park_if_cached(b):
                self._parked += 1
            else:
                self._release_one(b)

    # -- prefix-cache coordination ----------------------------------------
    def revive(self, block: int):
        """Parked (cached, refcount-0) block -> live on a prefix hit."""
        self._check_range(block)
        if self._refs[block] != 0 or block in self._free_set:
            raise ValueError(f"revive of non-parked block {block}")
        self._refs[block] = 1
        self._parked -= 1

    def release(self, blocks):
        """Return parked blocks to the free list (prefix-cache eviction)."""
        for b in blocks:
            self._check_range(b)
            if self._refs[b] != 0 or b in self._free_set:
                raise ValueError(f"release of non-parked block {b}")
            self._parked -= 1
            self._release_one(b)

    # -- host-DRAM + NVMe spill tiers ---------------------------------------
    def bind_nvme(self, store, capacity: int):
        """Attach an NVMe store (``write(payload) -> key``, ``read(key) ->
        payload``, ``drop(key)``) holding up to ``capacity`` demoted blocks.
        When a spill finds the host tier full, the oldest host payload is
        written through the store and its handle moves tiers — extending the
        pressure order to spill -> NVMe -> evict -> preempt."""
        if capacity < 1:
            raise ValueError(f"nvme capacity must be >= 1, got {capacity}")
        self._nvme_store = store
        self._nvme_capacity = int(capacity)

    def _can_demote(self) -> bool:
        return (self._nvme_store is not None and self._host
                and len(self._nvme) < self._nvme_capacity)

    def can_spill(self) -> bool:
        """Room left in the spill tiers? True when the host tier has a slot
        or demoting its oldest payload to NVMe would open one. (Full tiers ->
        callers fall back to plain eviction; records are never silently
        dropped, which keeps the swap accounting identity
        ``spills == restores + drops + host + nvme`` exact.)"""
        return len(self._host) < self._host_capacity or self._can_demote()

    def spill(self, block: int, payload):
        """Parked (cached, refcount-0) block -> host: store ``payload`` under
        a fresh single-shot handle and return the device id to the free list.
        A full host tier first demotes its oldest payload to the NVMe store
        (when bound and not itself full) — the demoted handle stays valid.
        Raises on non-parked blocks or when both tiers are full."""
        self._check_range(block)
        if self._refs[block] != 0 or block in self._free_set:
            raise ValueError(f"spill of non-parked block {block}")
        if len(self._host) >= self._host_capacity:
            if not self._can_demote():
                raise ValueError(
                    f"host tier full ({len(self._host)}/"
                    f"{self._host_capacity}), nvme "
                    f"{len(self._nvme)}/{self._nvme_capacity}")
            # demote the oldest host record (dict preserves insertion order)
            old = next(iter(self._host))
            self._nvme[old] = self._nvme_store.write(self._host.pop(old))
            self._nvme_demotions += 1
        self._parked -= 1
        self._release_one(block)
        ref = self._next_host_ref
        self._next_host_ref += 1
        self._host[ref] = payload
        self._host_spills += 1
        return ref

    def restore(self, ref: int):
        """Consume a spill handle and return its payload — read back through
        the NVMe store when the record was demoted. The caller allocates a
        fresh device block and rebinds the contents; the handle is dead
        afterwards (no resurrection of swapped-out refs)."""
        if ref in self._host:
            self._host_restores += 1
            return self._host.pop(ref)
        if ref in self._nvme:
            key = self._nvme.pop(ref)
            payload = self._nvme_store.read(key)
            self._nvme_store.drop(key)
            self._host_restores += 1
            return payload
        raise ValueError(f"restore of non-host record {ref}")

    def drop_host(self, ref: int):
        """Discard a host or NVMe record without restoring it (cache
        invalidation — e.g. the owning prefix cache is flushed). Returns the
        dropped host payload (None for an NVMe record)."""
        if ref in self._host:
            self._host_drops += 1
            return self._host.pop(ref)
        if ref in self._nvme:
            self._nvme_store.drop(self._nvme.pop(ref))
            self._host_drops += 1
        else:
            raise ValueError(f"drop of non-host record {ref}")

    def host_swap_stats(self):
        """Cumulative spill/restore/drop counters;
        ``spilled == restored + dropped + resident + nvme_resident`` always
        (the swap accounting identity the perf gate checks — a spilled
        record is either consumed, invalidated, or still parked in one of
        the two off-device tiers)."""
        return {"spilled": self._host_spills,
                "restored": self._host_restores,
                "dropped": self._host_drops,
                "resident": len(self._host),
                "capacity": self._host_capacity,
                "nvme_resident": len(self._nvme),
                "nvme_capacity": self._nvme_capacity,
                "nvme_demotions": self._nvme_demotions}

    def _release_one(self, b):
        self._free.append(b)
        self._free_set.add(b)
        self._stats_cache = None

    def _check_range(self, b):
        if not 0 <= b < self._num_blocks:
            raise ValueError(f"block id {b} out of range")

    def draft_pages(self, pages_per_block: int):
        """A second, smaller page-size class carved out of this pool: a
        ``DraftPageAllocator`` whose pages are 1/``pages_per_block`` of a
        block. Draft-model KV rides the same refcounted pool this way —
        draft pages consume parent blocks through the ordinary
        ``allocate``/``free`` protocol, so the census invariant and pool
        pressure see them like any other tenant."""
        return DraftPageAllocator(self, pages_per_block)

    def stats(self):
        """Host-side free-list stats for the serving gauges: free/total
        counts plus contiguous-run structure. ``fragmentation`` is
        1 - largest_run/free — 0.0 when the free ids form one contiguous
        range (or the list is empty), approaching 1.0 as the free space
        shatters. Paged attention doesn't need contiguity, but run structure
        still predicts swap_in/swap_out gather efficiency.

        O(free) per recompute (no sort: a block starts a run iff ``b-1`` is
        not free, then the run is walked forward), and the result is cached
        until the next allocate/free mutates the free list — per-step
        ``sample_kv_stats`` calls between mutations are O(1)."""
        if self._stats_cache is None:
            fs = self._free_set
            runs, largest = 0, 0
            for b in fs:
                if b - 1 in fs:
                    continue  # interior of a run; counted from its start
                runs += 1
                run_len = 1
                nxt = b + 1
                while nxt in fs:
                    run_len += 1
                    nxt += 1
                if run_len > largest:
                    largest = run_len
            frag = 1.0 - largest / len(fs) if fs else 0.0
            self._stats_cache = {
                "free": len(fs), "total": self._num_blocks,
                "free_runs": runs, "largest_free_run": largest,
                "fragmentation": frag}
        return dict(self._stats_cache)


class DraftPageAllocator:
    """Sub-block page allocator: a second, smaller page-size class riding a
    parent ``BlockedAllocator``.

    Each parent block is carved into ``pages_per_block`` draft pages; page
    id = ``parent_block * pages_per_block + slot``, so draft page ids map
    straight to pool offsets without a translation table. Parent blocks are
    acquired lazily (one ``parent.allocate`` per ``pages_per_block`` pages
    of demand) and returned the moment their last sub-page frees — draft KV
    therefore shows up in the parent census as ordinary live blocks, and
    ``free + live + cached == num_blocks`` keeps holding.

    Draft pages are refcount-1 only (a draft chunk is private to its row and
    is rolled back or dropped within the round — nothing ever shares it), so
    ``free`` here is exact release, not deref.
    """

    def __init__(self, parent: BlockedAllocator, pages_per_block: int):
        if pages_per_block < 2:
            raise ValueError(
                f"pages_per_block must be >= 2, got {pages_per_block}")
        self._parent = parent
        self._ppb = int(pages_per_block)
        self._free = deque()        # free sub-page ids of held parent blocks
        self._free_set = set()
        self._held = {}             # parent block -> live sub-page count

    @property
    def pages_per_block(self) -> int:
        return self._ppb

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def live_pages(self) -> int:
        return sum(self._held.values())

    @property
    def held_blocks(self) -> int:
        """Parent blocks currently carved into draft pages (live in the
        parent's census)."""
        return len(self._held)

    def counts(self):
        return {"free_pages": len(self._free),
                "live_pages": self.live_pages,
                "held_blocks": len(self._held),
                "pages_per_block": self._ppb}

    def allocate(self, num_pages: int):
        """Allocate ``num_pages`` draft page ids, growing the parent
        footprint one block at a time as needed. Raises (allocating
        nothing) when the parent pool cannot cover the growth."""
        if num_pages < 0:
            raise ValueError(f"bad page count {num_pages}")
        need_blocks = max(0, -(-(num_pages - len(self._free)) // self._ppb))
        if need_blocks:
            # all-or-nothing: the parent raises before any page hands out
            for b in self._parent.allocate(need_blocks):
                self._held[b] = 0
                for slot in range(self._ppb):
                    p = b * self._ppb + slot
                    self._free.append(p)
                    self._free_set.add(p)
        out = []
        for _ in range(num_pages):
            p = self._free.popleft()
            self._free_set.discard(p)
            self._held[p // self._ppb] += 1
            out.append(p)
        return out

    def free(self, pages):
        """Return draft pages; a parent block whose last sub-page frees is
        released back to the parent pool (its free sub-pages leave this
        class entirely). Double free raises."""
        for p in pages:
            b = p // self._ppb
            if b not in self._held or p in self._free_set:
                raise ValueError(f"free of non-live draft page {p}")
            self._held[b] -= 1
            self._free.append(p)
            self._free_set.add(p)
        released = [b for b, live in self._held.items() if live == 0]
        for b in released:
            del self._held[b]
            for slot in range(self._ppb):
                p = b * self._ppb + slot
                # every sub-page of a 0-live block is free by construction
                self._free.remove(p)
                self._free_set.discard(p)
            self._parent.free([b])
