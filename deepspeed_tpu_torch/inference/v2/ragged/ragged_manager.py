"""Ragged state manager (port of
``deepspeed_tpu/inference/v2/ragged/ragged_manager.py``): tracks live
sequences and owns the blocked KV cache.

With ``state_manager.host_kv_blocks`` > 0 and prefix caching on, parked
prefix blocks spill to the host-DRAM tier under pool pressure and restore on
a match. Speculative decode rolls a sequence's paged cursor back over the
rejected tail of a verify chunk (``rollback_sequence``), and
``speculative.draft_page_divisor`` > 1 carves a draft-page class out of the
same pool. ``sample_kv_stats`` records the KV gauges when telemetry is on.
The fleet's page transfer: ``export_sequences_pages`` detaches finished
sequences' pages in one gather (delta shipping leaves out the leading blocks
the destination's prefix cache already holds), ``import_sequences_pages``
binds a shipment all-or-nothing. Left for a later slice: the NVMe tier
(ROADMAP A14).
"""

import torch

from deepspeed_tpu_torch import telemetry
from deepspeed_tpu_torch.inference.v2.ragged.kv_cache import BlockedKVCache
from deepspeed_tpu_torch.inference.v2.ragged.prefix_cache import PrefixCache
from deepspeed_tpu_torch.inference.v2.ragged.sequence_descriptor import DSSequenceDescriptor
from deepspeed_tpu_torch.utils.logging import logger


class DSStateManager:

    def __init__(self, config, num_layers, num_kv_heads, head_dim, device,
                 num_blocks=None):
        """``num_kv_heads``: the KV heads of this rank's pools (all of them
        without tensor parallelism). ``num_blocks`` overrides
        ``state_manager.num_kv_blocks``; without either, the pool is sized
        from the device's free memory."""
        self._config = config
        sm, kv = config.state_manager, config.kv_cache
        device = torch.device(device)
        num_blocks = num_blocks or sm.num_kv_blocks
        if num_blocks is None:
            num_blocks = self._blocks_from_memory_budget(
                num_layers, num_kv_heads, head_dim, kv, device,
                kv_dtype=sm.kv_dtype)
        self.kv_cache = BlockedKVCache(num_layers, num_blocks, kv.block_size,
                                       num_kv_heads, head_dim, kv.cache_dtype,
                                       kv_dtype=sm.kv_dtype, device=device,
                                       host_capacity=sm.host_kv_blocks)
        # block-granular prefix sharing (config_v2.py prefix_caching knob,
        # default off). None when disabled — every cache-path branch below
        # is a single attribute test.
        self.prefix_cache = None
        if getattr(config, "prefix_caching", False):
            self.prefix_cache = PrefixCache(self.kv_cache.allocator,
                                            kv.block_size)
            if sm.host_kv_blocks > 0:
                # pressure then demotes LRU parked blocks to host DRAM
                # (pages move through the kv_cache's swapper) before
                # dropping anything
                self.prefix_cache.bind_spiller(self.kv_cache)
        # second, smaller page-size class for draft-model KV (speculative
        # decode), carved lazily out of the same refcounted pool, so the
        # census and pool pressure see draft pages as ordinary tenants
        self.draft_pages = None
        spec = config.speculative
        if spec.draft_page_divisor > 1:
            self.draft_pages = self.kv_cache.allocator.draft_pages(
                spec.draft_page_divisor)
        self._seqs = {}
        self.swap_outs = 0  # host swap tier counters (kv_cache swap_out/in)
        self.swap_ins = 0
        self.peak_occupancy = 0.0  # high-water KV occupancy (kv_stats)
        logger.info(f"DSStateManager: {num_blocks} KV blocks x {kv.block_size} "
                    f"tokens ({num_layers} layers, {num_kv_heads} kv heads, "
                    f"prefix_caching={'on' if self.prefix_cache else 'off'})")

    @staticmethod
    def _blocks_from_memory_budget(num_layers, num_kv_heads, head_dim, kv,
                                   device, kv_dtype="fp"):
        """Size the pool from device memory: 60% of the memory the card has
        free now (``torch.cuda.mem_get_info``, so the weights already loaded
        are accounted for); 1 GiB on the CPU. int8 pages cost 1 byte/element
        plus one fp32 scale per token row. A pool of no KV heads (a tp
        rank's empty share) sets no bound: the other ranks' budgets do."""
        if kv_dtype == "int8":
            elt_bytes = 1 + 4 / head_dim
        else:
            elt_bytes = 4 if kv.cache_dtype == "fp32" else 2
        bytes_per_block = int(2 * num_layers * kv.block_size * num_kv_heads
                              * head_dim * elt_bytes)  # K + V pools
        if device.type == "cuda":
            free, _ = torch.cuda.mem_get_info(device)
            budget = int(free * 0.6)
        else:
            budget = 1 << 30
        if not bytes_per_block:
            return 1 << 62       # an empty tp share holds no pages: no bound
        return max(16, budget // bytes_per_block)

    @staticmethod
    def blocks_needed_for(seen, have, new_tokens, block_size):
        """Extra blocks to grow a sequence with ``seen`` cached tokens and
        ``have`` allocated blocks by ``new_tokens`` — single source of truth
        for admission control and allocation."""
        return max(0, -(-(seen + new_tokens) // block_size) - have)

    # -- sequence tracking (reference ragged_manager.py:100-205) -----------
    @property
    def tracked_sequences(self):
        return self._seqs

    @property
    def n_tracked_sequences(self):
        return len(self._seqs)

    @property
    def kv_block_size(self):
        return self.kv_cache.block_size

    @property
    def free_blocks(self):
        """Blocks available to new allocations: the raw free list plus
        (with prefix caching on) idle cached blocks the allocator will evict
        on demand."""
        free = self.kv_cache.free_blocks
        if self.prefix_cache is not None:
            free += self.prefix_cache.evictable_blocks
        return free

    def kv_stats(self):
        """Pure host-side KV pool read: occupancy, free-list depth,
        fragmentation, swap counters. Never touches the device.
        ``occupancy`` counts blocks live under sequences; idle prefix-cached
        blocks are reclaimable and reported separately, and host-resident
        blocks hold no device memory: ``total_blocks``/``occupancy``/
        ``occupied_blocks`` are the device census, and the host tier
        reports through the ``host_kv_*`` and ``kv_*`` fields, with
        ``kv_spilled == kv_restored + kv_dropped + host_kv_blocks``."""
        a = self.kv_cache.allocator_stats()
        total, free = self.kv_cache.allocator.num_blocks, a["free"]
        parked = self.kv_cache.allocator.cached_blocks
        occupancy = 1.0 - (free + parked) / total if total else 0.0
        if occupancy > self.peak_occupancy:
            self.peak_occupancy = occupancy
        swapped = sum(1 for s in self._seqs.values() if s.is_swapped)
        hs = self.kv_cache.allocator.host_swap_stats()
        stats = {"total_blocks": total, "free_blocks": free,
                 "occupied_blocks": total - free - parked,
                 "occupancy": occupancy,
                 "peak_occupancy": self.peak_occupancy,
                 "free_runs": a["free_runs"],
                 "largest_free_run": a["largest_free_run"],
                 "fragmentation": a["fragmentation"],
                 "tracked_sequences": len(self._seqs),
                 "swapped_sequences": swapped,
                 # swap_outs/ins count whole-sequence preemptions of LIVE
                 # sequences; the host tier's block-granular prefix
                 # traffic is the kv_* trio below
                 "swap_outs": self.swap_outs, "swap_ins": self.swap_ins,
                 "swap_outs_live": self.swap_outs,
                 "host_kv_blocks": hs["resident"],
                 "host_kv_capacity": hs["capacity"],
                 "host_kv_occupancy": (hs["resident"] / hs["capacity"]
                                       if hs["capacity"] else 0.0),
                 "kv_spilled": hs["spilled"], "kv_restored": hs["restored"],
                 "kv_dropped": hs["dropped"]}
        if self.prefix_cache is not None:
            stats.update(self.prefix_cache.stats())
        return stats

    def sample_kv_stats(self, point="step"):
        """``kv_stats`` plus the serving gauges when telemetry is enabled
        (occupancy, free-list depth and fragmentation, and the prefix-cache
        and host-tier gauges where those are on)."""
        stats = self.kv_stats()
        tm = telemetry.get_telemetry()
        if tm.enabled:
            tm.serving_gauge("serving/kv_occupancy", stats["occupancy"],
                             point=point)
            tm.serving_gauge("serving/kv_free_blocks", stats["free_blocks"],
                             point=point)
            tm.serving_gauge("serving/kv_fragmentation",
                             stats["fragmentation"], point=point)
            if self.prefix_cache is not None:
                tm.serving_gauge("serving/prefix_hit_rate",
                                 stats["prefix_hit_rate"], point=point)
                tm.serving_gauge("serving/cached_blocks",
                                 stats["cached_blocks"], point=point)
                tm.serving_gauge("serving/prefill_tokens_saved",
                                 stats["prefill_tokens_saved"], point=point)
            if stats["host_kv_capacity"]:
                tm.serving_gauge("serving/host_kv_blocks",
                                 stats["host_kv_blocks"], point=point)
        return stats

    def get_sequence(self, uid):
        return self._seqs.get(uid)

    def get_or_create_sequence(self, uid):
        if uid in self._seqs:
            return self._seqs[uid]
        if len(self._seqs) >= self._config.state_manager.max_tracked_sequences:
            raise RuntimeError(
                f"already tracking {len(self._seqs)} sequences "
                f"(max_tracked_sequences)")
        seq = DSSequenceDescriptor(uid=uid)
        self._seqs[uid] = seq
        return seq

    # -- prefix caching (ragged/prefix_cache.py) ---------------------------
    def match_prefix(self, uid, prompt_tokens):
        """Longest-cached-prefix match at sequence creation: on a hit the
        sequence is created holding the shared blocks with ``seen_tokens``
        advanced past the matched tokens, so the scheduler never re-runs
        them. Returns the number of matched tokens (0 = miss or disabled).
        The match is block-aligned and strictly shorter than the prompt."""
        cache = self.prefix_cache
        if cache is None or uid in self._seqs:
            return 0
        if len(self._seqs) >= self._config.state_manager.max_tracked_sequences:
            cache.misses += 1
            return 0
        blocks, digests = cache.lookup_chain(prompt_tokens)
        if not blocks:
            cache.misses += 1
            return 0
        # host-resident links swap back in here; the resolved chain may be a
        # prefix of the match when the pool can't hold a restore
        resolved = cache.acquire_chain(blocks, digests)
        if not resolved:
            return 0
        seq = self.get_or_create_sequence(uid)
        matched = len(resolved) * cache.block_size
        seq.kv_blocks = list(resolved)
        seq.digests = list(digests[:len(resolved)])
        seq.seen_tokens = matched
        seq.tokens = [int(t) for t in prompt_tokens[:matched]]
        return matched

    def commit_cached_blocks(self, seq):
        """Register every newly FILLED full block of ``seq`` in the prefix
        cache (called after post_forward, and at flush as the donation step).
        When another sequence concurrently cached identical content, dedup:
        adopt the canonical shared block and free the private copy — the
        contents are bit-identical (same tokens, same deterministic
        per-row forward), so the block table swap is invisible to
        attention."""
        cache = self.prefix_cache
        bs = cache.block_size
        n_full = seq.seen_tokens // bs
        while len(seq.digests) < n_full:
            i = len(seq.digests)
            parent = seq.digests[i - 1] if i else b""
            digest, canonical = cache.insert(
                parent, seq.tokens[i * bs:(i + 1) * bs], seq.kv_blocks[i])
            if canonical != seq.kv_blocks[i]:
                self.kv_cache.free([seq.kv_blocks[i]])
                seq.kv_blocks[i] = canonical
            seq.digests.append(digest)

    def rollback_sequence(self, uid, n_tokens):
        """Roll a sequence's paged cursor back ``n_tokens``: the rejected
        tail of a speculative verify chunk. Tail blocks that fall wholly
        past the new cursor are released through ``kv_cache.free``, which
        is deref-aware: a shared or cached block just drops one reference,
        only a private refcount-1 block returns to the pool. The cursor
        never crosses the committed prefix-cache boundary (committed
        digests cover full, immutable, possibly shared blocks; the deferred
        commit, ``engine.commit_prefix`` after the rollback, keeps rejected
        tokens out of them), so the guard below checks an invariant."""
        seq = self._seqs.get(uid)
        if seq is None:
            raise ValueError(f"rollback of untracked sequence {uid}")
        if n_tokens <= 0:
            return
        assert seq.in_flight_tokens == 0, "cannot roll back mid-forward"
        assert not seq.is_swapped, "cannot roll back a swapped sequence"
        bs = self.kv_block_size
        new_seen = seq.seen_tokens - int(n_tokens)
        assert new_seen >= 0, "rollback past start of sequence"
        assert new_seen >= len(seq.digests) * bs, \
            "rollback would cross the committed prefix-cache boundary"
        keep = -(-new_seen // bs)
        tail = seq.kv_blocks[keep:]
        if tail:
            del seq.kv_blocks[keep:]
            self.kv_cache.free(tail)
        seq.seen_tokens = new_seen
        if self.prefix_cache is not None:
            del seq.tokens[new_seen:]

    def flush_sequence(self, uid):
        """Drop a sequence and release its KV blocks (reference :110). With
        prefix caching on, full blocks are donated back to the cache instead
        of freed, children first so LRU eviction reclaims leaves first."""
        seq = self._seqs.pop(uid, None)
        if seq is None:
            logger.warning(f"flush of untracked sequence {uid}")
            return
        if self.prefix_cache is not None and not seq.is_swapped:
            self.commit_cached_blocks(seq)
            self.kv_cache.free(list(reversed(seq.kv_blocks)))
        else:
            self.kv_cache.free(seq.kv_blocks)

    # -- page transfer (prefill/decode disaggregation) ---------------------
    def sequence_block_digests(self, uids):
        """Full-block chain digests for the given tracked sequences — what a
        delta-shipping transport exchanges with the destination before
        exporting, so blocks the destination's prefix cache already holds
        never cross the wire. Requires prefix caching (token streams are
        only tracked then); returns ``{}`` when disabled. Untracked uids are
        silently skipped (the transport treats them as nothing-to-skip)."""
        if self.prefix_cache is None:
            return {}
        bs = self.kv_block_size
        out = {}
        for uid in uids:
            seq = self._seqs.get(uid)
            if seq is None:
                continue
            full = min(seq.seen_tokens // bs, len(seq.kv_blocks))
            parent, chain = b"", []
            for i in range(full):
                parent = PrefixCache.chain_digest(
                    parent, seq.tokens[i * bs:(i + 1) * bs])
                chain.append(parent)
            out[uid] = chain
        return out

    def held_prefix_lens(self, chains):
        """Per-uid count of leading chain links this pool's prefix cache
        already holds (device or host/NVMe tier) — the delta-shipping
        set-difference answered from the destination side."""
        if self.prefix_cache is None:
            return {uid: 0 for uid in chains}
        return {uid: self.prefix_cache.held_prefix_len(chain)
                for uid, chain in chains.items()}

    def export_sequence_pages(self, uid):
        """Detach ``uid``'s KV pages for shipping to another engine's pool
        (single-sequence form of ``export_sequences_pages``). Returns a
        handle for ``import_sequence_pages``."""
        h = self.export_sequences_pages([uid])
        m = h["seqs"][0]
        return {"n": m["n"], "k": h["k"], "v": h["v"], "blocks": h["blocks"],
                "seen_tokens": m["seen_tokens"], "tokens": m["tokens"]}

    def export_sequences_pages(self, uids, skip=None):
        """Batched export: every listed sequence's page rows leave in ONE
        device gather (``export_blocks`` over the concatenated block lists),
        so the fleet ships a whole round's finished prefills as one
        transfer, paying the launch cost per transfer, not per request.
        Each sequence is then released exactly as ``flush_sequence`` would
        — with prefix caching on, full blocks are donated to the cache
        first, so a prefill replica keeps serving warm prefixes after the
        handoff. Returns a handle for ``import_sequences_pages`` whose
        ``seqs`` list preserves submission order.

        ``skip`` (delta-shipping): ``{uid: k}`` leading full blocks the
        DESTINATION's prefix cache already holds — those rows are excluded
        from the gather and ride as ``skipped_digests`` instead, for the
        importer to re-acquire locally. Requires prefix caching. The
        handle's ``blocks`` are the gathered rows' ids."""
        for uid in uids:  # validate everything before mutating anything
            seq = self._seqs.get(uid)
            if seq is None:
                raise ValueError(f"export of untracked sequence {uid}")
            if seq.is_swapped:
                raise ValueError(f"cannot export swapped sequence {uid}")
            if seq.in_flight_tokens:
                raise RuntimeError(f"cannot export sequence {uid} mid-forward")
        if skip and self.prefix_cache is None:
            raise ValueError("delta export requires prefix caching")
        bs = self.kv_block_size
        blocks, seqs, popped = [], [], []
        for uid in uids:
            seq = self._seqs.pop(uid)
            popped.append(seq)
            hold = 0
            if skip:
                hold = min(int(skip.get(uid, 0)), seq.seen_tokens // bs,
                           len(seq.kv_blocks))
            m = {"uid": uid, "n": len(seq.kv_blocks) - hold,
                 "seen_tokens": seq.seen_tokens,
                 "tokens": list(seq.tokens)}
            if hold:
                parent, digs = b"", []
                for i in range(hold):
                    parent = PrefixCache.chain_digest(
                        parent, seq.tokens[i * bs:(i + 1) * bs])
                    digs.append(parent)
                m["skipped"] = hold
                m["skipped_digests"] = digs
            seqs.append(m)
            blocks.extend(seq.kv_blocks[hold:])
        # one gather for the whole group — it COPIES, so the ids can be
        # freed/donated immediately after
        k, v = self.kv_cache.export_blocks(blocks)
        for seq in popped:
            if self.prefix_cache is not None:
                self.commit_cached_blocks(seq)
                self.kv_cache.free(list(reversed(seq.kv_blocks)))
            else:
                self.kv_cache.free(seq.kv_blocks)
        return {"n": len(blocks), "k": k, "v": v, "seqs": seqs, "blocks": blocks}

    def import_sequence_pages(self, uid, handle):
        """Bind shipped KV pages into this pool (single-sequence form of
        ``import_sequences_pages``). Returns the bound block count."""
        batch = {"n": handle["n"], "k": handle["k"], "v": handle["v"],
                 "seqs": [{"uid": uid, "n": handle["n"],
                           "seen_tokens": handle["seen_tokens"],
                           "tokens": handle.get("tokens", [])}]}
        bound = self.import_sequences_pages(batch)
        handle["dst_blocks"] = batch["dst_blocks"]
        return bound

    def import_sequences_pages(self, handle):
        """Bind a batched shipment: ONE scatter allocates fresh block ids
        (refcount 1 via the ``BlockedAllocator``) for every sequence in the
        handle, then each sequence is created mid-stream with
        ``seen_tokens`` already past its shipped pages — decode never
        re-runs prefill. With prefix caching on, the token streams ride
        along so imported full blocks register in THIS pool's cache at the
        next commit. All-or-nothing: on any failure the partially created
        sequences and all imported blocks are released. Returns the total
        bound block count; the shipped rows' new ids are left in
        ``handle["dst_blocks"]`` (a tp controller's followers write their
        heads there)."""
        for m in handle["seqs"]:
            if m["uid"] in self._seqs:
                raise ValueError(f"uid {m['uid']} already tracked")
        # delta-shipping: re-acquire skipped prefix blocks from the LOCAL
        # prefix cache first — a miss (evicted between the digest exchange
        # and the ship) aborts before anything binds, and the transport's
        # bind-failure path re-prefills the request
        prefix_ids, prefix_digs, acquired = {}, {}, []
        try:
            for m in handle["seqs"]:
                hold = int(m.get("skipped", 0))
                if not hold:
                    continue
                if self.prefix_cache is None:
                    raise ValueError("delta shipment without a prefix cache")
                digs = [bytes.fromhex(d) if isinstance(d, str) else d
                        for d in m["skipped_digests"]]
                got = self.prefix_cache.acquire_known(digs)
                acquired.extend(got)
                if len(got) < hold:
                    raise ValueError(
                        f"delta bind miss for {m['uid']}: "
                        f"held {len(got)}/{hold} skipped blocks")
                prefix_ids[m["uid"]] = got
                prefix_digs[m["uid"]] = digs
            ids = list(self.kv_cache.import_blocks(
                handle["k"], handle["v"], int(handle["n"])))
        except Exception:
            if acquired:
                self.kv_cache.free(acquired)
            raise
        off, created = 0, []
        try:
            for m in handle["seqs"]:
                seq = self.get_or_create_sequence(m["uid"])
                created.append(m["uid"])
                seq.kv_blocks = prefix_ids.get(m["uid"], []) \
                    + ids[off:off + int(m["n"])]
                off += int(m["n"])
                seq.seen_tokens = int(m["seen_tokens"])
                if self.prefix_cache is not None:
                    seq.tokens = [int(t) for t in m["tokens"]]
                    # skipped blocks are already-registered cache entries;
                    # seed their digests so commit starts past them
                    seq.digests = list(prefix_digs.get(m["uid"], []))
        except Exception:
            for uid in created:
                self._seqs.pop(uid, None)
            self.kv_cache.free(ids)
            if acquired:
                self.kv_cache.free(acquired)
            raise
        handle["dst_blocks"] = ids
        return len(ids) + len(acquired)

    # -- host swap tier (ZeRO-Inference KV offload analog) -----------------
    def swap_out_sequence(self, uid):
        """Copy a tracked sequence's KV blocks to CPU tensors; the sequence
        stays tracked (seen_tokens intact) but holds no device blocks."""
        seq = self._seqs[uid]
        if seq.is_swapped:
            return
        if seq.in_flight_tokens:
            raise RuntimeError("cannot swap a sequence mid-forward")
        seq.swap_handle = self.kv_cache.swap_out(seq.kv_blocks)
        seq.kv_blocks = []
        self.swap_outs += 1

    def swap_in_sequence(self, uid):
        """Restore a swapped sequence into fresh device blocks."""
        seq = self._seqs[uid]
        if not seq.is_swapped:
            return
        seq.kv_blocks = list(self.kv_cache.swap_in(seq.swap_handle))
        seq.swap_handle = None
        self.swap_ins += 1

    def blocks_to_resume(self, uid):
        seq = self._seqs[uid]
        return seq.swap_handle["n"] if seq.is_swapped else 0

    # -- block arithmetic --------------------------------------------------
    def blocks_needed(self, seq, new_tokens):
        """Extra blocks required to grow ``seq`` by ``new_tokens``."""
        return self.blocks_needed_for(seq.seen_tokens, seq.cur_allocated_blocks,
                                      new_tokens, self.kv_block_size)

    def ensure_capacity(self, seq, new_tokens):
        extra = self.blocks_needed(seq, new_tokens)
        if extra:
            seq.extend_blocks(self.kv_cache.reserve(extra))
