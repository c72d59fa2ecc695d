"""The port's host-DRAM KV spill tier against the JAX package's, on the CPU.

Mirrors the host-tier cases of ``tests/test_kv_tiering.py`` and the
spill/restore cases of ``tests/test_prefix_cache.py``: the same tiny Llama
weights (drawn by flax from ``PRNGKey(0)``, carried into the port through
``params_from_flax``) serve in both packages under pool pressure, parked
prefix blocks spill to the host tier and revive on a shared-prefix request,
and the greedy streams must be identical to the JAX engine's and to an
unpressured engine's, with the ``kv_stats`` counters equal to JAX's. The
double-buffered ``HostKVSwapper`` bounds its pending landings, every landing
goes through the engine's accounted ``host_fetch``, spill handles are
single-shot, restores pin a chain's device links before they allocate, and
``nvme_kv_blocks`` raises naming ROADMAP A14.

Tolerance: none; token streams and counters must be equal (both packages
run fp32 weights, activations and KV, and greedy picks agree exactly, as
``tests/test_torch_serving.py`` shows).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deepspeed_tpu.inference.v2 import InferenceEngineV2 as JaxEngine
from deepspeed_tpu.inference.v2.config_v2 import (
    RaggedInferenceEngineConfig as JaxEngineConfig)
from deepspeed_tpu.inference.v2.ragged.blocked_allocator import (
    BlockedAllocator as JaxAllocator)
from deepspeed_tpu.inference.v2.ragged.prefix_cache import PrefixCache as JaxPrefixCache
from deepspeed_tpu.inference.v2.scheduler import SplitFuseScheduler as JaxScheduler
from deepspeed_tpu.models.llama import LlamaConfig as JaxLlamaConfig
from deepspeed_tpu.models.llama import LlamaForCausalLM as JaxLlama
from deepspeed_tpu_torch.inference.v2 import InferenceEngineV2, SplitFuseScheduler
from deepspeed_tpu_torch.inference.v2.config_v2 import RaggedInferenceEngineConfig
from deepspeed_tpu_torch.inference.v2.ragged import (BlockedAllocator,
                                                     BlockedKVCache, PrefixCache)
from deepspeed_tpu_torch.models.llama import (LlamaConfig, LlamaForCausalLM,
                                              params_from_flax)
from deepspeed_tpu_torch.runtime.swap_tensor.kv_swapper import HostKVSwapper


@pytest.fixture(scope="module")
def served():
    jcfg = JaxLlamaConfig.tiny(scan_layers=True, remat=False, dtype=jnp.float32)
    jmodel = JaxLlama(jcfg)
    ids = np.random.default_rng(0).integers(0, jcfg.vocab_size,
                                            (1, 8)).astype(np.int32)
    params = jmodel.init(jax.random.PRNGKey(0), {"input_ids": ids})["params"]
    model = LlamaForCausalLM(LlamaConfig.tiny(dtype=torch.float32))
    model.load_state_dict(params_from_flax(jax.tree.map(np.asarray, params)))
    return jcfg, jmodel, params, model


def engine_config(kv_dtype="fp", host_kv_blocks=0, prefix_caching=False,
                  num_kv_blocks=64):
    """``tests/test_kv_tiering.py``'s ``make_engine`` configuration."""
    return {"state_manager": {"max_ragged_sequence_count": 4,
                              "max_ragged_batch_size": 16,
                              "max_context": 128,
                              "num_kv_blocks": num_kv_blocks,
                              "kv_dtype": kv_dtype,
                              "host_kv_blocks": host_kv_blocks},
            "kv_cache": {"block_size": 8, "cache_dtype": "fp32"},
            "prefix_caching": prefix_caching}


def engines(served, **kw):
    _, jmodel, params, model = served
    cfg = engine_config(**kw)
    return (JaxEngine(jmodel, params, config=cfg),
            InferenceEngineV2(model, cfg, device="cpu"))


STAT_KEYS = ("kv_spilled", "kv_restored", "kv_dropped", "host_kv_blocks",
             "host_kv_capacity", "host_kv_occupancy", "swap_outs_live",
             "total_blocks", "free_blocks", "occupied_blocks", "occupancy",
             "prefix_hits", "prefix_misses", "prefill_tokens_saved",
             "prefix_spills", "prefix_restores", "host_cached_blocks",
             "evictions")


# ---------------------------------------------------------------------------
# host-DRAM tier at the engine level
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kv_dtype", ["fp", "int8"])
def test_prefix_blocks_spill_and_revive_without_live_swaps(served, kv_dtype):
    """``tests/test_kv_tiering.py``'s case through both packages: 40 shared
    tokens park, a 60-token filler spills them under a 12-block pool, a
    reuse request restores them. Streams equal JAX's and an unpressured
    engine's, the counters equal JAX's, no live sequence was swapped."""
    cfg = served[0]
    rng = np.random.default_rng(47)
    warm = rng.integers(0, cfg.vocab_size, 40).astype(np.int32)
    filler = rng.integers(0, cfg.vocab_size, 60).astype(np.int32)
    reuse = np.concatenate(
        [warm, rng.integers(0, cfg.vocab_size, 6).astype(np.int32)])
    jax_engine, engine = engines(served, kv_dtype=kv_dtype, prefix_caching=True,
                                 num_kv_blocks=12, host_kv_blocks=16)
    outs = []
    for eng, sched_cls in ((jax_engine, JaxScheduler),
                           (engine, SplitFuseScheduler)):
        sched = sched_cls(eng, token_budget=16)
        sched.submit(0, warm, max_new_tokens=2)
        warm_out = sched.run_to_completion()[0].tolist()  # parks warm's blocks
        sched.submit(1, filler, max_new_tokens=2)
        filler_out = sched.run_to_completion()[1].tolist()  # spills them
        spilled = eng.kv_stats()
        sched.submit(2, reuse, max_new_tokens=4)
        reuse_out = sched.run_to_completion()[2].tolist()
        outs.append((warm_out, filler_out, reuse_out, spilled, eng.kv_stats(),
                     sched.prefill_tokens_saved))
    (j_warm, j_fill, j_reuse, j_spilled, j_stats, j_saved), \
        (warm_out, filler_out, reuse_out, spilled, stats, saved) = outs
    assert (warm_out, filler_out, reuse_out) == (j_warm, j_fill, j_reuse)
    for key in STAT_KEYS:
        assert spilled[key] == j_spilled[key], key
        assert stats[key] == j_stats[key], key
    assert saved == j_saved > 0
    assert spilled["kv_spilled"] >= 1 and spilled["host_kv_blocks"] >= 1
    alloc = engine._state.kv_cache.allocator
    assert stats["total_blocks"] == alloc.num_blocks
    assert stats["occupied_blocks"] == alloc.live_blocks
    assert stats["kv_restored"] >= 1
    assert stats["swap_outs_live"] == 0
    assert stats["kv_spilled"] == stats["kv_restored"] + \
        stats["kv_dropped"] + stats["host_kv_blocks"]

    # an unpressured engine generates the same tokens for uid 2: the
    # spill/restore round trip kept the KV bytes exactly
    ref = SplitFuseScheduler(InferenceEngineV2(
        served[3], engine_config(kv_dtype=kv_dtype, num_kv_blocks=64),
        device="cpu"), token_budget=16)
    ref.submit(2, reuse, max_new_tokens=4)
    assert ref.run_to_completion()[2].tolist() == reuse_out


def test_spill_landings_route_through_accounted_host_fetch(served):
    _, engine = engines(served, prefix_caching=True, num_kv_blocks=12,
                        host_kv_blocks=16)
    cfg = served[0]
    sched = SplitFuseScheduler(engine, token_budget=16)
    rng = np.random.default_rng(48)
    sched.submit(0, rng.integers(0, cfg.vocab_size, 40).astype(np.int32),
                 max_new_tokens=2)
    sched.run_to_completion()
    base = engine.host_sync_count
    sched.submit(1, rng.integers(0, cfg.vocab_size, 60).astype(np.int32),
                 max_new_tokens=2)
    sched.run_to_completion()
    assert engine.kv_stats()["kv_spilled"] >= 1
    engine._state.kv_cache.swapper.drain()
    assert engine._state.kv_cache.swapper.landings >= 1
    assert engine.host_sync_count > base + 2


def test_host_kv_stats_fields(served):
    pair = engines(served, host_kv_blocks=8)
    for eng in pair:
        stats = eng.kv_stats()
        assert stats["host_kv_capacity"] == 8
        assert stats["host_kv_blocks"] == 0
        assert stats["host_kv_occupancy"] == 0.0
        assert stats["swap_outs_live"] == 0
        assert stats["kv_spilled"] == stats["kv_restored"] == \
            stats["kv_dropped"] == 0
    assert set(pair[1].kv_stats()) <= set(pair[0].kv_stats())


def test_config_host_tier_served_nvme_raises_naming_a14():
    doc = {"state_manager": {"host_kv_blocks": 4}}
    assert RaggedInferenceEngineConfig(doc).to_dict() == \
        JaxEngineConfig(doc).to_dict()
    doc = {"state_manager": {"host_kv_blocks": 4, "nvme_kv_blocks": 4}}
    JaxEngineConfig(doc)
    with pytest.raises(NotImplementedError, match="ROADMAP.md queue A14"):
        RaggedInferenceEngineConfig(doc)


# ---------------------------------------------------------------------------
# KV cache: spill and restore move exactly the spilled bytes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kv_dtype", ["fp", "int8"])
def test_spill_restore_round_trip_is_bitwise(kv_dtype):
    kv = BlockedKVCache(2, 6, 4, 2, 16, dtype="fp32", kv_dtype=kv_dtype,
                        device="cpu", host_capacity=4)
    gen = torch.Generator().manual_seed(0)
    pools = kv._pools()
    for p in pools:
        p.copy_((torch.randn(p.shape, generator=gen) * 50).to(p.dtype))
    before = [p[:, 3].clone() for p in pools]
    payload = kv.spill_block(3)
    for p in pools:
        p[:, 3] = 0                       # the freed id is reused
    kv.restore_block(payload, 5)
    for p, b in zip(kv._pools(), before):
        assert torch.equal(p[:, 5], b)
    assert len(before) == (4 if kv_dtype == "int8" else 2)
    assert kv.swapper.pending == 0 and kv.swapper.landings == 1


# ---------------------------------------------------------------------------
# HostKVSwapper double buffering (mirrors tests/test_kv_tiering.py)
# ---------------------------------------------------------------------------

def test_swapper_bounds_pending_and_preserves_payloads():
    landed = []

    def fetch(arrays, what):
        landed.append(what)
        return tuple(a.clone() for a in arrays)

    sw = HostKVSwapper(fetch, buffer_count=2)
    p1 = sw.submit((torch.ones(4),))
    p2 = sw.submit((torch.full((4,), 2.0),))
    assert sw.pending == 2 and not landed    # within the buffer: deferred
    p3 = sw.submit((torch.full((4,), 3.0),))
    assert sw.pending == 2 and len(landed) == 1  # oldest landed to make room
    out = sw.land(p1)                         # already landed: cached
    assert torch.all(out[0] == 1.0) and len(landed) == 1
    out = sw.land(p3)                         # jump the queue: force-land
    assert torch.all(out[0] == 3.0) and len(landed) == 2
    sw.drain()
    assert sw.pending == 0 and len(landed) == 3
    assert sw.landings == 3
    out = sw.land(p2)                         # landed by drain
    assert torch.all(out[0] == 2.0)


def test_swapper_uses_accounted_fetch_tag_and_land_wrapper():
    tags, wrapped = [], []

    def fetch(arrays, what):
        tags.append(what)
        return arrays

    def wrapper(thunk):
        wrapped.append(1)
        return thunk()

    sw = HostKVSwapper(fetch, buffer_count=1, land_wrapper=wrapper)
    sw.submit((torch.zeros(2),))
    sw.drain()
    assert tags == ["kv_cache/spill"] and wrapped == [1]


# ---------------------------------------------------------------------------
# prefix cache with a spiller (mirrors tests/test_prefix_cache.py)
# ---------------------------------------------------------------------------

class _StubSpiller:
    """Page-mover stand-in: records spill/restore traffic."""

    def __init__(self):
        self.spill_calls = 0
        self.restore_calls = 0

    def spill_block(self, block):
        self.spill_calls += 1
        return ("pages", block)

    def restore_block(self, payload, block):
        assert payload[0] == "pages"
        self.restore_calls += 1


def _both(num_blocks, host_capacity, block_size=4):
    """(JAX allocator, cache, spiller), (port allocator, cache, spiller)."""
    out = []
    for alloc_cls, cache_cls in ((JaxAllocator, JaxPrefixCache),
                                 (BlockedAllocator, PrefixCache)):
        a = alloc_cls(num_blocks, host_capacity=host_capacity)
        c = cache_cls(a, block_size=block_size)
        sp = _StubSpiller()
        c.bind_spiller(sp)
        out.append((a, c, sp))
    return out


def _state(a, c, sp):
    st = c.stats()
    st.pop("prefix_hit_rate")
    return (a.counts(), a.host_swap_stats(), st, sp.spill_calls,
            sp.restore_calls)


def test_host_tier_spill_restore_guards_and_no_resurrection():
    for a, c, _ in _both(8, 1):
        b1, b2 = a.allocate(2)
        with pytest.raises(ValueError, match="non-parked"):
            a.spill(b1, "pages")
        d1, _ = c.insert(b"", np.arange(4, dtype=np.int32), b1)
        c.insert(d1, np.arange(4, 8, dtype=np.int32), b2)
        a.free([b2])
        a.free([b1])
        ref = a.spill(b1, "pages-b1")
        assert a.counts()["host"] == 1 and a.counts()["free"] == 7
        with pytest.raises(ValueError, match="host tier full"):
            a.spill(b2, "pages-b2")
        assert a.restore(ref) == "pages-b1"
        with pytest.raises(ValueError, match="non-host record"):
            a.restore(ref)                # consumed: no resurrection
        with pytest.raises(ValueError, match="non-host record"):
            a.drop_host(ref)
        assert a.host_swap_stats() == {
            "spilled": 1, "restored": 1, "dropped": 0, "resident": 0,
            "capacity": 1, "nvme_resident": 0, "nvme_capacity": 0,
            "nvme_demotions": 0}


def test_prefix_cache_spills_lru_first_and_restores_on_match():
    states = []
    for a, c, sp in _both(8, 4):
        toks = np.arange(8, dtype=np.int32)
        b0, b1 = a.allocate(2)
        d0, _ = c.insert(b"", toks[:4], b0)
        c.insert(d0, toks[4:8], b1)
        a.free([b1])
        a.free([b0])
        assert c.evict(1) == 1
        got, digs = c.lookup_chain(toks.tolist() + [0])
        assert got[0] == b0 and got[1] is None
        resolved = c.acquire_chain(got, digs)
        assert len(resolved) == 2 and resolved[1] is not None
        assert sp.restore_calls == 1 and a.host_blocks == 0 and c.restores == 1
        states.append((_state(a, c, sp), resolved))
    assert states[0] == states[1]


def test_acquire_chain_pins_links_before_reentrant_restore_eviction():
    states = []
    for a, c, sp in _both(3, 4):
        toks = np.arange(8, dtype=np.int32)
        b0, b1, u = a.allocate(3)
        d0, _ = c.insert(b"", toks[:4], b0)
        d1, _ = c.insert(d0, toks[4:8], b1)
        c.insert(b"", np.arange(100, 104, dtype=np.int32), u)
        a.free([b0])
        a.free([b1])
        a.free([u])
        assert c.evict(1) == 1 and a.host_blocks == 1
        x = a.allocate(1)[0]              # zero free blocks remain
        got, digs = c.lookup_chain(np.append(toks, np.int32(0)))
        resolved = c.acquire_chain(got, digs)
        assert len(resolved) == 2 and resolved[1] == b1
        assert resolved[0] not in (b1, x)
        assert sp.spill_calls == 2 and sp.restore_calls == 1
        assert c.hits == 1 and c.misses == 0
        states.append((_state(a, c, sp), resolved))
    assert states[0] == states[1]


def test_acquire_chain_failed_restore_unpins_and_counts_miss():
    states = []
    for a, c, sp in _both(2, 4):
        toks = np.arange(8, dtype=np.int32)
        b0, b1 = a.allocate(2)
        d0, _ = c.insert(b"", toks[:4], b0)
        c.insert(d0, toks[4:8], b1)
        a.free([b0])
        a.free([b1])
        assert c.evict(1) == 1 and a.host_blocks == 1
        x = a.allocate(1)[0]
        got, digs = c.lookup_chain(np.append(toks, np.int32(0)))
        assert got == [None, b1]
        assert c.acquire_chain(got, digs) == []
        assert c.hits == 0 and c.misses == 1
        assert c.host_cached_blocks == 1 and c.evictable_blocks == 1
        assert a.refcount(x) == 1
        states.append(_state(a, c, sp))
    assert states[0] == states[1]


def test_full_host_tier_falls_back_to_plain_eviction():
    states = []
    for a, c, sp in _both(8, 1):
        parent = b""
        blocks = a.allocate(3)
        for i, b in enumerate(blocks):
            parent, _ = c.insert(parent, np.arange(i * 4, (i + 1) * 4,
                                                   dtype=np.int32), b)
        a.free(list(reversed(blocks)))
        assert c.evict(3) == 3
        assert sp.spill_calls == 1 and c.evictions == 2
        assert a.counts()["free"] == 8
        states.append(_state(a, c, sp))
    assert states[0] == states[1]


def test_reinsert_of_host_resident_digest_drops_the_stale_copy():
    states = []
    for a, c, sp in _both(4, 4):
        toks = np.arange(4, dtype=np.int32)
        b0, = a.allocate(1)
        c.insert(b"", toks, b0)
        a.free([b0])
        assert c.evict(1) == 1 and c.host_cached_blocks == 1
        b1, = a.allocate(1)
        d, canon = c.insert(b"", toks, b1)   # identical content re-prefilled
        assert canon == b1 and c.host_cached_blocks == 0
        hs = a.host_swap_stats()
        assert hs["dropped"] == 1 and hs["spilled"] == hs["restored"] + \
            hs["dropped"] + hs["resident"]
        states.append(_state(a, c, sp))
    assert states[0] == states[1]


@pytest.mark.parametrize("seed", range(3))
def test_random_spill_restore_traffic_matches_jax(seed):
    """The two packages' allocators and caches, driven through the same
    random allocate / insert / free / evict / match operations with a host
    tier, stay in identical state, and the census and swap identities hold
    after every operation."""
    rng = np.random.default_rng(seed)
    sides = _both(10, 5)
    chains = [rng.integers(0, 50, 16).astype(np.int32) for _ in range(4)]
    held = [[] for _ in sides]
    for _ in range(200):
        op = rng.integers(0, 4)
        chain = chains[rng.integers(0, len(chains))]
        n = int(rng.integers(1, 4))
        results = []
        for (a, c, sp), h in zip(sides, held):
            try:
                if op == 0:                       # prefill a chain's blocks
                    got, digs = c.lookup_chain(list(chain[:4 * n]) + [0])
                    blocks = c.acquire_chain(got, digs)
                    try:
                        extra = a.allocate(n - len(blocks)) if n > len(blocks) else []
                    except ValueError:
                        a.free(list(reversed(blocks)))
                        raise
                    parent = digs[len(blocks) - 1] if blocks else b""
                    for i, b in enumerate(extra, start=len(blocks)):
                        parent, canon = c.insert(parent, chain[4 * i:4 * i + 4], b)
                        if canon != b:
                            a.free([b])
                            b = canon
                        blocks.append(b)
                    h.append(blocks)
                    res = list(blocks)
                elif op == 1 and h:                # flush the oldest holder
                    a.free(list(reversed(h.pop(0))))
                    res = "freed"
                elif op == 2:
                    res = c.evict(n)
                else:
                    res = a.allocate(1)
                    h.append(res)
            except ValueError as e:
                res = f"ValueError {e}"
            results.append(res)
            cnt = a.counts()
            assert cnt["free"] + cnt["live"] + cnt["cached"] == a.num_blocks
            hs = a.host_swap_stats()
            assert hs["spilled"] == hs["restored"] + hs["dropped"] + hs["resident"]
        assert results[0] == results[1]
        assert _state(*sides[0]) == _state(*sides[1])
