"""Host-side serving state of the port (``deepspeed_tpu_torch/inference/v2/
ragged``, ``config_v2``) against the JAX package's.

The allocator, prefix cache and batch wrapper are copies; the cases here
mirror ``tests/test_prefix_cache.py`` and ``tests/test_inference_v2.py`` and
add differential checks that drive both packages through the same random
operations and require identical state. Also pins the package boundary: the
port imports neither JAX nor the JAX package.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from deepspeed_tpu.inference.v2.config_v2 import (
    RaggedInferenceEngineConfig as JaxEngineConfig)
from deepspeed_tpu.inference.v2.ragged.blocked_allocator import (
    BlockedAllocator as JaxAllocator)
from deepspeed_tpu.inference.v2.ragged.prefix_cache import PrefixCache as JaxPrefixCache
from deepspeed_tpu.inference.v2.ragged.ragged_wrapper import (
    RaggedBatchWrapper as JaxWrapper)
from deepspeed_tpu_torch.inference.v2.config_v2 import RaggedInferenceEngineConfig
from deepspeed_tpu_torch.inference.v2.ragged import (
    BlockedAllocator, BlockedKVCache, DSSequenceDescriptor, PrefixCache,
    RaggedBatchWrapper)


# ---------------------------------------------------------------------------
# package boundary
# ---------------------------------------------------------------------------

def test_port_imports_no_jax():
    code = ("import sys; import deepspeed_tpu_torch, "
            "deepspeed_tpu_torch.inference.v2, deepspeed_tpu_torch.models, "
            "deepspeed_tpu_torch.ops.paged_attention, "
            "deepspeed_tpu_torch.ops.cuda_build; "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'deepspeed_tpu')); "
            "print(bad); sys.exit(1 if bad else 0)")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120,
                       cwd=os.path.dirname(os.path.dirname(__file__)))
    assert r.returncode == 0, r.stdout + r.stderr


# ---------------------------------------------------------------------------
# allocator (mirrors tests/test_prefix_cache.py)
# ---------------------------------------------------------------------------

def test_allocator_refcount_lifecycle_and_double_free():
    a = BlockedAllocator(8)
    b1, b2 = a.allocate(2)
    assert a.counts() == {"free": 6, "live": 2, "cached": 0, "host": 0,
                          "nvme": 0, "total": 8}
    a.ref([b1])
    assert a.refcount(b1) == 2
    a.free([b1])
    assert a.refcount(b1) == 1
    a.free([b1])
    assert a.counts()["free"] == 7
    with pytest.raises(ValueError, match="double free"):
        a.free([b1])
    with pytest.raises(ValueError, match="non-live"):
        a.ref([b1])
    with pytest.raises(ValueError, match="only 7 free"):
        a.allocate(8)
    a.free([b2])
    assert a.counts()["free"] == 8


def test_allocator_deref_revive_release_guards():
    a = BlockedAllocator(4)
    blocks = a.allocate(2)
    assert a.deref([blocks[0]]) == [blocks[0]]
    assert a.free_blocks == 2  # limbo: zeroed but not yet released
    with pytest.raises(ValueError, match="double free"):
        a.deref([blocks[0]])
    with pytest.raises(ValueError, match="out of range"):
        a.deref([99])
    with pytest.raises(ValueError, match="non-parked"):
        a.revive(blocks[1])
    with pytest.raises(ValueError, match="non-parked"):
        a.release([a._free[0]])


@pytest.mark.parametrize("seed", [0, 1])
def test_allocator_and_prefix_cache_match_jax_under_random_ops(seed):
    """Same random allocate/free/commit/match/evict sequence on both
    packages: identical block ids, counts, stats and cache lookups."""
    rng = np.random.default_rng(seed)
    pairs = []
    for Alloc, Cache in ((BlockedAllocator, PrefixCache),
                         (JaxAllocator, JaxPrefixCache)):
        a = Alloc(24)
        pairs.append((a, Cache(a, block_size=4)))
    held = [[], []]          # block references held, per package
    prompts = [rng.integers(0, 3, 9).astype(np.int32) for _ in range(4)]
    for _ in range(400):
        op = int(rng.integers(5))
        n = int(rng.integers(1, 4))
        p = prompts[int(rng.integers(len(prompts)))]
        pick = int(rng.integers(max(len(held[0]), 1)))
        outs = []
        for (a, c), h in zip(pairs, held):
            room = a.free_blocks + c.evictable_blocks
            if op == 0 and room >= n:
                got = a.allocate(n)
                h.extend(got)
                outs.append(got)
            elif op == 1 and h:
                b = h.pop(pick)
                a.free([b])
                outs.append(b)
            elif op == 2 and room >= 2:
                # commit two freshly written full blocks of prompt p,
                # deduplicating against the cache as the state manager does
                parent, got = b"", []
                for i, b in enumerate(a.allocate(2)):
                    parent, canon = c.insert(parent, p[4 * i:4 * i + 4], b)
                    if canon != b:
                        a.free([b])
                    got.append(canon)
                h.extend(got)
                outs.append(got)
            elif op == 3:
                blocks, digests = c.lookup_chain(p)
                got = c.acquire_chain(blocks, digests)
                h.extend(got)
                outs.append(got)
            elif op == 4:
                outs.append(c.evict(n))
            else:
                outs.append(None)
        assert outs[0] == outs[1]
        assert pairs[0][0].counts() == pairs[1][0].counts()
        assert pairs[0][0].stats() == pairs[1][0].stats()
        assert pairs[0][1].stats() == {
            k: v for k, v in pairs[1][1].stats().items()
            if k in pairs[0][1].stats()}


def test_allocator_stats_match_jax():
    rng = np.random.default_rng(0)
    a, b = BlockedAllocator(32), JaxAllocator(32)
    held = []
    for _ in range(200):
        if held and (not a.free_blocks or rng.random() < 0.5):
            blk = held.pop(int(rng.integers(len(held))))
            a.free([blk])
            b.free([blk])
        else:
            n = int(rng.integers(1, min(4, a.free_blocks) + 1))
            got = a.allocate(n)
            assert got == b.allocate(n)
            held.extend(got)
        assert a.stats() == b.stats()


# ---------------------------------------------------------------------------
# prefix cache (mirrors tests/test_prefix_cache.py)
# ---------------------------------------------------------------------------

def test_prefix_cache_strict_prefix_match_and_lifecycle():
    a = BlockedAllocator(16)
    c = PrefixCache(a, block_size=4)
    tokens = np.arange(12, dtype=np.int32)
    blocks = a.allocate(3)
    d0, _ = c.insert(b"", tokens[:4], blocks[0])
    c.insert(d0, tokens[4:8], blocks[1])
    got, _ = c.lookup_chain(tokens[:8])
    assert got == [blocks[0]]           # the final token must run a forward
    got, digs = c.lookup_chain(tokens[:9])
    assert got == [blocks[0], blocks[1]]
    other = np.concatenate([tokens[:4], tokens[4:8] + 1, [0]])
    assert c.lookup_chain(other)[0] == [blocks[0]]
    a.free([blocks[2]])
    a.free([blocks[1]])
    a.free([blocks[0]])
    assert a.counts()["cached"] == 2 and c.evictable_blocks == 2
    got, digs = c.lookup_chain(tokens[:9])
    c.acquire_chain(got, digs)
    assert a.counts()["live"] == 2 and a.counts()["cached"] == 0
    assert c.hits == 1 and c.tokens_saved == 8
    a.free([blocks[1]])
    a.free([blocks[0]])
    assert c.evict(1) == 1              # the leaf goes first
    assert c.lookup_chain(tokens[:9])[0] == [blocks[0]]
    out = a.allocate(16)                # pool pressure evicts the rest
    assert len(out) == 16 and c.evictions == 2
    with pytest.raises(ValueError, match="only 0 free"):
        a.allocate(1)


def test_prefix_cache_insert_dedup_returns_canonical():
    a = BlockedAllocator(8)
    c = PrefixCache(a, block_size=4)
    toks = np.arange(4, dtype=np.int32)
    b_first, b_dup = a.allocate(2)
    d, canon = c.insert(b"", toks, b_first)
    assert canon == b_first
    d2, canon2 = c.insert(b"", toks, b_dup)
    assert d2 == d and canon2 == b_first
    assert a.refcount(b_first) == 2
    a.free([b_dup])
    assert a.counts()["free"] == 7 and a.counts()["live"] == 1
    assert c.chain_digest(b"", toks) == JaxPrefixCache.chain_digest(b"", toks)


# ---------------------------------------------------------------------------
# batch wrapper and sequence descriptor
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_rows", [1, 3, 5, 8])
def test_wrapper_build_matches_jax(n_rows):
    rng = np.random.default_rng(n_rows)
    ours, ref = RaggedBatchWrapper(8, 64, 6, 40), JaxWrapper(8, 64, 6, 40)
    for uid in range(n_rows):
        toks = rng.integers(0, 100, int(rng.integers(1, 40))).astype(np.int32)
        blocks = rng.integers(0, 40, int(rng.integers(1, 7))).tolist()
        seen = int(rng.integers(0, 50))
        ours.insert_sequence(uid, toks, seen, blocks)
        ref.insert_sequence(uid, toks, seen, blocks)
    a, b = ours.build(), ref.build()
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])
    assert ours.current_tokens == ref.current_tokens


def test_wrapper_rejects_overflow():
    w = RaggedBatchWrapper(2, 8, 2, 9)
    with pytest.raises(ValueError, match="per-seq budget"):
        w.insert_sequence(0, np.zeros(9, np.int32), 0, [0])
    with pytest.raises(ValueError, match="table width"):
        w.insert_sequence(0, np.zeros(2, np.int32), 0, [0, 1, 2])
    w.insert_sequence(0, [1], 0, [0])
    w.insert_sequence(1, [1], 0, [1])
    with pytest.raises(ValueError, match="already holds"):
        w.insert_sequence(2, [1], 0, [2])


def test_sequence_descriptor_post_forward():
    s = DSSequenceDescriptor(uid=3)
    s.extend_blocks([4, 5])
    s.in_flight_tokens = 7
    s.post_forward()
    assert (s.seen_tokens, s.in_flight_tokens, s.cur_allocated_blocks) == (7, 0, 2)
    assert not s.is_swapped


# ---------------------------------------------------------------------------
# KV cache
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kv_dtype", ["fp", "int8"])
def test_kv_cache_layout_and_swap_roundtrip(kv_dtype):
    kv = BlockedKVCache(2, 6, 4, 2, 16, "fp32", kv_dtype=kv_dtype,
                        device="cpu")
    assert tuple(kv.k_pool.shape) == (2, 7, 2, 4, 16)     # + trash block
    assert kv.trash_block == 6
    if kv_dtype == "int8":
        assert kv.k_pool.dtype == torch.int8
        assert tuple(kv.k_scale.shape) == (2, 7, 2, 1, 4)
    blocks = kv.reserve(3)
    g = torch.Generator().manual_seed(0)
    for p in (kv.k_pool, kv.v_pool):
        p.copy_(torch.randint(-100, 100, p.shape, generator=g).to(p.dtype))
    before = kv.k_pool[:, blocks].clone()
    fetched = []
    kv.set_host_fetch(lambda t, what: fetched.append(what) or t.cpu())
    handle = kv.swap_out(blocks)
    assert kv.free_blocks == 6 and fetched
    kv.k_pool.zero_()
    new = kv.swap_in(handle)
    assert torch.equal(kv.k_pool[:, new], before)
    with pytest.raises(ValueError, match="kv_dtype"):
        BlockedKVCache(1, 2, 4, 1, 16, kv_dtype="int4", device="cpu")


def test_kv_cache_takes_no_default_device():
    """The pools live where the caller says: no CPU default to fall into."""
    with pytest.raises(TypeError, match="device"):
        BlockedKVCache(1, 2, 4, 1, 16, "fp32")


# ---------------------------------------------------------------------------
# config: the same JSON validates the same way
# ---------------------------------------------------------------------------

def test_config_defaults_and_overrides_match_jax():
    doc = {"state_manager": {"max_ragged_batch_size": 96,
                             "num_kv_blocks": 12, "kv_dtype": "int8"},
           "kv_cache": {"block_size": 16, "cache_dtype": "fp32"},
           "modules": {"attention": "dense"}, "prefix_caching": True}
    for d in ({}, doc):
        assert RaggedInferenceEngineConfig(d).to_dict() == \
            JaxEngineConfig(d).to_dict()


def test_config_unknown_key_warns_not_raises():
    cfg = RaggedInferenceEngineConfig({"no_such_key": 1,
                                       "state_manager": {"typo": 2}})
    assert not hasattr(cfg, "no_such_key")


@pytest.mark.parametrize("doc,item", [
    ({"state_manager": {"host_kv_blocks": 4, "nvme_kv_blocks": 4}}, "A14"),
    ({"state_manager": {"nvme_kv_blocks": 4}}, "A14"),
    # speculation under tensor parallelism, refused until A5 part 2, is served
    ({"tensor_parallel": {"tp_size": 2}, "speculative": {"enabled": True}}, "A5"),
])
def test_config_unported_values_raise_naming_roadmap(doc, item):
    """The NVMe KV rung raises naming A14; A5's case (speculative decode at
    tp 2) is served since A5 part 2: the port takes it as the reference
    does."""
    JaxEngineConfig(doc)          # the reference accepts them
    if item == "A5":
        assert RaggedInferenceEngineConfig(doc).to_dict() == JaxEngineConfig(doc).to_dict()
        return
    with pytest.raises(NotImplementedError, match=f"ROADMAP.md queue {item}"):
        RaggedInferenceEngineConfig(doc)


@pytest.mark.parametrize("doc", [
    {"speculative": {"enabled": True}},
    {"slo_classes": {"interactive": {"ttft_target_s": 0.5}}},
], ids=["A3", "A4"])
def test_config_served_values_match_jax(doc):
    """Speculative decode (A3) and SLO classes (A4) are served: the port
    takes them as the reference does."""
    assert RaggedInferenceEngineConfig(doc).to_dict() == JaxEngineConfig(doc).to_dict()
