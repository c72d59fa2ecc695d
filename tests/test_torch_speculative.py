"""Speculative decode in the port against the JAX package, on the CPU.

Mirrors ``tests/test_speculative.py`` (without its router and
prefill/decode-fleet cases). The same tiny Llama weights (drawn by flax
from ``PRNGKey(0)`` in fp32, carried into the port through
``params_from_flax``) serve in both packages.

The oracle is the JAX package's: greedy speculative decode reproduces the
plain stream token for token. Here the port's greedy streams, with
speculation on and off, equal each other and the JAX package's (on and
off), and its speculated / accepted / rejected counts equal the JAX
scheduler's on the same workload. The verify forward's last column equals
the port's ``ragged_forward`` logits bit for bit, and its columns match the
JAX ``ragged_forward_verify`` within 2e-5 (fp32 in both packages; the
forwards differ only in matmul and reduction order, as in
``tests/test_torch_serving.py``). Around that: rollback of rejected drafts
never frees a block another chain holds and never crosses the committed
prefix-cache boundary, the ``DraftPageAllocator`` sub-page class keeps the
parent census, the n-gram drafter's lookup rules, and the guard rails.

Seeded sampling cannot match across packages (the JAX package draws with
threefry, the port with a (seed, position)-keyed torch generator), so the
seeded case holds speculative == plain inside the port, on a workload on
which the port's drafter fires.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deepspeed_tpu.inference.v2 import InferenceEngineV2 as JaxEngine
from deepspeed_tpu.inference.v2.ragged.blocked_allocator import (
    BlockedAllocator as JaxBlockedAllocator)
from deepspeed_tpu.inference.v2.ragged.ragged_wrapper import (
    RaggedBatchWrapper as JaxWrapper)
from deepspeed_tpu.inference.v2.scheduler import SplitFuseScheduler as JaxScheduler
from deepspeed_tpu.inference.v2.speculative import NgramDrafter as JaxDrafter
from deepspeed_tpu.models.llama import LlamaConfig as JaxLlamaConfig
from deepspeed_tpu.models.llama import LlamaForCausalLM as JaxLlama
from deepspeed_tpu.models.mixtral import MixtralConfig as JaxMixtralConfig
from deepspeed_tpu.models.mixtral import MixtralForCausalLM as JaxMixtral
from deepspeed_tpu_torch.inference.v2 import (InferenceEngineV2,
                                              RaggedInferenceEngineConfig,
                                              SplitFuseScheduler, build_engine)
from deepspeed_tpu_torch.inference.v2.model_implementations.llama import (
    ragged_forward, ragged_forward_verify)
from deepspeed_tpu_torch.inference.v2.ragged.blocked_allocator import (
    BlockedAllocator, DraftPageAllocator)
from deepspeed_tpu_torch.inference.v2.ragged.ragged_wrapper import RaggedBatchWrapper
from deepspeed_tpu_torch.inference.v2.sampling import sample_rows, verify_rows
from deepspeed_tpu_torch.inference.v2.speculative import NgramDrafter
from deepspeed_tpu_torch.models.llama import (LlamaConfig, LlamaForCausalLM,
                                              params_from_flax)
from deepspeed_tpu_torch.models.mixtral import MixtralConfig, MixtralForCausalLM

ATOL = 2e-5


@pytest.fixture(scope="module")
def served():
    jcfg = JaxLlamaConfig.tiny(scan_layers=True, remat=False, dtype=jnp.float32)
    jmodel = JaxLlama(jcfg)
    ids = np.random.default_rng(0).integers(0, jcfg.vocab_size,
                                            (1, 8)).astype(np.int32)
    params = jmodel.init(jax.random.PRNGKey(0), {"input_ids": ids})["params"]
    model = LlamaForCausalLM(LlamaConfig.tiny(dtype=torch.float32))
    model.load_state_dict(params_from_flax(jax.tree.map(np.asarray, params)))
    return jmodel, params, model


def engine_config(spec=False, prefix_caching=False, num_kv_blocks=64,
                  max_tokens=16, max_context=128, host_kv_blocks=0,
                  max_drafts=4, draft_page_divisor=0):
    config = {"state_manager": {"max_ragged_sequence_count": 4,
                                "max_ragged_batch_size": max_tokens,
                                "max_context": max_context,
                                "num_kv_blocks": num_kv_blocks,
                                "host_kv_blocks": host_kv_blocks},
              "kv_cache": {"block_size": 8, "cache_dtype": "fp32"},
              "prefix_caching": prefix_caching}
    if spec:
        config["speculative"] = {"enabled": True,
                                 "max_draft_tokens": max_drafts,
                                 "draft_page_divisor": draft_page_divisor}
    return config


def make_engine(served, jax_engine=False, **kw):
    jmodel, params, model = served
    if jax_engine:
        return JaxEngine(jmodel, params, config=engine_config(**kw))
    return InferenceEngineV2(model, engine_config(**kw), device="cpu")


def _census(engine):
    cnt = engine._state.kv_cache.allocator.counts()
    assert cnt["free"] + cnt["live"] + cnt["cached"] == \
        cnt["total"] - cnt["host"], cnt
    return cnt


def _repetitive_prompts(n=3, seed=0, max_len=40, vocab=512):
    """Template-heavy prompts (tiled short patterns): the greedy
    continuation of a tiny model over a periodic context tends to continue
    the period, so the n-gram drafter lands accepts."""
    rng = np.random.default_rng(seed)
    out = {}
    for uid in range(n):
        pat = rng.integers(0, vocab, int(rng.integers(2, 5))).astype(np.int32)
        reps = int(rng.integers(4, 8))
        out[uid] = np.tile(pat, reps)[:max_len]
    return out


def _run_sched(served, prompts, spec, kw_fn=None, jax_engine=False, **eng_kw):
    engine = make_engine(served, jax_engine=jax_engine, spec=spec, **eng_kw)
    sched = (JaxScheduler if jax_engine else SplitFuseScheduler)(
        engine, token_budget=16)
    for uid, p in prompts.items():
        sched.submit(uid, p, **(kw_fn(uid) if kw_fn else {"max_new_tokens": 10}))
    got = sched.run_to_completion()
    return {u: got[u].tolist() for u in got}, sched, engine


def _counts(sched):
    return (sched.speculated_tokens, sched.accepted_tokens,
            sched.rejected_tokens)


# ---------------------------------------------------------------------------
# drafter
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("ngram_max,context,k,want", [
    (3, [1, 2, 3, 9, 1, 2, 3], 2, [9, 1]),           # longest suffix wins
    (3, [1, 2, 3, 9, 1, 2, 3], 4, [9, 1, 2, 3]),
    (3, [5, 6, 7, 7], 3, [7, 7, 7]),                  # falls back to 1-grams
    (3, [1, 2, 3, 4], 3, []),                         # nothing recurs
    (3, [1, 2, 3, 4] * 3, 7, [1, 2, 3, 4, 1, 2, 3]),  # chains past a period
    (3, [1, 2, 3, 4] * 3, 2, [1, 2]),
    (2, [1, 2, 8, 1, 2, 9, 1, 2], 1, [9]),            # most recent wins
    (3, [1, 2, 1], 0, []), (3, [1], 4, []), (3, [], 4, []),
])
def test_ngram_drafter_rules_match_jax(ngram_max, context, k, want):
    assert NgramDrafter(ngram_max).draft(context, k) == want
    assert JaxDrafter(ngram_max).draft(context, k) == want


def test_ngram_drafter_random_contexts_match_jax():
    rng = np.random.default_rng(0)
    for _ in range(200):
        n = int(rng.integers(1, 4))
        ctx = [int(t) for t in rng.integers(0, 6, int(rng.integers(0, 30)))]
        k = int(rng.integers(0, 8))
        assert NgramDrafter(n).draft(ctx, k) == JaxDrafter(n).draft(ctx, k)
    with pytest.raises(ValueError, match="ngram_max"):
        NgramDrafter(ngram_max=0)


# ---------------------------------------------------------------------------
# verify forward
# ---------------------------------------------------------------------------

def _two_row_batch(state, sm, max_blocks, wrapper_cls, chunks):
    for uid, c in chunks.items():
        seq = state.get_or_create_sequence(uid)
        state.ensure_capacity(seq, len(c))
    wrapper = wrapper_cls(sm.max_ragged_sequence_count, sm.max_ragged_batch_size,
                          max_blocks, state.kv_cache.trash_block)
    for uid, c in chunks.items():
        wrapper.insert_sequence(uid, c, 0, state.get_sequence(uid).kv_blocks)
    return wrapper.build()


def test_verify_forward_last_column_bit_exact_and_matches_jax(served):
    """The port's verify forward: its last column equals ``ragged_forward``'s
    logits bit for bit over the same pools, at k_max 2, 4 and 8, with a
    4-token and a 1-token chunk (the q_len-dependent column clip on both
    sides); every live column matches the JAX ``ragged_forward_verify``
    within ATOL."""
    chunks = {1: np.array([2, 3, 4, 5], np.int32), 2: np.array([7], np.int32)}
    engine = make_engine(served)
    state, sm = engine._state, engine._config.state_manager
    a = {k: torch.from_numpy(v) for k, v in _two_row_batch(
        state, sm, engine._max_blocks_per_seq, RaggedBatchWrapper, chunks).items()}
    kv = state.kv_cache
    model = engine._model
    pools = (kv.k_pool.clone(), kv.v_pool.clone())

    def fresh():
        kv.k_pool.copy_(pools[0])
        kv.v_pool.copy_(pools[1])
        return (model, kv, a["tokens"], a["q_len"], a["seen"], a["block_tables"])

    plain = ragged_forward(*fresh())
    jengine = make_engine(served, jax_engine=True)
    jstate = jengine._state
    ja = _two_row_batch(jstate, jengine._config.state_manager,
                        jengine._max_blocks_per_seq, JaxWrapper, chunks)
    jkv = jstate.kv_cache
    for k_max in (2, 4, 8):
        ver = ragged_forward_verify(*fresh(), k_max)
        assert ver.shape == (a["tokens"].shape[0], k_max, 512)
        for row in range(len(chunks)):
            assert torch.equal(ver[row, -1], plain[row]), \
                f"k_max={k_max} row={row}: verify last column must be " \
                f"bit-identical to the plain forward"
        jver, _, _ = jengine._verify_forward(
            jengine._model_config, jengine._params, jnp.array(jkv.k_pool),
            jnp.array(jkv.v_pool), jnp.asarray(ja["tokens"]),
            jnp.asarray(ja["q_len"]), jnp.asarray(ja["seen"]),
            jnp.asarray(ja["block_tables"]), k_max)
        for row, c in enumerate(chunks.values()):
            live = slice(k_max - min(len(c), k_max), k_max)
            np.testing.assert_allclose(ver[row, live].numpy(),
                                       np.asarray(jver)[row, live],
                                       atol=ATOL, rtol=0)


def test_verify_rows_draw_what_sample_rows_draws_at_each_position():
    """Column c of a verify row samples at stream position
    ``last - (K-1) + c`` with the row's own parameters: the draw
    ``sample_rows`` makes at that position from the same logits, greedy and
    sampled rows mixed; padding rows take the argmax."""
    g = torch.Generator().manual_seed(0)
    S, K, V = 4, 4, 64
    logits = torch.randn(S, K, V, generator=g) * 3
    temps, top_ks, top_ps = [0.0, 0.7, 1.3], [0, 8, 0], [1.0, 0.9, 0.8]
    seeds, last = [5, 6, 7], [3, 10, 20]
    ids = verify_rows(logits, temps, top_ks, top_ps, seeds, last)
    assert ids.shape == (S, K) and ids.dtype == torch.int32
    for s in range(3):
        for c in range(K):
            want = sample_rows(logits[s:s + 1, c], [temps[s]], [top_ks[s]],
                               [top_ps[s]], [seeds[s]], [last[s] - (K - 1) + c])
            assert int(ids[s, c]) == int(want[0])
    assert torch.equal(ids[3], torch.argmax(logits[3], -1).int())


# ---------------------------------------------------------------------------
# scheduler parity: the oracle
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def greedy_runs(served):
    """The template workload through both packages, speculation off and
    on."""
    prompts = _repetitive_prompts(n=3, seed=1)
    runs = {}
    for jax_engine in (False, True):
        for spec in (False, True):
            runs[(jax_engine, spec)] = _run_sched(served, prompts, spec,
                                                  jax_engine=jax_engine)
    return runs


def test_greedy_parity_and_acceptance(greedy_runs):
    """Greedy speculative decode reproduces the plain stream token for
    token, in the port and against the JAX package, accepts drafts on the
    template workload with the JAX scheduler's counts, and drains the
    pool."""
    base = greedy_runs[(True, False)][0]
    for key, (out, _, _) in greedy_runs.items():
        assert out == base, f"(jax, spec)={key} diverged from JAX plain"
    _, sched, engine = greedy_runs[(False, True)]
    _, jsched, _ = greedy_runs[(True, True)]
    assert sched.speculated_tokens > 0, "workload must actually draft"
    assert sched.accepted_tokens > 0, "template workload must accept drafts"
    assert sched.speculated_tokens == \
        sched.accepted_tokens + sched.rejected_tokens
    assert _counts(sched) == _counts(jsched)
    assert sched.tokens_per_round() > 1.0
    assert sched.tokens_per_round() == pytest.approx(jsched.tokens_per_round(),
                                                     abs=1e-12)
    assert _census(engine)["live"] == 0, "finished requests free every block"


def test_spec_disabled_counters_stay_zero(greedy_runs):
    _, sched, _ = greedy_runs[(False, False)]
    assert _counts(sched) == (0, 0, 0)
    assert sched.tokens_per_round() == 1.0


@pytest.mark.parametrize("prompt_seed,accepts", [(2, False), (6, True)])
def test_seeded_sampling_parity_inside_the_port(served, prompt_seed, accepts):
    """Seeded per-request sampling shares the (seed, position) stream: the
    speculative run emits exactly the plain run's tokens. Prompt seed 2 is
    the JAX test's own workload (low temperature, top-k 12, seeds 500 +
    7 uid), on which threefry never drafts but the port's drafter does; on
    prompt seed 6 a sampled draft is also accepted."""
    prompts = _repetitive_prompts(n=3, seed=prompt_seed)

    def kw(uid):
        return {"max_new_tokens": 8, "temperature": 0.2, "top_k": 12,
                "seed": 500 + uid * 7}

    off, _, _ = _run_sched(served, prompts, spec=False, kw_fn=kw)
    on, sched, _ = _run_sched(served, prompts, spec=True, kw_fn=kw)
    assert on == off, "speculative sampling must share the seeded stream"
    assert sched.speculated_tokens > 0, \
        "sampled rows must actually run verify chunks"
    if accepts:
        assert sched.accepted_tokens > 0


def test_greedy_parity_mixed_random_prompts(served):
    """Random prompts rarely draft well; parity holds regardless, with rows
    whose drafter returns nothing beside mid-prefill rows."""
    rng = np.random.default_rng(3)
    prompts = {0: rng.integers(0, 512, 29).astype(np.int32),
               1: rng.integers(0, 512, 5).astype(np.int32),
               2: np.tile(rng.integers(0, 512, 3), 9).astype(np.int32)}
    kw = lambda uid: {"max_new_tokens": 6}  # noqa: E731
    off, _, _ = _run_sched(served, prompts, spec=False, kw_fn=kw)
    on, sched, _ = _run_sched(served, prompts, spec=True, kw_fn=kw)
    jon, jsched, _ = _run_sched(served, prompts, spec=True, kw_fn=kw,
                                jax_engine=True)
    assert on == off == jon
    assert _counts(sched) == _counts(jsched)


def test_eos_inside_accepted_run_stops_exactly(served, greedy_runs):
    """An eos inside an accepted run truncates the emission at the eos,
    where the plain stream stops."""
    prompts = {0: _repetitive_prompts(n=1, seed=1)[0]}
    eos = greedy_runs[(False, False)][0][0][2]   # third greedy token

    def kw(uid):
        return {"max_new_tokens": 10, "eos_token_id": eos}

    off_eos, _, _ = _run_sched(served, prompts, spec=False, kw_fn=kw)
    on_eos, _, _ = _run_sched(served, prompts, spec=True, kw_fn=kw)
    assert on_eos == off_eos
    assert on_eos[0][-1] == eos and eos not in on_eos[0][:-1]


def test_spec_parity_under_preemption(served):
    """A pool too small for both requests forces host-swap preemption mid
    run; the speculative leg matches the plain leg and the JAX package."""
    rng = np.random.default_rng(4)
    pat = rng.integers(0, 512, 4).astype(np.int32)
    prompts = {0: np.tile(pat, 11), 1: np.tile(pat + 1, 11)}   # 44 tokens
    kw = lambda uid: {"max_new_tokens": 6}  # noqa: E731
    off, _, _ = _run_sched(served, prompts, spec=False, kw_fn=kw, num_kv_blocks=10)
    on, sched, eng_on = _run_sched(served, prompts, spec=True, kw_fn=kw,
                                   num_kv_blocks=10)
    jon, jsched, _ = _run_sched(served, prompts, spec=True, kw_fn=kw,
                                num_kv_blocks=10, jax_engine=True)
    assert on == off == jon
    assert all(len(v) == 6 for v in on.values())
    assert eng_on.swap_stats["swap_outs"] >= 1, \
        "the tight pool must actually preempt the speculative leg"
    assert sched.speculated_tokens > 0
    assert _counts(sched) == _counts(jsched)
    _census(eng_on)


def _template_waves(seed, kw_fn, vocab=512):
    """Three waves over two shared template prefixes: waves 2-3 reuse the
    wave-1 prefixes (prefix-cache hits) and the tiled structure drafts."""
    rng = np.random.default_rng(seed)
    pool_a = np.tile(rng.integers(0, vocab, 4), 6).astype(np.int32)
    pool_b = np.tile(rng.integers(0, vocab, 3), 6).astype(np.int32)

    def mk(pool, n_suffix):
        return np.concatenate(
            [pool, rng.integers(0, vocab, n_suffix).astype(np.int32)])

    return [[(0, mk(pool_a, 5), kw_fn(0)), (1, mk(pool_b, 3), kw_fn(1))],
            [(2, mk(pool_a, 9), kw_fn(2))],
            [(3, mk(pool_b, 7), kw_fn(3)), (4, mk(pool_a, 2), kw_fn(4))]]


def _waves_run(served, waves, spec, caching, jax_engine=False):
    engine = make_engine(served, jax_engine=jax_engine, spec=spec,
                         prefix_caching=caching)
    sched = (JaxScheduler if jax_engine else SplitFuseScheduler)(
        engine, token_budget=16)
    for wave in waves:
        for uid, prompt, kw in wave:
            sched.submit(uid, prompt, **kw)
        for _ in range(2):
            if sched.has_work:
                sched.step()
    got = sched.run_to_completion()
    return {u: got[u].tolist() for u in got}, sched, engine


def test_spec_parity_with_prefix_cache_interleaving(served):
    """All four legs of the (speculate x prefix-cache) square emit the JAX
    package's stream over staggered shared-prefix waves, the caching legs
    share blocks, and the deferred commit keeps rejected drafts out of the
    chain-digest cache."""
    waves = _template_waves(5, lambda u: {"max_new_tokens": 6})
    base, jsched, _ = _waves_run(served, waves, spec=True, caching=True,
                                 jax_engine=True)
    legs = {}
    for spec in (False, True):
        for caching in (False, True):
            legs[(spec, caching)] = _waves_run(served, waves, spec, caching)
    for key, (out, _, _) in legs.items():
        assert out == base, f"leg {key} diverged from the JAX package"
    _, sched_on, eng_on = legs[(True, True)]
    assert sched_on.speculated_tokens > 0
    assert _counts(sched_on) == _counts(jsched)
    assert eng_on._state.prefix_cache.hits >= 2, \
        "workload must actually exercise sharing under speculation"
    assert _census(eng_on)["live"] == 0


def test_spec_parity_with_host_spill_and_revive(served):
    """Speculation over the full pressure ladder: parked prefix blocks
    spill to the host tier, an unrelated large request evicts, and a later
    shared prompt revives through a restore; parity with the plain leg
    holds and the spill and restore happened."""
    rng = np.random.default_rng(6)
    warm = np.tile(rng.integers(0, 512, 4), 10).astype(np.int32)
    big = rng.integers(0, 512, 60).astype(np.int32)
    revive = np.concatenate([warm, rng.integers(0, 512, 6).astype(np.int32)])

    def run(spec):
        engine = make_engine(served, spec=spec, prefix_caching=True,
                             num_kv_blocks=12, host_kv_blocks=16,
                             max_context=256)
        sched = SplitFuseScheduler(engine, token_budget=16)
        for uid, prompt, new in ((0, warm, 4), (1, big, 2), (2, revive, 4)):
            sched.submit(uid, prompt, max_new_tokens=new)
            sched.run_to_completion()
        return ({u: v.tolist() for u, v in sched.results().items()},
                sched, engine)

    off, _, _ = run(False)
    on, sched, eng_on = run(True)
    assert on == off
    assert sched.speculated_tokens > 0
    assert eng_on.kv_stats()["kv_spilled"] >= 1
    assert eng_on.kv_stats()["kv_restored"] >= 1
    _census(eng_on)


# ---------------------------------------------------------------------------
# rollback on the paged cursor
# ---------------------------------------------------------------------------

def test_rollback_frees_private_tail_and_census(served):
    engine = make_engine(served, max_tokens=32)
    prompt = np.arange(20, dtype=np.int32)
    engine.put([1], [prompt])
    seq = engine._state.get_sequence(1)
    assert seq.seen_tokens == 20 and len(seq.kv_blocks) == 3
    free_before = engine.free_blocks
    engine.rollback(1, 5)  # 15 seen -> 2 blocks kept, 1 freed
    assert seq.seen_tokens == 15 and len(seq.kv_blocks) == 2
    assert engine.free_blocks == free_before + 1
    engine.rollback(1, 0)  # no-op
    assert seq.seen_tokens == 15
    with pytest.raises(ValueError, match="untracked"):
        engine.rollback(99, 1)
    engine.flush(1)
    cnt = _census(engine)
    assert cnt["free"] == cnt["total"]


def test_rollback_never_frees_shared_blocks_or_crosses_commit(served):
    """A sequence sharing committed prefix blocks with another chain rolls
    back only its private tail (shared refcounts untouched), and rolling
    past the committed boundary is an invariant violation."""
    engine = make_engine(served, prefix_caching=True)
    state = engine._state
    alloc = state.kv_cache.allocator
    sched = SplitFuseScheduler(engine, token_budget=16)
    rng = np.random.default_rng(7)
    prefix = rng.integers(0, 512, 24).astype(np.int32)
    sched.submit(0, prefix, max_new_tokens=2)
    sched.run_to_completion()  # parks the prompt's 3 full blocks

    tail2 = np.concatenate([prefix[:16], rng.integers(0, 512, 9).astype(np.int32)])
    assert engine.match_prefix(1, tail2) == 16
    assert engine.match_prefix(2, tail2) == 16  # second holder of the prefix
    seq = state.get_sequence(1)
    shared = list(seq.kv_blocks)
    assert all(alloc.refcount(b) == 2 for b in shared)

    # a verify chunk's cursor advance past the shared prefix: 9 more tokens
    # -> seen 25, 4 blocks, digests still the 2 committed
    state.ensure_capacity(seq, 9)
    seq.seen_tokens += 9
    seq.tokens += [int(t) for t in tail2[16:25]]
    assert len(seq.kv_blocks) == 4 and len(seq.digests) == 2

    engine.rollback(1, 7)  # seen 18: private block 4 frees, block 3 stays
    assert seq.seen_tokens == 18 and len(seq.kv_blocks) == 3
    assert all(alloc.refcount(b) == 2 for b in shared), \
        "rollback must never free a block another chain holds"
    _census(engine)
    with pytest.raises(AssertionError, match="committed prefix-cache"):
        engine.rollback(1, 3)  # seen 15 would cross the 2-block boundary
    state.flush_sequence(1)
    state.flush_sequence(2)
    assert _census(engine)["live"] == 0


# ---------------------------------------------------------------------------
# the draft page-size class on the shared pool
# ---------------------------------------------------------------------------

def test_draft_page_allocator_lifecycle_and_parent_census():
    for parent in (BlockedAllocator(8), JaxBlockedAllocator(8)):
        d = parent.draft_pages(4)
        assert d.pages_per_block == 4
        pages = d.allocate(6)  # 2 parent blocks, 8 pages, 6 live
        assert pages == [0, 1, 2, 3, 4, 5]
        assert d.counts() == {"free_pages": 2, "live_pages": 6,
                              "held_blocks": 2, "pages_per_block": 4}
        cnt = parent.counts()
        assert cnt["live"] == 2 and cnt["free"] == 6
        d.free(pages[:3])
        assert d.free_pages == 5 and parent.counts()["live"] == 2
        d.free([pages[3]])  # last live page of its parent block: it returns
        assert parent.counts()["live"] == 1 and d.live_pages == 2
        d.free(pages[4:])
        assert d.counts() == {"free_pages": 0, "live_pages": 0,
                              "held_blocks": 0, "pages_per_block": 4}
        assert parent.counts()["free"] == 8
        with pytest.raises(ValueError, match="non-live draft page"):
            d.free([pages[0]])
        with pytest.raises(ValueError, match="pages_per_block"):
            parent.draft_pages(1)
    assert isinstance(BlockedAllocator(2).draft_pages(2), DraftPageAllocator)


def test_draft_page_allocator_all_or_nothing_and_random_census():
    """All-or-nothing growth, then 300 random allocate/free operations
    replayed on the port's allocator and the JAX one: the same page ids,
    the same counts, the parent census held throughout."""
    parent = BlockedAllocator(4)
    d = parent.draft_pages(4)
    other = parent.allocate(3)  # only 1 parent block left = 4 pages
    with pytest.raises(ValueError, match="free"):
        d.allocate(5)
    assert d.counts()["held_blocks"] == 0, "failed allocate must not hold"
    parent.free(other)

    parent, jparent = BlockedAllocator(4), JaxBlockedAllocator(4)
    d = parent.draft_pages(4)
    jd = jparent.draft_pages(4)
    rng = np.random.default_rng(8)
    live = []
    for _ in range(300):
        if live and (rng.random() < 0.5 or parent.free_blocks == 0
                     and d.free_pages == 0):
            k = int(rng.integers(1, len(live) + 1))
            idx = rng.choice(len(live), size=k, replace=False)
            for i in sorted(idx, reverse=True):
                p = live.pop(i)
                d.free([p])
                jd.free([p])
        else:
            want = int(rng.integers(1, 6))
            if want > d.free_pages + parent.free_blocks * 4:
                continue
            got = d.allocate(want)
            assert got == jd.allocate(want)
            live.extend(got)
        cnt = parent.counts()
        assert cnt == jparent.counts() and d.counts() == jd.counts()
        assert cnt["free"] + cnt["live"] + cnt["cached"] == cnt["total"]
        assert d.live_pages == len(live)
        assert d.free_pages + d.live_pages == d.held_blocks * 4
        assert cnt["live"] == d.held_blocks
    for p in live:
        d.free([p])
    assert parent.counts()["free"] == 4


def test_engine_wires_draft_page_class(served):
    engine = make_engine(served, spec=True, draft_page_divisor=4)
    d = engine._state.draft_pages
    assert d is not None and d.pages_per_block == 4
    pages = d.allocate(3)
    assert _census(engine)["live"] == 1  # one parent block carved
    d.free(pages)
    assert _census(engine)["live"] == 0
    assert make_engine(served, spec=True)._state.draft_pages is None


# ---------------------------------------------------------------------------
# configuration and guard rails
# ---------------------------------------------------------------------------

def test_spec_requires_device_sampling_and_verify_fn(served):
    engine = make_engine(served, spec=True)
    with pytest.raises(ValueError, match="device_sampling"):
        SplitFuseScheduler(engine, device_sampling=False)
    SplitFuseScheduler(make_engine(served), device_sampling=False)
    assert engine.verify_supported
    # an engine without a verify forward refuses speculation
    engine._verify_forward = None
    with pytest.raises(ValueError, match="verify forward"):
        SplitFuseScheduler(engine)


def test_mixtral_speculation_raises_the_jax_packages_error():
    """Mixtral has no verify forward in either package: speculation raises
    the same ValueError; plain Mixtral serving is untouched."""
    config = engine_config(spec=True)
    with pytest.raises(ValueError) as jerr:
        JaxEngine(JaxMixtral(JaxMixtralConfig.tiny(dtype=jnp.float32)), None,
                  config=config)
    model = MixtralForCausalLM(MixtralConfig.tiny(dtype=torch.float32))
    with pytest.raises(ValueError) as err:
        build_engine(model, config, device="cpu")
    assert str(err.value) == str(jerr.value)
    assert not build_engine(model, engine_config(), device="cpu").verify_supported


def test_speculation_and_slo_classes_are_served_nvme_still_waits():
    cfg = RaggedInferenceEngineConfig(dict(
        engine_config(spec=True),
        slo_classes={"interactive": {"ttft_target_s": 0.5}}))
    assert cfg.speculative.enabled and cfg.speculative.max_draft_tokens == 4
    assert cfg.slo_classes == {"interactive": {"ttft_target_s": 0.5}}
    with pytest.raises(NotImplementedError, match="A14"):
        RaggedInferenceEngineConfig({"state_manager": {"nvme_kv_blocks": 4}})
