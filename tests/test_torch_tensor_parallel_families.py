"""Tensor-parallel serving of the OPT, Falcon and Phi families, uneven head
splits, W8A16 v1 serving, speculative decode and the host KV tier at tp,
against the JAX package on the CPU.

A fixture starts 2 ranks (suite "tp2") and 4 (suite "tp4") of
``tests/test_torch_tensor_parallel_families_worker.py``, two gloo worlds
with ``file://`` rendezvous under the test's temporary directory, one thread
each, a timeout on the whole run. Meanwhile the test process runs the JAX
package on the virtual CPU devices with the same flax weights (carried into
the port through ``params_from_flax``) and inputs:

- FastGen at tp 2 (``build_replica(..., tp_size=2)``): tiny OPT, Phi, and a
  Falcon with 3 query heads on 1 KV head, whose fused ``query_key_value``
  of 80 columns the JAX mesh cuts 40 / 40, inside a head, while the port's
  ranks hold 2 and 1 whole heads, each with a copy of the KV head; at tp 4,
  the tiny Llama's 2 KV heads, each rank one query head and a copy of its
  KV head. One pre-drawn token stream drives both packages (PR 16's rule:
  a near-tie cannot fork them); every round's logits are compared to 2e-5
  and greedy tokens where the top-2 gap clears ``TOKEN_MARGIN``; a planted
  fault (Falcon rank 1's ``dense`` columns read from the even cut's
  boundary) must move them far outside; ``build_hf_engine`` on a Falcon
  directory the port wrote serves the in-memory engine's logits at tp 2,
  bit for bit;
- v1 at tp 2 with 8-bit weights (groups of 16, an FFN of 144 = 9 groups,
  cut 5 / 4): the logits against the JAX v1 engine's at tp 2, and every
  quantized linear's dequantized part on each rank equal, bit for bit, to
  the rank's part of the JAX engine's whole dequantized tensor;
- speculative decode and the host KV tier at tp 2 against the same engine
  config at tp 1 (streams equal; drafts speculated; spills and restores,
  each rank's restored pages equal to what it spilled).

Slices drawn and loaded (``from_seed``, ``params_from_flax``,
``load_pretrained``) are held in this process against the whole tensors,
and the plan's refusals against ``jax.device_put``'s.
"""

import dataclasses
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

import deepspeed_tpu
from deepspeed_tpu.inference.quantization.quantization import (
    QuantizedParameter as JaxQuantizedParameter)
from deepspeed_tpu.inference.v2.replica_group import build_replica as jax_build_replica
from deepspeed_tpu.models import falcon as jax_falcon
from deepspeed_tpu.models import phi as jax_phi
from deepspeed_tpu.models.llama import LlamaConfig as JaxLlamaConfig
from deepspeed_tpu.models.llama import LlamaForCausalLM as JaxLlama
from deepspeed_tpu.models.opt import OPTConfig as JaxOPTConfig
from deepspeed_tpu.models.opt import OPTForCausalLM as JaxOPT
from deepspeed_tpu.models.parallel_block import ParallelBlockForCausalLM as JaxBlock
from deepspeed_tpu_torch.checkpoint import hf
from deepspeed_tpu_torch.models import llama as port_llama
from deepspeed_tpu_torch.models.falcon import falcon_7b_config
from deepspeed_tpu_torch.parallel.tensor_parallel import TPPlan

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_tensor_parallel_families_worker import FAMILIES, QUANT  # noqa: E402

WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "test_torch_tensor_parallel_families_worker.py")
SUITES = {"tp2": 2, "tp4": 4}
RUN_TIMEOUT_S = 300
V1_TOL = dict(atol=2e-4, rtol=2e-3)
V2_ATOL = 2e-5
TOKEN_MARGIN = 1e-4
JAX_F32 = dict(dtype=jnp.float32, remat=False)
ENG = {"state_manager": {"max_ragged_sequence_count": 9, "max_ragged_batch_size": 64,
                         "max_context": 96, "num_kv_blocks": 96},
       "kv_cache": {"block_size": 8, "cache_dtype": "fp32"}}
JAX_MODELS = {
    "opt": lambda: JaxOPT(JaxOPTConfig.tiny(scan_layers=True, **JAX_F32)),
    "falcon": lambda: JaxBlock(jax_falcon.tiny_falcon_config(
        hidden_size=48, num_attention_heads=3, **JAX_F32)),
    "phi": lambda: JaxBlock(jax_phi.tiny_phi_config(**JAX_F32)),
    "llama": lambda: JaxLlama(JaxLlamaConfig.tiny(scan_layers=True, **JAX_F32)),
    "llama_q": lambda: JaxLlama(dataclasses.replace(
        JaxLlamaConfig.tiny(scan_layers=True, **JAX_F32), intermediate_size=144)),
}


def flax_params(model, seed):
    ids = np.zeros((1, 8), np.int32)
    return jax.tree.map(np.asarray,
                        model.init(jax.random.PRNGKey(seed), {"input_ids": ids})["params"])


def make_inputs(params):
    rng = np.random.default_rng(18)

    def toks(n):
        return rng.integers(0, 256, n).astype(np.int32)   # every tiny vocabulary

    rounds = [[(1, toks(11)), (2, toks(17)), (3, toks(5))],
              [(u, toks(1)) for u in (1, 2, 3)],
              [(u, toks(1)) for u in (1, 2, 3)] + [(4, toks(9))],
              [(u, toks(1)) for u in (1, 2, 3, 4)],
              [(u, toks(1)) for u in (1, 2, 3, 4)]]
    warm, filler = toks(40), toks(60)
    return {"params": params, "rounds": rounds,
            "v1_ids": rng.integers(0, 512, (4, 8)).astype(np.int32),
            "spec_prompts": [np.tile(toks(n), 24 // n + 2)[:l].astype(np.int32)
                             for n, l in ((3, 20), (4, 30), (2, 14))],
            "tier_requests": [(warm, 2), (filler, 2),
                              (np.concatenate([warm, toks(6)]), 4)]}


def serve(engine, rounds):
    return [np.asarray(engine.put([u for u, _ in b], [t for _, t in b]), np.float32)
            for b in rounds]


def dequantized_tree(tree):
    """The JAX engine's params with each quantized leaf dequantized whole,
    in fp32, as numpy."""
    return jax.tree.map(
        lambda x: np.asarray(x.dequantized(jnp.float32)) if isinstance(
            x, JaxQuantizedParameter) else np.asarray(x), tree,
        is_leaf=lambda x: isinstance(x, JaxQuantizedParameter))


def jax_runs(inp, jmodels):
    out = {}
    for name, tp in (("opt", 2), ("falcon", 2), ("phi", 2), ("llama", 4)):
        mesh, sched = jax_build_replica(jmodels[name], inp["params"][name],
                                        jax.devices()[:tp], tp_size=tp, engine_config=ENG)
        with mesh:
            out[name] = serve(sched._engine, inp["rounds"])
    eng = deepspeed_tpu.init_inference(
        jmodels["llama_q"], config={"dtype": "fp32", "tensor_parallel": {"tp_size": 2},
                                    "quant": QUANT})
    eng.set_params(inp["params"]["llama_q"])
    out["v1_q_logits"] = np.asarray(eng(inp["v1_ids"]), np.float32)
    out["v1_q_whole"] = port_llama.params_from_flax(dequantized_tree(eng.params))
    return out


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """Inputs, each suite's per-rank results, and the JAX runs."""
    d = tmp_path_factory.mktemp("torch_tp_families")
    jmodels = {name: make() for name, make in JAX_MODELS.items()}
    params = {name: flax_params(m, i) for i, (name, m) in enumerate(jmodels.items())}
    inp = make_inputs(params)
    inp["falcon_hf"] = str(d / "falcon_hf")
    cls, cfg, convert = FAMILIES["falcon"]
    falcon = cls(cfg)
    falcon.load_state_dict(convert(params["falcon"]))
    hf.export_pretrained(falcon, cfg, inp["falcon_hf"])
    torch.save(inp, d / "inputs.pt")
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")}
    env.update(OMP_NUM_THREADS="1", PYTHONUNBUFFERED="1")
    jobs = [(s, r, w) for s, w in SUITES.items() for r in range(w)]
    logs = {j: open(d / f"log_{j[0]}_{j[1]}.txt", "w") for j in jobs}
    procs = {j: subprocess.Popen([sys.executable, WORKER, j[0], str(j[1]), str(j[2]),
                                  str(d / f"rdzv_{j[0]}"), str(d / "inputs.pt"),
                                  str(d / f"out_{j[0]}_{j[1]}.pt")],
                                 stdout=logs[j], stderr=subprocess.STDOUT, env=env)
             for j in jobs}
    deadline = time.monotonic() + RUN_TIMEOUT_S
    try:
        want = jax_runs(inp, jmodels)
        for p in procs.values():
            p.wait(timeout=max(1.0, deadline - time.monotonic()))
    except subprocess.TimeoutExpired:
        pytest.fail(f"the gloo ranks did not finish in {RUN_TIMEOUT_S}s")
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs.values():
            f.close()
    for j, p in procs.items():
        if p.returncode:
            log = (d / f"log_{j[0]}_{j[1]}.txt").read_text()
            pytest.fail(f"{j[0]} rank {j[1]} exited {p.returncode}:\n{log[-4000:]}")
    got = {s: [torch.load(d / f"out_{s}_{r}.pt", weights_only=False) for r in range(w)]
           for s, w in SUITES.items()}
    return inp, got, want


def hold_tokens(got, want):
    """Greedy tokens equal wherever the reference's top-2 gap clears the
    margin; returns how many rows were held."""
    top2 = np.sort(want, axis=-1)[..., -2:]
    clear = (top2[..., 1] - top2[..., 0]) > TOKEN_MARGIN
    np.testing.assert_array_equal(got.argmax(-1)[clear], want.argmax(-1)[clear])
    return int(clear.sum())


# ---------------------------------------------------------------------------
# FastGen at tp against JAX build_replica
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,suite,heads", [
    ("opt", "tp2", [(2, 2), (2, 2)]),
    ("falcon", "tp2", [(2, 1), (1, 1)]),
    ("phi", "tp2", [(2, 2), (2, 2)]),
    ("llama", "tp4", [(1, 1)] * 4),
])
def test_round_logits_match_jax_build_replica(run, name, suite, heads):
    """Every round's last-token logits on the controller against the JAX
    engine's at the same tp on the same token stream; greedy tokens where
    the gap clears the margin; each rank's (query heads, KV heads); the
    followers ran every forward."""
    inp, got, want = run
    ranks = got[suite]
    assert [r[f"{name}_heads"] for r in ranks] == heads
    held = 0
    for ours, ref in zip(ranks[0][name], want[name]):
        np.testing.assert_allclose(ours, ref, atol=V2_ATOL, rtol=0)
        held += hold_tokens(ours, ref)
    assert held > 0 and len(ranks[0][name]) == len(want[name]) == len(inp["rounds"])
    for r in ranks[1:]:
        assert r[name] == len(inp["rounds"])
    assert ranks[0][f"{name}_attention"] == "cuda_paged"


@pytest.mark.parametrize("name,suite,reduces_per_layer", [
    ("opt", "tp2", 2), ("falcon", "tp2", 1), ("phi", "tp2", 1), ("llama", "tp4", 2)])
def test_exchanges_per_forward(run, name, suite, reduces_per_layer):
    """Per forward: OPT and Llama all-reduce after the attention and the MLP
    products, a parallel block once a layer (its two row-split products
    summed first); one embedding reduce, one logits gather."""
    inp, got, _ = run
    forwards, layers = len(inp["rounds"]), 2
    for r in got[suite]:
        c = r[f"{name}_counts"]
        assert c["row_reduce"]["calls"] == reduces_per_layer * layers * forwards
        assert c["vocab_embed"]["calls"] == c["gather_vocab"]["calls"] == forwards


def test_build_hf_engine_at_tp2_serves_the_in_memory_logits(run):
    """``build_hf_engine`` on a Falcon directory the port wrote, at tp 2:
    each rank loads its part and the controller's logits equal the
    in-memory engine's at tp 2, bit for bit, every round."""
    _, got, _ = run
    r0, r1 = got["tp2"]
    assert len(r0["falcon_hf"]) == len(r0["falcon"])
    for ours, ref in zip(r0["falcon_hf"], r0["falcon"]):
        np.testing.assert_array_equal(ours, ref)
    assert r1["falcon_hf"] == len(r0["falcon"])


def test_falcon_planted_fault_fails_the_comparison(run):
    """Rank 1's ``dense`` columns cut at the even boundary (half a head
    off) move the logits far outside the bound."""
    _, got, want = run
    err = np.abs(got["tp2"][0]["falcon_fault"][0] - want["falcon"][0]).max()
    assert err > 100 * V2_ATOL, err


# ---------------------------------------------------------------------------
# v1 with 8-bit weights at tp 2
# ---------------------------------------------------------------------------

def test_v1_int8_logits_match_jax_v1_int8(run):
    """The logits of the v1 ids on both ranks against the JAX v1 engine's
    at tp 2 with the same quantization; both ranks generate alike."""
    _, got, want = run
    r0, r1 = got["tp2"]
    for r in (r0, r1):
        np.testing.assert_allclose(r["v1_q_logits"], want["v1_q_logits"], **V1_TOL)
    assert hold_tokens(r0["v1_q_logits"], want["v1_q_logits"]) > 0
    np.testing.assert_array_equal(r0["v1_q_tokens"], r1["v1_q_tokens"])


def test_v1_int8_rank_parts_are_the_jax_whole_tensors_parts(run):
    """Each rank's dequantized part of every quantized linear equals, bit
    for bit, its part (``TPPlan`` with the group) of the JAX engine's whole
    dequantized tensor: gate/up cut 80 / 64 columns (5 and 4 groups of 16),
    down's rows the same."""
    _, got, want = run
    cfg = FAMILIES["llama_q"][1]
    whole = want["v1_q_whole"]
    for rank, r in enumerate(got["tp2"]):
        plan = TPPlan(cfg, 2, rank, group_size=QUANT["group_size"])
        parts = r["v1_q_parts"]
        assert len(parts) == 7 * cfg.num_hidden_layers + 1     # and lm_head
        for name, part in parts.items():
            assert torch.equal(part, plan.cut(name, whole[name])), name
        assert parts["layers.0.mlp.up_proj.weight"].shape[0] == (80, 64)[rank]
        assert parts["layers.0.mlp.down_proj.weight"].shape[1] == (80, 64)[rank]


# ---------------------------------------------------------------------------
# speculative decode and the host KV tier at tp 2
# ---------------------------------------------------------------------------

def test_speculative_decode_at_tp2_matches_tp1(run):
    """Greedy speculative streams at tp 2 equal the tp 1 engine's, with the
    same drafts speculated and accepted; the follower ran the verify
    forwards."""
    _, got, _ = run
    r0, r1 = got["tp2"]
    assert r0["spec_tp2"] == r0["spec_tp1"]
    assert all(len(t) == 12 for t in r0["spec_tp2"].values())
    assert r0["spec_tp2_counts"] == r0["spec_tp1_counts"]
    assert r0["spec_tp2_counts"][0] > 0 and r0["spec_tp2_counts"][1] > 0
    assert r1["spec_tp2"] > 0 and r1["spec_tp2_counts"] is None


def test_host_tier_at_tp2_matches_tp1(run):
    """Under pool pressure the tp 2 engine spills the parked prefix and
    restores it for the reuse request as the tp 1 engine does: the same
    streams (those of an unpressured engine) and counters, no live swap,
    and every rank's restored pages equal to what it spilled."""
    _, got, _ = run
    r0, r1 = got["tp2"]
    assert r0["tier_tp2"] == r0["tier_tp1"] == r0["tier_roomy"]
    stats, ref = r0["tier_tp2_stats"], r0["tier_tp1_stats"]
    for key in ("kv_spilled", "kv_restored", "kv_dropped", "host_kv_blocks",
                "prefix_hits", "prefill_tokens_saved", "swap_outs_live"):
        assert stats[key] == ref[key], key
    assert stats["kv_spilled"] >= 1 and stats["kv_restored"] >= 1
    assert stats["swap_outs_live"] == 0
    for r in (r0, r1):
        assert len(r["tier_restores_exact"]) == stats["kv_restored"]
        assert all(r["tier_restores_exact"])


# ---------------------------------------------------------------------------
# parts drawn and loaded, and the plan's cuts and refusals (one process)
# ---------------------------------------------------------------------------

SLICE_CASES = {"opt": 2, "falcon": 2, "phi": 2, "llama": 4}


def seeded(name, **kw):
    cls, cfg, _ = FAMILIES[name]
    model = cls.from_seed(cfg, seed=3, device="cpu", **kw)
    with torch.no_grad():
        for n, p in model.named_parameters():
            if n.endswith(".bias"):
                p.normal_(0, 0.02, generator=torch.Generator().manual_seed(len(n)))
    return model


@pytest.mark.parametrize("name", sorted(SLICE_CASES))
def test_from_seed_parts_equal_the_whole_draw(name):
    """Each rank's ``from_seed`` parts equal its plan's cut of the one-rank
    draw, bitwise (uneven Falcon heads, copied KV heads included)."""
    cls, cfg, _ = FAMILIES[name]
    tp = SLICE_CASES[name]
    whole = cls.from_seed(cfg, seed=5, device="cpu").state_dict()
    for rank in range(tp):
        part = cls.from_seed(cfg, seed=5, device="cpu", tp_size=tp, tp_rank=rank)
        assert (part.tp.size, part.tp.rank) == (tp, rank)
        for n, value in part.state_dict().items():
            assert torch.equal(value, part.plan.cut(n, whole[n])), n


def test_falcon_fused_qkv_holds_the_rank_s_heads_and_the_kv_head():
    """Falcon with 3 query heads on 1 KV head at tp 2: rank 0 holds q heads
    0-1, rank 1 q head 2, both the k and v head; Falcon-7B's 71 heads split
    36 / 35."""
    cls, cfg, _ = FAMILIES["falcon"]
    whole = cls.from_seed(cfg, seed=5, device="cpu").layers[0].query_key_value.weight
    Dh = cfg.head_dim
    q, k, v = whole[:3 * Dh], whole[3 * Dh:4 * Dh], whole[4 * Dh:]
    for rank, heads in ((0, slice(0, 2 * Dh)), (1, slice(2 * Dh, 3 * Dh))):
        part = cls.from_seed(cfg, seed=5, device="cpu", tp_size=2, tp_rank=rank)
        assert torch.equal(part.layers[0].query_key_value.weight,
                           torch.cat([q[heads], k, v]))
    big = [TPPlan(falcon_7b_config(), 2, r) for r in range(2)]
    assert [(p.heads, p.kv_heads) for p in big] == [(36, 1), (35, 1)]


@pytest.mark.parametrize("name", ["opt", "falcon", "phi"])
def test_params_from_flax_parts_equal_the_whole_tree_s(run, name):
    """``params_from_flax(tree, plan)`` gives the plan's cut of the whole
    conversion, bitwise."""
    inp, _, _ = run
    cls, cfg, convert = FAMILIES[name]
    whole = convert(inp["params"][name])
    for rank in range(2):
        plan = TPPlan(cfg, 2, rank)
        part = convert(inp["params"][name], plan)
        assert set(part) == set(whole)
        for n, value in part.items():
            assert torch.equal(value, plan.cut(n, whole[n])), n
        local = cls(cfg, tp_size=2, tp_rank=rank)
        local.load_state_dict(part)                # every shape fits the rank's module


@pytest.mark.parametrize("name", ["opt", "falcon", "phi"])
def test_load_pretrained_parts_equal_the_whole_load(tmp_path, name):
    """Each rank's ``load_pretrained(tp_size=2, tp_rank=r)`` of a directory
    the port wrote equals its plan's cut of the whole load (Falcon's fused
    qkv cut after its conversion, the others before)."""
    model = seeded(name)
    hf.export_pretrained(model, model.config, str(tmp_path))
    whole = hf.load_pretrained(str(tmp_path), device="cpu").state_dict()
    for rank in range(2):
        part = hf.load_pretrained(str(tmp_path), device="cpu", tp_size=2, tp_rank=rank)
        state = part.state_dict()
        assert set(state) == set(whole)
        for n, value in state.items():
            assert torch.equal(value, part.plan.cut(n, whole[n])), n


@pytest.mark.parametrize("rows,tp", [(511, 2), (130, 4), (96, 5), (4672, 2), (32000, 3)])
def test_plan_refuses_what_jax_device_put_refuses(rows, tp):
    """A split dimension of ``rows`` elements at ``tp``: the JAX mesh's
    ``device_put`` and the port's plan both raise ``ValueError``, or both
    take it (Falcon-7B's fused qkv width at tp 2, cut mid-head by JAX)."""
    mesh = Mesh(np.array(jax.devices()[:tp]), ("tp",))
    try:
        jax.device_put(np.zeros((rows, 2), np.float32), NamedSharding(mesh, P("tp", None)))
        jax_refuses = False
    except ValueError:
        jax_refuses = True
    cfg = dataclasses.replace(port_llama.LlamaConfig.tiny(), vocab_size=rows,
                              intermediate_size=rows * tp)
    if jax_refuses:
        with pytest.raises(ValueError, match=f"of {rows} elements is not divisible by "
                                             f"tp_size {tp}"):
            TPPlan(cfg, tp, 0)
    else:
        assert TPPlan(cfg, tp, 0).vocab == rows // tp
    assert jax_refuses == (rows % tp != 0)


def test_plan_cuts_whole_units_earlier_ranks_first():
    """Llama-2-7B with groups of 256 at tp 2: gate/up 5632 and 5376 columns
    (22 and 21 groups), q heads 16 each; without groups the even cut
    (5504 each)."""
    cfg = port_llama.LlamaConfig.llama2_7b()
    assert [TPPlan(cfg, 2, r, group_size=256).ffn for r in range(2)] == [5632, 5376]
    assert [TPPlan(cfg, 2, r, group_size=256).heads for r in range(2)] == [16, 16]
    assert [TPPlan(cfg, 2, r).ffn for r in range(2)] == [5504, 5504]
    assert [TPPlan(cfg, 2, r).spans["ffn"] for r in range(2)] == [[(0, 5504)],
                                                                 [(5504, 11008)]]


@pytest.mark.parametrize("case", ["one_group", "heads_short", "padded_group"])
def test_plan_names_a5_part_3_where_a_rank_would_hold_no_whole_unit(case):
    """Where a rank would hold no whole unit (A5 part 3 serves it now): a
    group of 256 over the tiny FFN of 128 and the query heads' 64 columns
    (one group for two ranks) and 4 query heads over 8 ranks leave the
    last ranks an empty share; groups of
    16 that do not tile an FFN of 136 leave the last rank the padded group
    (5 and 4 units: 80 and 56 columns)."""
    tiny = port_llama.LlamaConfig.tiny()
    args, want = {
        "one_group": ((tiny, 2, 256), {"ffn": [128, 0], "heads": [4, 0]}),
        "heads_short": ((tiny, 8, None), {"heads": [1] * 4 + [0] * 4,
                                          "kv_heads": [1] * 4 + [0] * 4,
                                          "ffn": [16] * 8}),
        "padded_group": ((dataclasses.replace(tiny, intermediate_size=136), 2, 16),
                         {"ffn": [80, 56]})}[case]
    plans = [TPPlan(args[0], args[1], r, group_size=args[2]) for r in range(args[1])]
    for attr, values in want.items():
        assert [getattr(p, attr) for p in plans] == values, attr
