"""Tensor-parallel serving of the port against the JAX package's, on gloo
ranks on the CPU.

The port's side runs once per module: a fixture starts 2 processes of
``tests/test_torch_tensor_parallel_worker.py`` (suite "tp2") and 4 more
(suite "grid4"), two gloo worlds with ``file://`` rendezvous under the
test's temporary directory, one thread each, a timeout on the whole run.
Meanwhile the test process runs the JAX engines on the virtual CPU devices
with the same weights (flax draws, carried into the port through
``params_from_flax``) and inputs:

- v1: ``init_inference`` at tp 2 and at dp 2 x tp 2 against the JAX
  engine at the same settings (``tests/test_inference.py::
  test_dp_replicated_tp_serving_mesh``), each rank's weights against the
  JAX engine's shard on the device at its grid place, and the clamping of
  ``tp_size`` 4 x ``replica_num`` 64 on 4 ranks (``::test_replica_clamping``);
- v2: the engine at tp 2 (tiny Llama with fp32 and int8 KV pools, tiny
  Mixtral) against JAX ``build_replica(..., tp_size=2)`` (Mixtral: the JAX
  engine on an ``("ep", "tp")`` mesh of 1 x 2, since ``build_replica``'s
  ``tp``-only mesh cannot place Mixtral's ``"ep"`` specs, ROADMAP §C). Both
  are driven with one pre-drawn token stream, so a near-tie cannot fork
  them (JAX's own tp 1 and tp 2 greedy streams differ at fp32, ROADMAP §C);
  every round's logits are compared;
- the single controller: sampled requests at tp 2 against a tp 1 engine,
  and with rank 1's scheduler clock skewed; the follower holds no sequence;
  preemption under KV pressure swaps every rank's pages;
- a planted fault (rank 1 holds rank 0's q_proj slice in layer 0) that the
  comparison rejects;
- what was refused at tp 2 until A5 part 2 and is served now (OPT,
  Falcon, heads tp does not divide, one KV head on two ranks, v1
  quantization, speculative decode, the host tier: each builds), a
  vocabulary tp does not divide (``ValueError``, as ``jax.device_put``
  raises), fleet replicas at tp and v1 grids that leave ranks idle (A5 part
  3), ``ep`` with ``tp`` (A12), training over ``tp`` and a tp 2 Llama's loss
  (A12);
- both builders take their grid from ``parallel.groups`` and never replace
  an installed topology;
- the ``tp`` cases of ``tests/test_topology.py`` with ``pp`` 1.

``from_seed``, ``shard_model`` and ``load_pretrained`` slices are held in
this process.

Tolerances: v1 logits at the JAX test's ``atol=2e-4, rtol=2e-3``. v2 logits
at ``V2_ATOL`` 2e-5 absolute, the one-card serving parity's
(``tests/test_torch_serving.py``), int8 KV pools included: the row-split
sums move fp32 logits of magnitude ~0.5 by ~1e-6 either way. Greedy tokens
are compared where the reference's top-2 gap exceeds ``TOKEN_MARGIN``.
"""

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
from deepspeed_tpu.inference.v2 import InferenceEngineV2 as JaxEngine
from deepspeed_tpu.inference.v2.replica_group import build_replica as jax_build_replica
from deepspeed_tpu.models.llama import LlamaConfig as JaxLlamaConfig
from deepspeed_tpu.models.llama import LlamaForCausalLM as JaxLlama
from deepspeed_tpu.models.mixtral import MixtralConfig as JaxMixtralConfig
from deepspeed_tpu.models.mixtral import MixtralForCausalLM as JaxMixtral
from deepspeed_tpu_torch.checkpoint import hf
from deepspeed_tpu_torch.models import llama as port_llama
from deepspeed_tpu_torch.models import mixtral as port_mixtral
from deepspeed_tpu_torch.inference.v2.engine_factory import shard_model
from deepspeed_tpu_torch.moe.utils import expert_slice, moe_param_specs
from deepspeed_tpu_torch.parallel.tensor_parallel import TensorParallel

WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "test_torch_tensor_parallel_worker.py")
SUITES = {"tp2": 2, "grid4": 4}
RUN_TIMEOUT_S = 300
V1_TOL = dict(atol=2e-4, rtol=2e-3)
V2_ATOL = 2e-5
TOKEN_MARGIN = 1e-4
ENG = {"state_manager": {"max_ragged_sequence_count": 9, "max_ragged_batch_size": 64,
                         "max_context": 96, "num_kv_blocks": 96},
       "kv_cache": {"block_size": 8, "cache_dtype": "fp32"}}


def flax_params(model, seed):
    ids = np.zeros((1, 8), np.int32)
    return jax.tree.map(np.asarray,
                        model.init(jax.random.PRNGKey(seed), {"input_ids": ids})["params"])


def make_inputs(llama_params, mixtral_params):
    rng = np.random.default_rng(16)

    def toks(n):
        return rng.integers(0, 512, n).astype(np.int32)

    rounds = [[(1, toks(11)), (2, toks(17)), (3, toks(5))],
              [(u, toks(1)) for u in (1, 2, 3)],
              [(u, toks(1)) for u in (1, 2, 3)] + [(4, toks(9))],
              [(u, toks(1)) for u in (1, 2, 3, 4)],
              [(u, toks(1)) for u in (1, 2, 3, 4)]]
    return {"llama_params": llama_params, "mixtral_params": mixtral_params,
            "rounds": rounds, "v1_ids": rng.integers(0, 512, (4, 8)).astype(np.int32),
            "sampled": [(10 + i, toks(n), 100 + i) for i, n in enumerate((7, 13, 4))],
            "pressure": [toks(44), toks(44)]}


def shard_tree(params, mesh, coord):
    """Each leaf's shard on the mesh device at ``coord``, as numpy."""
    device = mesh.devices[coord]

    def pick(leaf):
        for shard in leaf.addressable_shards:
            if shard.device == device:
                return np.asarray(shard.data)
        raise AssertionError(f"no shard on {device}")
    return jax.tree.map(pick, params)


def jax_runs(inp, jmodels):
    """The JAX engines on the same weights and inputs."""
    (jllama, lparams), (jmixtral, mparams) = jmodels
    out = {}
    for key, tp, dp in (("v1_tp2", 2, 1), ("v1_dp2tp2", 2, 2)):
        eng = deepspeed_tpu.init_inference(
            jllama, config={"dtype": "fp32", "tensor_parallel": {"tp_size": tp},
                            "replica_num": dp})
        eng.set_params(lparams)
        out[f"{key}_mesh"] = dict(eng.mesh.shape)
        out[f"{key}_logits"] = np.asarray(eng(inp["v1_ids"]), np.float32)
        out[f"{key}_shards"] = {(d, t): shard_tree(eng.params, eng.mesh, (d, t))
                                for d in range(dp) for t in range(tp)}
        if dp == 1:
            out[f"{key}_greedy"] = np.asarray(eng.generate(inp["v1_ids"], max_new_tokens=6))
    for key, kv_dtype in (("v2_llama", "fp"), ("v2_llama_int8", "int8")):
        ecfg = dict(ENG, state_manager=dict(ENG["state_manager"], kv_dtype=kv_dtype))
        mesh, sched = jax_build_replica(jllama, lparams, jax.devices()[:2], tp_size=2,
                                        engine_config=ecfg)
        with mesh:
            out[key] = serve(sched._engine, inp["rounds"])
    # build_replica's tp-only mesh cannot place Mixtral's ("ep", ..., "tp")
    # expert specs; an ep axis of 1 beside tp gives the same tp layout
    mesh = Mesh(np.array(jax.devices()[:2]).reshape(1, 2), ("ep", "tp"))
    specs = jmixtral.param_specs(mparams)
    placed = jax.device_put(mparams, jax.tree.map(
        lambda s: NamedSharding(mesh, s if s is not None else P()), specs,
        is_leaf=lambda s: s is None or isinstance(s, P)))
    with mesh:
        out["v2_mixtral"] = serve(JaxEngine(jmixtral, placed, config=ENG), inp["rounds"])
    return out


def serve(engine, rounds):
    return [np.asarray(engine.put([u for u, _ in b], [t for _, t in b]), np.float32)
            for b in rounds]


@pytest.fixture(scope="module")
def jmodels():
    jllama = JaxLlama(JaxLlamaConfig.tiny(scan_layers=True, remat=False, dtype=jnp.float32))
    jmixtral = JaxMixtral(JaxMixtralConfig.tiny(remat=False, dtype=jnp.float32))
    return (jllama, flax_params(jllama, 0)), (jmixtral, flax_params(jmixtral, 1))


@pytest.fixture(scope="module")
def run(tmp_path_factory, jmodels):
    """Inputs, each suite's per-rank results, and the JAX runs."""
    d = tmp_path_factory.mktemp("torch_tp")
    inp = make_inputs(jmodels[0][1], jmodels[1][1])
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
# v1: init_inference over the (dp, tp) grid
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("key", ["v1_tp2", "v1_dp2tp2"])
def test_v1_logits_match_jax_engine(run, key):
    """Every rank returns the whole batch's logits, those of the JAX engine
    on the same (dp, tp) mesh."""
    _, got, want = run
    ranks = got["tp2"] if key == "v1_tp2" else got["grid4"]
    for r in ranks:
        assert r[f"{key}_grid"] == want[f"{key}_mesh"]
        np.testing.assert_allclose(r[f"{key}_logits"], want[f"{key}_logits"], **V1_TOL)
    assert hold_tokens(ranks[0][f"{key}_logits"], want[f"{key}_logits"]) > 0


@pytest.mark.parametrize("key", ["v1_tp2", "v1_dp2tp2"])
def test_v1_rank_holds_its_param_specs_slice(run, key):
    """Each rank holds exactly the JAX engine's shard at its grid place, and
    the ranks of one tp index hold equal slices across dp."""
    _, got, want = run
    ranks = got["tp2"] if key == "v1_tp2" else got["grid4"]
    tp = 2
    for g, r in enumerate(ranks):
        shard = port_llama.params_from_flax(want[f"{key}_shards"][(g // tp, g % tp)])
        state = r[f"{key}_state"]
        assert set(state) == set(shard)
        for name, value in state.items():
            torch.testing.assert_close(value, shard[name], rtol=0, atol=0, msg=name)
    if len(ranks) == 4:
        for name, value in ranks[0][f"{key}_state"].items():
            assert torch.equal(value, ranks[2][f"{key}_state"][name]), name


def test_v1_generate_tp2(run):
    """Greedy tokens equal the JAX engine's on rows whose every step's
    top-2 gap clears the margin (checked on the v1 logits above); sampled
    tokens, drawn on tp rank 0 and broadcast, equal on both ranks."""
    _, got, want = run
    r0, r1 = got["tp2"]
    np.testing.assert_array_equal(r0["v1_tp2_greedy"], r1["v1_tp2_greedy"])
    np.testing.assert_array_equal(r0["v1_tp2_sampled"], r1["v1_tp2_sampled"])
    first = want["v1_tp2_logits"][:, -1]
    top2 = np.sort(first, -1)[:, -2:]
    clear = (top2[:, 1] - top2[:, 0]) > TOKEN_MARGIN
    np.testing.assert_array_equal(r0["v1_tp2_greedy"][clear, 0],
                                  want["v1_tp2_greedy"][clear, 0])


def test_v1_replica_clamping(run):
    """``tp_size`` 4 and ``replica_num`` 64 on 4 ranks clamp to a 1 x 4
    grid, as the JAX engine clamps its mesh, and serve the one-rank logits."""
    _, got, _ = run
    for r in got["grid4"]:
        assert r["clamp_grid"] == {"dp": 1, "tp": 4}
        np.testing.assert_allclose(r["clamp_logits"], r["clamp_alone"], **V1_TOL)


# ---------------------------------------------------------------------------
# v2: the engine at tp 2, one controller
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("key", ["v2_llama", "v2_llama_int8", "v2_mixtral"])
def test_v2_round_logits_match_jax_tp2(run, key):
    """Every round's last-token logits on the controller, against the JAX
    tp 2 engine's on the same token stream; greedy tokens where the gap
    clears the margin; the follower ran every forward and tracked nothing."""
    inp, got, want = run
    r0, r1 = got["tp2"]
    assert len(r0[key]) == len(want[key]) == len(inp["rounds"])
    held = 0
    for ours, ref in zip(r0[key], want[key]):
        np.testing.assert_allclose(ours, ref, atol=V2_ATOL, rtol=0)
        held += hold_tokens(ours, ref)
    assert held > 0
    assert r1[key] == len(inp["rounds"])            # the follower's forwards
    assert r1[f"{key}_tracked"] == 0 and r0[f"{key}_tracked"] == 4
    assert r0[f"{key}_attention"] == "cuda_paged"


@pytest.mark.parametrize("key", ["v2_llama", "v2_mixtral"])
def test_v2_exchanges_per_forward(run, key):
    """Per forward: two all-reduces a layer (after o and after down or the
    expert FFN), one embedding reduce, one logits gather, on every rank."""
    inp, got, _ = run
    forwards, layers = len(inp["rounds"]), 2
    for r in got["tp2"]:
        c = r[f"{key}_counts"]
        assert c["row_reduce"]["calls"] == 2 * layers * forwards
        assert c["vocab_embed"]["calls"] == c["gather_vocab"]["calls"] == forwards
        # a header and a payload a forward, and the stop's header
        assert c["broadcast_from_controller"]["calls"] == 2 * forwards + 1


def test_v2_planted_fault_fails_the_comparison(run):
    """Rank 1 holding rank 0's slice of one q_proj moves the logits far
    outside the bound."""
    _, got, want = run
    err = np.abs(got["tp2"][0]["v2_fault"][0] - want["v2_llama"][0]).max()
    assert err > 100 * V2_ATOL, err


def test_single_controller_sampling_and_skewed_clock(run):
    """Sampled streams at tp 2 equal a tp 1 engine's; with rank 1's
    scheduler clock skewed (and SLO burn rates read from it) they do not
    move: only rank 0 schedules and samples."""
    _, got, _ = run
    r0, r1 = got["tp2"]
    assert r0["replica_tp"] == (2, 0) and r1["replica_tp"] == (2, 1)
    assert r1["sampled_tp2"] is None and r1["skewed_tp2"] is None
    assert r0["sampled_tp2"] == r0["sampled_tp1"] == r1["sampled_tp1"]
    assert r0["skewed_tp2"] == r0["sampled_tp2"]
    assert all(len(t) == 6 for t in r0["sampled_tp2"].values())


def test_preemption_swaps_every_rank_s_pages(run):
    """Under KV pressure the controller preempts and resumes a sequence;
    the follower swaps its shards of the same pages, so the greedy streams
    equal the pressured tp 1 run's."""
    _, got, _ = run
    r0, r1 = got["tp2"]
    assert r0["pressure_swaps"]["swap_outs"] >= 1 and r0["pressure_swaps"]["swap_ins"] >= 1
    assert r0["pressure_tp2"] == r0["pressure_tp1"]
    assert all(len(t) == 6 for t in r0["pressure_tp2"].values())
    assert r1["pressure_tp2"] is None


# (case, the queue item that refused it at tp 2): A5 parts 2 and 3 serve
# their cases now (fleet and replica-group replicas at tp 2 build on both
# ranks), and a vocabulary tp does not divide raises ValueError as the JAX
# mesh does; the rest still name their item
SERVED_SINCE_A5_PART_2 = ("opt", "falcon", "kv_heads", "heads", "v1_quant", "speculative",
                          "host_tier", "fleet", "replica_group")


@pytest.mark.parametrize("case,item", [
    ("opt", "A5 part 2"), ("falcon", "A5 part 2"), ("kv_heads", "A5 part 2"),
    ("heads", "A5 part 2"), ("vocab", "A5 part 2"), ("v1_quant", "A5 part 2"),
    ("speculative", "A5 part 2"), ("host_tier", "A5 part 2"),
    ("v1_labels", "A12"), ("train_config", "A12"), ("train_mesh", "A12"),
    ("fleet", "A5 part 3"), ("replica_group", "A5 part 3"), ("ep_with_tp", "A12"),
])
def test_out_of_scope_raises(run, case, item):
    _, got, _ = run
    for r in got["tp2"]:
        msg = r["refusals"][case]
        if case in SERVED_SINCE_A5_PART_2:
            assert msg is None, msg
        elif case == "vocab":
            assert msg is not None and msg.startswith("ValueError") and "511" in msg \
                and "tp_size 2" in msg, msg
        else:
            assert msg is not None and msg.startswith("NotImplementedError") \
                and item in msg, msg


def test_idle_v1_ranks_raise_naming_a5_part_3(run):
    """A v1 grid of 2 ranks in a world of 4 leaves two idle, as the JAX mesh
    takes the first dp x tp devices (A5 part 3 serves it): every rank
    returns the same logits, bitwise, the grid's; ranks 2 and 3 are idle."""
    _, got, want = run
    ranks = got["grid4"]
    np.testing.assert_allclose(ranks[0]["idle_grid"][2], want["v1_tp2_logits"], **V1_TOL)
    for rank, r in enumerate(ranks):
        grid, idle, logits = r["idle_grid"]
        assert grid == {"dp": 1, "tp": 2} and idle == (rank >= 2)
        np.testing.assert_array_equal(logits, ranks[0]["idle_grid"][2])


def test_topology_tp_axis(run):
    """``tests/test_topology.py``'s tp cases with pp 1, on 4 ranks."""
    _, got, _ = run
    for rank, r in enumerate(got["grid4"]):
        t = r["topology"]
        assert t["sizes"] == (2, 2, 2)
        assert t["roundtrip"]
        assert t["indivisible"].startswith("AssertionError")
        assert t["registry"] == (2, rank % 2, 2, 2)
        assert t["tp_group_rank_sum"] == (1.0 if rank < 2 else 5.0)
        assert t["tensor_parallel"] == (2, rank % 2, (rank - rank % 2, rank - rank % 2 + 1))


def test_serving_never_replaces_an_installed_topology(run):
    """v1 and v2 take their grid from ``parallel.groups``: with none
    installed the engine installs its own (and the next engine at the same
    tp uses it); an installed topology with another tp axis raises in both
    builders and stays installed."""
    _, got, _ = run
    for key, suite in (("v1_tp2", "tp2"), ("v1_dp2tp2", "grid4")):
        assert all(r[f"{key}_installed"] for r in got[suite]), key
    for r in got["grid4"]:
        t = r["topology"]
        for builder in ("other_tp_v2", "other_tp_v1"):
            msg = t[builder]
            assert msg is not None and msg.startswith("ValueError") and "tp 4" in msg, msg
        assert t["kept"]


# ---------------------------------------------------------------------------
# slices drawn and loaded (one process)
# ---------------------------------------------------------------------------

def tiny_model(family, seed):
    if family == "llama":
        cfg = port_llama.LlamaConfig.tiny(dtype=torch.float32)
        return port_llama.LlamaForCausalLM.from_seed(cfg, seed=seed, device="cpu")
    cfg = port_mixtral.MixtralConfig.tiny(dtype=torch.float32)
    return port_mixtral.MixtralForCausalLM.from_seed(cfg, seed=seed, device="cpu")


@pytest.mark.parametrize("family", ["llama", "mixtral", "mixtral_ep"])
def test_from_seed_slices_equal_the_whole_draw(family):
    """Each rank's ``from_seed`` slices (``tp_rank`` of 2, or for
    ``mixtral_ep`` ``ep_rank`` of 2: dim 0 of each expert stack) equal the
    one-rank draw's, bitwise."""
    whole_model = tiny_model(family.split("_")[0], 5)
    cls, cfg = type(whole_model), whole_model.config
    whole = whole_model.state_dict()
    for rank in range(2):
        if family == "mixtral_ep":
            part = cls.from_seed(cfg, seed=5, device="cpu", ep_size=2, ep_rank=rank)
            specs = moe_param_specs(part)
            assert any(specs.values())

            def cut(name, full):
                return expert_slice(full, 2, rank) if specs[name] else full
        else:
            part = cls.from_seed(cfg, seed=5, device="cpu", tp_size=2, tp_rank=rank)
            cut = part.plan.cut
            assert part.tp.rank == rank and part.tp.size == 2
        for name, value in part.state_dict().items():
            assert torch.equal(value, cut(name, whole[name])), name


@pytest.mark.parametrize("family", ["llama", "mixtral"])
def test_shard_model_copies_the_slices(family):
    """``shard_model`` cuts a whole model into copies of the rank's slices:
    no split parameter shares storage with the whole model's, so dropping
    the whole model frees it; the values are the slices."""
    whole = tiny_model(family, 7)
    storages = {p.untyped_storage().data_ptr() for p in whole.parameters()}
    state = {n: p.detach().clone() for n, p in whole.named_parameters()}
    for rank in range(2):
        part = shard_model(whole, TensorParallel(size=2, rank=rank, ranks=(0, 1)))
        specs = part.param_specs()
        for name, p in part.named_parameters():
            assert torch.equal(p, part.plan.cut(name, state[name])), name
            if specs[name] is not None:
                assert p.untyped_storage().data_ptr() not in storages, name


@pytest.mark.parametrize("variant", ["llama", "qwen2", "internlm", "mixtral"])
def test_load_pretrained_slices_equal_the_whole_load(tmp_path, variant):
    """Each rank's ``load_pretrained(tp_size=2, tp_rank=r)`` of a written
    directory equals its slice of the whole load (q/k permuted on the rank's
    heads; q/k/v biases split, the o bias kept whole)."""
    if variant == "mixtral":
        cfg = port_mixtral.MixtralConfig.tiny(dtype=torch.float32)
        model = port_mixtral.MixtralForCausalLM.from_seed(cfg, seed=2, device="cpu")
    else:
        extra = {"qwen2": dict(attention_bias=True),
                 "internlm": dict(attention_bias=True, attention_out_bias=True)}
        cfg = port_llama.LlamaConfig.tiny(dtype=torch.float32, **extra.get(variant, {}))
        model = port_llama.LlamaForCausalLM.from_seed(cfg, seed=2, device="cpu")
        with torch.no_grad():
            for n, p in model.named_parameters():
                if n.endswith(".bias"):
                    p.normal_(0, 0.02)
    hf.export_pretrained(model, cfg, str(tmp_path))
    whole = hf.load_pretrained(str(tmp_path), device="cpu").state_dict()
    for rank in range(2):
        part = hf.load_pretrained(str(tmp_path), device="cpu", tp_size=2, tp_rank=rank)
        assert (part.tp.size, part.tp.rank) == (2, rank)
        state = part.state_dict()
        assert set(state) == set(whole)
        for name, value in state.items():
            assert torch.equal(value, part.plan.cut(name, whole[name])), name
