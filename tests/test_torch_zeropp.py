"""ZeRO++ (qwZ, hpZ's quantized primary exchange, the hierarchical quantized
collectives) and MiCS in the port against the JAX package, on 4 gloo ranks
on the CPU: the mirror of ``tests/test_zeropp.py`` and, by counting each
collective's group in the port's comm layer (``comm.collective_counts``),
of ``tests/test_hierarchical_collectives.py``.

The port's side runs once per module: a fixture starts 4 processes of
``tests/test_torch_zeropp_worker.py`` (a ``file://`` rendezvous under the
test's temporary directory, one thread each, a timeout on the whole run).
The JAX engines run here meanwhile, on 4 of the 8 virtual CPU devices, with
the same numpy inputs; each rank of the port gets the rows of the global
micro-batch that the JAX mesh places on its device. The 4 ranks are laid out
as the JAX meshes are: ``dpr`` 2 x ``dp`` 2 under hpZ and MiCS.

The model is the tiny Llama with an FFN of 640. qwZ groups each leaf along
its JAX twin's last axis: dim 0 of an ``nn.Linear`` weight [out, in], whose
Flax kernel is [in, out] (``zero/qwz.jax_leaves``). So ``gate_proj`` and
``up_proj`` [640, 64], cut along their 640 outputs at world 4 into 160, 0.625
of a group of 256, take qwZ's "rows" route; the JAX model stacks its layers,
so each layer's norm is a row of a 2-D leaf there and is quantized too.

Tolerances:
- the quantizer, qwZ's working copy, hpZ's exchange, the hierarchical
  collectives and ``reduce(buckets=k)``: exact (the same IEEE operations in
  the same order as the JAX package's);
- MiCS (fp32) against the JAX MiCS engine and the port's flat stage 1:
  losses to 1e-5 relative and masters to 2e-5 absolute, as the ZeRO stages
  of ``tests/test_torch_zero.py`` (summation order only: MiCS sums in dp,
  then across dpr). AdamW's eps is 1e-6 here, as in that file's MoE
  engines: with 1e-8 Adam turns the fp32 summation noise of a gradient
  near 0 into a master difference above 2e-5 (one element of 40960 read
  8.1e-5 against the JAX engine);
- hpZ (bf16) against the port's flat stage 3: equal, as hpZ only moves
  where the working shards live; against the JAX hpZ engine the bf16
  tolerances of ``tests/test_torch_zero.py`` (losses to 2e-3 relative);
- qwZ and hpZ + qwZ (bf16, int8 working copy) against the JAX qwZ and
  hpZ + qwZ engines: the bf16 loss tolerance of hpZ, 2e-3 relative (the
  same groups, the same ints, up to a bf16 rounding of a master that the
  fp32 summation order moves); a planted fault (rank 0's ``lm_head``
  scales doubled after the first requantize) falls outside it. Against
  the port's plain ZeRO-3, and the qgZ composition against it: JAX's rtol
  and atol of 0.15 (qgZ's int4 groups differ from the JAX engine's,
  ``tests/test_torch_zero.py``).
"""

import os
import subprocess
import sys
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.models.llama import LlamaConfig as JaxLlamaConfig
from deepspeed_tpu.models.llama import LlamaForCausalLM as JaxLlama
from deepspeed_tpu.ops.quantizer import dequantize_lastdim as jax_dequantize_lastdim
from deepspeed_tpu.ops.quantizer import quantize_lastdim as jax_quantize_lastdim
from deepspeed_tpu.parallel import groups as jgroups
from deepspeed_tpu.parallel.topology import MeshTopology as JaxMesh
from deepspeed_tpu.runtime.comm import coalesced_collectives as jcc
from deepspeed_tpu.runtime.engine import DeepSpeedEngine as JaxEngine
from deepspeed_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM, params_from_flax
from deepspeed_tpu_torch.ops import quantizer as pquant
from deepspeed_tpu_torch.runtime.zero import qwz
from deepspeed_tpu_torch.runtime.zero.partition import shard_of

WORLD, MICRO, GAS, T, STEPS = 4, 2, 2, 32, 4
WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)), "test_torch_zeropp_worker.py")
RUN_TIMEOUT_S = 150
LLAMA_DIMS = dict(vocab_size=512, hidden_size=64, intermediate_size=640,
                  num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
                  max_position_embeddings=128)
HPZ = dict(zero_shard_size=2, zero_hierarchy="hpz")
MICS = dict(zero_shard_size=2, zero_hierarchy="mics")
BF16 = {"bf16": {"enabled": True}}


def config(stage, dtype=None, **zero):
    cfg = {"train_batch_size": GAS * MICRO * WORLD, "train_micro_batch_size_per_gpu": MICRO,
           "gradient_accumulation_steps": GAS,
           "optimizer": {"type": "AdamW", "params": {"lr": 3e-3, "weight_decay": 0.01,
                                                     "eps": 1e-6}},
           "gradient_clipping": 1.0,
           "zero_optimization": dict({"stage": stage,
                                      "stage3_param_persistence_threshold": 0}, **zero)}
    return dict(cfg, **(dtype or {}))


QWZ = dict(zero_quantized_weights=True)
ENGINE_CASES = {
    "stage1": dict(config=config(1)),
    "mics": dict(config=config(1, mics_shard_size=2)),
    "mics_stage2": dict(config=config(2, mics_shard_size=2)),
    "stage3_bf16": dict(config=config(3, BF16)),
    "hpz": dict(config=config(3, BF16, zero_hpz_partition_size=2)),
    "qwz": dict(config=config(3, BF16, **QWZ)),
    "hpz_qwz": dict(config=config(3, BF16, zero_hpz_partition_size=2, **QWZ)),
    "hpz_qwz_qgz": dict(config=config(3, BF16, zero_hpz_partition_size=2,
                                      zero_quantized_gradients=True, **QWZ)),
    # the planted fault: rank 0's lm_head scales doubled after the first
    # requantize, until the next
    "qwz_fault": dict(config=config(3, BF16, **QWZ), fault="lm_head.weight"),
}
# the JAX engines the port's are held to: (case, dtype, mesh)
JAX_CASES = (("mics", jnp.float32, MICS), ("hpz", jnp.bfloat16, HPZ),
             ("qwz", jnp.bfloat16, {}), ("hpz_qwz", jnp.bfloat16, HPZ))
QWZ_RTOL = 2e-3
# leaves cut at world 4 along each qwZ route, with the axis their groups
# run along (0: an nn.Linear weight): gate_proj [640, 64] cut along its
# outputs, 160 of 640 a rank: rows; down_proj [64, 640] cut along its
# inputs, the JAX kernel's rows: chunk; 6 JAX rows over 4 ranks: whole;
# chunk along the last axis (256 columns, one whole group); chunk along
# dim 0; a stacked leaf's rows
QWZ_LEAVES = {"gate_proj": ((640, 64), 0), "down_proj": ((64, 640), 0),
              "uneven_linear": ((640, 6), 0), "uneven_rows": ((6, 640), -1),
              "aligned_cols": ((8, 1024), -1), "rows_dim0": ((512, 64), -1),
              "stacked": ((4, 8, 640), -1)}
QWZ_ROUTES = {"gate_proj": "rows", "down_proj": "chunk", "uneven_linear": "whole",
              "uneven_rows": "whole", "aligned_cols": "chunk", "rows_dim0": "chunk",
              "stacked": "rows"}


def llama_batches(seed=0, steps=STEPS):
    rng = np.random.default_rng(seed)
    window = []
    for _ in range(GAS):
        ids = rng.integers(0, 512, (MICRO * WORLD, T)).astype(np.int32)
        window.append({"input_ids": ids, "labels": ids})
    return window * steps


def jax_llama(dtype):
    model = JaxLlama(JaxLlamaConfig(**LLAMA_DIMS, dtype=dtype, remat=False))
    ids = jnp.asarray(llama_batches()[0]["input_ids"][:MICRO])
    return model, jax.tree.map(np.asarray, model.init(jax.random.PRNGKey(0), ids)["params"])


def jax_engine_runs(inputs):
    want = {}
    for case, dtype, mesh_kw in JAX_CASES:
        model, params = jax_llama(dtype)
        engine, *_ = deepspeed_tpu.initialize(
            model=model, model_parameters=params, config=ENGINE_CASES[case]["config"],
            mesh=JaxMesh(dp=WORLD, devices=jax.devices()[:WORLD], **mesh_kw))
        losses = []
        for b in inputs["llama_batches"]:
            loss = engine(b)
            engine.backward(loss)
            engine.step()
            losses.append(float(loss))
        want[case] = (losses, jax.tree.map(np.asarray, engine.get_model_parameters()),
                      engine)
        jgroups.reset()
    return want


def make_inputs():
    rng = np.random.default_rng(5)
    _, params = jax_llama(jnp.float32)
    return {
        "micro": MICRO, "llama_dims": LLAMA_DIMS, "engine_cases": ENGINE_CASES,
        "llama_params": params_from_flax(params), "llama_batches": llama_batches(),
        "a2a_single": rng.normal(size=(2, 64)).astype(np.float32),
        "a2a_hier": rng.normal(size=(2, 2, 128)).astype(np.float32),
        # rank r's blocks [inter (dpr), intra (dp), rows, cols]
        "moe_blocks": rng.normal(size=(WORLD, 2, 2, 3, 64)).astype(np.float32),
        "qwz_leaves": {n: ((rng.normal(size=s) * np.linspace(0.1, 3.0, s[-1])).astype(
            np.float32), axis) for n, (s, axis) in QWZ_LEAVES.items()},
        "bucket_leaves": [rng.normal(size=(WORLD,) + s).astype(np.float32)
                          for s in ((64, 32), (8,), (16, 300), (4, 4, 12), (128,), (32, 64))],
    }


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_zeropp")
    inputs = make_inputs()
    inputs["ckpt_dir"] = str(d / "ckpt")
    torch.save(inputs, d / "inputs.pt")
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")}
    env.update(OMP_NUM_THREADS="1", PYTHONUNBUFFERED="1")
    logs = [open(d / f"log{r}.txt", "w") for r in range(WORLD)]
    procs = [subprocess.Popen([sys.executable, WORKER, str(r), str(WORLD), str(d / "rdzv"),
                               str(d / "inputs.pt"), str(d / f"out{r}.pt")],
                              stdout=logs[r], stderr=subprocess.STDOUT, env=env)
             for r in range(WORLD)]
    deadline = time.monotonic() + RUN_TIMEOUT_S
    try:
        want = jax_engine_runs(inputs)
        for p in procs:
            p.wait(timeout=max(1.0, deadline - time.monotonic()))
    except subprocess.TimeoutExpired:
        pytest.fail(f"the {WORLD} gloo ranks did not finish in {RUN_TIMEOUT_S}s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()
    for r, p in enumerate(procs):
        if p.returncode:
            log = (d / f"log{r}.txt").read_text()
            pytest.fail(f"rank {r} exited {p.returncode}:\n{log[-4000:]}")
    ranks = [torch.load(d / f"out{r}.pt", weights_only=False) for r in range(WORLD)]
    return inputs, ranks, want


def jmesh2d():
    """dpr 2 x dp 2 over the first 4 devices: rank r = 2 * dpr + dp."""
    return jax.sharding.Mesh(np.asarray(jax.devices()[:WORLD]).reshape(2, 2), ("dpr", "dp"))


def masters(res):
    return {k: v.numpy() for k, v in res["master"].items()}


def jax_masters(tree):
    return {k: v.numpy() for k, v in params_from_flax(tree).items()}


# ---------------------------------------------------------------- quantizer

def test_quantize_lastdim_roundtrip():
    """JAX ``test_quantize_lastdim_roundtrip``'s case (the pad path, groups
    of 64 over 130 columns): the port's ints and scales equal the JAX
    package's, and the round trip is within a 64th of the largest value."""
    x = np.random.default_rng(1).normal(size=(64, 130)).astype(np.float32)
    q, s = pquant.quantize_lastdim(torch.from_numpy(x), group_size=64)
    jq, js = jax_quantize_lastdim(jnp.asarray(x), group_size=64)
    assert q.shape == x.shape and q.dtype == torch.int8
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    back = pquant.dequantize_lastdim(q, s, group_size=64)
    assert float((back - torch.from_numpy(x)).abs().max()) < float(np.abs(x).max()) / 64


@pytest.mark.parametrize("shape", [(64, 640), (4096 // 16, 11008 // 16), (8, 100), (3, 2, 257)])
def test_qwz_kernel_route_is_quantize_lastdim(shape):
    """qwZ's quantize (row 5's ``block_quantize`` on the rows, widened to
    fp32) and dequantize (row 6's ``block_dequantize``, one peer, cast once)
    against the JAX package's ``quantize_lastdim`` / ``dequantize_lastdim``
    of the same bf16 leaf, bit for bit (on the CPU the wrappers run their
    plain versions)."""
    x = np.random.default_rng(2).normal(size=shape).astype(np.float32) * 3
    xb = torch.from_numpy(x).to(torch.bfloat16)
    d = shape[-1]
    gs, _ = qwz.group_of(d)
    q, s = qwz.quantize_rows(xb.reshape(-1, d), gs)
    jq, js = jax_quantize_lastdim(jnp.asarray(x).astype(jnp.bfloat16))
    np.testing.assert_array_equal(q.view(shape).numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.view(qwz.scale_shape(shape)).numpy(), np.asarray(js))
    back = qwz.dequantize_leaf(q.view(shape), s.view(qwz.scale_shape(shape)), torch.bfloat16)
    want = jax_dequantize_lastdim(jq, js, dtype=jnp.bfloat16)
    np.testing.assert_array_equal(back.float().numpy(), np.asarray(want.astype(jnp.float32)))


# ---------------------------------------------------------------- collectives

def test_all_to_all_quant_reduce_single_axis(run):
    """JAX ``test_all_to_all_quant_reduce_single_axis``: int8 over the dp
    pair, groups of 32; each rank's shard equals the JAX collective's
    exactly, and the sum's to JAX's bound."""
    inputs, ranks, _ = run
    g = inputs["a2a_single"]
    f = jax.shard_map(lambda v: jcc.all_to_all_quant_reduce(v[0], intra_axis="dp",
                                                            intra_bits=8, group_size=32),
                      mesh=jax.sharding.Mesh(np.asarray(jax.devices()[:2]), ("dp",)),
                      in_specs=P("dp"), out_specs=P("dp"), check_vma=False)
    want = np.asarray(f(jnp.asarray(g))).reshape(2, -1)
    for r, rank in enumerate(ranks):
        got = rank["collectives"]["a2a_single"].numpy()
        np.testing.assert_array_equal(got, want[r % 2])
        np.testing.assert_allclose(got, g.sum(0).reshape(2, -1)[r % 2], atol=0.1, rtol=0.05)


def test_all_to_all_quant_reduce_hierarchical(run):
    """JAX ``test_all_to_all_quant_reduce_hierarchical`` on dpr 2 x dp 2:
    int4 in dp, int8 across dpr; rank (e, i) holds chunk i * 2 + e, equal
    to the JAX collective's and within JAX's bound of the true sum."""
    inputs, ranks, _ = run
    g = inputs["a2a_hier"]
    f = jax.shard_map(lambda v: jcc.all_to_all_quant_reduce(
        v[0, 0], intra_axis="dp", inter_axis="dpr", intra_bits=4, inter_bits=8,
        group_size=32)[None, None], mesh=jmesh2d(), in_specs=P("dpr", "dp"),
        out_specs=P("dpr", "dp"), check_vma=False)
    want = np.asarray(f(jnp.asarray(g)))
    total, shard = g.sum(axis=(0, 1)), g.shape[-1] // WORLD
    for r, rank in enumerate(ranks):
        e, i = divmod(r, 2)
        got = rank["collectives"]["a2a_hier"].numpy()
        np.testing.assert_array_equal(got, want[e, i])
        c = i * 2 + e
        np.testing.assert_allclose(got, total[c * shard:(c + 1) * shard], atol=1.0, rtol=0.1)


def test_moe_hierarchical_a2a(run):
    """``moe_hierarchical_a2a`` on dpr 2 x dp 2 against the JAX collective
    (full precision over dp, int8 over dpr): equal; and every block is the
    sender's payload to within its int8 step."""
    inputs, ranks, _ = run
    x = inputs["moe_blocks"]
    f = jax.shard_map(lambda v: jcc.moe_hierarchical_a2a(v[0, 0], "dp", "dpr", inter_bits=8,
                                                         group_size=64)[None, None],
                      mesh=jmesh2d(), in_specs=P("dpr", "dp"), out_specs=P("dpr", "dp"),
                      check_vma=False)
    want = np.asarray(f(jnp.asarray(x.reshape(2, 2, *x.shape[1:]))))
    for r, rank in enumerate(ranks):
        e, i = divmod(r, 2)
        got = rank["collectives"]["moe_hier_a2a"].numpy()
        np.testing.assert_array_equal(got, want[e, i])
        for a in range(2):
            for b in range(2):
                sent = x[a * 2 + b, e, i]      # what peer (a, b) addressed to (e, i)
                np.testing.assert_allclose(got[a, b], sent, atol=np.abs(sent).max() / 127)


# ---------------------------------------------------------------- topology

def test_hierarchical_topology(run):
    """JAX ``test_hierarchical_topology`` at world 4: hpZ and MiCS split
    the world into dpr 2 x dp 2, MiCS confines the ZeRO axes to dp, both
    confine the working shards; the MiCS and hpZ constructors build the
    same grids; each against the JAX topology."""
    _, ranks, _ = run
    for name, kw in (("hpz", HPZ), ("mics", MICS), ("mics_topology", MICS),
                     ("hpz_topology", HPZ)):
        jt = JaxMesh(dp=WORLD, devices=jax.devices()[:WORLD], **kw)
        for rank in ranks:
            got = rank["collectives"][f"topology_{name}"]
            assert got["sizes"] == (jt.dpr_size, jt.dp_size) == (2, 2)
            assert got["hierarchy"] == jt.zero_hierarchy
            assert got["zero_axes"] == jt.zero_axes
            assert got["param_zero_axes"] == jt.param_zero_axes
            assert got["data_parallel_size"] == jt.data_parallel_size == WORLD
            assert got["zero"][0] == (2 if kw is MICS else WORLD) and got["param"][0] == 2


# ---------------------------------------------------------------- engines

def test_hpz_engine_parity(run):
    """JAX ``test_hpz_engine_parity``: hpZ changes only where the working
    shards live, so its losses equal the port's flat stage 3 exactly, and
    are held to the JAX hpZ engine at bf16 tolerances; every working shard
    spans the dp pair, every master the world."""
    _, ranks, want = run
    want_losses = want["hpz"][0]
    for rank in ranks:
        res = rank["hpz"]
        assert res["hierarchy"] == "hpz" and res["sizes"] == (2, 2)
        assert res["losses"] == rank["stage3_bf16"]["losses"]
        np.testing.assert_allclose(res["losses"], want_losses, rtol=2e-3)
        for name, (world, param_world, _) in res["placement"].items():
            assert (world, param_world) == (WORLD, 2), name
    assert want_losses[-1] < want_losses[0]


def test_mics_engine_parity(run):
    """JAX ``test_mics_engine_parity``: MiCS at stage 1 against the port's
    flat stage 1 and the JAX MiCS engine; masters and moments shard over
    the dp pair only."""
    _, ranks, want = run
    want_losses, want_tree, _ = want["mics"]
    want_master = jax_masters(want_tree)
    for rank in ranks:
        res = rank["mics"]
        assert res["hierarchy"] == "mics"
        np.testing.assert_allclose(res["losses"], rank["stage1"]["losses"], rtol=1e-5)
        np.testing.assert_allclose(res["losses"], want_losses, rtol=1e-5)
        for name, got in masters(res).items():
            np.testing.assert_allclose(got, want_master[name], rtol=0, atol=2e-5,
                                       err_msg=name)
        for name, (world, _, _) in res["placement"].items():
            assert world == 2, name
        np.testing.assert_allclose(rank["mics_stage2"]["losses"], rank["stage1"]["losses"],
                                   rtol=1e-5)


def test_qwz_engine(run):
    """JAX ``test_qwz_engine``: the int8 working copy trains; its losses
    against the JAX qwZ engine at the bf16 tolerance (the same groups), and
    against the port's plain ZeRO-3 at JAX's 0.15."""
    _, ranks, want = run
    want_losses, _, jengine = want["qwz"]
    assert jengine.quantized_weights
    for rank in ranks:
        res = rank["qwz"]
        assert res["quantized"], "expected int8 working weights"
        assert all(res["placement"][n][2] == torch.int8 for n in res["quantized"])
        np.testing.assert_allclose(res["losses"], want_losses, rtol=QWZ_RTOL)
        np.testing.assert_allclose(res["losses"], rank["stage3_bf16"]["losses"],
                                   rtol=0.15, atol=0.15)
        assert res["losses"][-1] < res["losses"][0]
        assert res["resident_after"] == 0


def test_qwz_tolerance_rejects_planted_fault(run):
    """The qwZ run with rank 0's ``lm_head`` scales doubled after the first
    requantize: the same losses up to the fault, then outside the bf16
    tolerance that holds the clean run to the JAX engine."""
    _, ranks, want = run
    want_losses = want["qwz"][0]
    for rank in ranks:
        got = rank["qwz_fault"]["losses"]
        assert got[:GAS] == rank["qwz"]["losses"][:GAS]
        assert not np.allclose(got, want_losses, rtol=QWZ_RTOL), got


def test_hpz_qwz_engine_parity(run):
    """hpZ + qwZ (bf16): the primary exchange moves int8, the working copy
    lands bf16 on the dp pair; the losses against the JAX hpZ + qwZ engine
    at the bf16 tolerance."""
    _, ranks, want = run
    want_losses, _, jengine = want["hpz_qwz"]
    assert jengine.topology.zero_hierarchy == "hpz"
    for rank in ranks:
        res = rank["hpz_qwz"]
        assert not res["quantized"] and res["wire"]["hpz_primary_exchange"]["wire"] > 0
        np.testing.assert_allclose(res["losses"], want_losses, rtol=QWZ_RTOL)


def jax_tree_of(sd):
    """The tiny Llama's port state dict as the JAX model's param tree
    (``params_from_flax`` inverted): layers stacked, kernels [in, out]."""
    L = LLAMA_DIMS["num_hidden_layers"]

    def stack(fmt, kernel=False):
        return np.stack([sd[fmt.format(i)].numpy().T if kernel else sd[fmt.format(i)].numpy()
                         for i in range(L)])

    block = {n: {"scale": stack("layers.{}.%s.weight" % n)}
             for n in ("input_layernorm", "post_attention_layernorm")}
    for group, names in (("self_attn", ("q_proj", "k_proj", "v_proj", "o_proj")),
                         ("mlp", ("gate_proj", "up_proj", "down_proj"))):
        block[group] = {n: {"kernel": stack("layers.{}.%s.%s.weight" % (group, n), True)}
                        for n in names}
    return {"embed_tokens": sd["embed_tokens.weight"].numpy(),
            "lm_head": sd["lm_head.weight"].numpy(),
            "norm": {"scale": sd["norm.weight"].numpy()}, "layers": {"block": block}}


def test_qwz_working_copy_is_quantize_lastdim(run):
    """Right after the first requantize, each rank's int8 chunk and the
    whole scales equal the JAX engine's ``_quantize_working`` of the JAX
    model's bf16 tree built from the same masters, bit for bit: the
    kernels' groups along their outputs (gate/up's mid-group cut
    included), the stacked norms quantized."""
    _, ranks, _ = run
    from deepspeed_tpu_torch.runtime.zero.partition import zero_shard_dim
    master = ranks[0]["qwz"]["first_master"]
    tree = jax_tree_of(master)
    assert jax.tree.structure(tree) == jax.tree.structure(jax_llama(jnp.float32)[1])
    jq = _jax_quantize_working(jax.tree.map(lambda a: jnp.asarray(a).astype(jnp.bfloat16),
                                            tree))
    is_q = lambda x: isinstance(x, dict) and set(x) == {"q", "scale"}    # noqa: E731
    part = lambda k: jax.tree.map(lambda x: np.asarray(x[k] if is_q(x) else x), jq,  # noqa: E731
                                  is_leaf=is_q)
    want_q, want_s = params_from_flax(part("q")), params_from_flax(part("scale"))
    # every leaf but the final norm, 1-D in the JAX model too
    assert sorted(ranks[0]["qwz"]["working"]) == sorted(n for n in master if n != "norm.weight")
    for name, full in master.items():
        if name == "norm.weight":
            continue
        # params_from_flax transposes the kernels; a kernel's scales are
        # [in, G], the JAX layout
        s_want = want_s[name].T if name.endswith("_proj.weight") else want_s[name]
        d = zero_shard_dim(full.shape, WORLD)
        for r, rank in enumerate(ranks):
            q, s = rank["qwz"]["working"][name]
            assert torch.equal(q.float(), shard_of(want_q[name], d, WORLD, r)), name
            np.testing.assert_array_equal(s.numpy(), s_want.numpy(), err_msg=name)


def test_qwz_gather_is_dequantize_working(run):
    """What the stage-3 gather hands the forward right after the first
    requantize (the int8 chunks all-gathered and dequantized at use) is the
    JAX engine's ``_dequantize_working`` of its quantized tree, bit for bit,
    on every rank."""
    _, ranks, _ = run
    tree = jax_tree_of(ranks[0]["qwz"]["first_master"])
    jq = _jax_quantize_working(jax.tree.map(lambda a: jnp.asarray(a).astype(jnp.bfloat16),
                                            tree))
    fake = SimpleNamespace(working_dtype=jnp.bfloat16, _is_qleaf=JaxEngine._is_qleaf)
    deq = JaxEngine._dequantize_working(fake, jq)
    want = params_from_flax(jax.tree.map(lambda a: np.asarray(a.astype(jnp.float32)), deq))
    for rank in ranks:
        got = rank["qwz"]["gathered"]
        assert sorted(got) == sorted(want)
        for name, w in want.items():
            assert got[name].dtype == torch.bfloat16
            assert torch.equal(got[name].float(), w), name


def test_qwz_checkpoint_roundtrip(run):
    """JAX ``test_qwz_checkpoint_roundtrip``: a tag saved with the int8
    working copy loads into an engine that started elsewhere; the masters
    and the working copy come back."""
    _, ranks, _ = run
    for rank in ranks:
        res = rank["qwz_checkpoint"]
        for name, a in res["before"].items():
            np.testing.assert_allclose(res["after"][name].numpy(), a.numpy(), atol=1e-6)
        for name, (q, s) in res["before_q"].items():
            assert torch.equal(res["after_q"][name][0], q)
            assert torch.equal(res["after_q"][name][1], s)


def _jax_quantize_working(tree):
    """The JAX engine's ``_quantize_working`` of ``tree``: every leaf of 2+
    dimensions quantized (threshold 0)."""
    fake = SimpleNamespace(config=SimpleNamespace(zero_config=SimpleNamespace(
        stage3_param_persistence_threshold=0)))
    fake._should_quantize = lambda leaf: JaxEngine._should_quantize(fake, leaf)
    return JaxEngine._quantize_working(fake, tree)


@pytest.mark.parametrize("name", sorted(QWZ_LEAVES))
def test_qwz_and_hpz_exchange_bitwise(run, name):
    """qwZ's working copy from each rank's chunk (``requantize_chunk``) is
    bitwise the JAX engine's ``_quantize_working`` of the whole bf16 JAX
    leaf (an ``nn.Linear`` weight transposed), cut as the port cuts it;
    hpZ's exchange (``quantized_full`` then the dequantize) is bitwise JAX
    ``hpz_exchange``'s value, ``dequantize_lastdim(quantize_lastdim(leaf))``
    in bf16."""
    inputs, ranks, _ = run
    x, axis = inputs["qwz_leaves"][name]
    jleaf = jnp.asarray(np.moveaxis(x, axis, -1)).astype(jnp.bfloat16)
    jq = _jax_quantize_working({"w": jleaf})["w"]
    q_full = np.moveaxis(np.array(jq["q"]), -1, axis)
    s_full = np.array(jq["scale"])
    hpz = np.moveaxis(np.asarray(jax_dequantize_lastdim(jq["q"], jq["scale"],
                                                        dtype=jnp.bfloat16)
                                 .astype(jnp.float32)), -1, axis)
    for r, rank in enumerate(ranks):
        got = rank["collectives"][f"qwz_{name}"]
        assert got["route"] == QWZ_ROUTES[name]
        want_q = shard_of(torch.from_numpy(np.ascontiguousarray(q_full)), got["dim"], WORLD, r)
        assert torch.equal(got["q"], want_q)
        np.testing.assert_array_equal(got["scale"].numpy(), s_full)
        np.testing.assert_array_equal(got["q_full"].numpy(), q_full)
        np.testing.assert_array_equal(got["scale_full"].numpy(), s_full)
        np.testing.assert_array_equal(got["hpz"].float().numpy(), hpz)


def test_hpz_qwz_qgz_engine(run):
    """The ZeRO++ composition (ZeRO-3 + qgZ + qwZ + hpZ 2, bf16): the
    working copy stays bf16 on the dp pair, the primary exchange moves
    int8 + scales (about half the bf16 bytes, the row-route's re-layout
    included), and the loss falls."""
    _, ranks, _ = run
    for rank in ranks:
        res = rank["hpz_qwz_qgz"]
        assert not res["quantized"]
        assert all(p[2] == torch.bfloat16 for n, p in res["placement"].items()
                   if p[2] is not None)
        ex = res["wire"]["hpz_primary_exchange"]
        assert 0 < ex["wire"] < 0.7 * ex["logical"], ex
        assert res["losses"][-1] < res["losses"][0]
        np.testing.assert_allclose(res["losses"], rank["stage3_bf16"]["losses"],
                                   rtol=0.15, atol=0.15)


@pytest.mark.parametrize("config,match,error", [
    (dict(config(3, **QWZ)), "requires fp16/bf16", ValueError),
    (dict(config(3, BF16, zero_quantized_gradients=True, **QWZ)),
     "zero_hpz_partition_size", ValueError),
    (dict(config(3, BF16, offload_optimizer={"device": "cpu"}, **QWZ)),
     "offload_optimizer", ValueError),
])
def test_qwz_refusals_are_the_jax_packages(config, match, error):
    """qwZ raises the JAX engine's ``ValueError``s: without mixed precision,
    with qgZ but no secondary partition, with optimizer offload."""
    model = LlamaForCausalLM(LlamaConfig.tiny(dtype=torch.float32))
    cfg = dict(config, train_batch_size=MICRO * GAS)
    with pytest.raises(error, match=match):
        deepspeed_tpu_torch.initialize(model=model, config=cfg, device="cpu")


# ------------------------------------------- test_hierarchical_collectives.py

def _groups(counts, op):
    return {ranks for (o, ranks), n in counts.items() if o == op and n}


def test_flat_stage3_gathers_span_world(run):
    """Control: flat ZeRO-3's parameter gathers span the whole world, so
    the counting below could not pass vacuously."""
    _, ranks, _ = run
    for rank in ranks:
        gathers = _groups(rank["stage3_bf16"]["counts"]["micro"], "all_gather")
        assert gathers == {(0, 1, 2, 3)}


def test_hpz_param_gathers_confined_to_shard_group(run):
    """hpZ: every forward/backward parameter gather rides the rank's dp
    pair, none spans the world; the gradient reduction still does."""
    _, ranks, _ = run
    for r, rank in enumerate(ranks):
        micro = rank["hpz"]["counts"]["micro"]
        pair = (r - r % 2, r - r % 2 + 1)
        assert _groups(micro, "all_gather") == {pair}
        assert sum(n for (o, g), n in micro.items() if o == "all_gather") >= 3
        assert (0, 1, 2, 3) in _groups(micro, "reduce_scatter")


def test_mics_apply_confined_grads_full_world(run):
    """MiCS (stage 2): each micro-step's gradients are reduce-scattered in
    the dp pair and all-reduced across the dpr pair, which together span
    the world; every collective of the apply step stays in the dp pair."""
    _, ranks, _ = run
    for r, rank in enumerate(ranks):
        counts = rank["mics_stage2"]["counts"]
        pair, across = (r - r % 2, r - r % 2 + 1), (r % 2, r % 2 + 2)
        assert _groups(counts["micro"], "reduce_scatter") == {pair}
        assert across in _groups(counts["micro"], "all_reduce")
        applied = {g for (o, g), n in counts["apply"].items() if n}
        assert applied == {pair}, applied


# ------------------------------------------------------------- qgZ buckets

def test_reduce_buckets_bitwise(run):
    """``QgzPlan.reduce(buckets=3)`` (three byte-balanced buckets) is
    bitwise ``reduce(buckets=1)``, with and without the error-feedback
    residual, on the hierarchical dpr x dp plan; each bucket's 6 leaves go
    over one coalesced call of ints and one of scales a stage: 4 all-to-alls
    for one bucket, 12 for three, where one call a leaf would take 24."""
    _, ranks, _ = run
    for rank in ranks:
        c = rank["collectives"]
        assert len(c["buckets_3_groups"]) == 3
        for a, b in zip(c["buckets_1"], c["buckets_3"]):
            assert torch.equal(a, b)
        for xs, ys in zip(c["buckets_1_residual"], c["buckets_3_residual"]):
            for a, b in zip(xs, ys):
                assert torch.equal(a, b)
        assert (c["buckets_1_calls"], c["buckets_3_calls"]) == (4, 12)
