"""Data-parallel ZeRO training and the ZeRO++ exchanges of the port against
the JAX package's, on 4 gloo ranks on the CPU.

The port's side runs once per module: a fixture starts 4 processes of
``tests/test_torch_zero_worker.py`` (a ``file://`` rendezvous under the test's
temporary directory, one thread each, a timeout on the whole run), which
run every scenario and return their results. The JAX engines run here,
on 4 of the 8 virtual CPU devices, in the same fixture while the ranks
work, with the same numpy inputs: each rank of the port gets the rows of
the global micro-batch that the JAX mesh places on its device.

Tolerances:
- ZeRO stages 0-3 and the masked-loss run (fp32): the port sums the ranks'
  gradients of their local means and divides by the world, the JAX engine
  takes the gradient of the mean over the global batch; the two differ only
  in summation order, so losses agree to 1e-5 relative and the final master
  parameters to 2e-5 absolute, as in ``tests/test_torch_engine.py``: they
  move by up to ~0.02 over 6 steps, and Adam's update of an element whose
  gradient is near 0 turns that summation noise into up to ~2e-5 (one
  element of a stage-1 run reached 1.9e-5; all others stay below 1e-5);
- ``exchange_reduce``, ``quantized_all_gather`` and ``_reduce_leaf`` are
  exact: the ints and scales are the same IEEE operations, and the sums are
  taken in the same peer order; ``reduce_scatter_coalesced`` sums integer
  values, exact in any order;
- qgZ engines: int4 gradients, so the losses agree to the rtol 0.15 of
  ``tests/test_qgz.py``. The two engines also quantize different groups:
  the JAX Llama stacks each layer's weight as [L, in, out] and the port
  keeps [out, in] per layer, so their shard dimensions and groups of 2048
  differ.
"""

import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

import flax.linen as fnn
import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.models.llama import LlamaConfig as JaxLlamaConfig
from deepspeed_tpu.models.llama import LlamaForCausalLM as JaxLlama
from deepspeed_tpu.parallel.topology import MeshTopology as JaxMesh
from deepspeed_tpu.runtime.comm import coalesced_collectives as jcc
from deepspeed_tpu.runtime.zero.config import DeepSpeedZeroConfig as JaxZeroConfig
from deepspeed_tpu.runtime.zero.partition import ZeroPartitioner as JaxPartitioner
from deepspeed_tpu.runtime.zero.qgz import QgzPlan as JaxQgzPlan
from deepspeed_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM, params_from_flax

WORLD, MICRO, GAS, T, STEPS = 4, 2, 2, 32, 6
WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)), "test_torch_zero_worker.py")
RUN_TIMEOUT_S = 240
IGNORE = -100
MASKED_DIMS = (64, 32)      # vocab, width


def llama_config(**extra):
    cfg = {"train_batch_size": GAS * MICRO * WORLD,
           "train_micro_batch_size_per_gpu": MICRO,
           "gradient_accumulation_steps": GAS,
           "optimizer": {"type": "AdamW", "params": {"lr": 3e-3, "weight_decay": 0.01}},
           "scheduler": {"type": "WarmupDecayLR",
                         "params": {"total_num_steps": STEPS, "warmup_num_steps": 2}},
           "gradient_clipping": 1.0}
    cfg.update(extra)
    return cfg


def zero(stage, **kw):
    return {"zero_optimization": dict({"stage": stage,
                                       "stage3_param_persistence_threshold": 0}, **kw)}


QGZ = dict(zero_quantized_gradients=True)
LLAMA_CASES = {
    "stage0": zero(0), "stage1": zero(1), "stage2": zero(2), "stage3": zero(3),
    "stage3_bf16": dict(zero(3), bf16={"enabled": True}),
    "qgz": zero(2, **QGZ),
    "qgz_hpz": zero(3, zero_hpz_partition_size=2, **QGZ),
    "qgz_fp16": dict(zero(2, **QGZ), fp16={"enabled": True, "initial_scale_power": 8}),
    # the first step's scale overflows fp16: that step is skipped and must
    # keep the (zero) residual
    "qgz_feedback": dict(zero(2, zero_quantized_gradients_error_feedback=True, **QGZ),
                         fp16={"enabled": True, "initial_scale_power": 20,
                               "hysteresis": 1}),
}
MASKED_CONFIG = dict(llama_config(), optimizer={"type": "AdamW", "params": {"lr": 1e-2}},
                     scheduler={}, **zero(3))


def llama_batches(seed=0):
    """GAS global micro-batches, repeated every optimizer step: a loss the
    6 steps can lower."""
    rng = np.random.default_rng(seed)
    window = []
    for _ in range(GAS):
        ids = rng.integers(0, 512, (MICRO * WORLD, T)).astype(np.int32)
        window.append({"input_ids": ids, "labels": ids})
    return window * STEPS


def masked_batches(seed=1):
    """Rank r's rows ignore a fraction r/4 of their labels: uneven valid
    counts across ranks."""
    rng = np.random.default_rng(seed)
    V = MASKED_DIMS[0]
    out = []
    for _ in range(GAS * 4):
        ids = rng.integers(0, V, (MICRO * WORLD, T)).astype(np.int32)
        labels = rng.integers(0, V, (MICRO * WORLD, T)).astype(np.int32)
        drop = rng.random((MICRO * WORLD, T)) < (np.arange(MICRO * WORLD) // MICRO)[:, None] / 4
        out.append({"input_ids": ids, "labels": np.where(drop, IGNORE, labels)})
    return out


class JaxMaskedLM(fnn.Module):
    """The JAX twin of ``test_torch_zero_worker.MaskedLM``."""
    vocab: int
    dim: int

    @fnn.compact
    def __call__(self, batch, deterministic=True):
        init = fnn.initializers.normal(0.5)
        embed = self.param("embed", init, (self.vocab, self.dim))
        w1 = self.param("w1", init, (self.dim, self.dim))
        b1 = self.param("b1", init, (self.dim,))
        head = self.param("head", init, (self.dim, self.vocab))
        logits = jnp.tanh(embed[batch["input_ids"]] @ w1 + b1) @ head
        labels = batch["labels"]
        mask = labels != IGNORE
        tgt = jnp.take_along_axis(logits, jnp.maximum(labels, 0)[..., None], -1)[..., 0]
        nll = jax.nn.logsumexp(logits, -1) - tgt
        return (nll * mask).sum() / jnp.maximum(mask.sum(), 1)


def jax_llama(dtype=jnp.float32):
    model = JaxLlama(JaxLlamaConfig.tiny(dtype=dtype, remat=False))
    ids = jnp.asarray(llama_batches()[0]["input_ids"][:MICRO])
    return model, jax.tree.map(np.asarray, model.init(jax.random.PRNGKey(0), ids)["params"])


def jax_masked():
    model = JaxMaskedLM(*MASKED_DIMS)
    b = masked_batches()[0]
    params = model.init(jax.random.PRNGKey(3), {k: jnp.asarray(v) for k, v in b.items()})
    return model, jax.tree.map(np.asarray, params["params"])


def jax_mesh(**kw):
    return JaxMesh(dp=WORLD, devices=jax.devices()[:WORLD], **kw)


def run_jax_engine(model, params, config, micro_batches, mesh=None):
    """(losses, final parameters, global gradient norm) of the JAX engine."""
    engine, *_ = deepspeed_tpu.initialize(model=model, model_parameters=params,
                                          config=config, mesh=mesh or jax_mesh())
    losses = []
    for b in micro_batches:
        loss = engine(b)
        engine.backward(loss)
        engine.step()
        losses.append(float(loss))
    return (losses, jax.tree.map(np.asarray, engine.get_model_parameters()),
            engine.get_global_grad_norm())


HPZ = dict(zero_shard_size=2, zero_hierarchy="hpz")


def jax_engine_runs(inputs):
    """The JAX engine's run of every case the tests compare with."""
    batches = inputs["llama_batches"]
    want = {}
    for case, dtype, mesh_kw in (("stage0", jnp.float32, {}), ("stage1", jnp.float32, {}),
                                 ("stage2", jnp.float32, {}), ("stage3", jnp.float32, {}),
                                 ("stage3_bf16", jnp.bfloat16, {}), ("qgz", jnp.float32, {}),
                                 ("qgz_hpz", jnp.float32, HPZ)):
        model, params = jax_llama(dtype)
        want[case] = run_jax_engine(model, params, llama_config(**LLAMA_CASES[case]),
                                    batches, mesh=jax_mesh(**mesh_kw))
    model, params = jax_masked()
    want["masked"] = run_jax_engine(model, params, MASKED_CONFIG, inputs["masked_batches"])
    return want


def make_inputs():
    rng = np.random.default_rng(7)
    _, lp = jax_llama()
    _, mp = jax_masked()
    return {
        "micro": MICRO,
        "llama_params": params_from_flax(lp),
        "llama_config": llama_config(),
        "llama_batches": llama_batches(),
        "llama_cases": LLAMA_CASES,
        "masked_dims": MASKED_DIMS,
        "masked_params": {k: torch.tensor(v) for k, v in mp.items()},
        "masked_config": MASKED_CONFIG,
        "masked_batches": masked_batches(),
        # rank r's exchange payload (row j for peer j): 3000 is not a
        # multiple of the 2048 group
        "payload": rng.standard_normal((WORLD, WORLD, 3000)).astype(np.float32),
        "shard": rng.standard_normal((WORLD, 5, 300)).astype(np.float32),
        "coalesced": [rng.integers(-50, 50, (WORLD,) + s).astype(np.float32)
                      for s in ((10,), (16,), (3, 4))],
        # a JAX-stacked Llama leaf [L, in, out]
        "stacked": rng.standard_normal((WORLD, 2, 64, 128)).astype(np.float32),
    }


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """Inputs, the results of every port-side scenario per rank, and the
    JAX engine's runs (``jax_engine_runs``)."""
    d = tmp_path_factory.mktemp("torch_zero")
    inputs = make_inputs()
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


def port_master(res):
    return {k: v.numpy() for k, v in res["master"].items()}


# ---------------------------------------------------------------------------
# ZeRO stages against the JAX engine
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("stage", [0, 1, 2, 3])
def test_stage_matches_jax_engine(run, stage):
    """6 optimizer steps of GAS 2 on 4 ranks: every rank's losses and final
    masters against the JAX engine on a 4-device mesh at the same stage."""
    _, ranks, want = run
    want_losses, want_master, want_norm = want[f"stage{stage}"]
    want_master = {k: v.numpy() for k, v in params_from_flax(want_master).items()}
    for rank in ranks:
        res = rank[f"stage{stage}"]
        np.testing.assert_allclose(res["losses"], want_losses, rtol=1e-5)
        for name, got in port_master(res).items():
            np.testing.assert_allclose(got, want_master[name], rtol=0, atol=2e-5,
                                       err_msg=name)
        assert res["grad_norm"] == pytest.approx(want_norm, rel=1e-4)
    assert want_losses[-1] < want_losses[0]


def test_zero3_bf16_matches_jax_engine(run):
    """Stage 3 in bf16 (bf16 working shards cast from the fp32 master
    chunks) against the JAX engine at stage 3 in bf16, with the bf16
    tolerances of ``tests/test_torch_engine.py``: losses to 2e-3 relative,
    the parameter updates to 10% relative L2 (a sign-flipped update gives
    ~200%, none 100%)."""
    _, ranks, want = run
    _, params = jax_llama(jnp.bfloat16)
    want_losses, want_master, _ = want["stage3_bf16"]
    start = params_from_flax(params)
    want_master = params_from_flax(want_master)
    want = torch.cat([(want_master[n] - start[n]).flatten() for n in start])
    for rank in ranks:
        res = rank["stage3_bf16"]
        np.testing.assert_allclose(res["losses"], want_losses, rtol=2e-3)
        got = torch.cat([(res["master"][n] - start[n]).flatten() for n in start])
        assert float((got - want).norm() / want.norm()) < 0.1
        assert not any(resident for *_, resident, _ in res["at_rest"].values())


def test_zero3_working_params_are_sharded_at_rest(run):
    """Stage 3: after training, every leaf's working copy holds no storage
    and each rank keeps a quarter of it (every tiny-Llama leaf has a
    dimension divisible by 4), as do the masters."""
    _, ranks, _ = run
    for rank in ranks:
        for name, (numel, shard, resident, master) in rank["stage3"]["at_rest"].items():
            assert shard == numel // WORLD and master == numel // WORLD, name
            assert not resident, name
    for name, (numel, shard, resident, master) in ranks[0]["stage2"]["at_rest"].items():
        assert shard is None and resident and master == numel // WORLD, name


def test_uneven_masks_give_the_global_mean(run):
    """Ranks hold 100%, 75%, 50% and 25% valid labels: the port weights each
    rank's masked mean by its count and matches the JAX loss over the
    global batch (stage 3). The mean of the ranks' local means differs from
    it by far more than the tolerance, so the weighting is what passes."""
    inputs, ranks, want = run
    model, params = jax_masked()
    batches = inputs["masked_batches"]
    want_losses, want_master, _ = want["masked"]
    for rank in ranks:
        np.testing.assert_allclose(rank["masked"]["losses"], want_losses, rtol=1e-5)
        for name, got in port_master(rank["masked"]).items():
            np.testing.assert_allclose(got, want_master[name], rtol=0, atol=2e-5,
                                       err_msg=name)
    b = {k: jnp.asarray(v) for k, v in batches[0].items()}
    local = [float(model.apply({"params": params},
                               {k: v[r * MICRO:(r + 1) * MICRO] for k, v in b.items()}))
             for r in range(WORLD)]
    assert abs(np.mean(local) - want_losses[0]) > 1e-3 * want_losses[0]


@pytest.mark.parametrize("hierarchy", ["dp", "hpz"])
def test_rank_grid_matches_jax_topology(run, hierarchy):
    """Each rank's coordinates, the ZeRO world index (dpr_idx * dp +
    dp_idx) and the stage-3 working-shard group (under hpZ the dp group of
    2) against the JAX topology on 4 devices."""
    _, ranks, _ = run
    kw = HPZ if hierarchy == "hpz" else {}
    jt = jax_mesh(**kw)
    dp = jt.get_dim("dp")
    for r, rank in enumerate(ranks):
        got = rank["collectives"][f"topology_{hierarchy}"]
        coord = jt.get_coord(r)
        assert got["coord"] == coord and got["rank"] == r == jt.get_rank(**coord)
        assert tuple(got["zero"]) == (WORLD, coord["dpr"] * dp + coord["dp"])
        assert tuple(got["param"]) == (dp, coord["dp"])
        if hierarchy == "hpz":
            assert got["dp_group"] == [coord["dpr"] * dp + i for i in range(dp)]


@pytest.mark.parametrize("environ,want", [
    ({}, (None, 1, 0, 0)),
    ({"MASTER_ADDR": "node0", "WORLD_SIZE": "8", "RANK": "5", "LOCAL_RANK": "1"},
     ("node0", 8, 5, 1)),
    ({"DST_COORDINATOR_ADDRESS": "node1", "DST_NUM_PROCESSES": "4", "DST_PROCESS_ID": "3",
      "DST_LOCAL_RANK": "3", "MASTER_ADDR": "node0", "WORLD_SIZE": "8", "RANK": "5"},
     ("node1", 4, 3, 3)),
])
def test_process_env_discovery(monkeypatch, environ, want):
    """The launcher's rank, world, coordinator and the local rank that picks
    each process's card, from the torchrun variables or their DST_ names."""
    from deepspeed_tpu_torch.comm import comm
    for k in ("MASTER_ADDR", "WORLD_SIZE", "RANK", "LOCAL_RANK", "DST_COORDINATOR_ADDRESS",
              "DST_NUM_PROCESSES", "DST_PROCESS_ID", "DST_LOCAL_RANK"):
        monkeypatch.delenv(k, raising=False)
    for k, v in environ.items():
        monkeypatch.setenv(k, v)
    assert comm.discover_process_env() + (comm.get_local_rank(),) == want
    assert comm.discover_process_env(environ) == want[:3]


def test_unported_axes_raise():
    from deepspeed_tpu_torch.parallel.topology import MeshTopology
    for kw, item in ((dict(tp=2), "A12"), (dict(ep=2), "A9"), (dict(pp=2), "A12"),
                     (dict(sp=2), "A12")):
        with pytest.raises(NotImplementedError, match=item):
            MeshTopology(devices=[0, 1], **kw)


# ---------------------------------------------------------------------------
# the exchanges against the JAX functions under shard_map
# ---------------------------------------------------------------------------

def shard_mapped(fn, n_out, mesh=None, axes=("dp",)):
    mesh = mesh or jax.sharding.Mesh(np.array(jax.devices()[:WORLD]), ("dp",))
    spec = P(axes if len(axes) > 1 else axes[0])
    return jax.shard_map(fn, mesh=mesh, in_specs=spec,
                         out_specs=tuple([spec] * n_out) if n_out > 1 else spec,
                         axis_names=set(axes), check_vma=False)


@pytest.mark.parametrize("bits", [4, 8])
def test_exchange_reduce_matches_jax(run, bits):
    inputs, ranks, _ = run
    fn = shard_mapped(lambda b: tuple(x[None] for x in jcc.exchange_reduce(
        b[0], "dp", bits, 2048, return_error=True)), 2)
    want_out, want_err = (np.asarray(x) for x in fn(jnp.asarray(inputs["payload"])))
    for r, rank in enumerate(ranks):
        got, err, plain = rank["collectives"][f"exchange_{bits}"]
        np.testing.assert_array_equal(got.numpy(), want_out[r])
        np.testing.assert_array_equal(plain.numpy(), want_out[r])
        np.testing.assert_array_equal(err.numpy(), want_err[r])


def test_quantized_all_gather_matches_jax(run):
    inputs, ranks, _ = run
    fn = shard_mapped(lambda x: jcc.quantized_all_gather(x[0], "dp")[None], 1)
    want = np.asarray(fn(jnp.asarray(inputs["shard"])))
    for r, rank in enumerate(ranks):
        np.testing.assert_array_equal(rank["collectives"]["all_gather"].numpy(), want[r])


def test_reduce_scatter_coalesced_matches_jax(run):
    inputs, ranks, _ = run
    fn = jax.shard_map(
        lambda *ts: tuple(x[None] for x in jcc.reduce_scatter_coalesced(
            [t[0] for t in ts], "dp")),
        mesh=jax.sharding.Mesh(np.array(jax.devices()[:WORLD]), ("dp",)),
        in_specs=tuple(P("dp") for _ in inputs["coalesced"]),
        out_specs=tuple(P("dp") for _ in inputs["coalesced"]),
        axis_names={"dp"}, check_vma=False)
    want = [np.asarray(x) for x in fn(*[jnp.asarray(t) for t in inputs["coalesced"]])]
    for r, rank in enumerate(ranks):
        for got, w in zip(rank["collectives"]["reduce_scatter"], want):
            np.testing.assert_array_equal(got.numpy(), w[r])


@pytest.mark.parametrize("hierarchy", ["dp", "hpz"])
def test_reduce_leaf_matches_jax(run, hierarchy):
    """``QgzPlan._reduce_leaf`` on a stacked [L, in, out] leaf, over dp=4
    (int4) and over dpr=2 x dp=2 (int4 within dp, int8 across dpr), with and
    without the error-feedback residual."""
    inputs, ranks, _ = run
    kw = HPZ if hierarchy == "hpz" else {}
    topo = jax_mesh(**kw)
    leaf = jnp.asarray(inputs["stacked"][0])
    plan = JaxQgzPlan(topo, JaxPartitioner(topo, JaxZeroConfig({"stage": 2})), {"w": leaf})
    d, axes = plan._zero_dim(plan.grad_specs["w"], plan.base_specs["w"])
    spec = P(plan.axes)

    def body(x):
        out, err = plan._reduce_leaf(x[0], d, axes, want_error=True)
        return out[None], err[None]

    # eager, on a mesh of the manual axes alone: under jit XLA fuses the
    # jnp twin's products into its sum (FMA), which the port's kernels and
    # plain versions never do
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:WORLD]).reshape(
        [plan.sizes[a] for a in plan.axes]), plan.axes)
    fn = jax.shard_map(body, mesh=mesh, in_specs=spec, out_specs=(spec, spec),
                       axis_names=set(plan.axes), check_vma=False)
    want, want_err = (np.asarray(x) for x in fn(jnp.asarray(inputs["stacked"])))
    for r, rank in enumerate(ranks):
        got_d, got_axes, got, (got_e, err) = rank["collectives"][f"reduce_leaf_{hierarchy}"]
        assert (got_d, tuple(got_axes)) == (d, tuple(axes))
        # the chunk is the same with and without the residual
        np.testing.assert_array_equal(got.numpy(), want[r])
        np.testing.assert_array_equal(got_e.numpy(), want[r])
        np.testing.assert_array_equal(err.numpy(), want_err[r])


# ---------------------------------------------------------------------------
# qgZ engines (mirrors tests/test_qgz.py)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case,stage,mesh_kw", [
    ("qgz", 2, {}),
    ("qgz_hpz", 3, HPZ),
])
def test_qgz_engine_tracks_exact_and_jax(run, case, stage, mesh_kw):
    """GAS 2, 6 steps: the port's qgZ losses against its own exact stage-2
    run and against the JAX qgZ engine (the hierarchy: dpr=2 x dp=2, with
    stage-3 working shards over dp only)."""
    _, ranks, want = run
    assert LLAMA_CASES[case]["zero_optimization"]["stage"] == stage
    hpz = LLAMA_CASES[case]["zero_optimization"].get("zero_hpz_partition_size", 1)
    assert (hpz == mesh_kw.get("zero_shard_size", 1))
    jax_losses = want[case][0]
    exact = ranks[0]["stage2"]["losses"]
    for rank in ranks:
        got = rank[case]["losses"]
        assert got == ranks[0][case]["losses"]
        assert got[-1] < got[0]
        np.testing.assert_allclose(got, exact, rtol=0.15)
        np.testing.assert_allclose(got, jax_losses, rtol=0.15)
    if case == "qgz_hpz":
        for name, (numel, shard, resident, master) in ranks[0][case]["at_rest"].items():
            assert shard == numel // 2 and master == numel // WORLD, name


def test_qgz_with_fp16_loss_scaling(run):
    """fp16 dynamic loss scaling under qgZ: finite, falling, no step skipped."""
    _, ranks, _ = run
    res = ranks[0]["qgz_fp16"]
    assert np.isfinite(res["losses"]).all()
    assert res["losses"][-1] < res["losses"][0]
    assert res["skipped"] == 0


def test_qgz_error_feedback_keeps_residual_on_overflow(run):
    """The first step overflows fp16 on every rank: it is skipped together,
    the residual stays the previous (zero) carry; later steps carry a
    non-zero residual, and training goes on."""
    _, ranks, _ = run
    for rank in ranks:
        res = rank["qgz_feedback"]
        assert res["skipped"] >= 1 and res["skipped"] < STEPS
        first_good = res["skipped"]
        assert res["residual_norms"][:first_good] == [0.0] * first_good
        assert all(n > 0 for n in res["residual_norms"][first_good:])
        assert res["skipped"] == ranks[0]["qgz_feedback"]["skipped"]


def test_qgz_requires_stage2_and_a_world():
    model = LlamaForCausalLM(LlamaConfig.tiny(dtype=torch.float32))
    with pytest.raises(ValueError, match="stage >= 2"):
        deepspeed_tpu_torch.initialize(model=model, config=dict(
            llama_config(train_batch_size=GAS * MICRO), **zero(1, **QGZ)), device="cpu")
    with pytest.raises(ValueError, match="world > 1"):
        deepspeed_tpu_torch.initialize(model=model, config=dict(
            llama_config(train_batch_size=GAS * MICRO), **zero(2, **QGZ)), device="cpu")
