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
  differ;
- MoE (Mixtral, fp32), with and without expert parallelism: engines as the
  ZeRO stages above (losses 1e-5, masters 2e-5, clipping norm 1e-4). The
  gate's global sums are taken over ranks in rank order where the JAX gate
  reduces the global matrix: summation order again. Single ``MOELayer``
  runs on ``ep`` 2 x ``dp`` 2 and ``ep`` 4 against the JAX layer on one
  host, as ``tests/test_torch_moe.py`` holds the one-rank layer: outputs
  and gradients to 1e-5 of each tensor's largest element, the aux loss to
  1e-5, counts exactly; the int8 wire to the 0.05 of ``tests/test_moe.py``.
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
from deepspeed_tpu.models.mixtral import MixtralConfig as JaxMixtralConfig
from deepspeed_tpu.models.mixtral import MixtralExpertMLP as JaxExpert
from deepspeed_tpu.models.mixtral import MixtralForCausalLM as JaxMixtral
from deepspeed_tpu.moe import sharded_moe as jmoe
from deepspeed_tpu.parallel import groups as jgroups
from deepspeed_tpu.parallel.topology import MeshTopology as JaxMesh
from deepspeed_tpu.runtime.comm import coalesced_collectives as jcc
from deepspeed_tpu.runtime.zero.config import DeepSpeedZeroConfig as JaxZeroConfig
from deepspeed_tpu.runtime.zero.partition import ZeroPartitioner as JaxPartitioner
from deepspeed_tpu.runtime.zero.qgz import QgzPlan as JaxQgzPlan
from deepspeed_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM, params_from_flax
from deepspeed_tpu_torch.models.mixtral import params_from_flax as mixtral_params

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

# Mixtral engines. TINY with a drop-heavy capacity at dp 4 (no expert
# parallelism) holds the gate's global routing; SMALL (128-multiples, as
# megablox needs) runs every ZeRO stage on ep 2 x dp 2 and on ep 4, each
# dispatch mode on both meshes, top-1 and top-2. AdamW's eps is 1e-6 here:
# with 1e-8, Adam turns the fp32 summation noise of the many near-zero
# expert gradients into master differences above 2e-5 even between the JAX
# engine's own runs on a 1-device and on the 4-device ep mesh, so the
# masters could not be held to 2e-5 against any implementation.
MOE_ADAMW = {"type": "AdamW", "params": {"lr": 3e-3, "weight_decay": 0.01, "eps": 1e-6}}
MOE_T = 16
TINY = dict(vocab_size=512, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
            num_attention_heads=4, num_key_value_heads=2, num_local_experts=4,
            max_position_embeddings=128)
SMALL = dict(TINY, hidden_size=128, intermediate_size=256)


# checkpoint resume at W = 4: (family, the uninterrupted case it must equal)
RESUME_CASES = {"stage1": ("llama", "stage1"), "stage2": ("llama", "stage2"),
                "stage3": ("llama", "stage3"), "qgz_feedback": ("llama", "qgz_feedback"),
                "ep2_dp2": ("moe", "ep2_stage2_indices_k2")}


def moe_case(ep, stage, backend, k, params="small", capacity_factor=1.0):
    widths = SMALL if params == "small" else TINY
    return dict(ep=ep, params=params,
                model=dict(widths, moe_backend=backend, num_experts_per_tok=k,
                           capacity_factor=capacity_factor),
                config=dict(llama_config(**zero(stage)), optimizer=MOE_ADAMW,
                            expert_parallel_size=ep))


MOE_CASES = {
    "routing_dp4": moe_case(1, 0, "indices", 2, params="tiny", capacity_factor=0.5),
    "ep2_stage0_einsum_k1": moe_case(2, 0, "einsum", 1),
    "ep2_stage1_gmm_k2": moe_case(2, 1, "gmm", 2),
    "ep2_stage2_indices_k2": moe_case(2, 2, "indices", 2),
    "ep2_stage3_gmm_k1": moe_case(2, 3, "gmm", 1),
    "ep4_stage0_gmm_k2": moe_case(4, 0, "gmm", 2),
    "ep4_stage1_indices_k1": moe_case(4, 1, "indices", 1),
    "ep4_stage2_gmm_k2": moe_case(4, 2, "gmm", 2),
    "ep4_stage3_einsum_k2": moe_case(4, 3, "einsum", 2),
}
EP_CASES = [c for c in MOE_CASES if c.startswith("ep")]

# single MOELayer cases (k, capacity_factor, drop_tokens, dispatch mode) on
# the 4 ranks' 64 tokens, D = 128, F = 256, E = 4
LAYER_DIMS = (128, 256, 4)
LAYER_CASES = {
    "einsum_top1_dense": (1, 100.0, True, "einsum"),
    "einsum_top2_drops": (2, 0.5, True, "einsum"),
    "indices_top2_drops": (2, 0.5, True, "indices"),
    "gmm_top2_dropless": (2, 1.0, False, "gmm"),
    "gmm_top1_drops": (1, 1.0, True, "gmm"),
}


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


def moe_batches(seed=2):
    """GAS global micro-batches of MOE_T tokens, repeated every step."""
    rng = np.random.default_rng(seed)
    window = []
    for _ in range(GAS):
        ids = rng.integers(0, 512, (MICRO * WORLD, MOE_T)).astype(np.int32)
        window.append({"input_ids": ids, "labels": ids})
    return window * STEPS


def jax_mixtral_config(case):
    return JaxMixtralConfig(**case["model"], dtype=jnp.float32, remat=False)


def jax_mixtral_params(widths):
    """The JAX model's init with each router sharpened x10: top-k choices
    far from ties, which a last-bit difference upstream could flip."""
    model = JaxMixtral(JaxMixtralConfig(**widths, dtype=jnp.float32))
    ids = jnp.asarray(moe_batches()[0]["input_ids"][:MICRO])
    params = jax.tree.map(np.asarray, jax.jit(model.init)(jax.random.PRNGKey(0), ids)["params"])
    for name, layer in params.items():
        if name.startswith("layers_"):
            moe = layer["block_sparse_moe"]["gate"]
            moe["wg"] = moe["wg"] * 10.0
    return params


def jax_layer_expert():
    D, F, _ = LAYER_DIMS
    return JaxExpert(JaxMixtralConfig(hidden_size=D, intermediate_size=F, dtype=jnp.float32))


def layer_inputs():
    rng = np.random.default_rng(11)
    D = LAYER_DIMS[0]
    return tuple(rng.standard_normal((4, 16, D)).astype(np.float32) for _ in range(2))


def jax_layer_run(name):
    """The JAX MOELayer on one host over the global tokens: params (router
    sharpened x10, away from ties), output, aux loss, counts and the
    gradients of ``sum(out * dout) + 0.1 * l_aux``."""
    k, cf, drop, mode = LAYER_CASES[name]
    E = LAYER_DIMS[2]
    layer = jmoe.MOELayer(jax_layer_expert, E, k, cf, cf, min_capacity=2,
                          drop_tokens=drop, dispatch_mode=mode)
    x, dout = (jnp.asarray(a) for a in layer_inputs())
    params = jax.tree.map(np.asarray, layer.init(jax.random.PRNGKey(len(name)), x)["params"])
    params["gate"]["wg"] = params["gate"]["wg"] * 10.0

    def loss(p, xx):
        out, l_aux, counts = layer.apply({"params": p}, xx)
        return jnp.sum(out * dout) + 0.1 * l_aux, (out, l_aux, counts)

    (_, (out, l_aux, counts)), (gp, gx) = jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True)(params, x)
    ex, gex = params["experts"]["MixtralExpertMLP_0"], gp["experts"]["MixtralExpertMLP_0"]
    flat = {"wg": params["gate"]["wg"], **{w: ex[w]["kernel"] for w in ("w1", "w2", "w3")}}
    grads = {"wg": gp["gate"]["wg"], "dx": gx,
             **{w: gex[w]["kernel"] for w in ("w1", "w2", "w3")}}
    return ({n: np.asarray(v, np.float32) for n, v in flat.items()},
            dict(out=np.asarray(out), l_aux=float(l_aux), counts=np.asarray(counts),
                 **{n: np.asarray(v) for n, v in grads.items()}))


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
    for name, case in MOE_CASES.items():
        ep = case["ep"]
        want[name] = run_jax_engine(JaxMixtral(jax_mixtral_config(case)),
                                    inputs["moe_params"][case["params"]], case["config"],
                                    inputs["moe_batches"],
                                    mesh=JaxMesh(dp=WORLD // ep, ep=ep,
                                                 devices=jax.devices()[:WORLD]))
    jgroups.reset()
    return want


def make_inputs():
    rng = np.random.default_rng(7)
    _, lp = jax_llama()
    _, mp = jax_masked()
    layer_refs = {name: jax_layer_run(name) for name in LAYER_CASES}
    return {
        "moe_cases": MOE_CASES,
        "moe_params": {"tiny": jax_mixtral_params(TINY), "small": jax_mixtral_params(SMALL)},
        "moe_batches": moe_batches(),
        "layer_dims": LAYER_DIMS,
        "layer_inputs": layer_inputs(),
        "layer_cases": LAYER_CASES,
        "layer_params": {n: ref[0] for n, ref in layer_refs.items()},
        "layer_want": {n: ref[1] for n, ref in layer_refs.items()},
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
        "resume_cases": RESUME_CASES,
    }


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """Inputs, the results of every port-side scenario per rank, and the
    JAX engine's runs (``jax_engine_runs``)."""
    d = tmp_path_factory.mktemp("torch_zero")
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


@pytest.mark.parametrize("zero_cfg,ep_cfg,want", [
    ({"zero_hpz_partition_size": 2}, 1, dict(ep=2, zero_shard_size=2, zero_hierarchy="hpz")),
    ({"mics_shard_size": 2}, 1, dict(ep=2, zero_shard_size=2, zero_hierarchy="mics")),
    ({}, 4, dict(ep=4, zero_shard_size=None, zero_hierarchy=None)),
], ids=["hpz", "mics", "config_ep_wins"])
def test_groups_initialize_ep_size_builds_one_topology(monkeypatch, zero_cfg, ep_cfg, want):
    """``groups.initialize(ep_size=2, config=...)`` builds one topology with
    the ep axis where the config names none, keeping the config's hpZ or
    MiCS shard group (a config's own ``expert_parallel_size`` wins)."""
    from deepspeed_tpu_torch.parallel import groups, topology
    from deepspeed_tpu_torch.runtime.config import DeepSpeedConfig
    built = []
    monkeypatch.setattr(topology, "MeshTopology", lambda **kw: built.append(kw) or kw)
    config = DeepSpeedConfig({"train_batch_size": 8, "expert_parallel_size": ep_cfg,
                              "zero_optimization": dict({"stage": 3}, **zero_cfg)})
    try:
        groups.initialize(ep_size=2, config=config)
    finally:
        groups.reset()
    assert len(built) == 1
    assert {k: built[0][k] for k in want} == want


def test_unported_axes_raise():
    """pp and sp raise at the topology. The tp axis serves inference
    (``tests/test_torch_tensor_parallel.py``); training over it raises in the
    training config here, and in the training engine given a tp mesh (the
    gloo ranks of that test), naming A12."""
    from deepspeed_tpu_torch.parallel.topology import MeshTopology
    from deepspeed_tpu_torch.runtime.config import DeepSpeedConfig
    for kw, item in ((dict(pp=2), "A12"), (dict(sp=2), "A12")):
        with pytest.raises(NotImplementedError, match=item):
            MeshTopology(devices=[0, 1], **kw)
    with pytest.raises(NotImplementedError, match="A12"):
        DeepSpeedConfig({"train_batch_size": 2,
                         "tensor_parallel": {"tp_size": 2}}).check_supported()


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


# ---------------------------------------------------------------------------
# MoE: global routing under data parallelism, expert parallelism
# (mirrors tests/test_moe.py :90, :138, :471, :493, :521)
# ---------------------------------------------------------------------------

def check_moe_engine(run, case):
    _, ranks, want = run
    want_losses, want_master, want_norm = want[case]
    want_master = {k: v.numpy() for k, v in mixtral_params(want_master).items()}
    for rank in ranks:
        res = rank[case]
        np.testing.assert_allclose(res["losses"], want_losses, rtol=1e-5)
        assert set(res["master"]) == set(want_master)
        for name, got in port_master(res).items():
            np.testing.assert_allclose(got, want_master[name], rtol=0, atol=2e-5,
                                       err_msg=name)
        assert res["grad_norm"] == pytest.approx(want_norm, rel=1e-4)
    assert want_losses[-1] < want_losses[0]


def test_moe_global_routing_matches_jax_engine(run):
    """Mixtral-tiny at dp 4 (no expert parallelism), stage 0, capacity factor
    0.5: each rank routes its 2 x 16 tokens, and the capacity, the queue
    positions (first choices of every rank before any second choice) and the
    aux loss must be those of the JAX gate over the global 8 x 16 tokens.
    Gating each rank's tokens alone drops other choices and changes the aux
    loss's value and gradient, which moves the losses far past 1e-5."""
    check_moe_engine(run, "routing_dp4")


@pytest.mark.parametrize("case", EP_CASES)
def test_expert_parallel_engine_matches_jax(run, case):
    """6 steps of Mixtral (E 4) with expert_parallel_size 2 (x dp 2) or 4
    against the JAX engine on the same 4-device mesh: losses, whole masters
    (expert slices gathered over ep) and the clipping norm. Each rank's
    expert leaves hold E / ep experts; from stage 1 their masters are cut
    over the expert-data group (dp 2, or nothing at ep 4) along a dimension
    other than the expert axis, dense leaves over all 4 ranks."""
    check_moe_engine(run, case)
    _, ranks, _ = run
    ep, stage = MOE_CASES[case]["ep"], MOE_CASES[case]["config"]["zero_optimization"]["stage"]
    E = SMALL["num_local_experts"]
    for rank in ranks:
        res = rank[case]
        for name, shape in res["local_shapes"].items():
            numel, shard, resident, master = res["at_rest"][name]
            if ".experts." in name:
                assert shape[0] == E // ep and numel == int(np.prod(shape)), name
                want = numel // (WORLD // ep) if stage >= 1 else numel
            else:
                want = numel // WORLD if stage >= 1 and max(shape) % WORLD == 0 else numel
            assert master == want, (name, master, want)


def gathered_layer(ranks, ep, name):
    """Outputs and dx concatenated in rank order, the router gradient summed
    over ranks, each expert slice's gradient summed over the ranks holding
    it and the slices concatenated in ep order."""
    res = [r["moe_layers"][(ep, name)] for r in ranks]
    got = {n: torch.cat([r[n] for r in res]).numpy() for n in ("out", "dx")}
    got["wg"] = sum(r["wg"] for r in res).numpy()
    for w in ("w1", "w2", "w3"):
        got[w] = torch.cat([sum(r[w] for r in res if r["ep_rank"] == i)
                            for i in range(ep)]).numpy()
    return res, got


def close_to(got, want, rel=1e-5):
    scale = max(float(np.abs(want).max()), 1e-6)
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * scale)


@pytest.mark.parametrize("ep", [2, 4])
@pytest.mark.parametrize("name", list(LAYER_CASES))
def test_expert_parallel_layer_matches_jax(run, name, ep):
    """One MOELayer split over ep ranks, each holding 16 of the 64 tokens,
    against the JAX layer on one host: output, aux loss, counts and the
    gradients of x, the router and every expert weight."""
    inputs, ranks, _ = run
    want = inputs["layer_want"][name]
    D = LAYER_DIMS[0]
    res, got = gathered_layer(ranks, ep, name)
    close_to(got["out"], want["out"].reshape(-1, D))
    close_to(got["dx"], want["dx"].reshape(-1, D))
    for n in ("wg", "w1", "w2", "w3"):
        close_to(got[n], want[n])
    for r in res:
        np.testing.assert_allclose(r["l_aux"], want["l_aux"], rtol=1e-5)
        np.testing.assert_array_equal(r["counts"].numpy(), want["counts"])
    if name == "einsum_top1_dense":
        # nothing drops: each token's output is its expert's FFN scaled by
        # the gate (test_moe.py :138)
        p = inputs["layer_params"][name]
        x = inputs["layer_inputs"][0].reshape(-1, D)
        probs = torch.softmax(torch.from_numpy(x @ p["wg"]), -1).numpy()
        e = probs.argmax(-1)
        h = np.einsum("sd,sdf->sf", x, p["w1"][e])
        ffn = np.einsum("sf,sfd->sd", h / (1 + np.exp(-h)) * np.einsum(
            "sd,sdf->sf", x, p["w3"][e]), p["w2"][e])
        close_to(got["out"], ffn * probs[np.arange(len(e)), e][:, None])


@pytest.mark.parametrize("ep", [2, 4])
def test_groups_initialize_ep_size_on_ranks(run, ep):
    """``groups.initialize(ep_size=ep, config=...)`` on the 4 ranks, the
    config naming no ep axis: ep x (4 / ep) dp, rank r at ep coordinate
    r % ep, and expert / expert-data groups of those sizes."""
    _, ranks, _ = run
    for r, rank in enumerate(ranks):
        assert rank["moe_layers"][(ep, "topology")] == (ep, WORLD // ep, r % ep, ep,
                                                        WORLD // ep)


@pytest.mark.parametrize("ep", [2, 4])
def test_expert_parallel_quantized_wire(run, ep):
    """a2a_wire_bits 8 (gmm, dropless): the output stays within 0.05 of the
    full-precision wire's, and the dispatch and combine exchanges record
    their int8 + scale bytes against the fp32 payload they stand for; the
    fp32 wire records both equal."""
    _, ranks, _ = run
    for rank in ranks:
        w = rank["moe_layers"][(ep, "wire")]
        np.testing.assert_allclose(w[8].numpy(), w[None].numpy(), atol=0.05, rtol=0.05)
        assert float((w[8] - w[None]).abs().max()) > 0
        for op in ("a2a_dispatch", "a2a_combine"):
            assert w["wire_None"][op]["wire"] == w["wire_None"][op]["logical"] > 0
            q = w["wire_8"][op]
            assert 0.25 < q["wire"] / q["logical"] < 0.26, q


def test_qgz_refuses_expert_parallelism(run):
    """zero_quantized_gradients with an ep axis > 1 raises the JAX package's
    ValueError (qgZ exchanges over dp / dpr only)."""
    _, ranks, _ = run
    for rank in ranks:
        assert "currently supports dp/dpr ZeRO axes only (got ep size 2" in \
            rank["qgz_ep_error"]


# ---------------------------------------------------------------------------
# checkpoint save/load of sharded state at W = 4
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", list(RESUME_CASES))
def test_resume_from_checkpoint_equals_uninterrupted_run(run, name):
    """A run saved after 3 of its 6 optimizer steps and resumed by a fresh
    engine (other initial weights) on every rank gives the uninterrupted
    run's losses and whole masters exactly: each rank restored its own
    shards (ZeRO-1/2/3 chunks, the qgZ residual after an overflow-skipped
    step, its ``ep`` rank's expert slices)."""
    _, ranks, _ = run
    case = RESUME_CASES[name][1]
    for rank in ranks:
        got, want = rank["resume"][name], rank[case]
        assert got["loaded"] == got["saved"] and got["steps"] == STEPS
        assert got["losses"] == want["losses"]
        assert got["master"].keys() == want["master"].keys()
        for k, v in want["master"].items():
            assert torch.equal(got["master"][k], v), k
