"""The port's optimizers (``ops/adam.py``, ``ops/onebit.py``) and the 1-bit
wire verb (``runtime/comm/compressed.py``) against the JAX package's, on
the CPU.

Every name the JAX ``build_optimizer`` takes runs 10 steps on the tiny
Llama's parameters with the same gradients (random, per step) and learning
rates: optax on the JAX tree (layers stacked ``[L, ...]``, kernels ``[in,
out]``), the port's optimizer inside an engine, whose masters are one
tensor per layer and ``nn.Linear`` weights ``[out, in]``. The leaf-wide
arithmetic (LAMB's trust ratios over a stacked leaf, Muon's 2-D rule: the
stacked norms ``[L, D]`` orthogonalised, the stacked kernels ``[L, in,
out]`` on its Adam branch; the 1-bit scales) must read the JAX leaf. At
ZeRO stages 1-3 on 4 gloo ranks (``tests/test_torch_optimizers_worker.py``)
the masters are shards and the same runs must give the same masters.

Tolerances: the optax optimizers agree to rtol 1e-5 (atol 1e-6 for
elements near 0): fp32 arithmetic in another order. The 1-bit family to
rtol 1e-4, atol 2e-5: 0/1 Adam's undamped first steps (``m / sqrt(v)``
without bias correction is about 32 ``sign(g)``) carry JAX's own fp32
rounding, 6.6e-6 relative at step 1 against a float64 evaluation where the
port's reads 2.5e-7, into every later step.

``compressed_allreduce`` on 4 gloo ranks against the JAX collective under
``shard_map`` on 4 CPU devices with the same inputs and error buffers,
over 30 steps: the sign bits equal, the values to rtol 1e-6 (the error
buffers, differences of values about 1 carried over the steps, to 1e-5
absolute); and the ``tests/test_onebit.py`` properties of the accumulated
mean.
"""

import os
import subprocess
import sys
import time

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from deepspeed_tpu.models.llama import LlamaConfig as JaxLlamaConfig
from deepspeed_tpu.models.llama import LlamaForCausalLM as JaxLlama
from deepspeed_tpu.ops import onebit as jax_onebit
from deepspeed_tpu.ops.adam import build_optimizer as jax_build
from deepspeed_tpu.ops.adam import set_lr as jax_set_lr
from deepspeed_tpu.runtime.comm import compressed as jax_compressed
import deepspeed_tpu_torch
from deepspeed_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM, params_from_flax
from deepspeed_tpu_torch.ops import onebit
from deepspeed_tpu_torch.ops.adam import build_optimizer, set_lr
from deepspeed_tpu_torch.runtime.comm import compressed

WORLD, STEPS = 4, 10
WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "test_torch_optimizers_worker.py")
RUN_TIMEOUT_S = 120

OPTAX = [("Lamb", {"lr": 1e-2, "weight_decay": 0.01}),
         ("Lion", {"lr": 1e-3, "weight_decay": 0.1}),
         ("SGD", {"lr": 1e-2, "momentum": 0.9, "nesterov": True, "weight_decay": 0.01}),
         ("SGD", {"lr": 1e-2}),
         ("Adagrad", {"lr": 1e-2, "weight_decay": 0.01}),
         ("Muon", {"lr": 1e-2}),
         ("Adam", {"lr": 1e-2, "adam_w_mode": False, "weight_decay": 0.01}),
         ("AdamW", {"lr": 1e-2, "weight_decay": 0.01})]
ONEBIT = [("OneBitAdam", {"lr": 1e-2, "freeze_step": 3, "weight_decay": 0.01}),
          ("ZeroOneAdam", {"lr": 1e-2, "var_freeze_step": 5, "var_update_scaler": 2}),
          ("OneBitLamb", {"lr": 1e-2, "freeze_step": 3, "weight_decay": 0.01})]
ZERO_CASES = [(name, params, stage) for name, params in (OPTAX[0], OPTAX[5], ONEBIT[2])
              for stage in (1, 2, 3)]
TOLS = {"optax": dict(rtol=1e-5, atol=1e-6), "onebit": dict(rtol=1e-4, atol=2e-5)}
CAR_N, CAR_STEPS = 1000, 30


def jax_params():
    model = JaxLlama(JaxLlamaConfig.tiny(dtype=jnp.float32, remat=False))
    ids = jnp.zeros((1, 8), jnp.int32)
    return jax.tree.map(np.asarray, model.init(jax.random.PRNGKey(0), ids)["params"])


def gradient_trees(params, seed=0):
    rng = np.random.default_rng(seed)
    return [jax.tree.map(lambda p: (0.1 * rng.standard_normal(p.shape)).astype(np.float32),
                         params) for _ in range(STEPS)]


LRS = [1.0, 0.5, 2.0, 1.0, 0.8, 1.2, 1.0, 0.7, 1.5, 1.0]


def jax_run(name, params, tree, grads):
    tx, _ = jax_build(name, params)
    p = jax.tree.map(jnp.asarray, tree)
    state = tx.init(p)

    @jax.jit
    def step(p, state, g, lr):
        updates, state = tx.update(g, jax_set_lr(state, lr), p)
        return optax.apply_updates(p, updates), state

    for g, scale in zip(grads, LRS):
        p, state = step(p, state, jax.tree.map(jnp.asarray, g),
                        jnp.float32(params["lr"] * scale))
    return params_from_flax(jax.tree.map(np.asarray, p))


def port_run(name, params, tree, grads):
    config = {"train_batch_size": 1, "optimizer": {"type": name, "params": params}}
    model = LlamaForCausalLM(LlamaConfig.tiny(dtype=torch.float32), device="cpu")
    engine, *_ = deepspeed_tpu_torch.initialize(model=model,
                                                model_parameters=params_from_flax(tree),
                                                config=config, device="cpu")
    for g, scale in zip(grads, LRS):
        sd = params_from_flax(g)
        for leaf in engine._leaves:
            leaf.master.grad = sd[leaf.name]
        set_lr(engine.optimizer, params["lr"] * scale)
        engine.optimizer.step()
    return engine


def assert_masters(got, want, tol):
    assert set(got) == set(want)
    for n, w in want.items():
        np.testing.assert_allclose(got[n].numpy(), w.numpy(), err_msg=n, **tol)


@pytest.fixture(scope="module")
def setup():
    tree = jax_params()
    return tree, gradient_trees(tree)


@pytest.mark.parametrize("name,params", OPTAX + ONEBIT,
                         ids=[f"{n}{i}" for i, (n, _) in enumerate(OPTAX + ONEBIT)])
def test_ten_steps_match_jax_on_the_stacked_tiny_llama(setup, name, params):
    tree, grads = setup
    engine = port_run(name, params, tree, grads)
    tol = TOLS["onebit" if (name, params) in ONEBIT else "optax"]
    assert_masters(engine.get_model_parameters(), jax_run(name, params, tree, grads), tol)


def test_jax_leaves_of_the_stacked_llama(setup):
    """The engine's leaves form the JAX tree's: one per stacked parameter,
    2-D for the stacked norms and the embeddings (Muon's matrices), 3-D for
    the stacked kernels."""
    tree, grads = setup
    engine = port_run("Muon", {"lr": 1e-2}, tree, grads[:1])
    shapes = {leaf.members[0].name: leaf.jax_shape for leaf in engine.jax_leaves}
    assert len(engine.jax_leaves) == len(jax.tree.leaves(tree))
    assert shapes["layers.0.input_layernorm.weight"] == (2, 64)
    assert shapes["layers.0.mlp.gate_proj.weight"] == (2, 64, 128)
    assert shapes["embed_tokens.weight"] == (512, 64)
    assert all(len(leaf.members) == 2 for leaf in engine.jax_leaves
               if leaf.members[0].name.startswith("layers."))


def test_unknown_optimizer_names_raise():
    with pytest.raises(ValueError, match="Unknown optimizer type 'Novograd'"):
        build_optimizer("Novograd", {}, [torch.zeros(2)])
    with pytest.raises(ValueError):
        jax_build("Novograd", {})


def test_build_optimizer_defaults_match_jax():
    """The defaults that differ from optax's and torch's: Lamb's eps 1e-8,
    Lion's betas (0.9, 0.99), Adagrad's accumulator from 0.1, SGD's trace at
    momentum 0.0."""
    p = [torch.zeros(3)]
    assert build_optimizer("lamb", {}, p)[0].defaults["eps"] == 1e-8
    assert build_optimizer("lion", {}, p)[0].defaults["betas"] == (0.9, 0.99)
    opt, lr = build_optimizer("adagrad", {}, p)
    assert opt.init_state(p[0])["sum_of_squares"].eq(0.1).all() and lr == 1e-3
    assert build_optimizer("sgd", {}, p)[0].defaults["momentum"] == 0.0
    assert build_optimizer("onebitlamb", {}, p)[0].defaults["freeze_step"] == 100


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, setup):
    """Every ZeRO case and the compressed allreduce on 4 gloo ranks."""
    tree, grads = setup
    d = tmp_path_factory.mktemp("torch_optimizers")
    rng = np.random.default_rng(0)
    car = [torch.from_numpy(rng.normal(size=(WORLD, CAR_N)).astype(np.float32))
           for _ in range(CAR_STEPS)]
    inputs = {"params": params_from_flax(tree), "grads": [params_from_flax(g) for g in grads],
              "lr_scales": LRS, "cases": ZERO_CASES, "car_n": CAR_N, "car_inputs": car}
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
        want = {(name, stage): jax_run(name, params, tree, grads)
                for name, params, stage in ZERO_CASES if stage == 1}
        jax_car = jax_compressed_runs(car)
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
            pytest.fail(f"rank {r} exited {p.returncode}:\n"
                        f"{(d / f'log{r}.txt').read_text()[-4000:]}")
    got = [torch.load(d / f"out{r}.pt", weights_only=False) for r in range(WORLD)]
    return got, want, jax_car, car


def jax_compressed_runs(car):
    mesh = Mesh(np.asarray(jax.devices()[:WORLD]), ("dp",))
    w_err, s_err = jax_compressed.init_error_buffers(CAR_N, WORLD)
    w_errs = jnp.zeros((WORLD,) + w_err.shape)
    s_errs = jnp.zeros((WORLD,) + s_err.shape)

    @jax.jit
    def run(xs, w_errs, s_errs):
        def f(x, we, se):
            out, we2, se2 = jax_compressed.compressed_allreduce(x[0], we[0], se[0],
                                                                axis_name="dp")
            return out[None], we2[None], se2[None]
        return jax.shard_map(f, mesh=mesh, in_specs=(P("dp"), P("dp"), P("dp")),
                             out_specs=(P("dp"), P("dp"), P("dp")), check_vma=False)(
            xs, w_errs, s_errs)

    out = []
    for xs in car:
        outs, w_errs, s_errs = run(jnp.asarray(xs.numpy()), w_errs, s_errs)
        out.append((np.asarray(outs), np.asarray(w_errs), np.asarray(s_errs)))
    return out


@pytest.mark.parametrize("name,params,stage", ZERO_CASES,
                         ids=[f"{n}-stage{s}" for n, _, s in ZERO_CASES])
def test_zero_stages_match_jax_on_four_ranks(ranks, name, params, stage):
    got, want, _, _ = ranks
    tol = TOLS["onebit" if (name, params) in ONEBIT else "optax"]
    for r in range(WORLD):
        masters, sharded = got[r]["optimizers"][(name, stage)]
        assert sharded > 0
        assert_masters(masters, want[(name, 1)], tol)


def test_compressed_allreduce_matches_mean_over_steps(ranks):
    """``tests/test_onebit.py``'s case on 4 gloo ranks, against the JAX
    collective step by step: sign bits exact, values to rtol 1e-6; and
    error feedback keeps the accumulated mean close to the exact one."""
    got, _, jax_car, car = ranks
    acc_exact = np.zeros(CAR_N)
    acc_comp = np.zeros(CAR_N)
    for step, (outs, w_errs, s_errs) in enumerate(jax_car):
        for r in range(WORLD):
            out, we, se = (t.numpy() for t in got[r]["compressed"][step])
            np.testing.assert_array_equal(out >= 0, outs[r] >= 0)
            np.testing.assert_allclose(out, outs[r], rtol=1e-6, atol=1e-7)
            # the residuals are differences of values about 1 accumulated
            # over the steps: a few ulps of those
            np.testing.assert_allclose(we, w_errs[r], rtol=1e-6, atol=1e-5)
            np.testing.assert_allclose(se, s_errs[r], rtol=1e-6, atol=1e-5)
        acc_exact += car[step].numpy().mean(axis=0)
        acc_comp += got[0]["compressed"][step][0].numpy()
    denom = np.linalg.norm(acc_exact)
    assert np.linalg.norm(acc_comp - acc_exact) / denom < 0.35


def test_compressed_allreduce_reference_and_packing():
    """The plain version the card holds the collective to is the
    collective's algorithm; packbits is ``jnp.packbits``' big-endian order."""
    rng = np.random.default_rng(4)
    bits = rng.integers(0, 2, 64).astype(bool)
    np.testing.assert_array_equal(compressed.packbits(torch.from_numpy(bits)).numpy(),
                                  np.asarray(jnp.packbits(jnp.asarray(bits))))
    np.testing.assert_array_equal(
        compressed.unpackbits(compressed.packbits(torch.from_numpy(bits))).numpy(), bits)
    xs = [torch.from_numpy(rng.normal(size=CAR_N).astype(np.float32)) for _ in range(WORLD)]
    w, s = compressed.error_shapes(CAR_N, WORLD)
    assert (w, s) == jax_compressed.error_shapes(CAR_N, WORLD)
    out, we, se = compressed.compressed_allreduce_reference(
        xs, [torch.zeros(w)] * WORLD, [torch.zeros(s)] * WORLD)
    jout = jax_compressed_runs([torch.stack(xs)])[0]
    np.testing.assert_allclose(out.numpy(), jout[0][0], rtol=1e-6, atol=1e-7)
    for r in range(WORLD):
        np.testing.assert_allclose(we[r].numpy(), jout[1][r], rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(se[r].numpy(), jout[2][r], rtol=1e-6, atol=1e-6)


def quadratic_losses(opt_factory, steps=300, dim=32, seed=0):
    target = torch.from_numpy(np.asarray(jax.random.normal(jax.random.PRNGKey(seed), (dim,))))
    w = torch.zeros(dim)
    opt = opt_factory([w])
    losses = []
    for _ in range(steps):
        loss = ((w - target) ** 2).sum()
        w.grad = 2 * (w - target)
        opt.step()
        losses.append(float(loss))
    return losses


@pytest.mark.parametrize("factory,final_tol", [
    (lambda p: onebit.OneBitAdam(p, lr=0.05, freeze_step=50), 1e-2),
    (lambda p: onebit.ZeroOneAdam(p, lr=0.05, var_freeze_step=50), 1e-2),
    (lambda p: onebit.OneBitLamb(p, lr=0.05, eps=1e-6, freeze_step=50), 0.5),
], ids=["onebit_adam", "zero_one_adam", "onebit_lamb"])
def test_onebit_converges_past_freeze(factory, final_tol):
    """``tests/test_onebit.py``: convergence well into the compression
    stage (the JAX factories' default eps for 1-bit LAMB, 1e-6)."""
    losses = quadratic_losses(factory)
    assert min(losses) < 2e-2 * losses[0]
    assert min(losses[60:]) < losses[60]
    assert losses[-1] < final_tol * losses[0]


def test_onebit_adam_warmup_matches_adam():
    """Before freeze_step the trajectory is exact Adam."""
    l_1bit = quadratic_losses(lambda p: onebit.OneBitAdam(p, lr=0.05, freeze_step=10 ** 6),
                              steps=50)
    l_adam = quadratic_losses(lambda p: build_optimizer("adam", {"lr": 0.05}, p)[0],
                              steps=50)
    np.testing.assert_allclose(l_1bit, l_adam, rtol=1e-4)


def test_engine_accepts_onebit_names():
    """``tests/test_onebit.py``: each name trains through the engine."""
    rng = np.random.default_rng(0)
    ids = rng.integers(0, 512, (8, 16)).astype(np.int64)
    batch = {"input_ids": ids, "labels": ids}
    for name in ("OneBitAdam", "ZeroOneAdam", "OneBitLamb"):
        model = LlamaForCausalLM.from_seed(LlamaConfig.tiny(dtype=torch.float32), seed=0,
                                           device="cpu")
        engine, *_ = deepspeed_tpu_torch.initialize(
            model=model, device="cpu",
            config={"train_batch_size": 8,
                    "optimizer": {"type": name, "params": {"lr": 1e-3, "freeze_step": 2}}})
        losses = []
        for _ in range(6):
            loss = engine(batch)
            engine.backward(loss)
            engine.step()
            losses.append(float(loss.detach()))
        assert losses[-1] < losses[0], (name, losses)


def test_onebit_factories_match_jax_transforms():
    """The 1-bit classes with the JAX transforms' own defaults (eps 1e-6 for
    1-bit LAMB) against them on one leaf."""
    rng = np.random.default_rng(7)
    p0 = rng.standard_normal((6, 5)).astype(np.float32)
    grads = [rng.standard_normal((6, 5)).astype(np.float32) for _ in range(8)]
    for jf, pf in ((lambda: jax_onebit.onebit_lamb(learning_rate=1e-2, freeze_step=3),
                    lambda p: onebit.OneBitLamb(p, lr=1e-2, eps=1e-6, freeze_step=3)),
                   (lambda: jax_onebit.onebit_adam(learning_rate=1e-2, freeze_step=3),
                    lambda p: onebit.OneBitAdam(p, lr=1e-2, freeze_step=3))):
        tx = jf()
        jp = jnp.asarray(p0)
        st = tx.init(jp)
        w = torch.from_numpy(p0.copy())
        opt = pf([w])
        for g in grads:
            up, st = tx.update(jnp.asarray(g), st, jp)
            jp = optax.apply_updates(jp, up)
            w.grad = torch.from_numpy(g)
            opt.step()
        np.testing.assert_allclose(w.numpy(), np.asarray(jp), **TOLS["onebit"])
