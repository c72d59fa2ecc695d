"""The rest of training in the port (client optimizers, ``zero.Init``, the
``dots`` and ``cpu_checkpointing`` policies through the engine,
``PrefetchLoader``, ``fused_step``, ``set_train_batch_size`` /
``gas_offset``, the tensor-fragment accessors, ``TiledLinear`` and qgZ
under MiCS) against the JAX package's, on the CPU.

Mirrors ``tests/test_sharded_init.py``, ``tests/test_engine.py``'s policy,
accessor, ``gas_offset``, prefetch and ``fused_step`` cases, the accessor
parts of ``tests/test_checkpoint_universal.py`` and the MiCS cases of
``tests/test_qgz.py`` / ``tests/test_zeropp.py``. Multi-rank cases run on 4
gloo ranks of ``tests/test_torch_training_rest_worker.py`` (the worker
pattern of ``tests/test_torch_zero.py``), the JAX engines here on 4 of the 8
virtual CPU devices meanwhile.

Tolerances:
- ``zero.Init`` against the whole-module path, and qgZ under MiCS against
  qgZ under hpZ (the same dpr x dp exchange, the masters cut otherwise):
  bit for bit;
- ``fused_step`` against the unfused path: JAX's ``test_fused_*`` bounds
  (losses rtol 1e-5, parameters rtol 1e-4 atol 1e-7, the norm 1e-4); the
  port accepts the key and has one path (its windows read nothing back to
  the host either way), so they are equal;
- the accessors after two AdamW steps at lr 1e-3 and one more micro-step,
  at stages 1-3 against stage 0 and against the JAX engine's (the JAX
  tree's layer 0, transposed): the sums over ranks run in another order,
  and Adam's second step turns that noise into up to ~1e-5 of a parameter
  (``tests/test_torch_zero.py`` reads 1.9e-5 over 6 steps at lr 3e-3), so
  the parameters agree to 2e-5 absolute and the moments and the gradient,
  taken at those parameters, to 1e-3 of each tensor's largest element; a
  set, and each local read against its slice of the full one, exactly;
- qgZ under MiCS against the JAX engine's qgZ under MiCS: ``tests/
  test_qgz.py``'s rtol 0.15 on the losses (int4 gradients, groups cut
  differently: the JAX leaf is ``[L, in, out]``);
- ``TiledLinear`` against the JAX module on the same tiles: 2e-6.
"""

import functools
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import deepspeed_tpu
from deepspeed_tpu.models.llama import LlamaConfig as JaxLlamaConfig
from deepspeed_tpu.models.llama import LlamaForCausalLM as JaxLlama
from deepspeed_tpu.parallel import groups as jgroups
from deepspeed_tpu.parallel.topology import MeshTopology as JaxMesh
from deepspeed_tpu.runtime.zero.tiling import TiledLinear as JaxTiledLinear
from deepspeed_tpu.runtime.zero.tiling import TiledLinearReturnBias as JaxTiledReturnBias
from deepspeed_tpu.utils import tensor_fragment as jax_tf
import deepspeed_tpu_torch
from deepspeed_tpu_torch.models.gpt2 import GPT2Config, GPT2LMHeadModel
from deepspeed_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM, params_from_flax
from deepspeed_tpu_torch.runtime.activation_checkpointing import checkpointing
from deepspeed_tpu_torch.runtime.dataloader import PrefetchLoader
from deepspeed_tpu_torch.runtime.zero import sharded_init
from deepspeed_tpu_torch.runtime.zero.tiling import TiledLinear, TiledLinearReturnBias
from deepspeed_tpu_torch.utils import tensor_fragment as tf

WORLD, T = 4, 16
WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "test_torch_training_rest_worker.py")
RUN_TIMEOUT_S = 150
FRAGMENT_LR = 1e-3


def near(a, b, what):
    """The accessors' tolerance (module docstring)."""
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    bound = 2e-5 if what == "param" else 1e-3 * float(np.abs(b).max())
    assert float(np.abs(a - b).max()) <= bound, (what, float(np.abs(a - b).max()), bound)


def token_batches(n, B, vocab=512, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        ids = rng.integers(0, vocab, (B, T)).astype(np.int64)
        out.append({"input_ids": ids, "labels": ids})
    return out


@functools.lru_cache(maxsize=1)
def jax_llama_params():
    model = JaxLlama(JaxLlamaConfig.tiny(dtype=jnp.float32, remat=False))
    return model, jax.tree.map(np.asarray, model.init(
        jax.random.PRNGKey(0), jnp.zeros((1, T), jnp.int32))["params"])


def llama_engine(config, params=None):
    model = LlamaForCausalLM(LlamaConfig.tiny(dtype=torch.float32), device="cpu")
    engine, *_ = deepspeed_tpu_torch.initialize(
        model=model, model_parameters=params_from_flax(params if params is not None
                                                       else jax_llama_params()[1]),
        config=config, device="cpu")
    return engine


def base_config(**kw):
    cfg = {"train_batch_size": 2, "optimizer": {"type": "AdamW", "params": {"lr": 1e-2}}}
    cfg.update(kw)
    return cfg


# ---------------------------------------------------------------------------
# item 6: client optimizers
# ---------------------------------------------------------------------------

def test_client_optimizer_instance_class_and_factory():
    """An Optimizer built over the module's parameters is rebound to the
    masters group by group with its hyperparameters; a class and a factory
    are called on the masters; the client owns its learning rate. Each
    trains as the config's SGD with the same law does."""
    batches = token_batches(2, 2)
    _, params = jax_llama_params()

    def run(optimizer, config):
        model = LlamaForCausalLM(LlamaConfig.tiny(dtype=torch.float32), device="cpu")
        if callable(optimizer) and getattr(optimizer, "__name__", "") == "instance":
            optimizer = optimizer(model)
        engine, opt, *_ = deepspeed_tpu_torch.initialize(
            model=model, model_parameters=params_from_flax(params), optimizer=optimizer,
            config=config, device="cpu")
        for b in batches:
            loss = engine(b)
            engine.backward(loss)
            engine.step()
        return engine, opt

    want, _ = run(None, base_config(optimizer={"type": "SGD", "params": {
        "lr": 0.05, "momentum": 0.9}}))

    def instance(model):
        head = [p for n, p in model.named_parameters() if n == "lm_head.weight"]
        rest = [p for n, p in model.named_parameters() if n != "lm_head.weight"]
        return torch.optim.SGD([{"params": rest}, {"params": head, "momentum": 0.9}],
                               lr=0.05, momentum=0.9)

    for client in (instance,
                   lambda ps: torch.optim.SGD(ps, lr=0.05, momentum=0.9)):
        engine, opt = run(client, base_config())
        assert engine.optimizer is opt and isinstance(opt, torch.optim.SGD)
        assert opt.param_groups[0]["lr"] == 0.05     # the client's, not the schedule's
        masters = {id(leaf.master) for leaf in engine._leaves}
        assert all(id(p) in masters for g in opt.param_groups for p in g["params"])
        got = engine.get_model_parameters()
        for n, w in want.get_model_parameters().items():
            np.testing.assert_allclose(got[n].numpy(), w.numpy(), rtol=1e-5, atol=1e-6)
    # a LeafOptimizer class is given the JAX leaves
    from deepspeed_tpu_torch.ops.adam import Lamb
    engine, opt = run(Lamb, base_config())
    assert isinstance(opt, Lamb) and len(opt._leaf_of) == len(engine._leaves)
    with pytest.raises(ValueError, match="client optimizer must be a torch.optim.Optimizer"):
        run(42, base_config())
    with pytest.raises(ValueError, match="client optimizer must be"):
        run(lambda ps: "not an optimizer", base_config())


# ---------------------------------------------------------------------------
# item 7: zero.Init at world 1
# ---------------------------------------------------------------------------

def test_abstract_params_allocate_nothing_and_init_builds_on_meta():
    with deepspeed_tpu_torch.zero.Init(config=base_config()):
        model = GPT2LMHeadModel(GPT2Config.large())
    assert sharded_init.is_meta(model)
    shapes = sharded_init.abstract_params(model)
    assert shapes["wte.weight"] == ((50257, 1280), torch.bfloat16)
    assert len(shapes) == 2 + 36 * 12 + 2
    with deepspeed_tpu_torch.zero.Init(enabled=False):
        assert not sharded_init.is_meta(torch.nn.Linear(2, 2))


@pytest.mark.parametrize("stage", [0, 3])
def test_engine_under_zero_init_equals_from_seed(stage):
    """Born from the config's seed, bit for bit the same model built whole
    from that seed: masters, working copies, and a step's losses."""
    cfg = GPT2Config.tiny(dtype=torch.float32)
    config = base_config(seed=7, zero_optimization={"stage": stage})
    with deepspeed_tpu_torch.zero.Init(config=config) as zinit:
        model = GPT2LMHeadModel(cfg)
    born = zinit.materialize(model, device="cpu")
    whole = GPT2LMHeadModel.from_seed(cfg, 7, device="cpu")
    for n, p in whole.named_parameters():
        assert torch.equal(born[n], p.float())
    e1, *_ = deepspeed_tpu_torch.initialize(model=model, config=config, device="cpu")
    e2, *_ = deepspeed_tpu_torch.initialize(model=whole, config=config, device="cpu")
    assert all(not p.is_meta for p in model.parameters())
    b = token_batches(1, 2)[0]
    for e in (e1, e2):
        loss = e(b)
        e.backward(loss)
        e.step()
    got, want = e1.get_model_parameters(), e2.get_model_parameters()
    assert all(torch.equal(got[n], want[n]) for n in want)


# ---------------------------------------------------------------------------
# item 8: the policies through the engine
# ---------------------------------------------------------------------------

@pytest.fixture
def reset_policy():
    yield
    checkpointing.reset()


def test_remat_policy_config_reaches_models(reset_policy):
    """``tests/test_engine.py``'s case: the configured policy is what the
    models run under, and the GPT-2 engine trains under "dots" (and the
    offloaded dots) exactly as under "nothing"."""
    cfg = GPT2Config.tiny(dtype=torch.float32)
    batches = token_batches(3, 8)
    runs = {}
    for policy, cpu in (("nothing", False), ("dots", False), ("dots", True)):
        config = base_config(train_batch_size=8, bf16={"enabled": True},
                             activation_checkpointing={"policy": policy,
                                                       "cpu_checkpointing": cpu})
        model = GPT2LMHeadModel.from_seed(cfg, 0, device="cpu")
        engine, *_ = deepspeed_tpu_torch.initialize(model=model, config=config, device="cpu")
        assert checkpointing._CONFIG["policy"] == policy
        assert checkpointing.current_policy() == ("nothing" if policy == "nothing" else "dots")
        losses = []
        for b in batches * 3:
            loss = engine(b)
            engine.backward(loss)
            engine.step()
            losses.append(float(loss.detach()))
        runs[(policy, cpu)] = losses
        assert losses[-1] < losses[0]
    assert runs[("dots", False)] == runs[("nothing", False)] == runs[("dots", True)]
    with pytest.raises(KeyError):
        deepspeed_tpu_torch.initialize(
            model=GPT2LMHeadModel.from_seed(cfg, 0, device="cpu"), device="cpu",
            config=base_config(activation_checkpointing={"policy": "selective"}))


# ---------------------------------------------------------------------------
# item 9: PrefetchLoader
# ---------------------------------------------------------------------------

def test_engine_prefetch_batches_config():
    """prefetch_batches wraps the training dataloader in PrefetchLoader and
    train_batch consumes its batches: the same losses as without it."""
    rng = np.random.default_rng(0)
    ids = rng.integers(0, 512, (32, T)).astype(np.int64)
    data = {"input_ids": ids, "labels": ids}
    out = []
    for prefetch in (2, 0):
        engine_data = deepspeed_tpu_torch.initialize(
            model=LlamaForCausalLM(LlamaConfig.tiny(dtype=torch.float32), device="cpu"),
            model_parameters=params_from_flax(jax_llama_params()[1]), training_data=data,
            config=base_config(train_batch_size=8, prefetch_batches=prefetch),
            device="cpu")[0]
        assert isinstance(engine_data.training_dataloader, PrefetchLoader) == bool(prefetch)
        out.append([float(engine_data.train_batch()) for _ in range(5)])
    assert np.isfinite(out[0]).all() and out[0] == out[1]


def test_prefetch_loader_bounds_and_errors():
    started = []

    def source():
        for i in range(6):
            started.append(i)
            yield {"x": np.full((2,), i)}

    class Loader:
        def __iter__(self):
            return source()

        def __len__(self):
            return 6

    loader = PrefetchLoader(Loader(), device="cpu", depth=2)
    assert len(loader) == 6
    it = iter(loader)
    first = next(it)
    assert isinstance(first["x"], torch.Tensor) and int(first["x"][0]) == 0
    time.sleep(0.3)
    assert len(started) <= 1 + 2 + 1          # the consumed one, depth ahead, one waiting
    assert [int(b["x"][0]) for b in it] == [1, 2, 3, 4, 5]
    assert [int(b["x"][0]) for b in loader] == list(range(6))   # a fresh pass

    class Broken:
        def __iter__(self):
            yield {"x": np.zeros(1)}
            raise RuntimeError("bad sample")

    with pytest.raises(RuntimeError, match="bad sample"):
        list(PrefetchLoader(Broken(), device="cpu"))


# ---------------------------------------------------------------------------
# item 10: fused_step, a JAX key the port accepts: train_batch has one path
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("gas", [1, 2])
def test_fused_step_matches_unfused(gas):
    """``tests/test_engine.py``'s ``test_fused_step_matches_two_phase`` and
    ``test_fused_gas_train_batch_matches_unfused``: an engine configured
    with ``fused_step`` trains as one without it."""
    batches = token_batches(8, 2, seed=3)

    def train(fused):
        engine = llama_engine(base_config(train_batch_size=2 * gas,
                                          gradient_accumulation_steps=gas,
                                          fused_step=fused, gradient_clipping=1.0))
        it = iter(batches)
        losses = [float(engine.train_batch(it)) for _ in range(8 // gas)]
        assert engine.global_steps == 8 // gas and engine.micro_steps == 8
        return losses, engine.get_model_parameters(), engine.get_global_grad_norm()

    l_fused, p_fused, n_fused = train(True)
    l_plain, p_plain, n_plain = train(False)
    np.testing.assert_allclose(l_fused, l_plain, rtol=1e-5, atol=1e-6)
    for n in p_plain:
        np.testing.assert_allclose(p_fused[n].numpy(), p_plain[n].numpy(), rtol=1e-4,
                                   atol=1e-7)
    assert n_fused == pytest.approx(n_plain, rel=1e-4)


def test_fused_step_fp16_overflow_still_skips():
    batches = token_batches(4, 2, seed=4)
    engine = llama_engine(base_config(train_batch_size=4, gradient_accumulation_steps=2,
                                      fused_step=True,
                                      fp16={"enabled": True, "initial_scale_power": 30,
                                            "hysteresis": 1}))
    it = iter(batches)
    before = engine.get_model_parameters()
    engine.train_batch(it)
    assert engine.skipped_steps == 1 and engine.cur_scale == 2.0 ** 29
    after = engine.get_model_parameters()
    assert all(torch.equal(before[n], after[n]) for n in before)


# ---------------------------------------------------------------------------
# item 11: set_train_batch_size and gas_offset
# ---------------------------------------------------------------------------

def test_engine_accessors_set_lr_mom_batch():
    """``tests/test_engine.py``'s accessor case."""
    engine = llama_engine(base_config(train_batch_size=None,
                                      train_micro_batch_size_per_gpu=2,
                                      gradient_accumulation_steps=1,
                                      optimizer={"type": "Adam", "params": {
                                          "lr": 1e-3, "betas": [0.8, 0.95]}}))
    batch = token_batches(1, 2)[0]
    assert engine.get_mom() == [[0.8, 0.95]]
    engine.set_lr(5e-4)
    loss = engine(batch); engine.backward(loss); engine.step()
    assert abs(engine.get_lr()[0] - 5e-4) < 1e-9
    engine.set_train_batch_size(4)       # micro 2 -> gas 2, at a boundary
    assert engine.gradient_accumulation_steps() == 2 and engine.train_batch_size() == 4
    with pytest.raises(ValueError):
        engine.set_train_batch_size(5)
    steps_before = engine.global_steps
    loss = engine(batch); engine.backward(loss); engine.step()
    assert engine.global_steps == steps_before          # mid-window: no apply
    with pytest.raises(RuntimeError, match="mid-accumulation"):
        engine.set_train_batch_size(8)
    loss = engine(batch); engine.backward(loss); engine.step()
    assert engine.global_steps == steps_before + 1      # window of 2 closed
    sgd = llama_engine(base_config(optimizer={"type": "SGD", "params": {"lr": 0.1}}))
    assert sgd.get_mom() == [0.0]


def test_gas_offset_survives_checkpoint(tmp_path):
    """``tests/test_engine.py``: a resized window stays aligned across a
    save and a load."""
    def build():
        return llama_engine(base_config(train_batch_size=None,
                                        train_micro_batch_size_per_gpu=1,
                                        gradient_accumulation_steps=1))
    batch = token_batches(1, 1)[0]
    eng = build()
    for _ in range(3):
        loss = eng(batch); eng.backward(loss); eng.step()
    eng.set_train_batch_size(2)
    loss = eng(batch); eng.backward(loss); eng.step()
    eng.save_checkpoint(str(tmp_path), tag="resized")
    eng2 = build()
    eng2.set_train_batch_size(2)
    eng2.load_checkpoint(str(tmp_path), tag="resized")
    assert eng2.micro_steps == 4 and eng2._gas_offset == 3
    assert eng2.is_gradient_accumulation_boundary()


# ---------------------------------------------------------------------------
# item 12: the tensor-fragment accessors at world 1
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,states", [("AdamW", ("exp_avg", "exp_avg_sq")),
                                         ("SGD", ("trace",)),
                                         ("Adagrad", ("sum_of_squares",)),
                                         ("OneBitLamb", ("exp_avg", "error", "scaling"))])
def test_fragment_get_set(name, states):
    """``tests/test_checkpoint_universal.py``'s fragment cases, with each
    ported optimizer's state names."""
    engine = llama_engine(base_config(train_batch_size=4, gradient_accumulation_steps=2,
                                      optimizer={"type": name, "params": {"lr": 1e-2}}))
    for b in token_batches(3, 2):
        loss = engine(b); engine.backward(loss); engine.step()
    key = "layers.0.mlp.gate_proj.weight"
    assert key in tf.param_names(engine)
    w = tf.safe_get_full_fp32_param(engine, key)
    assert w.dtype == torch.float32 and w.shape == (128, 64)
    for s in states:
        got = tf.safe_get_full_optimizer_state(engine, key, s)
        assert got is not None and torch.isfinite(got).all()
    assert tf.safe_get_full_optimizer_state(engine, key, "nope") is None
    assert not tf.safe_set_full_optimizer_state(engine, key, w, "nope")
    g = tf.safe_get_full_grad(engine, key)       # one micro-step staged
    assert g is not None and g.abs().max() > 0
    assert tf.safe_set_full_fp32_param(engine, key, torch.zeros_like(w))
    assert tf.safe_get_full_fp32_param(engine, key).abs().max() == 0
    s = states[0]
    new = torch.full_like(tf.safe_get_full_optimizer_state(engine, key, s), 0.5)
    assert tf.safe_set_full_optimizer_state(engine, key, new, s)
    assert torch.equal(tf.safe_get_full_optimizer_state(engine, key, s), new)
    assert tf.safe_get_local_fp32_param(engine, key).numel() == w.numel()
    assert tf.safe_get_local_grad(engine, key) is not None
    assert tf.safe_get_local_optimizer_state(engine, key, s) is not None
    assert tf.safe_get_full_fp32_param(engine, "nope") is None
    from deepspeed_tpu_torch.utils import safe_get_full_fp32_param
    assert safe_get_full_fp32_param is tf.safe_get_full_fp32_param


# ---------------------------------------------------------------------------
# item 14: TiledLinear
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cls,jcls", [(TiledLinear, JaxTiledLinear),
                                      (TiledLinearReturnBias, JaxTiledReturnBias)])
def test_tiled_linear_matches_jax(cls, jcls):
    x = np.random.default_rng(0).standard_normal((3, 12)).astype(np.float32)
    jmod = jcls(features=8, in_splits=3, out_splits=2)
    jp = jax.tree.map(np.asarray, jmod.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"])
    jp["bias"] = np.random.default_rng(1).standard_normal(8).astype(np.float32)
    want = jmod.apply({"params": jp}, jnp.asarray(x))
    mod = cls(12, 8, in_splits=3, out_splits=2, device="cpu")
    assert sorted(n for n, _ in mod.named_parameters()) == sorted(jp)
    mod.load_state_dict({k: torch.from_numpy(v) for k, v in jp.items()})
    got = mod(torch.from_numpy(x))
    if cls is TiledLinear:
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=2e-6)
    else:
        for a, b in zip(got, want):
            np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), atol=2e-6)
    kernel = np.random.default_rng(2).standard_normal((12, 8)).astype(np.float32)
    ours = TiledLinear.from_dense_kernel(torch.from_numpy(kernel), 3, 2)
    theirs = JaxTiledLinear.from_dense_kernel(kernel, 3, 2)
    assert list(ours) == list(theirs)
    for k in theirs:
        np.testing.assert_array_equal(ours[k].numpy(), theirs[k])


def test_tiled_linear_init_and_zero_leaves():
    """Init variance follows the whole fan-in; each tile is its own engine
    leaf."""
    mod = TiledLinear(1024, 512, in_splits=4, out_splits=2, device="cpu",
                      generator=torch.Generator().manual_seed(0))
    w = torch.cat([mod.tile_0_0, mod.tile_1_0, mod.tile_2_0, mod.tile_3_0]).detach()
    assert float(w.std()) == pytest.approx(1024 ** -0.5, rel=0.03)
    y = mod(torch.randn(256, 1024, generator=torch.Generator().manual_seed(1)))
    assert float(y.detach().std()) == pytest.approx(1.0, rel=0.1)

    class Net(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.lin = TiledLinear(16, 8, in_splits=2, out_splits=2, device="cpu")

        def forward(self, batch):
            return self.lin(batch["x"]).pow(2).mean()

    engine, *_ = deepspeed_tpu_torch.initialize(model=Net(), config=base_config(),
                                                device="cpu")
    assert [leaf.name for leaf in engine._leaves] == [
        "lin.tile_0_0", "lin.tile_1_0", "lin.tile_0_1", "lin.tile_1_1", "lin.bias"]
    loss = engine({"x": torch.randn(2, 16)}); engine.backward(loss); engine.step()


# ---------------------------------------------------------------------------
# the 4-rank runs: zero.Init at stages 1-3 and under ep, the accessors at
# stages 0-3, qgZ under MiCS
# ---------------------------------------------------------------------------

def jax_runs(params, batches):
    """The JAX engines on 4 devices: the accessors after the worker's
    fragment run (stage 0), and qgZ under MiCS."""
    out = {}
    model = JaxLlama(JaxLlamaConfig.tiny(dtype=jnp.float32, remat=False))
    for name, zero in (("fragments", {"stage": 0}),
                       ("qgz_mics", {"stage": 2, "mics_shard_size": 2,
                                     "zero_quantized_gradients": True})):
        jgroups.reset()
        config = {"train_batch_size": 8, "train_micro_batch_size_per_gpu": 1,
                  "gradient_accumulation_steps": 2,
                  "optimizer": {"type": "AdamW", "params": {
                      "lr": FRAGMENT_LR if name == "fragments" else 1e-2}},
                  "zero_optimization": zero}
        mesh = JaxMesh(dp=WORLD, devices=jax.devices()[:WORLD],
                       zero_shard_size=zero.get("mics_shard_size"),
                       zero_hierarchy="mics" if "mics_shard_size" in zero else None)
        engine, *_ = deepspeed_tpu.initialize(model=model, model_parameters=params,
                                              config=config, mesh=mesh)
        losses = []
        run = batches[:5] if name == "fragments" else batches[:4]
        for i, b in enumerate(run):
            loss = engine({k: jnp.asarray(v) for k, v in b.items()})
            engine.backward(loss)
            if name == "fragments" and i == 4:
                break
            engine.step()
            losses.append(float(jax.device_get(loss)))
        if name == "fragments":
            key = "['layers']['block']['mlp']['gate_proj']['kernel']"
            out[name] = {what: np.asarray(fn(engine, key))[0].T for what, fn in (
                ("param", jax_tf.safe_get_full_fp32_param),
                ("exp_avg", lambda e, k: jax_tf.safe_get_full_optimizer_state(e, k, "exp_avg")),
                ("exp_avg_sq",
                 lambda e, k: jax_tf.safe_get_full_optimizer_state(e, k, "exp_avg_sq")),
                ("grad", jax_tf.safe_get_full_grad))}
        else:
            out[name] = losses
    return out


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_training_rest")
    _, params = jax_llama_params()
    batches = token_batches(6, WORLD, seed=5)
    torch.save({"llama": params_from_flax(params), "batches": batches,
                "fragment_lr": FRAGMENT_LR}, d / "inputs.pt")
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
        want = jax_runs(params, batches)
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
    return [torch.load(d / f"out{r}.pt", weights_only=False) for r in range(WORLD)], want


@pytest.mark.parametrize("case", ["zero_init_1", "zero_init_2", "zero_init_3",
                                  "zero_init_ep"])
def test_zero_init_bitwise_and_one_whole_leaf_at_a_time(ranks, case):
    """``tests/test_sharded_init.py`` on 4 ranks: born sharded, bit for bit
    the whole-module path; while drawing, no earlier whole leaf is alive;
    a rank holds a quarter of the masters (stages 1-3); expert slices keep
    their ep placement."""
    got, _ = ranks
    for r in got:
        res = r[case]
        assert res["differs"] == []
        if case == "zero_init_ep":
            assert res["experts"] > 0
            continue
        assert res["max_alive"] == 0 and res["draws"] == 2 + 2 * 12 + 2
        assert res["sharded"] > 0 and res["share"] < 0.35 * res["whole"]
    assert sorted(r["zero_init_ep"]["ep_rank"] for r in got) == [0, 0, 1, 1]


@pytest.mark.parametrize("stage", [0, 1, 3])
def test_fragments_gather_over_the_placement(ranks, stage):
    """Full reads at every stage equal stage 0's and the JAX engine's; a set
    writes this rank's piece only."""
    got, want = ranks
    key = "layers.0.mlp.gate_proj.weight"
    for r in got:
        res, ref = r[f"fragments_{stage}"], got[0]["fragments_0"]
        for name, vals in res["full"].items():
            for what in ("param", "exp_avg", "exp_avg_sq", "grad"):
                near(vals[what], ref["full"][name][what], what)
        for what in ("param", "exp_avg", "exp_avg_sq", "grad"):
            near(res["full"][key][what], want["fragments"][what], what)
        new = torch.arange(128 * 64, dtype=torch.float32).reshape(128, 64)
        assert torch.equal(res["set_param"], new) and torch.equal(res["set_state"], 2 * new)
        if stage:
            assert res["local_numel"] == new.numel() // WORLD
            assert res["local_state_numel"] == new.numel() // WORLD
        assert res["unknown"] is None and res["absent_state"] is None


def test_qgz_under_mics(ranks):
    """qgZ under MiCS runs its exchange over dp and across dpr as hpZ does:
    its masters are bit for bit qgZ + hpZ's at the same dpr x dp split,
    cut over the shard group; its losses track the JAX engine's qgZ under
    MiCS and the port's MiCS without qgZ to rtol 0.15."""
    got, want = ranks
    for r in got:
        qm, m, qh = r["qgz_mics"], r["mics"], r["qgz_hpz"]
        assert qm["hierarchy"] == "mics" and qm["zero_world"] == 2
        assert qh["hierarchy"] == "hpz" and qh["zero_world"] == 4
        assert qm["losses"] == qh["losses"]
        assert all(torch.equal(qm["masters"][n], qh["masters"][n]) for n in qh["masters"])
        np.testing.assert_allclose(qm["losses"], m["losses"], rtol=0.15)
        np.testing.assert_allclose(qm["losses"][:len(want["qgz_mics"])], want["qgz_mics"],
                                   rtol=0.15)
        assert qm["losses"] == got[0]["qgz_mics"]["losses"]


def test_qgz_under_mics_moves_only_the_shard_groups_chunks(ranks):
    """After the exchange, each rank of qgZ under MiCS receives in fp32 only
    its dp chunk's parts (at most 1 / dp of the gradients a step, less its
    own), for a dp chunk of whole world chunks and for one cut along
    another dim; hpZ, whose masters take the world chunks as they are,
    moves nothing more."""
    got, _ = ranks
    for r in got:
        qm = r["qgz_mics"]
        assert qm["redistributed"] == [True] * 4
        moved = qm["wire"]["mics_grad_redistribute"]["wire"]
        assert 0 < moved <= 4 * qm["grad_bytes"] // 2
        assert "mics_grad_redistribute" not in r["qgz_hpz"]["wire"]
