"""The v1 engine's KV-cached forward of the parallel-block families, Falcon
and Phi, against the JAX package's, on the CPU.

The same tiny weights (numpy draws in the flax tree's shapes) serve in
both packages, carried into the port by ``params_from_flax``: ``init_inference`` ``generate``
(greedy tokens exactly) and each step of the cached forward (logits to
2e-5, fp32), unquantized and with ``quant`` at 8 bits (the dequantized
weights rounded to bf16 in an fp32 engine, as v1 does), against JAX
``init_inference(...).generate`` and the JAX model's ``use_cache`` apply.
In groups of 48 the fused qkv (N 96) tiles and ``dense``, ``fc1`` and
``fc2`` (N 64, 128, 64) end in a padded group: at bf16 those take
``dense_dequant`` by the declared route and the others row 7. An HF
directory of each family serves through ``init_inference``, and OPT and
Mixtral, which have no cached path in the JAX package either, raise
``ValueError`` from ``generate``.
"""

import copy
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.inference.generation import init_cache as jax_init_cache
from deepspeed_tpu.models import falcon as jax_falcon
from deepspeed_tpu.models import phi as jax_phi
from deepspeed_tpu.models.parallel_block import ParallelBlockForCausalLM as JaxBlock
from deepspeed_tpu_torch.checkpoint import hf
from deepspeed_tpu_torch.inference.generation import init_cache
from deepspeed_tpu_torch.inference.quantization import QuantizedLinear
from deepspeed_tpu_torch.models import falcon, phi
from deepspeed_tpu_torch.models import parallel_block as port_pb
from deepspeed_tpu_torch.models.mixtral import MixtralConfig, MixtralForCausalLM
from deepspeed_tpu_torch.models.opt import OPTConfig, OPTForCausalLM

ATOL = 2e-5
F32 = dict(dtype=jnp.float32, remat=False)
GROUP = 32
NEW = 4                 # new tokens a generate
PADDED_GROUP = 48
FAMILIES = {
    "falcon": (jax_falcon.tiny_falcon_config, falcon.tiny_falcon_config, {}),
    "falcon_mha_bias_tied": (jax_falcon.tiny_falcon_config, falcon.tiny_falcon_config,
                             dict(num_key_value_heads=4, use_bias=True, tie_lm_head=True)),
    "phi": (jax_phi.tiny_phi_config, phi.tiny_phi_config, {}),
}


def ids(seed, shape=(2, 8), vocab=256):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(np.int32)


@pytest.fixture(scope="module", params=sorted(FAMILIES))
def family(request):
    return built(request.param)


@functools.lru_cache(maxsize=None)
def built(name):
    """(name, JAX model, params, port model) of a family, built once."""
    jcfg_fn, cfg_fn, kw = FAMILIES[name]
    jmodel = JaxBlock(jcfg_fn(**kw, **F32))
    shapes = jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0),
                                                {"input_ids": ids(0)}))["params"]
    rng = np.random.default_rng(0)

    def fill(path, leaf):              # N(0, 0.02); LayerNorm scales 1, biases 0.02-noise
        if jax.tree_util.keystr(path).endswith("['scale']"):
            return np.ones(leaf.shape, np.float32)
        return (0.02 * rng.standard_normal(leaf.shape)).astype(np.float32)
    params = jax.tree_util.tree_map_with_path(fill, shapes)
    model = port_pb.ParallelBlockForCausalLM(cfg_fn(dtype=torch.float32, remat=False, **kw))
    model.load_state_dict(port_pb.params_from_flax(params))
    return name, jmodel, params, model.eval().requires_grad_(False)


def fresh(model):
    """A copy for one engine (``init_inference`` casts and quantizes the
    module it is given in place)."""
    return copy.deepcopy(model)


def config(bits, dtype="fp32", group=GROUP):
    conf = {"dtype": dtype}
    if bits:
        conf["quant"] = {"enabled": True, "bits": bits, "group_size": group}
    return conf


def jax_steps(jmodel, params, prompt, tokens):
    """The JAX model's cached logits (one jitted apply): the prompt's, then
    one step per token of ``tokens`` [B, n]."""
    B, T = prompt.shape

    @jax.jit
    def step(params, cache, ids, pos):
        return jmodel.apply({"params": params, "cache": cache}, {"input_ids": ids},
                            use_cache=True, positions=pos, mutable=["cache"])
    out, v = step(params, jax_init_cache(jmodel, prompt), prompt,
                  np.broadcast_to(np.arange(T, dtype=np.int32), (B, T)))
    logits = [np.asarray(out)[:, -1]]
    for i in range(tokens.shape[1]):
        out, v = step(params, v["cache"], tokens[:, i:i + 1],
                      np.full((B, 1), T + i, np.int32))
        logits.append(np.asarray(out)[:, -1])
    return np.stack(logits, 1)


def port_steps(model, prompt, tokens):
    x = torch.as_tensor(prompt).long()
    B, T = x.shape
    cache = init_cache(model, x)
    with torch.no_grad():
        out, cache = model(x, use_cache=True, cache=cache)
        logits = [out[:, -1]]
        for i in range(tokens.shape[1]):
            pos = torch.full((B, 1), T + i, dtype=torch.long)
            out, cache = model(torch.as_tensor(tokens[:, i:i + 1]).long(), positions=pos,
                               use_cache=True, cache=cache)
            logits.append(out[:, -1])
    return torch.stack(logits, 1).float().numpy()


@pytest.mark.parametrize("name,bits", [("falcon", None), ("phi", None), ("phi", 8)])
def test_cached_generate_matches_jax(name, bits):
    """Greedy ``generate`` exactly and every cached step's logits to 2e-5,
    through the engines' (quantized) modules: Falcon and Phi unquantized,
    Phi at 8 bits (the 8-bit Falcon modules are the padded-route test's;
    the tied-head variant's cached path is held by the prefill and fault
    tests)."""
    _, jmodel, params, model = built(name)
    prompt = ids(1)
    jeng = deepspeed_tpu.init_inference(jmodel, config=config(bits))
    jeng.set_params(params)
    want = np.asarray(jeng.generate(prompt, max_new_tokens=NEW))
    eng = deepspeed_tpu_torch.init_inference(fresh(model), config=config(bits), device="cpu")
    got = eng.generate(prompt, max_new_tokens=NEW).numpy()
    np.testing.assert_array_equal(got, want)
    # the JAX engine's serving module dequantizes its int8 tree inside
    np.testing.assert_allclose(port_steps(eng.module, prompt, got[:, :NEW - 1]),
                               jax_steps(jeng._serve_module, jeng.params, prompt,
                                         want[:, :NEW - 1]),
                               rtol=0, atol=ATOL)


def test_cached_prefill_equals_the_full_forward(family):
    _, _, _, model = family
    x = torch.as_tensor(ids(2)).long()
    with torch.no_grad():
        full = model(x)
        cached, cache = model(x, use_cache=True, cache=init_cache(model, x))
    np.testing.assert_allclose(cached.numpy(), full.numpy(), rtol=0, atol=ATOL)
    assert cache.index == 8 and len(cache.keys) == model.config.num_hidden_layers


def test_planted_cache_fault_is_rejected(family):
    """A cache index one ahead (the step reads a stale zero slot and writes
    past its own) moves the logits far past the tolerance."""
    _, _, _, model = family
    x = torch.as_tensor(ids(3)).long()
    with torch.no_grad():
        _, cache = model(x, use_cache=True, cache=init_cache(model, x))
        nxt = torch.as_tensor(ids(4, (2, 1))).long()
        pos = torch.full((2, 1), 8, dtype=torch.long)
        good, _ = model(nxt, positions=pos, use_cache=True, cache=_copy(cache))
        cache.index += 1
        bad, _ = model(nxt, positions=pos, use_cache=True, cache=cache)
    assert float((good - bad).abs().max()) > 100 * ATOL


def _copy(cache):
    out = object.__new__(type(cache))
    out.keys = [k.clone() for k in cache.keys]
    out.values = [v.clone() for v in cache.values]
    out.index = cache.index
    return out


def test_padded_groups_take_the_declared_dense_route(family):
    """At bf16 and 8 bits every Dense linear runs row 7 except those whose
    last group of 48 is padded: those take ``dense_dequant`` by the
    declared gap; ``lm_head`` (grouped along K) as before."""
    name, _, _, model = family
    eng = deepspeed_tpu_torch.init_inference(fresh(model), config=config(8, "bf16", PADDED_GROUP),
                                             device="cpu")
    routes = {n: m for n, m in eng.module.named_modules() if isinstance(m, QuantizedLinear)}
    for n, m in routes.items():
        if n == "lm_head":
            assert m.impl == "dense_dequant" and m.gap is None
            continue
        padded = bool(m.shape[1] % PADDED_GROUP)
        assert (m.impl == "dense_dequant") == padded and bool(m.gap) == padded, (n, m.impl)
    kernel = {n.split(".")[-1] for n, m in routes.items() if m.impl == "cuda_fused_dequant"}
    assert kernel == ({"query_key_value"} if name.startswith("falcon") else set())
    assert eng.generate(ids(5), max_new_tokens=3).shape == (2, 3)


@pytest.mark.parametrize("name", ["falcon", "phi"])
def test_hf_directory_serves_through_v1(tmp_path, name):
    """An HF directory of each family loads and generates in v1, equal to
    the same weights passed as a model."""
    cfg = (falcon.tiny_falcon_config if name == "falcon" else phi.tiny_phi_config)(
        dtype=torch.float32, remat=False)
    model = port_pb.ParallelBlockForCausalLM.from_seed(cfg, 0, device="cpu")
    hf.export_pretrained(model, cfg, str(tmp_path))
    served = deepspeed_tpu_torch.init_inference(
        None, config={"checkpoint": str(tmp_path), "dtype": "fp32"}, device="cpu")
    alone = deepspeed_tpu_torch.init_inference(model, config={"dtype": "fp32"},
                                               device="cpu")
    prompt = ids(6)
    np.testing.assert_array_equal(served.generate(prompt, max_new_tokens=4).numpy(),
                                  alone.generate(prompt, max_new_tokens=4).numpy())


@pytest.mark.parametrize("cls,cfg", [(OPTForCausalLM, OPTConfig.tiny),
                                     (MixtralForCausalLM, MixtralConfig.tiny)])
def test_families_without_a_cached_path_raise(cls, cfg):
    model = cls.from_seed(cfg(dtype=torch.float32), 0, device="cpu")
    eng = deepspeed_tpu_torch.init_inference(model, config={"dtype": "fp32"}, device="cpu")
    with pytest.raises(ValueError, match="no KV-cached forward"):
        eng.generate(ids(7), max_new_tokens=2)
