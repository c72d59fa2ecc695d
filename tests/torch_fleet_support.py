"""Shared pieces of the port's serving-fleet tests (``test_torch_fleet.py``,
``test_torch_fleet_elastic.py``, ``test_torch_kv_fabric.py``): the tiny fp32
Llama drawn by flax from ``PRNGKey(0)`` and carried into the port through
``params_from_flax``, the JAX fleet tests' engine configs and request
generators, and the monolithic references of both packages."""

import numpy as np
import torch

import jax
import jax.numpy as jnp

from deepspeed_tpu import telemetry as jax_telemetry
from deepspeed_tpu.inference.v2.replica_group import build_replica as jax_build_replica
from deepspeed_tpu.models.llama import LlamaConfig as JaxLlamaConfig
from deepspeed_tpu.models.llama import LlamaForCausalLM as JaxLlama
from deepspeed_tpu.resilience import faults as jax_faults
from deepspeed_tpu_torch import telemetry
from deepspeed_tpu_torch.inference.v2.replica_group import (_ModelCopies,
                                                            build_device_replica)
from deepspeed_tpu_torch.models.llama import (LlamaConfig, LlamaForCausalLM,
                                              params_from_flax)
from deepspeed_tpu_torch.resilience import faults

# the JAX fleet tests' engine config (tests/test_fleet.py)
ENG = {"state_manager": {"max_ragged_sequence_count": 9,
                         "max_ragged_batch_size": 64,
                         "max_context": 96,
                         "num_kv_blocks": 96},
       "kv_cache": {"block_size": 8, "cache_dtype": "fp32"}}

# the wire tests' engine config (tests/test_kv_fabric.py): int8 pools, so
# the wire leg is lossless, and prefix caching for delta shipping
WIRE_ENG = {"state_manager": {"max_ragged_sequence_count": 12,
                              "max_ragged_batch_size": 64,
                              "max_context": 96,
                              "num_kv_blocks": 128,
                              "kv_dtype": "int8"},
            "kv_cache": {"block_size": 8, "cache_dtype": "fp32"},
            "prefix_caching": True}

DEVICES = ["cpu"] * 3


def served_models():
    """(jax config, jax model, flax params, port model): the same tiny fp32
    Llama in both packages."""
    jcfg = JaxLlamaConfig.tiny(scan_layers=True, remat=False, dtype=jnp.float32)
    jmodel = JaxLlama(jcfg)
    ids = np.random.default_rng(0).integers(0, jcfg.vocab_size,
                                            (1, 8)).astype(np.int32)
    params = jmodel.init(jax.random.PRNGKey(0), {"input_ids": ids})["params"]
    model = LlamaForCausalLM(LlamaConfig.tiny(dtype=torch.float32), device="cpu")
    model.load_state_dict(params_from_flax(jax.tree.map(np.asarray, params)))
    return jcfg, jmodel, params, model.requires_grad_(False)


def clean_state():
    """Disarm both packages' faults and switch both telemetries off."""
    for f in (faults, jax_faults):
        f.reset()
    for tm in (telemetry, jax_telemetry):
        tm.close()
        tm.reset()
    telemetry.configure(enabled=False, jsonl_path="", chrome_trace_path="",
                        sample_sync=True)
    jax_telemetry.configure(enabled=False, jsonl_path="", chrome_trace_path="",
                            sample_sync=True, jax_annotations=False)


def requests(vocab, n=4, seed=5, max_new=6, sampling=False):
    """Mixed-length prompts, several longer than the prefill chunk
    (``tests/test_fleet.py::_requests``)."""
    rng = np.random.default_rng(seed)
    out = {}
    for uid in range(n):
        plen = int(rng.integers(5, 60))
        kwargs = {"max_new_tokens": max_new}
        if sampling:
            kwargs.update(temperature=0.9, top_k=5,
                          seed=int(rng.integers(0, 2 ** 30)))
        out[uid] = (rng.integers(0, vocab, plen).astype(np.int32), kwargs)
    return out


def prefix_requests(vocab, pools=2, per_pool=2, seed=11):
    """Groups sharing a 24-token prefix (``tests/test_kv_fabric.py``)."""
    rng = np.random.default_rng(seed)
    out = {}
    for g in range(pools):
        prefix = rng.integers(1, vocab, 24).astype(np.int32)
        for i in range(per_pool):
            uid = g * per_pool + i
            sfx = rng.integers(1, vocab, 4 + 8 * uid).astype(np.int32)
            out[uid] = np.concatenate([prefix, sfx])
    return out


def single_reference(model, reqs, eng=ENG, budget=48):
    """The port's monolithic single-replica run: {uid: tokens}."""
    _, sched = build_device_replica(_ModelCopies(model), "cpu", eng, budget)
    for uid, (prompt, kwargs) in reqs.items():
        sched.submit(uid, prompt, **kwargs)
    return {u: np.asarray(v, np.int32) for u, v in sched.run_to_completion().items()}


def jax_single_reference(jmodel, params, reqs, eng=ENG, budget=48):
    """The JAX package's monolithic single-replica run: {uid: tokens}."""
    mesh, sched = jax_build_replica(jmodel, params, [jax.devices()[0]],
                                    engine_config=eng, token_budget=budget)
    with mesh:
        for uid, (prompt, kwargs) in reqs.items():
            sched.submit(uid, prompt, **kwargs)
        return {u: np.asarray(v, np.int32) for u, v in sched.run_to_completion().items()}


def assert_bit_exact(got, want):
    assert set(got) >= set(want)
    for uid in want:
        np.testing.assert_array_equal(np.asarray(got[uid], np.int32),
                                      np.asarray(want[uid], np.int32),
                                      err_msg=f"uid {uid}")
