"""v2 engine factory (port of ``deepspeed_tpu/inference/v2/engine_factory.py``,
mirroring reference ``inference/v2/engine_factory.py:68`` ``build_hf_engine``):
HF checkpoint directory in, ragged serving engine out.

Families (the reference maps eight policies, :68-129): llama / llama2 /
mistral / qwen2 / qwen / internlm route to the ragged llama forward
(qkv-bias and sliding window per config), mixtral to the ragged MoE
forward, falcon and phi to the ragged parallel-block forward, opt to the
ragged OPT forward. ``build_hf_engine`` loads the weights through the HF
converter (``checkpoint/hf.py``) straight in the serving dtype on the
engine's device; ``build_engine`` serves an in-tree model.

With ``tensor_parallel.tp_size`` > 1 (every family) every rank of the
``tp`` group calls the builder: the group is the ``tp`` axis of
the topology in ``parallel.groups`` (``groups.serving_topology``: the
installed one, or a ``MeshTopology(tp=tp_size)`` over the world when none
is installed),
each rank serves its share of the weights (``TPPlan``), tp rank 0 drives
the engine and the other ranks run ``engine.follow()``. ``build_replica`` is the JAX
package's one-replica builder (``inference/v2/replica_group.py:28``) over
that group.
"""

import torch

from deepspeed_tpu_torch.checkpoint import hf as hf_interop
from deepspeed_tpu_torch.inference.v2.config_v2 import RaggedInferenceEngineConfig
from deepspeed_tpu_torch.inference.v2.engine_v2 import InferenceEngineV2
from deepspeed_tpu_torch.inference.v2.scheduler import SplitFuseScheduler
from deepspeed_tpu_torch.models.llama import LlamaConfig
from deepspeed_tpu_torch.models.mixtral import MixtralConfig
from deepspeed_tpu_torch.models.opt import OPTConfig
from deepspeed_tpu_torch.models.parallel_block import ParallelBlockConfig
from deepspeed_tpu_torch.parallel import groups
from deepspeed_tpu_torch.parallel.tensor_parallel import TensorParallel, slice_state_dict
from deepspeed_tpu_torch.utils.logging import logger

SUPPORTED_FAMILIES = ("llama", "mistral", "qwen2", "mixtral", "falcon", "phi",
                      "opt", "qwen", "internlm")  # qwen(v1)/internlm load as
                                                  # llama models (hf.py)
LLAMA_FAMILIES = ("llama", "llama2", "mistral", "qwen2", "qwen", "internlm")
# families without a k-token verify forward (speculative decode refuses them)
NO_VERIFY_FAMILIES = ("mixtral", "falcon", "phi", "opt")


def build_hf_engine(path, engine_config=None, dtype=None, device=None):
    """Build a ragged engine from a HuggingFace checkpoint dir.

    Args:
        path: directory with config.json + safetensors/bin weights.
        engine_config: ``RaggedInferenceEngineConfig`` or dict.
        dtype: serving dtype (default ``torch.bfloat16``); the weights are
            stored and computed in it.
        device: where the engine runs and the weights load (default
            ``"cuda"``, which raises without a GPU).
    """
    mt = hf_interop.detect_model_type(path)
    if mt not in SUPPORTED_FAMILIES:
        raise ValueError(f"ragged engine supports {SUPPORTED_FAMILIES}, "
                         f"got model_type {mt!r}")
    dtype = torch.bfloat16 if dtype is None else dtype
    config = _as_config(engine_config)
    tp = _tensor_parallel(config)
    model = hf_interop.load_pretrained(path, dtype=dtype, device=device,
                                       tp_size=tp.size, tp_rank=tp.rank)
    model.requires_grad_(False)
    logger.info(f"build_hf_engine: {mt} from {path} "
                f"({sum(p.numel() for p in model.parameters()) / 1e6:.1f}M params, "
                f"dtype {dtype})")
    return build_engine(model, config, family=mt, device=device)


def model_family(model):
    """The family of an in-tree model, by its config."""
    for cls, family in ((MixtralConfig, "mixtral"), (ParallelBlockConfig, "falcon"),
                        (OPTConfig, "opt"), (LlamaConfig, "llama")):
        if isinstance(model.config, cls):
            return family
    raise ValueError(f"{type(model.config).__name__} has no ragged forward")


def resolve_forward_fn(model, family=None):
    """The ragged implementation for a model family (the reference's policy
    map, ``engine_factory.py:68-129``)."""
    family = family or model_family(model)
    if family == "mixtral":
        from deepspeed_tpu_torch.inference.v2.model_implementations.mixtral import (
            ragged_forward)
    elif family in ("falcon", "phi"):
        from deepspeed_tpu_torch.inference.v2.model_implementations.parallel_block import (
            ragged_forward)
    elif family == "opt":
        from deepspeed_tpu_torch.inference.v2.model_implementations.opt import (
            ragged_forward)
    elif family in LLAMA_FAMILIES:
        from deepspeed_tpu_torch.inference.v2.model_implementations.llama import (
            ragged_forward)
    else:
        raise ValueError(f"unknown model family {family!r}")
    return ragged_forward


def resolve_verify_fn(model, family=None):
    """The k-token verify forward for a model family, or ``None`` when the
    family has none (Mixtral, Falcon, Phi, OPT, as in the JAX package): the
    engine then refuses speculation rather than fall back to another
    program."""
    if (family or model_family(model)) in NO_VERIFY_FAMILIES:
        return None
    from deepspeed_tpu_torch.inference.v2.model_implementations.llama import (
        ragged_forward_verify)
    return ragged_forward_verify


def _as_config(engine_config):
    if isinstance(engine_config, RaggedInferenceEngineConfig):
        return engine_config
    return RaggedInferenceEngineConfig(engine_config or {})


def _tensor_parallel(config):
    """This rank's ``TensorParallel`` for ``config``'s ``tp_size``, from the
    topology in ``parallel.groups`` (``groups.serving_topology``)."""
    tp_size = int(dict(config.tensor_parallel).get("tp_size", 1))
    if tp_size == 1:
        return TensorParallel()
    return TensorParallel.from_topology(groups.serving_topology(tp_size))


def shard_model(model, tp):
    """``model`` as rank ``tp.rank`` of ``tp`` serves it: a model built with
    ``tp.size`` keeps its weights (they must be that rank's parts), a whole
    model is cut into a new module holding copies of the rank's parts
    (dropping the whole model then frees its split weights)."""
    if model.tp_size == tp.size:
        if model.plan.rank != tp.rank:
            raise ValueError(f"the model holds tp rank {model.plan.rank}'s share, "
                             f"this is tp rank {tp.rank}")
    elif model.tp_size == 1:
        local = type(model)(model.config, device="meta", tp_size=tp.size, tp_rank=tp.rank)
        local.load_state_dict(slice_state_dict(model.state_dict(), local.plan), assign=True)
        model = local.requires_grad_(False)
    else:
        raise ValueError(f"a model split over {model.tp_size} ranks cannot serve "
                         f"at tp_size {tp.size}")
    model.set_tensor_parallel(tp)
    return model


def build_engine(model, engine_config=None, family=None, device=None):
    """Build a ragged engine from an in-tree model whose weights lie on
    ``device`` (default ``"cuda"``). With ``tensor_parallel.tp_size`` > 1
    every rank of the ``tp`` group calls it (module docstring); ``model`` is
    the whole model or the rank's slice of it (``from_seed(...,
    tp_size=..., tp_rank=...)``)."""
    config = _as_config(engine_config)
    tp = _tensor_parallel(config)
    if tp.size > 1:
        model = shard_model(model, tp)
    return InferenceEngineV2(model, config,
                             forward_fn=resolve_forward_fn(model, family),
                             verify_fn=resolve_verify_fn(model, family),
                             device=device)


def build_replica(model, tp_size=1, engine_config=None, token_budget=None, device=None):
    """One replica over a ``tp`` group of ``tp_size`` ranks (the JAX
    package's ``build_replica``, ``inference/v2/replica_group.py:28``):
    every rank of the group calls it. On tp rank 0 it returns (the group's
    ``TensorParallel``, a ``SplitFuseScheduler`` over the engine), whose
    caller serves and then calls ``scheduler.engine.stop_followers()``; on
    the other ranks it serves the controller's forwards and returns
    (``TensorParallel``, None) once the controller stops them."""
    config = _as_config(engine_config)
    config.tensor_parallel = dict(config.tensor_parallel, tp_size=int(tp_size))
    engine = build_engine(model, config, device=device)
    if not engine.is_controller:
        engine.follow()
        return engine.tensor_parallel, None
    return engine.tensor_parallel, SplitFuseScheduler(engine, token_budget=token_budget)
