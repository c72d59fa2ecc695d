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
"""

import torch

from deepspeed_tpu_torch.checkpoint import hf as hf_interop
from deepspeed_tpu_torch.inference.v2.engine_v2 import InferenceEngineV2
from deepspeed_tpu_torch.models.llama import LlamaConfig
from deepspeed_tpu_torch.models.mixtral import MixtralConfig
from deepspeed_tpu_torch.models.opt import OPTConfig
from deepspeed_tpu_torch.models.parallel_block import ParallelBlockConfig
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
    model = hf_interop.load_pretrained(path, dtype=dtype, device=device)
    model.requires_grad_(False)
    logger.info(f"build_hf_engine: {mt} from {path} "
                f"({sum(p.numel() for p in model.parameters()) / 1e6:.1f}M params, "
                f"dtype {dtype})")
    return build_engine(model, engine_config, family=mt, device=device)


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


def build_engine(model, engine_config=None, family=None, device=None):
    """Build a ragged engine from an in-tree model whose weights lie on
    ``device`` (default ``"cuda"``)."""
    return InferenceEngineV2(model, engine_config,
                             forward_fn=resolve_forward_fn(model, family),
                             verify_fn=resolve_verify_fn(model, family),
                             device=device)
