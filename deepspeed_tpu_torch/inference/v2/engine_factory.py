"""v2 engine factory (port of ``deepspeed_tpu/inference/v2/engine_factory.py``).

``build_engine`` serves an in-tree ``LlamaForCausalLM`` or
``MixtralForCausalLM``: the llama family (llama, llama2, mistral, qwen2,
internlm trees) routes to the ragged llama forward, mixtral to the ragged
MoE forward. ``build_hf_engine`` waits until a checkpoint is in the
repository (ROADMAP A6); the falcon/phi and opt forwards wait for ROADMAP
A7.
"""

from deepspeed_tpu_torch.inference.v2.engine_v2 import InferenceEngineV2
from deepspeed_tpu_torch.models.llama import LlamaConfig
from deepspeed_tpu_torch.models.mixtral import MixtralConfig

LLAMA_FAMILIES = ("llama", "llama2", "mistral", "qwen2", "qwen", "internlm")
UNPORTED_FAMILIES = ("falcon", "phi", "opt")


def resolve_forward_fn(model, family=None):
    """The ragged implementation for a model family (the reference's policy
    map, ``engine_factory.py:68-129``)."""
    if family is None:
        if isinstance(model.config, MixtralConfig):
            family = "mixtral"
        elif isinstance(model.config, LlamaConfig):
            family = "llama"
        else:
            raise NotImplementedError(
                f"{type(model.config).__name__} has no ragged forward in "
                f"deepspeed_tpu_torch yet; see ROADMAP.md queue A7")
    if family in UNPORTED_FAMILIES:
        raise NotImplementedError(
            f"the {family} ragged forward is not ported yet; see ROADMAP.md "
            f"queue A7")
    if family == "mixtral":
        from deepspeed_tpu_torch.inference.v2.model_implementations.mixtral import (
            ragged_forward)
        return ragged_forward
    if family not in LLAMA_FAMILIES:
        raise ValueError(f"unknown model family {family!r}")
    from deepspeed_tpu_torch.inference.v2.model_implementations.llama import (
        ragged_forward)
    return ragged_forward


def resolve_verify_fn(model, family=None):
    """The k-token verify forward for a model family, or ``None`` when the
    family has none (Mixtral, as in the JAX package): the engine then
    refuses speculation rather than fall back to another program."""
    if family is None:
        family = "mixtral" if isinstance(model.config, MixtralConfig) else "llama"
    if family == "mixtral" or family in UNPORTED_FAMILIES:
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
