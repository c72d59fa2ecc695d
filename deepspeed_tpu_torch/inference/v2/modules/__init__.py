"""Swappable module-implementation layer (reference ``inference/v2/modules/``)."""

from deepspeed_tpu_torch.inference.v2.modules.heuristics import (  # noqa: F401
    instantiate_attention, instantiate_linear, instantiate_moe)
from deepspeed_tpu_torch.inference.v2.modules.module_registry import (  # noqa: F401
    ModuleImpl, UnknownModuleError, UnsupportedModuleError,
    register_module, select)
