"""Inference v1 config (port of ``deepspeed_tpu/inference/config.py``).

The same keys, defaults and deprecated aliases (``mp_size`` lands in
``tensor_parallel.tp_size``, ``kernel_inject`` in
``replace_with_kernel_inject``, ``moe.num_experts`` in ``moe_experts``).
Kernel-injection and CUDA-graph flags are accepted for compatibility: the
port's attention and quantized products always run on its hand-written
kernels, and it captures no graphs.
"""

import torch

from deepspeed_tpu_torch.runtime.config_utils import DeepSpeedConfigModel

_DTYPES = {
    "fp32": torch.float32, "float32": torch.float32,
    "fp16": torch.float16, "half": torch.float16, "float16": torch.float16,
    "bf16": torch.bfloat16, "bfloat16": torch.bfloat16,
    "int8": torch.int8,
}


class DeepSpeedTPConfig(DeepSpeedConfigModel):
    """Tensor-parallel settings (reference ``inference/config.py:47``)."""
    enabled = True
    tp_size = 1


class DeepSpeedMoEConfig(DeepSpeedConfigModel):
    """MoE inference settings (reference ``inference/config.py:65``)."""
    enabled = True
    ep_size = 1
    moe_experts = [1]
    _deprecated = {"num_experts": "moe_experts"}


class QuantizationConfig(DeepSpeedConfigModel):
    """Weight quantization at load time (reference ``inference/config.py:114``):
    groupwise symmetric int8, int4, fp6 or fp12 weights."""
    enabled = False
    bits = 8
    q_groups = 1
    group_size = 256


class DeepSpeedInferenceConfig(DeepSpeedConfigModel):
    """Top-level inference config (reference ``inference/config.py:134``)."""
    dtype = "bf16"
    tensor_parallel = DeepSpeedTPConfig()
    moe = DeepSpeedMoEConfig()
    quant = QuantizationConfig()
    checkpoint = None                 # a checkpoint tag directory
    replica_num = 1
    replace_with_kernel_inject = False
    max_out_tokens = 1024
    min_out_tokens = 1
    max_tokens = 1024
    replace_method = "auto"
    enable_cuda_graph = False
    triangular_masking = True
    return_tuple = True
    training_mp_size = 1
    _deprecated = {"mp_size": "tp_size_legacy", "kernel_inject": "replace_with_kernel_inject"}

    tp_size_legacy = None  # landing slot for deprecated mp_size

    @classmethod
    def from_dict(cls, d, **kwargs):
        cfg = cls(d, **kwargs)
        if cfg.tp_size_legacy is not None:
            cfg.tensor_parallel.tp_size = cfg.tp_size_legacy
        return cfg

    @property
    def torch_dtype(self):
        if isinstance(self.dtype, torch.dtype):
            return self.dtype
        return _DTYPES[str(self.dtype).lower()]
