"""Registered serving-module implementations (port of
``deepspeed_tpu/inference/v2/modules/implementations.py``): the attention
and moe rows. The linear, embedding and unembed rows wait for the
subsystems that read them (queue A's quantized-inference item).
"""

from deepspeed_tpu_torch.inference.v2.modules.module_registry import register_module
from deepspeed_tpu_torch.ops import grouped_gemm as gg
from deepspeed_tpu_torch.ops import paged_attention as pa


def _cuda_paged_supports(q_shape=None, pool_shape=None, **_):
    if q_shape is None or pool_shape is None:
        return False, "no shapes provided"
    reason = pa.unsupported_reason(q_shape, pool_shape)
    return reason is None, reason or "ok"


@register_module("attention", "cuda_paged", supports=_cuda_paged_supports)
def _build_cuda_paged(**_):
    """Hand-written sm_90a blocked-flash kernel over paged KV
    (``csrc/paged_attention.cu``, O(seen) HBM reads); on CPU tensors its
    wrapper runs the plain version."""
    return pa.paged_mha


@register_module("attention", "dense")
def _build_dense_attention(**_):
    """The kernel's plain PyTorch version (gathers the whole block table,
    O(max_context) reads) on whatever device the tensors are."""
    return pa.paged_mha_reference


# -- moe: expert-FFN dispatch ----------------------------------------------

def _cuda_gmm_supports(d_model=None, d_ff=None, **_):
    reason = gg.unsupported_reason(d_model, d_ff)
    if reason:
        return False, f"dims (D={d_model}, F={d_ff}): {reason}"
    return True, "ok"


@register_module("moe", "cuda_gmm", supports=_cuda_gmm_supports)
def _build_cuda_gmm(**_):
    """Hand-written sm_90a grouped GEMM over expert-sorted rows
    (``csrc/grouped_gemm.cu``; moe_scatter/gather around it), no capacity
    dimension; on CPU tensors its wrapper runs the plain version."""
    return gg.moe_ffn_gmm


@register_module("moe", "einsum")
def _build_einsum_moe(**_):
    """GShard dense dispatch-combine over stacked expert weights (lossless
    capacity), a plain PyTorch version on whatever device the tensors are."""
    from deepspeed_tpu_torch.inference.v2.model_implementations.mixtral import (
        moe_ffn_einsum)
    return moe_ffn_einsum
