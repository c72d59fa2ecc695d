"""Registered serving-module implementations (port of
``deepspeed_tpu/inference/v2/modules/implementations.py``): the attention,
moe and linear rows. The linear rows serve quantized weights
(``inference/quantization``) in the v1 engine and
``QuantizedParameter.matmul``; the ragged v2 engine has no quantized linear
and refuses a ``modules.linear`` pin. The embedding and unembed rows have a
single implementation each and are not registered.
"""

import torch

from deepspeed_tpu_torch.inference.v2.modules.module_registry import register_module
from deepspeed_tpu_torch.ops import grouped_gemm as gg
from deepspeed_tpu_torch.ops import paged_attention as pa
from deepspeed_tpu_torch.ops import quantized_matmul as qm


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


# -- linear: quantized-weight matmul ---------------------------------------
# Every row's callable is fn(x [M, K], qp, out_dtype) -> [M, N] for a
# QuantizedParameter qp in the [K, N] layout.

def _cuda_fused_dequant_supports(m=None, k=None, n=None, group_size=None, num_bits=None,
                                 ndim=2, dtype=torch.bfloat16, device_type="cuda", **_):
    if ndim != 2:
        return False, f"the kernel takes 2-D weights, got ndim={ndim}"
    # on CPU tensors the wrapper runs its plain version, which takes any dtype
    reason = qm.unsupported_reason(m, k, n, group_size, num_bits,
                                   dtype if device_type == "cuda" else torch.bfloat16)
    if reason:
        return False, (f"(M={m}, K={k}, N={n}, group={group_size}, bits={num_bits}, "
                       f"{dtype}): {reason}")
    return True, "ok"


def fused_dequant_linear(x, qp, out_dtype=None):
    return qm.quantized_matmul(x, qp.q, qp.scale, qp.group_size, out_dtype=out_dtype)


@register_module("linear", "cuda_fused_dequant", supports=_cuda_fused_dequant_supports)
def _build_cuda_fused_dequant(**_):
    """Hand-written sm_90a dequantize-matmul (``csrc/quantized_matmul.cu``):
    int8 weights cross HBM, the tile is dequantized in shared memory; on CPU
    tensors its wrapper runs the plain version."""
    return fused_dequant_linear


def dense_dequant_linear(x, qp, out_dtype=None, tile_dtype=None, transposed=False):
    """Dequantize, rounding the weight to ``tile_dtype`` (by default
    ``out_dtype or x.dtype``: the JAX row's inlined ``x @
    qp.dequantized(out_dtype or x.dtype)``), then multiply in JAX's
    promotion of x's dtype and ``out_dtype``. ``transposed``: ``qp`` is a
    raw ``[N, K]`` weight grouped along K (``lm_head``), multiplied as
    ``x @ w.T``."""
    w = qp.dequantized(tile_dtype or out_dtype or x.dtype)
    dt = torch.promote_types(x.dtype, out_dtype or x.dtype)
    return x.to(dt) @ (w.T if transposed else w).to(dt)


@register_module("linear", "dense_dequant")
def _build_dense_dequant(**_):
    """Dequantize-then-matmul, a plain PyTorch version on whatever device
    the tensors are; every bit width."""
    return dense_dequant_linear
