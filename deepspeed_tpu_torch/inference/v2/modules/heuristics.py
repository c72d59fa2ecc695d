"""Per-backend module-implementation selection (port of
``deepspeed_tpu/inference/v2/modules/heuristics.py``).

"auto" picks the hand-written kernel and never drops to the plain version:
a shape the kernel cannot take raises, so a run that asked for the card
cannot silently measure something else. A plain version serves only when
the config pins it (``modules.attention = "dense"``, ``modules.moe =
"einsum"``, ``linear`` = "dense_dequant").
"""

import torch

from deepspeed_tpu_torch.inference.v2.modules import implementations  # noqa: F401  (registers rows)
from deepspeed_tpu_torch.inference.v2.modules.module_registry import select


def instantiate_attention(q_shape, pool_shape, preference=None):
    """-> ('cuda_paged' | 'dense', callable) for ragged paged attention.
    ``preference``: a registered name pins (raises if it cannot serve these
    shapes); None/'auto' means the kernel row, which raises likewise."""
    if preference in (None, "auto"):
        preference = "cuda_paged"
    return select("attention", preference,
                  q_shape=tuple(q_shape), pool_shape=tuple(pool_shape))


def instantiate_moe(d_model, d_ff, preference=None):
    """-> ('cuda_gmm' | 'einsum', callable) for the expert-FFN dispatch of
    a model of width ``d_model`` and expert width ``d_ff``. None/'auto'
    means the kernel row, which raises on dims it cannot take."""
    if preference in (None, "auto"):
        preference = "cuda_gmm"
    return select("moe", preference, d_model=d_model, d_ff=d_ff)


def instantiate_linear(m, k, n, group_size, num_bits, ndim=2, preference=None,
                       dtype=torch.bfloat16, device_type="cuda"):
    """-> ('cuda_fused_dequant' | 'dense_dequant', callable) for a
    quantized-weight product [M, K] @ [K, N] with activations of ``dtype``
    on ``device_type``. None/'auto' means the kernel row at 8 bits, which
    raises where the kernel cannot serve; 4-, 6- and 12-bit weights have no
    kernel in either package, so there it means 'dense_dequant'."""
    if preference in (None, "auto"):
        preference = "cuda_fused_dequant" if num_bits == 8 else "dense_dequant"
    return select("linear", preference, m=m, k=k, n=n, group_size=group_size,
                  num_bits=num_bits, ndim=ndim, dtype=dtype, device_type=device_type)
