"""Per-backend module-implementation selection (port of
``deepspeed_tpu/inference/v2/modules/heuristics.py``).

"auto" picks the hand-written kernel and never drops to the plain version:
a shape the kernel cannot take raises, so a run that asked for the card
cannot silently measure something else. The plain version serves only when
the config pins ``modules.attention = "dense"``.
"""

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
