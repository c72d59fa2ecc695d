"""Block-sparse attention (port of ``deepspeed_tpu/ops/sparse_attention``)."""

from deepspeed_tpu_torch.ops.sparse_attention.sparsity_config import (
    BigBirdSparsityConfig, BSLongformerSparsityConfig, DenseSparsityConfig,
    FixedSparsityConfig, LocalSlidingWindowSparsityConfig, SparsityConfig,
    VariableSparsityConfig)
from deepspeed_tpu_torch.ops.sparse_attention.sparse_self_attention import (
    SparseSelfAttention, blockwise_sparse_attention, sparse_attention)

__all__ = ["BigBirdSparsityConfig", "BSLongformerSparsityConfig",
           "DenseSparsityConfig", "FixedSparsityConfig",
           "LocalSlidingWindowSparsityConfig", "SparsityConfig",
           "VariableSparsityConfig", "SparseSelfAttention", "sparse_attention"]
