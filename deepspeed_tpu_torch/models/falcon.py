"""Falcon family configs (port of ``deepspeed_tpu/models/falcon.py``). See
``models/parallel_block.py``."""

from deepspeed_tpu_torch.models.parallel_block import (ParallelBlockConfig,
                                                       ParallelBlockForCausalLM)

FalconForCausalLM = ParallelBlockForCausalLM


def falcon_7b_config(**kw):
    defaults = dict(vocab_size=65024, hidden_size=4544, intermediate_size=18176,
                    num_hidden_layers=32, num_attention_heads=71,
                    num_key_value_heads=1, use_bias=False, fused_qkv=True,
                    rotary_pct=1.0)
    defaults.update(kw)
    return ParallelBlockConfig(**defaults)


def tiny_falcon_config(**kw):
    defaults = dict(vocab_size=256, hidden_size=64, intermediate_size=128,
                    num_hidden_layers=2, num_attention_heads=4,
                    num_key_value_heads=1, max_position_embeddings=128,
                    use_bias=False, fused_qkv=True)
    defaults.update(kw)
    return ParallelBlockConfig(**defaults)
