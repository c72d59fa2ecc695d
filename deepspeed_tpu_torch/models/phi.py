"""Phi family configs (port of ``deepspeed_tpu/models/phi.py``). See
``models/parallel_block.py``."""

from deepspeed_tpu_torch.models.parallel_block import (ParallelBlockConfig,
                                                       ParallelBlockForCausalLM)

PhiForCausalLM = ParallelBlockForCausalLM


def phi_2_config(**kw):
    defaults = dict(vocab_size=51200, hidden_size=2560, intermediate_size=10240,
                    num_hidden_layers=32, num_attention_heads=32,
                    num_key_value_heads=32, max_position_embeddings=2048,
                    use_bias=True, fused_qkv=False, rotary_pct=0.4,
                    gelu_exact=False, lm_head_bias=True)
    defaults.update(kw)
    return ParallelBlockConfig(**defaults)


def tiny_phi_config(**kw):
    defaults = dict(vocab_size=256, hidden_size=64, intermediate_size=128,
                    num_hidden_layers=2, num_attention_heads=4,
                    num_key_value_heads=4, max_position_embeddings=128,
                    use_bias=True, fused_qkv=False, rotary_pct=0.5,
                    gelu_exact=False, lm_head_bias=True)
    defaults.update(kw)
    return ParallelBlockConfig(**defaults)
