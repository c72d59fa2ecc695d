"""Qwen2: the Llama architecture with q/k/v biases and GQA (port of
``deepspeed_tpu/models/qwen2.py``). The Llama module, parameterized by
``attention_bias`` (``models/llama.py``)."""

from deepspeed_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM

Qwen2ForCausalLM = LlamaForCausalLM


def qwen2_7b_config(**kw):
    defaults = dict(vocab_size=152064, hidden_size=3584, intermediate_size=18944,
                    num_hidden_layers=28, num_attention_heads=28,
                    num_key_value_heads=4, max_position_embeddings=4096,
                    attention_bias=True, rope_theta=1000000.0)
    defaults.update(kw)
    return LlamaConfig(**defaults)


def tiny_qwen2_config(**kw):
    defaults = dict(vocab_size=512, hidden_size=64, intermediate_size=128,
                    num_hidden_layers=2, num_attention_heads=4,
                    num_key_value_heads=2, max_position_embeddings=128,
                    attention_bias=True)
    defaults.update(kw)
    return LlamaConfig(**defaults)
