"""Mistral: the Llama architecture with sliding-window attention and GQA
(port of ``deepspeed_tpu/models/mistral.py``). The Llama module,
parameterized by ``sliding_window`` (``models/llama.py`` carries the window
in the training, KV-cache and ragged paths)."""

from deepspeed_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM

MistralForCausalLM = LlamaForCausalLM


def mistral_config(**kw):
    """mistralai/Mistral-7B-v0.1 geometry."""
    defaults = dict(vocab_size=32000, hidden_size=4096, intermediate_size=14336,
                    num_hidden_layers=32, num_attention_heads=32,
                    num_key_value_heads=8, max_position_embeddings=4096,
                    sliding_window=4096, rope_theta=10000.0)
    defaults.update(kw)
    return LlamaConfig(**defaults)


def tiny_mistral_config(**kw):
    defaults = dict(vocab_size=512, hidden_size=64, intermediate_size=128,
                    num_hidden_layers=2, num_attention_heads=4,
                    num_key_value_heads=2, max_position_embeddings=128,
                    sliding_window=16)
    defaults.update(kw)
    return LlamaConfig(**defaults)
