from deepspeed_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM, params_from_flax
