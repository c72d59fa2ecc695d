"""Tensor swapping between tiers (port of ``deepspeed_tpu/runtime/swap_tensor``):
the host-DRAM KV page swapper. The NVMe swappers wait for ROADMAP A14."""
