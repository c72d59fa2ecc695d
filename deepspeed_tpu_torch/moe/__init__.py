"""Mixture of experts (port of ``deepspeed_tpu/moe``): gating, dispatch
and the ``MoE`` layer, on one device or with the experts split over an
expert-parallel axis."""
