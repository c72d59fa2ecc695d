"""Checkpoint interop (port of ``deepspeed_tpu/checkpoint/``): HuggingFace
directories (``hf``). Universal checkpoints and DeepSpeed checkpoint interop
are ROADMAP A15."""
