"""Hand-written Hopper kernels (``csrc/``) and their PyTorch wrappers."""
