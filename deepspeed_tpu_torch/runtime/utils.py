"""Runtime math utilities (port of ``deepspeed_tpu/runtime/utils.py``).

``global_norm`` / ``clip_grads_by_global_norm`` / ``has_overflow`` over a
list of tensors. All three stay on the tensors' device: the norm and the
overflow flag are 0-d tensors, so clipping needs no host read.
"""

import torch


def global_norm(tensors):
    """L2 norm over every element of every tensor, in fp32."""
    tensors = list(tensors)
    if not tensors:
        return torch.zeros(())
    return torch.sqrt(torch.stack([t.float().pow(2).sum() for t in tensors]).sum())


def clip_grads_by_global_norm(grads, max_norm, norm=None, eps=1e-6):
    """Scale ``grads`` in place so their global norm is at most ``max_norm``.
    Returns (grads, pre-clip norm)."""
    grads = list(grads)
    if norm is None:
        norm = global_norm(grads)
    scale = torch.clamp(max_norm / (norm + eps), max=1.0)
    for g in grads:
        g.mul_(scale.to(g.dtype))
    return grads, norm


def has_overflow(tensors):
    """0-d bool tensor: True if any tensor holds an inf or a nan."""
    tensors = list(tensors)
    if not tensors:
        return torch.zeros((), dtype=torch.bool)
    return torch.stack([~torch.isfinite(t).all() for t in tensors]).any()


def count_parameters(tensors):
    return sum(t.numel() for t in tensors)
