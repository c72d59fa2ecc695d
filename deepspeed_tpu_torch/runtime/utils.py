"""Runtime math utilities (port of ``deepspeed_tpu/runtime/utils.py``).

``global_norm`` / ``clip_grads_by_global_norm`` / ``has_overflow`` over a
list of tensors. All three stay on the tensors' device: the norm and the
overflow flag are 0-d tensors, so clipping needs no host read. Under ZeRO a
rank holds shards of some gradients and whole copies of others: with a
process ``group``, ``global_norm`` all-reduces the shards' sum of squares
and counts each whole tensor once, and ``has_overflow`` all-reduces its
flag (max), so every rank clips by the same norm and skips the same steps.
"""

import torch

from deepspeed_tpu_torch.comm import comm as dist


def _sum_squares(tensors, device):
    if not tensors:
        return torch.zeros((), device=device)
    return torch.stack([t.float().pow(2).sum() for t in tensors]).sum()


def global_norm(tensors, group=None, sharded=None, replicas=None):
    """L2 norm over every element of every tensor, in fp32. ``sharded[i]``
    marks ``tensors[i]`` as this rank's piece of a tensor spread over
    ``group``, whose squares are summed over the group, divided by
    ``replicas[i]`` (default 1) when that many ranks of the group hold each
    piece; the others are whole on every rank and counted once."""
    tensors = list(tensors)
    if not tensors:
        return torch.zeros(())
    if sharded is None or dist.get_world_size(group) == 1:
        return torch.sqrt(_sum_squares(tensors, tensors[0].device))
    device = tensors[0].device
    replicas = replicas or [1] * len(tensors)
    shared = [(t, r) for t, s, r in zip(tensors, sharded, replicas) if s]
    parts = _sum_squares([t for t, r in shared if r == 1], device)
    for t, r in shared:
        if r > 1:
            parts = parts + _sum_squares([t], device) / r
    whole = _sum_squares([t for t, s in zip(tensors, sharded) if not s], device)
    return torch.sqrt(dist.all_reduce(parts, group=group) + whole)


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


def has_overflow(tensors, group=None):
    """0-d bool tensor: True if any tensor holds an inf or a nan, on this
    rank or (with ``group``) on any rank of the group."""
    tensors = list(tensors)
    if not tensors:
        return torch.zeros((), dtype=torch.bool)
    flag = torch.stack([~torch.isfinite(t).all() for t in tensors]).any()
    if dist.get_world_size(group) == 1:
        return flag
    return dist.all_reduce(flag.to(torch.int32), op=dist.ReduceOp.MAX, group=group) > 0


def count_parameters(tensors):
    return sum(t.numel() for t in tensors)
