"""Activation checkpointing (port of
``deepspeed_tpu/runtime/activation_checkpointing/checkpointing.py``).

The config's ``activation_checkpointing.policy`` picks what a decoder layer
saves for backward, as the JAX package's ``policy_by_name`` does:

- ``"everything"`` (the default): recompute everything — each layer runs under
  ``torch.utils.checkpoint(use_reentrant=False)``, which keeps only the
  layer's input and re-runs its forward (flash kernel included) in backward;
- ``"dots"``: save each projection's output and the attention output,
  recompute the elementwise work (JAX ``dots_with_no_batch_dims_saveable``
  plus the name ``flash_attn_out``). The layer runs under the same
  checkpoint with torch's selective-checkpoint contexts, whose policy
  saves every 2-D product (``aten.mm`` / ``aten.addmm``: a dot with no
  batch dimensions) and the flash forward's (out, lse) (the dispatcher op
  ``flash_fwd_op``), so the recomputation launches no forward kernel; a
  product with batch dimensions (``bmm``, the plain attention's) is
  recomputed;
- ``"nothing"``: no recomputation, every activation is saved.

``cpu_checkpointing`` (JAX ``offload_dot_with_no_batch_dims`` to pinned
host memory) keeps the 2-D products of a CUDA run in pinned host memory
instead (asynchronous copies out in the first pass, back in the
recomputation); the flash output stays on the device. It applies to every
policy but ``"nothing"``, which has nothing to offload, so
``"everything"`` with it runs as ``"dots"`` offloaded, as in the JAX
package.

``configure`` records the options globally; models read ``current_policy()``
when they run, as the JAX models read it at trace time.
``saves_for_backward()`` tells code running inside a forward whether autograd
keeps what it saves: not under ``no_grad``, nor in the first pass of a
checkpointed function (its recomputation in backward does keep it). ZeRO
stage 3 frees a layer's gathered parameters after a forward that keeps
nothing.
"""

import collections
import contextlib
import functools

import torch
import torch.utils.checkpoint
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.checkpoint import CheckpointPolicy, create_selective_checkpoint_contexts

from deepspeed_tpu_torch.ops.flash_attention import flash_fwd_op

_CONFIG = {"policy": "everything", "checkpoint_in_cpu": False}
_DISCARDING = [0]     # depth of first passes of checkpointed functions

POLICIES = ("everything", "dots", "nothing")
_DOTS = frozenset((torch.ops.aten.mm.default, torch.ops.aten.addmm.default))
_FLASH = flash_fwd_op._opoverload


def configure(deepspeed_config):
    """Record the ``activation_checkpointing`` section of a
    ``DeepSpeedConfig``; an unknown policy raises the JAX package's
    ``KeyError``."""
    ac = deepspeed_config.activation_checkpointing
    _CONFIG.update(policy=ac.policy, checkpoint_in_cpu=bool(ac.cpu_checkpointing))
    current_policy()


def current_policy():
    """The policy a layer runs under: the configured name, with
    ``cpu_checkpointing`` turning every recomputing policy into offloaded
    ``"dots"``."""
    name = _CONFIG["policy"]
    if name not in POLICIES:
        raise KeyError(name)
    if _CONFIG["checkpoint_in_cpu"] and name != "nothing":
        return "dots"
    return name


def _policy(saved, ctx, func, *args, **kwargs):
    return CheckpointPolicy.MUST_SAVE if func in saved else CheckpointPolicy.PREFER_RECOMPUTE


def _to_host(t):
    if not t.is_cuda:
        return t
    return torch.empty_like(t, device="cpu", pin_memory=True).copy_(t, non_blocking=True)


class _HostDots(TorchDispatchMode):
    """``cpu_checkpointing``: the first pass keeps each 2-D product's host
    copy; the recomputation takes them back in order instead of
    multiplying again."""

    def __init__(self, saved, replay):
        super().__init__()
        self.saved, self.replay = saved, replay

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func not in _DOTS:
            return func(*args, **kwargs)
        if self.replay:
            host, device = self.saved.popleft()
            return host.to(device, non_blocking=True)
        out = func(*args, **kwargs)
        self.saved.append((_to_host(out), out.device))
        return out


@contextlib.contextmanager
def _entered(*contexts):
    with contextlib.ExitStack() as stack:
        for c in contexts:
            stack.enter_context(c)
        yield


def _dots_contexts():
    """The two passes' contexts of a ``"dots"`` checkpoint: torch's
    selective checkpoint saving the flash output and the 2-D products.
    Offloaded, its policy leaves the products to be recomputed, so they
    reach ``_HostDots`` beneath it, which keeps them on the host."""
    if not _CONFIG["checkpoint_in_cpu"]:
        return create_selective_checkpoint_contexts(
            functools.partial(_policy, _DOTS | {_FLASH}))
    first, again = create_selective_checkpoint_contexts(functools.partial(_policy, {_FLASH}))
    saved = collections.deque()
    return (_entered(_HostDots(saved, replay=False), first),
            _entered(_HostDots(saved, replay=True), again))


def checkpoint(function, *args, **kwargs):
    """Run ``function(*args, **kwargs)`` under the configured policy: with
    ``"everything"`` or ``"dots"`` and gradients enabled, keep the inputs
    (and under ``"dots"`` the products and the flash output) and recompute the
    rest of the forward in backward."""
    policy = current_policy()
    if policy == "nothing" or not torch.is_grad_enabled():
        return function(*args, **kwargs)
    calls = [0]

    def run(*a, **k):
        calls[0] += 1
        if calls[0] > 1:            # the recomputation, in backward
            return function(*a, **k)
        _DISCARDING[0] += 1
        try:
            return function(*a, **k)
        finally:
            _DISCARDING[0] -= 1

    if policy == "dots":
        return torch.utils.checkpoint.checkpoint(run, *args, use_reentrant=False,
                                                 context_fn=_dots_contexts, **kwargs)
    return torch.utils.checkpoint.checkpoint(run, *args, use_reentrant=False, **kwargs)


def saves_for_backward():
    """Whether the forward running now keeps its saved tensors for a
    backward."""
    return torch.is_grad_enabled() and _DISCARDING[0] == 0


def reset():
    _CONFIG["policy"] = "everything"
    _CONFIG["checkpoint_in_cpu"] = False
