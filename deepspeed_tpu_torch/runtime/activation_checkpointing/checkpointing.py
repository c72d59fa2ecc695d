"""Activation checkpointing (port of
``deepspeed_tpu/runtime/activation_checkpointing/checkpointing.py``).

The config's ``activation_checkpointing.policy`` picks what a decoder layer
saves for backward, as in the JAX package:

- ``"everything"`` (the default): recompute everything — each layer runs under
  ``torch.utils.checkpoint(use_reentrant=False)``, which keeps only the
  layer's input and re-runs its forward (flash kernel included) in backward;
- ``"nothing"``: no recomputation, every activation is saved.

``"dots"`` and ``cpu_checkpointing`` raise ``NotImplementedError``
(ROADMAP A1). ``configure`` records the options globally; models read
``current_policy()`` when they run, as the JAX models read it at trace time.
``saves_for_backward()`` tells code running inside a forward whether autograd
keeps what it saves: not under ``no_grad``, nor in the first pass of a
checkpointed function (its recomputation in backward does keep it). ZeRO
stage 3 frees a layer's gathered parameters after a forward that keeps
nothing.
"""

import torch
import torch.utils.checkpoint

_CONFIG = {"policy": "everything", "checkpoint_in_cpu": False}
_DISCARDING = [0]     # depth of first passes of checkpointed functions

POLICIES = ("everything", "nothing")


def configure(deepspeed_config):
    """Record the ``activation_checkpointing`` section of a
    ``DeepSpeedConfig``; raises for what the port cannot do."""
    ac = deepspeed_config.activation_checkpointing
    _CONFIG.update(policy=ac.policy, checkpoint_in_cpu=ac.cpu_checkpointing)
    current_policy()


def current_policy():
    """The configured policy name; raises for what the port cannot do."""
    if _CONFIG["checkpoint_in_cpu"]:
        raise NotImplementedError("activation_checkpointing.cpu_checkpointing "
                                  "is not ported yet: ROADMAP A1")
    if _CONFIG["policy"] not in POLICIES:
        raise NotImplementedError(
            f"activation_checkpointing.policy={_CONFIG['policy']!r} is not "
            f"ported yet (supported: {POLICIES}): ROADMAP A1")
    return _CONFIG["policy"]


def checkpoint(function, *args, **kwargs):
    """Run ``function(*args, **kwargs)`` under the configured policy: with
    ``"everything"`` and gradients enabled, keep only the inputs and recompute
    the forward in backward."""
    if current_policy() == "everything" and torch.is_grad_enabled():
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

        return torch.utils.checkpoint.checkpoint(run, *args,
                                                 use_reentrant=False, **kwargs)
    return function(*args, **kwargs)


def saves_for_backward():
    """Whether the forward running now keeps its saved tensors for a
    backward."""
    return torch.is_grad_enabled() and _DISCARDING[0] == 0


def reset():
    _CONFIG["policy"] = "everything"
    _CONFIG["checkpoint_in_cpu"] = False
