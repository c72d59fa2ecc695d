"""Utilities of the port. The tensor-fragment accessors are re-exported
here, as ``deepspeed.utils`` exports them, on first use (the modules they
need import ``utils.logging``)."""

_FRAGMENTS = ("param_names", "safe_get_full_fp32_param", "safe_get_full_grad",
              "safe_get_full_optimizer_state", "safe_get_local_fp32_param",
              "safe_get_local_grad", "safe_get_local_optimizer_state",
              "safe_set_full_fp32_param", "safe_set_full_optimizer_state")


def __getattr__(name):
    if name in _FRAGMENTS:
        from deepspeed_tpu_torch.utils import tensor_fragment
        return getattr(tensor_fragment, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
