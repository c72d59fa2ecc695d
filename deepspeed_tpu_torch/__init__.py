"""deepspeed_tpu_torch — the PyTorch/CUDA port of ``deepspeed_tpu``.

The JAX package beside this one is the reference; each module here mirrors
its counterpart's path (``deepspeed_tpu_torch/inference/v2/engine_v2.py``
ports ``deepspeed_tpu/inference/v2/engine_v2.py``). This package imports
``torch`` and numpy, never ``jax`` or ``deepspeed_tpu``: what it needs from a
reference module it keeps as its own copy.

Entry points take ``device=`` and default to ``"cuda"``; with no GPU present
they raise unless the caller passes ``device="cpu"``. Every kernel the JAX
package wrote in Pallas becomes a hand-written Hopper kernel under
``csrc/``, built with ``nvcc`` at first use; on CPU tensors a kernel's
wrapper runs its plain PyTorch version.
"""

__version__ = "0.1.0"

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``device`` or, when None, CUDA.

    Raises when the device is CUDA and no GPU is present — a run asked for
    the card must never quietly land on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "port on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev
