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


def initialize(args=None, model=None, optimizer=None, model_parameters=None,
               training_data=None, lr_scheduler=None, mpu=None, collate_fn=None,
               config=None, config_params=None, device=None, mesh=None):
    """Build the training engine (port of ``deepspeed_tpu.initialize``).

    Returns ``(engine, optimizer, training_dataloader, lr_scheduler)``.
    ``model`` is a ``torch.nn.Module`` whose ``forward(batch)`` returns the
    loss; ``model_parameters`` an optional state dict of initial fp32 values
    (by parameter name) that the engine's master copy starts from instead of
    the module's own; ``config`` a dict, a JSON path, or (with ``args``)
    ``args.deepspeed_config``; ``device`` the device to train on
    (``cuda:LOCAL_RANK`` by default); ``mesh`` a ``MeshTopology`` of the
    ranks (by default one built from the config over every rank). With
    WORLD_SIZE > 1 in the environment and no process group yet, it joins
    one (NCCL on CUDA, gloo on the CPU). Then ``loss = engine(batch);
    engine.backward(loss); engine.step()``, or
    ``engine.train_batch(data_iter)``, on every rank.
    """
    import os

    from deepspeed_tpu_torch.comm import comm as dist
    from deepspeed_tpu_torch.runtime.config import DeepSpeedConfig
    from deepspeed_tpu_torch.runtime.engine import DeepSpeedEngine

    if device is None:
        device = torch.device("cuda", dist.get_local_rank())
    if int(os.environ.get("WORLD_SIZE", "1")) > 1 and not dist.is_initialized():
        dist.init_distributed(
            dist_backend="nccl" if torch.device(device).type == "cuda" else "gloo")

    if config is None and config_params is not None:
        config = config_params
    if config is None and args is not None and hasattr(args, "deepspeed_config"):
        config = args.deepspeed_config
    if mpu is not None and int(mpu.get_model_parallel_world_size()) > 1:
        raise NotImplementedError("model parallelism through mpu is not ported "
                                  "yet: ROADMAP A12")
    config = config if isinstance(config, DeepSpeedConfig) else DeepSpeedConfig(config)
    engine = DeepSpeedEngine(config=config, model=model, optimizer=optimizer,
                             model_parameters=model_parameters,
                             training_data=training_data, lr_scheduler=lr_scheduler,
                             collate_fn=collate_fn, device=device, mesh=mesh)
    return engine, engine.optimizer, engine.training_dataloader, engine.lr_scheduler


def init_inference(model=None, config=None, params=None, device=None, **kwargs):
    """Build the v1 inference engine (port of ``deepspeed_tpu.init_inference``).

    ``model`` is a ``LlamaForCausalLM`` (or a module with its KV-cache
    contract), or None when ``config["checkpoint"]`` names a HuggingFace
    directory of the Llama family, whose model is then built; ``params`` a
    state dict of its parameters, or the JAX package's Llama parameter
    tree, converted through ``params_from_flax``;
    ``config`` a dict of ``DeepSpeedInferenceConfig`` keys, which ``kwargs``
    overlay; ``device`` the device to serve on (``cuda`` by default). Then
    ``engine(ids)`` gives logits and ``engine.generate(ids, ...)`` tokens."""
    from deepspeed_tpu_torch.inference.config import DeepSpeedInferenceConfig
    from deepspeed_tpu_torch.inference.engine import InferenceEngine
    from deepspeed_tpu_torch.models.llama import params_from_flax

    if isinstance(params, dict) and isinstance(params.get("layers"), dict):
        params = params_from_flax(params)
    cfg = DeepSpeedInferenceConfig.from_dict(config or {}, **kwargs)
    return InferenceEngine(model, cfg, params=params, device=device)


def __getattr__(name):
    # ``deepspeed_tpu_torch.zero``: ``deepspeed.zero`` (Init, the tiled
    # linears), imported on first use
    if name == "zero":
        import importlib
        return importlib.import_module("deepspeed_tpu_torch.runtime.zero")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def add_config_arguments(parser):
    """Add the DeepSpeed CLI flags to an argparse parser: ``--deepspeed`` and
    ``--deepspeed_config <json>``, which :func:`initialize` reads through
    ``args.deepspeed_config``."""
    import argparse
    group = parser.add_argument_group("DeepSpeed", "DeepSpeed configurations")
    group.add_argument("--deepspeed", default=False, action="store_true",
                       help="Enable DeepSpeed (helper flag for user scripts)")
    group.add_argument("--deepspeed_config", default=None, type=str,
                       help="DeepSpeed json configuration file.")
    group.add_argument("--deepscale", default=False, action="store_true",
                       help=argparse.SUPPRESS)
    return parser
