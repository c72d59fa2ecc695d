"""Partition-at-construction initialisation (port of
``deepspeed_tpu/runtime/zero/sharded_init.py``; the reference's
``zero.Init``).

A model built inside ``zero.Init`` is built on the ``meta`` device: its
parameters have shapes and dtypes and no storage. The engine
(``initialize``) then materialises one parameter at a time straight into
this rank's state: each leaf is drawn whole on the device from the
config's ``seed`` by the model's own init law (``model.init_parameter(name,
tensor, generator)``, one ``torch.Generator`` in parameter order, so the
values are bitwise those of ``Model.from_seed(config, seed)``), cut to this
rank's master chunk and working copy (freed to its stage-3 shard), and
dropped before the next is drawn. No rank's device holds more than its
ZeRO share plus one whole leaf, and no broadcast from rank 0 is needed:
every rank draws the same values. An expert slice is drawn as its whole
stack ``[E, ...]`` and cut to this rank's ``ep`` slice.

``abstract_params`` gives the meta model's ``{name: (shape, dtype)}``
without allocating; ``materialize_sharded`` the fp32 master pieces of a
rank (the JAX function's born-sharded tree), outside an engine.
"""

import torch
from torch import nn

from deepspeed_tpu_torch import resolve_device
from deepspeed_tpu_torch.moe.utils import expert_slice, moe_param_specs
from deepspeed_tpu_torch.utils.logging import log_dist


def is_meta(module):
    """Whether ``module`` was built under ``zero.Init`` (its parameters
    hold no storage)."""
    return any(p.is_meta for p in module.parameters())


def abstract_params(model):
    """``{name: (shape, dtype)}`` of a model's parameters, allocating
    nothing."""
    return {n: (tuple(p.shape), p.dtype) for n, p in model.named_parameters()}


def seeded_leaves(model, seed, device, ep_size=1, ep_rank=0):
    """Yield ``(name, parameter, value)`` in parameter order: ``value`` the
    parameter drawn whole on ``device`` in its own dtype by
    ``model.init_parameter`` from one ``torch.Generator(seed)`` (an expert
    slice of an ``ep_size`` > 1 model drawn as its whole stack and cut to
    ``ep_rank``'s slice). Only the leaf being yielded is alive."""
    law = getattr(model, "init_parameter", None)
    if law is None:
        raise ValueError(f"{type(model).__name__} has no init_parameter(name, tensor, "
                         f"generator): zero.Init cannot draw its parameters")
    device = resolve_device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    specs = moe_param_specs(model) if ep_size > 1 else {}
    with torch.no_grad():
        for name, p in model.named_parameters():
            if specs.get(name):
                whole = torch.empty((p.shape[0] * ep_size,) + tuple(p.shape[1:]),
                                    dtype=p.dtype, device=device)
                law(name, whole, gen)
                value = expert_slice(whole, ep_size, ep_rank).clone()
                del whole
            else:
                value = torch.empty(p.shape, dtype=p.dtype, device=device)
                law(name, value, gen)
            yield name, p, value
            del value


def replace_parameter(module, name, tensor):
    """Put ``tensor`` in place of the (meta) parameter ``name`` of
    ``module``; returns the new ``nn.Parameter``."""
    owner, _, attr = name.rpartition(".")
    mod = module.get_submodule(owner) if owner else module
    param = nn.Parameter(tensor, requires_grad=True)
    setattr(mod, attr, param)
    return param


def materialize_sharded(model, partitioner, seed, device=None):
    """This rank's fp32 master pieces of ``model`` (built under
    ``zero.Init``) by ``partitioner``'s rule: ``{name: flat chunk or whole
    tensor}``, one whole leaf alive at a time."""
    from deepspeed_tpu_torch.runtime.zero.partition import shard_of
    topo = partitioner.topology
    ep_rank = topo.get_axis_rank("ep") if topo.ep_size > 1 else 0
    specs = moe_param_specs(model, topo.ep_size)
    out = {}
    for name, p, value in seeded_leaves(model, seed, device, topo.ep_size, ep_rank):
        place = partitioner.placement(specs[name])
        full = value.float()
        dim = partitioner.master_dim(tuple(p.shape), place)
        out[name] = full if dim is None else shard_of(full, dim, place.world,
                                                      place.index).clone()
        del full
    n = sum(t.numel() for t in out.values())
    log_dist(f"zero.Init: materialized {n / 1e6:.2f}M master elements on this rank "
             f"(stage {partitioner.stage}, world {partitioner.zero_world})", ranks=[0])
    return out


class Init:
    """``deepspeed.zero.Init``: models built inside are built on the meta
    device, and ``initialize`` (or ``materialize``) draws their parameters
    born sharded from the config's ``seed``::

        with deepspeed_tpu_torch.zero.Init(config=ds_config):
            model = GPT2LMHeadModel(GPT2Config.large())
        engine, *_ = deepspeed_tpu_torch.initialize(model=model, config=ds_config)
    """

    def __init__(self, config=None, mesh=None, enabled=True):
        from deepspeed_tpu_torch.runtime.config import DeepSpeedConfig
        self.config = config if isinstance(config, DeepSpeedConfig) \
            else DeepSpeedConfig(config or {})
        self.mesh = mesh
        self.enabled = enabled
        self._device = None

    def __enter__(self):
        if self.enabled:
            self._device = torch.device("meta")
            self._device.__enter__()
        return self

    def __exit__(self, *exc):
        if self._device is not None:
            self._device.__exit__(*exc)
            self._device = None
        return False

    def materialize(self, model, device=None):
        """This rank's fp32 master pieces of ``model`` (``materialize_sharded``
        with this context's config, topology and seed)."""
        from deepspeed_tpu_torch.parallel import groups
        from deepspeed_tpu_torch.runtime.zero.partition import ZeroPartitioner
        topology = groups.initialize(mesh_topology=self.mesh, config=self.config)
        partitioner = ZeroPartitioner(topology, self.config.zero_config)
        return materialize_sharded(model, partitioner, self.config.seed, device)
