"""DeepSpeedEngine (port of ``deepspeed_tpu/runtime/engine.py``).

The engine trains one process's share of a data-parallel world over
``torch.distributed`` (a world of one needs no process group). It holds the
model's parameters in the working dtype (bf16, fp16 or fp32) inside the
module, an fp32 master copy and fp32 gradient accumulators
(``engine.py:434-555`` in the JAX package). As there, every floating
parameter is cast to the working dtype and gradients are taken with respect
to that working copy. ZeRO cuts the state along each leaf's shard dimension
(``zero/partition.py``):

- stage 0/1: each micro-step's gradients are added into whole local
  accumulators, all-reduced at the gradient-accumulation boundary;
- stage 1+: each rank runs Adam on its chunks of the master and moments,
  then the updated working chunks are all-gathered into the module;
- stage 2+: each micro-step's gradients are reduce-scattered into chunk
  accumulators as autograd produces them;
- stage 3: the working parameters are sharded at rest (their storage freed)
  and gathered one decoder layer at a time: a forward hook on each layer
  gathers before it runs, and frees after a forward that keeps nothing for
  backward (the first pass of a recomputed layer, or no-grad); the
  recomputation in backward gathers again, and each parameter is freed as
  soon as its gradient has been folded in;
- qgZ (``zero_quantized_gradients``, stage >= 2): local gradients are
  accumulated whole and exchanged quantized at the boundary
  (``QgzPlan.reduce``, ``engine.py:1176-1184``), with error feedback whose
  residual survives an overflow-skipped step (``:1193-1195``);
- qwZ (``zero_quantized_weights``, stage 3 under bf16/fp16,
  ``engine.py:457-515``, ``:768-805``): the working copy at rest is int8
  shards plus whole fp32 scales (``zero/qwz.py``), requantized from the
  masters after every step and load; a unit's gather moves the ints and
  dequantizes into the parameters' storage (kernel rows 5-6), and the
  gradients are taken with respect to the dequantized values;
- hpZ (``zero_hpz_partition_size``): the stage-3 working shards span the
  inner ``dp`` group; with qwZ the working copy stays in full precision and
  only the master -> working exchange moves int8 + scales (``hpz_exchange``,
  ``:1078-1102``), recorded in ``WIRE_BYTES`` as "hpz_primary_exchange";
- MiCS (``mics_shard_size``): every shard spans ``dp`` and is replicated
  across ``dpr``; gradients are reduced inside ``dp`` and all-reduced across
  ``dpr``, so they sum over the whole data-parallel world;
- the overlap schedule (``overlap.schedule``, ``:857-1175``): under qgZ the
  boundary exchange splits into ``grad_buckets`` byte-balanced buckets
  (``QgzPlan._bucketize``), each started as soon as the boundary
  micro-step's backward has folded its leaves (on a side stream under
  NCCL) and sent over coalesced calls; on a model with the streaming
  protocol (``streaming_plan``) at stage 3 each gather unit's pre-hook
  waits on its own gather and starts the next ``prefetch_depth`` units'
  as asynchronous collectives (forward order, reversed for the
  recomputation in backward). Both only move work: the results are
  bitwise those of the unscheduled step;
- expert parallelism (``expert_parallel_size`` or ``moe.ep_size`` > 1):
  the experts of each ``MOELayer`` built with that ``ep_size`` are this
  rank's slice of the stack (``moe/utils.moe_param_specs``). Their state is
  cut over the expert-data-parallel group (the ZeRO axes less ``ep``,
  ``zero/partition.py``) and their gradients reduced over it only: the
  dispatch's backward has already summed the ``ep`` peers' contributions.
  Dense gradients reduce over the whole data-parallel world, both with the
  same denominators, and the clipping norm counts each distinct shard once.

A module built under ``zero.Init`` (on the meta device) has each parameter
drawn from the config's ``seed`` straight into this rank's state
(``zero/sharded_init.py``), no broadcast. The optimizer is any name of the
JAX package's ``build_optimizer`` or a client ``torch.optim.Optimizer``;
its leaf-wide arithmetic reads the JAX twin's leaves (``jax_leaves``,
``zero/jax_layout.py``). ``train_batch`` runs a window without a host read
(fp16's overflow flag at the boundary aside), so JAX's ``fused_step`` is
accepted and changes nothing; ``set_train_batch_size`` rebases the window
(``_gas_offset``, carried by checkpoints).

Every gradient of ``engine.backward`` is folded into its accumulator by a
``register_post_accumulate_grad_hook`` as soon as autograd produces it, so
at most a layer's gradients exist at once; a backward run outside
``engine.backward`` leaves ``.grad`` to its caller.

Loss and gradients are those of the JAX engine's loss over the global
batch. The JAX engine sees the whole global micro-batch; here each rank sees
``train_micro_batch_size_per_gpu`` rows of it, so ``forward`` all-reduces
the loss and the sum over ranks is divided by the world at the boundary.
A module whose loss is a mean over a data-dependent count (masked tokens)
returns ``(loss, {"num_valid_tokens": n})``: the ranks are then weighted by
their counts, which gives the global mean where ranks hold different
numbers of valid tokens. Under qgZ the loss is the mean of the ranks'
losses, as in the JAX qgZ engine (``:921``).

- ``forward(batch)`` runs the module and returns the loss with its graph;
- ``backward(loss)`` runs autograd on the (loss-scaled) loss;
- ``step()`` at the boundary reduces the gradients, unscales them, skips the
  step on fp16 overflow (any rank's), clips by the global norm, runs the
  optimizer on this rank's masters, updates the working copy and the loss
  scale (``engine.py:1106-1147``);
- ``save_checkpoint`` / ``load_checkpoint`` (``engine.py:2214-2444``): every
  rank writes its own state (``state_dict``: working copy at rest, masters,
  Adam's moments, accumulators, qgZ residual) into one tag
  (``checkpoint_engine/native_engine.py``), with the counters, loss scale,
  LR scheduler and client state; a load verifies the tag, quarantines a
  corrupt one to ``<tag>.corrupt`` and falls back to the newest earlier
  valid tag. A tag loads only into the world size, topology and ZeRO stage
  it was cut for (other layouts: universal checkpoints, ROADMAP A15);
- ``save_16bit_model`` / ``load_hf_weights`` (``engine.py:2456-2510``):
  the gathered fp32 masters written as a HuggingFace export
  (``checkpoint/hf.py``; fp16 kept, bf16 widened to fp32), an npz for a
  model no converter covers; and an HF directory's weights loaded into the
  masters and the working copy.
"""

import os
import re
import weakref
from typing import Any, NamedTuple

import torch
from torch import nn

from deepspeed_tpu_torch import resolve_device
from deepspeed_tpu_torch.comm import comm as dist
from deepspeed_tpu_torch.moe.utils import moe_param_specs
from deepspeed_tpu_torch.ops.adam import STATE_ALIASES, build_optimizer, set_lr
from deepspeed_tpu_torch.parallel import groups
from deepspeed_tpu_torch.runtime.activation_checkpointing import checkpointing
from deepspeed_tpu_torch.runtime.checkpoint_engine.native_engine import (
    CorruptCheckpointError, NativeCheckpointEngine, atomic_write_text)
from deepspeed_tpu_torch.runtime.config import DeepSpeedConfig
from deepspeed_tpu_torch.runtime.dataloader import (DeepSpeedDataLoader, PrefetchLoader,
                                                    RepeatingLoader)
from deepspeed_tpu_torch.runtime.fp16.loss_scaler import (LossScaleState,
                                                          init_loss_scale_state,
                                                          update_loss_scale)
from deepspeed_tpu_torch.runtime.lr_schedules import LRSchedulerShim, get_lr_schedule
from deepspeed_tpu_torch.runtime.utils import (clip_grads_by_global_norm, global_norm,
                                               has_overflow)
from deepspeed_tpu_torch.runtime.comm.coalesced_collectives import record_exchange
from deepspeed_tpu_torch.runtime.zero import qwz, sharded_init
from deepspeed_tpu_torch.runtime.zero.jax_layout import build_layout
from deepspeed_tpu_torch.runtime.zero.partition import (ZeroPartitioner, alloc_storage,
                                                        free_storage, gather_full,
                                                        is_resident, moved_shape, shard_of)
from deepspeed_tpu_torch.utils.logging import log_dist, logger

_DTYPES = {None: torch.float32, "fp32": torch.float32, "fp16": torch.float16,
           "bf16": torch.bfloat16}


class StepStats(NamedTuple):
    grad_norm: Any        # 0-d fp32 tensor on the engine's device
    lr: float


class _Leaf:
    """One parameter's state on this rank. ``master``, the optimizer's
    moments and a sharded ``acc`` are flat chunks in the partitioner's
    layout (``shard_of``) or whole tensors; ``shard`` is the stage-3
    working chunk; ``place`` the groups they are cut over
    (``partition.Placement``)."""

    def __init__(self, name, param):
        self.name = name
        self.param = param
        self.shape = tuple(param.shape)
        self.master_dim = self.grad_dim = self.param_dim = None
        self.master = self.acc = self.shard = self.place = None
        # qwZ: ``shard`` holds int8 (the whole leaf's where it is not cut)
        # and ``qscale`` the whole JAX scales, grouped along ``qaxis``
        # (``qwz.jax_leaves``); hpZ + qwZ: ``hpz`` marks a leaf whose
        # master -> working exchange moves int8
        self.quant = self.hpz = False
        self.qscale = None
        self.qaxis = -1


class _ReportedLoss(torch.autograd.Function):
    """Value: the loss over the global batch. Gradient: to this rank's
    weighted local loss, whose sum over ranks is the world times the
    global loss's."""

    @staticmethod
    def forward(ctx, local, reported):
        return reported.clone()

    @staticmethod
    def backward(ctx, g):
        return g, None


def _call(engine_ref, method, *args):
    """Run ``method`` of the engine behind a weak reference, if it lives."""
    engine = engine_ref()
    if engine is not None:
        getattr(engine, method)(*args)


class DeepSpeedEngine:

    def __init__(self, config=None, model=None, optimizer=None,
                 model_parameters=None, training_data=None, lr_scheduler=None,
                 collate_fn=None, device=None, mesh=None):
        self.config = config if isinstance(config, DeepSpeedConfig) else DeepSpeedConfig(config)
        zc = self.config.zero_config
        if zc.cpu_offload or zc.offload_optimizer_device in ("cpu", "nvme"):
            if zc.zero_quantized_weights:
                raise ValueError("zero_quantized_weights cannot be combined with "
                                 "offload_optimizer")
            if zc.zero_quantized_gradients:
                raise ValueError("zero_quantized_gradients cannot be combined "
                                 "with offload_optimizer")
        self.config.check_supported()
        if not isinstance(model, nn.Module):
            raise ValueError("deepspeed_tpu_torch.initialize requires a torch.nn.Module "
                             f"model whose forward(batch) returns the loss, got {type(model)}")
        self.module = model
        self.device = resolve_device(device)

        # --- topology: the rank grid, its groups and the ZeRO partition ---
        self.topology = groups.initialize(mesh_topology=mesh, config=self.config)
        if self.topology.tp_size > 1:
            raise NotImplementedError(
                f"training over a tp axis of size {self.topology.tp_size} is not ported "
                "to deepspeed_tpu_torch yet: ROADMAP A12 (tensor parallelism); the tp "
                "axis serves inference only")
        self.partitioner = ZeroPartitioner(self.topology, self.config.zero_config)
        self.zero_group = self.partitioner.zero_group
        # the data-parallel world: the batch's split and every gradient's sum
        # (larger than the ZeRO group under MiCS)
        self.data_group, self.dp_world, self.dp_rank = \
            self.topology.axes_group(self.topology.data_axes)
        stage = self.zero_optimization_stage()

        tb, mb, gas = self.config.resolve_batch_params(self.topology.data_parallel_size)
        self.train_batch_size_value = tb
        self.micro_batch_size = mb
        self.gradient_accumulation_steps_value = gas

        # --- precision ---
        self.fp16_enabled = bool(self.config.fp16.enabled)
        self.bf16_enabled = bool(self.config.bf16.enabled)
        self.working_dtype = (torch.float16 if self.fp16_enabled else
                              torch.bfloat16 if self.bf16_enabled else torch.float32)
        self.mixed_precision = self.working_dtype != torch.float32
        self.dynamic_loss_scale = self.fp16_enabled and not (self.config.fp16.loss_scale > 0)
        self.grad_accum_dtype = _DTYPES[self.config.data_types.grad_accum_dtype]

        # --- qwZ (ZeRO++ quantized weights): int8 working copy at stage 3;
        # under hpZ the working copy stays full precision and only the
        # primary master -> working exchange is quantized ---
        qwz_on = bool(zc.zero_quantized_weights and stage >= 3)
        self._qwz_hpz = qwz_on and self.topology.zero_hierarchy == "hpz"
        self.quantized_weights = qwz_on and not self._qwz_hpz
        if qwz_on and not self.mixed_precision:
            raise ValueError("zero_quantized_weights requires fp16/bf16 training "
                             "(the fp32 master holds full precision)")

        # --- qgZ (ZeRO++ quantized gradients) ---
        self._qgz = None
        self._qgz_feedback = False
        if zc.zero_quantized_gradients:
            if stage < 2:
                raise ValueError("zero_quantized_gradients requires ZeRO stage >= 2 "
                                 "(gradients must be partitioned)")
            if self.quantized_weights:
                raise ValueError(
                    "zero_quantized_gradients + zero_quantized_weights "
                    "requires a secondary parameter partition: set "
                    "zero_hpz_partition_size > 1 (ZeRO++ hpZ)")
            from deepspeed_tpu_torch.runtime.zero.qgz import QgzPlan
            self._qgz = QgzPlan(self.topology)
            self._qgz_feedback = bool(zc.zero_quantized_gradients_error_feedback)

        # --- the overlap schedule: grad buckets under qgZ, and the gather
        # units' prefetch on a model with the streaming protocol ---
        ov = self.config.overlap_config
        self._grad_buckets = max(int(ov.grad_buckets), 1) \
            if ov.schedule and self._qgz is not None else 1
        self._prefetch_depth = max(int(ov.prefetch_depth), 0) \
            if self._overlap_streaming_ready() else 0

        # --- parameters: fp32 master, working copy in the module ---
        self._init_parameters(model_parameters)
        self._folding = False          # inside engine.backward: hooks fold gradients
        self._in_backward = False      # prefetch order: the recomputation's
        self._pending = {}             # unit -> [(leaf, buffer, handle)] in flight
        self.prefetched_units = 0      # gathers the schedule started ahead of use
        self._register_hooks()
        self._bucket_idxs = self._bucket_left = None
        self._bucket_done = {}
        self._side_stream = None
        if self._grad_buckets > 1:
            self._bucket_idxs = self._qgz.buckets_of([leaf.acc for leaf in self._leaves],
                                                     self._grad_buckets)
            self._bucket_of = {j: b for b, idxs in enumerate(self._bucket_idxs) for j in idxs}
            log_dist(f"overlap.schedule on: prefetch_depth={self._prefetch_depth} "
                     f"grad_buckets={len(self._bucket_idxs)} over {len(self._units)} "
                     f"gather units", ranks=[0])

        # --- optimizer: a name, a client optimizer, or the config's ---
        opt_cfg = self.config.optimizer
        self.jax_leaves = build_layout(self._leaves, self.module, self.topology)
        self._client_optimizer = optimizer is not None and not isinstance(optimizer, str)
        if self._client_optimizer:
            self.optimizer = self._client(optimizer)
            self._base_lr = opt_cfg.params.get("lr", 1e-3)
        else:
            name = optimizer if isinstance(optimizer, str) else opt_cfg.type
            self.optimizer, self._base_lr = build_optimizer(
                name, opt_cfg.params, [leaf.master for leaf in self._leaves],
                layout=self.jax_leaves)

        # --- LR schedule: a name, a callable step -> lr, or the config's ---
        if lr_scheduler is not None and not isinstance(lr_scheduler, str):
            if not callable(lr_scheduler):
                raise ValueError("client lr_scheduler must be callable: step -> lr")
            self._schedule_fn = lr_scheduler
        else:
            sched = lr_scheduler if isinstance(lr_scheduler, str) else self.config.scheduler.type
            self._schedule_fn = get_lr_schedule(sched, self.config.scheduler.params,
                                                base_lr=opt_cfg.params.get("lr", self._base_lr))
        self.lr_scheduler = LRSchedulerShim(self._schedule_fn, engine=self)

        self.training_dataloader = None
        if training_data is not None:
            self.training_dataloader = DeepSpeedDataLoader(
                training_data, batch_size=mb, collate_fn=collate_fn,
                dp_rank=self.dp_rank, dp_world=self.dp_world)
            if self.config.prefetch_batches:
                # a worker thread assembles the next batches and copies them
                # to the device on a side stream while the step computes
                self.training_dataloader = PrefetchLoader(
                    self.training_dataloader, device=self.device,
                    depth=self.config.prefetch_batches)

        checkpointing.configure(deepspeed_config=self.config)

        self.scale = init_loss_scale_state(self.config.fp16) if self.fp16_enabled \
            else LossScaleState(1.0, 0, 0)
        self.global_steps = 0
        self.global_samples = 0
        self.micro_steps = 0
        self._gas_offset = 0          # the window's rebase after set_train_batch_size
        self._skipped = 0
        self._step_applied = False
        self._last_stats = None
        self._staged_loss = None
        self._data_iterator = None
        n = sum(leaf.param.numel() for leaf in self._leaves)
        log_dist(f"DeepSpeedEngine: device={self.device} dtype={self.working_dtype} "
                 f"batch=({tb},{mb},{gas}) world={self.dp_world} zero_stage={stage} "
                 f"qgz={self._qgz is not None} qwz={qwz_on} "
                 f"hierarchy={self.topology.zero_hierarchy} parameters={n / 1e6:.2f}M",
                 ranks=[0])

    def _client(self, optimizer):
        """A client optimizer over the masters (JAX ``engine.py:229-247``,
        where an optax transformation or a factory of one is taken): a
        ``torch.optim.Optimizer`` class or a callable ``params -> Optimizer``
        is called on the masters; an ``Optimizer`` built over the module's
        parameters is rebound to their masters group by group, each group's
        hyperparameters kept. A ``LeafOptimizer`` (``ops/adam.py``) is given
        the JAX leaves."""
        masters = [leaf.master for leaf in self._leaves]
        if isinstance(optimizer, torch.optim.Optimizer):
            master_of = {id(leaf.param): leaf.master for leaf in self._leaves}
            for group in optimizer.param_groups:
                try:
                    group["params"] = [master_of[id(p)] for p in group["params"]]
                except KeyError:
                    raise ValueError("the client optimizer holds a tensor that is not a "
                                     "parameter of the model") from None
            optimizer.state.clear()
            opt = optimizer
        elif callable(optimizer):
            opt = optimizer(masters)
        else:
            opt = None
        if not isinstance(opt, torch.optim.Optimizer):
            raise ValueError(
                "client optimizer must be a torch.optim.Optimizer or a "
                f"factory returning one, got {type(optimizer)}")
        if hasattr(opt, "set_layout"):
            opt.set_layout(self.jax_leaves)
        return opt

    def _overlap_streaming_ready(self):
        """Can the overlap schedule's prefetch leg run (JAX ``:857-884``)?
        It needs qgZ and a model with the streaming protocol; the bucketed
        exchange applies regardless."""
        if not (self.config.overlap_config.schedule and self._qgz is not None):
            return False
        plan = getattr(self.module, "streaming_plan", None)
        ok = callable(plan) and bool(plan())
        if not ok:
            logger.warning(
                "overlap.schedule: param prefetch disabled — model lacks the "
                "streaming protocol (streaming_plan/streaming_split/"
                "streaming_apply) or a compression transform is active; the "
                "bucketized grad exchange still applies")
        return ok

    # ------------------------------------------------------------------
    # state layout
    # ------------------------------------------------------------------
    def _init_parameters(self, model_parameters):
        """Per parameter, one at a time (so at most one whole fp32 copy
        exists): the fp32 value from ``model_parameters`` (a state dict of
        tensors or arrays, by name) or the module, made equal on every rank
        by a broadcast from rank 0 (reference ``_broadcast_model``), then
        this rank's master (chunk or whole), the working copy in the module
        (freed to its stage-3 chunk) and the gradient accumulator. A module
        built under ``zero.Init`` (on the meta device) has each parameter
        drawn whole from the config's ``seed`` by its own init law
        (``zero/sharded_init.py``), the same on every rank, so nothing is
        broadcast."""
        named = list(self.module.named_parameters())
        src = dict(model_parameters or {})
        unknown = set(src) - {n for n, _ in named}
        if unknown:
            raise ValueError(f"model_parameters names no parameter of the model: "
                             f"{sorted(unknown)[:5]}")
        part = self.partitioner
        qgz = self._qgz is not None
        specs = moe_param_specs(self.module, self.topology.ep_size)
        self._leaves = []
        twins = qwz.jax_leaves(self.module)
        drawn = sharded_init.is_meta(self.module) and not src
        if drawn:
            ep = self.topology.ep_size
            source = sharded_init.seeded_leaves(
                self.module, self.config.seed, self.device, ep,
                self.topology.get_axis_rank("ep") if ep > 1 else 0)
        else:
            source = ((n, p, src.get(n, p.detach())) for n, p in named)
        with torch.no_grad():
            for n, p, value in source:
                # a drawn leaf stays in its own dtype (exact in fp32), so it
                # and the working copy are all that is alive beside the
                # share: one fp32 leaf's bytes at most
                full = value if drawn else torch.as_tensor(value).to(
                    device=self.device, dtype=torch.float32, copy=True)
                del value
                if tuple(full.shape) != tuple(p.shape):
                    raise ValueError(f"{n}: model_parameters shape {tuple(full.shape)} != "
                                     f"{tuple(p.shape)}")
                if p.is_meta:
                    p = sharded_init.replace_parameter(self.module, n,
                                                       full.to(self.working_dtype))
                leaf = _Leaf(n, p)
                leaf.place = place = part.placement(specs[n])
                if not drawn:
                    self._broadcast_initial(full, place)
                W = place.world
                leaf.master_dim = part.master_dim(leaf.shape, place)
                leaf.grad_dim = part.grad_dim(leaf.shape, place)
                leaf.param_dim = part.param_dim(leaf.shape, place)
                threshold = self.config.zero_config.stage3_param_persistence_threshold
                leaf.qaxis, jshape = twins.get(n, (-1, leaf.shape))
                quantizable = qwz.should_quantize(jshape, p.dtype, threshold)
                leaf.quant = self.quantized_weights and quantizable
                leaf.hpz = self._qwz_hpz and quantizable
                if not drawn:
                    p.data = full.to(self.working_dtype, copy=True)
                p.requires_grad_(True)
                if leaf.master_dim is not None:
                    leaf.master = shard_of(full, leaf.master_dim, W, place.index).to(
                        torch.float32, copy=True)
                elif self.mixed_precision or part.stage >= 1:
                    leaf.master = full.to(torch.float32, copy=drawn)
                else:
                    leaf.master = p       # stage 0 in fp32: Adam updates the module
                if leaf.quant:
                    self._quantize_whole(leaf, p.data)
                elif leaf.param_dim is not None:
                    leaf.shard = self._working_shard(leaf, full)
                    free_storage(p.data)
                del full
                whole = qgz or leaf.grad_dim is None
                leaf.acc = torch.zeros(
                    leaf.shape if whole else (p.numel() // W,),
                    dtype=self.grad_accum_dtype, device=self.device)
                self._leaves.append(leaf)
        self._residual = None
        if self._qgz_feedback:
            # fp32 whatever grad_accum_dtype is: the carry is the small
            # difference the wire format dropped
            self._residual = [torch.zeros(leaf.shape, dtype=torch.float32,
                                          device=self.device) for leaf in self._leaves]
        part.describe([leaf.shape for leaf in self._leaves])

    @staticmethod
    def _broadcast_initial(full, place):
        """Make a leaf's initial value equal on the ranks that hold it: rank
        0's over the world for a dense leaf (reference ``_broadcast_model``),
        the first rank's of its expert-data group for an expert slice."""
        if not place.expert:
            dist.broadcast(full, src=0, group=None)
        elif place.world > 1:
            src = 0 if place.group is None else \
                torch.distributed.get_process_group_ranks(place.group)[0]
            dist.broadcast(full, src=src, group=place.group)

    def _quantize_whole(self, leaf, working):
        """qwZ's working copy from the whole working-precision value
        ``working`` (the module's storage): the int8 chunk (or whole leaf)
        and the whole scales; the module keeps the dequantized value where
        the leaf is not cut, and frees its storage where it is."""
        q, leaf.qscale = qwz.quantize_leaf(working, leaf.qaxis)
        place = leaf.place
        if leaf.param_dim is None:
            leaf.shard = q.contiguous()
            qwz.dequantize_leaf(leaf.shard, leaf.qscale, self.working_dtype, out=working,
                                axis=leaf.qaxis)
        else:
            leaf.shard = shard_of(q, leaf.param_dim, place.param_world,
                                  place.param_index).clone()
            free_storage(working)

    def _working_shard(self, leaf, full):
        """The stage-3 working chunk of ``full`` (a whole value, fp32 or as
        drawn). It is the master chunk itself where both have the same cut
        and dtype."""
        place = leaf.place
        if (leaf.param_dim == leaf.master_dim and place.param_world == place.world
                and not self.mixed_precision):
            return leaf.master
        return shard_of(full, leaf.param_dim, place.param_world,
                        place.param_index).to(self.working_dtype, copy=True)

    # ------------------------------------------------------------------
    # hooks: gradients folded in as produced; stage-3 gather and release
    # ------------------------------------------------------------------
    def _register_hooks(self):
        """The hooks hold the engine weakly: a tensor's gradient hooks live
        in autograd's C++ state, where Python's collector cannot see a cycle
        back to the engine, so a strong reference would keep the engine and
        its state alive for as long as the module."""
        me = weakref.ref(self)
        for i, leaf in enumerate(self._leaves):
            leaf.param.register_post_accumulate_grad_hook(
                lambda p, _i=i: _call(me, "_grad_hook", _i, p))
        self._units = []
        if not any(leaf.param_dim is not None for leaf in self._leaves):
            return
        # gather units: every child of a ModuleList (the decoder layers) and
        # the root for the parameters outside them
        by_param = {id(leaf.param): leaf for leaf in self._leaves
                    if leaf.param_dim is not None}
        in_units = set()
        for mod in self.module.modules():
            if isinstance(mod, nn.ModuleList):
                for child in mod:
                    if any(id(p) in in_units for p in child.parameters()):
                        continue
                    unit = [by_param[id(p)] for p in child.parameters() if id(p) in by_param]
                    in_units.update(id(p) for p in child.parameters())
                    if unit:
                        self._units.append((child, unit))
        rest = [leaf for pid, leaf in by_param.items() if pid not in in_units]
        if rest:
            self._units.append((self.module, rest))
        for u, (mod, _) in enumerate(self._units):
            mod.register_forward_pre_hook(lambda m, a, _u=u: _call(me, "_gather", _u))
            mod.register_forward_hook(
                lambda m, a, out, _u=u: _call(me, "_release_after_forward", _u))
        # prefetch order: the root's pre-hook runs before the layers'; the
        # recomputation in backward runs the layers in reverse
        layers = list(range(len(self._units) - (1 if rest else 0)))
        fwd = ([len(self._units) - 1] if rest else []) + layers
        self._next_units = {"forward": {u: fwd[k + 1:] for k, u in enumerate(fwd)},
                            "backward": {u: layers[:k][::-1] for k, u in enumerate(layers)}}

    def _gather(self, u):
        """A unit's forward pre-hook: its gather, waited on where the
        schedule started it earlier; then, under the schedule, the next
        ``prefetch_depth`` units' gathers started asynchronously."""
        with torch.no_grad():
            self._finish_unit(u)
            if self._prefetch_depth:
                nxt = self._next_units["backward" if self._in_backward else "forward"][u]
                for v in nxt[:self._prefetch_depth]:
                    if v not in self._pending:
                        self._start_unit(v)
                        self.prefetched_units += 1

    def _start_unit(self, u):
        if u in self._pending:
            return
        started = []
        for leaf in self._units[u][1]:
            if not is_resident(leaf.param.data):
                started.append(self._start_gather(leaf))
        self._pending[u] = started

    def _finish_unit(self, u):
        if u not in self._pending:
            self._start_unit(u)
        for job in self._pending.pop(u):
            self._finish_gather(*job)

    def _start_gather(self, leaf):
        """Give ``leaf``'s parameter its storage and start gathering its
        working shards (int8 under qwZ) over its parameter group."""
        p, place = leaf.param, leaf.place
        alloc_storage(p.data)
        src = leaf.shard
        if not leaf.quant and leaf.param_dim == 0 and p.data.is_contiguous():
            buf = p.data.view(-1)
        else:
            buf = torch.empty(place.param_world * src.numel(), dtype=src.dtype,
                              device=src.device)
        return leaf, buf, dist.all_gather_start(src, buf, group=place.param_group)

    def _finish_gather(self, leaf, buf, handle):
        """Wait for a gather started by ``_start_gather`` (the current
        stream waits under NCCL) and lay it into the parameter's storage,
        dequantized under qwZ."""
        if handle is not None:
            handle.wait()
        p = leaf.param
        if buf.data_ptr() == p.data.data_ptr():
            return
        full = buf.view(moved_shape(leaf.shape, leaf.param_dim)).movedim(0, leaf.param_dim)
        if not leaf.quant:
            p.data.copy_(full)
            return
        qwz.dequantize_leaf(full, leaf.qscale, self.working_dtype, out=p.data, axis=leaf.qaxis)
        W = leaf.place.param_world
        record_exchange("qwz_all_gather", p.numel() * p.element_size() * (W - 1) // W,
                        p.numel() * (W - 1) // W)

    def _release_after_forward(self, u):
        if not checkpointing.saves_for_backward():
            for leaf in self._units[u][1]:
                free_storage(leaf.param.data)

    def _release_all(self):
        for u in list(self._pending):    # gathers in flight land before the free
            for job in self._pending.pop(u):
                self._finish_gather(*job)
        for leaf in self._leaves:
            if leaf.param_dim is not None:
                free_storage(leaf.param.data)

    def _grad_hook(self, i, p):
        if not self._folding:
            return
        leaf = self._leaves[i]
        g = p.grad
        p.grad = None
        with torch.no_grad():
            self._fold(leaf, g)
        if leaf.param_dim is not None:
            free_storage(p.data)
        if self._bucket_left is not None:
            b = self._bucket_of[i]
            self._bucket_left[b].discard(i)
            if not self._bucket_left[b]:
                self._start_bucket(b)

    def _fold(self, leaf, g):
        """Add one micro-step's gradient into the leaf's accumulator:
        reduce-scattered into its chunk at stage >= 2 (without qgZ), else
        whole and local."""
        if leaf.acc.shape == g.shape:
            leaf.acc.add_(g)
            return
        place = leaf.place
        moved = g.movedim(leaf.grad_dim, 0).reshape(place.world, -1).to(self.grad_accum_dtype)
        chunk = dist.reduce_scatter(moved.reshape(-1), group=place.group)
        if place.replica_world > 1:           # MiCS: the sum spans every replica group
            dist.all_reduce(chunk, group=place.replica_group)
        leaf.acc.add_(chunk)

    # ------------------------------------------------------------------
    # the overlap schedule's grad buckets
    # ------------------------------------------------------------------
    def _start_bucket(self, b):
        """Exchange bucket ``b`` of the boundary micro-step's accumulators
        now that backward has folded its leaves: on a side stream under NCCL
        (the exchange overlaps the rest of backward), in line otherwise."""
        idxs = self._bucket_idxs[b]
        acc = [self._leaves[j].acc for j in idxs]
        res = None if self._residual is None else [self._residual[j] for j in idxs]
        run = lambda: self._qgz.reduce_bucket(acc, res, return_residual=res is not None)
        if self.device.type == "cuda" and dist.is_initialized() \
                and torch.distributed.get_backend() == "nccl":
            if self._side_stream is None:
                self._side_stream = torch.cuda.Stream(self.device)
            self._side_stream.wait_stream(torch.cuda.current_stream(self.device))
            with torch.cuda.stream(self._side_stream):
                self._bucket_done[b] = run()
        else:
            self._bucket_done[b] = run()

    def _bucketed_grads(self):
        """Every bucket's exchange (those backward did not start, now), in
        leaf order: ``(grads, residual')``."""
        n = len(self._leaves)
        grads, errs = [None] * n, [None] * n
        for b in range(len(self._bucket_idxs)):
            if b not in self._bucket_done:
                self._start_bucket(b)
        if self._side_stream is not None:
            cur = torch.cuda.current_stream(self.device)
            cur.wait_stream(self._side_stream)
        for b, idxs in enumerate(self._bucket_idxs):
            got = self._bucket_done.pop(b)
            got, got_err = got if self._residual is not None else (got, [None] * len(idxs))
            for j, g, e in zip(idxs, got, got_err):
                if self._side_stream is not None:
                    for t in (g, e):
                        if t is not None:
                            t.record_stream(cur)
                grads[j], errs[j] = g, e
        self._bucket_left = None
        return grads, (errs if self._residual is not None else None)

    # ------------------------------------------------------------------
    # training API
    # ------------------------------------------------------------------
    def _to_device(self, batch):
        if isinstance(batch, dict):
            return {k: self._to_device(v) for k, v in batch.items()}
        if isinstance(batch, (tuple, list)):
            return type(batch)(self._to_device(v) for v in batch)
        return torch.as_tensor(batch).to(self.device, non_blocking=True)

    def forward(self, batch):
        """Run the module on this rank's ``batch`` and return the loss over
        the global batch, with the graph of this rank's share of it."""
        self.module.train()
        out = self.module(self._to_device(batch))
        count = None
        if isinstance(out, tuple):
            loss = out[0]
            if len(out) > 1 and isinstance(out[1], dict):
                count = out[1].get("num_valid_tokens")
        else:
            loss = out
        if self.dp_world > 1:
            loss = self._global_loss(loss, count)
        self._staged_loss = loss
        return loss

    __call__ = forward

    def _global_loss(self, loss, count):
        """All-reduce the loss over the data-parallel world. Rank r's share
        is ``loss_r * c_r * W / sum(c)`` (``c`` the valid-token counts, 1
        without them or under qgZ), so the sum of the ranks' gradients is W
        times the global mean's; the boundary divides by W."""
        W = self.dp_world
        if count is None or self._qgz is not None:
            c = torch.ones((), device=loss.device)
        else:
            c = torch.as_tensor(count, device=loss.device).float()
        stats = torch.stack([loss.detach().float() * c, c])
        dist.all_reduce(stats, group=self.data_group)
        share = loss * (c * W / stats[1]).to(loss.dtype)
        return _ReportedLoss.apply(share, (stats[0] / stats[1]).to(loss.dtype))

    def backward(self, loss=None, retain_graph=False):
        """Backpropagate ``loss`` (default: the last forward's), scaled for
        fp16; the hooks fold every gradient into its accumulator."""
        if loss is None:
            loss = self._staged_loss
        if loss is None:
            raise RuntimeError("backward() called before forward()")
        scaled = loss.float()
        if self.fp16_enabled:
            scaled = scaled * self.scale.loss_scale
        predivide = self.config.gradient_predivide_factor
        if self.config.prescale_gradients and predivide != 1.0:
            scaled = scaled / predivide
        if self._bucket_idxs is not None and self.is_gradient_accumulation_boundary():
            self._bucket_left = [set(idxs) for idxs in self._bucket_idxs]
            self._bucket_done = {}
        self._folding = self._in_backward = True
        try:
            scaled.backward(retain_graph=retain_graph)
        finally:
            self._folding = self._in_backward = False
        self._staged_loss = None
        return loss

    def is_gradient_accumulation_boundary(self):
        """JAX ``engine.py:1696-1698``: ``_gas_offset`` rebases the window
        after ``set_train_batch_size``."""
        rel = self.micro_steps - self._gas_offset
        return (rel + 1) % self.gradient_accumulation_steps_value == 0

    def set_train_batch_size(self, train_batch_size):
        """Change the global batch size through the gradient-accumulation
        steps, the micro-batch size untouched (JAX ``engine.py:2086-2118``).
        Only at a window's boundary: mid-window raises ``RuntimeError``."""
        rel = self.micro_steps - self._gas_offset
        if rel % self.gradient_accumulation_steps_value != 0:
            raise RuntimeError(
                "set_train_batch_size mid-accumulation-window: call it only "
                "right after step() completed a window")
        mbs, dp = self.micro_batch_size, self.dp_world
        if train_batch_size % (mbs * dp) != 0:
            raise ValueError(f"train_batch_size {train_batch_size} not divisible by "
                             f"micro_batch ({mbs}) x dp ({dp})")
        self.gradient_accumulation_steps_value = train_batch_size // (mbs * dp)
        self.train_batch_size_value = train_batch_size
        self.config.train_batch_size = train_batch_size
        self.config.gradient_accumulation_steps = self.gradient_accumulation_steps_value
        self._gas_offset = self.micro_steps

    def step(self):
        """Optimizer step at the gradient-accumulation boundary."""
        self._step_applied = False
        if self.is_gradient_accumulation_boundary():
            self._last_stats = self._apply_step(float(self._schedule_fn(self.global_steps)))
            self._step_applied = True
            self.global_steps += 1
            self.lr_scheduler.step()
            if self.global_steps % self.config.steps_per_print == 0:
                log_dist(f"step={self.global_steps}, skipped={self._skipped}, "
                         f"lr={self._last_stats.lr}, loss_scale={self.scale.loss_scale}",
                         ranks=[0])
        self.micro_steps += 1
        self.global_samples += self.micro_batch_size * self.dp_world

    def _reduced_grads(self):
        """Per leaf, this rank's summed gradient in its master's layout."""
        leaves = self._leaves
        if self._qgz is not None:
            if self._bucket_idxs is not None:
                grads, res = self._bucketed_grads()
            elif self._residual is None:
                grads, res = self._qgz.reduce([leaf.acc for leaf in leaves]), None
            else:
                grads, res = self._qgz.reduce([leaf.acc for leaf in leaves],
                                              residual=self._residual, return_residual=True)
            if self.topology.zero_hierarchy == "mics":
                grads = [self._mics_chunk(leaf, g) for leaf, g in zip(leaves, grads)]
            return grads, res
        grads = []
        for leaf in leaves:
            g, place = leaf.acc, leaf.place
            if leaf.grad_dim is None:         # whole: all-reduced once per step
                if place.world > 1:
                    g = dist.all_reduce(g, group=place.group)
                if place.replica_world > 1:
                    g = dist.all_reduce(g, group=place.replica_group)
                if leaf.master_dim is not None:
                    g = shard_of(g, leaf.master_dim, place.world, place.index)
            grads.append(g)
        return grads, None

    def _mics_chunk(self, leaf, g):
        """qgZ under MiCS: the exchange runs over the whole data-parallel
        world (int4 in ``dp``, int8 across ``dpr``, as JAX's topology splits
        it), which leaves this rank its chunk of the world; the master is
        cut over the ``dp`` shard group only (JAX GSPMD reshards the one to
        the other): ``QgzPlan.shard_group_chunk`` moves to each rank the
        parts of its ``dp`` chunk."""
        d = self._qgz._zero_dim(leaf.shape)
        if d is None:                 # all-reduced whole
            full = g.reshape(leaf.shape)
            return full if leaf.master_dim is None else shard_of(
                full, leaf.master_dim, leaf.place.world, leaf.place.index)
        if leaf.master_dim is None:
            return gather_full(g, d, leaf.shape, self._qgz.world_group)
        return self._qgz.shard_group_chunk(g, leaf.shape, d, leaf.master_dim,
                                           leaf.place.world)

    @torch.no_grad()
    def _apply_step(self, lr):
        denom = float(self.gradient_accumulation_steps_value) * self.dp_world
        if self.fp16_enabled:
            denom *= self.scale.loss_scale
        predivide = self.config.gradient_predivide_factor
        if self.config.prescale_gradients and predivide != 1.0:
            denom /= predivide
        # fp16 only: the one host read of a step, to skip it on any rank's
        # overflow. Under qgZ the local accumulators are checked before the
        # exchange, whose quantization would turn a NaN into a finite value.
        overflow = False
        if self.fp16_enabled and self._qgz is not None:
            overflow = bool(has_overflow([leaf.acc for leaf in self._leaves],
                                         group=self.zero_group))
        norm = torch.zeros((), device=self.device)
        if not overflow:
            grads, new_res = self._reduced_grads()
            # divided in place: the accumulators are zeroed after the step
            grads = [g if g.dtype == torch.float32 else g.float() for g in grads]
            torch._foreach_div_(grads, denom)
            if self.fp16_enabled and self._qgz is None:
                overflow = bool(has_overflow(grads, group=self.zero_group))
        if overflow:
            self._skipped += 1
        else:
            if new_res is not None:
                # an overflow-skipped step keeps the previous carry
                self._residual = new_res
            clip = self.config.gradient_clipping
            # an expert slice is distinct across ep ranks: spread over the
            # world, held by the ranks of its expert-data group when whole
            sharded = [leaf.master_dim is not None or leaf.place.expert
                       for leaf in self._leaves]
            replicas = [leaf.place.world if leaf.master_dim is None else 1
                        for leaf in self._leaves]
            norm = global_norm(grads, group=self.zero_group, sharded=sharded,
                               replicas=replicas)
            if clip and clip > 0:
                clip_grads_by_global_norm(grads, clip, norm=norm)
            if not self._client_optimizer:
                set_lr(self.optimizer, lr)
            for leaf, g in zip(self._leaves, grads):
                leaf.master.grad = g
            self.optimizer.step()
            for leaf in self._leaves:
                leaf.master.grad = None
            del grads
            self._update_working()
        self._release_all()
        self._bucket_left, self._bucket_done = None, {}
        stats = StepStats(grad_norm=norm, lr=lr)
        self.scale = update_loss_scale(self.scale, overflow, self.config.fp16,
                                       self.dynamic_loss_scale)
        for leaf in self._leaves:
            leaf.acc.zero_()
        return stats

    def _update_working(self):
        """The working copy from the updated masters: cast in place where
        this rank holds what it needs, else all-gathered over the ZeRO
        world (stage 1/2 parameters, and stage-3 chunks cut otherwise than
        their masters); requantized under qwZ, and through hpZ's quantized
        primary exchange under qwZ + hpZ."""
        for leaf in self._leaves:
            p, m, place = leaf.param, leaf.master, leaf.place
            if leaf.quant:
                self._requantize(leaf)
                continue
            if leaf.hpz:
                self._hpz_exchange(leaf)
                continue
            if m is p or m is leaf.shard:
                continue
            if leaf.param_dim is None:
                if leaf.master_dim is None:
                    p.data.copy_(m)
                else:
                    gather_full(m.to(self.working_dtype), leaf.master_dim, leaf.shape,
                                place.group, out=p.data)
            elif leaf.master_dim == leaf.param_dim and place.param_world == place.world:
                leaf.shard.copy_(m)
            else:
                full = m if leaf.master_dim is None else gather_full(
                    m.to(self.working_dtype), leaf.master_dim, leaf.shape, place.group)
                leaf.shard.copy_(shard_of(full, leaf.param_dim, place.param_world,
                                          place.param_index))

    def _requantize(self, leaf):
        """qwZ (JAX ``:1128-1133``): the int8 working copy and whole scales
        of ``leaf`` from its updated master, in the working dtype first."""
        place, wd = leaf.place, self.working_dtype
        if leaf.param_dim is None:
            alloc_storage(leaf.param.data)
            full = leaf.master if leaf.master_dim is None else gather_full(
                leaf.master.to(wd), leaf.master_dim, leaf.shape, place.group)
            leaf.param.data.copy_(full.view(leaf.shape))
            self._quantize_whole(leaf, leaf.param.data)
        elif leaf.master_dim == leaf.param_dim and place.param_world == place.world:
            leaf.shard, leaf.qscale = qwz.requantize_chunk(
                leaf.master.to(wd), leaf.param_dim, leaf.shape, place.param_group,
                place.param_world, place.param_index, axis=leaf.qaxis)
        else:
            full = gather_full(leaf.master.to(wd), leaf.master_dim, leaf.shape, place.group)
            alloc_storage(leaf.param.data)
            leaf.param.data.copy_(full)
            self._quantize_whole(leaf, leaf.param.data)

    def _hpz_exchange(self, leaf):
        """hpZ's primary exchange (JAX ``hpz_exchange``, ``:1078-1102``): the
        master chunks (cut over the whole ZeRO world) quantized and gathered
        as int8 + scales, dequantized and cut to this rank's ``dp`` working
        shard in full precision. ``WIRE_BYTES`` counts what the ints and
        scales stood for (the working dtype's bytes of the same gather)."""
        place, wd = leaf.place, self.working_dtype
        m = leaf.master.to(wd)
        if leaf.master_dim is None:
            q, sc = qwz.quantize_leaf(m, leaf.qaxis)
        else:
            q, sc, wire = qwz.quantized_full(m, leaf.master_dim, leaf.shape, place.group,
                                             place.world, axis=leaf.qaxis)
            logical = m.numel() * m.element_size() * (place.world - 1)
            record_exchange("hpz_primary_exchange", logical, wire)
        full = qwz.dequantize_leaf(q, sc, wd, axis=leaf.qaxis)
        if leaf.param_dim is None:
            leaf.param.data.copy_(full)
        else:
            leaf.shard.copy_(shard_of(full, leaf.param_dim, place.param_world,
                                      place.param_index))

    def train_batch(self, data_iter=None):
        """One full accumulation window: ``gradient_accumulation_steps``
        forward/backward/step calls. Returns the window's mean loss as a
        device tensor. The window reads no value back to the host: each
        micro-step's loss stays on the device, and only the boundary step
        reads fp16's overflow flag. This is what the JAX engine's
        ``fused_step`` (``engine.py:1200-1245``, the window as one compiled
        program) buys, so the key is accepted and changes nothing here."""
        if data_iter is None:
            if self.training_dataloader is None:
                raise ValueError("train_batch needs data_iter or training_data")
            if self._data_iterator is None:
                self._data_iterator = iter(RepeatingLoader(self.training_dataloader))
            data_iter = self._data_iterator
        losses = []
        for _ in range(self.gradient_accumulation_steps_value):
            loss = self.forward(next(data_iter))
            self.backward(loss)
            self.step()
            losses.append(loss.detach())
        return torch.stack(losses).mean()

    @torch.no_grad()
    def eval_batch(self, batch):
        """The module's output (loss with labels, else logits) on this
        rank's ``batch``, without gradients."""
        self.module.eval()
        return self.module(self._to_device(batch))

    # ------------------------------------------------------------------
    # introspection (reference engine getter surface)
    # ------------------------------------------------------------------
    def zero_optimization_stage(self):
        return self.config.zero_config.stage

    def zero_optimization(self):
        return self.zero_optimization_stage() > 0

    def get_lr(self):
        if self._last_stats is not None:
            return [self._last_stats.lr]
        return [float(self._schedule_fn(self.global_steps))]

    def set_lr(self, lr):
        """Pin the learning rate to ``lr`` from here on."""
        value = float(lr[0] if isinstance(lr, (list, tuple)) else lr)
        self._schedule_fn = lambda step: value
        self.lr_scheduler.schedule_fn = self._schedule_fn

    def get_mom(self):
        """The first momentum coefficient from the optimizer config (JAX
        ``get_mom``): SGD's momentum (``build_optimizer``'s default 0.0),
        else the betas (Adam's default (0.9, 0.999))."""
        params = dict(self.config.optimizer.params or {})
        if "sgd" in str(self.config.optimizer.type or "").lower():
            return [params.get("momentum", 0.0)]
        return [list(params.get("betas", (0.9, 0.999)))]

    def get_global_grad_norm(self):
        return float(self._last_stats.grad_norm) if self._last_stats is not None else 0.0

    @property
    def skipped_steps(self):
        return self._skipped

    @property
    def cur_scale(self):
        return self.scale.loss_scale

    def loss_scale(self):
        return self.cur_scale

    def was_step_applied(self):
        return self._step_applied

    def train_micro_batch_size_per_gpu(self):
        return self.micro_batch_size

    def train_batch_size(self):
        return self.train_batch_size_value

    def gradient_accumulation_steps(self):
        return self.gradient_accumulation_steps_value

    def get_model_parameters(self):
        """The fp32 master parameters as a state dict of whole tensors on
        the CPU; sharded ones are all-gathered, and expert slices gathered
        over ``ep`` into the whole stack, so every rank calls it."""
        out = {}
        for leaf in self._leaves:
            m = leaf.master.detach().float()
            if leaf.master_dim is not None:
                m = gather_full(m, leaf.master_dim, leaf.shape, leaf.place.group)
            if leaf.place.expert:
                m = dist.all_gather(m.reshape(leaf.shape), group=self.topology.get_group("ep"))
            out[leaf.name] = m.cpu().clone()
        return out

    # ------------------------------------------------------------------
    # checkpointing (JAX engine.py:2214-2444)
    # ------------------------------------------------------------------
    def _opt_state(self, master):
        """The optimizer's tensor state of ``master`` by checkpoint name
        (``exp_avg`` / ``exp_avg_sq`` for ``mu`` / ``nu``, ``opt_<name>``
        for the others), made (step 0) where no step has run yet, so that
        every engine has the same leaves to save and to load into. A client
        optimizer without ``init_state`` saves what it holds."""
        init = getattr(self.optimizer, "init_state", None)
        st = init(master) if init is not None else self.optimizer.state[master]
        names = {v: k for k, v in STATE_ALIASES.items()}
        return {names.get(k, f"opt_{k}"): v for k, v in st.items()
                if isinstance(v, torch.Tensor)}

    def state_dict(self):
        """This rank's training state by name, in leaf order: the working
        copy at rest (the stage-3 chunk where sharded), the fp32 master where
        it is a tensor of its own, the optimizer's state (``_opt_state``),
        the gradient accumulator
        and the qgZ error-feedback residual; under qwZ the working copy is
        the int8 chunk with its whole scales (``qscale``). The engine's own
        tensors, not copies."""
        sd = {}
        for i, leaf in enumerate(self._leaves):
            n = leaf.name
            sd[f"module.{n}"] = leaf.shard if leaf.param_dim is not None or leaf.quant \
                else leaf.param.data
            if leaf.quant:
                sd[f"qscale.{n}"] = leaf.qscale
            if leaf.master is not leaf.param and leaf.master is not leaf.shard:
                sd[f"master.{n}"] = leaf.master
            for key, value in self._opt_state(leaf.master).items():
                sd[f"{key}.{n}"] = value
            sd[f"grad_acc.{n}"] = leaf.acc
            if self._residual is not None:
                sd[f"qgz_residual.{n}"] = self._residual[i]
        return sd

    @torch.no_grad()
    def load_state_dict(self, state_dict, module_only=False):
        """Copy another engine's ``state_dict()`` (the same leaves and
        layout) into this one's tensors; ``module_only`` copies only the
        working copy and the masters."""
        live = self.state_dict()
        for name, value in state_dict.items():
            if module_only and not name.startswith(("module.", "master.", "qscale.")):
                continue
            live[name].copy_(value)
        for leaf in self._leaves:        # qwZ: a whole leaf's module holds its dequantization
            if leaf.quant and leaf.param_dim is None:
                qwz.dequantize_leaf(leaf.shard, leaf.qscale, self.working_dtype,
                                    out=leaf.param.data, axis=leaf.qaxis)

    def _checkpoint_layout(self):
        """What a tag's shards are cut for: the world, the rank grid and the
        ZeRO stage (with its persistence threshold)."""
        layout = {"world": dist.get_world_size(), "axes": dict(self.topology._sizes),
                  "zero_stage": self.zero_optimization_stage(),
                  "param_world": self.partitioner.param_world,
                  "persistence_threshold": self.partitioner.threshold}
        if self.topology.zero_hierarchy is not None:
            layout["zero_hierarchy"] = self.topology.zero_hierarchy
        if self.quantized_weights:
            layout["quantized_weights"] = True
        return layout

    def save_checkpoint(self, save_dir, tag=None, client_state=None, save_latest=True,
                        async_save=False):
        """Save this engine's state to ``save_dir/tag`` (default
        ``global_step<N>``) on every rank, then point ``save_dir/latest`` at
        it. Returns the tag's path."""
        if async_save:
            raise NotImplementedError("async_save is not ported to deepspeed_tpu_torch "
                                      "yet; see ROADMAP.md queue A15 (checkpoint platform)")
        tag = str(tag or f"global_step{self.global_steps}")
        path = os.path.join(save_dir, tag)
        st = next(iter(self.optimizer.state.values()), {})
        meta = {"counters": {"global_steps": self.global_steps,
                             "global_samples": self.global_samples,
                             "micro_steps": self.micro_steps,
                             "skipped_steps": self._skipped,
                             "gas_offset": self._gas_offset,
                             "loss_scale": tuple(self.scale)},
                "lr_scheduler": self.lr_scheduler.state_dict(),
                "client_state": client_state or {},
                "ds_config": self.config._param_dict}
        NativeCheckpointEngine().save(self.state_dict(), path, meta=meta,
                                      aux={"adam_step": int(st.get("step", 0))},
                                      layout=self._checkpoint_layout())
        if save_latest and dist.get_rank() == 0:
            atomic_write_text(os.path.join(save_dir, "latest"), tag)
        dist.barrier()
        log_dist(f"saved checkpoint {path}", ranks=[0])
        return path

    @staticmethod
    def _checkpoint_tags(load_dir):
        """Tags in ``load_dir``, newest first: numbered tags (a trailing
        integer) by number ahead of the others by mtime; quarantined and
        in-flight directories are never candidates."""
        out = []
        for name in os.listdir(load_dir):
            p = os.path.join(load_dir, name)
            if not os.path.isdir(p) or ".corrupt" in name or ".tmp." in name \
                    or ".old." in name or not os.path.exists(os.path.join(p, "meta.json")):
                continue
            m = re.search(r"(\d+)$", name)
            out.append(((1, int(m.group(1))) if m else (0, os.path.getmtime(p)), name))
        return [n for _, n in sorted(out, reverse=True)]

    @staticmethod
    def _quarantine(path):
        """Move a corrupt tag aside to ``<tag>.corrupt`` (kept, not deleted)."""
        dst, n = f"{path}.corrupt", 0
        while os.path.exists(dst):
            n += 1
            dst = f"{path}.corrupt.{n}"
        try:
            os.replace(path, dst)
        except OSError:
            return None
        return dst

    def _read_tag(self, ckpt, path):
        """This rank's leaves of ``path``, verified; CorruptCheckpointError
        on every rank when any rank found the tag corrupt."""
        err, loaded = None, None
        try:
            manifest = ckpt.verify(path)
            layout = self._checkpoint_layout()
            if manifest.get("layout") != layout:
                raise NotImplementedError(
                    f"checkpoint {path} was cut for {manifest.get('layout')}, this engine "
                    f"runs {layout}: loading at another world size, topology or ZeRO "
                    f"stage needs universal checkpoints, ROADMAP.md queue A15")
            loaded = (ckpt.load(path, template=self.state_dict(), rank=dist.get_rank(),
                                manifest=manifest), ckpt.load_meta(path), ckpt.load_aux(path))
        except CorruptCheckpointError as e:
            err = e
        flag = torch.tensor([float(err is not None)], device=self.device)
        dist.all_reduce(flag)
        if flag.item() > 0:
            raise err or CorruptCheckpointError(path, reason="another rank found it corrupt")
        return loaded

    def load_checkpoint(self, load_dir, tag=None, load_optimizer_states=True,
                        load_lr_scheduler_states=True, load_module_only=False):
        """Load ``load_dir/tag`` (default: the ``latest`` pointer) on every
        rank. A corrupt tag is quarantined and the newest earlier valid tag
        loads instead (``latest`` is then repaired). Returns ``(path,
        client_state)``, or ``(None, {})`` when there is no ``latest``."""
        if tag is None:
            latest = os.path.join(load_dir, "latest")
            if not os.path.exists(latest):
                logger.warning(f"no 'latest' file in {load_dir}; nothing loaded")
                return None, {}
            with open(latest) as f:
                tag = f.read().strip()
        ckpt, attempted = NativeCheckpointEngine(), []
        while True:
            path = os.path.join(load_dir, str(tag))
            try:
                state, meta, aux = self._read_tag(ckpt, path)
                break
            except CorruptCheckpointError as e:
                attempted.append(str(tag))
                dist.barrier()
                q = self._quarantine(path) if dist.get_rank() == 0 and os.path.isdir(path) \
                    else None
                dist.barrier()
                logger.error(f"checkpoint {path} corrupt: {e}"
                             + (f"; quarantined to {q}" if q else ""))
                candidates = [t for t in self._checkpoint_tags(load_dir) if t not in attempted]
                if not candidates:
                    raise
                tag = candidates[0]
                logger.warning(f"falling back to checkpoint tag {tag!r}")
        if attempted and dist.get_rank() == 0:
            atomic_write_text(os.path.join(load_dir, "latest"), str(tag))
        module_only = load_module_only or not load_optimizer_states
        self.load_state_dict(state, module_only=module_only)
        if self.quantized_weights or self._qwz_hpz:
            # JAX _refresh_working_from_master: the working copy requantized
            # from the loaded masters
            self._update_working()
        if not module_only and hasattr(self.optimizer, "init_state"):
            for leaf in self._leaves:
                self.optimizer.state[leaf.master]["step"] = aux.get("adam_step", 0)
        c = meta.get("counters", {})
        self.global_steps = int(c.get("global_steps", 0))
        self.global_samples = int(c.get("global_samples", 0))
        self.micro_steps = int(c.get("micro_steps", 0))
        self._skipped = int(c.get("skipped_steps", 0))
        self._gas_offset = int(c.get("gas_offset", 0))
        if "loss_scale" in c:
            self.scale = LossScaleState(*c["loss_scale"])
        if load_lr_scheduler_states and "lr_scheduler" in meta:
            self.lr_scheduler.load_state_dict(meta["lr_scheduler"])
        self._release_all()
        dist.barrier()
        log_dist(f"loaded checkpoint {path} (step {self.global_steps})", ranks=[0])
        return path, meta.get("client_state", {})

    def save_16bit_model(self, save_dir, save_filename=None):
        """Reference engine ``save_16bit_model``: the gathered master weights
        as a HuggingFace checkpoint (``model.safetensors`` + ``config.json``,
        ``checkpoint/hf.py`` ``export_pretrained``) for the families the
        converters cover; any other model, or an explicit ``save_filename``,
        gets an npz of the parameters by name (``model_weights.npz``, not
        named like a torch file). fp16 training writes fp16; bf16 and fp32
        write fp32 (the JAX engine's rule). Every rank calls it (the masters
        are gathered); rank 0 writes. Returns the path written."""
        import numpy as np

        from deepspeed_tpu_torch.checkpoint import hf as hf_interop
        dtype = torch.float16 if self.fp16_enabled else torch.float32
        params = self.get_model_parameters()
        cfg = getattr(self.module, "config", None)
        path = None
        if dist.get_rank() == 0:
            os.makedirs(save_dir, exist_ok=True)
            if save_filename is None and cfg is not None:
                try:
                    path = hf_interop.export_pretrained(params, cfg, save_dir, dtype=dtype)
                except hf_interop.UnsupportedModelError:
                    pass  # unknown family -> npz fallback (real errors propagate)
            if path is None:
                path = os.path.join(save_dir, save_filename or "model_weights.npz")
                np.savez(path, **{n: t.to(dtype).numpy() for n, t in params.items()})
        if dist.get_world_size() > 1:
            box = [path]
            torch.distributed.broadcast_object_list(box, src=0)
            path = box[0]
        return path

    @torch.no_grad()
    def load_hf_weights(self, model_dir):
        """Load a HuggingFace checkpoint directory into the live engine (the
        ``load_checkpoint(load_module_only=True)`` analog for HF checkpoints;
        reference ``module_inject/replace_module.py:182``): the converted
        fp32 weights replace the masters (this rank's chunks) and the
        working copy; the optimizer's moments are kept. Names and shapes
        must be the engine's model's. Returns the converted state dict."""
        from deepspeed_tpu_torch.checkpoint import hf as hf_interop
        params = hf_interop.load_pretrained(model_dir, dtype=torch.float32,
                                            device=self.device).state_dict()
        have = {leaf.name: leaf for leaf in self._leaves}
        if set(params) != set(have):
            raise ValueError(f"{model_dir} does not hold this model's parameters: "
                             f"{sorted(set(params) ^ set(have))[:5]}")
        for name, full in params.items():
            leaf = have[name]
            if tuple(full.shape) != leaf.shape:
                raise ValueError(f"{name}: {model_dir} holds {tuple(full.shape)}, the "
                                 f"model {leaf.shape}")
            if leaf.master_dim is not None:
                leaf.master.copy_(shard_of(full, leaf.master_dim, leaf.place.world,
                                           leaf.place.index))
            elif leaf.master is leaf.param:
                leaf.param.data.copy_(full)
            else:
                leaf.master.copy_(full)
        self._update_working()
        self._release_all()
        return params
