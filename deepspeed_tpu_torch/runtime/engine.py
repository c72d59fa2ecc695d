"""DeepSpeedEngine for one device (port of ``deepspeed_tpu/runtime/engine.py``).

The engine holds the model's parameters in the working dtype (bf16, fp16 or
fp32) inside the module, an fp32 master copy and fp32 gradient accumulators
(``engine.py:434-555`` in the JAX package). As there, every floating
parameter — norm scales and embeddings included — is cast to the working
dtype, and gradients are taken with respect to that working copy.

- ``forward(batch)`` runs the module and returns the loss with its graph;
- ``backward(loss)`` runs autograd on the (loss-scaled) loss and adds the
  working-dtype gradients into the accumulators, freeing them;
- ``step()`` at the gradient-accumulation boundary averages the accumulated
  gradients, unscales them, skips the step on fp16 overflow, clips by the
  global norm, runs the optimizer on the master copy, recasts it into the
  working copy and updates the loss scale (``engine.py:1106-1147``).

The JAX engine fuses forward, backward and accumulation into one XLA
program; this is PyTorch's own forward/backward split, as the reference
DeepSpeed has it. Data parallelism and ZeRO 1/2/3 wait for the distributed
slice (ROADMAP A1): ``DeepSpeedConfig.check_supported`` raises for them.
"""

from typing import Any, NamedTuple

import torch
from torch import nn

from deepspeed_tpu_torch import resolve_device
from deepspeed_tpu_torch.ops.adam import build_optimizer, set_lr
from deepspeed_tpu_torch.runtime.activation_checkpointing import checkpointing
from deepspeed_tpu_torch.runtime.config import DeepSpeedConfig
from deepspeed_tpu_torch.runtime.dataloader import DeepSpeedDataLoader, RepeatingLoader
from deepspeed_tpu_torch.runtime.fp16.loss_scaler import (LossScaleState,
                                                          init_loss_scale_state,
                                                          update_loss_scale)
from deepspeed_tpu_torch.runtime.lr_schedules import LRSchedulerShim, get_lr_schedule
from deepspeed_tpu_torch.runtime.utils import (clip_grads_by_global_norm, count_parameters,
                                               global_norm, has_overflow)
from deepspeed_tpu_torch.utils.logging import log_dist

_DTYPES = {None: torch.float32, "fp32": torch.float32, "fp16": torch.float16,
           "bf16": torch.bfloat16}


class StepStats(NamedTuple):
    grad_norm: Any        # 0-d fp32 tensor on the engine's device
    lr: float


class DeepSpeedEngine:

    def __init__(self, config=None, model=None, optimizer=None,
                 model_parameters=None, training_data=None, lr_scheduler=None,
                 collate_fn=None, device=None):
        self.config = config if isinstance(config, DeepSpeedConfig) else DeepSpeedConfig(config)
        self.config.check_supported()
        if not isinstance(model, nn.Module):
            raise ValueError("deepspeed_tpu_torch.initialize requires a torch.nn.Module "
                             f"model whose forward(batch) returns the loss, got {type(model)}")
        self.module = model
        self.device = resolve_device(device)

        tb, mb, gas = self.config.resolve_batch_params(1)
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

        # --- parameters: fp32 master, working copy in the module ---
        self._init_parameters(model_parameters)

        # --- optimizer ---
        opt_cfg = self.config.optimizer
        if optimizer is not None and not isinstance(optimizer, str):
            raise NotImplementedError("client optimizer objects are not ported yet; pass "
                                      "an optimizer name or a config section: ROADMAP A1")
        name = optimizer if isinstance(optimizer, str) else opt_cfg.type
        self.optimizer, self._base_lr = build_optimizer(name, opt_cfg.params, self._opt_params)

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
            self.training_dataloader = DeepSpeedDataLoader(training_data, batch_size=mb,
                                                           collate_fn=collate_fn)

        checkpointing.configure(deepspeed_config=self.config)

        self.scale = init_loss_scale_state(self.config.fp16) if self.fp16_enabled \
            else LossScaleState(1.0, 0, 0)
        self.global_steps = 0
        self.global_samples = 0
        self.micro_steps = 0
        self._skipped = 0
        self._step_applied = False
        self._last_stats = None
        self._staged_loss = None
        self._data_iterator = None
        log_dist(f"DeepSpeedEngine: device={self.device} dtype={self.working_dtype} "
                 f"batch=({tb},{mb},{gas}) parameters="
                 f"{count_parameters(self._master) / 1e6:.2f}M", ranks=[0])

    def _init_parameters(self, model_parameters):
        """Master copies in fp32 from ``model_parameters`` (a state dict of
        tensors or arrays, by parameter name) or the module's own values,
        taken before the module is cast; then the module's parameters become
        the working-dtype copy on the engine's device."""
        named = list(self.module.named_parameters())
        src = dict(model_parameters or {})
        unknown = set(src) - {n for n, _ in named}
        if unknown:
            raise ValueError(f"model_parameters names no parameter of the model: "
                             f"{sorted(unknown)[:5]}")
        with torch.no_grad():
            masters = [torch.as_tensor(src.get(n, p.detach()))
                       .to(device=self.device, dtype=torch.float32).clone()
                       for n, p in named]
            self.module.to(self.device)
            for (n, p), m in zip(named, masters):
                if tuple(m.shape) != tuple(p.shape):
                    raise ValueError(f"{n}: model_parameters shape {tuple(m.shape)} != "
                                     f"{tuple(p.shape)}")
                p.data = m.to(self.working_dtype)
                p.requires_grad_(True)
        self._names = [n for n, _ in named]
        self._params = [p for _, p in named]
        self._master = masters if self.mixed_precision else self._params
        self._opt_params = self._master
        self._grad_acc = [torch.zeros(p.shape, dtype=self.grad_accum_dtype, device=self.device)
                          for p in self._params]

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
        """Run the module on ``batch`` and return its loss with the graph."""
        self.module.train()
        loss = self.module(self._to_device(batch))
        if isinstance(loss, tuple):
            loss = loss[0]
        self._staged_loss = loss
        return loss

    __call__ = forward

    def backward(self, loss=None, retain_graph=False):
        """Backpropagate ``loss`` (default: the last forward's), scaled for
        fp16, and add the gradients into the fp32 accumulators."""
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
        scaled.backward(retain_graph=retain_graph)
        with torch.no_grad():
            for p, acc in zip(self._params, self._grad_acc):
                if p.grad is not None:
                    acc.add_(p.grad)
                    p.grad = None
        self._staged_loss = None
        return loss

    def is_gradient_accumulation_boundary(self):
        return (self.micro_steps + 1) % self.gradient_accumulation_steps_value == 0

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
        self.global_samples += self.micro_batch_size

    @torch.no_grad()
    def _apply_step(self, lr):
        denom = float(self.gradient_accumulation_steps_value)
        if self.fp16_enabled:
            denom *= self.scale.loss_scale
        predivide = self.config.gradient_predivide_factor
        if self.config.prescale_gradients and predivide != 1.0:
            denom /= predivide
        grads = self._grad_acc if self.grad_accum_dtype == torch.float32 \
            else [a.float() for a in self._grad_acc]
        torch._foreach_div_(grads, denom)
        # fp16 only: the one host read of a step, to skip it on overflow
        overflow = bool(has_overflow(grads)) if self.fp16_enabled else False
        if overflow:
            norm = torch.zeros((), device=self.device)
            self._skipped += 1
        else:
            clip = self.config.gradient_clipping
            norm = global_norm(grads)
            if clip and clip > 0:
                clip_grads_by_global_norm(grads, clip, norm=norm)
            set_lr(self.optimizer, lr)
            for t, g in zip(self._opt_params, grads):
                t.grad = g
            self.optimizer.step()
            for t in self._opt_params:
                t.grad = None
            if self.mixed_precision:
                for p, m in zip(self._params, self._master):
                    p.copy_(m)
        stats = StepStats(grad_norm=norm, lr=lr)
        self.scale = update_loss_scale(self.scale, overflow, self.config.fp16,
                                       self.dynamic_loss_scale)
        for a in self._grad_acc:
            a.zero_()
        return stats

    def train_batch(self, data_iter=None):
        """One full accumulation window: ``gradient_accumulation_steps``
        forward/backward/step calls. Returns the window's mean loss as a
        device tensor."""
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
        """The module's output (loss with labels, else logits) without
        gradients."""
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
        """The fp32 master parameters as a state dict (copies on the CPU)."""
        return {n: m.detach().float().cpu().clone() for n, m in zip(self._names, self._master)}
