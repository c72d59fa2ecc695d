"""Inference engine v1 (port of ``deepspeed_tpu/inference/engine.py``).

``init_inference`` serves a model's logits forward and KV-cached
``generate`` on one device. As in the JAX engine, every floating weight is
cast to ``config.dtype`` first (norm scales and the embedding too), then,
with ``quant.enabled``, quantized (``inference/quantization``): each
quantized ``nn.Linear`` becomes a ``QuantizedLinear`` and its bf16 weight is
released as it is replaced, so the card never holds both copies.

The JAX v1 engine dequantizes the whole tree to bf16 before every forward
and leaves the fusion of that dequantization into the matmuls to XLA. Eager
PyTorch has no such fusion, and a dequantized copy would put the dense
weights back on the card, so the port multiplies the int8 weights directly:
at 8 bits in bf16, every Dense kernel runs on the dequantize-matmul kernel
(row 7), whose rounding points are v1's (``q * s`` in fp32, one rounding to
bf16, fp32 products). Where no kernel exists the ``dense_dequant`` row
serves, and the engine logs it once at build: 4-, 6- and 12-bit weights (no
kernel in either package), ``lm_head`` (grouped along K, a layout the
kernel does not take), and fp16 or fp32 serving, where v1 still rounds the
weights to bf16 and the kernel would round them to the activations' dtype.

Tensor-parallel and replicated serving run over a ``(dp, tp)`` grid of
``torch.distributed`` ranks, the JAX engine's ``(dp, tp)`` mesh
(``inference/engine.py:65-125``): every rank of the world calls
``init_inference``. ``tensor_parallel.tp_size`` and ``replica_num`` clamp to
the world with the JAX engine's warnings; the grid is the topology of
``parallel.groups`` (``groups.serving_topology``), as the v2 engine's, over
the first ``dp x tp`` ranks, as the JAX mesh takes the first ``dp x tp``
devices. The other ranks are idle: they hold no weights and run no
forward, and take every result from global rank 0 (``forward``'s logits,
``generate``'s tokens), so each rank of the world returns what the one JAX
program returns. The weights are split over ``tp``
as the model's ``param_specs`` says (the rank's slices are cut from the
whole state dict given) and replicated across ``dp``; ``forward`` runs each
``dp`` replica on its share of the batch rows and gathers the whole batch's
logits on every rank; ``generate`` runs the whole batch on every replica,
and with ``temperature`` > 0 tp rank 0 draws each token and broadcasts it
(the engines' seeds agree across the world), so the ranks never diverge.
With ``quant.enabled`` over ``tp``, as the JAX engine does, each whole
weight is quantized and the rank keeps its part of ``q`` and ``scale``
(``quantization.quantized_part``): the model is cut by a ``TPPlan`` built
with the group size, so that gate/up (and q/k/v) are cut in whole groups
(Llama-2-7B at tp 2: gate/up N 5632 and 5376, ``down_proj``'s K the same
ranges) and every linear that runs on row 7 at tp 1 runs on it at tp 2.
That needs the whole weights (a whole model, or whole ``params``; an HF
directory quantizes each whole tensor as it loads, keeping the rank's part,
``checkpoint/hf.load_pretrained``'s ``quantize``). An 8-bit linear whose
groups row 7 cannot take (a padded last group, or a tensor-parallel part
whose cut splits groups: ``quantization.kernel_gap``) runs
``dense_dequant``, and the engine logs which.

The KV-cached forward (``generate``) runs the Llama families and the
parallel-block families, Falcon and Phi (``models/parallel_block.py``, the
JAX ``ParallelBlock``'s ``use_cache`` path), as the JAX package's v1 engine
does; OPT and Mixtral have no cached path in the JAX package either, and
``generate`` raises ``ValueError`` for them. ``config.checkpoint`` may name
a HuggingFace checkpoint directory of any family ``checkpoint/hf.py``
loads: it loads through ``load_pretrained`` in ``config.dtype``, and its
model serves when none was given. ``config.checkpoint`` may also name a tag
written by the port's ``save_checkpoint``: its working weights load into the
model (the JAX engine's intent, ``state.get("module", state)``; its own call
raises, ROADMAP §C).
"""

import os
import random

import torch

from deepspeed_tpu_torch import resolve_device
from deepspeed_tpu_torch.comm import comm as dist
from deepspeed_tpu_torch.inference.config import DeepSpeedInferenceConfig
from deepspeed_tpu_torch.inference.generation import generate as _generate
from deepspeed_tpu_torch.inference.quantization.quantization import (
    EXCLUDE, V1_TILE_DTYPE, QuantizedLinear, _quantized_names, quantize_param_tree,
    quantized_linear, quantized_nbytes, quantized_part, replace_module)
from deepspeed_tpu_torch.models.mixtral import MixtralConfig
from deepspeed_tpu_torch.models.opt import OPTConfig
from deepspeed_tpu_torch.parallel.tensor_parallel import TensorParallel
from deepspeed_tpu_torch.parallel import groups
from deepspeed_tpu_torch.utils.logging import logger

# families without a KV-cached forward, in the JAX package as in the port
NO_CACHED_FORWARD = (MixtralConfig, OPTConfig)
# dtypes of the results an idle rank takes from rank 0
_RESULT_DTYPES = (torch.float32, torch.bfloat16, torch.float16, torch.int64)


class InferenceEngine:
    """Serve ``model`` (a ``torch.nn.Module`` with the KV-cache contract of
    ``models/llama.py``) on ``device`` (default CUDA). ``params``: a state
    dict to load into it; without one, ``config.checkpoint`` or the model's
    own weights serve (a model on the meta device waits for
    ``set_params``). Over a ``(dp, tp)`` grid (module docstring) ``model``
    may be the whole model or this rank's slice of it."""

    def __init__(self, model, config=None, params=None, device=None):
        if not isinstance(config, DeepSpeedInferenceConfig):
            config = DeepSpeedInferenceConfig.from_dict(config or {})
        if not torch.empty((), dtype=config.torch_dtype).is_floating_point():
            raise NotImplementedError(
                f"dtype={config.dtype}: integer serving dtypes require the "
                "weight-quantization path (config.quant), not a raw cast")
        self._config = config
        self.device = resolve_device(device)
        self.topology = self._build_grid(int(config.tensor_parallel.tp_size),
                                         int(config.replica_num))
        self.idle = self.topology is not None and self.topology.grid_rank is None
        self.tp = TensorParallel.from_topology(self.topology) \
            if self.topology and not self.idle else TensorParallel()
        self._generator = torch.Generator(device=self.device)
        self._generator.manual_seed(self._shared_seed())
        self._ready = False
        if self.idle:
            self.module = None           # holds no weights, runs no forward
            self._ready = True
            return
        quant = config.quant
        if model is not None and self.tp.size > 1 and model.tp_size == 1:
            if params is None and not any(p.is_meta for p in model.parameters()):
                params = model.state_dict()     # the whole weights, cut in set_params
            group = dict(quant_group_size=quant.group_size) if quant.enabled else {}
            model = type(model)(model.config, device="meta", tp_size=self.tp.size,
                                tp_rank=self.tp.rank, **group)
        elif model is not None and self.tp.size > 1 and quant.enabled:
            raise ValueError(
                "quant.enabled at tensor_parallel.tp_size > 1 quantizes each whole weight "
                "(as the JAX engine does) and keeps this rank's part: give the whole "
                "model, not one rank's share")
        self.module = model
        if params is None and config.checkpoint:
            params = self._load_checkpoint(config.checkpoint)
        if self._ready:
            return
        if params is not None:
            self.set_params(params)
        elif model is not None and not any(p.is_meta for p in model.parameters()):
            self.set_params({})

    # -- setup -------------------------------------------------------------
    def _build_grid(self, tp_size, replica_num):
        """The ``(dp, tp)`` rank grid over the first ``dp x tp`` ranks of
        the world, clamped as the JAX engine clamps its mesh (None: one
        rank serves alone, as each rank of a world does then): the topology
        ``groups.serving_topology`` installs or finds installed. Ranks past
        the grid are idle."""
        world = dist.get_world_size()
        if tp_size > world:
            logger.warning(f"tp_size {tp_size} > {world} devices; clamping")
            tp_size = world
        dp = max(1, int(replica_num))
        if dp * tp_size > world:
            dp = max(1, world // tp_size)
            logger.warning(f"replica_num x tp_size exceeds {world} devices; clamping "
                           f"replicas to {dp}")
        if dp * tp_size == 1:
            return None
        return groups.serving_topology(tp_size, dp, devices=list(range(dp * tp_size)))

    @property
    def grid(self):
        """The serving grid's axes, ``{"dp": ..., "tp": ...}`` (the JAX
        engine's ``mesh.shape``)."""
        t = self.topology
        return {"dp": t.dp_size if t else 1, "tp": t.tp_size if t else 1}

    def _shared_seed(self):
        """A sampling seed drawn on global rank 0 and shared by the grid."""
        seed = torch.tensor([random.SystemRandom().randrange(2 ** 62)], dtype=torch.int64,
                            device=self.device)
        if self.topology is not None:
            dist.broadcast(seed, src=0)
        return int(seed.item())

    def _load_checkpoint(self, path):
        from deepspeed_tpu_torch.runtime.checkpoint_engine.native_engine import (
            NativeCheckpointEngine)
        if os.path.isdir(path) and os.path.exists(os.path.join(path, "config.json")):
            return self._load_hf_checkpoint(path)
        if self.module is None:
            raise ValueError("loading a native checkpoint needs the model it was saved from")
        ckpt = NativeCheckpointEngine()
        manifest = ckpt.verify(path)
        layout = manifest.get("layout", {})
        if layout.get("zero_stage", 0) >= 3 or layout.get("axes", {}).get("ep", 1) > 1:
            raise NotImplementedError(
                f"{path} holds ZeRO-3 or expert-parallel shards of the weights; "
                "assembling them is universal checkpoints, ROADMAP.md queue A15")
        want = {f"module.{n}" for n, _ in self.module.named_parameters()}
        have = {n for n, _ in manifest["leaves"][0]}
        if not want <= have:
            raise ValueError(f"{path} holds no weights for {sorted(want - have)[:3]}...: "
                             "saved from another model")
        loaded = ckpt.load(path, rank=0, manifest=manifest, names=want)
        return {n[len("module."):]: t for n, t in loaded.items()}

    def _load_hf_checkpoint(self, path):
        """An HF checkpoint directory, converted straight into the serving
        dtype on the engine's device (no transient fp32 copy); its model is
        adopted when the engine was given none."""
        from deepspeed_tpu_torch.checkpoint import hf as hf_interop
        q, dtype = self._config.quant, self._config.torch_dtype
        if self.tp.size == 1 or not q.enabled:
            model = hf_interop.load_pretrained(path, dtype=dtype, device=self.device,
                                               tp_size=self.tp.size, tp_rank=self.tp.rank)
            if self.module is None:
                self.module = model
            return model.state_dict()
        # quantized at tp: each whole tensor quantized as it loads, the
        # rank's part kept; the loaded model serves
        impl = self._quant_impl()

        def quantize(model, name, whole):
            mod = name[:-len(".weight")]
            if not name.endswith(".weight") or any(e in name.lower() for e in EXCLUDE) \
                    or not isinstance(model.get_submodule(mod), torch.nn.Linear):
                return None
            return quantized_part(mod, whole.to(dtype), model.plan, None, q.bits,
                                  q.group_size, impl)
        model = hf_interop.load_pretrained(path, dtype=dtype, device=self.device,
                                           tp_size=self.tp.size, tp_rank=self.tp.rank,
                                           quantize=quantize,
                                           quant_group_size=q.group_size)
        self.module = model.eval().requires_grad_(False)
        with torch.no_grad():
            for p in model.parameters():
                if p.is_floating_point():
                    p.data = p.data.to(dtype)
        model.set_tensor_parallel(self.tp)
        self._log_gaps()
        self._ready = True
        return None

    def set_params(self, params):
        """Load a state dict (names of the model's parameters; ``{}`` keeps
        the model's own values) onto the device in ``config.dtype``, one
        tensor at a time, then quantize with ``config.quant``. A weight whose
        module is already quantized is quantized anew from the value given.
        Over a ``tp`` axis a whole tensor is cut to this rank's part; with
        ``quant.enabled`` each linear's whole weight is quantized, then cut
        (module docstring)."""
        dtype, mod = self._config.torch_dtype, self.module
        q = self._config.quant
        whole_quant = q.enabled and self.tp.size > 1
        later = {f"{n}.weight" for n, _ in _quantized_names(mod)} if whole_quant else set()
        unknown = set(params) - {n for n, _ in mod.named_parameters()} - {
            f"{n}.weight" for n, m in mod.named_modules() if isinstance(m, QuantizedLinear)}
        if unknown:
            raise ValueError(f"params name nothing in the model: {sorted(unknown)[:5]}")
        if any(p.is_meta for p in mod.parameters()):
            mod.to_empty(device=self.device)
        with torch.no_grad():
            for name, p in list(mod.named_parameters()):
                if name in later:
                    continue                  # quantized whole below
                value = torch.as_tensor(params[name]) if name in params else p.detach()
                if value.shape != p.shape and self.tp.size > 1:
                    value = mod.plan.cut(name, value).clone()
                if value.shape != p.shape:
                    raise ValueError(f"{name}: a {tuple(value.shape)} value for a "
                                     f"{tuple(p.shape)} parameter")
                p.data = value.to(self.device, dtype if value.is_floating_point() else None)
            impl = self._quant_impl() if whole_quant else None
            for name, m in list(mod.named_modules()):
                weight = f"{name}.weight"
                if weight not in params or not (
                        weight in later or isinstance(m, QuantizedLinear)):
                    continue
                w = torch.as_tensor(params[weight]).to(self.device, dtype)
                if self.tp.size == 1:
                    new = quantized_linear(name, w, m.bias, q.bits, q.group_size, m.impl)
                else:
                    local = (tuple(m.weight.shape) if weight in later
                             else m.shape[::-1] if m.layout == "kn" else m.shape)
                    if tuple(mod.plan.cut(weight, w).shape) != tuple(local):
                        raise ValueError(f"{weight}: quantizing at tensor_parallel.tp_size "
                                         f"{self.tp.size} needs the whole weight, got "
                                         f"{tuple(w.shape)}")
                    new = quantized_part(name, w, mod.plan, m.bias, q.bits, q.group_size,
                                         m.impl if isinstance(m, QuantizedLinear) else impl)
                replace_module(mod, name, new)
                del w
            if later - set(params):
                raise ValueError(f"quantizing at tensor_parallel.tp_size {self.tp.size} "
                                 f"needs the whole weights; none given for "
                                 f"{sorted(later - set(params))[:3]}")
        mod.eval().requires_grad_(False)
        if self.tp.size > 1:
            mod.set_tensor_parallel(self.tp)
        self._maybe_quantize()
        self._log_gaps()
        self._ready = True

    def _log_gaps(self):
        """Log the 8-bit linears that take ``dense_dequant`` by the route
        ``quantization.kernel_gap`` declares."""
        gaps = {}
        for n, m in self.module.named_modules():
            if isinstance(m, QuantizedLinear) and m.gap and m.impl == "dense_dequant":
                gaps.setdefault(m.gap, []).append(n)
        for why, names in gaps.items():
            logger.info(f"weight quantization: {names}: {why}: dense_dequant")

    def _quant_impl(self):
        """The registry row every quantized Dense kernel is pinned to (None:
        the kernel), logged."""
        q, dtype = self._config.quant, self._config.torch_dtype
        if q.bits != 8:
            logger.info(f"weight quantization: {q.bits}-bit weights have no kernel in "
                        f"either package; every quantized linear runs dense_dequant")
            return "dense_dequant"
        if dtype != V1_TILE_DTYPE:
            logger.info(f"weight quantization: serving {dtype}, the weights round to bf16 "
                        f"(the JAX v1 engine's dequantization) and the kernel rounds to "
                        f"the activations' dtype; every quantized linear runs dense_dequant")
            return "dense_dequant"
        return None

    def _maybe_quantize(self):
        q = self._config.quant
        if not q.enabled:
            return
        impl = self._quant_impl()
        before = quantized_nbytes(self.module)
        quantize_param_tree(self.module, num_bits=q.bits, group_size=q.group_size, impl=impl)
        after = quantized_nbytes(self.module)
        raw = [n for n, m in self.module.named_modules()
               if isinstance(m, QuantizedLinear) and m.layout == "nk"]
        if raw and impl is None:
            logger.info(f"weight quantization: {raw} grouped along K, a layout the kernel "
                        f"does not take: dense_dequant")
        logger.info(f"weight quantization: {before / 1e6:.1f}MB -> {after / 1e6:.1f}MB "
                    f"({q.bits}-bit)")

    # -- serving -----------------------------------------------------------
    def _require_params(self):
        if not self._ready:
            raise RuntimeError(
                "InferenceEngine has no parameters: pass params= to init_inference, "
                "set config.checkpoint to a checkpoint tag, or call set_params()")

    def _from_rank0(self, result):
        """Every rank of the world takes global rank 0's ``result`` when the
        grid leaves ranks idle (an idle rank passes None); else
        ``result``."""
        t = self.topology
        if t is None or t.ranks.size == dist.get_world_size():
            return result
        header = torch.zeros(6, dtype=torch.int64, device=self.device)
        if result is not None:
            header[0] = _RESULT_DTYPES.index(result.dtype)
            header[1] = result.dim()
            header[2:2 + result.dim()] = torch.tensor(result.shape)
        dist.broadcast(header, src=0)
        code, ndim, *shape = header.tolist()
        if result is None:
            result = torch.empty(shape[:ndim], dtype=_RESULT_DTYPES[code],
                                 device=self.device)
        result = result.contiguous()
        dist.broadcast(result, src=0)
        return result

    @torch.no_grad()
    def forward(self, batch, **kwargs):
        """Logits [B, T, V] of ``batch`` (ids [B, T], or a dict with
        ``input_ids``). Over ``dp`` replicas, a batch whose rows they divide
        is split among them and its logits gathered on every rank, as the
        JAX engine shards it; otherwise every replica runs it whole. An
        idle rank returns rank 0's logits."""
        self._require_params()
        if self.idle:
            return self._from_rank0(None)
        if not isinstance(batch, dict):
            batch = {"input_ids": batch}
        batch = {k: torch.as_tensor(v).to(self.device) for k, v in batch.items()}
        dp = self.grid["dp"]
        B = batch["input_ids"].shape[0]
        if dp == 1 or B % dp or "labels" in batch:
            return self._from_rank0(self.module(batch, **kwargs))
        group, _, index = self.topology.axes_group(("dp",))
        n = B // dp
        out = self.module({k: v[index * n:(index + 1) * n] for k, v in batch.items()},
                          **kwargs)
        return self._from_rank0(dist.all_gather(out.contiguous(), group=group))

    __call__ = forward

    def generate(self, input_ids, max_new_tokens=32, temperature=0.0, top_k=0, top_p=1.0,
                 rng=None, eos_token_id=None, **kwargs):
        """KV-cached generation: [B, max_new_tokens] token ids. ``rng``: a
        ``torch.Generator`` or a seed for sampling (default the engine's)."""
        self._require_params()
        if self.idle:
            return self._from_rank0(None)
        if isinstance(self.module.config, NO_CACHED_FORWARD):
            raise ValueError(
                f"{type(self.module).__name__} has no KV-cached forward, in the JAX "
                "package either: the v1 engine serves its logits (forward) only; "
                "generate through the v2 engine (build_engine / build_hf_engine)")
        max_new_tokens = min(max_new_tokens, self._config.max_out_tokens)
        if isinstance(rng, int):
            rng = torch.Generator(device=self.device).manual_seed(rng)
        return self._from_rank0(_generate(
            self.module, input_ids, max_new_tokens=max_new_tokens, temperature=temperature,
            top_k=top_k, top_p=top_p, generator=rng or self._generator,
            eos_token_id=eos_token_id, tp=self.tp))

    def destroy(self):
        """The JAX engine releases its compiled functions here; the port
        compiles none, so nothing is released."""
