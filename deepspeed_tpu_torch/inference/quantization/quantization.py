"""ZeRO-Inference weight-only quantization (port of
``deepspeed_tpu/inference/quantization/quantization.py``).

Weights are stored int8 (or packed int4, fp6, fp12) with fp32 group scales
and multiplied without a dense copy: each quantized ``nn.Linear`` of a model
is replaced by a ``QuantizedLinear`` whose 8-bit product runs on the fused
dequantize-matmul kernel (``ops/quantized_matmul.py``, kernel row 7).

Layouts are the JAX package's, so that the quantized values and scales of
every leaf equal the JAX tree's bit for bit: a flax ``Dense`` kernel is
``[in, out] = [K, N]``, the port's ``nn.Linear.weight.T``, grouped along N;
``lm_head`` is a raw ``[V, D]`` parameter in both packages (``x @
lm_head.T``), grouped along D. The leaves quantized are those JAX quantizes:
every matrix whose lower-cased name contains none of ``embed``, ``norm``,
``bias`` or ``scale``; the port's names (``layers.0.mlp.up_proj.weight``,
``norm.weight``, ``embed_tokens.weight``) give the same set.

Under tensor parallelism the JAX v1 engine shards the weights, then
quantizes each whole tensor (``inference/engine.py:65-70, 118-166``):
``quantized_part`` does the same for one rank, quantizing the whole weight
and keeping the rank's part of ``q`` and ``scale``, cut by the model's
``TPPlan`` (built with the group size, so that column-split linears are cut
in whole groups), so that the rank's dequantized weight is the whole
tensor's dequantized slice, bit for bit.
"""

import functools

import torch
from torch import nn

from deepspeed_tpu_torch.ops.fp_quantizer import dequantize_fp, quantize_fp
from deepspeed_tpu_torch.parallel.tensor_parallel import take_spans
from deepspeed_tpu_torch.ops.quantizer import (dequantize, dequantize_lastdim,
                                               quantize, quantize_lastdim)

EXCLUDE = ("embed", "norm", "bias", "scale")
# the dtype a quantized linear rounds its weights to: the JAX v1 engine
# dequantizes the whole tree to bf16 whatever its serving dtype
V1_TILE_DTYPE = torch.bfloat16
# modules whose weight the JAX model holds as a raw [out, in] parameter
# (``x @ p.T``) rather than a flax Dense kernel [in, out]
RAW_WEIGHTS = ("lm_head",)


class QuantizedParameter:
    """One quantized weight in the JAX layout: ``q`` and fp32 ``scale``
    as ``quantize_lastdim`` (8-bit), ``quantize`` (4-bit) or ``quantize_fp``
    (6/12-bit) give them, ``shape`` the weight's."""

    def __init__(self, q, scale, shape, num_bits, group_size):
        self.q = q
        self.scale = scale
        self.shape = tuple(int(s) for s in shape)
        self.num_bits = int(num_bits)
        self.group_size = int(group_size)

    @classmethod
    def from_tensor(cls, w, num_bits=8, group_size=256):
        if num_bits in (6, 12):
            q, s = quantize_fp(w, bits=num_bits, group_size=group_size)
        elif num_bits == 8:
            q, s = quantize_lastdim(w, group_size=group_size)
        else:
            q, s = quantize(w, num_bits=num_bits, group_size=group_size)
        return cls(q, s, w.shape, num_bits, group_size)

    def dequantized(self, dtype=torch.bfloat16):
        if self.num_bits in (6, 12):
            return dequantize_fp(self.q, self.scale, self.shape, bits=self.num_bits,
                                 group_size=self.group_size, dtype=dtype)
        if self.num_bits == 8:
            return dequantize_lastdim(self.q, self.scale, group_size=self.group_size,
                                      dtype=dtype)
        return dequantize(self.q, self.scale, self.shape, num_bits=self.num_bits,
                          group_size=self.group_size, dtype=dtype)

    def matmul(self, x, out_dtype=None, impl=None):
        """``x @ dequant(self)`` for a ``[K, N]`` weight through the module
        registry's linear rows: ``cuda_fused_dequant``, the kernel (None or
        "auto" at 8 bits; it raises on a shape it cannot take), or
        ``dense_dequant``, dequantize to ``out_dtype or x.dtype`` then
        multiply (the only row at 4, 6 and 12 bits)."""
        from deepspeed_tpu_torch.inference.v2.modules.heuristics import instantiate_linear
        K, N = self.shape if len(self.shape) == 2 else (None, None)
        M = x.numel() // x.shape[-1]
        _, fn = instantiate_linear(M, K, N, self.group_size, self.num_bits,
                                   ndim=len(self.shape), preference=impl, dtype=x.dtype,
                                   device_type=x.device.type)
        out = fn(x.reshape(M, x.shape[-1]), self, out_dtype)
        return out.reshape(*x.shape[:-1], out.shape[-1])

    @property
    def nbytes(self):
        return self.q.numel() * self.q.element_size() + \
            self.scale.numel() * self.scale.element_size()


class QuantizedLinear(nn.Module):
    """Takes the place of a quantized ``nn.Linear``: ``q`` and ``scale``
    buffers in the JAX layout (``layout`` "kn", a Dense kernel, or "nk", a
    raw weight such as ``lm_head``), the bias as it was, and the product's
    implementation (``impl``, a registry row name). Both rows round the
    weights to ``V1_TILE_DTYPE``: the dense row by its ``tile_dtype``, the
    kernel by serving activations of that dtype only."""

    def __init__(self, qp, layout, impl, bias=None):
        super().__init__()
        self.register_buffer("q", qp.q)
        self.register_buffer("scale", qp.scale)
        self.shape, self.num_bits, self.group_size = qp.shape, qp.num_bits, qp.group_size
        self.layout = layout
        self.bias = bias
        self.set_impl(impl)

    def set_impl(self, impl):
        """Pin the product to a registry row ("cuda_fused_dequant" or
        "dense_dequant"); raises if the row cannot serve this weight."""
        from deepspeed_tpu_torch.inference.v2.modules.heuristics import instantiate_linear
        if impl != "dense_dequant" and self.layout != "kn":
            raise ValueError(f"{impl} needs a [K, N] weight grouped along N; this "
                             f"{self.layout} weight goes through dense_dequant")
        K, N = self.shape if self.layout == "kn" else self.shape[::-1]
        self.impl, fn = instantiate_linear(
            1, K, N, self.group_size, self.num_bits, preference=impl,
            dtype=V1_TILE_DTYPE, device_type=self.q.device.type)
        self._fn = fn if self.impl != "dense_dequant" else functools.partial(
            fn, tile_dtype=V1_TILE_DTYPE, transposed=self.layout == "nk")

    @property
    def qp(self):
        return QuantizedParameter(self.q, self.scale, self.shape, self.num_bits,
                                  self.group_size)

    def product(self, x):
        """``x @ dequant(W)`` without the bias (a row-split linear's partial
        product under tensor parallelism)."""
        if self.impl != "dense_dequant" and x.dtype != V1_TILE_DTYPE:
            raise TypeError(f"{self.impl} rounds the weight to the activations' dtype "
                            f"{x.dtype}; this linear's weights round to "
                            f"{V1_TILE_DTYPE}: pin dense_dequant")
        out = self._fn(x.reshape(-1, x.shape[-1]), self.qp, x.dtype)
        return out.reshape(*x.shape[:-1], out.shape[-1])

    def forward(self, x):
        out = self.product(x)
        return out if self.bias is None else out + self.bias.to(out.dtype)

    def extra_repr(self):
        return (f"shape={self.shape}, layout={self.layout}, bits={self.num_bits}, "
                f"group_size={self.group_size}, impl={self.impl}")


def _quantized_names(model, min_size=0, exclude=EXCLUDE):
    """Names of the ``nn.Linear`` modules whose weight JAX quantizes."""
    for name, mod in model.named_modules():
        if not isinstance(mod, nn.Linear):
            continue
        pname = f"{name}.weight".lower()
        if mod.weight.numel() < min_size or any(e in pname for e in exclude):
            continue
        yield name, mod


def quantized_linear(name, weight, bias=None, num_bits=8, group_size=256, impl=None):
    """The ``QuantizedLinear`` of module ``name``'s ``[out, in]`` weight,
    quantized in the JAX layout. ``impl`` pins a Dense kernel's product
    (None: the registry's choice, which raises where the kernel cannot
    serve); a raw weight (``lm_head``), grouped along K, which the kernel
    does not take, goes through ``dense_dequant``."""
    if name.split(".")[-1] in RAW_WEIGHTS:
        layout, row, w = "nk", "dense_dequant", weight
    else:
        layout, row, w = "kn", impl, weight.T.contiguous()
    qp = QuantizedParameter.from_tensor(w, num_bits, group_size)
    return QuantizedLinear(qp, layout, row, bias=bias)


def cut_quantized(qp, dim, spans):
    """The part of a whole ``QuantizedParameter`` (a ``[rows, cols]``
    weight in its quantized layout) at element ``spans`` along ``dim``
    (0: rows, 1: columns), in whole groups: 8-bit ``q`` and its scale
    columns cut directly (``quantize_lastdim`` keeps the weight's shape),
    the flattened 4-, 6- and 12-bit groups as ``[rows, cols / group, ...]``
    where ``cols`` is a whole number of groups. Raises
    ``NotImplementedError`` naming ROADMAP A5 part 3 where a cut would split
    a group."""
    R, C = qp.shape
    gs = min(qp.group_size, C) if qp.num_bits == 8 else qp.group_size
    ends = [e for span in spans for e in span] if dim == 1 else []
    if (qp.num_bits != 8 and C % gs) or any(e % gs and e != C for e in ends):
        raise NotImplementedError(
            f"a tensor-parallel cut of a {qp.num_bits}-bit [{R}, {C}] weight at {spans} "
            f"along dim {dim} would split its groups of {gs}; see ROADMAP.md queue A5 "
            "part 3")
    gspans = spans if dim == 0 else [(a // gs, -(-b // gs)) for a, b in spans]
    if qp.num_bits == 8:
        q, scale = take_spans(qp.q, dim, spans), take_spans(qp.scale, dim, gspans)
    else:
        q = take_spans(qp.q.reshape(R, C // gs, -1), dim, gspans)
        q = q.reshape(-1, qp.q.shape[-1]) if qp.q.dim() == 2 else q.reshape(-1)
        scale = take_spans(qp.scale.reshape(R, C // gs), dim, gspans).reshape(-1)
    n = sum(b - a for a, b in spans)
    return QuantizedParameter(q.contiguous(), scale.contiguous(),
                              (n, C) if dim == 0 else (R, n), qp.num_bits, qp.group_size)


def quantized_part(name, weight, plan, bias=None, num_bits=8, group_size=256, impl=None):
    """``quantized_linear`` of module ``name`` for rank ``plan.rank`` of a
    tensor-parallel group: ``weight`` is the WHOLE ``[out, in]`` weight,
    quantized whole in the JAX layout, then ``q`` and ``scale`` cut to the
    rank's part of ``{name}.weight`` (``plan.spans_of``; ``bias`` is the
    rank's already)."""
    raw = name.split(".")[-1] in RAW_WEIGHTS
    qp = QuantizedParameter.from_tensor(weight if raw else weight.T.contiguous(),
                                        num_bits, group_size)
    spans = plan.spans_of(f"{name}.weight")
    if spans is not None:
        dim, spans = spans
        # [out, in] -> the quantized layout: raw keeps it, a Dense kernel is [in, out]
        qp = cut_quantized(qp, dim if raw else 1 - dim, spans)
    return QuantizedLinear(qp, "nk" if raw else "kn", "dense_dequant" if raw else impl,
                           bias=bias)


def replace_module(model, name, new):
    parent, _, child = name.rpartition(".")
    setattr(model.get_submodule(parent) if parent else model, child, new)


def quantize_param_tree(model, num_bits=8, group_size=256, min_size=0, exclude=EXCLUDE,
                        impl=None):
    """Replace every quantized ``nn.Linear`` of ``model`` by a
    ``QuantizedLinear`` (``quantized_linear``), in place, one at a time:
    each dense weight is released as soon as its replacement exists.
    Returns ``model``."""
    for name, mod in list(_quantized_names(model, min_size, exclude)):
        replace_module(model, name, quantized_linear(
            name, mod.weight.detach(), mod.bias, num_bits, group_size, impl))
        del mod
    return model


def dequantize_param_tree(model, dtype=torch.bfloat16):
    """The model's state as dense tensors by parameter name: each
    ``QuantizedLinear`` dequantized to ``dtype`` in ``nn.Linear``'s
    ``[out, in]`` layout, every other parameter as it is."""
    out = {}
    for name, mod in model.named_modules():
        if isinstance(mod, QuantizedLinear):
            w = mod.qp.dequantized(dtype)
            out[f"{name}.weight"] = w.T if mod.layout == "kn" else w
    for name, p in model.named_parameters():
        out[name] = p.detach()
    return out


def quantized_nbytes(model):
    """Weight bytes of a model, quantized or not: every parameter, plus each
    ``QuantizedLinear``'s values and scales."""
    total = sum(p.numel() * p.element_size() for p in model.parameters())
    for mod in model.modules():
        if isinstance(mod, QuantizedLinear):
            total += mod.qp.nbytes
    return total
