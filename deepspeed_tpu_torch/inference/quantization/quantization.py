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
``quantized_part`` gives one rank its part of the whole tensor's ``q`` and
``scale``, cut by the model's ``TPPlan`` (built with the group size, so
that column-split linears are cut in whole groups where the groups tile
them), so that the rank's dequantized weight is the whole tensor's
dequantized slice, bit for bit. At 8 bits a group's codes and scale depend
on that group alone, so it quantizes only the groups its part falls in,
from the whole tensor in blocks of rows: a rank holds its part and one row
block's temporaries besides the whole tensor, never the whole tensor's
codes or a transposed copy of it. Where a cut
does not fall on group boundaries (k/v heads inside a group, Falcon's fused
qkv, 4-, 6- and 12-bit groups that wrap rows) the rank keeps a
``QuantizedPart``: its elements' codes with the whole tensor's scales,
dequantized element by element as the whole tensor is.

Row 7 takes whole groups only (``ops/quantized_matmul.py``), and the JAX
kernel's ``accept`` hands other shapes to XLA
(``ops/pallas/quantized_matmul.py:128-131``). So an 8-bit weight whose last
group is padded (Falcon-7B's fused qkv N 4672 and ``dense`` N 4544 in
groups of 256) or a ``QuantizedPart`` takes ``dense_dequant`` by the route
``kernel_gap`` declares, and the v1 engine logs each such linear.
"""

import functools

import torch
from torch import nn

from deepspeed_tpu_torch.ops.fp_quantizer import (FORMATS, decode, dequantize_fp, quantize_fp,
                                                  unpack_codes)
from deepspeed_tpu_torch.parallel.tensor_parallel import take_spans
from deepspeed_tpu_torch.ops.quantizer import (dequantize, dequantize_lastdim,
                                               quantize, quantize_lastdim)

EXCLUDE = ("embed", "norm", "bias", "scale")
# elements a block of rows quantizes at once (8 bits): 16 MB of fp32
LASTDIM_CHUNK = 1 << 22
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
        """Quantize ``w``; at 8 bits in blocks of rows written into the
        outputs (the groups run along the last axis, so the bits are the
        whole tensor's), which bounds the fp32 temporaries by
        ``LASTDIM_CHUNK`` elements; ``w`` may be a strided view (a
        transposed weight), each block is read from it."""
        if num_bits in (6, 12):
            q, s = quantize_fp(w, bits=num_bits, group_size=group_size)
        elif num_bits == 8:
            rows = w.reshape(-1, w.shape[-1]) if w.dim() else w.reshape(1, 1)
            R, C = rows.shape
            groups = -(-C // min(group_size, C))
            q = torch.empty(R, C, dtype=torch.int8, device=w.device)
            s = torch.empty(R, groups, dtype=torch.float32, device=w.device)
            step = max(1, LASTDIM_CHUNK // C)
            for a in range(0, R, step):
                q[a:a + step], s[a:a + step] = quantize_lastdim(rows[a:a + step],
                                                                group_size=group_size)
            q, s = q.reshape(w.shape), s.reshape(*w.shape[:-1], groups)
        else:
            q, s = quantize(w, num_bits=num_bits, group_size=group_size)
        return cls(q, s, w.shape, num_bits, group_size)

    def dequantized(self, dtype=torch.bfloat16):
        if 0 in self.shape:
            return torch.zeros(self.shape, dtype=dtype, device=self.q.device)
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
        x2 = x.flatten(0, -2)
        _, fn = instantiate_linear(x2.shape[0], K, N, self.group_size, self.num_bits,
                                   ndim=len(self.shape), preference=impl, dtype=x.dtype,
                                   device_type=x.device.type)
        out = fn(x2, self, out_dtype)
        return out.reshape(*x.shape[:-1], out.shape[-1])

    @property
    def nbytes(self):
        return self.q.numel() * self.q.element_size() + \
            self.scale.numel() * self.scale.element_size()


def element_codes(qp):
    """The integer codes of every element of a whole ``QuantizedParameter``,
    in the weight's shape: int8 values (8- and 4-bit, sign-extended), int16
    small-float codes (6- and 12-bit)."""
    R, C = qp.shape
    if qp.num_bits == 8:
        return qp.q
    if qp.num_bits == 4:
        qi = qp.q.to(torch.int16)
        lo, hi = qi & 0xF, (qi >> 4) & 0xF
        vals = torch.stack([torch.where(lo > 7, lo - 16, lo),
                            torch.where(hi > 7, hi - 16, hi)], dim=-1).reshape(-1)
        return vals[:R * C].reshape(R, C).to(torch.int8)
    return unpack_codes(qp.q, R * C, qp.num_bits).reshape(R, C).to(torch.int16)


class QuantizedPart:
    """A tensor-parallel rank's part of a whole ``QuantizedParameter`` at
    element ``spans`` along ``dim`` of the whole ``[rows, cols]`` weight,
    where the cut does not fall on group boundaries: the part's element
    codes (``element_codes``) and the WHOLE tensor's scales, so that
    ``dequantized`` gives the same bits as the whole tensor's dequantized
    slice. Only ``dense_dequant`` multiplies it."""

    def __init__(self, q, scale, shape, num_bits, group_size, whole, dim, spans):
        self.q, self.scale = q, scale
        self.shape = tuple(int(x) for x in shape)
        self.num_bits, self.group_size = int(num_bits), int(group_size)
        self.whole, self.dim = tuple(int(x) for x in whole), int(dim)
        self.spans = [tuple(int(e) for e in sp) for sp in spans]

    def _scales(self):
        """Each element's fp32 scale, in the part's shape."""
        R, C = self.whole
        dev = self.scale.device
        idx = torch.cat([torch.arange(a, b, device=dev) for a, b in self.spans]) \
            if self.spans else torch.zeros(0, dtype=torch.long, device=dev)
        rows = idx if self.dim == 0 else torch.arange(R, device=dev)
        cols = idx if self.dim == 1 else torch.arange(C, device=dev)
        if self.num_bits == 8:                    # groups along the last axis
            return self.scale[rows[:, None], (cols // min(self.group_size, C))[None, :]]
        return self.scale[(rows[:, None] * C + cols[None, :]) // self.group_size]

    def dequantized(self, dtype=torch.bfloat16):
        if self.num_bits in (6, 12):
            vals = decode(self.q, *FORMATS[self.num_bits])
        else:
            vals = self.q.float()
        return (vals * self._scales()).to(dtype)

    @property
    def nbytes(self):
        return self.q.numel() * self.q.element_size() + \
            self.scale.numel() * self.scale.element_size()


def kernel_gap(qp):
    """Why row 7 cannot take this 8-bit ``[K, N]`` weight, or None: a
    ``QuantizedPart``, an empty share, or a padded last group (module
    docstring). Such a linear takes ``dense_dequant`` by this declared
    route."""
    if isinstance(qp, QuantizedPart):
        return "a tensor-parallel cut splits its groups"
    if 0 in qp.shape:
        return "an empty tensor-parallel share (nothing to launch)"
    N = qp.shape[-1]
    gs = min(qp.group_size, N) if N else 0
    if gs and N % gs:
        return f"N {N} ends in a padded group of {gs} (row 7 takes whole groups)"
    return None


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
        self._part = (qp.whole, qp.dim, qp.spans) if isinstance(qp, QuantizedPart) else None
        self.layout = layout
        self.bias = bias
        # the declared route to dense_dequant of a weight row 7 cannot take
        self.gap = kernel_gap(qp) if layout == "kn" and qp.num_bits == 8 else None
        self.set_impl(impl)

    def set_impl(self, impl):
        """Pin the product to a registry row ("cuda_fused_dequant" or
        "dense_dequant"); raises if the row cannot serve this weight. The
        kernel's choice (None or "auto") on a weight with a ``gap`` is
        ``dense_dequant``."""
        from deepspeed_tpu_torch.inference.v2.modules.heuristics import instantiate_linear
        if impl in (None, "auto") and self.gap:
            impl = "dense_dequant"
        if impl != "dense_dequant" and (self.layout != "kn" or self._part):
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
        if self._part:
            return QuantizedPart(self.q, self.scale, self.shape, self.num_bits,
                                 self.group_size, *self._part)
        return QuantizedParameter(self.q, self.scale, self.shape, self.num_bits,
                                  self.group_size)

    def product(self, x):
        """``x @ dequant(W)`` without the bias (a row-split linear's partial
        product under tensor parallelism)."""
        if self.impl != "dense_dequant" and x.dtype != V1_TILE_DTYPE:
            raise TypeError(f"{self.impl} rounds the weight to the activations' dtype "
                            f"{x.dtype}; this linear's weights round to "
                            f"{V1_TILE_DTYPE}: pin dense_dequant")
        out = self._fn(x.flatten(0, -2), self.qp, x.dtype)
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
    (0: rows, 1: columns). Where the cut tiles the groups, a
    ``QuantizedParameter`` of whole groups: 8-bit ``q`` and its scale
    columns cut directly (``quantize_lastdim`` keeps the weight's shape; a
    padded last group stays padded), the flattened 4-, 6- and 12-bit groups
    as ``[rows, cols / group, ...]``. Elsewhere (a cut inside a group, or
    flattened groups that wrap rows) a ``QuantizedPart``, the same bits of
    the whole."""
    R, C = qp.shape
    gs = min(qp.group_size, C) if qp.num_bits == 8 else qp.group_size
    ends = [e for span in spans for e in span] if dim == 1 else []
    n = sum(b - a for a, b in spans)
    shape = (n, C) if dim == 0 else (R, n)
    if (qp.num_bits != 8 and C % gs) or any(e % gs and e != C for e in ends):
        q = take_spans(element_codes(qp), dim, spans)
        q = q.clone(memory_format=torch.contiguous_format)
        return QuantizedPart(q, qp.scale, shape, qp.num_bits, qp.group_size, (R, C), dim,
                             spans)
    gspans = spans if dim == 0 else [(a // gs, -(-b // gs)) for a, b in spans]
    if qp.num_bits == 8:
        q, scale = take_spans(qp.q, dim, spans), take_spans(qp.scale, dim, gspans)
    else:
        q = take_spans(qp.q.reshape(R, C // gs, -1), dim, gspans)
        q = q.reshape(-1, qp.q.shape[-1]) if qp.q.dim() == 2 else q.reshape(-1)
        scale = take_spans(qp.scale.reshape(R, C // gs), dim, gspans).reshape(-1)
    # copies: a view (a row cut of contiguous codes is one) would keep the
    # whole tensor's codes alive
    own = torch.contiguous_format
    return QuantizedParameter(q.clone(memory_format=own), scale.clone(memory_format=own),
                              shape, qp.num_bits, qp.group_size)


def _group_cover(spans, gs, C):
    """Element ``spans`` along a last axis of ``C`` widened to whole groups
    of ``gs`` and merged, in order."""
    cover = []
    for a, b in sorted((a // gs * gs, min(-(-b // gs) * gs, C)) for a, b in spans):
        if cover and a <= cover[-1][1]:
            cover[-1] = (cover[-1][0], max(cover[-1][1], b))
        else:
            cover.append((a, b))
    return cover


def _lastdim_part(w, dim, spans, group_size):
    """The 8-bit ``cut_quantized`` of the whole ``[rows, cols]`` weight
    ``w`` (a view in the quantized layout) at ``spans`` along ``dim``,
    quantizing only the groups the part falls in: its rows (``dim`` 0), or
    its columns widened to whole groups (``dim`` 1), cut afterwards."""
    spans = [(a, b) for a, b in spans if b > a]
    if dim == 0:
        return QuantizedParameter.from_tensor(take_spans(w, 0, spans), 8, group_size)
    R, C = w.shape
    if not spans:
        return QuantizedParameter(torch.empty(R, 0, dtype=torch.int8, device=w.device),
                                  torch.empty(R, 0, device=w.device), (R, 0), 8, group_size)
    cover = _group_cover(spans, min(group_size, C), C)
    starts = [0]
    for a, b in cover:
        starts.append(starts[-1] + b - a)
    rel = []
    for a, b in spans:
        i = next(i for i, (c0, c1) in enumerate(cover) if c0 <= a and b <= c1)
        rel.append((starts[i] + a - cover[i][0], starts[i] + b - cover[i][0]))
    qp = QuantizedParameter.from_tensor(take_spans(w, 1, cover), 8, group_size)
    return cut_quantized(qp, 1, rel)


def quantized_part(name, weight, plan, bias=None, num_bits=8, group_size=256, impl=None):
    """``quantized_linear`` of module ``name`` for rank ``plan.rank`` of a
    tensor-parallel group: ``weight`` is the WHOLE ``[out, in]`` weight;
    ``q`` and ``scale`` are the rank's part of ``{name}.weight``
    (``plan.spans_of``) of the whole tensor quantized in the JAX layout,
    bit for bit (``bias`` is the rank's already). At 8 bits only the
    groups the part falls in are quantized (module docstring); at 4, 6 and
    12 bits, whose flat groups wrap rows, the whole tensor is."""
    raw = name.split(".")[-1] in RAW_WEIGHTS
    # [out, in] -> the quantized layout: raw keeps it, a Dense kernel is [in, out]
    w = weight if raw else weight.T
    spans = plan.spans_of(f"{name}.weight")
    if num_bits == 8:
        qp = QuantizedParameter.from_tensor(w, 8, group_size) if spans is None else \
            _lastdim_part(w, spans[0] if raw else 1 - spans[0], spans[1], group_size)
    else:
        qp = QuantizedParameter.from_tensor(w.contiguous(), num_bits, group_size)
        if spans is not None:
            qp = cut_quantized(qp, spans[0] if raw else 1 - spans[0], spans[1])
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
