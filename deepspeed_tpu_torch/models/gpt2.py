"""GPT-2 model family (port of ``deepspeed_tpu/models/gpt2.py``).

``GPT2Config`` with its presets (``tiny``, ``small`` 124M, ``medium`` 350M,
``large`` 774M) and ``GPT2LMHeadModel``: an ``nn.Module`` whose
``forward(batch)`` is the JAX model's ``__call__``. Pre-LayerNorm blocks
(LayerNorm statistics in fp32, as flax's ``LayerNorm`` keeps them under a
bf16 ``dtype``), causal attention through the ``mha`` flash kernels, a GELU
MLP (flax's ``nn.gelu``: the tanh approximation) and an embedding ``wte``
tied to the head: the training loss is ``lm_head_next_token_loss`` on
``wte``, and without labels the model returns the logits ``x @ wte.T``.
Dropout (``config.dropout``) follows the embedding and each block's two
projections, as in the JAX model; it draws from torch's generator, so
cross-package parity holds at dropout 0 only.

Parameter names follow the HuggingFace layout without its ``transformer.``
prefix (``h.0.attn.c_attn.weight``, ...). The projections are
``nn.Linear`` (``[out, in]``): a flax Dense kernel and an HF Conv1D weight
are both ``[in, out]``, so ``params_from_flax`` and the HF converter
transpose them. ``config.scan_layers`` records the JAX twin's layout: with
it each ``h.{i}`` leaf is one ``[n_layer, ...]`` leaf there
(``jax_stacked_layers``), which the optimizers' leaf-wide arithmetic and
qwZ read.
"""

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from deepspeed_tpu_torch import resolve_device
from deepspeed_tpu_torch.models.losses import lm_head_next_token_loss
from deepspeed_tpu_torch.ops.flash_attention import mha
from deepspeed_tpu_torch.runtime.activation_checkpointing import checkpointing


@dataclasses.dataclass(frozen=True)
class GPT2Config:
    vocab_size: int = 50257
    n_positions: int = 1024
    n_embd: int = 768
    n_layer: int = 12
    n_head: int = 12
    dropout: float = 0.0
    layer_norm_epsilon: float = 1e-5
    scan_layers: bool = True          # the JAX twin's layout (module docstring)
    remat: bool = True                # recompute blocks per the checkpointing policy
    dtype: torch.dtype = torch.bfloat16

    @staticmethod
    def tiny(**kw):
        return GPT2Config(vocab_size=512, n_positions=128, n_embd=64, n_layer=2,
                          n_head=4, **kw)

    @staticmethod
    def small(**kw):  # 124M
        return GPT2Config(**kw)

    @staticmethod
    def medium(**kw):  # 350M
        return GPT2Config(n_embd=1024, n_layer=24, n_head=16, **kw)

    @staticmethod
    def large(**kw):  # 774M
        return GPT2Config(n_embd=1280, n_layer=36, n_head=20, **kw)

    def num_parameters(self):
        D = self.n_embd
        per_layer = 12 * D * D + 13 * D      # qkv, proj, fc, fc-proj + biases + 2 norms
        return (self.vocab_size + self.n_positions) * D + self.n_layer * per_layer + 2 * D


def layer_norm(x, weight, bias, eps):
    """flax ``LayerNorm``: mean and variance (``E[x^2] - E[x]^2``, clipped at
    0) in fp32, the normalised value scaled and shifted in fp32, cast back
    to ``x``'s dtype."""
    x32 = x.float()
    mean = x32.mean(-1, keepdim=True)
    var = torch.clamp((x32 * x32).mean(-1, keepdim=True) - mean * mean, min=0.0)
    y = (x32 - mean) * (torch.rsqrt(var + eps) * weight.float()) + bias.float()
    return y.to(x.dtype)


class LayerNorm(nn.Module):

    def __init__(self, dim, eps, device=None):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim, dtype=torch.float32, device=device))
        self.bias = nn.Parameter(torch.zeros(dim, dtype=torch.float32, device=device))

    def forward(self, x):
        return layer_norm(x, self.weight, self.bias, self.eps)


class GPT2Attention(nn.Module):

    def __init__(self, cfg, device=None):
        super().__init__()
        kw = dict(device=device, dtype=cfg.dtype)
        self.c_attn = nn.Linear(cfg.n_embd, 3 * cfg.n_embd, **kw)
        self.c_proj = nn.Linear(cfg.n_embd, cfg.n_embd, **kw)
        self.config = cfg

    def forward(self, x, attention=mha):
        cfg = self.config
        B, T, D = x.shape
        H = cfg.n_head
        q, k, v = self.c_attn(x).split(D, dim=-1)
        shape = (B, T, H, D // H)
        out = attention(q.reshape(shape), k.reshape(shape), v.reshape(shape), causal=True)
        out = self.c_proj(out.reshape(B, T, D))
        return F.dropout(out, cfg.dropout, self.training)


class GPT2MLP(nn.Module):

    def __init__(self, cfg, device=None):
        super().__init__()
        kw = dict(device=device, dtype=cfg.dtype)
        self.c_fc = nn.Linear(cfg.n_embd, 4 * cfg.n_embd, **kw)
        self.c_proj = nn.Linear(4 * cfg.n_embd, cfg.n_embd, **kw)
        self.dropout = cfg.dropout

    def forward(self, x):
        h = self.c_proj(F.gelu(self.c_fc(x), approximate="tanh"))
        return F.dropout(h, self.dropout, self.training)


class GPT2Block(nn.Module):

    def __init__(self, cfg, device=None):
        super().__init__()
        self.ln_1 = LayerNorm(cfg.n_embd, cfg.layer_norm_epsilon, device)
        self.attn = GPT2Attention(cfg, device)
        self.ln_2 = LayerNorm(cfg.n_embd, cfg.layer_norm_epsilon, device)
        self.mlp = GPT2MLP(cfg, device)

    def forward(self, x, attention=mha):
        x = x + self.attn(self.ln_1(x), attention)
        return x + self.mlp(self.ln_2(x))


class GPT2LMHeadModel(nn.Module):
    """Weights of a GPT-2 LM: LayerNorm parameters fp32, every other weight
    ``config.dtype`` (the JAX model casts its fp32 params to that dtype at
    each use; storing them cast gives the same values). The forward computes
    in the dtype the embedding holds, the engine's working dtype when it
    trains the module.
    ``tp_size`` > 1 raises: training and serving GPT-2 over a tp axis is
    ROADMAP A12."""

    def __init__(self, config: GPT2Config, device=None, tp_size=1, tp_rank=0):
        super().__init__()
        if tp_size > 1:
            raise NotImplementedError(
                "tensor-parallel GPT-2 (the JAX model's param_specs over a tp axis) "
                "is not ported to deepspeed_tpu_torch yet: ROADMAP A12")
        self.config = config
        self.tp_size, self.plan = 1, None
        D = config.n_embd
        self.wte = nn.Embedding(config.vocab_size, D, device=device, dtype=config.dtype)
        self.wpe = nn.Embedding(config.n_positions, D, device=device, dtype=config.dtype)
        self.h = nn.ModuleList(GPT2Block(config, device) for _ in range(config.n_layer))
        self.ln_f = LayerNorm(D, config.layer_norm_epsilon, device)

    def jax_stacked_layers(self):
        """The JAX twin stacks its blocks under ``scan_layers`` (``h/block``):
        each ``h.{i}`` leaf is one ``[n_layer, ...]`` leaf there."""
        return ("h.", self.config.n_layer) if self.config.scan_layers else (None, 1)

    def init_parameter(self, name, tensor, generator):
        """Draw parameter ``name`` in place by ``from_seed``'s law (what
        ``zero.Init`` materialises with)."""
        init_parameter(name, tensor, generator)

    def streaming_plan(self):
        """The streaming protocol (JAX ``streaming_plan``): the blocks."""
        return {"num_blocks": len(self.h)}

    def forward(self, batch, attention=mha):
        """``batch``: a dict with ``input_ids`` [B, T] and optional
        ``labels``, or the ids alone. The next-token loss with labels, else
        the logits [B, T, V]. In training each block runs under the
        configured activation-checkpointing policy (``config.remat``);
        ``attention`` replaces ``mha`` (a plain version, for comparisons)."""
        cfg = self.config
        if isinstance(batch, dict):
            input_ids, labels = batch["input_ids"], batch.get("labels")
        else:
            input_ids, labels = batch, None
        input_ids = input_ids.long()
        T = input_ids.shape[1]
        dt = self.wte.weight.dtype
        x = F.embedding(input_ids, self.wte.weight) + self.wpe.weight[:T].to(dt)[None]
        x = F.dropout(x, cfg.dropout, self.training)
        for block in self.h:
            if cfg.remat:
                x = checkpointing.checkpoint(block, x, attention)
            else:
                x = block(x, attention)
        x = self.ln_f(x)
        if labels is None:
            return x @ self.wte.weight.T
        return lm_head_next_token_loss(x, self.wte.weight, labels)

    @classmethod
    def from_seed(cls, config: GPT2Config, seed: int, device=None):
        """Random weights on ``device`` (default ``"cuda"``) by the JAX init
        laws: ``wte`` N(0, 0.02), ``wpe`` N(0, 0.01), flax Dense's LeCun
        normal (truncated at 2 std, variance 1 / fan-in) for each kernel,
        zero biases, unit LayerNorm scales; each drawn in parameter order
        from one ``torch.Generator(seed)`` (the draws differ from JAX's)."""
        model = cls(config, device="meta")
        return init_from_seed(model, seed, device)


def init_from_seed(model, seed, device=None):
    """Materialise a ``GPT2LMHeadModel`` built on the meta device (see
    ``from_seed``); also what ``zero.Init`` runs one parameter at a time
    (``init_parameter``)."""
    device = resolve_device(device)
    model = model.to_empty(device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    with torch.no_grad():
        for name, p in model.named_parameters():
            init_parameter(name, p, gen)
    return model.requires_grad_(False)


def init_parameter(name, p, gen):
    """Draw parameter ``name`` of a GPT-2 model in place by the JAX model's
    init law (``from_seed``)."""
    if name == "wte.weight":
        p.normal_(0.0, 0.02, generator=gen)
    elif name == "wpe.weight":
        p.normal_(0.0, 0.01, generator=gen)
    elif name.endswith(".bias"):
        p.zero_()
    elif p.dim() == 1:
        p.fill_(1.0)
    else:
        # flax lecun_normal: a normal truncated to [-2, 2] std, scaled so the
        # variance is 1 / fan_in
        std = (1.0 / p.shape[1]) ** 0.5 / 0.87962566103423978
        torch.nn.init.trunc_normal_(p, 0.0, 1.0, -2.0, 2.0, generator=gen)
        p.mul_(std)


def gpt2_flops_per_token(cfg: GPT2Config, seq_len: int) -> float:
    """Approximate training FLOPs per token (6N + the attention term), the
    JAX package's formula, for the model-FLOPs share."""
    n_params = (cfg.vocab_size * cfg.n_embd + cfg.n_positions * cfg.n_embd
                + cfg.n_layer * (12 * cfg.n_embd ** 2) + cfg.n_embd * 2)
    return 6 * n_params + 12 * cfg.n_layer * cfg.n_embd * seq_len


_LINEARS = (("attn", "c_attn"), ("attn", "c_proj"), ("mlp", "c_fc"), ("mlp", "c_proj"))


def params_from_flax(tree):
    """The JAX ``GPT2LMHeadModel`` param tree (numpy arrays; scanned
    ``h/block/...`` stacked ``[L, ...]`` or unscanned ``h_{i}``) -> a state
    dict of this module. The same mapping converts a gradient tree. Dense
    kernels ``[in, out]`` are transposed to ``nn.Linear``'s ``[out, in]``;
    values are copied as fp32."""
    if "h" in tree:
        blk = tree["h"]["block"]
        L = np.asarray(blk["ln_1"]["scale"]).shape[0]
        layer = lambda i: _index_tree(blk, i)
    else:
        L = sum(1 for k in tree if k.startswith("h_"))
        layer = lambda i: tree[f"h_{i}"]
    sd = {"wte.weight": tree["wte"], "wpe.weight": tree["wpe"],
          "ln_f.weight": tree["ln_f"]["scale"], "ln_f.bias": tree["ln_f"]["bias"]}
    for i in range(L):
        lt, pre = layer(i), f"h.{i}."
        for ln in ("ln_1", "ln_2"):
            sd[pre + ln + ".weight"] = lt[ln]["scale"]
            sd[pre + ln + ".bias"] = lt[ln]["bias"]
        for grp, nm in _LINEARS:
            sd[f"{pre}{grp}.{nm}.weight"] = np.asarray(lt[grp][nm]["kernel"]).T
            sd[f"{pre}{grp}.{nm}.bias"] = lt[grp][nm]["bias"]
    return {k: torch.tensor(np.asarray(v, np.float32)) for k, v in sd.items()}


def _index_tree(tree, i):
    if isinstance(tree, dict):
        return {k: _index_tree(v, i) for k, v in tree.items()}
    return np.asarray(tree)[i]
