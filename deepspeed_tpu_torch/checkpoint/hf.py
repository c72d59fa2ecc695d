"""HuggingFace checkpoint interop (port of ``deepspeed_tpu/checkpoint/hf.py``).

HF checkpoint directories in, the port's modules out (``load_pretrained``),
and the inverse export (``export_pretrained``), which ``transformers``'
``from_pretrained`` reads. The port reads and writes safetensors itself and
reads ``config.json`` itself: it imports neither ``transformers`` nor
``safetensors``.

- safetensors: an 8-byte little-endian header length, a JSON header (per
  tensor its dtype, shape and ``data_offsets``; ``__metadata__``), then the
  raw bytes. ``read_safetensors`` maps the file copy-on-write and hands
  back tensors in their stored dtype that view the mapping: bf16 stays
  bf16 (the JAX package widens every bf16 tensor to fp32 on the host).
  ``load_pretrained`` moves them to the device one at a time and converts
  them there, so the host never holds a second copy of the model.
- ``config.json``: ``read_hf_config`` applies, for a key the file omits,
  the default that ``transformers``' config class for the family applies
  (``HF_DEFAULTS``, one table per family, with the derived values of
  ``_derive``), so the converters read what ``AutoConfig`` would give them.
- Conventions: ``nn.Linear`` stores ``[out, in]`` in both layouts, so the
  port's state dicts keep HF's matrices; HF's llama-family rotary is
  half-split (pairs ``(j, j + d/2)``) while the port rotates interleaved
  pairs ``(2j, 2j+1)``, as the JAX package does, so q/k projection rows are
  permuted per head (``_permute_qk_rows``; for Phi only the rotated slice),
  and the export applies the inverse.

Families: llama / mistral / qwen2 / qwen (v1) / internlm into
``LlamaForCausalLM``, mixtral into ``MixtralForCausalLM``, opt into
``OPTForCausalLM``, falcon and phi into ``ParallelBlockForCausalLM``. The
families the JAX package also converts but the port has no model for raise
``NotImplementedError`` naming their queue item (``UNPORTED``).
"""

import json
import math
import mmap
import os
import re
import types

import torch
from torch import nn

from deepspeed_tpu_torch import resolve_device
from deepspeed_tpu_torch.parallel.tensor_parallel import take_spans
from deepspeed_tpu_torch.utils.logging import logger

LLAMA_FAMILY = ("llama", "mistral", "qwen2")
SUPPORTED = LLAMA_FAMILY + ("gpt2", "opt", "mixtral", "falcon", "phi", "bloom",
                            "gpt_neox", "gptj", "bert", "roberta",
                            "distilbert", "qwen", "internlm")
# families the JAX package converts whose models the port lacks: the queue
# item of ROADMAP.md that brings each
UNPORTED = {"gpt2": "A1 part 2", "bloom": "A12", "gpt_neox": "A12", "gptj": "A12",
            "bert": "A12", "roberta": "A12", "distilbert": "A12"}


class UnsupportedModelError(ValueError):
    """Model family the converters don't cover — callers may fall back
    (e.g. ``save_16bit_model`` degrades to an npz dump on exactly this)."""


# ---------------------------------------------------------------------------
# safetensors IO
# ---------------------------------------------------------------------------

ST_DTYPES = {"F64": torch.float64, "F32": torch.float32, "F16": torch.float16,
             "BF16": torch.bfloat16, "I64": torch.int64, "I32": torch.int32,
             "I16": torch.int16, "I8": torch.int8, "U8": torch.uint8, "BOOL": torch.bool}
_ST_NAMES = {v: k for k, v in ST_DTYPES.items()}


def read_safetensors(path):
    """{name: tensor} of one safetensors file, each in its stored dtype and
    shape. The file is mapped copy-on-write: a tensor views the mapping (the
    page cache) until it is written to or moved."""
    with open(path, "rb") as f:
        n = int.from_bytes(f.read(8), "little")
        header = json.loads(f.read(n))
        size = os.fstat(f.fileno()).st_size
        buf = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY) if size > 8 + n else b""
    base = 8 + n
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        dtype = ST_DTYPES.get(info["dtype"])
        if dtype is None:
            raise ValueError(f"{path}: {name} has dtype {info['dtype']}, which the "
                             f"reader does not take ({sorted(ST_DTYPES)})")
        begin, end = info["data_offsets"]
        shape = tuple(info["shape"])
        count = math.prod(shape)
        itemsize = torch.empty((), dtype=dtype).element_size()
        if end - begin != count * itemsize or base + end > size:
            raise ValueError(f"{path}: {name} spans bytes [{begin}, {end}), which "
                             f"do not hold {dtype} {list(shape)}")
        if count == 0:
            t = torch.empty(shape, dtype=dtype)
        elif (base + begin) % itemsize:
            # an unaligned tensor is copied out of the mapping
            t = torch.frombuffer(bytearray(buf[base + begin:base + end]), dtype=dtype)
        else:
            t = torch.frombuffer(buf, dtype=dtype, count=count, offset=base + begin)
        out[name] = t.reshape(shape)
    return out


def save_safetensors(state_dict, model_dir, filename="model.safetensors", dtype=None):
    """Write ``state_dict`` ({name: tensor}, on any device) as one
    safetensors file in ``model_dir``; floating tensors are cast to
    ``dtype`` when it is given. The header is written first, then each
    tensor's bytes, one tensor at a time through the host. Returns the
    path."""
    items = [(k, v.detach()) for k, v in state_dict.items()]
    dtypes = [dtype if dtype is not None and t.is_floating_point() else t.dtype
              for _, t in items]
    header, off = {"__metadata__": {"format": "pt"}}, 0
    for (name, t), dt in zip(items, dtypes):
        nbytes = t.numel() * torch.empty((), dtype=dt).element_size()
        header[name] = {"dtype": _ST_NAMES[dt], "shape": list(t.shape),
                        "data_offsets": [off, off + nbytes]}
        off += nbytes
    raw = json.dumps(header, separators=(",", ":")).encode()
    raw += b" " * (-len(raw) % 8)          # the data start 8-byte aligned
    os.makedirs(model_dir, exist_ok=True)
    path = os.path.join(model_dir, filename)
    with open(path, "wb") as f:
        f.write(len(raw).to_bytes(8, "little"))
        f.write(raw)
        for (_, t), dt in zip(items, dtypes):
            host = t.to(dt).contiguous().cpu()
            f.write(host.reshape(-1).view(torch.uint8).numpy())
    return path


def load_state_dict(model_dir):
    """Every ``*.safetensors`` (preferred; a sharded directory's files and,
    with ``model.safetensors.index.json``, a check that each tensor it maps
    was found) or ``pytorch_model*.bin`` in ``model_dir`` as one {name:
    tensor} dict in the stored dtypes, on the host."""
    st_files = sorted(f for f in os.listdir(model_dir) if f.endswith(".safetensors"))
    sd = {}
    if st_files:
        for f in st_files:
            sd.update(read_safetensors(os.path.join(model_dir, f)))
        index = os.path.join(model_dir, "model.safetensors.index.json")
        if os.path.exists(index):
            with open(index) as f:
                missing = set(json.load(f)["weight_map"]) - set(sd)
            if missing:
                raise FileNotFoundError(f"{model_dir}: the index maps tensors no "
                                        f"shard holds: {sorted(missing)[:5]}")
        return sd
    bin_files = sorted(f for f in os.listdir(model_dir)
                       if re.match(r"pytorch_model.*\.bin$", f))
    if not bin_files:
        raise FileNotFoundError(f"no safetensors/bin weights in {model_dir}")
    for f in bin_files:
        sd.update(torch.load(os.path.join(model_dir, f), map_location="cpu",
                             weights_only=True, mmap=True))
    return sd


def detect_model_type(model_dir):
    with open(os.path.join(model_dir, "config.json")) as f:
        return json.load(f)["model_type"]


# ---------------------------------------------------------------------------
# config.json, as transformers' config classes read it
# ---------------------------------------------------------------------------

# Per family, the keys the converters read and the default transformers'
# config class (4.57) applies where the file omits one; None is resolved by
# _derive. qwen (v1) and internlm have no transformers class (remote code):
# their rows are the defaults the JAX readers apply, and the keys in
# _REQUIRED have none.
HF_DEFAULTS = {
    "llama": dict(vocab_size=32000, hidden_size=4096, intermediate_size=11008,
                  num_hidden_layers=32, num_attention_heads=32,
                  num_key_value_heads=None, max_position_embeddings=2048,
                  rms_norm_eps=1e-6, rope_theta=10000.0, attention_bias=False,
                  head_dim=None),
    "mistral": dict(vocab_size=32000, hidden_size=4096, intermediate_size=14336,
                    num_hidden_layers=32, num_attention_heads=32, num_key_value_heads=8,
                    head_dim=None, max_position_embeddings=131072, rms_norm_eps=1e-6,
                    rope_theta=10000.0, sliding_window=4096),
    "qwen2": dict(vocab_size=151936, hidden_size=4096, intermediate_size=22016,
                  num_hidden_layers=32, num_attention_heads=32, num_key_value_heads=32,
                  max_position_embeddings=32768, rms_norm_eps=1e-6, rope_theta=10000.0,
                  use_sliding_window=False, sliding_window=4096),
    "mixtral": dict(vocab_size=32000, hidden_size=4096, intermediate_size=14336,
                    num_hidden_layers=32, num_attention_heads=32, num_key_value_heads=8,
                    head_dim=None, max_position_embeddings=131072, rms_norm_eps=1e-5,
                    rope_theta=1e6, sliding_window=None, num_experts_per_tok=2,
                    num_local_experts=8),
    "opt": dict(vocab_size=50272, hidden_size=768, num_hidden_layers=12, ffn_dim=3072,
                max_position_embeddings=2048, do_layer_norm_before=True,
                word_embed_proj_dim=None, num_attention_heads=12),
    "falcon": dict(vocab_size=65024, hidden_size=4544, num_hidden_layers=32,
                   num_attention_heads=71, num_kv_heads=None, layer_norm_epsilon=1e-5,
                   alibi=False, new_decoder_architecture=False, multi_query=True,
                   parallel_attn=True, bias=False, max_position_embeddings=2048,
                   rope_theta=10000.0, ffn_hidden_size=None, tie_word_embeddings=True),
    "phi": dict(vocab_size=51200, hidden_size=2048, intermediate_size=8192,
                num_hidden_layers=24, num_attention_heads=32, num_key_value_heads=None,
                hidden_act="gelu_new", max_position_embeddings=2048, layer_norm_eps=1e-5,
                rope_theta=10000.0, partial_rotary_factor=0.5),
    "qwen": dict(seq_length=2048, layer_norm_epsilon=1e-6, rotary_emb_base=10000.0,
                 kv_channels=None, no_bias=True, use_dynamic_ntk=False,
                 use_logn_attn=False),
    "internlm": dict(num_key_value_heads=None, max_position_embeddings=2048,
                     rms_norm_eps=1e-6, rope_theta=10000.0, head_dim=None, bias=True),
}
_REQUIRED = ("vocab_size", "hidden_size", "intermediate_size", "num_hidden_layers",
             "num_attention_heads")


def _derive(mt, c):
    """The values transformers' config ``__init__`` derives from others."""
    if mt in ("llama", "mistral", "qwen2", "mixtral", "phi", "internlm") \
            and c.num_key_value_heads is None:
        c.num_key_value_heads = c.num_attention_heads
    if mt == "llama" and c.head_dim is None:
        c.head_dim = c.hidden_size // c.num_attention_heads
    if mt == "qwen2" and not c.use_sliding_window:
        c.sliding_window = None
    if mt == "opt" and c.word_embed_proj_dim is None:
        c.word_embed_proj_dim = c.hidden_size
    if mt == "falcon":
        if c.num_kv_heads is None:
            c.num_kv_heads = c.num_attention_heads
        if c.ffn_hidden_size is None:
            c.ffn_hidden_size = 4 * c.hidden_size


def read_hf_config(model_dir):
    """``config.json`` of ``model_dir`` as an attribute namespace: the
    file's keys over the family's ``HF_DEFAULTS``, with the derived values
    resolved, as ``transformers.AutoConfig`` reads the keys the converters
    use. A family without a table keeps the file's keys alone."""
    with open(os.path.join(model_dir, "config.json")) as f:
        raw = json.load(f)
    mt = raw["model_type"]
    if mt in ("qwen", "internlm"):
        missing = [k for k in _REQUIRED if k not in raw]
        if missing:
            raise KeyError(f"{model_dir}/config.json ({mt}) lacks {missing}")
    if mt == "falcon" and raw.get("n_embed") is not None:
        raw = dict(raw, hidden_size=raw["n_embed"])     # FalconConfig's alias
    c = types.SimpleNamespace(**{**HF_DEFAULTS.get(mt, {}), **raw})
    _derive(mt, c)
    return c


# ---------------------------------------------------------------------------
# rotary convention permutation (half-split <-> interleaved)
# ---------------------------------------------------------------------------

def _rotary_perm(dh):
    """perm such that interleaved[..., p[i]] reads half-split[..., i]."""
    perm = torch.empty(dh, dtype=torch.long)
    perm[0::2] = torch.arange(dh // 2)
    perm[1::2] = torch.arange(dh // 2) + dh // 2
    return perm


def _permute_qk_rows(w, n_heads, dh, inverse=False, rotary_dim=None):
    """Permute the per-head output rows (dim 0) of a q/k projection weight
    [H*Dh, in] or bias [H*Dh] between rotary conventions. ``rotary_dim`` <
    dh permutes only the rotated slice (phi partial rotary)."""
    rd = dh if rotary_dim is None else rotary_dim
    perm = torch.cat([_rotary_perm(rd), torch.arange(rd, dh)])
    if inverse:
        perm = torch.argsort(perm)
    # whole heads: a tensor-parallel rank's rows hold fewer than n_heads
    shaped = w.reshape(w.shape[0] // dh, dh, *w.shape[1:])
    return shaped[:, perm.to(w.device)].reshape(w.shape)


# ---------------------------------------------------------------------------
# HF state dict -> the port's state dicts. Each converter yields (name,
# tensor) pairs of the port module's state dict; ``g(name)`` fetches one HF
# tensor (in load_pretrained: moved to the device and cast there), so the
# conversions run where the weights land.
# ---------------------------------------------------------------------------

def _llama_layers(sd, cfg, g):
    """The norms and attention projections of HF llama-named layers."""
    H, KV, Dh = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim
    for i in range(cfg.num_hidden_layers):
        p, o = f"model.layers.{i}.", f"layers.{i}."
        yield o + "input_layernorm.weight", g(p + "input_layernorm.weight")
        yield o + "post_attention_layernorm.weight", g(p + "post_attention_layernorm.weight")
        for nm, heads in (("q_proj", H), ("k_proj", KV), ("v_proj", None),
                          ("o_proj", None)):   # o bias: InternLM family
            for kind in ("weight", "bias"):
                name = p + f"self_attn.{nm}.{kind}"
                if name in sd:
                    t = g(name)
                    yield (o + f"self_attn.{nm}.{kind}",
                           _permute_qk_rows(t, heads, Dh) if heads else t)


def llama_to_torch(sd, cfg, g):
    """HF llama/mistral/qwen2/internlm -> ``LlamaForCausalLM``."""
    yield "embed_tokens.weight", g("model.embed_tokens.weight")
    yield "norm.weight", g("model.norm.weight")
    yield "lm_head.weight", g("lm_head.weight" if "lm_head.weight" in sd
                              else "model.embed_tokens.weight")
    yield from _llama_layers(sd, cfg, g)
    for i in range(cfg.num_hidden_layers):
        for nm in ("gate_proj", "up_proj", "down_proj"):
            yield f"layers.{i}.mlp.{nm}.weight", g(f"model.layers.{i}.mlp.{nm}.weight")


def qwen_to_torch(sd, cfg, g):
    """Qwen-v1 (``QWenLMHeadModel``, remote code) -> ``LlamaForCausalLM``:
    the fused biased ``c_attn`` rows q|k|v split (no GQA), the unbiased
    ``c_proj`` output, and the swapped-gate MLP ``w1(x) * silu(w2(x))``
    (gate_proj = w2, up_proj = w1, down_proj = c_proj). Reference policy:
    ``deepspeed/module_inject/containers/qwen.py``."""
    H, Dh, D = cfg.num_attention_heads, cfg.head_dim, cfg.hidden_size
    yield "embed_tokens.weight", g("transformer.wte.weight")
    yield "norm.weight", g("transformer.ln_f.weight")
    yield "lm_head.weight", g("lm_head.weight")
    for i in range(cfg.num_hidden_layers):
        p, o = f"transformer.h.{i}.", f"layers.{i}."
        yield o + "input_layernorm.weight", g(p + "ln_1.weight")
        yield o + "post_attention_layernorm.weight", g(p + "ln_2.weight")
        w, b = g(p + "attn.c_attn.weight"), g(p + "attn.c_attn.bias")
        for j, nm in enumerate(("q_proj", "k_proj", "v_proj")):
            wj, bj = w[j * D:(j + 1) * D], b[j * D:(j + 1) * D]
            if nm != "v_proj":
                wj, bj = _permute_qk_rows(wj, H, Dh), _permute_qk_rows(bj, H, Dh)
            yield o + f"self_attn.{nm}.weight", wj
            yield o + f"self_attn.{nm}.bias", bj
        yield o + "self_attn.o_proj.weight", g(p + "attn.c_proj.weight")
        yield o + "mlp.gate_proj.weight", g(p + "mlp.w2.weight")
        yield o + "mlp.up_proj.weight", g(p + "mlp.w1.weight")
        yield o + "mlp.down_proj.weight", g(p + "mlp.c_proj.weight")


def mixtral_to_torch(sd, cfg, g):
    """HF Mixtral -> ``MixtralForCausalLM`` (router ``wg`` [D, E], experts
    stacked [E, in, out])."""
    yield "embed_tokens.weight", g("model.embed_tokens.weight")
    yield "norm.weight", g("model.norm.weight")
    yield "lm_head.weight", g("lm_head.weight" if "lm_head.weight" in sd
                              else "model.embed_tokens.weight")
    yield from _llama_layers(sd, cfg, g)
    for i in range(cfg.num_hidden_layers):
        p, o = f"model.layers.{i}.block_sparse_moe.", f"layers.{i}.block_sparse_moe."
        yield o + "gate.wg", g(p + "gate.weight").T
        for w in ("w1", "w2", "w3"):
            yield o + f"experts.{w}", torch.stack(
                [g(p + f"experts.{e}.{w}.weight").T
                 for e in range(cfg.num_local_experts)])


def opt_to_torch(sd, cfg, g):
    """HF OPT -> ``OPTForCausalLM``: the names under ``model.decoder.``
    (the head is the tied embedding)."""
    pre = "model.decoder." if "model.decoder.embed_tokens.weight" in sd else "decoder."
    names = ["embed_tokens.weight", "embed_positions.weight", "final_layer_norm.weight",
             "final_layer_norm.bias"]
    for i in range(cfg.num_hidden_layers):
        for nm in ("self_attn.q_proj", "self_attn.k_proj", "self_attn.v_proj",
                   "self_attn.out_proj", "self_attn_layer_norm", "final_layer_norm",
                   "fc1", "fc2"):
            names += [f"layers.{i}.{nm}.weight", f"layers.{i}.{nm}.bias"]
    for name in names:
        yield name, g(pre + name)


def _falcon_split_qkv(fused, H, KV, Dh, interleaved):
    """Fused QKV wire layout -> (q, k, v) on the OUTPUT rows (dim 0).

    multi_query=True stores contiguous blocks [H q | KV k | KV v];
    multi_query=False stores per-head interleaved [H, (q,k,v), Dh]."""
    if not interleaved:
        return fused[:H * Dh], fused[H * Dh:(H + KV) * Dh], fused[(H + KV) * Dh:]
    shaped = fused.reshape(H, 3, Dh, *fused.shape[1:])
    return tuple(shaped[:, j].reshape(H * Dh, *fused.shape[1:]) for j in range(3))


def _fuse_qkv_interleaved(q, k, v, H, Dh):
    """Inverse of ``_falcon_split_qkv(..., interleaved=True)``."""
    rest = q.shape[1:]
    return torch.stack([a.reshape(H, Dh, *rest) for a in (q, k, v)], dim=1).reshape(
        3 * H * Dh, *rest)


def falcon_to_torch(sd, cfg, g):
    """HF Falcon (7b lineage: parallel_attn, rotary) ->
    ``ParallelBlockForCausalLM``, from the multi_query (block QKV) or the
    per-head-interleaved layout, with or without linear biases."""
    H, KV, Dh = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim
    interleaved = KV == H
    pre = "transformer." if "transformer.word_embeddings.weight" in sd else ""

    def qkv(t):
        q, k, v = _falcon_split_qkv(t, H, KV, Dh, interleaved)
        return torch.cat([_permute_qk_rows(q, H, Dh), _permute_qk_rows(k, KV, Dh), v])

    yield "embed_tokens.weight", g(pre + "word_embeddings.weight")
    yield "final_layernorm.weight", g(pre + "ln_f.weight")
    yield "final_layernorm.bias", g(pre + "ln_f.bias")
    if not cfg.tie_lm_head:
        yield "lm_head.weight", g("lm_head.weight" if "lm_head.weight" in sd
                                  else pre + "word_embeddings.weight")
    for i in range(cfg.num_hidden_layers):
        p, o = f"{pre}h.{i}.", f"layers.{i}."
        for kind in ("weight", "bias"):
            yield o + f"input_layernorm.{kind}", g(p + f"input_layernorm.{kind}")
            for ours, theirs in (("query_key_value", "self_attention.query_key_value"),
                                 ("dense", "self_attention.dense"),
                                 ("fc1", "mlp.dense_h_to_4h"), ("fc2", "mlp.dense_4h_to_h")):
                name = p + f"{theirs}.{kind}"
                if name in sd:
                    t = g(name)
                    yield o + f"{ours}.{kind}", qkv(t) if ours == "query_key_value" else t


def phi_to_torch(sd, cfg, g):
    """HF Phi (phi-1.5/phi-2) -> ``ParallelBlockForCausalLM`` (partial
    rotary, biases everywhere)."""
    H, KV, Dh, rd = (cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim,
                     cfg.rotary_dim)
    yield "embed_tokens.weight", g("model.embed_tokens.weight")
    yield "final_layernorm.weight", g("model.final_layernorm.weight")
    yield "final_layernorm.bias", g("model.final_layernorm.bias")
    yield "lm_head.weight", g("lm_head.weight")
    if "lm_head.bias" in sd:
        yield "lm_head.bias", g("lm_head.bias")
    for i in range(cfg.num_hidden_layers):
        p, o = f"model.layers.{i}.", f"layers.{i}."
        for kind in ("weight", "bias"):
            yield o + f"input_layernorm.{kind}", g(p + f"input_layernorm.{kind}")
            for ours, theirs, heads in (("q_proj", "self_attn.q_proj", H),
                                        ("k_proj", "self_attn.k_proj", KV),
                                        ("v_proj", "self_attn.v_proj", None),
                                        ("dense", "self_attn.dense", None),
                                        ("fc1", "mlp.fc1", None), ("fc2", "mlp.fc2", None)):
                name = p + f"{theirs}.{kind}"
                if name in sd:
                    t = g(name)
                    yield (o + f"{ours}.{kind}",
                           _permute_qk_rows(t, heads, Dh, rotary_dim=rd) if heads else t)


# ---------------------------------------------------------------------------
# config.json -> the port's configs
# ---------------------------------------------------------------------------

def llama_config_from_hf(hf_cfg, **overrides):
    """A transformers LlamaConfig/MistralConfig/Qwen2Config, or
    ``read_hf_config``'s namespace for one, -> the port's ``LlamaConfig``."""
    from deepspeed_tpu_torch.models.llama import LlamaConfig
    kw = dict(
        vocab_size=hf_cfg.vocab_size,
        hidden_size=hf_cfg.hidden_size,
        intermediate_size=hf_cfg.intermediate_size,
        num_hidden_layers=hf_cfg.num_hidden_layers,
        num_attention_heads=hf_cfg.num_attention_heads,
        num_key_value_heads=getattr(hf_cfg, "num_key_value_heads", None)
        or hf_cfg.num_attention_heads,
        max_position_embeddings=hf_cfg.max_position_embeddings,
        rms_norm_eps=hf_cfg.rms_norm_eps,
        rope_theta=getattr(hf_cfg, "rope_theta", 10000.0),
        head_dim=getattr(hf_cfg, "head_dim", None),
        attention_bias=bool(getattr(hf_cfg, "attention_bias", False)
                            or hf_cfg.model_type == "qwen2"),
        sliding_window=getattr(hf_cfg, "sliding_window", None)
        if getattr(hf_cfg, "use_sliding_window", True) else None,
    )
    kw.update(overrides)
    return LlamaConfig(**kw)


def qwen_config_from_json(raw, **overrides):
    """Qwen-v1 config (``read_hf_config``'s namespace) -> the port's
    ``LlamaConfig``. NTK/log-n attention extrapolation (use_dynamic_ntk /
    use_logn_attn) is identity within the native seq_length window, which
    is what max_position_embeddings is set to; beyond-window extrapolation
    is not represented."""
    from deepspeed_tpu_torch.models.llama import LlamaConfig
    if not raw.no_bias:
        raise UnsupportedModelError(
            "qwen with no_bias=false (biased c_proj/mlp) not represented")
    if raw.use_dynamic_ntk or raw.use_logn_attn:
        logger.warning(
            "qwen: use_dynamic_ntk/use_logn_attn are identity within the "
            "native seq_length window; beyond-window extrapolation is not "
            "represented (max_position_embeddings capped at seq_length)")
    kw = dict(vocab_size=raw.vocab_size, hidden_size=raw.hidden_size,
              intermediate_size=raw.intermediate_size // 2,
              num_hidden_layers=raw.num_hidden_layers,
              num_attention_heads=raw.num_attention_heads,
              num_key_value_heads=raw.num_attention_heads,
              max_position_embeddings=raw.seq_length, rms_norm_eps=raw.layer_norm_epsilon,
              rope_theta=raw.rotary_emb_base, head_dim=raw.kv_channels,
              attention_bias=True)
    kw.update(overrides)
    return LlamaConfig(**kw)


def internlm_config_from_json(raw, **overrides):
    """InternLM (v1) config -> the port's ``LlamaConfig``: llama naming with
    ``bias`` on q/k/v/o (reference container:
    ``deepspeed/module_inject/containers/internlm.py``)."""
    from deepspeed_tpu_torch.models.llama import LlamaConfig
    bias = bool(raw.bias)
    kw = dict(vocab_size=raw.vocab_size, hidden_size=raw.hidden_size,
              intermediate_size=raw.intermediate_size,
              num_hidden_layers=raw.num_hidden_layers,
              num_attention_heads=raw.num_attention_heads,
              num_key_value_heads=raw.num_key_value_heads,
              max_position_embeddings=raw.max_position_embeddings,
              rms_norm_eps=raw.rms_norm_eps, rope_theta=raw.rope_theta,
              head_dim=raw.head_dim,    # export_pretrained writes this for
              # nonstandard head dims; reload must honor it
              attention_bias=bias, attention_out_bias=bias)
    kw.update(overrides)
    return LlamaConfig(**kw)


def _mixtral_config(hf, **kw):
    from deepspeed_tpu_torch.models.mixtral import MixtralConfig
    return MixtralConfig(vocab_size=hf.vocab_size, hidden_size=hf.hidden_size,
                         intermediate_size=hf.intermediate_size,
                         num_hidden_layers=hf.num_hidden_layers,
                         num_attention_heads=hf.num_attention_heads,
                         num_key_value_heads=hf.num_key_value_heads,
                         num_local_experts=hf.num_local_experts,
                         num_experts_per_tok=hf.num_experts_per_tok,
                         max_position_embeddings=hf.max_position_embeddings,
                         rms_norm_eps=hf.rms_norm_eps,
                         rope_theta=getattr(hf, "rope_theta", 1e6), **kw)


def _opt_config(hf, **kw):
    from deepspeed_tpu_torch.models.opt import OPTConfig
    if not getattr(hf, "do_layer_norm_before", True):
        raise UnsupportedModelError(
            "OPT do_layer_norm_before=False (opt-350m post-LN lineage) "
            "not supported — the pre-LN model cannot represent it")
    if getattr(hf, "word_embed_proj_dim", hf.hidden_size) != hf.hidden_size:
        raise UnsupportedModelError(
            "OPT word_embed_proj_dim != hidden_size (project_in/out "
            "lineage, e.g. opt-350m) not supported")
    return OPTConfig(vocab_size=hf.vocab_size, hidden_size=hf.hidden_size,
                     ffn_dim=hf.ffn_dim, num_hidden_layers=hf.num_hidden_layers,
                     num_attention_heads=hf.num_attention_heads,
                     max_position_embeddings=hf.max_position_embeddings, **kw)


def _falcon_config(hf, **kw):
    from deepspeed_tpu_torch.models.parallel_block import ParallelBlockConfig
    if getattr(hf, "new_decoder_architecture", False):
        raise UnsupportedModelError(
            "falcon new_decoder_architecture (40b/180b grouped-qkv layout) "
            "not supported yet; 7b-lineage (multi_query) is")
    if getattr(hf, "alibi", False):
        raise UnsupportedModelError("falcon alibi variant not supported")
    if not getattr(hf, "parallel_attn", True):
        raise UnsupportedModelError(
            "falcon parallel_attn=False (sequential-residual falcon-rw "
            "lineage) not supported — the parallel-block model cannot "
            "represent it")
    kv = 1 if getattr(hf, "multi_query", True) else hf.num_attention_heads
    return ParallelBlockConfig(
        vocab_size=hf.vocab_size, hidden_size=hf.hidden_size,
        intermediate_size=getattr(hf, "ffn_hidden_size", 4 * hf.hidden_size),
        num_hidden_layers=hf.num_hidden_layers,
        num_attention_heads=hf.num_attention_heads, num_key_value_heads=kv,
        max_position_embeddings=getattr(hf, "max_position_embeddings", 2048),
        layer_norm_eps=hf.layer_norm_epsilon,
        rope_theta=getattr(hf, "rope_theta", 10000.0),
        use_bias=bool(getattr(hf, "bias", False)), fused_qkv=True,
        tie_lm_head=bool(getattr(hf, "tie_word_embeddings", False)), **kw)


def _phi_config(hf, sd, **kw):
    from deepspeed_tpu_torch.models.parallel_block import ParallelBlockConfig
    return ParallelBlockConfig(
        vocab_size=hf.vocab_size, hidden_size=hf.hidden_size,
        intermediate_size=hf.intermediate_size,
        num_hidden_layers=hf.num_hidden_layers,
        num_attention_heads=hf.num_attention_heads,
        num_key_value_heads=getattr(hf, "num_key_value_heads", None)
        or hf.num_attention_heads,
        max_position_embeddings=hf.max_position_embeddings,
        layer_norm_eps=hf.layer_norm_eps,
        rope_theta=getattr(hf, "rope_theta", 10000.0),
        rotary_pct=getattr(hf, "partial_rotary_factor", 1.0),
        use_bias=True, fused_qkv=False,
        # phi hidden_act is gelu_new (tanh); exact only if configured so
        gelu_exact=getattr(hf, "hidden_act", "gelu_new")
        not in ("gelu_new", "gelu_pytorch_tanh"),
        lm_head_bias="lm_head.bias" in sd, **kw)


def _family(mt, hf, sd, dtype):
    """(model class, the port's config, converter) of an HF family."""
    from deepspeed_tpu_torch.models.llama import LlamaForCausalLM
    from deepspeed_tpu_torch.models.mixtral import MixtralForCausalLM
    from deepspeed_tpu_torch.models.opt import OPTForCausalLM
    from deepspeed_tpu_torch.models.parallel_block import ParallelBlockForCausalLM
    if mt == "qwen":
        return LlamaForCausalLM, qwen_config_from_json(hf, dtype=dtype), qwen_to_torch
    if mt == "internlm":
        return (LlamaForCausalLM, internlm_config_from_json(hf, dtype=dtype),
                llama_to_torch)
    if mt in LLAMA_FAMILY:
        return LlamaForCausalLM, llama_config_from_hf(hf, dtype=dtype), llama_to_torch
    if mt == "opt":
        return OPTForCausalLM, _opt_config(hf, dtype=dtype), opt_to_torch
    if mt == "mixtral":
        return MixtralForCausalLM, _mixtral_config(hf, dtype=dtype), mixtral_to_torch
    if mt == "falcon":
        return ParallelBlockForCausalLM, _falcon_config(hf, dtype=dtype), falcon_to_torch
    return ParallelBlockForCausalLM, _phi_config(hf, sd, dtype=dtype), phi_to_torch


# Split of an HF tensor over ``tp``, by name: the dimension and the
# ``TPPlan`` spans of ``tensor_parallel.TP_SPLITS`` in the HF layout, so each
# rank moves only its part to the device. A tensor matching none (a norm,
# the router, learned positions, Falcon's fused ``query_key_value`` and
# Qwen-v1's fused ``c_attn``, whose rows are reordered by the conversion)
# moves whole and is cut after its conversion.
_HF_TP_SPLITS = (
    (r"(embed_tokens|wte|word_embeddings|lm_head)\.weight$", 0, "vocab"),
    (r"lm_head\.bias$", 0, "vocab"),
    (r"q_proj\.(weight|bias)$", 0, "q"),
    (r"(k_proj|v_proj)\.(weight|bias)$", 0, "kv"),
    (r"(gate_proj|up_proj|mlp\.w1|mlp\.w2|fc1|dense_h_to_4h)\.weight$", 0, "ffn"),
    (r"(fc1|dense_h_to_4h)\.bias$", 0, "ffn"),
    (r"(o_proj|attn\.c_proj|out_proj|self_attn\.dense|self_attention\.dense)\.weight$",
     1, "q"),
    (r"(down_proj|mlp\.c_proj|fc2|dense_4h_to_h)\.weight$", 1, "ffn"),
    (r"experts\.\d+\.(w1|w3)\.weight$", 0, "ffn"),
    (r"experts\.\d+\.w2\.weight$", 1, "ffn"),
)


def _hf_cut(plan, name, t):
    """``plan``'s rank's part of HF tensor ``name`` (``t`` itself where it
    moves whole)."""
    if plan.size > 1:
        for pattern, dim, kind in _HF_TP_SPLITS:
            if re.search(pattern, name):
                return take_spans(t, dim, plan.spans[kind])
    return t


def load_pretrained(model_dir, dtype=torch.float32, device=None, tp_size=1, tp_rank=0,
                    quantize=None, quant_group_size=None):
    """Load an HF checkpoint directory -> the port's module for its family,
    configured to match, with ``config.dtype`` = ``dtype``.

    The module is built on the meta device and loaded with
    ``load_state_dict(assign=True)``: each HF tensor is moved to ``device``
    (default ``"cuda"``, which raises without a GPU), rounded to ``dtype``
    there (the JAX loader's ``astype(dtype)``, norm scales included), then
    converted and stored in its parameter's dtype (norm scales fp32).

    With ``tp_size`` > 1 (tensor-parallel serving, every family) the module
    is built with ``tp_size`` and holds rank ``tp_rank``'s share (its
    ``TPPlan``): each HF tensor's part is cut on the host from the mapped
    file and only it moves to the device, where the q/k rotary permutation
    runs on the rank's whole heads; the fused projections move whole and
    are cut after their conversion.

    ``quantize(model, name, whole)`` (v1 serving with quantized weights at
    ``tp_size`` > 1): each tensor moves whole and is converted, and for
    every ``{module}.weight`` it takes, it returns the rank's
    ``QuantizedLinear`` quantized from the WHOLE tensor (None: the tensor is
    cut as usual), which then takes the module's place with the module's
    bias; the model's plan is built with ``quant_group_size``. One whole
    tensor at a time is alive besides the rank's share."""
    mt = detect_model_type(model_dir)
    if mt in UNPORTED:
        raise NotImplementedError(
            f"model_type {mt!r} converts in the JAX package but has no model in "
            f"deepspeed_tpu_torch yet; see ROADMAP.md queue {UNPORTED[mt]}")
    if mt not in SUPPORTED:
        raise UnsupportedModelError(
            f"unsupported model_type {mt!r}; supported: {SUPPORTED}")
    device = resolve_device(device)
    hf = read_hf_config(model_dir)
    sd = load_state_dict(model_dir)
    cls, cfg, convert = _family(mt, hf, sd, dtype)
    group = {} if quant_group_size is None else {"quant_group_size": quant_group_size}
    model = cls(cfg, device="meta", tp_size=tp_size, tp_rank=tp_rank, **group)
    target = dict(model.named_parameters())

    def g(name):
        t = sd[name] if quantize else _hf_cut(model.plan, name, sd[name])
        t = t.to(device)
        return t.to(dtype) if t.is_floating_point() else t

    def local(name, t):
        if t.shape != target[name].shape:      # cut after conversion: keep a copy
            t = model.plan.cut(name, t).clone()
        return t.to(target[name].dtype).contiguous()

    state, quantized = {}, {}
    for name, t in convert(sd, cfg, g):
        part = quantize(model, name, t) if quantize else None
        if part is None:
            state[name] = local(name, t)
        else:
            quantized[name[:-len(".weight")]] = part
        del t
    model.load_state_dict(state, assign=True, strict=not quantized)
    for name, part in quantized.items():
        part.bias = model.get_submodule(name).bias
        parent, _, child = name.rpartition(".")
        setattr(model.get_submodule(parent) if parent else model, child, part)
    return model


# ---------------------------------------------------------------------------
# the port's state dicts -> HF state dicts and config.json
# ---------------------------------------------------------------------------

def _llama_attention_from_torch(params, cfg, i):
    """Layer ``i``'s attention projections under their HF llama names."""
    H, KV, Dh = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim
    for nm, heads in (("q_proj", H), ("k_proj", KV), ("v_proj", None), ("o_proj", None)):
        for kind in ("weight", "bias"):
            name = f"layers.{i}.self_attn.{nm}.{kind}"
            if name in params:
                t = params[name]
                yield (f"model.layers.{i}.self_attn.{nm}.{kind}",
                       _permute_qk_rows(t, heads, Dh, inverse=True) if heads else t)


def llama_from_torch(params, cfg):
    """Inverse of :func:`llama_to_torch` -> HF-named state dict."""
    sd = {"model.embed_tokens.weight": params["embed_tokens.weight"],
          "model.norm.weight": params["norm.weight"],
          "lm_head.weight": params["lm_head.weight"]}
    for i in range(cfg.num_hidden_layers):
        p = f"model.layers.{i}."
        for nm in ("input_layernorm", "post_attention_layernorm"):
            sd[p + nm + ".weight"] = params[f"layers.{i}.{nm}.weight"]
        sd.update(_llama_attention_from_torch(params, cfg, i))
        for nm in ("gate_proj", "up_proj", "down_proj"):
            sd[p + f"mlp.{nm}.weight"] = params[f"layers.{i}.mlp.{nm}.weight"]
    return sd


def qwen_from_torch(params, cfg):
    """Inverse of :func:`qwen_to_torch` -> Qwen-v1-named state dict."""
    H, Dh = cfg.num_attention_heads, cfg.head_dim
    sd = {"transformer.wte.weight": params["embed_tokens.weight"],
          "transformer.ln_f.weight": params["norm.weight"],
          "lm_head.weight": params["lm_head.weight"]}
    for i in range(cfg.num_hidden_layers):
        p, o = f"transformer.h.{i}.", f"layers.{i}."
        sd[p + "ln_1.weight"] = params[o + "input_layernorm.weight"]
        sd[p + "ln_2.weight"] = params[o + "post_attention_layernorm.weight"]
        for kind in ("weight", "bias"):
            q, k, v = (params[o + f"self_attn.{nm}.{kind}"]
                       for nm in ("q_proj", "k_proj", "v_proj"))
            sd[p + f"attn.c_attn.{kind}"] = torch.cat([
                _permute_qk_rows(q, H, Dh, inverse=True),
                _permute_qk_rows(k, H, Dh, inverse=True), v])
        sd[p + "attn.c_proj.weight"] = params[o + "self_attn.o_proj.weight"]
        sd[p + "mlp.w2.weight"] = params[o + "mlp.gate_proj.weight"]
        sd[p + "mlp.w1.weight"] = params[o + "mlp.up_proj.weight"]
        sd[p + "mlp.c_proj.weight"] = params[o + "mlp.down_proj.weight"]
    return sd


def opt_from_torch(params, cfg):
    sd = {"model.decoder." + k: v for k, v in params.items()}
    sd["lm_head.weight"] = params["embed_tokens.weight"]
    return sd


def mixtral_from_torch(params, cfg):
    sd = {"model.embed_tokens.weight": params["embed_tokens.weight"],
          "model.norm.weight": params["norm.weight"],
          "lm_head.weight": params["lm_head.weight"]}
    for i in range(cfg.num_hidden_layers):
        p, o = f"model.layers.{i}.", f"layers.{i}."
        for nm in ("input_layernorm", "post_attention_layernorm"):
            sd[p + nm + ".weight"] = params[o + nm + ".weight"]
        sd.update(_llama_attention_from_torch(params, cfg, i))
        sd[p + "block_sparse_moe.gate.weight"] = params[o + "block_sparse_moe.gate.wg"].T
        for w in ("w1", "w2", "w3"):
            stack = params[o + f"block_sparse_moe.experts.{w}"]
            for e in range(cfg.num_local_experts):
                sd[p + f"block_sparse_moe.experts.{e}.{w}.weight"] = stack[e].T
    return sd


def _parallel_block_family(cfg):
    """Which HF family a ParallelBlockConfig describes — derivable from the
    architectural flags (the config carries no family tag)."""
    if cfg.dual_layernorm:
        return "gpt_neox"
    if cfg.fused_qkv:
        return "falcon"
    if not cfg._bias("qkv_bias") and cfg._bias("mlp_bias"):
        return "gptj"
    return "phi"


def parallel_block_from_torch(params, cfg):
    """Inverse converters for the parallel-residual families (falcon/phi).
    Returns (state_dict, hf_config_dict)."""
    H, KV, Dh, rd = (cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim,
                     cfg.rotary_dim)
    fam = _parallel_block_family(cfg)
    if fam in UNPORTED:
        raise NotImplementedError(
            f"HF export of the {fam} family is not ported to deepspeed_tpu_torch yet; "
            f"see ROADMAP.md queue {UNPORTED[fam]}")

    def unperm(t, heads):
        return _permute_qk_rows(t, heads, Dh, inverse=True, rotary_dim=rd)

    def falcon_wire(t):
        # mirror the loader: multi_query (KV==1) is block concat, KV==H is
        # per-head interleaved (transformers' _split_heads)
        q, k, v = t[:H * Dh], t[H * Dh:(H + KV) * Dh], t[(H + KV) * Dh:]
        q, k = unperm(q, H), unperm(k, KV)
        if KV == H:
            return _fuse_qkv_interleaved(q, k, v, H, Dh)
        return torch.cat([q, k, v])

    sd = {}
    for i in range(cfg.num_hidden_layers):
        o = f"layers.{i}."
        if fam == "falcon":
            p = f"transformer.h.{i}."
            names = (("input_layernorm", "input_layernorm"),
                     ("query_key_value", "self_attention.query_key_value"),
                     ("dense", "self_attention.dense"),
                     ("fc1", "mlp.dense_h_to_4h"), ("fc2", "mlp.dense_4h_to_h"))
        else:
            p = f"model.layers.{i}."
            names = (("input_layernorm", "input_layernorm"), ("q_proj", "self_attn.q_proj"),
                     ("k_proj", "self_attn.k_proj"), ("v_proj", "self_attn.v_proj"),
                     ("dense", "self_attn.dense"), ("fc1", "mlp.fc1"), ("fc2", "mlp.fc2"))
        for ours, theirs in names:
            for kind in ("weight", "bias"):
                if o + f"{ours}.{kind}" not in params:
                    continue
                t = params[o + f"{ours}.{kind}"]
                if ours == "query_key_value":
                    t = falcon_wire(t)
                elif ours in ("q_proj", "k_proj"):
                    t = unperm(t, H if ours == "q_proj" else KV)
                sd[p + f"{theirs}.{kind}"] = t

    embed = params["embed_tokens.weight"]
    if fam == "falcon":
        sd["transformer.word_embeddings.weight"] = embed
        sd["transformer.ln_f.weight"] = params["final_layernorm.weight"]
        sd["transformer.ln_f.bias"] = params["final_layernorm.bias"]
        if not cfg.tie_lm_head:
            sd["lm_head.weight"] = params["lm_head.weight"]
        hf = {"model_type": "falcon", "architectures": ["FalconForCausalLM"],
              "vocab_size": cfg.vocab_size, "hidden_size": cfg.hidden_size,
              "ffn_hidden_size": cfg.intermediate_size,
              "num_hidden_layers": cfg.num_hidden_layers,
              "num_attention_heads": cfg.num_attention_heads,
              "num_kv_heads": cfg.num_key_value_heads,
              "multi_query": cfg.num_key_value_heads == 1,
              "parallel_attn": True, "bias": cfg.use_bias, "alibi": False,
              "new_decoder_architecture": False,
              "rope_theta": cfg.rope_theta,
              "layer_norm_epsilon": cfg.layer_norm_eps,
              "max_position_embeddings": cfg.max_position_embeddings,
              "tie_word_embeddings": bool(cfg.tie_lm_head)}
    else:  # phi
        sd["model.embed_tokens.weight"] = embed
        sd["model.final_layernorm.weight"] = params["final_layernorm.weight"]
        sd["model.final_layernorm.bias"] = params["final_layernorm.bias"]
        sd["lm_head.weight"] = embed if cfg.tie_lm_head else params["lm_head.weight"]
        if "lm_head.bias" in params:
            sd["lm_head.bias"] = params["lm_head.bias"]
        hf = {"model_type": "phi", "architectures": ["PhiForCausalLM"],
              "vocab_size": cfg.vocab_size, "hidden_size": cfg.hidden_size,
              "intermediate_size": cfg.intermediate_size,
              "num_hidden_layers": cfg.num_hidden_layers,
              "num_attention_heads": cfg.num_attention_heads,
              "num_key_value_heads": cfg.num_key_value_heads,
              "max_position_embeddings": cfg.max_position_embeddings,
              "layer_norm_eps": cfg.layer_norm_eps,
              "rope_theta": cfg.rope_theta,
              "partial_rotary_factor": cfg.rotary_pct,
              "hidden_act": "gelu" if cfg.gelu_exact else "gelu_new",
              "tie_word_embeddings": False}
    return sd, hf


_TORCH_DTYPE_NAMES = {torch.float16: "float16", torch.float32: "float32",
                      torch.bfloat16: "bfloat16"}


def export_pretrained(params, cfg, save_dir, dtype=None):
    """Inverse of :func:`load_pretrained`: write ``model.safetensors`` +
    ``config.json`` that ``transformers.from_pretrained`` can load.

    ``params``: the port module's state dict (or the module), on any
    device; ``cfg``: its config. Floating tensors are written in ``dtype``,
    or in their own dtype when it is None (bf16 stays bf16). Returns the
    path of the weights file."""
    from deepspeed_tpu_torch.models.llama import LlamaConfig
    from deepspeed_tpu_torch.models.mixtral import MixtralConfig
    from deepspeed_tpu_torch.models.opt import OPTConfig
    from deepspeed_tpu_torch.models.parallel_block import ParallelBlockConfig

    if isinstance(params, nn.Module):
        params = params.state_dict()
    written = dtype if dtype is not None else params["embed_tokens.weight"].dtype
    if isinstance(cfg, LlamaConfig):
        # pick the faithful HF family: sliding_window => mistral (global
        # attention would silently diverge past the window), qkv-bias => qwen2
        if cfg.sliding_window:
            mt, arch = "mistral", "MistralForCausalLM"
        elif cfg.attention_out_bias:
            # q/k/v/o all biased => InternLM lineage (remote-code family)
            mt, arch = "internlm", "InternLMForCausalLM"
        elif cfg.attention_bias:
            mt, arch = "qwen2", "Qwen2ForCausalLM"
        else:
            mt, arch = "llama", "LlamaForCausalLM"
        sd = llama_from_torch(params, cfg)
        hf = {"model_type": mt, "architectures": [arch],
              "vocab_size": cfg.vocab_size, "hidden_size": cfg.hidden_size,
              "intermediate_size": cfg.intermediate_size,
              "num_hidden_layers": cfg.num_hidden_layers,
              "num_attention_heads": cfg.num_attention_heads,
              "num_key_value_heads": cfg.num_key_value_heads,
              "max_position_embeddings": cfg.max_position_embeddings,
              "rms_norm_eps": cfg.rms_norm_eps, "rope_theta": cfg.rope_theta,
              "tie_word_embeddings": False,
              "torch_dtype": _TORCH_DTYPE_NAMES.get(written, "bfloat16")}
        if cfg.sliding_window:
            hf["sliding_window"] = int(cfg.sliding_window)
        if mt == "internlm":
            hf["bias"] = True
        elif mt != "qwen2":
            hf["attention_bias"] = cfg.attention_bias
        if cfg.head_dim != cfg.hidden_size // cfg.num_attention_heads:
            hf["head_dim"] = int(cfg.head_dim)
    elif isinstance(cfg, OPTConfig):
        sd = opt_from_torch(params, cfg)
        hf = {"model_type": "opt", "architectures": ["OPTForCausalLM"],
              "vocab_size": cfg.vocab_size, "hidden_size": cfg.hidden_size,
              "ffn_dim": cfg.ffn_dim, "num_hidden_layers": cfg.num_hidden_layers,
              "num_attention_heads": cfg.num_attention_heads,
              "max_position_embeddings": cfg.max_position_embeddings,
              "do_layer_norm_before": True, "word_embed_proj_dim": cfg.hidden_size}
    elif isinstance(cfg, MixtralConfig):
        sd = mixtral_from_torch(params, cfg)
        hf = {"model_type": "mixtral", "architectures": ["MixtralForCausalLM"],
              "vocab_size": cfg.vocab_size, "hidden_size": cfg.hidden_size,
              "intermediate_size": cfg.intermediate_size,
              "num_hidden_layers": cfg.num_hidden_layers,
              "num_attention_heads": cfg.num_attention_heads,
              "num_key_value_heads": cfg.num_key_value_heads,
              "num_local_experts": cfg.num_local_experts,
              "num_experts_per_tok": cfg.num_experts_per_tok,
              "max_position_embeddings": cfg.max_position_embeddings,
              "tie_word_embeddings": False}
    elif isinstance(cfg, ParallelBlockConfig):
        sd, hf = parallel_block_from_torch(params, cfg)
    else:
        raise UnsupportedModelError(f"unsupported model config {type(cfg).__name__}")

    path = save_safetensors(sd, save_dir, dtype=dtype)
    with open(os.path.join(save_dir, "config.json"), "w") as f:
        json.dump(hf, f, indent=2)
    logger.info(f"exported HF checkpoint to {save_dir} "
                f"({sum(v.numel() for v in sd.values()) / 1e6:.1f}M params)")
    return path
