"""The port's GPT-2 (``deepspeed_tpu_torch/models/gpt2.py``) and its HF
converters against the JAX package's, on the CPU.

The same weights (the JAX model's init, moved with ``params_from_flax``,
for the scanned ``h/block`` tree and the unscanned ``h_{i}`` tree) and the
same token batch go through both models: logits, the next-token loss and
every parameter's gradient must agree. The JAX model attends through
``mha`` (its plain reference on the CPU), the port through the flash plain
versions. Everything is fp32 and differs in summation order only: 2e-5 of
each tensor's largest element. The HF cases mirror
``tests/test_hf_interop.py``'s GPT-2 case (transformers writes a tiny
checkpoint; its logits, the JAX loader's and the port's agree to 2e-3 as
there) and hold the export round trip bit for bit. The activation-
checkpointing policies change no value: ``dots`` and ``cpu_checkpointing``
give ``nothing``'s loss and gradients bit for bit, and ``dots`` runs each
layer's attention forward once where ``everything`` runs it twice. Seeded
dropout repeats under a seed and is recomputed identically.
"""

import collections
import json

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import jax
import jax.numpy as jnp

from deepspeed_tpu.checkpoint import hf as jax_hf
from deepspeed_tpu.models.gpt2 import GPT2Config as JaxGPT2Config
from deepspeed_tpu.models.gpt2 import GPT2LMHeadModel as JaxGPT2
from deepspeed_tpu.models.gpt2 import gpt2_flops_per_token as jax_flops
from deepspeed_tpu_torch.checkpoint import hf
from deepspeed_tpu_torch.models.gpt2 import (GPT2Config, GPT2LMHeadModel,
                                             gpt2_flops_per_token, params_from_flax)
from deepspeed_tpu_torch.ops import flash_attention as fa
from deepspeed_tpu_torch.runtime.activation_checkpointing import checkpointing

transformers = pytest.importorskip("transformers")

TOL = 2e-5


def batch(B=2, T=16, vocab=512, seed=0):
    ids = np.random.default_rng(seed).integers(0, vocab, (B, T)).astype(np.int32)
    return {"input_ids": ids, "labels": ids}


def jax_run(scan, b, seed=0):
    """JAX logits, loss, params and gradients of the tiny GPT-2."""
    model = JaxGPT2(JaxGPT2Config.tiny(dtype=jnp.float32, scan_layers=scan, remat=False))
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    params = jax.jit(model.init)(jax.random.PRNGKey(seed), jb)["params"]
    loss, grads = jax.jit(jax.value_and_grad(lambda p: model.apply({"params": p}, jb)))(params)
    logits = jax.jit(lambda p: model.apply({"params": p}, jb["input_ids"]))(params)
    tree = lambda t: jax.tree.map(np.asarray, t)
    return np.asarray(logits), float(loss), tree(params), tree(grads)


def port_model(params, scan=True, **kw):
    model = GPT2LMHeadModel(GPT2Config.tiny(dtype=torch.float32, scan_layers=scan, **kw),
                            device="cpu")
    model.load_state_dict(params_from_flax(params))
    return model


def close(a, b, tol=TOL):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    scale = max(float(np.abs(b).max()), 1e-12)
    assert float(np.abs(a - b).max()) <= tol * scale, (float(np.abs(a - b).max()), scale)


@pytest.mark.parametrize("scan", [True, False], ids=["scanned", "unscanned"])
def test_logits_loss_and_gradients_match_jax(scan):
    b = batch()
    logits, loss, params, grads = jax_run(scan, b)
    model = port_model(params, scan)
    tb = {k: torch.from_numpy(v) for k, v in b.items()}
    with torch.no_grad():
        close(model(tb["input_ids"]).numpy(), logits)
    got = model(tb)
    got.backward()
    assert float(got.detach()) == pytest.approx(loss, rel=TOL)
    want = params_from_flax(grads)
    named = dict(model.named_parameters())
    assert set(want) == set(named)
    for name, g in want.items():
        close(named[name].grad.numpy(), g.numpy())


def test_jax_stacked_layers_and_flops():
    cfg = GPT2Config.tiny()
    assert GPT2LMHeadModel(cfg, device="meta").jax_stacked_layers() == ("h.", 2)
    assert GPT2LMHeadModel(GPT2Config.tiny(scan_layers=False),
                           device="meta").jax_stacked_layers() == (None, 1)
    for preset in ("tiny", "small", "medium", "large"):
        ours, theirs = getattr(GPT2Config, preset)(), getattr(JaxGPT2Config, preset)()
        for f in ("vocab_size", "n_positions", "n_embd", "n_layer", "n_head"):
            assert getattr(ours, f) == getattr(theirs, f)
        assert gpt2_flops_per_token(ours, 1024) == jax_flops(theirs, 1024)
    large = GPT2Config.large()
    assert large.num_parameters() == sum(
        p.numel() for p in GPT2LMHeadModel(large, device="meta").parameters())
    with pytest.raises(NotImplementedError, match="A12"):
        GPT2LMHeadModel(cfg, device="meta", tp_size=2)


def test_from_seed_follows_the_jax_init_laws():
    model = GPT2LMHeadModel.from_seed(GPT2Config.small(dtype=torch.float32, n_layer=1),
                                      seed=0, device="cpu")
    p = dict(model.named_parameters())
    assert float(p["wte.weight"].std()) == pytest.approx(0.02, rel=0.01)
    assert float(p["wpe.weight"].std()) == pytest.approx(0.01, rel=0.02)
    fc = p["h.0.mlp.c_fc.weight"]                       # [4D, D]: fan-in D
    assert float(fc.std()) == pytest.approx(768 ** -0.5, rel=0.02)
    assert float(fc.abs().max()) <= 2 * 768 ** -0.5 / 0.87962566103423978 + 1e-6
    assert torch.all(p["h.0.ln_1.weight"] == 1) and torch.all(p["h.0.attn.c_attn.bias"] == 0)
    again = GPT2LMHeadModel.from_seed(GPT2Config.small(dtype=torch.float32, n_layer=1),
                                      seed=0, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(model.parameters(), again.parameters()))


@pytest.fixture
def policy():
    yield
    checkpointing.reset()


def run_policy(model, b, name, cpu=False):
    checkpointing._CONFIG.update(policy=name, checkpoint_in_cpu=cpu)
    model.zero_grad()
    loss = model({k: torch.from_numpy(v) for k, v in b.items()})
    loss.backward()
    return float(loss), [p.grad.clone() for p in model.parameters()]


def test_dots_and_cpu_checkpointing_change_no_value(policy, monkeypatch):
    b = batch(seed=1)
    _, _, params, _ = jax_run(True, b)
    model = port_model(params)
    want = run_policy(model, b, "nothing")
    calls = []
    fwd = fa.flash_mha_fwd_reference
    monkeypatch.setattr(fa, "flash_mha_fwd_reference",
                        lambda *a, **k: calls.append(1) or fwd(*a, **k))
    for name, cpu, forwards in (("everything", False, 4), ("dots", False, 2),
                                ("dots", True, 2), ("everything", True, 2)):
        calls.clear()
        got = run_policy(model, b, name, cpu)
        assert len(calls) == forwards, (name, cpu)
        assert got[0] == want[0]
        assert all(torch.equal(x, y) for x, y in zip(got[1], want[1])), (name, cpu)


class _OpCount(TorchDispatchMode):
    """Counts the ops that reach the dispatcher below the checkpoint's
    selective-checkpoint contexts (what those hand back is not counted)."""

    def __init__(self):
        super().__init__()
        self.n = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n[func] += 1
        return func(*args, **(kwargs or {}))


def test_dots_saves_the_products_and_the_named_output(policy):
    """Inside a dots checkpoint the 2-D products and the flash forward's
    output (the op ``flash_fwd_op``, JAX's ``flash_attn_out``) are saved in
    the first pass and handed back in the recomputation; a product with
    batch dims is recomputed. Against "nothing": "dots" runs one more bmm
    and no more mm or flash forward, "everything" one more of each; under
    ``cpu_checkpointing`` the products come back from the host copies."""
    w = torch.randn(8, 8, requires_grad=True)
    x = torch.randn(4, 8, requires_grad=True)

    def f(x):
        h = torch.tanh(x @ w)                     # mm: saved
        y = torch.bmm(h[None], h[None].transpose(1, 2))[0]    # bmm: recomputed
        qkv = (y @ h).view(1, 4, 2, 4)            # mm: saved
        return (fa.mha(qkv, qkv, qkv) ** 2).sum()

    runs = {}
    for name, cpu in (("nothing", False), ("dots", False), ("everything", False),
                      ("dots", True)):
        checkpointing._CONFIG.update(policy=name, checkpoint_in_cpu=cpu)
        x.grad = w.grad = None
        with _OpCount() as count:
            checkpointing.checkpoint(f, x).backward()
        ops = torch.ops.aten
        runs[name, cpu] = ([count.n[op] for op in (ops.mm.default, ops.bmm.default,
                                               fa.flash_fwd_op._opoverload)],
                      x.grad.clone(), w.grad.clone())
    want = runs.pop(("nothing", False))
    mm, bmm, flash = want[0]
    assert flash == 1
    assert runs["dots", False][0] == runs["dots", True][0] == [mm, bmm + 1, flash]
    assert runs["everything", False][0] == [mm + 2, bmm + 1, flash + 1]
    for got in runs.values():
        assert torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])
    checkpointing._CONFIG.update(policy="bogus")
    with pytest.raises(KeyError):
        checkpointing.current_policy()


def test_seeded_dropout_repeats_and_recomputes(policy):
    b = batch(seed=2)
    cfg = GPT2Config.tiny(dtype=torch.float32, dropout=0.1)
    model = GPT2LMHeadModel.from_seed(cfg, seed=0, device="cpu").requires_grad_(True)
    tb = {k: torch.from_numpy(v) for k, v in b.items()}
    model.train()
    runs = []
    for name in ("nothing", "everything", "dots"):
        checkpointing._CONFIG.update(policy=name)
        torch.manual_seed(5)
        model.zero_grad()
        loss = model(tb)
        loss.backward()
        runs.append((float(loss), [p.grad.clone() for p in model.parameters()]))
    for loss, grads in runs[1:]:
        assert loss == runs[0][0]
        assert all(torch.equal(a, c) for a, c in zip(grads, runs[0][1]))
    torch.manual_seed(6)
    assert float(model(tb)) != runs[0][0]
    model.eval()
    with torch.no_grad():
        assert torch.equal(model(tb["input_ids"]), model(tb["input_ids"]))


def hf_logits(model, ids):
    with torch.no_grad():
        return model(torch.from_numpy(ids)).logits.float().numpy()


def test_hf_gpt2_logits_and_round_trip(tmp_path):
    """``tests/test_hf_interop.py``'s GPT-2 case: the port's loader, the JAX
    loader and transformers agree on the logits; the port's export loads in
    transformers and back into the port bit for bit, and converts both ways
    as the JAX converters do."""
    cfg = transformers.GPT2Config(vocab_size=128, n_positions=32, n_embd=32, n_layer=2,
                                  n_head=2)
    torch.manual_seed(3)
    hf_model = transformers.GPT2LMHeadModel(cfg).eval()
    d = str(tmp_path / "ckpt")
    hf_model.save_pretrained(d, safe_serialization=True)
    ids = np.random.default_rng(3).integers(0, 128, size=(2, 10)).astype(np.int32)
    want = hf_logits(hf_model, ids)
    ours = hf.load_pretrained(d, device="cpu")
    assert isinstance(ours, GPT2LMHeadModel) and ours.config.n_layer == 2
    with torch.no_grad():
        got = ours(torch.from_numpy(ids)).numpy()
    np.testing.assert_allclose(got, want, atol=2e-3, rtol=1e-3)
    jmodel, jparams = jax_hf.load_pretrained(d)
    fcfg = type(jmodel.config)(**{**jmodel.config.__dict__, "dtype": jnp.float32,
                                  "remat": False})
    jlogits = np.asarray(jax.jit(type(jmodel)(fcfg).apply)({"params": jparams},
                                                           {"input_ids": ids}), np.float32)
    np.testing.assert_allclose(got, jlogits, atol=2e-3, rtol=1e-3)
    # the port's state dict is the JAX tree's, converted
    sd = params_from_flax(jax.tree.map(np.asarray, jparams))
    for name, t in ours.state_dict().items():
        np.testing.assert_allclose(t.numpy(), sd[name].numpy(), rtol=0, atol=0)
    # export: transformers reads it, and the port reads it back bit for bit
    out = str(tmp_path / "export")
    hf.export_pretrained(ours, ours.config, out)
    assert json.load(open(f"{out}/config.json"))["model_type"] == "gpt2"
    np.testing.assert_allclose(
        hf_logits(transformers.GPT2LMHeadModel.from_pretrained(out).eval(), ids), want,
        atol=1e-5, rtol=1e-5)
    again = hf.load_pretrained(out, device="cpu")
    with torch.no_grad():
        assert torch.equal(again(torch.from_numpy(ids)), torch.from_numpy(got))
    # the export's names and values are gpt2_from_flax's
    jsd = jax_hf.gpt2_from_flax(jparams, jmodel.config)
    ported = hf.gpt2_from_torch(ours.state_dict(), ours.config)
    for name, t in jsd.items():
        np.testing.assert_array_equal(ported["transformer." + name].numpy(), np.asarray(t))
