"""The port's block-sparse attention against the JAX package's, on the CPU.

Mirrors ``tests/test_block_sparse_kernel.py``: the same numpy inputs, made
from a seed, go through the JAX function and the port's counterpart. Layouts
of all six sparsity configs must be equal element for element (BigBird's and
Variable's random blocks from the same seed, over repeated ``make_layout``
calls), and so must the compacted schedules. The kernel's plain version
(``sparse_mha`` on CPU tensors) is held to the Pallas kernel run in interpret
mode, its gradients (the blockwise recompute) to ``jax.grad`` of the JAX
``sparse_mha``, the dense CPU path of ``sparse_attention`` to JAX's, and
``SparseSelfAttention`` with weights from ``params_from_flax`` to the Flax
module, output and gradients.

Tolerances: all in fp32. Forward values are sums of ~10-300 products of
magnitude ~1 whose order differs between XLA and PyTorch's CPU kernels
(observed below 1.1e-6); 2e-5 absolute, about 20x that noise and 10x
tighter than ``tests/test_block_sparse_kernel.py``'s kernel-vs-dense bound. Gradients pass through a softmax backward and
a sum over query blocks in another order (fp32 accumulation here, per-block
adds in XLA), observed below 5e-6 on entries up to ~14: 5e-5 absolute plus
1e-5 relative. The module adds two projections of width 64: 5e-5 absolute.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deepspeed_tpu.ops.pallas import block_sparse_attention as jbsa
from deepspeed_tpu.ops import sparse_attention as jsa
from deepspeed_tpu.ops.sparse_attention.sparse_self_attention import (
    blockwise_sparse_attention as jax_blockwise)
from deepspeed_tpu_torch.ops import block_sparse_attention as bsa
from deepspeed_tpu_torch.ops import sparse_attention as sa
from deepspeed_tpu_torch.ops.sparse_attention.sparse_self_attention import (
    blockwise_sparse_attention, params_from_flax)

ATOL = 2e-5
GRAD_ATOL, GRAD_RTOL = 5e-5, 1e-5


def make_qkv(B=2, H=4, S=256, D=64, seed=0):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal((B, H, S, D)).astype(np.float32)
                 for _ in range(3))


def torch_args(*arrays):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in arrays)


def jax_args(*arrays):
    return tuple(jnp.asarray(a) for a in arrays)


# ---------------------------------------------------------------------------
# sparsity configs
# ---------------------------------------------------------------------------

CONFIGS = [
    ("Dense", dict(num_heads=2)),
    ("Fixed", dict(num_heads=4)),
    ("Fixed", dict(num_heads=4, attention="unidirectional")),
    ("Fixed", dict(num_heads=4, different_layout_per_head=True,
                   num_local_blocks=4, num_global_blocks=2,
                   num_different_global_patterns=3,
                   horizontal_global_attention=True)),
    ("Variable", dict(num_heads=4, num_random_blocks=2,
                      local_window_blocks=[2, 3, 4], global_block_indices=[0, 5],
                      seed=3)),
    ("Variable", dict(num_heads=3, different_layout_per_head=True,
                      num_random_blocks=1, global_block_indices=[1],
                      global_block_end_indices=[3], attention="unidirectional",
                      horizontal_global_attention=False, seed=4)),
    ("BigBird", dict(num_heads=4)),
    ("BigBird", dict(num_heads=4, different_layout_per_head=True,
                     num_random_blocks=2, attention="unidirectional", seed=5)),
    ("BSLongformer", dict(num_heads=2, global_block_indices=[0, 7],
                          global_block_end_indices=[2, 9])),
    ("BSLongformer", dict(num_heads=2, attention="unidirectional")),
    ("LocalSlidingWindow", dict(num_heads=2, num_sliding_window_blocks=5)),
    ("LocalSlidingWindow", dict(num_heads=2, attention="bidirectional")),
]


@pytest.mark.parametrize("name,kw", CONFIGS,
                         ids=[f"{n}-{i}" for i, (n, _) in enumerate(CONFIGS)])
def test_layouts_equal_jax(name, kw):
    ours = getattr(sa, f"{name}SparsityConfig")(**kw)
    ref = getattr(jsa, f"{name}SparsityConfig")(**kw)
    for seq_len in (256, 256, 160):      # the generator advances per call
        a, b = ours.make_layout(seq_len), ref.make_layout(seq_len)
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="divisible"):
        ours.make_layout(100)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("name", ["Fixed", "BigBird", "Variable"])
def test_compact_layout_equals_jax(name, causal):
    kw = dict(num_heads=4, different_layout_per_head=True)
    layout = getattr(sa, f"{name}SparsityConfig")(**kw).make_layout(320)
    layout[1, 3] = 0                     # one query block with no key block
    cols, counts = bsa.compact_layout(layout, causal, 16)
    jcols, jcounts = jbsa.compact_layout(layout, causal, 16)
    np.testing.assert_array_equal(cols, jcols)
    np.testing.assert_array_equal(counts, jcounts)
    assert cols.dtype == counts.dtype == np.int32
    assert counts[1, 3] == 0


def test_compaction_is_o_enabled():
    layout = sa.FixedSparsityConfig(num_heads=4, block=16).make_layout(256)
    cols, counts = bsa.compact_layout(layout, causal=True, block=16)
    dense_steps = 4 * (256 // 16) * (256 // 16)
    assert counts.sum() < dense_steps * 0.6
    H, nq, _ = layout.shape
    for h in range(H):
        for iq in range(nq):
            c = counts[h, iq]
            assert np.all(cols[h, iq, :c] <= iq)
            assert np.all(np.diff(cols[h, iq, :c]) > 0)     # ascending
            assert set(cols[h, iq, :c]) == set(np.nonzero(layout[h, iq, :iq + 1])[0])


# ---------------------------------------------------------------------------
# the kernel's plain version against the Pallas kernel (interpret mode)
# ---------------------------------------------------------------------------

def layouts(S, block=16):
    return {"fixed": sa.FixedSparsityConfig(num_heads=4, block=block).make_layout(S),
            "bigbird": sa.BigBirdSparsityConfig(num_heads=4, block=block).make_layout(S)}


@pytest.mark.parametrize("name", ["fixed", "bigbird"])
@pytest.mark.parametrize("causal", [False, True])
def test_plain_kernel_matches_pallas_interpret(name, causal):
    q, k, v = make_qkv()
    layout = layouts(256)[name]
    ref = jbsa.sparse_mha(*jax_args(q, k, v), layout, 16, causal=causal,
                          interpret=True)
    ours = bsa.sparse_mha(*torch_args(q, k, v), layout, 16, causal=causal)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=ATOL, rtol=0)
    cols, counts, _ = bsa._schedule(layout, causal, 16, "cpu")
    direct = bsa.sparse_mha_fwd(*torch_args(q, k, v), cols, counts, 16, causal)
    assert torch.equal(direct, ours)
    assert bsa.sparse_mha_fwd.launches == 0          # no kernel on the CPU


def test_plain_kernel_scale_and_block32_match_pallas():
    q, k, v = make_qkv(B=1, H=2, S=192, D=32, seed=3)
    layout = sa.BSLongformerSparsityConfig(num_heads=2, block=32).make_layout(192)
    ref = jbsa.sparse_mha(*jax_args(q, k, v), layout, 32, causal=True,
                          softmax_scale=0.3, interpret=True)
    ours = bsa.sparse_mha(*torch_args(q, k, v), layout, 32, causal=True,
                          softmax_scale=0.3)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=ATOL, rtol=0)


def test_zero_count_query_block_is_exactly_zero():
    q, k, v = make_qkv(B=1, S=128)
    layout = sa.FixedSparsityConfig(num_heads=4, block=16).make_layout(128)
    layout[2, 5] = 0
    tq, tk, tv = (t.requires_grad_() for t in torch_args(q, k, v))
    out = bsa.sparse_mha(tq, tk, tv, layout, 16, causal=True)
    assert torch.all(out[0, 2, 80:96] == 0)
    ref = jbsa.sparse_mha(*jax_args(q, k, v), layout, 16, causal=True,
                          interpret=True)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref),
                               atol=ATOL, rtol=0)
    out.sum().backward()
    assert torch.all(tq.grad[0, 2, 80:96] == 0)


# ---------------------------------------------------------------------------
# gradients: the blockwise recompute against jax.grad
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,causal", [("fixed", True), ("bigbird", False)])
def test_gradients_match_jax(name, causal):
    q, k, v = make_qkv(B=1, H=4, S=128)
    layout = layouts(128)[name]

    def loss(q, k, v):
        return jnp.sum(jbsa.sparse_mha(q, k, v, layout, 16, causal=causal,
                                       interpret=True) ** 2)

    ref = jax.grad(loss, argnums=(0, 1, 2))(*jax_args(q, k, v))
    ts = [t.requires_grad_() for t in torch_args(q, k, v)]
    (bsa.sparse_mha(*ts, layout, 16, causal=causal) ** 2).sum().backward()
    for t, r in zip(ts, ref):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(r),
                                   atol=GRAD_ATOL, rtol=GRAD_RTOL)


def test_gradients_of_plain_route_equal_kernel_route_on_cpu():
    q, k, v = make_qkv(B=2, H=4, S=128, seed=1)
    layout = layouts(128)["fixed"]
    grads = []
    for plain in (False, True):
        ts = [t.requires_grad_() for t in torch_args(q, k, v)]
        bsa.sparse_mha(*ts, layout, 16, causal=True, plain=plain).sum().backward()
        grads.append([t.grad for t in ts])
    for a, b in zip(*grads):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# the dense and blockwise paths
# ---------------------------------------------------------------------------

def test_blockwise_and_kernel_agree():
    q, k, v = make_qkv(B=1, H=4, S=128)
    layout = sa.BigBirdSparsityConfig(num_heads=4, block=16).make_layout(128)
    out_k = bsa.sparse_mha(*torch_args(q, k, v), layout, 16)
    out_b = blockwise_sparse_attention(*torch_args(q, k, v), layout, 16)
    np.testing.assert_allclose(out_k.numpy(), out_b.numpy(), atol=ATOL, rtol=0)
    ref = jax_blockwise(*jax_args(q, k, v), layout, 16)
    np.testing.assert_allclose(out_b.numpy(), np.asarray(ref), atol=ATOL, rtol=0)


@pytest.mark.parametrize("causal", [False, True])
def test_sparse_attention_cpu_matches_jax_dense(causal):
    q, k, v = make_qkv(B=2, H=4, S=128, seed=2)
    layout = sa.VariableSparsityConfig(num_heads=4, num_random_blocks=1,
                                       seed=2).make_layout(128)
    layout[0, 4] = 0                     # a row with no key: zeroed
    ours = sa.sparse_attention(*torch_args(q, k, v), layout, 16, causal=causal)
    ref = jsa.sparse_attention(*jax_args(q, k, v), layout, 16, causal=causal)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=ATOL, rtol=0)
    assert torch.all(ours[:, 0, 64:80] == 0)


# ---------------------------------------------------------------------------
# SparseSelfAttention against the Flax module
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("causal", [False, True])
def test_sparse_self_attention_matches_flax(causal):
    B, S, E, H = 2, 128, 64, 4
    x = np.random.default_rng(4).standard_normal((B, S, E)).astype(np.float32)
    jmod = jsa.SparseSelfAttention(
        num_heads=H, sparsity_config=jsa.FixedSparsityConfig(num_heads=H),
        causal=causal)
    params = jmod.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    mod = sa.SparseSelfAttention(E, H, sa.FixedSparsityConfig(num_heads=H),
                                 causal=causal)
    mod.load_state_dict(params_from_flax(jax.tree.map(np.asarray, params)))

    def jloss(params, x):
        return jnp.sum(jmod.apply({"params": params}, x) ** 2)

    ref_out = jmod.apply({"params": params}, jnp.asarray(x))
    ref_gp, ref_gx = jax.grad(jloss, argnums=(0, 1))(params, jnp.asarray(x))
    tx = torch.from_numpy(x).requires_grad_()
    out = mod(tx)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref_out),
                               atol=5e-5, rtol=0)
    (out ** 2).sum().backward()
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(ref_gx),
                               atol=GRAD_ATOL, rtol=GRAD_RTOL)
    ref_sd = params_from_flax(jax.tree.map(np.asarray, ref_gp))
    for name, p in mod.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), ref_sd[name].numpy(),
                                   atol=GRAD_ATOL * 10, rtol=GRAD_RTOL, err_msg=name)


def test_sparse_self_attention_shared_layout_and_plain_route():
    """A BigBird module builds a new random layout per call, as the Flax one
    does; passing one layout to two runs makes them comparable: on the CPU
    the module's dense path and the kernel's plain version agree."""
    H, E, S = 4, 64, 128
    torch.manual_seed(0)
    mod = sa.SparseSelfAttention(E, H, sa.BigBirdSparsityConfig(num_heads=H, seed=1))
    x = torch.randn(1, S, E)
    layout = mod.sparsity_config.make_layout(S)
    a = mod(x, layout=layout)
    assert torch.equal(a, mod(x, layout=layout))
    np.testing.assert_allclose(mod(x, layout=layout, plain=True).detach().numpy(),
                               a.detach().numpy(), atol=ATOL, rtol=0)
    assert not np.array_equal(layout, mod.sparsity_config.make_layout(S))


# ---------------------------------------------------------------------------
# what the kernel refuses, and the package boundary
# ---------------------------------------------------------------------------

def test_unsupported_shapes_raise():
    q = torch.zeros(1, 2, 100, 64)
    layout = np.ones((2, 10, 10))
    with pytest.raises(ValueError, match="S % block"):
        bsa.sparse_mha(q, q, q, layout, 10)            # block % 8 != 0
    q = torch.zeros(1, 2, 128, 320)
    with pytest.raises(ValueError, match="D <= 256"):
        bsa.sparse_mha(q, q, q, np.ones((2, 8, 8)), 16)
    assert bsa.is_supported((1, 2, 128, 64), 16) == \
        jbsa.is_supported((1, 2, 128, 64), 16)
    for shape, block in (((1, 2, 100, 64), 10), ((1, 2, 128, 300), 16),
                         ((1, 2, 120, 64), 16), ((1, 2, 512, 256), 256)):
        assert bsa.is_supported(shape, block) == jbsa.is_supported(shape, block)
    # a CUDA tensor of block 256 is refused before any launch; on the CPU the
    # plain version takes it
    assert "block 256" in bsa.unsupported_reason((1, 2, 512, 64), 256, on_cuda=True)
    assert bsa.unsupported_reason((1, 2, 512, 64), 256, on_cuda=False) is None
    with pytest.raises(ValueError, match="cols"):
        bsa.sparse_mha_fwd(torch.zeros(1, 2, 64, 16), torch.zeros(1, 2, 64, 16),
                           torch.zeros(1, 2, 64, 16), torch.zeros(2, 3, 1, dtype=torch.int32),
                           torch.zeros(2, 3, dtype=torch.int32), 16)


def test_port_modules_import_no_jax():
    code = ("import sys; import deepspeed_tpu_torch.ops.block_sparse_attention, "
            "deepspeed_tpu_torch.ops.sparse_attention, "
            "deepspeed_tpu_torch.runtime.swap_tensor.kv_swapper, "
            "deepspeed_tpu_torch.inference.v2.ragged.kv_cache; "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'deepspeed_tpu')); "
            "print(bad); sys.exit(1 if bad else 0)")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120,
                       cwd=os.path.dirname(os.path.dirname(__file__)))
    assert r.returncode == 0, r.stdout + r.stderr
