"""The port's MoE gating, dispatch and layers against the JAX package's, on the CPU.

The same numpy inputs (drawn from a seed) go through ``deepspeed_tpu.moe``
and ``deepspeed_tpu_torch.moe``: ``top1_routing`` / ``topk_routing`` /
``_capacity`` (plans, drops, ``exp_counts``, aux loss, k = 1 and 2), the
``MOELayer`` in its three dispatch modes with the JAX layer's parameters
carried across (output, aux loss, expert counts and every gradient, with a
capacity that drops tokens, dropless, and a skewed batch), ``MoE`` with the
PR-MoE residual expert, the ``moe/utils`` parameter groups and the errors.
The JAX ``"gmm"`` mode runs megablox in interpret mode, the port's runs the
grouped-GEMM kernels' plain versions (CPU tensors) through their autograd
backward. Noisy gating draws its noise from a ``torch.Generator``, which
cannot reproduce JAX's threefry stream, so it is tested inside the port.

Tolerances. Routing is exact in the indices, positions and counts; gates
and the aux loss are fp32 softmax values and agree to 1e-6. The layers run
in fp32 and differ only in summation order: outputs and gradients agree to
1e-5 of each tensor's largest element for "indices" and "einsum"; megablox
in interpret mode sums its 128-wide tiles in another order again, and the
"gmm" mode is held to 1e-5 of the largest element as well (the JAX
package's own gmm-vs-indices test, ``tests/test_moe.py``, allows 5e-4).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deepspeed_tpu.models.mixtral import MixtralConfig as JaxMixtralConfig
from deepspeed_tpu.models.mixtral import MixtralExpertMLP as JaxExpert
from deepspeed_tpu.models.mixtral import MixtralForCausalLM as JaxMixtral
from deepspeed_tpu.moe import sharded_moe as jmoe
from deepspeed_tpu.moe import utils as jutils
from deepspeed_tpu.moe.layer import MoE as JaxMoE
from deepspeed_tpu_torch.models.mixtral import MixtralConfig, MixtralExpertMLP
from deepspeed_tpu_torch.models.mixtral import MixtralForCausalLM
from deepspeed_tpu_torch.moe import sharded_moe as pmoe
from deepspeed_tpu_torch.moe import utils as putils
from deepspeed_tpu_torch.moe.layer import MoE

D, F, E = 128, 256, 4
REL = 1e-5


def jax_expert():
    return JaxExpert(JaxMixtralConfig(hidden_size=D, intermediate_size=F,
                                      dtype=jnp.float32))


def port_expert():
    return MixtralExpertMLP(MixtralConfig(hidden_size=D, intermediate_size=F,
                                          dtype=torch.float32))


def logits_case(S=32, seed=0, skew=0.0):
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((S, E)).astype(np.float32)
    logits[:, 0] += skew
    return logits


def assert_plan_equal(p, j):
    np.testing.assert_array_equal(p.experts.numpy(), np.asarray(j.experts))
    np.testing.assert_array_equal(p.pos.numpy(), np.asarray(j.pos))
    np.testing.assert_allclose(p.gates.numpy(), np.asarray(j.gates), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(p.exp_counts.numpy(), np.asarray(j.exp_counts))
    np.testing.assert_allclose(float(p.l_aux), float(j.l_aux), rtol=1e-6)
    assert (p.capacity, p.num_experts) == (j.capacity, j.num_experts)


ROUTING_CASES = [
    # k, capacity_factor, min_capacity, drop_tokens, skew
    (1, 1.0, 4, True, 0.0),
    (1, 1.0, 4, True, 3.0),        # skewed: expert 0 overflows, choices drop
    (1, 1.0, 4, False, 3.0),       # dropless
    (2, 1.0, 4, True, 0.0),
    (2, 0.5, 2, True, 2.0),        # tight capacity: first and second choices drop
    (2, 2.0, 4, True, 0.0),
    (2, 1.0, 4, False, 3.0),
]


@pytest.mark.parametrize("k,cf,min_cap,drop,skew", ROUTING_CASES)
def test_routing_matches_jax(k, cf, min_cap, drop, skew):
    logits = logits_case(seed=k, skew=skew)
    if k == 1:
        want = jmoe.top1_routing(jnp.asarray(logits), cf, min_cap, drop_tokens=drop)
        got = pmoe.top1_routing(torch.from_numpy(logits), cf, min_cap, drop_tokens=drop)
        jg = jmoe.top1gating(jnp.asarray(logits), cf, min_cap, drop_tokens=drop)
        pg = pmoe.top1gating(torch.from_numpy(logits), cf, min_cap, drop_tokens=drop)
    else:
        want = jmoe.topk_routing(jnp.asarray(logits), k, cf, min_cap, drop)
        got = pmoe.topk_routing(torch.from_numpy(logits), k, cf, min_cap, drop)
        jg = jmoe.topkgating(jnp.asarray(logits), k, cf, min_cap, drop)
        pg = pmoe.topkgating(torch.from_numpy(logits), k, cf, min_cap, drop)
    assert_plan_equal(got, want)
    if drop and skew:
        assert float((got.gates == 0).sum()) > 0          # something dropped
    if not drop:
        assert got.capacity == logits.shape[0] and bool((got.gates > 0).all())
    for a, b in zip(pg, jg):
        np.testing.assert_allclose(np.asarray(a, np.float32), np.asarray(b, np.float32),
                                   rtol=0, atol=1e-6)


@pytest.mark.parametrize("S,k,cf,min_cap,drop", [
    (32, 1, 1.0, 4, True), (32, 2, 1.25, 4, True), (7, 2, 0.1, 4, True),
    (1000, 2, 2.0, 4, True), (16, 2, 8.0, 4, True), (16, 1, 1.0, 4, False)])
def test_capacity_matches_jax(S, k, cf, min_cap, drop):
    assert pmoe._capacity(S, E, k, cf, min_cap, drop) == \
        jmoe._capacity(S, E, k, cf, min_cap, drop)


def test_ties_go_to_the_lower_expert():
    """Equal logits route to the lower index, as ``jnp.argmax`` does, in
    both rounds of top-2; exp_counts are counted before the drop."""
    logits = np.zeros((6, E), np.float32)
    logits[3, 1] = logits[3, 2] = 1.0
    for k in (1, 2):
        fn_j = jmoe.top1_routing if k == 1 else jmoe.topk_routing
        fn_p = pmoe.top1_routing if k == 1 else pmoe.topk_routing
        args = () if k == 1 else (k,)
        want = fn_j(jnp.asarray(logits), *args, min_capacity=2)
        got = fn_p(torch.from_numpy(logits), *args, min_capacity=2)
        assert_plan_equal(got, want)
    assert got.experts[0].tolist() == [0, 1] and got.experts[3].tolist() == [1, 2]
    assert got.exp_counts.tolist() == [5.0, 6.0, 1.0, 0.0]


def carry_params(jparams, layer, prefix=()):
    """Load a JAX ``MOELayer``'s params into the port's layer."""
    p = jparams
    for key in prefix:
        p = p[key]
    ex = p["experts"]["MixtralExpertMLP_0"]
    sd = {"gate.wg": p["gate"]["wg"]}
    for n in ("w1", "w2", "w3"):
        sd[f"experts.{n}"] = ex[n]["kernel"]
    layer.load_state_dict({k: torch.tensor(np.asarray(v)) for k, v in sd.items()})


LAYER_CASES = {
    # name: k, capacity_factor, drop_tokens, input skew
    "top2_drops": (2, 0.5, True, 0.0),
    "top2_dropless": (2, 1.0, False, 0.0),
    "top1_skewed": (1, 1.0, True, 1.0),
}


def layer_inputs(skew, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, 16, D)).astype(np.float32)
    x += skew * np.abs(x)
    dout = rng.standard_normal((2, 16, D)).astype(np.float32)
    return x, dout


def jax_layer_run(layer, x, dout, aux_w=0.1):
    params = layer.init(jax.random.PRNGKey(1), jnp.asarray(x))["params"]
    if "gate" in params:     # a sharper router: choices far from ties
        params = jax.tree.map(np.asarray, params)
        params["gate"]["wg"] = params["gate"]["wg"] * 10.0

    def loss(p, xx):
        out, l_aux, counts = layer.apply({"params": p}, xx)
        return jnp.sum(out * dout) + aux_w * l_aux, (out, l_aux, counts)

    (_, (out, l_aux, counts)), (gp, gx) = jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True)(params, jnp.asarray(x))
    return params, np.asarray(out), float(l_aux), np.asarray(counts), gp, np.asarray(gx)


def close(got, want, rel=REL):
    want = np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-6)
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * scale)


@pytest.mark.parametrize("mode", ["indices", "einsum", "gmm"])
@pytest.mark.parametrize("case", list(LAYER_CASES))
def test_moe_layer_matches_jax(mode, case):
    k, cf, drop, skew = LAYER_CASES[case]
    x, dout = layer_inputs(skew, seed=len(case))
    jl = jmoe.MOELayer(jax_expert, E, k, cf, cf, min_capacity=2, drop_tokens=drop,
                       dispatch_mode=mode)
    params, out_j, aux_j, counts_j, gp, gx = jax_layer_run(jl, x, dout)
    pl = pmoe.MOELayer(port_expert, E, k, cf, cf, min_capacity=2, drop_tokens=drop,
                       dispatch_mode=mode, model_dim=D)
    carry_params(params, pl)
    xt = torch.from_numpy(x).requires_grad_()
    out, l_aux, counts = pl(xt)
    ((out * torch.from_numpy(dout)).sum() + 0.1 * l_aux).backward()
    close(out.detach().numpy(), out_j)
    np.testing.assert_allclose(float(l_aux.detach()), aux_j, rtol=1e-6)
    np.testing.assert_array_equal(counts.numpy(), counts_j)
    close(xt.grad.numpy(), gx)
    close(pl.gate.wg.grad.numpy(), gp["gate"]["wg"])
    ex = gp["experts"]["MixtralExpertMLP_0"]
    for n in ("w1", "w2", "w3"):
        close(getattr(pl.experts, n).grad.numpy(), ex[n]["kernel"])
    if case == "top2_drops":   # the capacity drops choices, which still count
        plan = pl.gate(torch.from_numpy(x).reshape(-1, D), as_plan=True)
        assert int((plan.gates == 0).sum()) > 0
        assert float(counts.sum()) == 2 * 32


def test_moe_residual_matches_jax():
    """PR-MoE: the dense residual expert and its learned 2-way coefficient."""
    x, dout = layer_inputs(0.0, seed=5)
    jm = JaxMoE(D, jax_expert, num_experts=E, k=2, use_residual=True,
                capacity_factor=2.0)
    params, out_j, aux_j, _, gp, gx = jax_layer_run(jm, x, dout)
    pm = MoE(D, port_expert, num_experts=E, k=2, use_residual=True, capacity_factor=2.0)
    carry_params(params, pm.deepspeed_moe, ("deepspeed_moe",))
    with torch.no_grad():
        for n in ("w1", "w2", "w3"):
            getattr(pm.mlp, n).copy_(torch.tensor(np.asarray(
                params["MixtralExpertMLP_0"][n]["kernel"])))
        pm.coefficient.weight.copy_(torch.tensor(np.asarray(
            params["coefficient"]["kernel"])).T)
        pm.coefficient.bias.copy_(torch.tensor(np.asarray(params["coefficient"]["bias"])))
    xt = torch.from_numpy(x).requires_grad_()
    out, l_aux, _ = pm(xt)
    ((out * torch.from_numpy(dout)).sum() + 0.1 * l_aux).backward()
    close(out.detach().numpy(), out_j)
    np.testing.assert_allclose(float(l_aux.detach()), aux_j, rtol=1e-6)
    close(xt.grad.numpy(), gx)
    close(pm.coefficient.weight.grad.numpy().T, gp["coefficient"]["kernel"])
    close(pm.mlp.w1.grad.numpy(), gp["MixtralExpertMLP_0"]["w1"]["kernel"])
    close(pm.deepspeed_moe.experts.w2.grad.numpy(),
          gp["deepspeed_moe"]["experts"]["MixtralExpertMLP_0"]["w2"]["kernel"])


def test_moe_utils_match_jax():
    """The optimizer-group surface over parameter names agrees with the JAX
    functions over the same Mixtral model's key paths."""
    jcfg = JaxMixtralConfig.tiny(dtype=jnp.float32, remat=False)
    ids = jnp.zeros((1, 8), jnp.int32)
    jparams = jax.eval_shape(lambda: JaxMixtral(jcfg).init(
        jax.random.PRNGKey(0), {"input_ids": ids}))["params"]
    model = MixtralForCausalLM(MixtralConfig.tiny(dtype=torch.float32))
    jm, jd = jutils.split_params_into_different_moe_groups_for_optimizer(jparams)
    pm, pd = putils.split_params_into_different_moe_groups_for_optimizer(model)
    assert (len(pm), len(pd)) == (len(jm), len(jd)) == (6, 17)
    assert all(".experts.w" in n for n in pm)
    assert putils.has_moe_layers(model) == jutils.has_moe_layers(jparams) == (True, 6)
    shared, expert = putils.split_params_into_shared_and_expert_params(
        dict(model.named_parameters()))
    assert sorted(expert) == sorted(pm) and sorted(shared) == sorted(pd)
    jgroups = jutils.configure_moe_param_groups(jparams)
    groups = putils.configure_moe_param_groups(model.named_parameters())
    assert [(len(g["params"]), g["moe"], g.get("name")) for g in groups] == \
        [(len(g["params"]), g["moe"], g.get("name")) for g in jgroups]
    assert [putils.is_moe_param_group(g) for g in groups] == [False, True]
    assert putils.is_moe_param("deepspeed_moe.gate.wg")
    assert not putils.is_moe_param("layers.0.block_sparse_moe.gate.wg")
    assert putils.has_moe_layers({"w": torch.zeros(1)}) == (False, 0)
    assert len(putils.configure_moe_param_groups({"w": torch.zeros(1)})) == 1


class PlainMLP(torch.nn.Module):
    """An expert without the grouped-GEMM contract."""

    def __init__(self):
        super().__init__()
        self.fc = torch.nn.Linear(D, D)

    def forward(self, x):
        return torch.relu(self.fc(x))


def test_errors_name_what_is_not_ported():
    x = torch.zeros(1, 8, D)
    with pytest.raises(ValueError, match="gated-MLP expert declaring GMM_COMPAT"):
        pmoe.MOELayer(PlainMLP, E, dispatch_mode="gmm", model_dim=D)(x)
    with pytest.raises(ValueError, match="does not compose with tp meshes"):
        pmoe.MOELayer(port_expert, E, dispatch_mode="gmm", model_dim=D, tp_size=2)(x)
    with pytest.raises(ValueError, match="divisible by the ep axis"):
        pmoe.MOELayer(port_expert, E, model_dim=D, ep_size=3)
    # expert parallelism needs a topology with the layer's ep axis
    with pytest.raises(ValueError, match="does not match the topology's ep axis"):
        pmoe.MOELayer(port_expert, E, dispatch_mode="gmm", model_dim=D, ep_size=2)(x)
    with pytest.raises(ValueError, match="does not match the topology's ep axis"):
        MoE(D, port_expert, num_experts=E, ep_size=4)(x)
    with pytest.raises(ValueError, match="dispatch_mode must be"):
        pmoe.MOELayer(port_expert, E, dispatch_mode="dense", model_dim=D)


def test_generic_expert_runs_under_vmap():
    """A non-GMM expert (biases, nn.Linear) runs in the capacity modes, one
    stacked parameter per expert parameter, and the two modes agree."""
    layer = pmoe.MOELayer(PlainMLP, E, k=2, capacity_factor=2.0, model_dim=D)
    assert tuple(layer.experts.fc_weight.shape) == (E, D, D)
    assert tuple(layer.experts.fc_bias.shape) == (E, D)
    x = torch.from_numpy(layer_inputs(0.0)[0])
    a, _, _ = layer(x)
    layer.dispatch_mode = "einsum"
    b, _, _ = layer(x)
    torch.testing.assert_close(a, b, rtol=0, atol=1e-5)


def test_noisy_gating_draws_from_the_callers_generator():
    """RSample: Gumbel noise from the generator picks the expert; the same
    seed gives the same plan, the gate stays the clean softmax value of the
    chosen expert, and evaluation (train=False) adds no noise."""
    gate = pmoe.TopKGate(D, E, k=1, noisy_gate_policy="RSample", capacity_factor=4.0)
    x = torch.from_numpy(layer_inputs(0.0)[0]).reshape(-1, D)
    plans = [gate(x, as_plan=True, generator=torch.Generator().manual_seed(7))
             for _ in range(2)]
    torch.testing.assert_close(plans[0].experts, plans[1].experts)
    clean = gate(x, train=False, as_plan=True, generator=torch.Generator())
    probs = torch.softmax(x @ gate.wg, -1)
    assert bool((clean.experts[:, 0] == probs.argmax(-1)).all())
    noisy = plans[0]
    assert bool((noisy.experts != clean.experts).any())
    chosen = probs.gather(1, noisy.experts)
    kept = noisy.gates > 0
    torch.testing.assert_close(noisy.gates[kept], chosen[kept])


def test_moe_param_specs_and_expert_slices_match_jax():
    """``moe_param_specs`` marks the leaves the JAX ``moe_param_specs`` cuts
    over ``ep`` (the stacked experts, not the router), and a model built
    with ``ep_size`` 2 holds, on each ep rank, the contiguous half of every
    expert stack that ``params_from_flax`` and ``expert_slice`` cut."""
    from jax.sharding import PartitionSpec as P
    from deepspeed_tpu_torch.models.mixtral import params_from_flax
    jcfg = JaxMixtralConfig.tiny(dtype=jnp.float32, remat=False)
    ids = jnp.zeros((1, 8), jnp.int32)
    jparams = jax.tree.map(np.asarray, JaxMixtral(jcfg).init(
        jax.random.PRNGKey(0), {"input_ids": ids})["params"])
    jspecs = jax.tree_util.tree_leaves(jutils.moe_param_specs(jparams),
                                       is_leaf=lambda x: isinstance(x, P) or x is None)
    model = MixtralForCausalLM(MixtralConfig.tiny(dtype=torch.float32))
    specs = putils.moe_param_specs(model)
    assert sum(v is not None for v in specs.values()) == \
        sum(isinstance(v, P) for v in jspecs) == 6
    assert all(".experts.w" in n for n, v in specs.items() if v == ("ep",))
    full = params_from_flax(jparams)
    for rank in (0, 1):
        part = MixtralForCausalLM(MixtralConfig.tiny(dtype=torch.float32), ep_size=2)
        sd = params_from_flax(jparams, ep_size=2, ep_rank=rank)
        part.load_state_dict(sd)
        for name, p in part.named_parameters():
            if ".experts." in name:
                assert p.shape[0] == 2
                torch.testing.assert_close(p.detach(), putils.expert_slice(
                    full[name], 2, rank), rtol=0, atol=0)
            else:
                torch.testing.assert_close(p.detach(), full[name], rtol=0, atol=0)
