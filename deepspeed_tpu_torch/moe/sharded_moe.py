"""Sharded MoE core: gating and dispatch (port of
``deepspeed_tpu/moe/sharded_moe.py``).

``TopKGate`` with top-1 / top-k gating, capacity factor, minimum capacity,
optional noisy gating and the GShard load-balancing auxiliary loss, and
``MOELayer``: gate -> dispatch -> experts -> combine, returning
``(output, l_aux, exp_counts)``. Every dispatch mode consumes one
``RoutingPlan``, so the modes agree to float tolerance:

- ``"indices"`` (the default): tokens are gathered into each expert's
  ``[C, D]`` capacity bin by routing index and combined back weighted by
  their gates (gather/scatter in plain PyTorch, the JAX package's XLA path);
- ``"einsum"``: the GShard ``[S, E, C]`` one-hot einsum formulation, the
  numerics oracle;
- ``"gmm"``: no capacity dimension: the rows are sorted by expert and the
  gated-MLP expert's three products run on the grouped-GEMM kernels
  (``ops/grouped_gemm.moe_ffn_gmm``; their backward on the dx and dW
  kernels). A dropped choice still goes through the FFN with gate 0.

The port runs on one device: ``MOELayer(..., ep_size=N)`` with N > 1
(expert parallelism, ROADMAP A9 with kernel row 9b) raises
``NotImplementedError``, and ``"gmm"`` under ``tp_size > 1`` raises the JAX
package's ``ValueError``. Noisy gating (``noisy_gate_policy="RSample"``) draws
its Gumbel noise from a ``torch.Generator`` the caller passes, in place of
the JAX ``"gating"`` rng stream.
"""

import dataclasses
import math
from typing import Any, Callable

import torch
import torch.nn.functional as F
from torch import nn
from torch.func import functional_call

from deepspeed_tpu_torch.ops import grouped_gemm as gg

DISPATCH_MODES = ("indices", "einsum", "gmm")


def _one_hot(idx, num):
    return F.one_hot(idx, num).float()


@dataclasses.dataclass
class RoutingPlan:
    """Index-form routing decision: the single source of gating truth.

    experts/pos/gates: [S, k]. Choice j of token s goes to slot
    ``(experts[s, j], pos[s, j])`` weighted ``gates[s, j]`` (0 when
    dropped). ``exp_counts`` [E] counts the choices before the drop."""
    l_aux: Any
    experts: Any      # [S, k] int64
    pos: Any          # [S, k] int32 (position in the expert's capacity queue)
    gates: Any        # [S, k] float32, 0 for dropped choices
    exp_counts: Any   # [E] float32, pre-drop routing counts
    capacity: int
    num_experts: int


def _capacity(S, E, k, capacity_factor, min_capacity, drop_tokens):
    """Tokens-per-expert budget: ``ceil(S k / E * capacity_factor)``, at
    least ``min_capacity`` and at most S; S when tokens are never dropped."""
    if not drop_tokens:
        return S
    cap = max(math.ceil((S * k / E) * capacity_factor), min_capacity)
    return min(cap, S)


def _gumbel(shape, generator, device):
    tiny = torch.finfo(torch.float32).tiny
    u = torch.rand(shape, generator=generator, device=device).clamp_min(tiny)
    return -torch.log(-torch.log(u))


def top1_routing(logits, capacity_factor=1.0, min_capacity=4,
                 noisy_gate_policy=None, generator=None, used_token_mask=None,
                 drop_tokens=True):
    """Top-1 routing in index form. ``logits`` [S, E] fp32; with
    ``noisy_gate_policy="RSample"`` and a ``generator``, Gumbel noise drawn
    from it picks the expert (the gate values stay the clean softmax)."""
    S, E = logits.shape
    capacity = _capacity(S, E, 1, capacity_factor, min_capacity, drop_tokens)
    if noisy_gate_policy == "RSample" and generator is not None:
        logits_w_noise = logits + _gumbel(logits.shape, generator, logits.device)
    else:
        logits_w_noise = logits
    gates = torch.softmax(logits, dim=-1)
    # the first maximum, as jnp.argmax: ties go to the lower expert
    idx = torch.argmax(logits_w_noise.detach(), dim=-1)          # [S]
    mask1 = _one_hot(idx, E)                                     # [S, E]
    if used_token_mask is not None:
        mask1 = mask1 * used_token_mask[:, None]
    # 1-based position of each token in its expert's queue (fp32 cumsum)
    pos_in_expert = torch.cumsum(mask1, dim=0) * mask1
    keep = (pos_in_expert <= capacity) & (mask1 > 0)
    mask1_kept = mask1 * keep.float()
    # load-balancing loss (GShard): E * sum_e mean_s(gates) * mean_s(mask)
    l_aux = torch.sum(gates.mean(0) * mask1.mean(0)) * E
    gate_val = torch.sum(gates * mask1_kept, dim=-1)             # 0 when dropped
    pos = torch.sum((pos_in_expert - 1) * mask1_kept, dim=-1).int()
    exp_counts = mask1.sum(0)
    return RoutingPlan(l_aux, idx[:, None], pos[:, None], gate_val[:, None],
                       exp_counts, capacity, E)


def topk_routing(logits, k=2, capacity_factor=1.0, min_capacity=4,
                 drop_tokens=True, normalize_gates=True):
    """Top-k routing in index form: k rounds of argmax over the remaining
    softmax mass (ties to the lower index), the aux loss on the first
    choice, queue positions counted across the k choices with first choices
    first, and the kept gates renormalised by their sum."""
    S, E = logits.shape
    capacity = _capacity(S, E, k, capacity_factor, min_capacity, drop_tokens)
    gates = torch.softmax(logits, dim=-1)
    masks, idxs = [], []
    g = gates.detach()
    for _ in range(k):
        idx = torch.argmax(g, dim=-1)
        m = _one_hot(idx, E)
        masks.append(m)
        idxs.append(idx)
        g = g * (1 - m)
    l_aux = torch.sum(gates.mean(0) * masks[0].mean(0)) * E
    offset = torch.zeros(E, dtype=torch.float32, device=logits.device)
    pos_cols, gate_cols = [], []
    for m in masks:
        pos = (torch.cumsum(m, dim=0) - 1) * m + offset[None, :] * m   # 0-based
        keep = (pos < capacity) & (m > 0)
        mk = m * keep.float()
        gate_cols.append(torch.sum(gates * mk, dim=-1))
        pos_cols.append(torch.sum(pos * mk, dim=-1).int())
        offset = offset + m.sum(0)
    gates_sk = torch.stack(gate_cols, dim=1)                     # [S, k]
    if normalize_gates:
        denom = gates_sk.sum(1, keepdim=True)
        gates_sk = gates_sk / torch.clamp_min(denom, 1e-9)
    exp_counts = sum(masks).sum(0)
    return RoutingPlan(l_aux, torch.stack(idxs, dim=1),
                       torch.stack(pos_cols, dim=1), gates_sk, exp_counts,
                       capacity, E)


def _densify(plan: RoutingPlan, S):
    """[S, E, C] combine (fp32) and dispatch (bool) from a RoutingPlan."""
    C, E = plan.capacity, plan.num_experts
    s_idx = torch.arange(S, device=plan.gates.device)[:, None].expand(plan.experts.shape)
    combine = torch.zeros(S, E, C, dtype=torch.float32, device=plan.gates.device)
    combine = combine.index_put(
        (s_idx, plan.experts.long(), plan.pos.long().clamp(max=C - 1)),
        plan.gates, accumulate=True)
    return combine, combine > 0


def top1gating(logits, capacity_factor=1.0, min_capacity=4, noisy_gate_policy=None,
               generator=None, used_token_mask=None, drop_tokens=True):
    """Top-1 gating. logits [S, E] -> (l_aux, combine [S, E, C],
    dispatch [S, E, C], exp_counts [E])."""
    plan = top1_routing(logits, capacity_factor, min_capacity, noisy_gate_policy,
                        generator, used_token_mask, drop_tokens)
    combine, dispatch = _densify(plan, logits.shape[0])
    return plan.l_aux, combine, dispatch, plan.exp_counts


def topkgating(logits, k=2, capacity_factor=1.0, min_capacity=4, drop_tokens=True,
               normalize_gates=True):
    """Top-k gating. logits [S, E] -> (l_aux, combine, dispatch, exp_counts)."""
    plan = topk_routing(logits, k, capacity_factor, min_capacity, drop_tokens,
                        normalize_gates)
    combine, dispatch = _densify(plan, logits.shape[0])
    return plan.l_aux, combine, dispatch, plan.exp_counts


class TopKGate(nn.Module):
    """Linear router ``wg`` [D, E] and gating. The router runs in fp32:
    ``x.float() @ wg.float()`` (``wg`` widened from its storage dtype)."""

    def __init__(self, model_dim, num_experts, k=1, capacity_factor=1.0,
                 eval_capacity_factor=1.0, min_capacity=4, noisy_gate_policy=None,
                 drop_tokens=True, device=None, dtype=torch.float32):
        super().__init__()
        self.wg = nn.Parameter(torch.empty(model_dim, num_experts, device=device,
                                           dtype=dtype))
        nn.init.normal_(self.wg, 0.0, 0.02)
        self.num_experts, self.k = num_experts, k
        self.capacity_factor = capacity_factor
        self.eval_capacity_factor = eval_capacity_factor
        self.min_capacity = min_capacity
        self.noisy_gate_policy = noisy_gate_policy
        self.drop_tokens = drop_tokens

    def forward(self, x, train=True, as_plan=False, generator=None):
        logits = x.float() @ self.wg.float()
        cf = self.capacity_factor if train else self.eval_capacity_factor
        if self.k == 1:
            plan = top1_routing(logits, cf, self.min_capacity, self.noisy_gate_policy,
                                generator=generator if train else None,
                                drop_tokens=self.drop_tokens)
        else:
            plan = topk_routing(logits, self.k, cf, self.min_capacity,
                                drop_tokens=self.drop_tokens)
        if as_plan:
            return plan
        combine, dispatch = _densify(plan, logits.shape[0])
        return plan.l_aux, combine, dispatch, plan.exp_counts


class Experts(nn.Module):
    """E experts applied to [E, C, D] inputs, their parameters stacked on a
    leading expert axis (the JAX package's ``nn.vmap`` over the expert).

    ``expert_factory()`` builds one expert module; E of them are built and
    each parameter ``name`` of theirs is stacked into ``experts.<name>``
    [E, ...] (dots become underscores), so a gated-MLP expert with
    parameters ``w1``, ``w3``, ``w2`` gives ``experts.w1`` [E, D, F] at the
    JAX package's layout. The forward runs one expert under ``torch.vmap``
    with each expert's slice of the stack (``functional_call`` on a template
    kept on the meta device, outside the parameter tree)."""

    def __init__(self, expert_factory, num_experts):
        super().__init__()
        experts = [expert_factory() for _ in range(num_experts)]
        self._names = [n for n, _ in experts[0].named_parameters()]
        for n in self._names:
            stacked = torch.stack([dict(e.named_parameters())[n].detach()
                                   for e in experts])
            self.register_parameter(n.replace(".", "_"), nn.Parameter(stacked))
        object.__setattr__(self, "template", experts[0].to("meta"))
        self.num_experts = num_experts

    def stacked(self, name):
        """The [E, ...] stack of the experts' parameter ``name``."""
        return getattr(self, name.replace(".", "_"))

    def forward(self, x):
        params = {n: self.stacked(n) for n in self._names}
        return torch.vmap(lambda p, xe: functional_call(self.template, p, (xe,)))(
            params, x)


def _gmm_ep_forward(*args, **kwargs):
    """Expert-parallel grouped-GEMM forward (the JAX package's shard_map of
    dispatch all-to-all, local ragged FFN, combine all-to-all)."""
    raise NotImplementedError(
        "dispatch_mode='gmm' under expert parallelism (ep > 1) is not ported "
        "yet: ROADMAP A9 (expert parallelism, kernel row 9b moe_ffn_gmm_rows)")


def _moe_gmm_ep_shard(*args, **kwargs):
    """One ep shard's dropless dispatch -> local grouped FFN -> combine."""
    raise NotImplementedError(
        "the expert-parallel grouped-GEMM shard is not ported yet: ROADMAP A9 "
        "(expert parallelism, kernel row 9b moe_ffn_gmm_rows)")


class MOELayer(nn.Module):
    """Gate -> dispatch -> experts -> combine. ``forward(x)`` returns
    ``(output, l_aux, exp_counts)``; see the module docstring for
    ``dispatch_mode``. ``model_dim`` is the token width D (the JAX module
    learns it from its input); ``ep_size`` and ``tp_size`` are the
    process-group topology's expert- and tensor-parallel degrees, 1 on the
    port's single device (the JAX ``a2a_wire_bits``, the expert-parallel
    wire's precision, comes with expert parallelism); ``gate_dtype`` is the
    router weight's storage dtype (fp32, as the JAX param)."""

    def __init__(self, expert_factory: Callable[[], nn.Module], num_experts, k=1,
                 capacity_factor=1.0, eval_capacity_factor=1.0, min_capacity=4,
                 noisy_gate_policy=None, drop_tokens=True, dispatch_mode="indices",
                 *, model_dim, ep_size=1, tp_size=1, device=None,
                 gate_dtype=torch.float32):
        super().__init__()
        if dispatch_mode not in DISPATCH_MODES:
            raise ValueError(f"MOELayer dispatch_mode must be 'indices', "
                             f"'einsum' or 'gmm', got {dispatch_mode!r}")
        if ep_size > 1:
            raise NotImplementedError(
                f"expert parallelism (ep_size={ep_size}) is not ported yet: "
                "ROADMAP A9 (expert parallelism, kernel row 9b)")
        self.gate = TopKGate(model_dim, num_experts, k, capacity_factor,
                             eval_capacity_factor, min_capacity, noisy_gate_policy,
                             drop_tokens, device=device, dtype=gate_dtype)
        self.experts = Experts(expert_factory, num_experts)
        self.num_experts, self.k = num_experts, k
        self.dispatch_mode = dispatch_mode
        self.tp_size = tp_size

    def forward(self, x, train=True, generator=None, matmul=gg.grouped_matmul):
        """``x`` [..., D] -> (output [..., D] in x's dtype, l_aux, exp_counts).
        ``generator`` feeds noisy gating; ``matmul`` is the grouped product
        of the ``"gmm"`` mode (the kernel, or its plain version for
        comparisons)."""
        orig_shape = x.shape
        D = x.shape[-1]
        xf = x.reshape(-1, D)
        S = xf.shape[0]
        plan = self.gate(xf, train, as_plan=True, generator=generator)
        E, C = plan.num_experts, plan.capacity

        if self.dispatch_mode == "gmm":
            return self._gmm_forward(x, xf, plan, matmul)

        if self.dispatch_mode == "einsum":
            combine, dispatch = _densify(plan, S)
            expert_in = torch.einsum("sec,sd->ecd", dispatch.to(xf.dtype), xf)
            expert_out = self.experts(expert_in)
            out = torch.einsum("sec,ecd->sd", combine.to(expert_out.dtype), expert_out)
            return out.reshape(orig_shape), plan.l_aux, plan.exp_counts

        # routed dispatch: slot (e, c) <- token index over the kept choices;
        # empty slots read token 0 and are zeroed by the validity mask, and
        # dropped choices write to a spare slot E*C that is cut off
        kept = plan.gates > 0                                    # [S, k]
        flat_slot = plan.experts.long() * C + plan.pos.long().clamp(max=C - 1)
        target = torch.where(kept, flat_slot, E * C).reshape(-1)
        token_of = torch.arange(S, device=x.device)[:, None].expand(flat_slot.shape)
        slot_token = torch.zeros(E * C + 1, dtype=torch.long, device=x.device)
        slot_token[target] = token_of.reshape(-1)
        slot_valid = torch.zeros(E * C + 1, dtype=torch.bool, device=x.device)
        slot_valid[target] = True
        expert_in = xf[slot_token[:E * C]].reshape(E, C, D)
        expert_in = expert_in * slot_valid[:E * C].reshape(E, C, 1).to(xf.dtype)
        expert_out = self.experts(expert_in)
        # combine: each token reads its k slots, gate-weighted in fp32
        flat_out = expert_out.reshape(E * C, -1)
        out = None
        for j in range(self.k):
            term = flat_out[flat_slot[:, j]].float() * plan.gates[:, j, None]
            out = term if out is None else out + term
        return out.to(x.dtype).reshape(orig_shape), plan.l_aux, plan.exp_counts

    def _gmm_forward(self, x, xf, plan, matmul):
        """Ragged grouped-GEMM expert FFN routed by the plan."""
        expert = self.experts.template
        names = getattr(expert, "GMM_COMPAT", None)
        if names is None or not hasattr(expert, "gmm_shapes"):
            raise ValueError(
                "dispatch_mode='gmm' needs a gated-MLP expert declaring "
                "GMM_COMPAT + gmm_shapes (e.g. MixtralExpertMLP); "
                f"{type(expert).__name__} does not")
        D = xf.shape[-1]
        shapes = {nm: (self.num_experts, *shp) for nm, shp in expert.gmm_shapes(D).items()}
        if self.tp_size > 1:
            # the ragged kernel has no tp decomposition
            raise ValueError(
                "dispatch_mode='gmm' does not compose with tp meshes "
                f"(mesh has tp={self.tp_size}); use dispatch_mode='indices'")
        d_ff = shapes[names[0]][-1]
        if not gg.is_supported(D, d_ff):
            raise ValueError(
                f"dispatch_mode='gmm': d_model={D} / d_ff={d_ff}: "
                f"{gg.unsupported_reason(D, d_ff)} for the grouped-GEMM kernel")
        w1, w3, w2 = (self.experts.stacked(n).to(x.dtype) for n in names)
        out = gg.moe_ffn_gmm(xf, plan.gates, plan.experts, w1, w2, w3,
                             n_experts=self.num_experts, dtype=x.dtype, matmul=matmul)
        return out.reshape(x.shape), plan.l_aux, plan.exp_counts
