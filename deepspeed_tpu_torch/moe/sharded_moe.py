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

Over ``torch.distributed`` (the installed ``parallel.groups`` topology),
each rank holds its share of the tokens, in the JAX package's
``batch_spec`` order over the data axes ("dpr", "dp", "ep", "sp"), and the
gate computes what the JAX gate computes over the global token matrix: the
capacity from the global token count, queue positions offset by the lower
ranks' per-expert counts (one all-gather of a [k + 1, E] tensor per
layer), and ``me``, ``ce`` and ``exp_counts`` from global sums. Each rank's
``l_aux`` has the global value, and its gradient is the data-parallel world
W times this rank's share of the global one: the engine averages the ranks'
gradients, and every other gradient a rank computes is likewise W times its
share (the rank's loss is a mean over its tokens).

With ``ep_size`` > 1 (expert parallelism) rank ``i`` of an ``ep`` group
holds experts ``i * E/ep`` to ``(i + 1) * E/ep - 1`` (the JAX
``moe_param_specs`` layout): ``"gmm"`` sends each routed row to its
expert's owner through the dispatch all-to-all, runs the received rows
through ``ops/grouped_gemm.moe_ffn_gmm_rows`` and sends them back through
the combine all-to-all (the JAX ``_gmm_ep_forward`` / ``_moe_gmm_ep_shard``),
optionally on a quantized wire (``a2a_wire_bits``, forward only); the
capacity modes fill their global ``[E, C, D]`` bins with this rank's tokens
and move them to the owners by a reduce-scatter over ``ep`` and an
all-reduce over the other data axes, and back by an all-gather over
``ep``, exact since each slot has one nonzero contributor. ``"gmm"`` under
``tp_size > 1`` raises the JAX package's ``ValueError``. Noisy gating
(``noisy_gate_policy="RSample"``) draws its Gumbel noise from a
``torch.Generator`` the caller passes, in place of the JAX ``"gating"`` rng
stream.
"""

import dataclasses
import math
from typing import Any, Callable

import torch
import torch.nn.functional as F
from torch import nn
from torch.func import functional_call

from deepspeed_tpu_torch.comm import comm as dist
from deepspeed_tpu_torch.ops import grouped_gemm as gg
from deepspeed_tpu_torch.parallel import groups
from deepspeed_tpu_torch.parallel.topology import DATA_AXES
from deepspeed_tpu_torch.runtime.comm.coalesced_collectives import expert_all_to_all

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


def _data_group():
    """(group, world, index) of the ranks whose tokens the gate sees as one
    batch: the data axes of the installed topology, axes-major."""
    topo = groups._TOPOLOGY
    if topo is None:
        return None, 1, 0
    return topo.axes_group(DATA_AXES)


def _gather_counts(rows, data_group):
    """All-gather this rank's [n, E] count rows over the data-parallel
    ranks: [world, n, E] (detached). A world of one exchanges nothing, also
    where the group is None and the process group has other ranks."""
    group, world, _ = data_group
    if world == 1:
        return rows.detach()[None]
    return dist.all_gather(rows.detach().contiguous(), group=group, tiled=False)


def _global_mean(local_sum, global_sum, world, S):
    """The mean over the global batch, with the gradient of this rank's
    share scaled by ``world`` (see the module docstring)."""
    return (global_sum + (world * local_sum - world * local_sum.detach())) / S


def top1_routing(logits, capacity_factor=1.0, min_capacity=4,
                 noisy_gate_policy=None, generator=None, used_token_mask=None,
                 drop_tokens=True, data_group=(None, 1, 0)):
    """Top-1 routing in index form. ``logits`` [S, E] fp32 (this rank's S
    rows of the global batch over ``data_group``); with
    ``noisy_gate_policy="RSample"`` and a ``generator``, Gumbel noise drawn
    from it picks the expert (the gate values stay the clean softmax)."""
    S_local, E = logits.shape
    _, world, index = data_group
    S = S_local * world
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
    stats = _gather_counts(torch.stack([mask1.sum(0), gates.sum(0)]), data_group)
    prefix, total = stats[:index, 0].sum(0), stats[:, 0].sum(0)
    # load-balancing loss (GShard): E * sum_e mean_s(gates) * mean_s(mask)
    me = _global_mean(gates.sum(0), stats[:, 1].sum(0), world, S)
    l_aux = torch.sum(me * (total / S)) * E
    # 1-based position of each token in its expert's queue (fp32 cumsum),
    # after the lower ranks' tokens
    pos_in_expert = (torch.cumsum(mask1, dim=0) + prefix) * mask1
    keep = (pos_in_expert <= capacity) & (mask1 > 0)
    mask1_kept = mask1 * keep.float()
    gate_val = torch.sum(gates * mask1_kept, dim=-1)             # 0 when dropped
    pos = torch.sum((pos_in_expert - 1) * mask1_kept, dim=-1).int()
    return RoutingPlan(l_aux, idx[:, None], pos[:, None], gate_val[:, None],
                       total, capacity, E)


def topk_routing(logits, k=2, capacity_factor=1.0, min_capacity=4,
                 drop_tokens=True, normalize_gates=True, data_group=(None, 1, 0)):
    """Top-k routing in index form: k rounds of argmax over the remaining
    softmax mass (ties to the lower index), the aux loss on the first
    choice, queue positions counted across the k choices with first choices
    first (globally over ``data_group``: every rank's first choices before
    any second choice), and the kept gates renormalised by their sum."""
    S_local, E = logits.shape
    _, world, index = data_group
    S = S_local * world
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
    stats = _gather_counts(torch.stack([m.sum(0) for m in masks] + [gates.sum(0)]),
                           data_group)
    prefixes = [stats[:index, j].sum(0) for j in range(k)]
    totals = [stats[:, j].sum(0) for j in range(k)]
    me = _global_mean(gates.sum(0), stats[:, k].sum(0), world, S)
    l_aux = torch.sum(me * (totals[0] / S)) * E
    offset = torch.zeros(E, dtype=torch.float32, device=logits.device)
    pos_cols, gate_cols = [], []
    for m, prefix, total in zip(masks, prefixes, totals):
        pos = (torch.cumsum(m, dim=0) + prefix - 1) * m + offset[None, :] * m   # 0-based
        keep = (pos < capacity) & (m > 0)
        mk = m * keep.float()
        gate_cols.append(torch.sum(gates * mk, dim=-1))
        pos_cols.append(torch.sum(pos * mk, dim=-1).int())
        offset = offset + total
    gates_sk = torch.stack(gate_cols, dim=1)                     # [S, k]
    if normalize_gates:
        denom = gates_sk.sum(1, keepdim=True)
        gates_sk = gates_sk / torch.clamp_min(denom, 1e-9)
    exp_counts = sum(totals)
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
    ``x.float() @ wg.float()`` (``wg`` widened from its storage dtype). The
    routing is global over the installed topology's data-parallel ranks
    (see the module docstring), so every rank of them calls it."""

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
        data_group = _data_group()
        if self.k == 1:
            plan = top1_routing(logits, cf, self.min_capacity, self.noisy_gate_policy,
                                generator=generator if train else None,
                                drop_tokens=self.drop_tokens, data_group=data_group)
        else:
            plan = topk_routing(logits, self.k, cf, self.min_capacity,
                                drop_tokens=self.drop_tokens, data_group=data_group)
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


def _reduce_scatter(t, group):
    return dist.reduce_scatter(t, group=group)


def _all_gather(t, group):
    return dist.all_gather(t, group=group)


def _all_reduce(t, group):
    return dist.all_reduce(t.clone(), group=group)


def _moe_gmm_ep_shard(xl, gl, el, w1, w2, w3, *, n_experts, group, ep, bits,
                      dtype, matmul):
    """One ep shard's dispatch -> local grouped FFN -> combine (the JAX
    ``_gmm_ep_forward`` and its ``shard_map`` body ``_moe_gmm_ep_shard``).

    xl [Sl, D] this rank's tokens; gl / el [Sl, k] their gates and GLOBAL
    expert ids; w1/w3 [E/ep, D, F], w2 [E/ep, F, D] this rank's slice of the
    expert stack (expert e lives on ep rank e // E_local); ``group`` the ep
    group of ``ep`` ranks. The per-peer send buffer has the static worst
    case (every local row routed to one peer): [ep, R, D] with R = Sl * k.
    Its empty slots carry zero rows tagged with the sentinel local id
    E_local, which ``moe_ffn_gmm_rows`` sorts past the last expert's group
    and skips; their results are never read back."""
    E_local = n_experts // ep
    Sl, D = xl.shape
    k = el.shape[-1]
    R = Sl * k
    dev = xl.device
    # moe_scatter by destination PEER: stable-sort the local (token, choice)
    # rows by their expert's owner
    flat_e = el.reshape(-1).long()                       # [R] global ids
    dest = flat_e // E_local                             # [R] owning peer
    order = torch.sort(dest, stable=True).indices
    ds = dest[order]
    counts = torch.zeros(ep, dtype=torch.long, device=dev).index_add_(
        0, dest, torch.ones_like(dest))
    starts = torch.cumsum(counts, 0) - counts
    pos = torch.arange(R, device=dev) - starts[ds]
    xs = xl[order // k].to(dtype)                        # [R, D] by peer
    send_x = torch.zeros(ep, R, D, dtype=dtype, device=dev).index_put((ds, pos), xs)
    send_e = torch.full((ep, R), E_local, dtype=torch.int32, device=dev)
    send_e[ds, pos] = (flat_e % E_local)[order].int()

    recv_x = expert_all_to_all(send_x, group, bits=bits, op="a2a_dispatch")
    recv_e = dist.all_to_all_single(send_e, group=group)
    y_rows = gg.moe_ffn_gmm_rows(recv_x.reshape(ep * R, D), recv_e.reshape(ep * R),
                                 w1, w2, w3, n_experts=E_local, dtype=dtype,
                                 matmul=matmul)
    back = expert_all_to_all(y_rows.reshape(ep, R, D), group, bits=bits,
                             op="a2a_combine")
    # moe_gather: each routed row from the slot it was sent from, unsorted,
    # and the k choices gate-combined in fp32
    y = torch.empty(R, D, dtype=dtype, device=dev)
    y[order] = back[ds, pos]
    return (y.view(Sl, k, D).float() * gl[..., None]).sum(1).to(dtype)


class MOELayer(nn.Module):
    """Gate -> dispatch -> experts -> combine. ``forward(x)`` returns
    ``(output, l_aux, exp_counts)``; see the module docstring for
    ``dispatch_mode``. ``model_dim`` is the token width D (the JAX module
    learns it from its input); ``ep_size`` and ``tp_size`` are the
    topology's expert- and tensor-parallel degrees: with ``ep_size`` > 1
    the layer holds ``num_experts // ep_size`` experts (this rank's slice,
    ``experts.num_experts``), and the installed ``parallel.groups``
    topology must have an ``ep`` axis of that size. ``a2a_wire_bits`` (None,
    8 or 4) is the expert-parallel wire's precision in ``"gmm"`` mode;
    ``gate_dtype`` is the router weight's storage dtype (fp32, as the JAX
    param)."""

    def __init__(self, expert_factory: Callable[[], nn.Module], num_experts, k=1,
                 capacity_factor=1.0, eval_capacity_factor=1.0, min_capacity=4,
                 noisy_gate_policy=None, drop_tokens=True, dispatch_mode="indices",
                 *, model_dim, ep_size=1, tp_size=1, a2a_wire_bits=None, device=None,
                 gate_dtype=torch.float32):
        super().__init__()
        if dispatch_mode not in DISPATCH_MODES:
            raise ValueError(f"MOELayer dispatch_mode must be 'indices', "
                             f"'einsum' or 'gmm', got {dispatch_mode!r}")
        if num_experts % ep_size:
            raise ValueError(f"expert parallelism needs num_experts ({num_experts}) "
                             f"divisible by the ep axis ({ep_size})")
        self.gate = TopKGate(model_dim, num_experts, k, capacity_factor,
                             eval_capacity_factor, min_capacity, noisy_gate_policy,
                             drop_tokens, device=device, dtype=gate_dtype)
        self.experts = Experts(expert_factory, num_experts // ep_size)
        self.num_experts, self.k = num_experts, k
        self.dispatch_mode = dispatch_mode
        self.ep_size, self.tp_size = ep_size, tp_size
        self.a2a_wire_bits = a2a_wire_bits

    def _ep_groups(self):
        """(ep group, expert-data group and its size) of the installed
        topology, checked against ``ep_size``."""
        topo = groups._TOPOLOGY
        mesh_ep = topo.ep_size if topo is not None else 1
        if mesh_ep != self.ep_size:
            raise ValueError(f"MOELayer(ep_size={self.ep_size}) does not match the "
                             f"topology's ep axis ({mesh_ep}): install a topology "
                             f"with ep={self.ep_size} (parallel.groups.initialize)")
        ed_group, ed_world, _ = topo.axes_group(topo.expert_zero_axes)
        return topo.get_group("ep"), ed_group, ed_world

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
            expert_out = self._run_experts(expert_in)
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
        expert_out = self._run_experts(expert_in)
        # combine: each token reads its k slots, gate-weighted in fp32
        flat_out = expert_out.reshape(E * C, -1)
        out = None
        for j in range(self.k):
            term = flat_out[flat_slot[:, j]].float() * plan.gates[:, j, None]
            out = term if out is None else out + term
        return out.to(x.dtype).reshape(orig_shape), plan.l_aux, plan.exp_counts

    def _run_experts(self, expert_in):
        """The experts on the global [E, C, D] bins this rank filled with its
        tokens' slots. Under expert parallelism the bins go to their owners
        (a reduce-scatter over ``ep`` sums the ep peers' slots, an all-reduce
        over the expert-data group the rest) and the owners' [E/ep, C, D]
        outputs come back by an all-gather over ``ep``."""
        if self.ep_size == 1:
            return self.experts(expert_in)
        ep_group, ed_group, ed_world = self._ep_groups()
        local = dist.with_transpose(expert_in, _reduce_scatter, _all_gather, ep_group)
        if ed_world > 1:
            local = dist.with_transpose(local, _all_reduce, _all_reduce, ed_group)
        return dist.with_transpose(self.experts(local), _all_gather, _reduce_scatter,
                                   ep_group)

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
        if self.ep_size > 1:
            ep_group, _, _ = self._ep_groups()
            out = _moe_gmm_ep_shard(xf, plan.gates, plan.experts, w1, w2, w3,
                                    n_experts=self.num_experts, group=ep_group,
                                    ep=self.ep_size, bits=self.a2a_wire_bits,
                                    dtype=x.dtype, matmul=matmul)
        else:
            out = gg.moe_ffn_gmm(xf, plan.gates, plan.experts, w1, w2, w3,
                                 n_experts=self.num_experts, dtype=x.dtype,
                                 matmul=matmul)
        return out.reshape(x.shape), plan.l_aux, plan.exp_counts
