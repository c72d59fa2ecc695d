"""Data-parallel FastGen serving (port of
``deepspeed_tpu/inference/v2/replica_group.py``; the DeepSpeed-MII
``replica_num`` analog).

The reference scales FastGen across replicas by launching N server
processes (DeepSpeed-MII). Here, as in the JAX package, the replicas are N
independent (engine, scheduler) pairs inside one process, each on a device
of an explicit list, with requests placed round-robin or pinned. Replicas
that share a device share the model's weight tensors (serving only reads
them); a replica on another device gets its own copy, made parameter by
parameter (``model_on``), never by a deep copy that would first double the
weights on the source card. Each replica owns its KV pool.

For SLO-aware placement put a ``fleet.SLORouter`` in front (it reads the
load signals exposed here); for prefill/decode specialisation see
``fleet.PrefillDecodeFleet``, which builds its replicas through the same
``build_device_replica``. ``engine_factory.build_replica`` stays the
one-replica builder over a ``tp`` group; replicas at ``tp_size`` > 1 in a
group or a fleet (per-rank page shipping between the tp groups of two
replicas) wait for ROADMAP A5 part 3.
"""

import contextlib

import torch

from deepspeed_tpu_torch import resolve_device, telemetry
from deepspeed_tpu_torch.inference.v2.engine_factory import build_engine
from deepspeed_tpu_torch.inference.v2.scheduler import SplitFuseScheduler


def on_device(device):
    """The context a replica's host code runs under: its card is the
    current CUDA device, so the kernels launched through ctypes (which use
    the current device's context) and PyTorch's own calls agree. The
    counterpart of the JAX package's ``with mesh:``. A no-op on the CPU."""
    device = torch.device(device)
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


def model_on(model, device):
    """``model`` with its weights on ``device``: the model itself when they
    already lie there, else a new module (built on the meta device) that
    holds a copy of each parameter, copied one at a time."""
    device = torch.device(device)
    if next(model.parameters()).device == device:
        return model
    copy = type(model)(model.config, device="meta")
    copy.load_state_dict({k: v.to(device) for k, v in model.state_dict().items()},
                         assign=True)
    return copy.requires_grad_(False)


def check_single_rank(tp_size):
    if int(tp_size) != 1:
        raise NotImplementedError(
            f"fleet and replica-group replicas at tp_size {tp_size} (per-rank page "
            "shipping between tp groups) are not ported yet; see ROADMAP.md queue "
            "A5 part 3")


class _ModelCopies:
    """One copy of the model per device, made on first use."""

    def __init__(self, model):
        self._model = model
        self._on = {next(model.parameters()).device: model}

    def on(self, device):
        if device not in self._on:
            self._on[device] = model_on(self._model, device)
        return self._on[device]


def build_device_replica(models, device, engine_config=None, token_budget=None):
    """One (device, ``SplitFuseScheduler``) pair on ``device``: the engine
    serves ``models.on(device)`` (``_ModelCopies``) and its KV pool lives
    there. Shared by ``ReplicaGroup`` and both sides of the fleet, so every
    replica is built the same way."""
    device = resolve_device(device)
    with on_device(device):
        engine = build_engine(models.on(device), engine_config, device=device)
    return device, SplitFuseScheduler(engine, token_budget=token_budget)


class ReplicaGroup:
    """N replicas of ``InferenceEngineV2`` + ``SplitFuseScheduler``.

    Args:
        model: the model every replica serves (its weights on one device).
        devices: one torch device (or name) per replica; several replicas
            may share a device.
        tp_size: devices per replica; only 1 is ported (A5 part 3).
        engine_config: per-replica ``InferenceEngineV2`` config.
        token_budget: per-replica SplitFuse token budget.
    """

    def __init__(self, model, devices, tp_size=1, engine_config=None,
                 token_budget=None):
        check_single_rank(tp_size)
        devices = list(devices)
        if not devices:
            raise ValueError("a replica group needs at least one device")
        models = _ModelCopies(model)
        self.replicas = [build_device_replica(models, d, engine_config, token_budget)
                         for d in devices]
        self._assignment = {}
        # per-replica assigned counts, kept incrementally
        self._assigned = [0] * len(self.replicas)

    @property
    def replica_num(self):
        return len(self.replicas)

    def submit(self, uid, prompt, replica=None, **kwargs):
        """Round-robin request placement (the reference MII load balancer);
        pass ``replica`` to pin (the fleet router does)."""
        r = len(self._assignment) % len(self.replicas) if replica is None \
            else int(replica)
        self._assignment[uid] = r
        self._assigned[r] += 1
        device, sched = self.replicas[r]
        with on_device(device):
            sched.submit(uid, prompt, **kwargs)
        tm = telemetry.get_telemetry()
        if tm.enabled:
            tm.serving_gauge("serving/replica_skew", self.active_skew(),
                             replica=r)
        return r

    def active_skew(self):
        """Active-count skew across replicas ((max - min) / mean, 0.0 =
        perfectly even). O(replicas)."""
        counts = [sched.active_count() for _, sched in self.replicas]
        mean = sum(counts) / len(counts) if counts else 0.0
        return (max(counts) - min(counts)) / mean if mean else 0.0

    def load_report(self):
        """Per-replica load: assigned / active request counts and KV
        occupancy, plus the active-count skew (and the SLO classes'
        attainment when telemetry has any)."""
        per = []
        for i, (device, sched) in enumerate(self.replicas):
            per.append({"replica": i, "device": str(device),
                        "assigned": self._assigned[i],
                        "active": sched.active_count(),
                        "kv_occupancy": sched.kv_stats()["occupancy"]})
        rep = {"replicas": per, "active_skew": self.active_skew()}
        slo = telemetry.slo_snapshot()
        if slo:
            rep["slo_classes"] = slo
        return rep

    @property
    def has_work(self):
        return any(sched.has_work for _, sched in self.replicas)

    def step(self):
        """One pipelined round across all replicas: every replica's forward
        is launched (``step_begin``) before any result is fetched
        (``step_finish``), so one replica's host work overlaps the others'
        device work. Returns the merged finished uids."""
        pendings = []
        for device, sched in self.replicas:
            if not sched.has_work:
                continue
            with on_device(device):
                p = sched.step_begin()
            if p is not None:
                pendings.append((device, sched, p))
        finished = []
        for device, sched, p in pendings:
            with on_device(device):
                finished.extend(sched.step_finish(p))
        return finished

    def router_targets(self):
        """The (device, scheduler) pairs a ``fleet.SLORouter`` places over."""
        return list(self.replicas)

    def cancel(self, uid):
        """Cancel a request wherever it was placed (frees its KV blocks).
        Returns True iff it was live."""
        r = self._assignment.get(uid)
        if r is None:
            return False
        device, sched = self.replicas[r]
        with on_device(device):
            return sched.cancel(uid)

    def results(self):
        """Generated tokens so far across all replicas, {uid: int32}."""
        out = {}
        for _, sched in self.replicas:
            out.update(sched.results())
        return out

    def run_to_completion(self, max_rounds=10000):
        """Drain every replica (pipelined rounds); merged {uid: tokens}."""
        for _ in range(max_rounds):
            if not self.has_work:
                break
            self.step()
        else:
            raise RuntimeError("replica group did not converge")
        return self.results()
