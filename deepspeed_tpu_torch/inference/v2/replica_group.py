"""Data-parallel FastGen serving (port of
``deepspeed_tpu/inference/v2/replica_group.py``; the DeepSpeed-MII
``replica_num`` analog).

The reference scales FastGen across replicas by launching N server
processes (DeepSpeed-MII). Here, as in the JAX package, the replicas are N
independent (engine, scheduler) pairs driven by one process, each on the
devices of an explicit list, with requests placed round-robin or pinned.
Replicas that share a device share the model's weight tensors (serving only
reads them); a replica on another device gets its own copy, made parameter
by parameter (``model_on``), never by a deep copy that would first double
the weights on the source card. Each replica owns its KV pool.

At ``tp_size`` > 1 each replica spans ``tp_size`` consecutive devices of
the list, as the JAX package's replica spans a ``("tp",)`` submesh of
consecutive devices (``replica_group.py:28-51``), and ``TPReplicas`` lays
the tp ranks out over the first ``tp_size`` processes of the
``torch.distributed`` world: process r holds tp rank r of EVERY replica,
replica i's on device ``i * tp_size + r`` of the list. So process 0 holds
every replica's controller (the single controller of ``engine_v2.py``:
whatever schedules, samples, reads a clock or routes runs there), and each
process r > 0 serves its shares of all replicas from one follower loop
(``engine_v2.follow_engines``) on one control channel, each replica's
messages under its own tag. Prefill tp rank r and decode tp rank r then
live in the same process, so a page ship moves each rank's heads by a
local or peer copy (or its own wire frame) and never through rank 0, with
no point-to-point exchange between processes. Every process calls the
constructor with the same arguments; on a follower it returns once the
controller calls ``stop_followers()``, holding no replica. Replicas whose
device tuples are equal share one tp process group and one copy of each
rank's weights.

For SLO-aware placement put a ``fleet.SLORouter`` in front (it reads the
load signals exposed here); for prefill/decode specialisation see
``fleet.PrefillDecodeFleet``, which builds its replicas through the same
helpers. ``engine_factory.build_replica`` stays the one-replica builder
over the topology's ``tp`` group.
"""

import contextlib

import torch
import torch.distributed

from deepspeed_tpu_torch import resolve_device, telemetry
from deepspeed_tpu_torch.comm import comm as dist
from deepspeed_tpu_torch.inference.v2.engine_factory import build_engine, shard_model
from deepspeed_tpu_torch.inference.v2.engine_v2 import (_BUILD, _STOP, ControlChannel,
                                                        follow_engines)
from deepspeed_tpu_torch.inference.v2.scheduler import SplitFuseScheduler
from deepspeed_tpu_torch.parallel.tensor_parallel import TensorParallel
from deepspeed_tpu_torch.utils.logging import logger


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


def clamp_tp(tp_size):
    """``tp_size`` clamped to the ranks of the world, with the JAX
    ``ReplicaGroup``'s warning (the port's devices of a tp group are its
    processes)."""
    world = dist.get_world_size()
    if tp_size > world:
        logger.warning(f"tp_size {tp_size} > {world} devices; clamping")
        tp_size = world
    return tp_size


class _ModelCopies:
    """One copy of the model per device, made on first use, and one copy
    of a tp rank's share per device tuple of a replica."""

    def __init__(self, model):
        self._model = model
        self._on = {next(model.parameters()).device: model}
        self._shares = {}

    def on(self, device):
        if device not in self._on:
            self._on[device] = model_on(self._model, device)
        return self._on[device]

    def share(self, key, tp, device):
        """Rank ``tp.rank``'s share on ``device`` for the replicas on the
        device tuple ``key`` (cut from the whole model where it lies)."""
        if key not in self._shares:
            self._shares[key] = shard_model(self._model, tp, device=device)
        return self._shares[key]


class TPReplicas:
    """This process's place among the ranks of replicas at ``tp_size`` > 1
    (module docstring). ``slots``: each replica slot's ``tp_size`` devices,
    the replicas built now and the spares a fleet may raise later. Every
    process of the world makes the same groups in the same order (one per
    distinct device tuple, then the control channel's); processes past
    ``tp_size`` hold nothing."""

    def __init__(self, models, slots, tp_size):
        world, self.rank = dist.get_world_size(), dist.get_rank()
        if world < tp_size:
            raise ValueError(f"replicas at tp_size {tp_size} need {tp_size} ranks of the "
                             f"torch.distributed world; it has {world}")
        self.models, self.slots, self.size = models, [tuple(s) for s in slots], tp_size
        ranks = tuple(range(tp_size))
        self.active = self.rank < tp_size
        self._groups = {}
        for key in self.slots:
            if key not in self._groups:
                self._groups[key] = torch.distributed.new_group(ranks=list(ranks))
        control = torch.distributed.new_group(ranks=list(ranks))
        rank = min(self.rank, tp_size - 1)
        self._tp = {key: TensorParallel(g, tp_size, rank, ranks)
                    for key, g in self._groups.items()}
        self.channel = ControlChannel(TensorParallel(control, tp_size, rank, ranks),
                                      self.device(0)) if self.active else None

    @property
    def is_controller(self):
        return self.rank == 0

    def device(self, slot):
        """This process's device of replica slot ``slot``."""
        return resolve_device(self.slots[slot][min(self.rank, self.size - 1)])

    def build(self, slot, engine_config=None, token_budget=None):
        """This process's share of the replica in ``slot``: on the
        controller a ``(device, SplitFuseScheduler)`` pair, on a follower
        its engine (None past ``tp_size``). Once the followers follow, the
        controller ``announce``s a slot before it builds it."""
        if not self.active:
            return None
        key, device = self.slots[slot], self.device(slot)
        with on_device(device):
            model = self.models.share(key, self._tp[key], device)
            engine = build_engine(model, engine_config, device=device, tp=self._tp[key])
        engine.attach_channel(self.channel, slot)
        if not self.is_controller:
            return engine
        return device, SplitFuseScheduler(engine, token_budget=token_budget)

    def announce(self, slot):
        """Controller: the followers build their shares of ``slot`` now."""
        self.channel.send(_BUILD, slot)

    def follow(self, engines, build=None):
        """Follower: serve ``engines`` ({slot: engine}) until stopped; they
        stay readable in ``self.engines`` (those the controller kept)."""
        self.engines = dict(engines)
        if self.active:
            follow_engines(self.engines, self.channel, build)

    def stop(self):
        """Controller: end every follower's loop."""
        self.channel.send(_STOP)


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
        devices: the replicas' devices (torch devices or names),
            ``tp_size`` consecutive ones a replica; several replicas may
            share a device.
        tp_size: devices per replica, clamped to the world's ranks with the
            JAX warning; above 1 every process of the world calls the
            constructor (module docstring) and the controller ends the
            followers with ``stop_followers()``.
        engine_config: per-replica ``InferenceEngineV2`` config.
        token_budget: per-replica SplitFuse token budget.
    """

    def __init__(self, model, devices, tp_size=1, engine_config=None,
                 token_budget=None):
        devices = list(devices)
        if not devices:
            raise ValueError("a replica group needs at least one device")
        tp_size = clamp_tp(int(tp_size))
        if len(devices) % tp_size:
            raise ValueError(f"{len(devices)} devices do not make whole replicas of "
                             f"tp_size {tp_size}")
        models = _ModelCopies(model)
        self._ranks = None
        if tp_size == 1:
            self.replicas = [build_device_replica(models, d, engine_config, token_budget)
                             for d in devices]
        else:
            self._ranks = TPReplicas(models, [devices[i:i + tp_size] for i in
                                              range(0, len(devices), tp_size)], tp_size)
            built = [self._ranks.build(i, engine_config, token_budget)
                     for i in range(len(self._ranks.slots))]
            self.replicas = built if self._ranks.is_controller else []
            if not self._ranks.is_controller:
                self._ranks.follow(enumerate(built))
        self._assignment = {}
        # per-replica assigned counts, kept incrementally
        self._assigned = [0] * len(self.replicas)

    @property
    def is_controller(self):
        """Whether this process drives the group (always at ``tp_size`` 1)."""
        return self._ranks is None or self._ranks.is_controller

    def stop_followers(self):
        """Controller: end the followers' loops (no-op at ``tp_size`` 1)."""
        if self._ranks is not None and self._ranks.is_controller:
            self._ranks.stop()

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
