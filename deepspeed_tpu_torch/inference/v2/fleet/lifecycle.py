"""Replica lifecycle for the serving fleet: state machine, failure
detection, and the saturation-driven autoscaler (port of
``deepspeed_tpu/inference/v2/fleet/lifecycle.py``).

The serving analog of the trainer's elasticity stack: where training
survives slice loss by resharding the gang, the fleet
survives replica loss by marking the replica DEAD, routing around it, and
re-admitting its in-flight requests from their last committed prefix
digest (``PrefillDecodeFleet._lose_replica``). Everything here is pure
host-side policy — no torch, no devices — so the state machine is
property-testable and the failure detector runs on an injected clock. The
JAX package also writes each transition into its flight recorder's ring;
the port's flight recorder waits for ROADMAP A15.

Three pieces:

- :class:`ReplicaLifecycle` — the ``live -> draining -> dead`` state
  machine over ``(role, index)`` keys. LIVE replicas step and take
  placements; DRAINING replicas step (finishing their in-flight work) but
  take nothing new; DEAD replicas are tombstones — never stepped, never
  placed, their host-side request state still readable for recovery.
- :class:`FailureDetector` — the watchdog pattern
  in its synchronous serving form: every completed replica step ``beat``s;
  ``check()`` names live replicas whose last beat is older than the
  timeout (a replica wedged by ``replica.stall`` stops beating and gets
  declared dead without ever raising).
- :class:`FleetAutoscaler` — the router's backlog/TTFT saturation model
  acting instead of just reporting: queue depth or decode-side KV
  saturation scales the decode side up (warm standby first), sustained
  idleness drains and retires the newest idle replica (never below the
  floor), with a cooldown so bursty arrivals don't flap the fleet.
"""

import time

from deepspeed_tpu_torch import telemetry

# module-level alias so the disabled-telemetry zero-overhead test can prove
# lifecycle bookkeeping never reads the clock (the detector's clock is
# injected explicitly; this alias is only its default)
_now = time.monotonic

LIVE = "live"
DRAINING = "draining"
DEAD = "dead"

_TRANSITIONS = frozenset([(LIVE, DRAINING), (LIVE, DEAD), (DRAINING, DEAD)])


class ReplicaLifecycle:
    """``live -> draining -> dead`` over hashable replica keys.

    Keys are ``(role, index)`` tuples in the fleet, but any hashable works
    (the property test drives it with abstract ids). Transitions are
    one-way: a dead replica never revives — scale-up after a planned
    retirement creates a NEW key (the warm engine pool makes that cheap),
    so request-routing invariants never see a key flip back to live.
    """

    def __init__(self):
        self._state = {}

    def add(self, key):
        """Register a new replica as LIVE. Re-adding any known key raises —
        keys are single-use by design (see class docstring)."""
        if key in self._state:
            raise ValueError(f"replica {key!r} already registered "
                             f"({self._state[key]})")
        self._state[key] = LIVE

    def state(self, key):
        return self._state[key]

    def known(self, key):
        return key in self._state

    def is_live(self, key):
        return self._state.get(key) == LIVE

    def is_stepping(self, key):
        """LIVE or DRAINING — replicas that still run scheduler rounds."""
        return self._state.get(key) in (LIVE, DRAINING)

    def live(self, role=None):
        """Sorted keys in LIVE state (optionally one role)."""
        return sorted(k for k, s in self._state.items()
                      if s == LIVE and (role is None or k[0] == role))

    def counts(self):
        """{state: count} over every registered replica."""
        out = {LIVE: 0, DRAINING: 0, DEAD: 0}
        for s in self._state.values():
            out[s] += 1
        return out

    def _to(self, key, new):
        cur = self._state.get(key)
        if cur is None:
            raise KeyError(f"unknown replica {key!r}")
        if (cur, new) not in _TRANSITIONS:
            raise ValueError(
                f"illegal lifecycle transition {cur} -> {new} for {key!r}")
        self._state[key] = new

    def mark_draining(self, key):
        self._to(key, DRAINING)

    def mark_dead(self, key):
        self._to(key, DEAD)


class FailureDetector:
    """Missed-heartbeat detector over an injectable clock.

    ``beat(key)`` after every completed replica step; ``check()`` returns
    the keys whose last beat is older than ``timeout_s``. No threads —
    the fleet's serving loop is synchronous, so the detector is polled
    once per round (the watchdog's ``check()``-directly-callable testing
    seam, promoted to the production path). ``forget`` drops a replica
    that was marked dead so it can't re-fire."""

    def __init__(self, timeout_s=30.0, clock=None):
        if timeout_s <= 0:
            raise ValueError(f"timeout_s must be > 0, got {timeout_s}")
        self.timeout_s = float(timeout_s)
        self._clock = clock if clock is not None else _now
        self._last = {}

    def beat(self, key):
        self._last[key] = self._clock()

    def forget(self, key):
        self._last.pop(key, None)

    def last_beat(self, key):
        return self._last.get(key)

    def check(self):
        """Keys overdue for a heartbeat, oldest-beat first."""
        now = self._clock()
        out = [(t, k) for k, t in self._last.items()
               if now - t > self.timeout_s]
        return [k for _, k in sorted(out, key=lambda e: e[0])]


class FleetAutoscaler:
    """Round-based decode-side autoscaler over a fleet + router pair.

    Call :meth:`observe` once per serving round (between ``router.step()``
    calls). Signals, all O(replicas) host-side reads:

    - scale UP when the router's bounded queue has depth (admissions are
      over predicted SLO everywhere) or any live decode replica's KV
      occupancy crosses ``up_occupancy`` — both mean the decode side is
      the bottleneck the router's TTFT model is seeing;
    - scale DOWN (drain, then retire) the newest decode replica that has
      been completely idle for ``down_idle_rounds`` consecutive rounds
      while the router queue is empty, never below ``min_decode``.

    ``cooldown_rounds`` rounds pass between actions so one burst doesn't
    flap the fleet; the fleet's warm engine pool makes up/down cheap
    (retired engines are reused, so scale-up after a trough pays no
    recompile). Purely counter-based — no clock reads — so the disabled-
    telemetry zero-overhead test can drive it with a raising ``_now``."""

    def __init__(self, fleet, router, min_decode=1, max_decode=None,
                 up_queue_depth=1, up_occupancy=0.85,
                 down_idle_rounds=12, cooldown_rounds=8):
        if min_decode < 1:
            raise ValueError(f"min_decode must be >= 1, got {min_decode}")
        self._fleet = fleet
        self._router = router
        self._min = int(min_decode)
        self._max = None if max_decode is None else int(max_decode)
        self._up_queue = int(up_queue_depth)
        self._up_occ = float(up_occupancy)
        self._down_idle = int(down_idle_rounds)
        self._cooldown = int(cooldown_rounds)
        self.scale_ups = 0
        self.scale_downs = 0
        self._cool = 0
        self._idle = {}  # decode index -> consecutive fully-idle rounds

    def observe(self):
        """One control tick: returns ``("up", index)``, ``("down", index)``
        or None."""
        fleet = self._fleet
        live = fleet.live_decode_indices()
        for j in live:
            self._idle[j] = self._idle.get(j, 0) + 1 \
                if fleet.decode_active(j) == 0 else 0
        if len(live) < self._min:
            # below the floor (replica loss): replace capacity NOW —
            # recovery bypasses the cooldown, which only damps churn
            j = fleet.scale_up_decode()
            if j is not None:
                self.scale_ups += 1
                self._idle[j] = 0
                return ("up", j)
        if self._cool > 0:
            self._cool -= 1
            return None
        depth = self._router.queue_depth
        saturated = any(fleet.decode_occupancy(j) >= self._up_occ
                        for j in live)
        if (depth >= self._up_queue or saturated) and \
                (self._max is None or len(live) < self._max):
            j = fleet.scale_up_decode()
            if j is not None:
                self.scale_ups += 1
                self._cool = self._cooldown
                self._idle[j] = 0
                return ("up", j)
        if depth == 0 and not saturated and len(live) > self._min:
            idle = [j for j in live if self._idle.get(j, 0) >= self._down_idle]
            if idle:
                j = idle[-1]  # newest idle replica retires first
                fleet.scale_down_decode(j)
                self.scale_downs += 1
                self._cool = self._cooldown
                self._idle.pop(j, None)
                return ("down", j)
        return None

    def report(self):
        rep = {"scale_ups": self.scale_ups, "scale_downs": self.scale_downs,
               "live_decode": len(self._fleet.live_decode_indices())}
        tm = telemetry.get_telemetry()
        if tm.enabled:
            tm.fleet_gauge("fleet/live_replicas",
                           rep["live_decode"]
                           + len(self._fleet.live_prefill_indices()))
        return rep
