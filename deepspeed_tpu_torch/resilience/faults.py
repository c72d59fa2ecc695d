"""Fault injection — a process-global registry of named fault points (the
port's own copy of ``deepspeed_tpu/resilience/faults.py``; pure Python).

The resilience layer's testability core: production code calls ``maybe_fail("ckpt.publish")`` at the places real faults strike
(checkpoint writers, the comm shim's host path, worker startup, the engine
step loop), and a drill/test arms those points with deterministic triggers
so every recovery path executes on CPU — no TPU preemption required.

Spec grammar (config key ``resilience.faults`` or env ``DS_TPU_FAULTS``;
entries separated by ``;`` or ``,``)::

    point:mode[@stepA[-B]][!action]

    ckpt.write:once@step3            # raise on the first hit at step 3
    ckpt.publish:n2                  # raise on the 2nd hit ever
    comm.collective:p0.25            # each hit fails with prob 0.25 (seeded)
    step.hang:once@step5!sleep2.5    # stall the step loop 2.5s at step 5
    worker.exit:once!exit7           # hard-exit the process with code 7

Modes: ``once`` (first matching hit) · ``always`` · ``n<K>`` (K-th matching
hit, 1-based) · ``p<FLOAT>`` (per-hit probability from a seeded RNG —
``resilience.fault_seed`` / ``DS_TPU_FAULT_SEED``). The optional step
window only matches once the engine has fed ``set_step``.

Actions: ``raise`` (default — raises :class:`InjectedFault`), ``sleep<S>``
(stall then continue; default for ``step.hang``), ``exit[<code>]``
(``os._exit`` — a crash, no cleanup; default for ``worker.exit``, code 1).

Disarmed (the default), ``maybe_fail`` is a constant-time no-op. Every trip
is recorded through telemetry (``Fault/<point>`` counter events) so Chrome
traces show fault→recovery intervals.

In the port the points the fleet trips are live (``replica.*``,
``transport.*``, ``handoff.bind_fail``); the training-side points keep their
names so a spec written for the JAX package parses here too. The JAX
package's post-mortem bundle, flushed before an ``exit`` or a long
``sleep``, waits for the flight recorder (ROADMAP A15): the port logs and
counts the trip only.
"""

import os
import random
import re
import threading
import time

#: Every point the runtime is instrumented with — where it is called:
#: ``ckpt.write``   NativeCheckpointEngine.save, between shard and manifest
#: ``ckpt.publish`` both engines, between a complete tmp dir and the atomic
#:                  os.replace that makes it the live tag (the universal
#:                  checkpoint publish trips the same point)
#: ``comm.collective`` comm.py timed_op, host-level (non-traced) calls
#: ``comm.partition`` comm.py timed_op, same site — models a network
#:                  partition (a DCN slice dropping out of the gang); the
#:                  elastic reshard path treats it as a slice loss
#: ``io.host``      checkpoint host-side npz/file writes (retry-wrapped)
#: ``step.hang``    top of DeepSpeedEngine.step()
#: ``slice.lost``   DeepSpeedEngine.step(), next to step.hang — a whole
#:                  slice dying mid-step (resilience/elastic_reshard.py)
#: ``worker.exit``  comm.init_distributed (every worker's first runtime call)
#: ``replica.lost`` PrefillDecodeFleet.step(), per replica — the serving
#:                  analog of slice.lost: the fleet marks the replica dead
#:                  and re-admits its in-flight requests elsewhere
#: ``replica.stall`` PrefillDecodeFleet.step(), same site — with the raise
#:                  action the replica skips rounds (no heartbeat) until the
#:                  failure detector declares it dead; with sleep it drags
#:                  the round
#: ``transport.drop`` KVPageTransport, BEFORE the page export — a dropped
#:                  handoff transfer is retried (retry_call); exhaustion
#:                  surfaces as HandoffError and the request re-prefills
#:                  on the decode side
#: ``transport.corrupt`` KVPageTransport wire codec, between serialize and
#:                  parse — the raise is converted into a flipped payload
#:                  byte, so the per-page CRC32 check detects it
#:                  (WireCRCError) and the wire leg re-serializes from the
#:                  still-resident export; exhaustion falls back like
#:                  transport.drop
#: ``handoff.bind_fail`` KVPageTransport, before the destination allocator
#:                  bind — pages already left the source, so no retry:
#:                  straight to the re-prefill fallback
KNOWN_POINTS = ("ckpt.write", "ckpt.publish", "comm.collective",
                "comm.partition", "io.host", "step.hang", "slice.lost",
                "worker.exit", "replica.lost", "replica.stall",
                "transport.drop", "transport.corrupt", "handoff.bind_fail")

#: points the elastic reshard path interprets as "a slice is gone" —
#: an :class:`InjectedFault` from any of these is translated into a
#: shrink-to-survivors reshard instead of a crash
SLICE_LOSS_POINTS = ("slice.lost", "comm.partition")

ENV_SPEC = "DS_TPU_FAULTS"
ENV_SEED = "DS_TPU_FAULT_SEED"

class InjectedFault(RuntimeError):
    """The exception an armed ``raise``-action fault point throws."""

    def __init__(self, point, detail=""):
        super().__init__(f"injected fault at {point!r}"
                         + (f": {detail}" if detail else ""))
        self.point = point


_ENTRY_RE = re.compile(
    r"^(?P<point>[a-z_]+\.[a-z_]+)"
    r":(?P<mode>once|always|n\d+|p(?:\d+(?:\.\d+)?|\.\d+))"
    r"(?:@step(?P<lo>\d+)(?:-(?P<hi>\d+))?)?"
    r"(?:!(?P<action>raise|sleep\d+(?:\.\d+)?|exit(?:\d+)?))?$")

_DEFAULT_ACTIONS = {"step.hang": ("sleep", 3600.0), "worker.exit": ("exit", 1)}


class _Rule:
    __slots__ = ("point", "mode", "nth", "prob", "lo", "hi",
                 "action", "arg", "hits", "trips")

    def __init__(self, point, mode, nth, prob, lo, hi, action, arg):
        self.point, self.mode = point, mode
        self.nth, self.prob = nth, prob
        self.lo, self.hi = lo, hi
        self.action, self.arg = action, arg
        self.hits = 0   # window-matching hits seen
        self.trips = 0  # times actually fired

    def describe(self):
        mode = {"nth": f"n{self.nth}", "prob": f"p{self.prob}"}.get(
            self.mode, self.mode)
        win = "" if self.lo is None else (
            f"@step{self.lo}" + (f"-{self.hi}" if self.hi != self.lo else ""))
        act = self.action + ("" if self.arg is None else str(self.arg))
        return f"{self.point}:{mode}{win}!{act}"


def parse_spec(spec):
    """Parse a fault spec string into rules; raises ValueError on bad
    grammar or unknown points (typos must not silently disarm a drill)."""
    rules = []
    for raw in re.split(r"[;,]", spec or ""):
        entry = raw.strip()
        if not entry:
            continue
        m = _ENTRY_RE.match(entry)
        if m is None:
            raise ValueError(
                f"bad fault spec entry {entry!r} — expected "
                f"'point:mode[@stepA[-B]][!action]' (docs/RESILIENCE.md)")
        point = m.group("point")
        if point not in KNOWN_POINTS:
            raise ValueError(f"unknown fault point {point!r}; known: "
                             f"{', '.join(KNOWN_POINTS)}")
        mode_s = m.group("mode")
        nth = prob = None
        if mode_s[0] == "n" and mode_s != "once":
            mode, nth = "nth", int(mode_s[1:])
            if nth < 1:
                raise ValueError(f"{entry!r}: n<K> is 1-based, got {nth}")
        elif mode_s.startswith("p"):
            mode, prob = "prob", float(mode_s[1:])
            if not 0.0 <= prob <= 1.0:
                raise ValueError(f"{entry!r}: probability {prob} not in [0,1]")
        else:
            mode = mode_s  # once | always
        lo = m.group("lo")
        hi = m.group("hi")
        lo = int(lo) if lo is not None else None
        hi = int(hi) if hi is not None else lo
        if lo is not None and hi < lo:
            raise ValueError(f"{entry!r}: empty step window {lo}-{hi}")
        action_s = m.group("action")
        if action_s is None:
            action, arg = _DEFAULT_ACTIONS.get(point, ("raise", None))
        elif action_s.startswith("sleep"):
            action, arg = "sleep", float(action_s[5:])
        elif action_s.startswith("exit"):
            action, arg = "exit", int(action_s[4:] or "1")
        else:
            action, arg = "raise", None
        rules.append(_Rule(point, mode, nth, prob, lo, hi, action, arg))
    return rules


class FaultInjector:
    """Process-global fault registry (module singleton below). Thread-safe:
    the async checkpoint writer trips ``ckpt.publish`` off-thread."""

    def __init__(self):
        self._lock = threading.Lock()
        self._rules = {}       # point -> [_Rule]
        self._rng = random.Random(0)
        self._step = None      # engine-fed; None = unknown
        self._armed = False
        self._env_checked = False

    # -- configuration ---------------------------------------------------
    def configure(self, spec=None, seed=None, reset=True):
        """Arm from a spec string (see module docstring). ``reset=False``
        merges on top of existing rules (how the env spec layers over the
        config spec). Trip counters always restart."""
        with self._lock:
            if reset:
                self._rules = {}
            for rule in parse_spec(spec or ""):
                self._rules.setdefault(rule.point, []).append(rule)
            if seed is not None:
                self._rng = random.Random(seed)
            self._armed = bool(self._rules)
            self._env_checked = True  # explicit config wins over lazy env

    def _check_env(self):
        with self._lock:
            if self._env_checked:
                return
            self._env_checked = True
        spec = os.environ.get(ENV_SPEC)
        if spec:
            seed = int(os.environ.get(ENV_SEED, "0"))
            self.configure(spec, seed=seed, reset=False)

    def reset(self):
        with self._lock:
            self._rules = {}
            self._armed = False
            self._step = None
            self._env_checked = True  # a reset() must stay disarmed

    # -- runtime ---------------------------------------------------------
    @property
    def armed(self):
        return self._armed

    def set_step(self, step):
        self._step = step

    def maybe_fail(self, point, detail=""):
        """The production hook. No-op unless a rule for ``point`` matches;
        otherwise performs the armed action (raise / sleep / exit)."""
        if not self._env_checked:
            self._check_env()
        if not self._armed:
            return
        fire = None
        with self._lock:
            for rule in self._rules.get(point, ()):
                if rule.lo is not None and (
                        self._step is None or
                        not rule.lo <= self._step <= rule.hi):
                    continue
                rule.hits += 1
                if rule.mode == "once" and rule.trips > 0:
                    continue
                if rule.mode == "nth" and rule.hits != rule.nth:
                    continue
                if rule.mode == "prob" and self._rng.random() >= rule.prob:
                    continue
                rule.trips += 1
                fire = rule
                break
        if fire is None:
            return
        self._record_trip(fire, detail)
        if fire.action == "sleep":
            time.sleep(fire.arg)
            return
        if fire.action == "exit":
            os._exit(fire.arg)
        raise InjectedFault(point, detail or fire.describe())

    def _record_trip(self, rule, detail):
        from deepspeed_tpu_torch.utils.logging import logger
        logger.warning(f"fault injection: tripping {rule.describe()} "
                       f"(step={self._step}, hit={rule.hits})"
                       + (f" [{detail}]" if detail else ""))
        try:
            from deepspeed_tpu_torch import telemetry
            telemetry.record(f"Fault/{rule.point}", 1, kind="counter",
                             action=rule.action, step=self._step,
                             rule=rule.describe())
        except Exception:
            pass  # telemetry must never mask the injected fault itself

    # -- introspection ---------------------------------------------------
    def trip_count(self, point=None):
        with self._lock:
            rules = (sum(self._rules.values(), []) if point is None
                     else self._rules.get(point, ()))
            return sum(r.trips for r in rules)

    def describe(self):
        with self._lock:
            return [r.describe() for rs in self._rules.values() for r in rs]


_INJECTOR = FaultInjector()


def get_injector():
    return _INJECTOR


def configure(spec=None, seed=None, reset=True):
    _INJECTOR.configure(spec, seed=seed, reset=reset)


def reset():
    _INJECTOR.reset()


def set_step(step):
    _INJECTOR.set_step(step)


def maybe_fail(point, detail=""):
    _INJECTOR.maybe_fail(point, detail=detail)


def armed():
    return _INJECTOR.armed


def trip_count(point=None):
    return _INJECTOR.trip_count(point)
