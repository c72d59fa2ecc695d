"""LR schedules (port of ``deepspeed_tpu/runtime/lr_schedules.py``).

LRRangeTest, OneCycle, WarmupLR, WarmupDecayLR and WarmupCosineLR, each a
pure ``lr(step) -> float`` built from the same config params as in the JAX
package, wrapped in ``LRSchedulerShim`` with the reference scheduler surface
(``step`` / ``get_lr`` / ``state_dict``). The engine reads the lr on the host
and hands it to the optimizer as a Python float.
"""

import math

LR_RANGE_TEST = "LRRangeTest"
ONE_CYCLE = "OneCycle"
WARMUP_LR = "WarmupLR"
WARMUP_DECAY_LR = "WarmupDecayLR"
WARMUP_COSINE_LR = "WarmupCosineLR"

VALID_LR_SCHEDULES = [LR_RANGE_TEST, ONE_CYCLE, WARMUP_LR, WARMUP_DECAY_LR, WARMUP_COSINE_LR]


def _clip(x, lo, hi):
    return min(max(x, lo), hi)


def _warmup(step, warmup_num_steps, warmup_min_lr, warmup_max_lr, warmup_type="log"):
    warmup_num_steps = max(2, warmup_num_steps)
    if warmup_type == "log":
        # min + (max - min) * log(step + 1) / log(warmup_steps): exactly
        # warmup_min_lr at step 0
        frac = math.log(step + 1.0) / math.log(float(warmup_num_steps))
    else:  # linear
        frac = step / float(warmup_num_steps)
    return warmup_min_lr + (warmup_max_lr - warmup_min_lr) * _clip(frac, 0.0, 1.0)


def warmup_lr(warmup_min_lr=0.0, warmup_max_lr=0.001, warmup_num_steps=1000,
              warmup_type="log", **_):
    """WarmupLR: warmup then hold at max."""

    def lr(step):
        step = float(step)
        if step < warmup_num_steps:
            return _warmup(step, warmup_num_steps, warmup_min_lr, warmup_max_lr, warmup_type)
        return float(warmup_max_lr)

    return lr


def warmup_decay_lr(total_num_steps, warmup_min_lr=0.0, warmup_max_lr=0.001,
                    warmup_num_steps=1000, warmup_type="log", **_):
    """WarmupDecayLR: warmup then linear decay to 0 at total_num_steps."""

    def lr(step):
        step = float(step)
        if step < warmup_num_steps:
            return _warmup(step, warmup_num_steps, warmup_min_lr, warmup_max_lr, warmup_type)
        decay = (total_num_steps - step) / max(float(total_num_steps - warmup_num_steps), 1.0)
        return warmup_max_lr * _clip(decay, 0.0, 1.0)

    return lr


def warmup_cosine_lr(total_num_steps, warmup_min_ratio=0.0, warmup_num_steps=1000,
                     cos_min_ratio=0.0001, warmup_type="log", warmup_max_lr=1.0, **_):
    """WarmupCosineLR: ratio warmup then cosine decay, as an absolute lr
    (warmup_max_lr folded in, as the JAX package does)."""

    def lr(step):
        step = float(step)
        if step < warmup_num_steps:
            return _warmup(step, warmup_num_steps, warmup_min_ratio * warmup_max_lr,
                           warmup_max_lr, warmup_type)
        progress = _clip((step - warmup_num_steps)
                         / max(float(total_num_steps - warmup_num_steps), 1.0), 0.0, 1.0)
        cosine = cos_min_ratio + (1 - cos_min_ratio) * 0.5 * (1 + math.cos(math.pi * progress))
        return warmup_max_lr * cosine

    return lr


def lr_range_test(lr_range_test_min_lr=1e-3, lr_range_test_step_size=2000,
                  lr_range_test_step_rate=1.0, lr_range_test_staircase=False, **_):
    """LRRangeTest: linearly or staircase increasing lr probe."""

    def lr(step):
        interval = float(step) / lr_range_test_step_size
        if lr_range_test_staircase:
            interval = math.floor(interval)
        return lr_range_test_min_lr * (1.0 + interval * lr_range_test_step_rate)

    return lr


def one_cycle(cycle_min_lr=0.0, cycle_max_lr=0.001, decay_lr_rate=0.0,
              cycle_first_step_size=2000, cycle_second_step_size=None,
              cycle_first_stair_count=0, cycle_second_stair_count=None,
              decay_step_size=0, **_):
    """OneCycle: triangular cycle then decay."""
    second = cycle_second_step_size if cycle_second_step_size is not None else cycle_first_step_size
    total_cycle = cycle_first_step_size + second

    def lr(step):
        step = float(step)
        if step < total_cycle:
            if step < cycle_first_step_size:
                return cycle_min_lr + (cycle_max_lr - cycle_min_lr) * (step / cycle_first_step_size)
            return cycle_max_lr - (cycle_max_lr - cycle_min_lr) * (
                (step - cycle_first_step_size) / second)
        if decay_step_size == 0:
            return float(cycle_min_lr)
        return cycle_min_lr / (1.0 + math.floor((step - total_cycle) / decay_step_size)
                               * decay_lr_rate)

    return lr


_FACTORIES = {
    WARMUP_LR: warmup_lr,
    WARMUP_DECAY_LR: warmup_decay_lr,
    WARMUP_COSINE_LR: warmup_cosine_lr,
    LR_RANGE_TEST: lr_range_test,
    ONE_CYCLE: one_cycle,
}


def get_lr_schedule(name, params, base_lr=None):
    """Build an ``lr(step)`` function from a scheduler config section."""
    if name is None:
        base = float(base_lr if base_lr is not None else 1e-3)
        return lambda step: base
    if name not in _FACTORIES:
        raise ValueError(f"unknown lr schedule {name}; valid: {VALID_LR_SCHEDULES}")
    params = dict(params or {})
    if base_lr is not None:
        params.setdefault("warmup_max_lr", base_lr)
    return _FACTORIES[name](**params)


class LRSchedulerShim:
    """Object with the reference scheduler surface (step/get_lr/state_dict)."""

    def __init__(self, schedule_fn, engine=None):
        self.schedule_fn = schedule_fn
        self._engine = engine
        self.last_batch_iteration = -1

    def step(self, last_batch_iteration=None):
        if last_batch_iteration is not None:
            self.last_batch_iteration = last_batch_iteration
        else:
            self.last_batch_iteration += 1

    def get_lr(self):
        step = self.last_batch_iteration
        if self._engine is not None:
            step = self._engine.global_steps
        return [float(self.schedule_fn(max(step, 0)))]

    def get_last_lr(self):
        return self.get_lr()

    def state_dict(self):
        return {"last_batch_iteration": self.last_batch_iteration}

    def load_state_dict(self, sd):
        self.last_batch_iteration = sd["last_batch_iteration"]
