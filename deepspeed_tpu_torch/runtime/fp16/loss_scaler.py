"""Loss scaling (port of ``deepspeed_tpu/runtime/fp16/loss_scaler.py``).

Static scaling keeps ``loss_scale``; dynamic scaling doubles it after
``loss_scale_window`` consecutive overflow-free steps and halves it (with
hysteresis) on overflow, with the JAX package's arithmetic. The state is a
tuple of Python numbers: the engine reads the overflow flag on the host once
per optimizer step in fp16 training, where the JAX package keeps the state on
the device to avoid that read.
"""

from typing import NamedTuple


class LossScaleState(NamedTuple):
    loss_scale: float       # current scale
    good_steps: int         # consecutive overflow-free steps
    hysteresis: int         # remaining tolerated overflows before halving


def init_loss_scale_state(fp16_config, static_scale=None):
    if static_scale is None:
        static_scale = fp16_config.loss_scale
    if static_scale and static_scale > 0:
        init = float(static_scale)
    else:
        init = float(2.0 ** fp16_config.initial_scale_power)
    return LossScaleState(loss_scale=init, good_steps=0,
                          hysteresis=int(fp16_config.hysteresis))


def update_loss_scale(state, found_inf, fp16_config, dynamic):
    """One ``DynamicLossScaler.update_scale`` step. Returns the new state."""
    if not dynamic:
        return state
    window = fp16_config.loss_scale_window
    found_inf = bool(found_inf)
    # on overflow: consume hysteresis; halve the scale once it is exhausted
    hys_left = max(state.hysteresis - 1, 0) if found_inf else state.hysteresis
    scale = state.loss_scale
    if found_inf and state.hysteresis <= 1:
        scale = max(scale / 2.0, fp16_config.min_loss_scale)
    good = 0 if found_inf else state.good_steps + 1
    grow = not found_inf and good > 0 and good % window == 0
    if grow:
        scale = scale * 2.0
    # reset hysteresis after an overflow-free step (consecutive_hysteresis
    # False) or a growth interval
    hys = (int(fp16_config.hysteresis)
           if grow or (not found_inf and not fp16_config.consecutive_hysteresis)
           else hys_left)
    return LossScaleState(loss_scale=scale, good_steps=good, hysteresis=hys)
