"""Config plumbing (port of ``deepspeed_tpu/runtime/config_utils.py``).

The reference uses pydantic-v1 models with ``deprecated``/``new_param`` field
metadata; to avoid a pydantic version dependency this is a small hand-rolled
equivalent: ``DeepSpeedConfigModel`` subclasses declare defaults as class
attributes and are constructed from a dict, with unknown-key warnings and
deprecated-key remapping. The same JSON validates the same way as in the JAX
package.
"""

import copy

from deepspeed_tpu_torch.utils.logging import logger


def get_scalar_param(param_dict, param_name, param_default_value):
    return param_dict.get(param_name, param_default_value)


def get_dict_param(param_dict, param_name, param_default_value):
    return param_dict.get(param_name, param_default_value)


def get_list_param(param_dict, param_name, param_default_value):
    return param_dict.get(param_name, param_default_value)


class DeepSpeedConfigModel:
    """Dict-backed config with class-attribute defaults.

    Subclasses set defaults as class attributes and may define
    ``_deprecated = {"old_key": "new_key"}``. Construction copies defaults to the
    instance then overlays the dict.
    """

    _deprecated = {}

    def __init__(self, param_dict=None, **kwargs):
        param_dict = dict(param_dict or {})
        param_dict.update(kwargs)
        # instance copies of all class-level defaults
        for klass in reversed(type(self).__mro__):
            for k, v in vars(klass).items():
                if not k.startswith("_") and not callable(v) and not isinstance(v, (property, classmethod, staticmethod)):
                    setattr(self, k, copy.deepcopy(v))
        known = set(k for k in vars(self) if not k.startswith("_"))
        for k, v in param_dict.items():
            key = k
            if key in self._deprecated:
                new = self._deprecated[key]
                logger.warning(f"Config param {key} is deprecated, use {new}")
                key = new
            if key in known:
                if v == "auto":
                    # HF-style "auto": keep the default (reference "auto"
                    # values are filled in by the HF integration layer)
                    continue
                cur = getattr(self, key)
                if isinstance(cur, DeepSpeedConfigModel) and isinstance(v, dict):
                    setattr(self, key, type(cur)(v))
                else:
                    setattr(self, key, v)
            else:
                self._handle_unknown(key, v)

    def _handle_unknown(self, key, value):
        logger.warning(f"{type(self).__name__}: ignoring unknown config key '{key}'")

    def to_dict(self):
        out = {}
        for k, v in vars(self).items():
            if k.startswith("_"):
                continue
            out[k] = v.to_dict() if isinstance(v, DeepSpeedConfigModel) else v
        return out

    def __repr__(self):
        return f"{type(self).__name__}({self.to_dict()})"
