"""Swappable module-implementation registry for the serving engine (port of
``deepspeed_tpu/inference/v2/modules/module_registry.py``).

Reference seam: ``deepspeed/inference/v2/modules/module_registry.py``
(``DSModuleRegistryBase.instantiate_config`` — named implementations per
module interface, ``supports_config`` validation, KeyError on unknown names)
plus the hardware heuristics in ``modules/heuristics.py:186``.

An implementation row is (interface, name, supports, build):

- ``supports(**ctx) -> (ok, reason)`` — cheap check (shapes, dtype); the
  reason string surfaces in errors.
- ``build(**ctx) -> callable`` — the function the engine calls.

``select`` takes the implementation by name: that implementation or a loud
error. Choosing the name (what "auto" means) belongs to ``heuristics``; a
choice that silently degraded would invalidate every run that used it.
"""

import dataclasses
from typing import Any, Callable, Dict, Tuple


class UnknownModuleError(KeyError):
    """Named implementation (or interface) is not registered."""


class UnsupportedModuleError(ValueError):
    """The named implementation cannot serve this call's context."""


@dataclasses.dataclass(frozen=True)
class ModuleImpl:
    interface: str
    name: str
    supports: Callable[..., Tuple[bool, str]]
    build: Callable[..., Any]


_REGISTRY: Dict[str, Dict[str, ModuleImpl]] = {}


def register_module(interface: str, name: str,
                    supports: Callable[..., Tuple[bool, str]] = None):
    """Decorator: register ``build`` under (interface, name)."""
    def deco(build):
        if name in _REGISTRY.get(interface, {}):
            raise ValueError(f"duplicate module impl {interface}:{name}")
        _REGISTRY.setdefault(interface, {})[name] = ModuleImpl(
            interface, name,
            supports or (lambda **ctx: (True, "unconditional")), build)
        return build
    return deco


def select(interface: str, name: str, **ctx):
    """(name, built-callable) of the implementation ``name`` for one call
    site: UnknownModuleError if it is not registered, UnsupportedModuleError
    with the implementation's reason if ``supports`` rejects this context."""
    if interface not in _REGISTRY:
        raise UnknownModuleError(
            f"no module interface {interface!r}; registered interfaces: "
            f"{sorted(_REGISTRY)}")
    by_name = _REGISTRY[interface]
    if name not in by_name:
        raise UnknownModuleError(
            f"unknown {interface} implementation {name!r}; "
            f"registered: {sorted(by_name)}")
    impl = by_name[name]
    ok, reason = impl.supports(**ctx)
    if not ok:
        raise UnsupportedModuleError(
            f"{interface}:{name} cannot serve this call: {reason}")
    return impl.name, impl.build(**ctx)
