"""String registry for placement policies (port of ``repro.api.registry``).

Names map to zero-argument factories; ``get_policy`` builds a fresh
instance per lookup and re-registering a name overwrites it (last one
wins).  ``resolve_policy`` also takes a ``SchedulerKind`` or a policy
object.
"""
from __future__ import annotations

from typing import Callable, Dict, List

from repro_torch.core.types import SchedulerKind

_POLICIES: Dict[str, Callable[[], object]] = {}

KIND_TO_NAME = {
    SchedulerKind.LEAST_FIT: "least-fit",
    SchedulerKind.OVERSUB: "oversub",
    SchedulerKind.FLEX_F: "flex-f",
    SchedulerKind.FLEX_L: "flex-l",
}


def register_policy(name: str, factory: Callable[[], object] | None = None):
    """Register a policy factory under ``name`` (decorator or call)."""
    def _add(f):
        _POLICIES[name] = f
        return f

    if factory is None:
        return _add
    return _add(factory)


def _ensure_builtins():
    import repro_torch.api.policies  # noqa: F401


def get_policy(name: str):
    _ensure_builtins()
    try:
        return _POLICIES[name]()
    except KeyError:
        raise KeyError(
            f"unknown policy {name!r}; registered: {sorted(_POLICIES)}"
        ) from None


def list_policies() -> List[str]:
    _ensure_builtins()
    return sorted(_POLICIES)


def resolve_policy(policy):
    """str | SchedulerKind | policy object -> policy object."""
    if isinstance(policy, SchedulerKind):
        return get_policy(KIND_TO_NAME[policy])
    if isinstance(policy, str):
        return get_policy(policy)
    return policy
