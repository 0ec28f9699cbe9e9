"""String registry for load estimators (port of ``repro.estimators.registry``).

Names resolve to zero-argument factories; last registration wins.  The
registry lists only what is registered: ``current`` and ``ewma`` here.
"""
from __future__ import annotations

from typing import Callable, Dict, List

from repro_torch.estimators.base import as_stateful

_ESTIMATORS: Dict[str, Callable[[], object]] = {}


def register_estimator(name: str,
                       factory: Callable[[], object] | None = None):
    """Register an estimator factory under ``name`` (decorator or call)."""
    def _add(f):
        _ESTIMATORS[name] = f
        return f

    if factory is None:
        return _add
    return _add(factory)


def _ensure_builtins():
    import repro_torch.estimators.builtin  # noqa: F401


def get_estimator(name: str):
    _ensure_builtins()
    try:
        return _ESTIMATORS[name]()
    except KeyError:
        raise KeyError(
            f"unknown estimator {name!r}; registered: {sorted(_ESTIMATORS)}"
        ) from None


def list_estimators() -> List[str]:
    _ensure_builtins()
    return sorted(_ESTIMATORS)


def resolve_estimator(est, noise_std: float = 0.0):
    """str | estimator object -> stateful estimator.

    ``noise_std`` is honoured by ``"current"`` and rejected elsewhere.
    """
    if isinstance(est, str):
        if est == "current":
            from repro_torch.estimators.builtin import CurrentEstimator
            return CurrentEstimator(noise_std=noise_std)
        if noise_std:
            raise ValueError(
                f"est_noise_std is only supported by the 'current' "
                f"estimator, not {est!r}; construct the estimator object "
                f"yourself to combine noise with it")
        return as_stateful(get_estimator(est))
    if noise_std:
        raise ValueError(
            "est_noise_std is ignored when an Estimator object is passed; "
            "set the noise on the object instead")
    return as_stateful(est)
