"""Live task migration and proactive drain (port of ``repro.migration``).

Tasks resident on draining nodes (the fault schedule's advance warning)
or, with ``overload_threshold``, on overloaded ones are re-placed onto
healthy nodes before the fault lands, keeping their progress.  The
simulator's migration pass admits them through the shared
``api.admission.admit_queue`` front end with the ``migrate`` policy; the
sources are excluded by ``DRAIN_LOAD`` on their reserved rows
(``api.admission.mask_unavailable``), so the kernels need no new input.
``migration=None`` leaves the simulator untouched.
"""
from __future__ import annotations

from typing import NamedTuple

from repro_torch.faults.injection import install_config_validator


class MigrationConfig(NamedTuple):
    """Live-migration knobs (the reference's fields and defaults).
    Requires faults: the drain tables are what migration acts on."""

    bandwidth: int = 32          # migrations started per slot
    migrate_cost: int = 1        # extra slots of runtime per move
    pool_size: int = 128         # in-flight pool; its overflow is evicted
                                 # into the retry queue
    overload_threshold: float = 0.0  # > 0: nodes whose dominant estimate
                                     # exceeds it drain too
    margin_scale: float = 0.0    # target cap 1 - margin_scale * P


def _validate_migration(cfg: MigrationConfig) -> None:
    """Reject degenerate migration configs at construction."""
    if cfg.bandwidth < 0:
        raise ValueError(
            f"MigrationConfig.bandwidth must be >= 0 (0 = no migration "
            f"budget, the evict-and-retry fallback), got {cfg.bandwidth!r}")
    if cfg.migrate_cost < 0:
        raise ValueError(
            f"MigrationConfig.migrate_cost must be >= 0, "
            f"got {cfg.migrate_cost!r}")
    if cfg.pool_size <= 0:
        raise ValueError(
            f"MigrationConfig.pool_size must be a positive pool width, "
            f"got {cfg.pool_size!r}")
    if float(cfg.overload_threshold) < 0.0:
        raise ValueError(
            f"MigrationConfig.overload_threshold must be >= 0, "
            f"got {cfg.overload_threshold!r}")
    if float(cfg.margin_scale) < 0.0:
        raise ValueError(
            f"MigrationConfig.margin_scale must be >= 0, "
            f"got {cfg.margin_scale!r}")


install_config_validator(MigrationConfig, _validate_migration)

__all__ = ["MigrationConfig"]
