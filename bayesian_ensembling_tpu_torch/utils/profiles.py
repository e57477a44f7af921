"""One-switch fit profiles.

Copy of ``bayesian_ensembling_tpu/utils/profiles.py`` (pure Python): the one
owner of the fit-schedule presets, so ``pipeline.run_scenario`` and every
later surface resolve ``profile="fast"`` to the same knobs as the JAX
package.  The presets were chosen from measurements of the JAX package; they
are still to be re-measured on the H100.

``faithful`` (default everywhere)
    The reference's own conventions: scratch Adam at the surface's default
    step count, classic DBA-10.

``fast``
    One schedule per regime:

    * annual / resampled 1-D (T <= ~200): coarse-in-time bfgs, 30 coarse
      steps at stride 12 + 20 warm-started fine steps;
    * native monthly (T = 1980/1032): coarse-to-fine in time, 500 coarse
      Adam steps at stride 12 + 100 fine steps;
    * gridded per-cell fits: scratch bfgs-30.
"""

from __future__ import annotations

import typing as tp

__all__ = ["PROFILES", "resolve_profile"]

PROFILES = ("faithful", "fast")


def resolve_profile(
    name: str,
    *,
    native_monthly: bool = False,
    gridded: bool = False,
) -> tp.Dict[str, tp.Any]:
    """Fit-kwarg preset for ``name`` in the given regime.

    Returns a dict of ``n_optim_nits / optimizer / time_stride /
    fine_steps`` overrides; empty for ``faithful`` (surface defaults).
    """
    if name not in PROFILES:
        raise ValueError(f"unknown profile {name!r}; one of {PROFILES}")
    if name == "faithful":
        return {}
    if gridded:
        return {"n_optim_nits": 30, "optimizer": "bfgs"}
    if native_monthly:
        return {
            "n_optim_nits": 500,
            "optimizer": "adam",
            "time_stride": 12,
            "fine_steps": 100,
        }
    return {
        "n_optim_nits": 30,
        "optimizer": "bfgs",
        "time_stride": 12,
        "fine_steps": 20,
    }
