"""Shared argparse plumbing for the port's command-line entry points.

Counterpart of ``bayesian_ensembling_tpu/utils/cli.py``: one owner of the
fit options' command-line surface, so the entry points stay consistent with
each other and with ``ops/gp.fit_gp_batch_dispatch``.  The presets behind
``--profile`` come from ``utils/profiles.py``.
"""

from __future__ import annotations

import argparse
import sys
import typing as tp

from bayesian_ensembling_tpu_torch.utils.profiles import resolve_profile

__all__ = [
    "add_optimizer_arg",
    "add_warm_time_args",
    "validate_warm_time_args",
    "add_profile_arg",
    "add_dba_args",
    "apply_profile",
]


def add_optimizer_arg(ap: argparse.ArgumentParser) -> None:
    """Add ``--optimizer`` with the shared help text."""
    ap.add_argument(
        "--optimizer",
        choices=["adam", "lbfgs", "bfgs"],
        default="adam",
        help="hyperparameter optimiser: 'adam' (reference-faithful, the "
        "default), 'bfgs' (per-model damped quasi-Newton; pair with a small "
        "--n-optim-nits, e.g. 30-60) or 'lbfgs' (optax's L-BFGS with a zoom "
        "line search: one step size for the batch's summed objective)",
    )


def add_warm_time_args(ap: argparse.ArgumentParser) -> None:
    """Add ``--time-stride`` / ``--fine-steps`` with the shared help text."""
    ap.add_argument(
        "--time-stride",
        type=int,
        default=1,
        help="coarse-to-fine-in-time fit: run the coarse step count on "
        "every Nth timestep, then --fine-steps warm-started steps at full "
        "resolution (ops/gp.fit_gp_batch_warm_time; requires --fine-steps)",
    )
    ap.add_argument(
        "--fine-steps",
        type=int,
        default=None,
        help="full-resolution warm-started steps for --time-stride > 1",
    )


def add_dba_args(ap: argparse.ArgumentParser, default_iterations: int = 10) -> None:
    """Add ``--dba-iterations/--dba-method/--dba-tol`` with shared help."""
    ap.add_argument(
        "--dba-iterations", type=int, default=default_iterations,
        help="mean-target DBA iterations (classic: fixed count; "
        "subgradient: the epoch cap, the reference flagship passes 50)",
    )
    ap.add_argument(
        "--dba-method",
        choices=["classic", "subgradient"],
        default="classic",
        help="mean-target algorithm: 'classic' (exact-mean-update DBA) or "
        "'subgradient' (the tslearn stochastic variant the reference "
        "flagship calls; pair with --dba-iterations 50; tol defaults to 1e-3)",
    )
    ap.add_argument(
        "--dba-tol", type=float, default=None,
        help="convergence tolerance: classic, stop when the barycentre "
        "moves less than this between iterations (--dba-iterations becomes "
        "the cap); subgradient, the epoch-to-epoch cost tolerance (default 1e-3)",
    )


def add_profile_arg(ap: argparse.ArgumentParser) -> None:
    """Add ``--profile`` with the shared help text (utils/profiles.py)."""
    ap.add_argument(
        "--profile",
        choices=["faithful", "fast"],
        default="faithful",
        help="fit preset: 'faithful' (the reference's conventions: scratch "
        "Adam, the surface defaults) or 'fast' (one schedule per regime: "
        "coarse-in-time bfgs at annual resolution, warm stride-12 Adam at "
        "native monthly, bfgs-30 for gridded fits; utils/profiles.py).  "
        "Mutually exclusive with setting "
        "--optimizer/--n-optim-nits/--time-stride/--fine-steps yourself.",
    )


def apply_profile(
    ap: argparse.ArgumentParser,
    args: argparse.Namespace,
    *,
    resample_freq: tp.Optional[str] = None,
    gridded: bool = False,
) -> None:
    """Expand ``--profile`` into the fit knobs on ``args`` (in place).

    The profile OWNS those knobs: if any of them was moved off its parser
    default alongside a non-faithful profile, that is two sources of truth
    for one setting, refused at parse time.
    """
    if getattr(args, "profile", "faithful") == "faithful":
        return
    knobs = ("n_optim_nits", "optimizer", "time_stride", "fine_steps")
    for k in knobs:
        if hasattr(args, k) and getattr(args, k) != ap.get_default(k):
            ap.error(
                f"--profile {args.profile} sets --{k.replace('_', '-')} "
                "itself; drop the explicit flag or use --profile faithful"
            )
    native_monthly = resample_freq is not None and str(resample_freq).lower() == "none"
    for k, v in resolve_profile(args.profile, native_monthly=native_monthly,
                                gridded=gridded).items():
        if hasattr(args, k):
            setattr(args, k, v)


def validate_warm_time_args(
    ap: argparse.ArgumentParser,
    args: argparse.Namespace,
    resample_freq: tp.Optional[str] = None,
    prefit_dir: tp.Optional[str] = None,
) -> None:
    """Parse-time enforcement of the warm-time option contract.

    Mirrors ``ops/gp.fit_gp_batch_dispatch``'s runtime checks so mistyped
    options fail before any data loads.  ``resample_freq`` (the resolved
    frequency string, ``None``/'none' = native monthly) triggers the
    at-resampled-resolution note; ``prefit_dir`` rejects the stride
    outright: prefit checkpoints fix the fit, so the option would be
    ignored.
    """
    if args.time_stride < 1:
        ap.error(f"--time-stride must be >= 1, got {args.time_stride}")
    if args.time_stride > 1 and args.fine_steps is None:
        ap.error("--time-stride > 1 requires --fine-steps")
    if args.fine_steps is not None and args.time_stride == 1:
        ap.error("--fine-steps only applies with --time-stride > 1")
    if args.time_stride > 1 and prefit_dir:
        ap.error(
            "--time-stride applies to fresh fits only; --prefit-dir "
            "checkpoints fix the fit, so the option would be silently "
            "ignored"
        )
    if (
        args.time_stride > 1
        and resample_freq is not None
        and str(resample_freq).lower() != "none"
        # The fast profile's annual schedule is a stride-12 warm fit.
        and getattr(args, "profile", "faithful") == "faithful"
    ):
        print(
            "note: --time-stride targets the native monthly path; at "
            "resampled resolution the scratch fit is already short",
            file=sys.stderr,
        )
