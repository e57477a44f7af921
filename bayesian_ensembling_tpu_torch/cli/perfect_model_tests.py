"""Perfect-model-test driver over SSPs x weighting schemes, on the port.

The port's copy of ``experiments/perfect_model_tests.py``: for each
requested scenario and weight class, the leave-one-out
``PerfectModelTest`` with the barycentre scheme, writing CSVs and
figures.  Unlike the JAX script, the data directory is resolved only when
a scenario is loaded from netCDF: ``--prefit-dir`` checkpoints need none.

Usage:
    python -m bayesian_ensembling_tpu_torch.cli.perfect_model_tests [--data-dir DIR]
        [--out-dir DIR] [--ssps ssp370] [--weights CRPSWeight,LogLikelihoodWeight]
        [--n-optim-nits N] [--prefit-dir DIR] [--batched] [--device cuda|cpu]
"""

import argparse
import os

from bayesian_ensembling_tpu_torch.utils.cli import (
    add_dba_args,
    add_optimizer_arg,
    add_profile_arg,
    add_warm_time_args,
    apply_profile,
    validate_warm_time_args,
)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--data-dir", default=None)
    ap.add_argument("--out-dir", default="pmt_results")
    ap.add_argument("--ssps", default="ssp119,ssp126,ssp245,ssp370,ssp434,ssp460,ssp585")
    ap.add_argument("--weights",
                    default="LogLikelihoodWeight,InverseSquareWeight,UniformWeight,KSDWeight,"
                    "CRPSWeight")
    ap.add_argument("--n-optim-nits", type=int, default=1000)
    ap.add_argument("--prefit-dir", default=None, help="use checkpointed fits")
    ap.add_argument("--include-sim", action="store_true")
    ap.add_argument("--compat-fixed-point", action="store_true",
                    help="use the reference-faithful fixed-point barycentre sigma "
                    "(alias for --sigma-mode compat)")
    ap.add_argument("--sigma-mode", choices=["w2", "compat", "mixture"], default=None,
                    help="combined sigma: 'w2' closed-form barycentre (default), 'compat' "
                    "reference fixed point, 'mixture' moment-matched mixture variance")
    ap.add_argument("--batched", action="store_true",
                    help="all leave-one-out folds at once (prefit only; "
                    "validation.batched_pmt)")
    ap.add_argument("--figures", action="store_true",
                    help="with --batched: also draw the per-fold weight / projection figures")
    ap.add_argument("--resample-freq", default="Y",
                    help="calendar resample frequency for freshly loaded scenarios (M/Q/Y; "
                    "'none' = native monthly).  Ignored with --prefit-dir, whose "
                    "checkpoints fix the resolution.")
    add_optimizer_arg(ap)
    add_warm_time_args(ap)
    add_profile_arg(ap)
    add_dba_args(ap)
    ap.add_argument("--device", default="cuda",
                    help="where to fit and score: 'cuda' (default) or 'cpu'")
    return ap


def main(argv=None):
    """Run every (scenario, weighter) test; returns ``{(ssp, weighter):
    DataFrame}``."""
    ap = build_parser()
    args = ap.parse_args(argv)
    if args.profile != "faithful" and args.prefit_dir:
        ap.error("--profile applies to fresh fits only; --prefit-dir checkpoints fix the fit")
    apply_profile(ap, args, resample_freq=args.resample_freq)
    validate_warm_time_args(ap, args, resample_freq=args.resample_freq,
                            prefit_dir=args.prefit_dir)
    if args.batched and not args.prefit_dir:
        raise SystemExit("--batched requires --prefit-dir")
    if args.compat_fixed_point and args.sigma_mode not in (None, "compat"):
        ap.error(f"--compat-fixed-point conflicts with --sigma-mode {args.sigma_mode}")
    sigma_mode = "compat" if args.compat_fixed_point else (args.sigma_mode or "w2")

    import bayesian_ensembling_tpu_torch as bt
    from bayesian_ensembling_tpu_torch import pipeline
    from bayesian_ensembling_tpu_torch.models.gp_dtw import GPDTW1D
    from bayesian_ensembling_tpu_torch.validation import PerfectModelTest, load_model_collection

    ssps = args.ssps.split(",")
    collections = {}
    for ssp in ssps:
        if args.prefit_dir:
            hist = load_model_collection(os.path.join(args.prefit_dir, f"hist_{ssp}.npz"),
                                         device=args.device)
            fore = load_model_collection(os.path.join(args.prefit_dir, f"{ssp}.npz"),
                                         device=args.device)
            use_prefit = True
        else:
            # Only the netCDF branch needs the data directory.
            data_dir = args.data_dir or pipeline.default_data_dir()
            freq = None if args.resample_freq.lower() == "none" else args.resample_freq
            hist, fore = pipeline.load_scenario(ssp, data_dir, resample_freq=freq)
            use_prefit = False
        collections[ssp] = (hist, fore, use_prefit)

    # One shape bucket for the campaign (validation.batched_pmt pad_shape).
    pad_shape = None
    if args.batched and len(collections) > 1:
        pad_m = max(len(h) for h, _, _ in collections.values())
        pad_r = max(max(pm.n_realisations for pm in mc)
                    for h, f, _ in collections.values() for mc in (h, f))
        pad_shape = (pad_m, pad_r)
        print(f"shape bucket: pad_m={pad_m}, pad_r={pad_r}", flush=True)

    frames = {}
    for ssp in ssps:
        hist, fore, use_prefit = collections[ssp]
        for wname in args.weights.split(","):
            pmt = PerfectModelTest(
                hindcast_models=hist,
                forecast_models=fore,
                emulate_method=GPDTW1D,
                weight_method=getattr(bt, wname),
                ensemble_method=bt.Barycentre,
                ssp=ssp,
                include_sim=args.include_sim,
                save_dir=os.path.join(args.out_dir, ssp),
                scheme_kwargs={"sigma_mode": sigma_mode},
            )
            if args.batched:
                df = pmt.run_batched(pad_shape=pad_shape, figures=args.figures)
            else:
                df = pmt.run(
                    n_optim_nits=args.n_optim_nits,
                    use_prefit_models=use_prefit,
                    time_stride=args.time_stride,
                    fine_steps=args.fine_steps,
                    optimizer=args.optimizer,
                    dba_iterations=args.dba_iterations,
                    dba_method=args.dba_method,
                    dba_tol=args.dba_tol,
                    device=args.device,
                )
            frames[ssp, wname] = df
            print(f"{ssp} / {wname}:\n{df.describe().loc[['mean']]}", flush=True)
    return frames


if __name__ == "__main__":
    main()
