"""Pre-fit emulators and checkpoint the collections, on the port.

The port's copy of ``experiments/pre_fit_models.py``: fits ``GPDTW1D`` on
the historical and SSP collections of each scenario and saves them as npz
archives (``ModelCollection.save``, the layout both packages read), so
that perfect-model tests can reuse the fits.

Usage:
    python -m bayesian_ensembling_tpu_torch.cli.pre_fit_models [--data-dir DIR]
        [--out-dir DIR] [--n-optim-nits N] [--ssps ssp119,...] [--device cuda|cpu]
"""

import argparse
import os
import time

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
    ap.add_argument("--out-dir", default="pre_fit_models")
    ap.add_argument("--n-optim-nits", type=int, default=2500)
    ap.add_argument("--ssps", default="ssp119,ssp126,ssp245,ssp370,ssp434,ssp460,ssp585")
    ap.add_argument("--resample-freq", default="Y",
                    help="calendar resample frequency (M/Q/Y; 'none' keeps the native "
                    "monthly resolution, the large-T path; as full_experiment)")
    ap.add_argument("--fit-chunk-steps", type=int, default=None,
                    help="split the hyperparameter optimisation into host-level chunks of "
                    "this many steps (the same step sequence)")
    add_optimizer_arg(ap)
    add_warm_time_args(ap)
    add_profile_arg(ap)
    add_dba_args(ap)
    ap.add_argument("--device", default="cuda", help="where to fit: 'cuda' (default) or 'cpu'")
    return ap


def main(argv=None):
    """Fit and save every scenario; returns the paths written."""
    ap = build_parser()
    args = ap.parse_args(argv)
    apply_profile(ap, args, resample_freq=args.resample_freq)
    validate_warm_time_args(ap, args, resample_freq=args.resample_freq)

    import torch

    from bayesian_ensembling_tpu_torch import pipeline
    from bayesian_ensembling_tpu_torch.models.gp_dtw import GPDTW1D

    data_dir = args.data_dir or pipeline.default_data_dir()
    os.makedirs(args.out_dir, exist_ok=True)
    freq = None if args.resample_freq.lower() == "none" else args.resample_freq
    written = []
    for ssp in args.ssps.split(","):
        hist, ssp_mc = pipeline.load_scenario(ssp, data_dir, resample_freq=freq)
        t0 = time.time()
        fit_kw = dict(
            n_optim_nits=args.n_optim_nits,
            dba_iterations=args.dba_iterations,
            dba_method=args.dba_method,
            dba_tol=args.dba_tol,
            fit_chunk_steps=args.fit_chunk_steps,
            time_stride=args.time_stride,
            fine_steps=args.fine_steps,
            optimizer=args.optimizer,
            device=args.device,
        )
        hist.fit(GPDTW1D(), **fit_kw)
        ssp_mc.fit(GPDTW1D(), **fit_kw)
        if torch.device(args.device).type == "cuda":
            torch.cuda.synchronize()  # the fit's time, not the save's
        print(f"{ssp}: fitted in {time.time() - t0:.1f}s", flush=True)
        for name, mc in ((f"hist_{ssp}.npz", hist), (f"{ssp}.npz", ssp_mc)):
            path = os.path.join(args.out_dir, name)
            mc.save(path)
            written.append(path)
        print(f"{ssp}: saved", flush=True)
    return written


if __name__ == "__main__":
    main()
