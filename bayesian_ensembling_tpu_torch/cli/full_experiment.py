"""Full GMST experiment: all 7 SSP scenarios, warming projections + figures,
on the port.

The port's copy of ``experiments/full_experiment.py``: loads HadCRUT5 and
CMIP6 GMST members, anomalises them (1961-1990, annual), fits ``GPDTW1D``
emulators (2,000 iterations), CRPS-weights them against the observations,
combines them with the W2 barycentre, prints the 2050 / 2100 credible
intervals and saves one figure per scenario (and the ssp245 / 370 / 585
headline figure).

Usage:
    python -m bayesian_ensembling_tpu_torch.cli.full_experiment [--data-dir DIR]
        [--out-dir DIR] [--n-optim-nits N] [--ssps ssp119,ssp245,...]
        [--resample-freq M|Q|Y|none] [--device cuda|cpu] [--cpu]

``--cpu`` runs the float64 path on the CPU, as the JAX script's flag does;
``--device cpu`` alone keeps float32.
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
    ap.add_argument("--out-dir", default="figures")
    ap.add_argument("--n-optim-nits", type=int, default=2000)
    ap.add_argument("--ssps", default=None, help="comma-separated subset")
    ap.add_argument("--resample-freq", default="Y",
                    help="calendar resample frequency (M/Q/Y; 'none' keeps the native "
                    "monthly resolution, the large-T path)")
    ap.add_argument("--sigma-mode", choices=["w2", "compat", "mixture"], default="w2",
                    help="combined-sigma convention (schemes.Barycentre)")
    ap.add_argument("--fit-chunk-steps", type=int, default=None,
                    help="split the hyperparameter optimisation into host-level chunks of "
                    "this many steps (the same step sequence; each chunk ends with a "
                    "device synchronisation)")
    add_optimizer_arg(ap)
    add_warm_time_args(ap)
    add_profile_arg(ap)
    add_dba_args(ap)
    ap.add_argument("--refine-f64", action="store_true",
                    help="recompute the published posterior moments in float64 at the "
                    "float32-converged hyperparameters")
    ap.add_argument("--device", default="cuda", help="where to fit: 'cuda' (default) or 'cpu'")
    ap.add_argument("--cpu", action="store_true", help="run the float64 path on the CPU")
    return ap


def main(argv=None):
    """Run the experiment; returns ``{ssp: ScenarioResult}``."""
    ap = build_parser()
    args = ap.parse_args(argv)
    apply_profile(ap, args, resample_freq=args.resample_freq)
    validate_warm_time_args(ap, args, resample_freq=args.resample_freq)

    import matplotlib.pyplot as plt
    import torch

    from bayesian_ensembling_tpu_torch import pipeline
    from bayesian_ensembling_tpu_torch.models.gp_dtw import GPDTW1D
    from bayesian_ensembling_tpu_torch.plotters import cmap, plot_posterior_temporal

    device = "cpu" if args.cpu else args.device
    dtype = torch.float64 if args.cpu else torch.float32
    data_dir = args.data_dir or pipeline.default_data_dir()
    ssps = args.ssps.split(",") if args.ssps else list(pipeline.ALL_SSPS)
    os.makedirs(args.out_dir, exist_ok=True)

    freq = None if args.resample_freq.lower() == "none" else args.resample_freq
    obs = pipeline.load_observations(data_dir, resample_freq=freq)
    results = {}
    for ssp in ssps:
        hist, ssp_mc = pipeline.load_scenario(ssp, data_dir, resample_freq=freq)
        t0 = time.time()
        res = pipeline.run_scenario(
            hist, ssp_mc, obs, ssp,
            emulator=GPDTW1D(dtype=dtype),
            n_optim_nits=args.n_optim_nits,
            dba_iterations=args.dba_iterations,
            dba_method=args.dba_method,
            dba_tol=args.dba_tol,
            sigma_mode=args.sigma_mode,
            fit_chunk_steps=args.fit_chunk_steps,
            time_stride=args.time_stride,
            fine_steps=args.fine_steps,
            optimizer=args.optimizer,
            refine_f64=args.refine_f64,
            device=device,
        )
        results[ssp] = res
        for year, (mean, lo, hi) in pipeline.warming_summary(res).items():
            print(f"{ssp} mean at {year}: {mean:.3f} ({lo:.3f}-{hi:.3f}) 95% credible interval")
        print(f"{ssp}: {time.time() - t0:.1f}s", flush=True)

        fig, ax = plt.subplots(figsize=(6.5, 4))
        plot_posterior_temporal(res.barycentre, ax=ax, color=cmap()[0], label=ssp, n_sigma=(2,))
        ax.set_xlabel("Time")
        ax.set_ylabel("Temperature anomaly (degC)\nrelative to 1961-1990")
        ax.legend()
        fig.savefig(os.path.join(args.out_dir, f"{ssp}_with_95percent_credible_interval.pdf"))
        plt.close(fig)

    # The headline figure (ssp245 / 370 / 585, as the reference's figure 1).
    head = [s for s in ("ssp245", "ssp370", "ssp585") if s in results]
    if head:
        fig, ax = plt.subplots(figsize=(6.5, 4))
        for i, ssp in enumerate(head):
            plot_posterior_temporal(results[ssp].barycentre, ax=ax, color=cmap()[i], label=ssp,
                                    n_sigma=(2,))
        ax.set_xlabel("Time")
        ax.set_ylabel("Temperature anomaly (degC)\nrelative to 1961-1990")
        ax.legend()
        fig.savefig(os.path.join(args.out_dir, "figure1_with_95percent_credible_interval.pdf"))
        plt.close(fig)
    return results


if __name__ == "__main__":
    main()
