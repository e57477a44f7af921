"""Quickstart: the full ensembling pipeline on synthetic data, on the port.

The port's copy of ``examples/quickstart.py``: five synthetic models and
pseudo-observations, ``GPDTW1D`` emulation, CRPS weights, the W2
barycentre and its scores.  Swap the synthetic collection for
``pipeline.load_scenario(...)`` to use the real CMIP6/HadCRUT5 GMST data.

    python -m bayesian_ensembling_tpu_torch.examples.quickstart [--device cpu]
"""

import numpy as np

import bayesian_ensembling_tpu_torch as bt
from bayesian_ensembling_tpu_torch.examples import parse_args


def synthetic_model(rng, name, n_reals, n_months=120, offset=0.0):
    time = (np.datetime64("1961-01", "M") + np.arange(n_months)).astype("datetime64[ns]")
    trend = np.linspace(0.0, 1.5, n_months)
    seasonal = 0.4 * np.sin(2 * np.pi * (np.arange(n_months) % 12) / 12)
    vals = trend + seasonal + offset + 0.15 * rng.normal(size=(n_reals, n_months))
    da = bt.DimArray(vals, ("realisation", "time"), {"time": time}, name="tas")
    return bt.ProcessModel(da, name)


def main(argv=None):
    """Run the example; returns the time-mean weights, the final year's
    barycentre mean and standard deviation, and the NLL and RMSE."""
    args = parse_args(argv, __doc__)
    rng = np.random.default_rng(0)

    # 1. Wrap simulation output; compute anomalies vs a monthly climatology.
    models = [synthetic_model(rng, f"model{i}", n_reals=3 + i, offset=0.1 * i) for i in range(5)]
    collection = bt.ModelCollection(
        [m.calculate_anomaly(("1961-01-01", "1970-12-31"), resample_freq="Y") for m in models]
    )
    obs = synthetic_model(rng, "obs", n_reals=8).calculate_anomaly(
        ("1961-01-01", "1970-12-31"), resample_freq="Y"
    )

    # 2. Emulate every model (one batched fit).
    collection.fit(bt.GPDTW1D(dtype=args.torch_dtype), n_optim_nits=200, device=args.device)

    # 3. Weight against observations.
    weights = bt.CRPSWeight()(collection, obs)
    w_mean = [float(w) for w in np.asarray(weights.mean("time").values)]
    print("weights (time-mean):")
    for name, w in zip(collection.model_names, w_mean):
        print(f"  {name}: {w:.3f}")

    # 4. Combine with the Wasserstein-2 barycentre (sigma_mode="mixture" or
    #    "compat" for the other variances).
    posterior = bt.Barycentre()(collection, weights)
    mean = float(np.asarray(posterior.mean.values)[-1])
    sd = float(np.asarray(posterior.stddev.values)[-1])
    print(f"\nensemble mean at final year: {mean:.3f} "
          f"(+-2sd {mean - 2 * sd:.3f}..{mean + 2 * sd:.3f})")

    # 5. Validate with metrics.
    nll = bt.metrics.nll(posterior, obs.data.values)
    rmse = bt.metrics.rmse(posterior, obs.data.values)
    print(f"NLL vs obs: {nll:.3f}")
    print(f"RMSE vs obs: {rmse:.3f}")
    return {"weights": w_mean, "mean": mean, "sd": sd, "nll": nll, "rmse": rmse}


if __name__ == "__main__":
    main()
