"""Native-monthly (large-T) pipeline with the coarse-to-fine-in-time fit,
on the port.

The port's copy of ``examples/monthly_warm.py``: the synthetic data stays
at its native monthly resolution (T = 240, past the kernels' T cap, so the
fit takes the route ``linalg_path`` picks) and is fitted with
``time_stride`` / ``fine_steps``: 150 coarse steps on every 12th month,
then 30 warm-started steps at full T.

    python -m bayesian_ensembling_tpu_torch.examples.monthly_warm [--device cpu]
"""

import numpy as np

import bayesian_ensembling_tpu_torch as bt
from bayesian_ensembling_tpu_torch.examples import parse_args


def synthetic_model(rng, name, n_reals, n_months=240, offset=0.0):
    time = (np.datetime64("1961-01", "M") + np.arange(n_months)).astype("datetime64[ns]")
    trend = np.linspace(0.0, 1.5, n_months)
    seasonal = 0.4 * np.sin(2 * np.pi * (np.arange(n_months) % 12) / 12)
    vals = trend + seasonal + offset + 0.15 * rng.normal(size=(n_reals, n_months))
    da = bt.DimArray(vals, ("realisation", "time"), {"time": time}, name="tas")
    return bt.ProcessModel(da, name)


def main(argv=None):
    """Run the example; returns the final month's barycentre mean and
    standard deviation and the NLL."""
    args = parse_args(argv, __doc__)
    rng = np.random.default_rng(0)

    # 1. Native monthly anomalies: no resample_freq, so T stays at 240.
    models = [synthetic_model(rng, f"model{i}", n_reals=3, offset=0.1 * i) for i in range(4)]
    collection = bt.ModelCollection(
        [m.calculate_anomaly(("1961-01-01", "1970-12-31")) for m in models]
    )
    obs = synthetic_model(rng, "obs", n_reals=6).calculate_anomaly(("1961-01-01", "1970-12-31"))

    # 2. Coarse-to-fine in time: 150 coarse steps, then 30 at full T.
    collection.fit(bt.GPDTW1D(dtype=args.torch_dtype), n_optim_nits=150, time_stride=12,
                   fine_steps=30, device=args.device)

    # 3-4. Weight and combine exactly as at annual resolution.
    weights = bt.CRPSWeight()(collection, obs)
    posterior = bt.Barycentre()(collection, weights, sigma_mode="mixture")
    mean = float(np.asarray(posterior.mean.values)[-1])
    sd = float(np.asarray(posterior.stddev.values)[-1])
    print(f"monthly ensemble mean at final month: {mean:.3f} "
          f"(+-2sd {mean - 2 * sd:.3f}..{mean + 2 * sd:.3f})")
    nll = bt.metrics.nll(posterior, obs.data.values)
    print(f"NLL vs obs: {nll:.3f}")
    return {"mean": mean, "sd": sd, "nll": nll}


if __name__ == "__main__":
    main()
