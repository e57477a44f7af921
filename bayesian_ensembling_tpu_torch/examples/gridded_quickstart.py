"""Gridded quickstart: per-cell emulation, weighting and barycentre, on the
port.

The port's copy of ``examples/gridded_quickstart.py``: three synthetic
models on a 4 x 6 lat/lon grid, every (model, cell) pair its own DBA +
heteroskedastic GP (``GPDTW3D``), weighted per point against gridded
pseudo-observations and combined with the per-cell W2 barycentre
(``pipeline.run_gridded_scenario``).  On several cards the same pipeline
shards over a ("model", "cells") mesh through
``parallel.gridded.make_sharded_gridded_step``.

    python -m bayesian_ensembling_tpu_torch.examples.gridded_quickstart [--device cpu]
"""

import numpy as np

import bayesian_ensembling_tpu_torch as bt
from bayesian_ensembling_tpu_torch.examples import parse_args
from bayesian_ensembling_tpu_torch.pipeline import run_gridded_scenario


def synthetic_gridded_model(rng, name, n_reals, lat, lon, n_years=30, warm=1.0):
    time = (np.datetime64("1991", "Y") + np.arange(n_years)).astype("datetime64[ns]")
    lats = np.linspace(-60, 60, lat)
    lons = np.linspace(0, 330, lon)
    trend = warm * np.linspace(0, 1, n_years)[None, :, None, None]
    pattern = np.cos(np.deg2rad(lats))[None, None, :, None]
    vals = trend * pattern + 0.2 * rng.normal(size=(n_reals, n_years, lat, lon))
    da = bt.DimArray(vals, ("realisation", "time", "latitude", "longitude"),
                     {"time": time, "latitude": lats, "longitude": lons}, name="tas")
    return bt.ProcessModel(da, name)


def main(argv=None):
    """Run the example; returns the final year's barycentre mean
    (lat x lon) and the mean weight per model."""
    args = parse_args(argv, __doc__)
    rng = np.random.default_rng(0)
    lat, lon = 4, 6
    models = [synthetic_gridded_model(rng, f"model{i}", n_reals=3, lat=lat, lon=lon, warm=w)
              for i, w in enumerate((0.8, 1.0, 1.2))]
    mc = bt.ModelCollection(models)
    obs = synthetic_gridded_model(rng, "obs", n_reals=5, lat=lat, lon=lon, warm=1.0)

    weights, bary = run_gridded_scenario(mc, obs, emulator=bt.GPDTW3D(dtype=args.torch_dtype),
                                         n_optim_nits=100, dba_iterations=3, device=args.device)
    print("weights dims:", weights.dims, weights.shape)
    mean = np.asarray(bary.gaussian.mean.detach().cpu()).reshape(-1, lat, lon)
    print("barycentre mean, final year (lat x lon):")
    print(np.array2string(mean[-1], precision=2))
    if not np.isfinite(mean).all():
        raise RuntimeError("gridded_quickstart: the barycentre mean is not finite")
    # Model 1 (warm=1.0) matches the pseudo-obs best -> largest mean weight.
    w_by_model = np.asarray(weights.values).reshape(len(mc), -1).mean(axis=1)
    print("mean weight per model:", np.round(w_by_model, 3))
    return {"mean_final": mean[-1], "weight_per_model": w_by_model}


if __name__ == "__main__":
    main()
