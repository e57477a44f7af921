"""Gridded float64 refinement: float32 fits, float64 published moments, on
the port.

The port's copy of ``examples/gridded_refined.py``:

1. fit the gridded step in float32, returning the converged
   hyperparameters and DBA targets (``gridded_ensemble_step(return_fit=True)``);
2. refine: re-run only the per-cell posterior solves and the weighting /
   barycentre tail in float64 at those hyperparameters
   (``parallel.gridded.refined_gridded_f64``, in cell chunks of 3);
3. show that the two agree to the float32 solve scatter; the refined
   moments are what ``run_gridded_scenario(refine_f64=True)`` and
   ``serve build-gridded --refine-f64`` publish.

    python -m bayesian_ensembling_tpu_torch.examples.gridded_refined [--device cpu]

``--dtype float64`` runs step 1 in float64 too.
"""

import numpy as np
import torch

from bayesian_ensembling_tpu_torch.examples import parse_args
from bayesian_ensembling_tpu_torch.parallel.gridded import (
    gridded_ensemble_step,
    refined_gridded_f64,
)


def main(argv=None):
    """Run the example; returns the fit's and the refined barycentre means
    and the drift between them."""
    args = parse_args(argv, __doc__)
    rng = np.random.default_rng(0)
    m, c, r, t = 3, 8, 4, 24
    signal = np.sin(np.linspace(0, 3, t)).astype(np.float32)
    block = (signal + 0.3 * rng.normal(size=(m, c, r, t))).astype(np.float32)
    obs = (signal + 0.3 * rng.normal(size=(c, r, t))).astype(np.float32)
    mask = np.ones((m, c, r), bool)

    # 1) The fit and ensemble, returning the refinement's inputs.
    dev = torch.device(args.device)
    bm32, bs32, w, params, y_mean, y_var = gridded_ensemble_step(
        torch.as_tensor(block, dtype=args.torch_dtype, device=dev),
        torch.as_tensor(obs, dtype=args.torch_dtype, device=dev),
        torch.as_tensor(mask, device=dev), n_optim_nits=60, return_fit=True)

    # 2) The float64 refinement at the converged hyperparameters (chunked).
    bm64, bs64, w64 = refined_gridded_f64(block, obs, mask, params, (y_mean, y_var),
                                          cell_chunk=3, device=dev)

    fit_mean = bm32.detach().cpu().double().numpy()
    drift = float(np.abs(fit_mean - bm64).max())
    print(f"refined moments dtype: {bm64.dtype}")
    print(f"f32->f64 moment drift removed: {drift:.2e}")
    if not (bm64.dtype == np.float64 and np.isfinite(bm64).all() and drift < 1e-3):
        raise RuntimeError(f"gridded_refined: refined moments {bm64.dtype}, drift {drift}")

    # 3) The library surface publishes exactly this via refine_f64=True.
    print("refined barycentre mean, first cell:", np.array2string(bm64[0, :5], precision=4))
    return {"fit_mean": fit_mean, "refined_mean": bm64, "refined_std": bs64, "drift": drift}


if __name__ == "__main__":
    main()
