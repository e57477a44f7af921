"""PyTorch port of bayesian_ensembling_tpu for one NVIDIA H100.

The JAX package ``bayesian_ensembling_tpu`` stays the reference; this
package mirrors its module paths and function names and imports nothing
from it (and no JAX).  Its hand-written CUDA kernels (``csrc/``) replace the
JAX package's Pallas TPU kernels on the main path; each has a plain PyTorch
version beside it, which runs when the tensors are on the CPU.

Main entry points: the library API, ``ModelCollection([...]).fit(GPDTW1D())``
-> a weighter -> ``Barycentre()``, and its one-call form
:func:`pipeline.run_scenario`, fed by the netCDF loaders
``pipeline.load_observations`` / ``load_scenario``; its gridded counterpart,
``GPDTW3D`` and :func:`pipeline.run_gridded_scenario`, with the fused
:func:`gridded_ensemble_step` (every (model, cell) fit in one batch);
:func:`ensemble_multi_scenario_step` (the
annual 7-SSP step; every DBA method, optimiser, fit route and weight kind
of the JAX step), :func:`run_dedup_campaign` (the native-monthly campaign,
each unique model fitted once) and :func:`refined_multi_scenario_f64` (the
float64 posterior and tail at given hyperparameters); the perfect-model
test, :class:`PerfectModelTest` and :func:`batched_pmt`; the serving
layer, ``serve.ProjectionService`` with ``serve.build_artifacts``; and the
sharded surfaces on a ``torch.distributed`` device mesh,
:func:`make_sharded_step`, :func:`make_sharded_multi_scenario_step`,
:func:`make_sharded_dedup_campaign`, :func:`sharded_gridded_marginals` and
:func:`make_sharded_gridded_step` (``parallel/mesh.py``).
"""

from bayesian_ensembling_tpu_torch import _build, metrics, ops, parallel, pipeline
from bayesian_ensembling_tpu_torch.convert import (
    collection_from_jax,
    gp_params_from_jax,
    gp_params_to_numpy,
    posterior_from_jax,
)
from bayesian_ensembling_tpu_torch.coords import DimArray
from bayesian_ensembling_tpu_torch.data import ModelCollection, Posterior, ProcessModel
from bayesian_ensembling_tpu_torch.models.gp_3d import GPDTW3D
from bayesian_ensembling_tpu_torch.models.gp_dtw import (
    GPDTW1D,
    emulate_batch,
    emulate_batch_chunked,
    refine_posterior_f64,
)
from bayesian_ensembling_tpu_torch.models.mean_field import MeanField, MeanFieldApproximation
from bayesian_ensembling_tpu_torch.ops.dtw import (
    dba,
    dba_batch,
    dba_subgradient_batch,
    dtw_pairwise_sq,
    squared_dtw,
)
from bayesian_ensembling_tpu_torch.ops.dtw_cuda import dba_update_batch, squared_dtw_cost_batch
from bayesian_ensembling_tpu_torch.ops.gp import (
    BatchedGPParams,
    GPParams,
    fit_gp_batch,
    fit_gp_batch_chunked,
    fit_gp_batch_dispatch,
    fit_gp_batch_warm_time,
    init_params,
    posterior_marginals_batch,
    prepare_gp_inputs,
)
from bayesian_ensembling_tpu_torch.ops.linalg_blocked import nlml_terms_blocked
from bayesian_ensembling_tpu_torch.ops.linalg_cuda import (
    cholesky_batched,
    cholesky_solve_fused,
    linalg_path,
    nlml_terms,
    solve_vec_batched,
    tri_inv_batched,
)
from bayesian_ensembling_tpu_torch.parallel.campaign import (
    DedupCampaign,
    make_sharded_dedup_campaign,
    pack_dedup_campaign,
    pad_unique_axis,
    run_dedup_campaign,
)
from bayesian_ensembling_tpu_torch.parallel.gridded import (
    coarse_fit_params,
    coarse_warm_start,
    gridded_ensemble_step,
    gridded_tail,
    make_sharded_gridded_step,
    pad_cells,
    refined_gridded_f64,
    sharded_gridded_marginals,
)
from bayesian_ensembling_tpu_torch.parallel.mesh import collective_counts
from bayesian_ensembling_tpu_torch.parallel.step import (
    WEIGHT_KINDS,
    chunked_marginals,
    emulate_marginals,
    ensemble_multi_scenario_step,
    ensemble_scenario_step,
    fused_raw_weights,
    make_sharded_multi_scenario_step,
    make_sharded_step,
    multi_scenario_tail,
    pad_models,
    refined_multi_scenario_f64,
)
from bayesian_ensembling_tpu_torch.pipeline import (
    ScenarioResult,
    run_gridded_scenario,
    run_scenario,
)
from bayesian_ensembling_tpu_torch.schemes import Barycentre, MultiModelMean, WeightedModelMean
from bayesian_ensembling_tpu_torch.weights import (
    AbstractWeight,
    CRPSWeight,
    InverseSquareWeight,
    KSDWeight,
    LogLikelihoodWeight,
    ModelSimilarityWeight,
    UniformWeight,
)
from bayesian_ensembling_tpu_torch.validation import (
    PerfectModelTest,
    batched_pmt,
    load_model_collection,
)

__version__ = "0.1.0"


def __getattr__(name: str):
    # ``plotters`` draws with matplotlib and ``serve`` is an entry point of
    # its own: both load on first use, so the core package imports in an
    # install without matplotlib, pandas or h5py.
    if name in ("plotters", "serve"):
        import importlib

        module = importlib.import_module(f"bayesian_ensembling_tpu_torch.{name}")
        globals()[name] = module
        return module
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = [
    "ops",
    "metrics",
    "pipeline",
    # "plotters" is not in __all__: it loads on first use (module
    # __getattr__), and `import *` must work without matplotlib.
    "serve",
    "PerfectModelTest",
    "batched_pmt",
    "AbstractWeight",
    "Barycentre",
    "CRPSWeight",
    "DimArray",
    "GPDTW1D",
    "GPDTW3D",
    "InverseSquareWeight",
    "KSDWeight",
    "LogLikelihoodWeight",
    "MeanField",
    "MeanFieldApproximation",
    "ModelCollection",
    "ModelSimilarityWeight",
    "MultiModelMean",
    "Posterior",
    "ProcessModel",
    "ScenarioResult",
    "UniformWeight",
    "WeightedModelMean",
    "collection_from_jax",
    "emulate_batch",
    "emulate_batch_chunked",
    "posterior_from_jax",
    "refine_posterior_f64",
    "load_model_collection",
    "run_gridded_scenario",
    "run_scenario",
    "solve_vec_batched",
    "__version__",
    "BatchedGPParams",
    "DedupCampaign",
    "GPParams",
    "WEIGHT_KINDS",
    "cholesky_batched",
    "cholesky_solve_fused",
    "chunked_marginals",
    "coarse_fit_params",
    "coarse_warm_start",
    "collective_counts",
    "dba",
    "dba_batch",
    "dba_subgradient_batch",
    "dba_update_batch",
    "dtw_pairwise_sq",
    "emulate_marginals",
    "ensemble_multi_scenario_step",
    "ensemble_scenario_step",
    "fit_gp_batch",
    "fit_gp_batch_chunked",
    "fit_gp_batch_dispatch",
    "fit_gp_batch_warm_time",
    "fit_replay_counts",
    "fit_step_counts",
    "fused_raw_weights",
    "gp_params_from_jax",
    "gp_params_to_numpy",
    "gridded_ensemble_step",
    "gridded_tail",
    "init_params",
    "launch_counts",
    "linalg_path",
    "make_sharded_dedup_campaign",
    "make_sharded_gridded_step",
    "make_sharded_multi_scenario_step",
    "make_sharded_step",
    "multi_scenario_tail",
    "nlml_terms",
    "nlml_terms_blocked",
    "pack_dedup_campaign",
    "pad_cells",
    "pad_models",
    "pad_unique_axis",
    "posterior_marginals_batch",
    "prepare_gp_inputs",
    "refined_gridded_f64",
    "refined_multi_scenario_f64",
    "reset_launch_counts",
    "route_counts",
    "run_dedup_campaign",
    "sharded_gridded_marginals",
    "squared_dtw",
    "squared_dtw_cost_batch",
    "tri_inv_batched",
]


def launch_counts() -> dict[str, int]:
    """Kernel launches since the last reset, by kernel name."""
    return dict(_build.LAUNCHES)


def route_counts() -> dict[str, int]:
    """Batched-linalg calls since the last reset, by the route they took."""
    return dict(_build.ROUTES)


def fit_step_counts() -> dict[str, int]:
    """Optimiser steps of the batched GP fit since the last reset, by
    optimiser (each fit segment adds its step count once)."""
    return dict(ops.gp.FIT_STEPS)


def fit_replay_counts() -> dict[str, int]:
    """Of those steps, the ones that ran as replays of a captured CUDA
    graph, by optimiser (Adam on a card, past each segment's first
    ``ops.gp.GRAPH_WARMUP_STEPS``)."""
    return dict(ops.gp.FIT_REPLAYS)


def reset_launch_counts() -> None:
    """Set every kernel's launch count, every route count, every collective
    count (:func:`collective_counts`), every optimiser-step count
    (:func:`fit_step_counts`) and every replay count
    (:func:`fit_replay_counts`) to 0."""
    for counter in (_build.LAUNCHES, _build.ROUTES, parallel.mesh.COLLECTIVES, ops.gp.FIT_STEPS,
                    ops.gp.FIT_REPLAYS):
        for name in counter:
            counter[name] = 0
