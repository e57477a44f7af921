"""PyTorch port of bayesian_ensembling_tpu for one NVIDIA H100.

The JAX package ``bayesian_ensembling_tpu`` stays the reference; this
package mirrors its module paths and function names and imports nothing
from it (and no JAX).  Its hand-written CUDA kernels (``csrc/``) replace the
JAX package's Pallas TPU kernels on the main path; each has a plain PyTorch
version beside it, which runs when the tensors are on the CPU.

Main entry points: :func:`ensemble_multi_scenario_step` (the annual
7-SSP step; every DBA method, optimiser, fit route and weight kind of the
JAX step), :func:`run_dedup_campaign` (the native-monthly campaign, each
unique model fitted once) and :func:`refined_multi_scenario_f64` (the
float64 posterior and tail at given hyperparameters).
"""

from bayesian_ensembling_tpu_torch import _build
from bayesian_ensembling_tpu_torch.convert import gp_params_from_jax, gp_params_to_numpy
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
    tri_inv_batched,
)
from bayesian_ensembling_tpu_torch.parallel.campaign import (
    DedupCampaign,
    make_sharded_dedup_campaign,
    pack_dedup_campaign,
    pad_unique_axis,
    run_dedup_campaign,
)
from bayesian_ensembling_tpu_torch.parallel.step import (
    WEIGHT_KINDS,
    chunked_marginals,
    emulate_marginals,
    ensemble_multi_scenario_step,
    ensemble_scenario_step,
    fused_raw_weights,
    multi_scenario_tail,
    pad_models,
    refined_multi_scenario_f64,
)

__all__ = [
    "BatchedGPParams",
    "DedupCampaign",
    "WEIGHT_KINDS",
    "cholesky_batched",
    "cholesky_solve_fused",
    "chunked_marginals",
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
    "fused_raw_weights",
    "gp_params_from_jax",
    "gp_params_to_numpy",
    "init_params",
    "launch_counts",
    "linalg_path",
    "make_sharded_dedup_campaign",
    "multi_scenario_tail",
    "nlml_terms",
    "nlml_terms_blocked",
    "pack_dedup_campaign",
    "pad_models",
    "pad_unique_axis",
    "posterior_marginals_batch",
    "prepare_gp_inputs",
    "refined_multi_scenario_f64",
    "reset_launch_counts",
    "route_counts",
    "run_dedup_campaign",
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


def reset_launch_counts() -> None:
    """Set every kernel's launch count and every route count to 0."""
    for counter in (_build.LAUNCHES, _build.ROUTES):
        for name in counter:
            counter[name] = 0
