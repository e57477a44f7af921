"""PyTorch port of bayesian_ensembling_tpu for one NVIDIA H100.

The JAX package ``bayesian_ensembling_tpu`` stays the reference; this
package mirrors its module paths and function names and imports nothing
from it (and no JAX).  Its hand-written CUDA kernels (``csrc/``) replace the
JAX package's Pallas TPU kernels on the main path; each has a plain PyTorch
version beside it, which runs when the tensors are on the CPU.

Main entry point: :func:`ensemble_multi_scenario_step`.
"""

from bayesian_ensembling_tpu_torch import _build
from bayesian_ensembling_tpu_torch.convert import gp_params_from_jax, gp_params_to_numpy
from bayesian_ensembling_tpu_torch.ops.dtw import dba_batch
from bayesian_ensembling_tpu_torch.ops.dtw_cuda import dba_update_batch
from bayesian_ensembling_tpu_torch.ops.gp import (
    BatchedGPParams,
    fit_gp_batch,
    init_params,
    posterior_marginals_batch,
    prepare_gp_inputs,
)
from bayesian_ensembling_tpu_torch.ops.linalg_cuda import (
    cholesky_solve_fused,
    nlml_terms,
    tri_inv_batched,
)
from bayesian_ensembling_tpu_torch.parallel.step import (
    emulate_marginals,
    ensemble_multi_scenario_step,
    ensemble_scenario_step,
    multi_scenario_tail,
    pad_models,
)

__all__ = [
    "BatchedGPParams",
    "cholesky_solve_fused",
    "dba_batch",
    "dba_update_batch",
    "emulate_marginals",
    "ensemble_multi_scenario_step",
    "ensemble_scenario_step",
    "fit_gp_batch",
    "gp_params_from_jax",
    "gp_params_to_numpy",
    "init_params",
    "launch_counts",
    "multi_scenario_tail",
    "nlml_terms",
    "pad_models",
    "posterior_marginals_batch",
    "prepare_gp_inputs",
    "reset_launch_counts",
    "tri_inv_batched",
]


def launch_counts() -> dict[str, int]:
    """Kernel launches since the last reset, by kernel name."""
    return dict(_build.LAUNCHES)


def reset_launch_counts() -> None:
    """Set every kernel's launch count to 0."""
    for name in _build.LAUNCHES:
        _build.LAUNCHES[name] = 0
