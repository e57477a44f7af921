"""The ensemble step over a batch of scenarios and models, the dedup
campaign and the gridded step, each also sharded over a device mesh."""

from bayesian_ensembling_tpu_torch.parallel.mesh import (
    collective_counts,
    run_local,
    shard_map,
    use_mesh,
)
from bayesian_ensembling_tpu_torch.parallel.campaign import make_sharded_dedup_campaign
from bayesian_ensembling_tpu_torch.parallel.gridded import (
    coarse_fit_params,
    coarse_warm_start,
    make_sharded_gridded_step,
    sharded_gridded_marginals,
)
from bayesian_ensembling_tpu_torch.parallel.step import (
    make_sharded_multi_scenario_step,
    make_sharded_step,
)

__all__ = [
    "coarse_fit_params",
    "coarse_warm_start",
    "collective_counts",
    "make_sharded_dedup_campaign",
    "make_sharded_gridded_step",
    "make_sharded_multi_scenario_step",
    "make_sharded_step",
    "run_local",
    "shard_map",
    "sharded_gridded_marginals",
    "use_mesh",
]
