"""The port's sharded gridded surface (``parallel/gridded.py`` on
``parallel/mesh.py``) on 2 and 4 gloo ranks on the CPU, in float64:
``sharded_gridded_marginals`` over ``"cells"`` with and without ``gp_init``,
``make_sharded_gridded_step`` on a cells-only ``(model 1, cells n)`` mesh and
on a ``(model 2, cells n/2)`` mesh, with and without ``gp_init``, and
``coarse_warm_start(mesh=...)``; each held against the JAX package's sharded
function on a mesh of the same shape and against the port's unsharded one.

One spawn a world size (a module fixture) computes every case; the ranks
import no JAX.  Tolerance 1e-8 on moments, weights and hyperparameters.
"""

import concurrent.futures
import numpy as np
import pytest
import torch

from bayesian_ensembling_tpu_torch.ops import gp as tgp
from bayesian_ensembling_tpu_torch.parallel import gridded as tgridded
from bayesian_ensembling_tpu_torch import reset_launch_counts
from bayesian_ensembling_tpu_torch.parallel import mesh as tmesh

TOL = 1e-8
WORLDS = (2, 4)
M, LAT, LON, R, T, R_OBS = 4, 2, 4, 3, 12, 5
C = LAT * LON
FIT = dict(n_optim_nits=5, dba_iterations=2)
COARSE = dict(stride=2, n_models=3)  # 3 models x 2 coarse cells: padded on 4 ranks
# ("marginals", with gp_init) | ("step", mesh, weight kind, sigma mode, with gp_init)
CASES = (("marginals", False), ("marginals", True),
         ("step", "cells", "crps", "w2", False), ("step", "cells", "crps", "w2", True),
         ("step", "mc", "crps", "w2", False), ("step", "mc", "crps", "w2", True),
         ("step", "mc", "loglik", "mixture", False), ("step", "mc", "similarity_single", "w2", False),
         ("coarse",))


def make_inputs(seed=0):
    """The gridded bench's workload in miniature (a shared signal plus noise
    per model, cell and realisation; one masked realisation slot), a padded
    model and a warm start near the fitted values."""
    rng = np.random.default_rng(seed)
    signal = np.sin(np.linspace(0.0, 3.0, T))
    block = signal + 0.3 * rng.normal(size=(M, C, R, T))
    obs = signal + 0.3 * rng.normal(size=(C, R_OBS, T))
    mask = np.ones((M, C, R), bool)
    mask[1, 0, 2] = False
    block[~mask] = 0.0
    model_mask = np.array([1.0, 1.0, 1.0, 0.0])
    init = (rng.normal(0.3, 0.2, (M, C)), rng.normal(-0.5, 0.2, (M, C)))
    return dict(block=block, obs=obs, mask=mask, model_mask=model_mask, init=init)


def _meshes(world):
    from torch.distributed.device_mesh import init_device_mesh

    return {"1d": init_device_mesh("cpu", (world,), mesh_dim_names=("cells",)),
            "cells": init_device_mesh("cpu", (1, world), mesh_dim_names=("model", "cells")),
            "mc": init_device_mesh("cpu", (2, world // 2), mesh_dim_names=("model", "cells"))}


def _params(init, ndim):
    ls, var = (torch.from_numpy(np.ascontiguousarray(a)) for a in init)
    if ndim == 1:
        ls, var = ls[0], var[0]
    return tgp.BatchedGPParams(ls, var)


def _port_sharded(case, meshes, x):
    if case[0] == "marginals":
        init = _params(x["init"], 1) if case[1] else None
        return tgridded.sharded_gridded_marginals(meshes["1d"], x["block"][0], x["mask"][0],
                                                  gp_init=init, **FIT)
    if case[0] == "coarse":
        n = COARSE["n_models"]
        params = tgridded.coarse_warm_start(torch.from_numpy(x["block"][:n]),
                                            torch.from_numpy(x["mask"][:n]), LAT, LON,
                                            COARSE["stride"], mesh=meshes["1d"], **FIT)
        return params.raw_lengthscale.detach(), params.raw_variance.detach()
    _, mesh, kind, sigma, with_init = case
    step = tgridded.make_sharded_gridded_step(meshes[mesh], weight_kind=kind, sigma_mode=sigma,
                                              with_gp_init=with_init, **FIT)
    args = (x["block"], x["obs"], x["mask"], x["model_mask"])
    return step(*args, _params(x["init"], 2)) if with_init else step(*args)


def _full(x):
    from torch.distributed.tensor import DTensor

    return (x.full_tensor() if isinstance(x, DTensor) else x).numpy()


def _rank_worker(rank, world, x):
    torch.set_num_threads(1)
    meshes = _meshes(world)
    out = {}
    for case in CASES:
        reset_launch_counts()
        got = _port_sharded(case, meshes, x)
        counts = tmesh.collective_counts()
        out[case] = dict(values=[_full(g) for g in got], counts=counts,
                         types=[type(g).__name__ for g in got])
    errors = {}
    step = tgridded.make_sharded_gridded_step(meshes["mc"], **FIT)
    for name, (m, c) in (("cells", (M, C - 1)), ("models", (M - 1, C))):
        try:
            step(x["block"][:m, :c], x["obs"][:c], x["mask"][:m, :c], x["model_mask"][:m])
        except ValueError as e:
            errors[name] = str(e)
    out["errors"] = errors
    return out


def _spawn_worlds(*args):
    """``_rank_worker`` on every world size, the spawns side by side; a
    world that has not finished in 300 s fails the tests."""
    with concurrent.futures.ThreadPoolExecutor(len(WORLDS)) as pool:
        runs = {w: pool.submit(tmesh.run_local, _rank_worker, w, *args) for w in WORLDS}
        return {w: run.result() for w, run in runs.items()}


@pytest.fixture(scope="module")
def inputs():
    return make_inputs()


@pytest.fixture(scope="module")
def sharded(inputs):
    return _spawn_worlds(inputs)


def _jax_sharded(case, world, x):
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from bayesian_ensembling_tpu.ops.gp import GPParams
    from bayesian_ensembling_tpu.parallel import gridded as jgridded

    devices = np.array(jax.devices()[:world])
    j = {k: jnp.asarray(v) for k, v in x.items() if k != "init"}
    init = GPParams(*(jnp.asarray(a) for a in x["init"]))
    if case[0] == "marginals":
        gp_init = GPParams(init.raw_lengthscale[0], init.raw_variance[0]) if case[1] else None
        return jgridded.sharded_gridded_marginals(Mesh(devices, ("cells",)), j["block"][0],
                                                  j["mask"][0], gp_init=gp_init, **FIT)
    if case[0] == "coarse":
        n = COARSE["n_models"]
        p = jgridded.coarse_warm_start(j["block"][:n], j["mask"][:n], LAT, LON, COARSE["stride"],
                                       mesh=Mesh(devices, ("cells",)), **FIT)
        return p.raw_lengthscale, p.raw_variance
    _, mesh, kind, sigma, with_init = case
    shape = (1, world) if mesh == "cells" else (2, world // 2)
    step = jgridded.make_sharded_gridded_step(Mesh(devices.reshape(shape), ("model", "cells")),
                                              weight_kind=kind, sigma_mode=sigma,
                                              with_gp_init=with_init, **FIT)
    args = (j["block"], j["obs"], j["mask"], j["model_mask"])
    return step(*args, init) if with_init else step(*args)


def _port_unsharded(case, x):
    t = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in x.items() if k != "init"}
    if case[0] == "marginals":
        init = _params(x["init"], 1) if case[1] else None
        return tgridded.emulate_marginals(t["block"][0], t["mask"][0], gp_init=init, **FIT)
    if case[0] == "coarse":
        n = COARSE["n_models"]
        p = tgridded.coarse_warm_start(t["block"][:n], t["mask"][:n], LAT, LON, COARSE["stride"],
                                       **FIT)
        return p.raw_lengthscale, p.raw_variance
    _, _, kind, sigma, with_init = case
    return tgridded.gridded_ensemble_step(
        t["block"], t["obs"], t["mask"], t["model_mask"], weight_kind=kind, sigma_mode=sigma,
        gp_init=_params(x["init"], 2) if with_init else None, **FIT)


def _ids(case):
    return "-".join(str(c) for c in case)


def _close(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        w = np.asarray(w.detach() if isinstance(w, torch.Tensor) else w)
        assert g.shape == w.shape, (g.shape, w.shape)
        np.testing.assert_allclose(g, w, rtol=0, atol=TOL)


@pytest.mark.parametrize("case", CASES, ids=_ids)
@pytest.mark.parametrize("world", WORLDS)
def test_sharded_gridded_matches_jax_sharded(sharded, inputs, world, case):
    _close(sharded[world][case]["values"], _jax_sharded(case, world, inputs))


@pytest.mark.parametrize("case", CASES, ids=_ids)
@pytest.mark.parametrize("world", WORLDS)
def test_sharded_gridded_matches_port_unsharded(sharded, inputs, world, case):
    _close(sharded[world][case]["values"], _port_unsharded(case, inputs))


@pytest.mark.parametrize("case", CASES, ids=_ids)
@pytest.mark.parametrize("world", WORLDS)
def test_gridded_collectives_and_outputs(sharded, world, case):
    """The cells are collective-free; the step issues the audit's three
    all-reduces on the model axis (gridded_2d_crps_w2 in
    benchmarks/collective_audit.json), a pmax more for loglik and three
    gathers more for the similarity kinds, once for all cells; the sharded
    coarse fit gathers its hyperparameters once."""
    res = sharded[world][case]
    if case[0] == "marginals":
        assert res["counts"] == {"all_reduce": 0, "all_gather": 0}
        assert res["types"] == ["DTensor", "DTensor"]
    elif case[0] == "coarse":
        assert res["counts"] == {"all_reduce": 0, "all_gather": 1}
        assert res["types"] == ["Tensor", "Tensor"]
    else:
        kind = case[2]
        assert res["counts"] == {"all_reduce": 3 + (kind == "loglik"),
                                 "all_gather": 3 * kind.startswith("similarity")}
        assert res["types"] == ["DTensor", "DTensor", "DTensor"]


@pytest.mark.parametrize("world", WORLDS)
def test_undivided_axes_raise_naming_the_padding(sharded, world):
    errors = sharded[world]["errors"]
    if world == 2:  # (model 2, cells 1): every cell count divides
        assert "cells" not in errors
    else:
        assert "pad_cells" in errors["cells"]
    assert "pad_models" in errors["models"]


def test_gridded_model_axis_without_a_mesh_raises():
    x = make_inputs(1)
    t = [torch.from_numpy(x[k]) for k in ("block", "obs", "mask")]
    with pytest.raises(NameError, match="no mesh is current"):
        tgridded.gridded_ensemble_step(*t, model_axis="model", **FIT)
    mean = torch.zeros(M, C, T, dtype=torch.float64)
    for kind in ("crps", "loglik", "similarity"):
        with pytest.raises(NameError, match="unbound axis name"):
            tgridded.gridded_tail(mean, mean + 1, t[1], t[0], t[2], weight_kind=kind,
                                  model_axis="cells")
