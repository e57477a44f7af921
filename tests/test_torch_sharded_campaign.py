"""The port's sharded dedup campaign (``parallel/campaign.py``
``make_sharded_dedup_campaign``) on 2 and 4 gloo ranks on the CPU, in
float64: the unique-fit axes padded with ``pad_unique_axis`` as
tests/test_campaign_sharded.py pads them, held against the JAX package's
sharded campaign on meshes of the same shape and against the port's
unsharded ``run_dedup_campaign``.

One spawn a world size (a module fixture) computes every case; the ranks
import no JAX.  Tolerance 1e-8 on moments and weights.
"""

import concurrent.futures
import numpy as np
import pytest
import torch

from bayesian_ensembling_tpu_torch.coords import DimArray
from bayesian_ensembling_tpu_torch.data import ModelCollection, ProcessModel
from bayesian_ensembling_tpu_torch.parallel import campaign as tcampaign
from bayesian_ensembling_tpu_torch import reset_launch_counts
from bayesian_ensembling_tpu_torch.parallel import mesh as tmesh

TOL = 1e-8
WORLDS = (2, 4)
T_H, T_S, R, R_OBS = 24, 12, 3, 5
FIT = dict(n_optim_nits=5, dba_iterations=2)
# (weight kind, sigma mode, the port's hist_chunk)
CASES = (("crps", "w2", None), ("loglik", "w2", None), ("similarity", "mixture", None),
         ("crps", "w2", 2))
FIELDS = ("hb", "hm", "sb", "sm", "mmask", "uh", "um", "usb", "usm")


def make_pack(seed=0):
    """Three scenarios over five historical models (a-e), each scenario
    three of them, as the JAX package's sharded-campaign test; ragged
    realisation counts; the float fields in float64."""
    rng = np.random.default_rng(seed)
    time_h = (np.datetime64("2000-01", "M") + np.arange(T_H)).astype("datetime64[ns]")
    time_s = (np.datetime64("2010-01", "M") + np.arange(T_S)).astype("datetime64[ns]")
    n_real = {"a": 2, "b": R, "c": 2, "d": R, "e": R}

    def pm(name, t, time):
        vals = np.cumsum(rng.normal(size=(n_real[name], t)), axis=-1) * 0.3
        return ProcessModel(DimArray(vals, ("realisation", "time"), {"time": time}, name="tas"), name)

    pool = {n: pm(n, T_H, time_h) for n in n_real}
    scen = []
    for si, names in enumerate((("a", "b", "c"), ("b", "c", "d"), ("c", "d", "e"))):
        scen.append((f"scn{si}", ModelCollection([pool[n] for n in names]),
                     ModelCollection([pm(n, T_S, time_s) for n in names])))
    pack = tcampaign.pack_dedup_campaign(scen)
    for name in FIELDS:
        a = getattr(pack, name)
        if a.dtype == np.float32:
            setattr(pack, name, a.astype(np.float64))
    obs = np.cumsum(rng.normal(size=(R_OBS, T_H)), axis=-1) * 0.3
    return pack, obs


def campaign_args(pack, obs, multiple):
    uh, um = tcampaign.pad_unique_axis(pack.uh, pack.um, multiple)
    usb, usm = tcampaign.pad_unique_axis(pack.usb, pack.usm, multiple)
    return (uh, um, usb, usm, pack.uidx, pack.sidx, obs, pack.hb, pack.hm, pack.mmask)


def _rank_worker(rank, world, pack, obs):
    from torch.distributed.device_mesh import init_device_mesh

    torch.set_num_threads(1)
    mesh = init_device_mesh("cpu", (world,), mesh_dim_names=("model",))
    out = {}
    for kind, sigma, chunk in CASES:
        campaign = tcampaign.make_sharded_dedup_campaign(mesh, weight_kind=kind, sigma_mode=sigma,
                                                         hist_chunk=chunk, **FIT)
        reset_launch_counts()
        got = campaign(*campaign_args(pack, obs, world))
        out[(kind, sigma, chunk)] = dict(values=[g.numpy() for g in got],
                                         counts=tmesh.collective_counts(),
                                         types=[type(g).__name__ for g in got])
    campaign = tcampaign.make_sharded_dedup_campaign(mesh, **FIT)
    try:
        campaign(*campaign_args(pack, obs, 1))
    except ValueError as e:
        out["error"] = str(e)
    return out


def _spawn_worlds(*args):
    """``_rank_worker`` on every world size, the spawns side by side; a
    world that has not finished in 300 s fails the tests."""
    with concurrent.futures.ThreadPoolExecutor(len(WORLDS)) as pool:
        runs = {w: pool.submit(tmesh.run_local, _rank_worker, w, *args) for w in WORLDS}
        return {w: run.result() for w, run in runs.items()}


@pytest.fixture(scope="module")
def inputs():
    return make_pack()


@pytest.fixture(scope="module")
def sharded(inputs):
    return _spawn_worlds(*inputs)


def _ids(case):
    return "-".join(str(c) for c in case)


def _close(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=0, atol=TOL)


@pytest.mark.parametrize("case", CASES, ids=_ids)
@pytest.mark.parametrize("world", WORLDS)
def test_sharded_campaign_matches_jax_sharded(sharded, inputs, world, case):
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from bayesian_ensembling_tpu.parallel import campaign as jcampaign

    pack, obs = inputs
    mesh = Mesh(np.array(jax.devices()[:world]), ("model",))
    campaign = jcampaign.make_sharded_dedup_campaign(mesh, weight_kind=case[0],
                                                     sigma_mode=case[1], **FIT)
    want = campaign(*(jnp.asarray(a) for a in campaign_args(pack, obs, world)))
    _close(sharded[world][case]["values"], want)


@pytest.mark.parametrize("case", CASES, ids=_ids)
@pytest.mark.parametrize("world", WORLDS)
def test_sharded_campaign_matches_port_unsharded(sharded, inputs, world, case):
    pack, obs = inputs
    want = tcampaign.run_dedup_campaign(pack, obs, hist_chunk=pack.uh.shape[0],
                                        weight_kind=case[0], sigma_mode=case[1], device="cpu",
                                        dtype=torch.float64, **FIT)
    _close(sharded[world][case]["values"], [w.numpy() for w in want])


@pytest.mark.parametrize("case", CASES, ids=_ids)
@pytest.mark.parametrize("world", WORLDS)
def test_campaign_collectives(sharded, world, case):
    """Two gathers (the historical and the SSP marginals, mean and variance
    in one), and none in the tail, which runs on every rank as it does
    unsharded; the outputs are plain tensors."""
    res = sharded[world][case]
    assert res["counts"] == {"all_reduce": 0, "all_gather": 2}
    assert res["types"] == ["Tensor", "Tensor", "Tensor"]


@pytest.mark.parametrize("world", WORLDS)
def test_unpadded_unique_axis_raises_naming_pad_unique_axis(sharded, world):
    assert "pad_unique_axis" in sharded[world]["error"]


def test_sharded_campaign_refuses_unknown_options_before_fitting():
    with pytest.raises(ValueError, match="unknown weight_kind"):
        tcampaign.make_sharded_dedup_campaign(None, weight_kind="nope")
    with pytest.raises(ValueError, match="sigma_mode"):
        tcampaign.make_sharded_dedup_campaign(None, sigma_mode="compat")
