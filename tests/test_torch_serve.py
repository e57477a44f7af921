"""The port's serving layer (``serve.py``) against the JAX package, on the CPU.

The queries are numpy in both packages and must agree exactly on the same
artifacts.  The two build functions run the whole fit: ``build_artifacts`` on a
temporary netCDF tree (``test_torch_io.py``'s) and ``build_gridded_artifacts``
on its synthetic grid, both packages with float64 emulators (substituted for
the float32 defaults), held at 1e-7 °C, the tolerance of
``test_torch_library_api.py`` for the whole of ``run_scenario``.
"""

import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from bayesian_ensembling_tpu import pipeline as jpipeline
from bayesian_ensembling_tpu import serve as jserve
from bayesian_ensembling_tpu.models import gp_3d as jgp_3d
from bayesian_ensembling_tpu.models.gp_dtw import GPDTW1D as JGPDTW1D
from bayesian_ensembling_tpu_torch import pipeline as tpipeline
from bayesian_ensembling_tpu_torch import serve as tserve
from bayesian_ensembling_tpu_torch.coords import DimArray
from bayesian_ensembling_tpu_torch.data import Posterior
from bayesian_ensembling_tpu_torch.models import gp_3d as tgp_3d
from bayesian_ensembling_tpu_torch.models.gp_dtw import GPDTW1D as TGPDTW1D
from bayesian_ensembling_tpu_torch.ops.distributions import DiagGaussian

from test_torch_io import data_tree  # noqa: F401  (the netCDF tree fixture)

torch.set_num_threads(1)


def artifacts():
    years = np.arange(2015, 2101)
    t = years.size
    monthly_years = np.repeat(np.arange(2015, 2018), 12).astype(np.int64)
    seasonal = np.tile(np.sin(2 * np.pi * np.arange(12) / 12), 3)
    return {
        "ssp585": {"years": years, "mean": np.linspace(1.0, 6.0, t),
                   "std": np.linspace(0.1, 0.3, t)},
        "ssp119": {"years": years, "mean": np.linspace(1.0, 1.5, t), "std": np.full(t, 0.2)},
        "monthly": {"years": monthly_years,
                    "mean": np.repeat([1.0, 2.0, 3.0], 12) + seasonal,
                    "std": np.repeat([0.1, 0.2, 0.3], 12)},
        "gridded": {"years": np.arange(2015, 2021), "lat": np.array([-45.0, 0.0, 45.0]),
                    "lon": np.array([0.0, 90.0, 180.0, 270.0]),
                    "mean": np.arange(72, dtype=np.float64).reshape(6, 3, 4) / 10.0,
                    "std": np.full((6, 3, 4), 0.2)},
    }


QUERIES = [
    ("scenarios", ()), ("project", ("ssp585", 2100)), ("project", ("ssp585", 2300)),
    ("project", ("ssp119", 2050, 0.8)), ("project", ("monthly", 2016)),
    ("trajectory", ("ssp585",)), ("trajectory", ("monthly",)),
    ("project_point", ("gridded", 2017, 10.0, 95.0)), ("project_point", ("gridded", 2015, 0.0, 350.0)),
    ("project_point", ("gridded", 2019, -80.0, 180.0, 0.5)), ("map_grid", ("gridded", 2016)),
    ("is_gridded", ("gridded",)), ("is_gridded", ("ssp119",)),
]
BAD = [
    ("project", ("nope", 2100)), ("project", ("ssp585", 2100, 1.5)), ("project", ("gridded", 2016)),
    ("trajectory", ("gridded",)), ("trajectory", ("nope",)), ("project_point", ("ssp585", 2100, 0, 0)),
    ("project_point", ("gridded", 2016, 0, 0, 0.0)), ("map_grid", ("ssp585", 2100)),
    ("map_grid", ("nope", 2100)),
]


@pytest.mark.parametrize("name,args", QUERIES, ids=[f"{n}-{i}" for i, (n, _) in enumerate(QUERIES)])
def test_queries_equal_jax(name, args):
    got = getattr(tserve.ProjectionService(artifacts()), name)(*args)
    want = getattr(jserve.ProjectionService(artifacts()), name)(*args)
    assert got == want


@pytest.mark.parametrize("name,args", BAD, ids=[f"{n}-{i}" for i, (n, _) in enumerate(BAD)])
def test_bad_queries_raise_as_jax(name, args):
    errors = []
    for mod in (tserve, jserve):
        with pytest.raises((KeyError, ValueError)) as e:
            getattr(mod.ProjectionService(artifacts()), name)(*args)
        errors.append((type(e.value), str(e.value)))
    assert errors[0] == errors[1]


def test_zvalue_and_save_load_roundtrip(tmp_path):
    for interval in (0.3, 0.8, 0.93, 0.95, 0.999):
        assert tserve._zvalue(interval) == jserve._zvalue(interval)
    with pytest.raises(ValueError):
        tserve._zvalue(1.2)
    tserve.ProjectionService(artifacts()).save(str(tmp_path / "t"))
    back = tserve.ProjectionService.load(str(tmp_path / "t"))
    jback = jserve.ProjectionService.load(str(tmp_path / "t"))
    assert back.scenarios() == jback.scenarios() == sorted(artifacts())
    for name, args in QUERIES:
        assert getattr(back, name)(*args) == getattr(jback, name)(*args)
    with pytest.raises(FileNotFoundError, match="no projection artifacts"):
        tserve.ProjectionService.load(str(tmp_path))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_from_results_on_cpu_tensors_matches_jax(dtype):
    from bayesian_ensembling_tpu.coords import DimArray as JDimArray
    from bayesian_ensembling_tpu.data import Posterior as JPosterior
    from bayesian_ensembling_tpu.ops.distributions import DiagGaussian as JDiag

    t = 10
    time = (np.datetime64("2015", "Y") + np.arange(t)).astype("datetime64[ns]")
    mean = np.linspace(0, 1, t)
    var = np.linspace(0.01, 0.05, t)
    tpost = Posterior(DiagGaussian(torch.tensor(mean, dtype=dtype),
                                   torch.tensor(var, dtype=dtype)),
                      DimArray(np.full((t,), np.nan), ("time",), {"time": time}))
    np_dtype = np.float32 if dtype == torch.float32 else np.float64
    jpost = JPosterior(JDiag(mean=mean.astype(np_dtype), var=var.astype(np_dtype)),
                       JDimArray(np.full((t,), np.nan), ("time",), {"time": time}))
    got = tserve.ProjectionService.from_results(
        {"sspX": tpipeline.ScenarioResult("sspX", None, tpost, 0.0, 0.0)})
    want = jserve.ProjectionService.from_results(
        {"sspX": jpipeline.ScenarioResult("sspX", None, jpost, 0.0, 0.0)})
    for key in ("years", "mean", "std"):
        np.testing.assert_array_equal(got._art["sspX"][key], want._art["sspX"][key])
        assert got._art["sspX"][key].dtype == want._art["sspX"][key].dtype
    assert got.project("sspX", 2024) == want.project("sspX", 2024)


def _get(url):
    try:
        with urllib.request.urlopen(url, timeout=30) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_http_endpoints_answer_as_jax():
    paths = ["/scenarios", "/project?scenario=ssp585&year=2100",
             "/project?scenario=ssp119&year=2050&interval=0.8", "/trajectory?scenario=monthly",
             "/project_point?scenario=gridded&year=2017&lat=0&lon=90",
             "/map?scenario=gridded&year=2016", "/project?scenario=zz&year=2100",
             "/project?scenario=ssp585", "/project_point?scenario=ssp585&year=2100&lat=0&lon=0",
             "/nowhere"]
    answers = []
    for mod in (tserve, jserve):
        server = mod.ProjectionService(artifacts()).make_http_server(port=0)
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        thread.start()
        try:
            base = f"http://127.0.0.1:{server.server_address[1]}"
            answers.append([_get(base + p) for p in paths])
        finally:
            server.shutdown()
            server.server_close()
            thread.join(timeout=30)
        assert not thread.is_alive()
    assert answers[0] == answers[1]
    assert [code for code, _ in answers[0]] == [200] * 6 + [400] * 3 + [404]


@pytest.fixture
def float64_emulators(monkeypatch):
    """Both packages' pipelines build float64 emulators by default."""
    monkeypatch.setattr(jpipeline, "GPDTW1D", lambda: JGPDTW1D(dtype=np.float64))
    monkeypatch.setattr(tpipeline, "GPDTW1D", lambda: TGPDTW1D(dtype=torch.float64))
    jcls, tcls = jgp_3d.GPDTW3D, tgp_3d.GPDTW3D
    monkeypatch.setattr(jgp_3d, "GPDTW3D", lambda: jcls(dtype=np.float64))
    monkeypatch.setattr(tgp_3d, "GPDTW3D", lambda: tcls(dtype=torch.float64))


def _art_close(got, want, tol):
    assert got.scenarios() == want.scenarios()
    for name in want.scenarios():
        a, b = got._art[name], want._art[name]
        assert set(a) == set(b)
        for key in b:
            assert a[key].shape == b[key].shape, key
            np.testing.assert_allclose(a[key], b[key], rtol=0, atol=tol, err_msg=f"{name} {key}")


def test_build_artifacts_matches_jax(data_tree, tmp_path, float64_emulators):  # noqa: F811
    kw = dict(ssps=["ssp119", "ssp585"], data_dir=data_tree, n_optim_nits=20)
    got = tserve.build_artifacts(str(tmp_path / "t"), device="cpu", **kw)
    want = jserve.build_artifacts(str(tmp_path / "j"), **kw)
    _art_close(got, want, 1e-7)
    _art_close(tserve.ProjectionService.load(str(tmp_path / "t")), want, 1e-7)


def test_build_gridded_artifacts_matches_jax(tmp_path, float64_emulators):
    kw = dict(lat=2, lon=3, n_models=2, n_realisations=3, n_steps=8, n_optim_nits=5)
    got = tserve.build_gridded_artifacts(str(tmp_path / "t"), device="cpu", **kw)
    want = jserve.build_gridded_artifacts(str(tmp_path / "j"), **kw)
    assert got.is_gridded("gridded")
    _art_close(got, want, 1e-7)


def test_build_functions_default_to_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this check is for a machine without CUDA")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tserve.build_gridded_artifacts(str(tmp_path), lat=1, lon=2, n_models=2,
                                       n_realisations=2, n_steps=4, n_optim_nits=1)


def test_main_builds_on_the_cpu(data_tree, tmp_path, capsys):  # noqa: F811
    tserve.main(["build-gridded", "--out", str(tmp_path / "g"), "--lat", "2", "--lon", "2",
                 "--models", "2", "--realisations", "2", "--steps", "6", "--n-optim-nits", "2",
                 "--device", "cpu"])
    tserve.main(["build", "--out", str(tmp_path / "b"), "--ssps", "ssp585", "--data-dir",
                 data_tree, "--n-optim-nits", "3", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "saved gridded artifacts for ['gridded']" in out
    assert "saved artifacts for ['ssp585']" in out
    svc = tserve.ProjectionService.load(str(tmp_path / "b"))
    assert svc.project("ssp585", 2100)["year"] == 2100
    assert tserve.ProjectionService.load(str(tmp_path / "g")).is_gridded("gridded")


@pytest.mark.parametrize("argv", [
    ["build", "--out", "x", "--profile", "fast", "--n-optim-nits", "5"],
    ["build", "--out", "x", "--time-stride", "4"],
    ["build", "--out", "x", "--fine-steps", "4"],
    ["serve"],
    ["build-gridded"],
])
def test_main_rejects_what_jax_rejects(argv, capsys):
    for mod in (tserve, jserve):
        with pytest.raises(SystemExit) as e:
            mod.main(argv)
        assert e.value.code == 2
    assert "error" in capsys.readouterr().err


@pytest.mark.parametrize("argv,freq", [
    ([], "Y"), (["--profile", "fast"], "Y"), (["--profile", "fast"], "none"),
    (["--optimizer", "bfgs", "--n-optim-nits", "30"], "Y"),
    (["--time-stride", "12", "--fine-steps", "100"], "none"),
    (["--dba-method", "subgradient", "--dba-iterations", "50", "--dba-tol", "1e-3"], "Y"),
])
def test_cli_helpers_parse_as_jax(argv, freq):
    """The port's copy of ``utils/cli.py`` builds the same options and
    expands the profiles into the same fit knobs."""
    import argparse

    from bayesian_ensembling_tpu.utils import cli as jcli
    from bayesian_ensembling_tpu_torch.utils import cli as tcli

    parsed = []
    for cli in (tcli, jcli):
        ap = argparse.ArgumentParser()
        ap.add_argument("--n-optim-nits", type=int, default=2000)
        cli.add_optimizer_arg(ap)
        cli.add_warm_time_args(ap)
        cli.add_profile_arg(ap)
        cli.add_dba_args(ap)
        args = ap.parse_args(argv)
        cli.apply_profile(ap, args, resample_freq=freq)
        cli.validate_warm_time_args(ap, args, resample_freq=freq)
        parsed.append(vars(args))
    assert parsed[0] == parsed[1]
