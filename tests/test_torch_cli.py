"""The port's entry scripts (``bayesian_ensembling_tpu_torch/cli``) against
the JAX package's ``experiments/`` and ``data_download/`` scripts, on the
CPU, on netCDF files and npz checkpoints the tests write.

- ``create_gmst`` and ``extract_single_location``: host numpy code on both
  sides, so the files they write hold equal values and coordinates.
- ``full_experiment --cpu``: both packages' float64 path on a netCDF tree
  laid out as ``default_data_dir`` expects; the printed credible intervals
  agree (three decimals) and the same figures are written.
- ``pre_fit_models``: the checkpoints equal, bit for bit, what the port's
  library writes for the same fits; against the JAX script (both fit
  float32 emulators, whose DBA and solvers round differently) the moments
  agree within 0.01 degC, the repository's float32 gate (``bench.py:560``).
- ``perfect_model_tests``: ``--batched --prefit-dir`` on float64 npz
  checkpoints, the port with no data directory at all (the JAX script
  needs one, ROADMAP C2, so it is given an empty one): the CSVs agree to
  1e-8; and the fold loop with fresh float32 fits on the netCDF tree: bit
  for bit the port's ``PerfectModelTest.run``, and within 0.01 degC (2%
  relative on the NLL columns) of the JAX script.
"""

import glob
import os
import runpy
import sys

import numpy as np
import pytest

pd = pytest.importorskip("pandas")
pytest.importorskip("h5py")
pytest.importorskip("matplotlib")

from bayesian_ensembling_tpu import coords as jcoords  # noqa: E402
from bayesian_ensembling_tpu.io import netcdf as jnetcdf  # noqa: E402
from bayesian_ensembling_tpu_torch.cli import create_gmst as t_gmst  # noqa: E402
from bayesian_ensembling_tpu_torch.cli import extract_single_location as t_extract  # noqa: E402
from bayesian_ensembling_tpu_torch.cli import full_experiment as t_full  # noqa: E402
from bayesian_ensembling_tpu_torch.cli import perfect_model_tests as t_pmt  # noqa: E402
from bayesian_ensembling_tpu_torch.cli import pre_fit_models as t_prefit  # noqa: E402

from test_torch_io import data_tree  # noqa: E402,F401  (the netCDF tree fixture)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run_jax_script(rel_path, argv, monkeypatch):
    monkeypatch.setattr(sys, "argv", [os.path.basename(rel_path)] + list(argv))
    if "data_download" in rel_path:
        monkeypatch.syspath_prepend(os.path.join(ROOT, "data_download"))
    runpy.run_path(os.path.join(ROOT, rel_path), run_name="__main__")


def _gridded(path, rng, nan_cell=False, lon0=0.0):
    time = (np.datetime64("2000-01", "M") + np.arange(6)).astype("datetime64[ns]")
    lat = np.linspace(-80, 80, 5)
    lon = np.linspace(lon0, lon0 + 315, 8)
    vals = rng.normal(size=(2, 6, 5, 8))
    if nan_cell:
        vals[:, :, 1, 3] = np.nan
    da = jcoords.DimArray(vals, ("realisation", "time", "latitude", "longitude"),
                          {"time": time, "latitude": lat, "longitude": lon,
                           "realisation": np.arange(2)}, name="tas")
    jnetcdf.save_dataarray(str(path), da, var_name="tas")
    return str(path)


def _same_file(a, b):
    x, y = jnetcdf.open_dataarray(a), jnetcdf.open_dataarray(b)
    assert x.dims == y.dims and x.name == y.name
    np.testing.assert_array_equal(x.values, y.values)
    assert set(x.coords) == set(y.coords)
    for k in x.coords:
        np.testing.assert_array_equal(x.coords[k], y.coords[k])


# ------------------------------------------------------------ data_download
@pytest.mark.parametrize("nan_cell", [False, True])
def test_create_gmst_matches_jax(tmp_path, nan_cell, monkeypatch, capsys):
    rng = np.random.default_rng(1)
    files = [_gridded(tmp_path / f"m{i}.nc", rng, nan_cell) for i in range(2)]
    _run_jax_script("data_download/create_gmst.py", [str(tmp_path / "jax")] + files, monkeypatch)
    got = t_gmst.main([str(tmp_path / "port")] + files)
    out = capsys.readouterr().out
    assert [os.path.basename(p) for p in got] == ["m0_gmst.nc", "m1_gmst.nc"]
    for p in got:
        assert p in out
        _same_file(p, str(tmp_path / "jax" / os.path.basename(p)))


@pytest.mark.parametrize("where", [[], ["--lat", "0.0", "--lon", "-45.0"],
                                   ["--lat", "-70", "--lon", "200"]])
def test_extract_single_location_matches_jax(tmp_path, where, monkeypatch, capsys):
    rng = np.random.default_rng(2)
    f = _gridded(tmp_path / "g.nc", rng)
    _run_jax_script("data_download/extract_single_location.py", [str(tmp_path / "jax"), f] + where,
                    monkeypatch)
    (got,) = t_extract.main([str(tmp_path / "port"), f] + where)
    capsys.readouterr()
    assert os.path.basename(got) == "g_single_location.nc"
    _same_file(got, str(tmp_path / "jax" / "g_single_location.nc"))


def test_gmst_and_location_functions_match_jax():
    """The functions behind the scripts, on one field."""
    sys.path.insert(0, os.path.join(ROOT, "data_download"))
    try:
        from create_gmst import area_weighted_mean
        from extract_single_location import extract_location
    finally:
        sys.path.remove(os.path.join(ROOT, "data_download"))
    from bayesian_ensembling_tpu_torch.coords import DimArray

    rng = np.random.default_rng(3)
    vals = rng.normal(size=(2, 4, 5, 8))
    coords = {"time": np.arange(4), "latitude": np.linspace(-80, 80, 5),
              "longitude": np.linspace(0, 315, 8)}
    dims = ("realisation", "time", "latitude", "longitude")
    jda, tda = jcoords.DimArray(vals, dims, coords, name="tas"), DimArray(vals, dims, coords,
                                                                          name="tas")
    np.testing.assert_array_equal(t_gmst.area_weighted_mean(tda).values,
                                  area_weighted_mean(jda).values)
    assert t_gmst.area_weighted_mean(tda).name == "tas_gmst"
    for lat, lon in ((52.5, 0.0), (0.0, -45.0), (10.0, 359.0)):
        np.testing.assert_array_equal(t_extract.extract_location(tda, lat, lon).values,
                                      extract_location(jda, lat, lon).values)


# -------------------------------------------------------------- experiments
def test_full_experiment_cpu_matches_jax(data_tree, tmp_path, monkeypatch, capsys):  # noqa: F811
    args = ["--data-dir", data_tree, "--ssps", "ssp119,ssp585", "--n-optim-nits", "6",
            "--dba-iterations", "2", "--cpu"]
    _run_jax_script("experiments/full_experiment.py", args + ["--out-dir", str(tmp_path / "jax")],
                    monkeypatch)
    want = capsys.readouterr().out
    results = t_full.main(args + ["--out-dir", str(tmp_path / "port")])
    got = capsys.readouterr().out

    def intervals(text):
        return [line for line in text.splitlines() if "credible interval" in line]

    assert len(intervals(got)) == 4 and intervals(got) == intervals(want)
    assert sorted(results) == ["ssp119", "ssp585"]
    names = sorted(os.path.basename(p) for p in glob.glob(str(tmp_path / "port" / "*.pdf")))
    assert names == sorted(os.path.basename(p) for p in glob.glob(str(tmp_path / "jax" / "*.pdf")))
    assert "ssp585_with_95percent_credible_interval.pdf" in names
    assert "figure1_with_95percent_credible_interval.pdf" in names


def test_pre_fit_models_matches_jax(data_tree, tmp_path, monkeypatch, capsys):  # noqa: F811
    args = ["--data-dir", data_tree, "--ssps", "ssp119", "--n-optim-nits", "4",
            "--dba-iterations", "2"]
    _run_jax_script("experiments/pre_fit_models.py", args + ["--out-dir", str(tmp_path / "jax")],
                    monkeypatch)
    written = t_prefit.main(args + ["--out-dir", str(tmp_path / "port"), "--device", "cpu"])
    out = capsys.readouterr().out
    assert "ssp119: saved" in out
    assert [os.path.basename(p) for p in written] == ["hist_ssp119.npz", "ssp119.npz"]
    import bayesian_ensembling_tpu_torch as bt

    hist, ssp = bt.pipeline.load_scenario("ssp119", data_tree)
    for mc, name in ((hist, "hist_ssp119.npz"), (ssp, "ssp119.npz")):
        mc.fit(bt.GPDTW1D(), n_optim_nits=4, dba_iterations=2, device="cpu")
        mc.save(str(tmp_path / f"lib_{name}"))
    for p in written:
        name = os.path.basename(p)
        with np.load(p) as a, np.load(str(tmp_path / f"lib_{name}")) as lib, \
                np.load(str(tmp_path / "jax" / name)) as b:
            assert sorted(a.files) == sorted(b.files) == sorted(lib.files)
            for k in a.files:
                np.testing.assert_array_equal(a[k], lib[k], err_msg=k)
                if a[k].dtype.kind == "f":
                    np.testing.assert_allclose(a[k], b[k], rtol=0, atol=0.01, err_msg=k)
                else:
                    np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def _prefit_dir(tmp_path):
    """float64 npz checkpoints of two scenarios with 3 and 4 models."""
    import bayesian_ensembling_tpu as jbet
    from bayesian_ensembling_tpu.models.gp_dtw import GPDTW1D

    rng = np.random.default_rng(5)
    prefit = tmp_path / "prefit"
    prefit.mkdir()
    for ssp, n_models in (("sspa", 3), ("sspb", 4)):
        for name in (f"hist_{ssp}", ssp):
            models = []
            for i in range(n_models):
                t = (np.datetime64("1961-01", "M") + np.arange(10)).astype("datetime64[ns]")
                vals = np.linspace(0, 1, 10) + 0.1 * i + 0.2 * rng.normal(size=(2 + i % 3, 10))
                models.append(jbet.ProcessModel(jcoords.DimArray(
                    vals, ("realisation", "time"), {"time": t}, name="tas"), f"model{i}"))
            mc = jbet.ModelCollection(models)
            mc.fit(GPDTW1D(dtype=np.float64), n_optim_nits=5, dba_iterations=2)
            mc.save(str(prefit / f"{name}.npz"))
    return str(prefit)


def _csvs(out_dir):
    return {os.path.relpath(p, out_dir): pd.read_csv(p, index_col=0)
            for p in sorted(glob.glob(os.path.join(out_dir, "*", "csvs", "*.csv")))}


def _same_csv(got, want, rtol, atol, name, nll_rtol=None):
    """Equal labels; numbers within (rtol, atol), the NLL columns within
    ``nll_rtol`` when given (they are not in degC)."""
    assert list(got.columns) == list(want.columns), name
    num = got.select_dtypes("number").columns
    assert len(num) > 0
    for col in got.columns.difference(num):
        assert list(got[col]) == list(want[col]), (name, col)
    for col in num:
        if nll_rtol is not None and col.startswith("nll"):
            tol = dict(rtol=nll_rtol, atol=0)
        else:
            tol = dict(rtol=rtol, atol=atol)
        np.testing.assert_allclose(got[col].to_numpy(float), want[col].to_numpy(float),
                                   err_msg=f"{name}: {col}", **tol)


def test_pmt_batched_prefit_needs_no_data_dir(tmp_path, monkeypatch, capsys):
    """``--batched --prefit-dir`` with ``$BET_DATA_DIR`` unset and no data
    anywhere: the port's CLI never resolves the data directory (the port
    side of ROADMAP C2), and its CSVs equal the JAX script's."""
    prefit = _prefit_dir(tmp_path)
    common = ["--batched", "--prefit-dir", prefit, "--ssps", "sspa,sspb",
              "--weights", "CRPSWeight,UniformWeight,LogLikelihoodWeight"]
    empty = tmp_path / "no_data"
    empty.mkdir()
    _run_jax_script("experiments/perfect_model_tests.py",
                    common + ["--out-dir", str(tmp_path / "jax"), "--data-dir", str(empty)],
                    monkeypatch)
    want_out = capsys.readouterr().out
    monkeypatch.delenv("BET_DATA_DIR", raising=False)
    from bayesian_ensembling_tpu_torch import pipeline as tpipeline

    with pytest.raises(FileNotFoundError):
        tpipeline.default_data_dir()  # nothing to find
    frames = t_pmt.main(common + ["--out-dir", str(tmp_path / "port"), "--device", "cpu"])
    got_out = capsys.readouterr().out
    assert "shape bucket: pad_m=4, pad_r=4" in got_out and "shape bucket: pad_m=4" in want_out
    assert len(frames) == 6
    got, want = _csvs(str(tmp_path / "port")), _csvs(str(tmp_path / "jax"))
    assert sorted(got) == sorted(want) and len(got) == 6
    for k in got:
        _same_csv(got[k], want[k], 1e-8, 1e-10, k)


def test_pmt_fresh_fits_on_netcdf_match_jax(data_tree, tmp_path, monkeypatch, capsys):  # noqa: F811
    args = ["--data-dir", data_tree, "--ssps", "ssp119", "--weights", "CRPSWeight",
            "--n-optim-nits", "3", "--dba-iterations", "2"]
    _run_jax_script("experiments/perfect_model_tests.py", args + ["--out-dir", str(tmp_path / "jax")],
                    monkeypatch)
    frames = t_pmt.main(args + ["--out-dir", str(tmp_path / "port"), "--device", "cpu"])
    import bayesian_ensembling_tpu_torch as bt

    hist, fore = bt.pipeline.load_scenario("ssp119", data_tree)
    lib = bt.PerfectModelTest(hist, fore, bt.GPDTW1D, bt.CRPSWeight, bt.Barycentre, "ssp119",
                              scheme_kwargs={"sigma_mode": "w2"}).run(
        n_optim_nits=3, dba_iterations=2, device="cpu")
    capsys.readouterr()
    pd.testing.assert_frame_equal(frames["ssp119", "CRPSWeight"], lib)
    got, want = _csvs(str(tmp_path / "port")), _csvs(str(tmp_path / "jax"))
    assert sorted(got) == sorted(want) and len(got) == 1
    for k in got:
        _same_csv(got[k], want[k], 0, 0.01, k, nll_rtol=0.02)


def test_cli_argument_errors_match_jax(monkeypatch, capsys):
    """The parse-time refusals of the JAX scripts."""
    with pytest.raises(SystemExit, match="--batched requires --prefit-dir"):
        t_pmt.main(["--batched"])
    with pytest.raises(SystemExit):
        t_pmt.main(["--compat-fixed-point", "--sigma-mode", "w2"])
    with pytest.raises(SystemExit):
        t_full.main(["--optimizer", "sgd"])
    capsys.readouterr()
    for module in (t_full, t_prefit, t_pmt):
        assert module.build_parser().parse_args([]).device == "cuda"
