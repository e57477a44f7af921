"""Serving layer: query fitted ensemble projections without refitting.

PyTorch counterpart of ``bayesian_ensembling_tpu/serve.py``.  The full
experiment's per-scenario barycentre posteriors are saved once as compact
numpy artifacts, and a :class:`ProjectionService` answers
warming-projection queries (mean + credible interval at any year) from
them, in-process or over HTTP (stdlib ``http.server``).  The fit that
builds the artifacts runs on ``--device`` (the card by default); the query
side is numpy and needs no device.

Build artifacts:        python -m bayesian_ensembling_tpu_torch.serve build --out DIR
Gridded artifacts:      python -m bayesian_ensembling_tpu_torch.serve build-gridded --out DIR
Serve them:             python -m bayesian_ensembling_tpu_torch.serve serve --artifacts DIR --port 8765
Query:                  GET /scenarios
                        GET /project?scenario=ssp585&year=2100&interval=0.95
                        GET /project_point?scenario=gridded&year=2100&lat=52.5&lon=0
                        GET /map?scenario=gridded&year=2100
"""

from __future__ import annotations

import json
import os
import statistics
import sys
import typing as tp

import numpy as np
import torch

__all__ = ["ProjectionService", "build_artifacts", "build_gridded_artifacts"]

def _zvalue(interval: float) -> float:
    """Two-sided Gaussian quantile, exact to double precision for ANY
    interval (stdlib AS241 inverse CDF — no scipy dependency)."""
    if not 0.0 < interval < 1.0:
        raise ValueError(f"interval must be in (0, 1), got {interval}")
    return statistics.NormalDist().inv_cdf(0.5 + interval / 2.0)


class ProjectionService:
    """Answers projection queries from saved per-scenario posteriors."""

    def __init__(self, artifacts: tp.Dict[str, tp.Dict[str, np.ndarray]]):
        # artifacts[ssp] = {"years": (T,), "mean": (T,), "std": (T,)}
        self._art = artifacts

    # ------------------------------------------------------------ factories
    @classmethod
    def from_results(cls, results: tp.Dict[str, tp.Any]) -> "ProjectionService":
        """Build from ``pipeline.ScenarioResult`` objects (moments on any
        device; they are copied to the host)."""
        from bayesian_ensembling_tpu_torch.io import timeutils

        def host(x: torch.Tensor) -> np.ndarray:
            return x.detach().cpu().numpy().astype(np.float64)

        art = {}
        for ssp, res in results.items():
            post = res.barycentre
            art[ssp] = {
                "years": timeutils.years_of(post.template.time).astype(np.int64),
                "mean": host(post.gaussian.mean),
                "std": np.sqrt(host(post.gaussian.variance)),
            }
        return cls(art)

    @classmethod
    def from_gridded(
        cls, posteriors: tp.Dict[str, tp.Any]
    ) -> "ProjectionService":
        """Build GRIDDED artifacts from fitted per-cell posteriors.

        ``posteriors[name]`` is a ``Posterior`` whose template carries
        ``(time, latitude, longitude)`` dims (the ``run_gridded_scenario``
        output).  Gridded artifacts add ``lat``/``lon`` axes and store
        ``mean``/``std`` as (T, La, Lo); queries go through
        :meth:`project_point` / :meth:`map_grid`.  The moments come to
        the host through the posterior's numpy views.
        """
        from bayesian_ensembling_tpu_torch.io import timeutils

        art = {}
        for name, post in posteriors.items():
            mean = post.mean  # DimArray, dims (time, latitude, longitude)
            if mean.dims != ("time", "latitude", "longitude"):
                raise ValueError(
                    "gridded artifacts need (time, latitude, longitude) "
                    f"posteriors, got dims {mean.dims} for {name!r}"
                )
            art[name] = {
                "years": timeutils.years_of(post.template.time).astype(np.int64),
                "mean": np.asarray(mean.values, np.float64),
                "std": np.sqrt(np.asarray(post.variance.values, np.float64)),
                "lat": np.asarray(mean.get_coord("latitude"), np.float64),
                "lon": np.asarray(mean.get_coord("longitude"), np.float64),
            }
        return cls(art)

    @classmethod
    def load(cls, directory: str) -> "ProjectionService":
        art = {}
        for fn in sorted(os.listdir(directory)):
            if fn.endswith(".npz"):
                with np.load(os.path.join(directory, fn)) as z:
                    art[fn[:-4]] = {k: z[k] for k in z.files}
        if not art:
            raise FileNotFoundError(f"no projection artifacts under {directory}")
        return cls(art)

    def save(self, directory: str) -> None:
        os.makedirs(directory, exist_ok=True)
        for ssp, a in self._art.items():
            np.savez_compressed(os.path.join(directory, f"{ssp}.npz"), **a)

    # -------------------------------------------------------------- queries
    def scenarios(self) -> tp.List[str]:
        return sorted(self._art)

    def is_gridded(self, scenario: str) -> bool:
        return scenario in self._art and "lat" in self._art[scenario]

    def project_point(
        self,
        scenario: str,
        year: int,
        lat: float,
        lon: float,
        interval: float = 0.95,
    ) -> tp.Dict[str, float]:
        """Projection at the nearest grid cell and year of a GRIDDED artifact
        (the serving form of the GPDTW3D capability)."""
        if scenario not in self._art:
            raise KeyError(
                f"unknown scenario {scenario!r}; have {self.scenarios()}"
            )
        if not self.is_gridded(scenario):
            raise ValueError(
                f"{scenario!r} is a GMST artifact — use project()"
            )
        if not 0.0 < interval < 1.0:
            raise ValueError("interval must be in (0, 1)")
        a = self._art[scenario]
        i = int(np.argmin(np.abs(a["lat"] - float(lat))))
        # Nearest longitude on the circle (0 and 360 are neighbours).
        dlon = np.abs((a["lon"] - float(lon) + 180.0) % 360.0 - 180.0)
        j = int(np.argmin(dlon))
        ti = int(np.argmin(np.abs(a["years"] - int(year))))
        sel = a["years"] == a["years"][ti]
        z = _zvalue(interval)
        mean = float(a["mean"][sel, i, j].mean())
        std = float(a["std"][sel, i, j].mean())
        return {
            "scenario": scenario,
            "year": int(a["years"][ti]),
            "lat": float(a["lat"][i]),
            "lon": float(a["lon"][j]),
            "mean": mean,
            "lo": mean - z * std,
            "hi": mean + z * std,
            "interval": interval,
        }

    def map_grid(self, scenario: str, year: int) -> tp.Dict[str, tp.Any]:
        """Full lat/lon field of projected mean/std at the nearest year."""
        if scenario not in self._art:
            raise KeyError(
                f"unknown scenario {scenario!r}; have {self.scenarios()}"
            )
        if not self.is_gridded(scenario):
            raise ValueError(
                f"{scenario!r} is a GMST artifact — use trajectory()"
            )
        a = self._art[scenario]
        ti = int(np.argmin(np.abs(a["years"] - int(year))))
        sel = a["years"] == a["years"][ti]
        return {
            "scenario": scenario,
            "year": int(a["years"][ti]),
            "lat": a["lat"].tolist(),
            "lon": a["lon"].tolist(),
            "mean": a["mean"][sel].mean(axis=0).tolist(),
            "std": a["std"][sel].mean(axis=0).tolist(),
        }

    def project(
        self, scenario: str, year: int, interval: float = 0.95
    ) -> tp.Dict[str, float]:
        """Warming mean + central credible interval at the nearest year.

        Artifacts built at native monthly resolution carry 12 timesteps per
        year; the yearly projection averages ALL of that year's steps —
        mean of the monthly means (the annual-mean anomaly, seasonal cycle
        averaged out) and mean of the monthly stds (the annual mean's
        spread under the high month-to-month posterior correlation of the
        smooth GP trend; with a single step per year — annual artifacts —
        both reduce to the old nearest-step lookup exactly)."""
        if scenario not in self._art:
            raise KeyError(
                f"unknown scenario {scenario!r}; have {self.scenarios()}"
            )
        if self.is_gridded(scenario):
            raise ValueError(
                f"{scenario!r} is a gridded artifact — use project_point()"
            )
        if not 0.0 < interval < 1.0:
            raise ValueError("interval must be in (0, 1)")
        a = self._art[scenario]
        nearest = int(a["years"][np.argmin(np.abs(a["years"] - int(year)))])
        sel = a["years"] == nearest
        z = _zvalue(interval)
        mean = float(a["mean"][sel].mean())
        std = float(a["std"][sel].mean())
        return {
            "scenario": scenario,
            "year": nearest,
            "mean": mean,
            "lo": mean - z * std,
            "hi": mean + z * std,
            "interval": interval,
        }

    def trajectory(self, scenario: str) -> tp.Dict[str, tp.List[float]]:
        if scenario not in self._art:
            # Same exception type as project() for the same condition.
            raise KeyError(
                f"unknown scenario {scenario!r}; have {self.scenarios()}"
            )
        if self.is_gridded(scenario):
            raise ValueError(
                f"{scenario!r} is a gridded artifact — use map_grid()"
            )
        a = self._art[scenario]
        years = a["years"].astype(np.float64)
        if len(years) != len(np.unique(years)):
            # Sub-annual artifacts (native monthly builds): label the steps
            # within each year fractionally (2100.04, 2100.13, ...) instead
            # of returning 12 indistinguishable copies of the integer year.
            frac = np.zeros_like(years)
            for y in np.unique(years):
                sel = a["years"] == y
                n = int(sel.sum())
                frac[sel] = (np.arange(n) + 0.5) / n
            years = years + frac
        return {
            "years": years.tolist(),
            "mean": a["mean"].tolist(),
            "std": a["std"].tolist(),
        }

    # ----------------------------------------------------------------- http
    def make_http_server(self, host: str = "127.0.0.1", port: int = 8765):
        """stdlib HTTP server exposing /scenarios, /project, /trajectory."""
        import http.server
        import urllib.parse

        service = self

        class Handler(http.server.BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet
                pass

            def _reply(self, code: int, payload):
                # allow_nan=False: bare NaN is invalid JSON; a degenerate
                # artifact should 400 loudly, not hand strict clients an
                # unparsable 200.
                body = json.dumps(payload, allow_nan=False).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                url = urllib.parse.urlparse(self.path)
                q = urllib.parse.parse_qs(url.query)
                try:
                    if url.path == "/scenarios":
                        self._reply(200, {"scenarios": service.scenarios()})
                    elif url.path == "/project":
                        self._reply(200, service.project(
                            q["scenario"][0],
                            int(q["year"][0]),
                            float(q.get("interval", ["0.95"])[0]),
                        ))
                    elif url.path == "/trajectory":
                        self._reply(200, service.trajectory(q["scenario"][0]))
                    elif url.path == "/project_point":
                        self._reply(200, service.project_point(
                            q["scenario"][0],
                            int(q["year"][0]),
                            float(q["lat"][0]),
                            float(q["lon"][0]),
                            float(q.get("interval", ["0.95"])[0]),
                        ))
                    elif url.path == "/map":
                        self._reply(200, service.map_grid(
                            q["scenario"][0], int(q["year"][0])
                        ))
                    else:
                        self._reply(404, {"error": f"unknown path {url.path}"})
                except (KeyError, ValueError, IndexError) as e:
                    self._reply(400, {"error": str(e)})

        return http.server.ThreadingHTTPServer((host, port), Handler)


def build_artifacts(
    out_dir: str,
    ssps: tp.Sequence[str] = None,
    data_dir: tp.Optional[str] = None,
    n_optim_nits: int = 2000,
    sigma_mode: str = "w2",
    resample_freq: tp.Optional[str] = "Y",
    time_stride: int = 1,
    fine_steps: tp.Optional[int] = None,
    fit_chunk_steps: tp.Optional[int] = None,
    optimizer: str = "adam",
    refine_f64: bool = False,
    device: tp.Union[str, torch.device] = "cuda",
) -> "ProjectionService":
    """Run the full experiment on ``device`` (the card unless the caller
    asks for ``"cpu"``) and save serving artifacts (one fit, then serve
    forever): ``pipeline.load_observations`` + ``load_scenario`` +
    ``run_scenario`` per scenario.  ``sigma_mode`` selects the
    combined-sigma convention ("w2" | "compat" | "mixture";
    ``schemes.Barycentre``).  ``resample_freq=None`` builds native-monthly
    projections, where ``time_stride``/``fine_steps`` select the
    coarse-to-fine-in-time fit and ``fit_chunk_steps`` splits each fit into
    host-level chunks.  ``refine_f64`` publishes float64-refined posterior
    moments (``pipeline.run_scenario``)."""
    from bayesian_ensembling_tpu_torch import pipeline

    ssps = list(ssps or pipeline.ALL_SSPS)
    obs = pipeline.load_observations(data_dir, resample_freq=resample_freq)
    results = {}
    for ssp in ssps:
        hist, ssp_mc = pipeline.load_scenario(ssp, data_dir, resample_freq=resample_freq)
        results[ssp] = pipeline.run_scenario(
            hist, ssp_mc, obs, ssp, n_optim_nits=n_optim_nits,
            sigma_mode=sigma_mode, time_stride=time_stride,
            fine_steps=fine_steps, fit_chunk_steps=fit_chunk_steps,
            optimizer=optimizer, refine_f64=refine_f64, device=device,
        )
    svc = ProjectionService.from_results(results)
    svc.save(out_dir)
    return svc


def build_gridded_artifacts(
    out_dir: str,
    lat: int = 12,
    lon: int = 24,
    n_models: int = 5,
    n_realisations: int = 10,
    n_steps: int = 86,
    n_optim_nits: int = 500,
    sigma_mode: str = "w2",
    name: str = "gridded",
    seed: int = 0,
    refine_f64: bool = False,
    refine_device: tp.Union[str, torch.device, None] = None,
    device: tp.Union[str, torch.device] = "cuda",
) -> "ProjectionService":
    """Fit the GRIDDED pipeline end to end on ``device`` (the card unless
    the caller asks for ``"cpu"``) and save a gridded artifact.

    The bundled data is GMST-only (already area-averaged), so this function
    serves a CMIP6-dimensioned synthetic gridded workload drawn from
    ``seed`` (the JAX package's ``build_gridded_artifacts`` draws the same
    numbers); with real
    gridded netCDFs, build the ``ModelCollection`` yourself and use
    ``ProjectionService.from_gridded({name: bary})`` on the
    ``pipeline.run_gridded_scenario`` output.  ``refine_device`` is where
    the float64 refinement runs (``device`` when None).
    """
    from bayesian_ensembling_tpu_torch import pipeline
    from bayesian_ensembling_tpu_torch.coords import DimArray
    from bayesian_ensembling_tpu_torch.data import ModelCollection, ProcessModel

    rng = np.random.default_rng(seed)
    time = (np.datetime64("2015-01", "Y") + np.arange(n_steps)).astype("datetime64[ns]")
    lats = np.linspace(-90 + 90 / lat, 90 - 90 / lat, lat)
    lons = np.linspace(0, 360, lon, endpoint=False)
    coords = {
        "time": time, "latitude": lats, "longitude": lons,
        "realisation": np.arange(n_realisations),
    }
    signal = np.sin(np.linspace(0, 3, n_steps))[:, None, None]

    def pm(name_, n_real):
        vals = (signal + 0.3 * rng.normal(size=(n_real, n_steps, lat, lon))).astype(np.float32)
        c = dict(coords)
        c["realisation"] = np.arange(n_real)
        return ProcessModel(
            DimArray(vals, ("realisation", "time", "latitude", "longitude"), c, name="tas"),
            name_,
        )

    mc = ModelCollection([pm(f"model{i}", n_realisations) for i in range(n_models)])
    obs = pm("obs", n_realisations)
    _, bary = pipeline.run_gridded_scenario(
        mc, obs, n_optim_nits=n_optim_nits, sigma_mode=sigma_mode,
        refine_f64=refine_f64, refine_device=refine_device, device=device,
    )
    svc = ProjectionService.from_gridded({name: bary})
    svc.save(out_dir)
    return svc


def main(argv: tp.Optional[tp.Sequence[str]] = None):
    import argparse

    from bayesian_ensembling_tpu_torch.utils.cli import (
        add_optimizer_arg,
        add_profile_arg,
        add_warm_time_args,
        apply_profile,
        validate_warm_time_args,
    )

    ap = argparse.ArgumentParser(prog="bayesian_ensembling_tpu_torch.serve")
    sub = ap.add_subparsers(dest="cmd", required=True)
    b = sub.add_parser("build")
    b.add_argument("--out", required=True)
    b.add_argument("--ssps", default=None)
    b.add_argument("--data-dir", default=None)
    b.add_argument("--n-optim-nits", type=int, default=2000)
    b.add_argument("--sigma-mode", choices=["w2", "compat", "mixture"], default="w2")
    b.add_argument(
        "--resample-freq",
        default="Y",
        help="calendar resample frequency (M/Q/Y; 'none' = native monthly)",
    )
    add_optimizer_arg(b)
    add_warm_time_args(b)
    add_profile_arg(b)
    b.add_argument(
        "--fit-chunk-steps", type=int, default=None,
        help="split each fit into host-level chunks of this many "
        "optimisation steps, each ended by a device synchronisation",
    )
    b.add_argument(
        "--refine-f64", action="store_true",
        help="publish float64-refined posterior moments in the artifacts "
        "(the fit stays float32)",
    )
    g = sub.add_parser(
        "build-gridded",
        help="fit the gridded pipeline on a synthetic CMIP6-dimensioned "
        "workload and save a gridded artifact (lat/lon point + map "
        "queries); for real gridded netCDFs use the library path "
        "(ProjectionService.from_gridded on run_gridded_scenario output)",
    )
    g.add_argument("--out", required=True)
    g.add_argument("--lat", type=int, default=12)
    g.add_argument("--lon", type=int, default=24)
    g.add_argument("--models", type=int, default=5)
    g.add_argument("--realisations", type=int, default=10)
    g.add_argument("--steps", type=int, default=86)
    g.add_argument("--n-optim-nits", type=int, default=500)
    g.add_argument("--sigma-mode", choices=["w2", "compat", "mixture"], default="w2")
    g.add_argument("--name", default="gridded")
    g.add_argument(
        "--refine-f64", action="store_true",
        help="publish float64-refined per-cell posterior moments (the fit "
        "stays float32)",
    )
    g.add_argument(
        "--refine-device", default=None,
        help="device for the float64 refinement pass (e.g. 'cpu'; default: --device)",
    )
    for p in (b, g):
        p.add_argument(
            "--device", default="cuda",
            help="device of the fit (default: the card; 'cpu' runs the plain "
            "versions of the kernels)",
        )
    s = sub.add_parser("serve")
    s.add_argument("--artifacts", required=True)
    s.add_argument("--host", default="127.0.0.1")
    s.add_argument("--port", type=int, default=8765)
    args = ap.parse_args(argv)

    if args.cmd == "build-gridded":
        svc = build_gridded_artifacts(
            args.out, lat=args.lat, lon=args.lon, n_models=args.models,
            n_realisations=args.realisations, n_steps=args.steps,
            n_optim_nits=args.n_optim_nits, sigma_mode=args.sigma_mode,
            name=args.name, refine_f64=args.refine_f64,
            refine_device=args.refine_device, device=args.device,
        )
        print(f"saved gridded artifacts for {svc.scenarios()} to {args.out}")
        return

    if args.cmd == "build":
        apply_profile(b, args, resample_freq=args.resample_freq)
        validate_warm_time_args(ap, args, resample_freq=args.resample_freq)
        ssps = args.ssps.split(",") if args.ssps else None
        freq = None if args.resample_freq.lower() == "none" else args.resample_freq
        svc = build_artifacts(
            args.out, ssps, args.data_dir, args.n_optim_nits,
            sigma_mode=args.sigma_mode, resample_freq=freq,
            time_stride=args.time_stride, fine_steps=args.fine_steps,
            fit_chunk_steps=args.fit_chunk_steps, optimizer=args.optimizer,
            refine_f64=args.refine_f64, device=args.device,
        )
        print(f"saved artifacts for {svc.scenarios()} to {args.out}")
    else:
        svc = ProjectionService.load(args.artifacts)
        server = svc.make_http_server(args.host, args.port)
        print(f"serving {svc.scenarios()} on http://{args.host}:{args.port}")
        server.serve_forever()


if __name__ == "__main__":
    main()
