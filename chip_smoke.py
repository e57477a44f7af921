#!/usr/bin/env python3
"""Smoke run of the PyTorch port (bayesian_ensembling_tpu_torch) on one NVIDIA GPU.

Run from the repository root:

    python3 chip_smoke.py [--seed 0]

Phases, in order; any failure exits non-zero:

1. Device: CUDA must be present; prints the card, torch/CUDA versions and
   the TF32 flags (float32 matmuls must run in full float32).
2. Build: compiles the CUDA kernels in ``bayesian_ensembling_tpu_torch/csrc``
   with nvcc for sm_90a (into ``build/torch_kernels/``) and loads them.
3. Kernels against their plain PyTorch versions at the main path's shapes:
   the DBA update (N = 3,248 pairs, T = 165 and 86, exact), the fused
   Cholesky-solve and the triangular inverse (B = 112, T = 165 and 86), and
   one non-positive-definite input that must come back NaN.
4. The slice: ``ensemble_multi_scenario_step`` on synthetic GMST-like inputs
   of the flagship shape (7 SSPs x 16 padded models x 29 ragged
   realisations, T = 165 / 86, 200 observation members), float32 on the card
   through the kernels, with every launch counter checked; then the same
   inputs in float64 through the plain versions on the CPU, and the
   barycentre mean and std must agree within 0.01 degC pointwise.
5. Timing of the faithful workload (2,000 Adam steps, 10 DBA iterations):
   median wall time of the step, and a per-stage split.

The last lines are a JSON summary of the kernels, the card's name and power
limit, and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time

import numpy as np

S, M, R, T_HIST, T_SSP, R_OBS = 7, 16, 29, 165, 86, 200
PARITY_DEGC = 0.01  # f32-vs-f64 gate on barycentre moments (bench.py's gate)
# Adam steps of the f32-kernels vs f64-plain comparison: the f64 run of the
# plain versions on the CPU takes about 2 minutes at 500 steps.
PARITY_NITS = 500
TIMING_NITS, TIMING_REPS = 2000, 3  # the faithful workload; median of 3 after a warm-up
LINALG_TOL = 1e-3  # float32 kernel vs float32 plain version, relative to the largest entry


def log(*a):
    print(*a, flush=True)


def _ar1(rng, shape, phi, sd):
    eps = rng.normal(0.0, sd * np.sqrt(1.0 - phi * phi), size=shape)
    out = np.empty(shape)
    out[..., 0] = rng.normal(0.0, sd, size=shape[:-1])
    for k in range(1, shape[-1]):
        out[..., k] = phi * out[..., k - 1] + eps[..., k]
    return out


def synthetic_flagship(seed, s=S, m=M, r=R, t_hist=T_HIST, t_ssp=T_SSP, r_obs=R_OBS):
    """GMST-anomaly-like blocks of the flagship shape, from a seed.

    Each model has a climate sensitivity and an offset; realisations add
    AR(1) internal variability; each scenario warms at its own rate after the
    historical period.  Realisation counts are ragged (2 to r) and zero
    padded; scenarios with fewer than ``m`` models are padded with
    ``pad_models``.  The observations are ``r_obs`` members around the
    forced historical response.
    """
    from bayesian_ensembling_tpu_torch import pad_models

    rng = np.random.default_rng(seed)
    forced_h = 1.2 * (np.arange(t_hist) / (t_hist - 1)) ** 3 - 0.1
    hb = np.zeros((s, m, r, t_hist))
    sb = np.zeros((s, m, r, t_ssp))
    hm = np.zeros((s, m, r), bool)
    mm = np.zeros((s, m))
    for si in range(s):
        m_real = m if si == 0 else int(rng.integers(m - 4, m + 1))
        sens = rng.normal(1.0, 0.2, m_real)[:, None, None]
        offset = rng.normal(0.0, 0.15, m_real)[:, None, None]
        rate = 0.005 + 0.035 * si / max(s - 1, 1)  # degC per year after the historical period
        forced_s = forced_h[-1] + rate * np.arange(1, t_ssp + 1)
        h = sens * forced_h + offset + _ar1(rng, (m_real, r, t_hist), 0.6, 0.12)
        p = sens * forced_s + offset + _ar1(rng, (m_real, r, t_ssp), 0.6, 0.12)
        # At least two realisations: a single one gets the 1e-8 noise floor,
        # and the float32 Cholesky of its 1-D Matern Gram fails (NaN) in the
        # JAX package and in the port alike.
        counts = rng.integers(2, r + 1, m_real)
        if si == 0:
            counts[0], counts[-1] = 2, r
        mask = np.arange(r)[None, :] < counts[:, None]
        h[~mask] = 0.0
        p[~mask] = 0.0
        hb[si], hm[si], mm[si] = pad_models(h, mask, m)
        sb[si], _, _ = pad_models(p, mask, m)
    obs = forced_h + _ar1(rng, (r_obs, t_hist), 0.6, 0.05)
    return hb, hm, sb, hm.copy(), obs, mm


def _nvidia_smi():
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return proc.stdout.strip().splitlines()[0]


def _cuda_ms(torch, fn, reps):
    """Mean device time of ``fn`` over ``reps`` launches after one warm-up."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def _wall(torch, fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0, out


def _rel(got, want):
    got, want = got.double().cpu(), want.double().cpu()
    return (got - want).abs().max().item() / max(1.0, want.abs().max().item())


def _abs(got, want):
    return (got.double().cpu() - want.double().cpu()).abs().max().item()


def _matern_spd(torch, x, noise, dev):
    """Matern-3/2 Grams (lengthscale 1, variance 1) of the features plus noise."""
    from bayesian_ensembling_tpu_torch.ops import gp as gp_ops

    params = gp_ops.init_params(x.shape[0], device=dev, dtype=torch.float32)
    pre, apply_fn = gp_ops.get_kernel_precomputed("matern32")
    with torch.no_grad():
        k = apply_fn(params, pre(x, x))
    return (k + torch.diag_embed(noise)).contiguous()


def check_kernels(torch, inputs, dev, report):
    """Phase 3: each kernel against its plain version at the slice's shapes."""
    from bayesian_ensembling_tpu_torch.ops import dtw_cuda
    from bayesian_ensembling_tpu_torch.ops import linalg_cuda as lc

    hb, hm, sb, sm, _, _ = inputs
    rng = np.random.default_rng(1)
    ok = True
    for name, block, mask in (("hist", hb, hm), ("ssp", sb, sm)):
        t = block.shape[-1]
        series = torch.tensor(block.reshape(-1, t), dtype=torch.float32, device=dev)
        w = torch.tensor(mask.reshape(-1, R), dtype=torch.float32, device=dev)
        b3 = torch.tensor(block.reshape(-1, R, t), dtype=torch.float32, device=dev)
        centers = (b3 * w[:, :, None]).sum(1) / w.sum(1, keepdim=True).clamp(min=1.0)
        centers = centers.repeat_interleave(R, dim=0).contiguous()
        n = series.shape[0]

        got = dtw_cuda.dba_update_batch(centers, series)
        want = dtw_cuda.dba_update_batch_reference(centers, series)
        torch.cuda.synchronize()
        exact = torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        err = max(_abs(got[0], want[0]), _abs(got[1], want[1]))
        ms = _cuda_ms(torch, lambda: dtw_cuda.dba_update_batch(centers, series), 20)
        plain_ms = _cuda_ms(torch, lambda: dtw_cuda.dba_update_batch_reference(centers, series), 2)
        log(f"  dba_update N={n} T={t}: exact={exact} max_abs_err={err:.3e} "
            f"kernel {ms:.4f} ms, plain {plain_ms:.3f} ms")
        ok &= exact
        report["dba_update"].append(dict(t=t, err=err, ms=ms, plain_ms=plain_ms))

        # B2 / B3 on Matern Grams of this collection's features plus noise.
        b = block.shape[0] * block.shape[1]
        x = b3.transpose(1, 2).contiguous()
        noise = torch.tensor(rng.uniform(0.005, 0.05, (b, t)), dtype=torch.float32, device=dev)
        ky = _matern_spd(torch, x, noise, dev)
        y = torch.tensor(rng.normal(size=(b, t)), dtype=torch.float32, device=dev)
        got = lc.chol_solve(ky, y)
        want = lc.chol_solve_reference(ky, y)
        exact64 = lc.chol_solve_reference(ky.double(), y.double())
        torch.cuda.synchronize()
        rels = [_rel(g, w_) for g, w_ in zip(got, want)]
        err = max(_abs(g, w_) for g, w_ in zip(got, want))
        vs64 = (max(_rel(g, e) for g, e in zip(got, exact64)),
                max(_rel(w_, e) for w_, e in zip(want, exact64)))
        ms = _cuda_ms(torch, lambda: lc.chol_solve(ky, y), 50)
        plain_ms = _cuda_ms(torch, lambda: lc.chol_solve_reference(ky, y), 10)
        log(f"  chol_solve B={b} T={t}: rel err (L, z, alpha, logdet) = "
            + ", ".join(f"{e:.2e}" for e in rels)
            + f" (tol {LINALG_TOL}); vs f64: kernel {vs64[0]:.2e}, plain {vs64[1]:.2e}; "
            f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
        ok &= max(rels) < LINALG_TOL
        report["chol_solve"].append(dict(t=t, err=err, ms=ms, plain_ms=plain_ms))

        l = want[0].contiguous()  # torch.linalg returns a column-major factor
        got_w = lc.tri_inv(l)
        want_w = lc.tri_inv_reference(l)
        exact_w = lc.tri_inv_reference(l.double())
        torch.cuda.synchronize()
        rel = _rel(got_w, want_w)
        err = _abs(got_w, want_w)
        ms = _cuda_ms(torch, lambda: lc.tri_inv(l), 50)
        plain_ms = _cuda_ms(torch, lambda: lc.tri_inv_reference(l), 10)
        log(f"  tri_inv B={b} T={t}: rel err {rel:.2e} (tol {LINALG_TOL}); vs f64: kernel "
            f"{_rel(got_w, exact_w):.2e}, plain {_rel(want_w, exact_w):.2e}; "
            f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
        ok &= rel < LINALG_TOL
        report["tri_inv"].append(dict(t=t, err=err, ms=ms, plain_ms=plain_ms))

        bad = ky.clone()
        bad[5] = -torch.eye(t, device=dev)
        _, _, alpha, logdet = lc.chol_solve(bad, y)
        torch.cuda.synchronize()
        nan_ok = bool(torch.isnan(logdet[5]) and torch.isnan(alpha[5]).all()
                      and torch.isfinite(logdet[:5]).all() and torch.isfinite(alpha[6:]).all())
        log(f"  chol_solve non-PD input at T={t} gives NaN only there: {nan_ok}")
        ok &= nan_ok
    return ok


def run_slice(torch, bt, inputs, dev, dtype, nits):
    tensors = [torch.tensor(a, dtype=torch.bool if a.dtype == bool else dtype, device=dev)
               for a in inputs]
    return bt.ensemble_multi_scenario_step(*tensors, n_optim_nits=nits, dba_iterations=10)


def stage_split(torch, bt, inputs, dev, nits):
    """Wall time of each stage of one faithful step, run stage by stage."""
    from bayesian_ensembling_tpu_torch.ops import gp as gp_ops

    hb, hm, sb, sm, obs, mm = (
        torch.tensor(a, dtype=torch.bool if a.dtype == bool else torch.float32, device=dev)
        for a in inputs
    )
    times = {"dba": 0.0, "fit": 0.0, "posterior": 0.0, "tail": 0.0}
    marg = []
    for block, mask in ((hb, hm), (sb, sm)):
        b3, m2 = block.reshape(S * M, R, -1), mask.reshape(S * M, R)
        dt, (x, y, v) = _wall(torch, lambda: gp_ops.prepare_gp_inputs(b3, m2, dba_iterations=10))
        times["dba"] += dt
        dt, (params, _) = _wall(torch, lambda: gp_ops.fit_gp_batch(x, y, v, n_optim_nits=nits))
        times["fit"] += dt
        dt, (mu, var) = _wall(torch, lambda: gp_ops.posterior_marginals_batch(params, x, y, v))
        times["posterior"] += dt
        marg.append((mu.reshape(S, M, -1), (var + v).reshape(S, M, -1)))
    (hmu, hvar), (smu, svar) = marg
    dt, _ = _wall(torch, lambda: bt.multi_scenario_tail(hmu, hvar, smu, svar, obs, hb, hm, mm))
    times["tail"] += dt
    return times


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0, help="seed of the synthetic inputs")
    args = ap.parse_args(argv)

    import torch

    # Phase 1: device.
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script needs an NVIDIA GPU",
              file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    smi = _nvidia_smi()
    log(f"[device] {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")
    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
            torch.get_float32_matmul_precision())
    log(f"[device] matmul.allow_tf32={tf32[0]} cudnn.allow_tf32={tf32[1]} "
        f"float32_matmul_precision={tf32[2]}")
    if tf32[0] or tf32[2] != "highest":
        print("chip_smoke: float32 matmuls are not full float32", file=sys.stderr)
        return 1

    import bayesian_ensembling_tpu_torch as bt
    from bayesian_ensembling_tpu_torch import _build

    # Phase 2: build.
    t0 = time.perf_counter()
    _build.library()
    log(f"[build] {_build.build_info['path']} in {time.perf_counter() - t0:.1f} s")
    for line in _build.build_info["log"].splitlines():
        if "Used" in line or "Compiling entry" in line:
            log(f"[build]   {line.strip()}")

    inputs = synthetic_flagship(args.seed)
    counts = inputs[1].sum(axis=2)
    log(f"[inputs] S={S} M={M} R={R} T={T_HIST}/{T_SSP} R_obs={R_OBS}; realisations per model "
        f"{counts[counts > 0].min()}..{counts.max()}; real models per scenario "
        f"{inputs[5].sum(axis=1).astype(int).tolist()}")

    # Phase 3: kernels against their plain versions.
    report = {"dba_update": [], "chol_solve": [], "tri_inv": []}
    log("[kernels]")
    if not check_kernels(torch, inputs, dev, report):
        print("chip_smoke: a kernel disagrees with its plain version", file=sys.stderr)
        return 1

    # Phase 4: the slice through the kernels, then the f64 plain reference.
    bt.reset_launch_counts()
    dt, (bm, bs, w) = _wall(torch, lambda: run_slice(torch, bt, inputs, dev, torch.float32,
                                                     PARITY_NITS))
    launches = bt.launch_counts()
    expected = {"dba_update": 2 * 10, "chol_solve": 2 * (PARITY_NITS + 1),
                "tri_inv": 2 * (PARITY_NITS + 1)}
    log(f"[slice] f32 on the card, {PARITY_NITS} Adam steps: {dt:.2f} s; "
        f"launches {launches} (expected {expected})")
    wsum = w.double().sum(dim=1)
    finite = all(bool(torch.isfinite(a).all()) for a in (bm, bs, w))
    if launches != expected or not finite or (wsum - 1.0).abs().max().item() > 1e-5:
        print(f"chip_smoke: slice check failed (finite={finite}, weight sums {wsum.tolist()})",
              file=sys.stderr)
        return 1
    t0 = time.perf_counter()
    ref = run_slice(torch, bt, inputs, torch.device("cpu"), torch.float64, PARITY_NITS)
    ref_s = time.perf_counter() - t0
    dmean = _abs(bm, ref[0])
    dstd = _abs(bs, ref[1])
    dw = _abs(w, ref[2])
    log(f"[slice] f64 plain on the CPU: {ref_s:.1f} s; max |dmean| {dmean:.3e} degC, "
        f"max |dstd| {dstd:.3e} degC (gate {PARITY_DEGC}), max |dweight| {dw:.3e}")
    log(f"[slice] 2100 barycentre by scenario: "
        + ", ".join(f"{m_:.3f}+-{s_:.3f}" for m_, s_ in zip(bm[:, -1].tolist(), bs[:, -1].tolist())))
    if not (dmean < PARITY_DEGC and dstd < PARITY_DEGC):
        print("chip_smoke: f32 kernel path disagrees with the f64 plain path", file=sys.stderr)
        return 1

    # Phase 5: the faithful workload.
    walls = []
    for rep in range(TIMING_REPS + 1):
        dt, out = _wall(torch, lambda: run_slice(torch, bt, inputs, dev, torch.float32,
                                                 TIMING_NITS))
        log(f"[timing] {'warm-up' if rep == 0 else f'run {rep}'}: {dt:.3f} s")
        if rep:
            walls.append(dt)
    if not all(bool(torch.isfinite(a).all()) for a in out):
        print("chip_smoke: the timed run gave non-finite output", file=sys.stderr)
        return 1
    split = stage_split(torch, bt, inputs, dev, TIMING_NITS)
    per_step = split["fit"] / (2 * TIMING_NITS) * 1e3
    # One chol_solve and one tri_inv per Adam step, averaged over the two collections.
    kern = sum(r["ms"] for name in ("chol_solve", "tri_inv") for r in report[name]) / 2
    log(f"[timing] {TIMING_NITS} Adam steps, 10 DBA iterations, S*M={S * M}: median "
        f"{statistics.median(walls):.3f} s over {len(walls)} runs; stages " + ", ".join(
            f"{k} {v:.3f} s" for k, v in split.items()))
    log(f"[timing] fit: {per_step:.3f} ms per Adam step and collection, of which the two linalg "
        f"kernels take {kern:.3f} ms (the rest is launch overhead and small ops)")

    src = {
        "dba_update": ("bayesian_ensembling_tpu_torch/csrc/dba_update.cu",
                       "bayesian_ensembling_tpu/ops/dtw_pallas.py:337"),
        "chol_solve": ("bayesian_ensembling_tpu_torch/csrc/chol_solve.cu",
                       "bayesian_ensembling_tpu/ops/linalg_pallas.py:247"),
        "tri_inv": ("bayesian_ensembling_tpu_torch/csrc/tri_inv.cu",
                    "bayesian_ensembling_tpu/ops/linalg_pallas.py:414"),
    }
    kernels = []
    for name, (source, replaces) in src.items():
        main_shape = report[name][0]  # T = 165, the historical collection
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[name],
            "max_abs_err": max(r["err"] for r in report[name]),
            "ms": main_shape["ms"], "plain_ms": main_shape["plain_ms"],
        })
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
