#!/usr/bin/env python3
"""Smoke run of the PyTorch port (bayesian_ensembling_tpu_torch) on one NVIDIA GPU.

Run from the repository root:

    python3 chip_smoke.py [--seed 0]

Phases, in order; any failure exits non-zero:

1. Device: CUDA must be present; prints the card, torch/CUDA versions and
   the TF32 flags (float32 matmuls must run in full float32).
2. Build: compiles the CUDA kernels in ``bayesian_ensembling_tpu_torch/csrc``
   with nvcc for sm_90a (into ``build/torch_kernels/``) and loads them.
3. Kernels against their plain PyTorch versions at the main paths' shapes:
   the squared-DTW cost (exact, float32 and float64: the subgradient DBA's
   epoch cost, N = 3,248 at T = 165 and 86; the medoid init's pairs,
   N = 45,472 at T = 165; the monthly N = 812 at T = 1980; T = 1), the DBA
   update (N = 3,248 pairs, T = 165 and 86, exact; and the subgradient
   step's N = 112), the fused Cholesky-solve (B = 112 and the library path's
   B = 16) and the triangular inverse (B = 112, T = 165 and 86 in float32,
   T = 165 in float64 too, each beside ``solve_triangular``), and one
   non-positive-definite input that must come back NaN; then the monthly
   path's kernels: the split DBA update (exact, float32 and float64, at the
   monthly collections' N and T = 1980 / 1032, with NaN pairs, and against
   the fused kernel at T = 165), the Cholesky and the triangular inverse at
   the blocked NLML's leaves (B = 65, T = 128; the Cholesky with a
   non-positive-definite slot), the blocked NLML in float32 against
   torch.linalg in float64 at the campaign's two fits (B = 65, T = 1032;
   B = 28, T = 1980), and both routes' times there (the whole table that
   the linalg_path thresholds are decided from is
   ``utils/linalg_route_times.py``'s); then the vector solve
   (given L: z, alpha, log-determinant) in float32 and float64 at the
   library path's shapes (B = 16, T = 165 and 86, where the Cholesky
   kernel is held against its plain version too; B = 1, T = 165, the
   launch of FullCovGaussian.log_prob) and at the shapes where
   the fused kernel and the library route do the same work today
   (B = 112, T = 165, where Cholesky + vector solve must also equal the
   fused Cholesky-solve; B = 65, T = 1032; B = 28, T = 1980: the streamed
   layout), each also as the forward-only launch the library's scores
   make (z and the log-determinant bit for bit the full launch's), with a
   zero and a negative diagonal entry that must come through untrapped.
4. The slice: ``ensemble_multi_scenario_step`` on synthetic GMST-like inputs
   of the flagship shape (7 SSPs x 16 padded models x 29 ragged
   realisations, T = 165 / 86, 200 observation members), float32 on the card
   through the kernels, with every launch counter checked; then the same
   inputs in float64 through the plain versions on the CPU, and the
   barycentre mean and std must agree within 0.01 degC pointwise.  At the
   float32 run's marginals (recomputed through ``emulate_marginals``, which
   must give the step's output bit for bit), the tail of every weight kind
   on the card against float64 on the CPU (weights within 1e-4, moments
   within 0.01 degC), and ``refined_multi_scenario_f64`` on the card
   against the CPU at the fitted hyperparameters and targets (1e-5 degC).
5. Timing of the faithful workload (2,000 Adam steps, 10 DBA iterations):
   the wall time of one run after a warm-up, and a per-stage split.
6. The native-monthly dedup campaign, ``run_dedup_campaign``, on synthetic
   inputs of its full width (20 unique historical models at T = 1980, 7
   scenarios with 65 SSP fits at T = 1032 padded to M = 16, 3 to 29
   realisations, 200 observation members) at the production monthly
   settings (500 Adam steps, 10 DBA iterations, historical chunks of 28):
   float32 on the card with every launch and route counter checked, then
   float64 on the card (the library route for every fit) as the reference,
   within 0.01 degC; then the wall time of one more float32 run and a
   per-stage split.
7. The reference-faithful DBA: the step with the subgradient DBA (50
   epochs, tol 1e-3) at the flagship shape, float32 against float64 on the
   card (0.01 degC), with the DTW cost and DBA-update launches checked
   against the epochs ``dba_subgradient_batch`` reports; the medoid
   ``dba_batch`` float32 against float64 (one cost launch, 10 updates);
   then the wall time of the subgradient step at 2,000 Adam steps (one run
   after a warm-up) and its DBA stage.
8. The bench's fast fit routes at the flagship shape: coarse-to-fine in
   time (stride 12, 1,000 coarse and 250 fine steps) against float64 on the
   card (0.01 degC); the per-model BFGS at 30 steps, whose distance to a
   10,000-step Adam truth may be at most 1.05 times the 2,000-step Adam
   run's (where it is not, the rule must hold once the models that the
   BFGS strands on the plateau of ROADMAP C7 take the truth's fits, and
   the script names them); the chunked fit (chunks of 250) against phase 4's merged fit, bit
   for bit; the wall time of one run of each after a warm-up.

9. The library API at full width: the flagship inputs as ``ProcessModel`` /
   ``ModelCollection`` objects (12 to 16 real models per scenario,
   unpadded, yearly time coordinates), ``run_scenario`` with
   ``LogLikelihoodWeight`` on the full-covariance ``GPDTW1D`` posteriors
   for all 7 scenarios in float32 on the card (500 Adam steps), every
   launch and route counter of every scenario checked (the Cholesky kernel
   once and the vector solve twice per scenario); the same in float64 on
   the card (0.01 degC on the barycentre); every other weighter, option,
   scheme and sigma mode at one scenario's float32 posteriors, card
   float32 against CPU float64; ``CRPSWeight`` through ``run_scenario``
   against phase 4's fused step for scenario 0 (0.01 degC); the wall time
   of one run after the checked one, and the share of fit, weights and
   scheme.

10. The gridded surface at the 5-degree north-star grid of
   ``benchmarks/gridded_bench.py`` (5 models x 36 x 72 cells x 10
   realisations x 86 annual steps, 10 observation members: 12,960 GP fits;
   the inputs from a copy of ``benchmarks/gridded_common.make_workload_cells``):
   B1 at N = 129,600 pairs and B2 / B3 at B = 12,960 and 2,592 matrices
   against their plain versions on sampled rows, timed beside their bounds;
   ``gridded_ensemble_step`` at the gridded fast profile (scratch bfgs-30),
   float32 on the card, a warm-up (which counts the step's host
   synchronisations) and the median of 3 runs, every launch and route
   counter checked, the peak device memory, a stage split and one
   profiler window over the fit (the card's busy share); the first 64
   cells' barycentre within 1e-3 of the JAX package's float64 moments in
   ``benchmarks/gridded_oracle.json`` (bfgs-30); ``refined_gridded_f64`` of
   the whole grid on the card against float64 plain on the CPU (64 cells,
   1e-5); Adam-500 on the first 64 cells and the coarse-to-fine warm start
   (stride 5, bfgs-30 coarse, bfgs-20 fine) against their oracle entries
   (1e-3); ``run_gridded_scenario`` over five ``ProcessModel`` objects of
   (10, 86, 36, 72) (CRPS, float32, 500 Adam steps), float32 against
   float64 on an 8 x 8 sub-grid (0.01 degC), with ``LogLikelihoodWeight``
   (no Cholesky or vector-solve launch: the posteriors are diagonal); and
   ``GPDTW3D(mode="svgp")`` on the 8 x 8 sub-grid, float64, card against
   CPU (1e-3 degC).

11. The perfect-model test and serving, on phase 9's float32 posteriors
   (the campaign CLI's ``--batched --prefit-dir`` form): ``batched_pmt``
   for all 7 scenarios x the 5 batched weight kinds under the campaign's
   shape bucket ``pad_shape = (16, 29)`` (and the compat and mixture sigma
   modes and ``include_sim`` for CRPS on scenario 0), float32 on the card
   against float64 on the CPU at the same posteriors (rmse, w2 and crps
   within 1e-3 degC, nll within 1e-3 relative), every call's launches
   checked (the loglik table: one Cholesky and two vector solves); padded
   against unpadded on the smallest scenario; the fold loop
   (``PerfectModelTest.run(use_prefit_models=True)``'s folds, a Cholesky
   and two vector solves each) against ``batched_pmt`` on the largest
   scenario (1e-4 relative); the loop with fresh ``GPDTW1D`` fits per fold
   (16 folds x 3 fits, 500 Adam steps: phase 9's depth, cut from the CLI's
   1,000), float32 against float64 on the card (0.01 degC on rmse, w2 and
   crps; nll printed), every launch counter checked and the run timed;
   then ``serve.ProjectionService.from_results`` on phase 9's results, a
   save / load round trip and an HTTP server on a localhost port answering
   a projection, a trajectory and a bad query (400), each held against the
   barycentre moments; and ``serve.build_gridded_artifacts`` at its
   defaults (12 x 24 cells, 5 models, 10 realisations, T = 86, 500 Adam
   steps) with its launch counters, ``project_point`` at every cell and
   ``map_grid`` held against the posterior it served.

12. The sharded surfaces (``parallel/mesh.py``) through a one-rank NCCL
   process group and CUDA device meshes: ``make_sharded_multi_scenario_step``
   on a (scenario 1, model 1) mesh at phase 4's width and depth,
   ``make_sharded_dedup_campaign`` on a ("model",) mesh at phase 6's campaign
   (historical chunks of 28), and ``make_sharded_gridded_step`` on a
   (model 1, cells 1) mesh at phase 10's grid (bfgs-30); on one rank every
   collective returns its input, so each must equal its earlier phase's
   float32 output bit for bit (the largest difference is printed beside the
   gate), with the collective counts of ``benchmarks/collective_audit.json``
   (3 all-reduces a step; the campaign's 2 gathers) and the earlier phase's
   launch and route counts.  Then whether gloo takes CUDA tensors for each
   collective of these paths, and if it does, ``make_sharded_step`` on
   scenario 0 (16 models, 500 Adam steps) as two gloo ranks sharing the
   card, against one rank within 1e-5 degC.  Each surface is timed once.

13. ``optimizer="lbfgs"`` (optax's L-BFGS: one zoom line search for each
   fit's summed objective): scenario 0 through ``ensemble_scenario_step``
   (30 steps a fit) in float64 on the card and on the CPU, with equal
   line-search counts at every step, the summed objective within 1e-9
   relative at every step and the barycentre within 1e-5 degC; the full
   flagship through ``ensemble_multi_scenario_step`` at 150 steps in
   float32, every launch and route counter against the evaluations the
   line search reports, every step's objective finite, one run timed
   after a warm-up with its evaluations and host synchronisations a step,
   and its distance to phase 8's truth printed beside Adam-2000's and
   bfgs-30's; the same in float64 on the card (0.01 degC); and
   ``run_scenario(optimizer="lbfgs")`` for scenario 0 (30 steps), float32
   against float64 on the card (0.01 degC).

14. The port's four examples (``bayesian_ensembling_tpu_torch/examples``:
   quickstart, monthly_warm, gridded_quickstart, gridded_refined) on the
   card in float32, each against its own float64 run on the CPU (0.01 degC
   on the numbers it prints), each launching the DBA update, the fused
   Cholesky-solve and the triangular inverse.

The last lines are a JSON summary of the kernels, the card's name and power
limit, and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time
import warnings

import numpy as np

S, M, R, T_HIST, T_SSP, R_OBS = 7, 16, 29, 165, 86, 200
PARITY_DEGC = 0.01  # f32-vs-f64 gate on barycentre moments (bench.py's gate)
# Adam steps of the f32-kernels vs f64-plain comparison: the f64 run of the
# plain versions on the CPU takes about 2 minutes at 500 steps.
PARITY_NITS = 500
# The faithful workload; timed runs after a warm-up.  One run: the host
# sets these host-bound times and drifts up to 2x between calls (ROADMAP
# C9), so medians of 3 told no more, and the script must finish within its
# 1,200 s on a slow host (PERF.md section 5).
TIMING_NITS, TIMING_REPS = 2000, 1
LINALG_TOL = 1e-3  # float32 kernel vs float32 plain version, relative to the largest entry
LINALG_TOL_F64 = 1e-10  # float64 kernel vs float64 plain version: another summation order

# The native-monthly campaign (benchmarks/monthly_bench.py all): 20 unique
# historical models, 7 scenarios with 65 real SSP fits padded to M = 16.
N_HIST_MODELS, SSP_MODELS = 20, (16, 12, 9, 8, 7, 7, 6)
T_HIST_M, T_SSP_M, HIST_CHUNK = 1980, 1032, 28
MONTHLY_NITS, MONTHLY_REPS = 500, 1  # timed runs after the checked one
# float32 blocked NLML vs float64 torch.linalg at (65, 1032) and (28, 1980),
# relative to the largest entry: float32 round-off of the Cholesky of a Gram
# whose condition number is about 1e5 (T / noise).
BLOCKED_TOL = 1e-2

# The reference-faithful DBA (the flagship's subgradient DBA, 50 epochs) and
# the bench's fast fit routes (bench.py:353-410).
SUBGRADIENT_EPOCHS = 50
WARM_NITS, WARM_KW = 1000, dict(time_stride=12, fine_steps=250)
BFGS_NITS, BFGS_KW = 30, dict(optimizer="bfgs")
TRUTH_NITS = 10_000  # the converged truth of the bfgs closeness gate
BFGS_SLACK = 1.05
CHUNK_STEPS = 250
WEIGHT_TOL = 1e-4  # float32 tail vs float64 at the same marginals
REFINED_DEGC = 1e-5  # refined moments, card vs CPU (bench.py:539)
LIBRARY_NITS, LIBRARY_REPS = 500, 1  # phase 9: run_scenario's fit depth; timed runs

# Peak rates of one H100 SXM (NVIDIA's data sheet) for the kernels' bounds.
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12

# The previous designs of the fused Cholesky-solve (one barrier per column of
# the backward substitution, the forward hook in one warp), of the split DBA
# update (one barrier per anti-diagonal, a byte per move code), and of the
# fused DBA update and the squared-DTW cost (the same), in ms,
# float32 unless marked, on one H100 80GB HBM3 at 700 W (PERF.md section 6),
# printed beside this run's times; and the monthly campaign's peak device
# memory with byte-wide move codes (PERF.md section 5).
PREVIOUS_MS = {("chol_solve", 112, 165): 0.0810, ("chol_solve", 112, 86): 0.0535,
               ("chol_solve_f64", 112, 165): 0.1047,
               ("dba_update_split", 812, 1980): 8.838, ("dba_update_split", 1885, 1032): 7.229,
               # One thread a row and a block barrier an anti-diagonal, byte-wide move
               # codes and a one-thread traceback (the DBA update).
               ("dba_update", 112, 165): 0.0548, ("dba_update", 112, 86): 0.0385,
               ("dba_update", 3248, 165): 0.3447,
               ("dtw_cost", 3248, 165): 0.378, ("dtw_cost", 45472, 165): 4.997,
               ("dtw_cost", 812, 1980): 5.681,
               # L read from device memory in the chain, twice, one block a matrix
               # (the vector solve, float32).
               ("solve_vec", 16, 165): 0.0528, ("solve_vec", 16, 86): 0.0346,
               ("solve_vec", 112, 165): 0.0532, ("solve_vec", 65, 1032): 0.4400,
               ("solve_vec", 28, 1980): 1.0037}
PREVIOUS_PEAK_GIB = 6.02


def _previous(key):
    ms = PREVIOUS_MS.get(key)
    return f" (previous design {ms} ms)" if ms is not None else ""


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


def _bound(n_bytes, n_ops):
    """(least time in ms, what bounds it): the bytes over the memory rate or
    the float32 operations over the peak rate, whichever is larger."""
    by_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    by_ops = n_ops / FP32_OPS_PER_S * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def _dba_work(n, t, e=4):
    """Centres and series read, sums and counts written; per cell of the DP a
    subtract, a multiply, an add and two comparisons."""
    return 4 * n * t * e, 5 * n * t * t


def _cost_work(n, t, e=4):
    """Centres and series read, one cost written; 5 operations per DP cell,
    as for the DBA update."""
    return (2 * n * t + n) * e, 5 * n * t * t


def _triangle_work(b, t, e=4):
    """The Cholesky (K to L) or the triangular inverse (L to W): the lower
    triangle of one T x T matrix read (all either kernel reads) and the whole
    T x T result written (zeros above the diagonal included), T^3/3 flops
    per matrix."""
    return b * (t * (t + 1) // 2 + t * t) * e, b * t ** 3 / 3


def _chol_solve_work(b, t, e=4):
    """K and y read; L, z, alpha and log|K| written; T^3/3 flops for the
    factor and T^2 for each of the two triangular solves."""
    return b * (2 * t * t + 4 * t + 1) * e, b * (t ** 3 / 3 + 2 * t * t)


def _solve_vec_work(b, t, e=4):
    """The lower triangle of L and y read; z, alpha and log|LL^T| written;
    T^2 flops for each of the two substitutions."""
    return b * (t * (t + 1) // 2 + 3 * t + 1) * e, b * 2 * t * t


def _solve_vec_forward_work(b, t, e=4):
    """The forward-only launch: the lower triangle of L and y read; z and
    log|LL^T| written; T^2 flops for the one substitution."""
    return b * (t * (t + 1) // 2 + 2 * t + 1) * e, b * t * t


def _matern_spd(torch, x, noise, dev):
    """Matern-3/2 Grams (lengthscale 1, variance 1) of the features plus noise."""
    from bayesian_ensembling_tpu_torch.ops import gp as gp_ops

    params = gp_ops.init_params(x.shape[0], device=dev, dtype=torch.float32)
    pre, apply_fn = gp_ops.get_kernel_precomputed("matern32")
    with torch.no_grad():
        k = apply_fn(params, pre(x, x))
    return (k + torch.diag_embed(noise)).contiguous()


def _check_dba(torch, dtw_cuda, centers, series, reps, impl="fused"):
    """One DBA-update kernel against its plain version, bit for bit, and
    timed; returns the report row."""
    n, t = series.shape
    name = "dba_update" if impl == "fused" else "dba_update_split"
    got = dtw_cuda.dba_update_batch(centers, series, impl=impl)
    want = dtw_cuda.dba_update_batch_reference(centers, series)
    torch.cuda.synchronize()
    exact = torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    err = max(_abs(got[0], want[0]), _abs(got[1], want[1]))
    del got, want
    ms = _cuda_ms(torch, lambda: dtw_cuda.dba_update_batch(centers, series, impl=impl), reps)
    plain_ms = _cuda_ms(torch, lambda: dtw_cuda.dba_update_batch_reference(centers, series), 1)
    work = _dba_work(n, t, centers.element_size())
    bound_ms, bound_by = _bound(*work)
    f64 = centers.dtype == torch.float64
    log(f"  {name} N={n} T={t}{' f64' if f64 else ''}: exact={exact} max_abs_err={err:.3e} kernel "
        f"{ms:.4f} ms{'' if f64 else _previous((name, n, t))}, plain {plain_ms:.3f} ms, bound "
        f"{bound_ms:.5f} ms ({bound_by})")
    return dict(t=t, n=n, err=err, ms=ms, plain_ms=plain_ms, work=work, library_ms=None,
                exact=exact)


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

        # The classic DBA's shape (N = B*R = 3,248 pairs a launch), then the
        # subgradient DBA's (one realisation of each of the B = 112 models
        # against its centre, 1,189 launches a step), in float32 and float64.
        sub_c, sub_s = centers[::R].contiguous(), series[::R].contiguous()
        for c_, s_, reps in ((centers, series, 20), (sub_c, sub_s, 200)):
            for dtype in (torch.float32, torch.float64):
                row = _check_dba(torch, dtw_cuda, c_.to(dtype), s_.to(dtype), reps)
                ok &= row["exact"]
                if dtype == torch.float32:
                    report["dba_update"].append(row)

        # B2 / B3 on Matern Grams of this collection's features plus noise,
        # in float32 and, at the historical shape, in float64 too (the
        # Grams are the float32 ones, widened).
        b = block.shape[0] * block.shape[1]
        x = b3.transpose(1, 2).contiguous()
        noise = torch.tensor(rng.uniform(0.005, 0.05, (b, t)), dtype=torch.float32, device=dev)
        ky32 = _matern_spd(torch, x, noise, dev)
        y32 = torch.tensor(rng.normal(size=(b, t)), dtype=torch.float32, device=dev)
        for dtype in (torch.float32, torch.float64) if t == T_HIST else (torch.float32,):
            ky, y = ky32.to(dtype), y32.to(dtype)
            f32 = dtype == torch.float32
            tol, tag, suffix = (LINALG_TOL, "", "") if f32 else (LINALG_TOL_F64, " f64", "_f64")
            e = ky.element_size()
            got = lc.chol_solve(ky, y)
            want = lc.chol_solve_reference(ky, y)
            exact64 = lc.chol_solve_reference(ky.double(), y.double())
            torch.cuda.synchronize()
            rels = [_rel(g, w_) for g, w_ in zip(got, want)]
            err = max(_abs(g, w_) for g, w_ in zip(got, want))
            vs64 = (max(_rel(g, e_) for g, e_ in zip(got, exact64)),
                    max(_rel(w_, e_) for w_, e_ in zip(want, exact64)))
            ms = _cuda_ms(torch, lambda: lc.chol_solve(ky, y), 50)
            plain_ms = _cuda_ms(torch, lambda: lc.chol_solve_reference(ky, y), 10)
            log(f"  chol_solve{tag} B={b} T={t}: rel err (L, z, alpha, logdet) = "
                + ", ".join(f"{r_:.2e}" for r_ in rels)
                + f" (tol {tol}); vs f64: kernel {vs64[0]:.2e}, plain {vs64[1]:.2e}; "
                f"kernel {ms:.4f} ms{_previous(('chol_solve' + suffix, b, t))}, plain {plain_ms:.4f} ms")
            ok &= max(rels) < tol
            report["chol_solve" + suffix].append(dict(t=t, err=err, ms=ms, plain_ms=plain_ms,
                                                      work=_chol_solve_work(b, t, e), library_ms=None))
            # The library path's shape: one scenario's M = 16 models a launch.
            k16, y16 = ky[:M].contiguous(), y[:M].contiguous()
            got16 = lc.chol_solve(k16, y16)
            want16 = [w_[:M] for w_ in want]
            torch.cuda.synchronize()
            rel16 = max(_rel(g, w_) for g, w_ in zip(got16, want16))
            ms16 = _cuda_ms(torch, lambda: lc.chol_solve(k16, y16), 50)
            work = _chol_solve_work(M, t, e)
            bound_ms, bound_by = _bound(*work)
            log(f"  chol_solve{tag} B={M} T={t} (library path): rel err {rel16:.2e} (tol {tol}); kernel "
                f"{ms16:.4f} ms, bound {bound_ms:.5f} ms ({bound_by})")
            ok &= rel16 < tol

            l = want[0].contiguous()  # torch.linalg returns a column-major factor
            got_w = lc.tri_inv(l)
            want_w = lc.tri_inv_reference(l)
            exact_w = lc.tri_inv_reference(l.double())
            torch.cuda.synchronize()
            rel = _rel(got_w, want_w)
            err = _abs(got_w, want_w)
            ms = _cuda_ms(torch, lambda: lc.tri_inv(l), 50)
            plain_ms = _cuda_ms(torch, lambda: lc.tri_inv_reference(l), 10)
            eye = torch.eye(t, dtype=dtype, device=dev).expand_as(l)
            lib_ms = _cuda_ms(torch, lambda: torch.linalg.solve_triangular(l, eye, upper=False), 10)
            log(f"  tri_inv{tag} B={b} T={t}: rel err {rel:.2e} (tol {tol}); vs f64: kernel "
                f"{_rel(got_w, exact_w):.2e}, plain {_rel(want_w, exact_w):.2e}; "
                f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, solve_triangular {lib_ms:.4f} ms")
            ok &= rel < tol
            report["tri_inv" + suffix].append(dict(t=t, err=err, ms=ms, plain_ms=plain_ms,
                                                   work=_triangle_work(b, t, e), library_ms=lib_ms))
        ky, y = ky32, y32

        bad = ky.clone()
        bad[5] = -torch.eye(t, device=dev)
        _, _, alpha, logdet = lc.chol_solve(bad, y)
        torch.cuda.synchronize()
        nan_ok = bool(torch.isnan(logdet[5]) and torch.isnan(alpha[5]).all()
                      and torch.isfinite(logdet[:5]).all() and torch.isfinite(alpha[6:]).all())
        log(f"  chol_solve non-PD input at T={t} gives NaN only there: {nan_ok}")
        ok &= nan_ok
    return ok


def check_solve_vec(torch, inputs, pack, dev, report):
    """Phase 3, B5: the vector-solve kernel against its plain version in
    float32 and float64, on the factors of Matern Grams of the paths'
    features plus noise; at the library path's two shapes the Cholesky
    kernel against its plain version on the same Grams, as that path
    launches it; at (112, 165) the Cholesky kernel followed by the vector
    solve against the fused Cholesky-solve kernel."""
    from bayesian_ensembling_tpu_torch.ops import linalg_cuda as lc
    from bayesian_ensembling_tpu_torch.parallel.campaign import pad_unique_axis

    hb, _, sb, _, _, _ = inputs
    uh, _ = pad_unique_axis(pack.uh, pack.um, HIST_CHUNK)
    cases = [  # (what runs at this shape, realisation block (B, R, T))
        ("library path, one scenario's hist", hb[0]),
        ("library path, one scenario's ssp", sb[0]),
        ("log_prob of one vector", hb[0, :1]),
        ("annual step's hist batch", hb.reshape(S * M, R, -1)),
        ("monthly ssp batch", pack.usb),
        ("monthly hist chunk", uh[:HIST_CHUNK]),
    ]
    rng = np.random.default_rng(3)
    ok = True
    for label, block in cases:
        b, _, t = block.shape
        x = torch.tensor(block, dtype=torch.float32, device=dev).transpose(1, 2).contiguous()
        noise = torch.tensor(rng.uniform(0.005, 0.05, (b, t)), dtype=torch.float32, device=dev)
        ky32 = _matern_spd(torch, x, noise, dev)
        y32 = torch.tensor(rng.normal(size=(b, t)), dtype=torch.float32, device=dev)
        del x
        for dtype in (torch.float32, torch.float64):
            ky, y = ky32.to(dtype), y32.to(dtype)
            l = lc.chol_reference(ky).contiguous()  # torch.linalg returns a column-major factor
            if b == M:  # the library path factors one scenario's posterior covariances
                got_l = lc.chol(ky)
                torch.cuda.synchronize()
                rel, err = _rel(got_l, l), _abs(got_l, l)
                ms = _cuda_ms(torch, lambda: lc.chol(ky), 50)
                plain_ms = _cuda_ms(torch, lambda: lc.chol_reference(ky), 20)
                lib_ms = _cuda_ms(torch, lambda: torch.linalg.cholesky_ex(ky), 20)
                log(f"  chol {label} B={b} T={t} {str(dtype)[6:]}: rel err {rel:.2e} (tol "
                    f"{LINALG_TOL}); kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, cholesky_ex "
                    f"{lib_ms:.4f} ms")
                ok &= rel < LINALG_TOL
                report["chol"].append(dict(t=t, err=err, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                                           work=_triangle_work(b, t, ky.element_size())))
                del got_l
            got = lc.solve_vec(l, y)
            want = lc.solve_vec_reference(l, y)
            torch.cuda.synchronize()
            rels = [_rel(g, w_) for g, w_ in zip(got, want)]
            err = max(_abs(g, w_) for g, w_ in zip(got, want))
            reps = 50 if t < 1000 else 10
            ms = _cuda_ms(torch, lambda: lc.solve_vec(l, y), reps)
            plain_ms = _cuda_ms(torch, lambda: lc.solve_vec_reference(l, y), reps)

            def two_solves():
                z = torch.linalg.solve_triangular(l, y[..., None], upper=False)
                return torch.linalg.solve_triangular(l.mT, z, upper=True)

            lib_ms = _cuda_ms(torch, two_solves, reps)
            work = _solve_vec_work(b, t, l.element_size())
            bound_ms, bound_by = _bound(*work)
            tol = LINALG_TOL if dtype == torch.float32 else LINALG_TOL_F64
            log(f"  solve_vec {label} B={b} T={t} {str(dtype)[6:]} ({lc._solve_vec_layout(t, dtype)}): "
                "rel err (z, alpha, logdet) = " + ", ".join(f"{e:.2e}" for e in rels)
                + f" (tol {tol}); kernel {ms:.4f} ms{_previous(('solve_vec', b, t)) if tol == LINALG_TOL else ''}, "
                f"plain {plain_ms:.4f} ms, two solve_triangular {lib_ms:.4f} ms, bound "
                f"{bound_ms:.5f} ms ({bound_by})")
            ok &= max(rels) < tol
            row = dict(t=t, b=b, err=err, ms=ms, plain_ms=plain_ms, work=work, library_ms=lib_ms)
            report["solve_vec" if dtype == torch.float32 else "solve_vec_f64"].append(row)
            # The forward-only launch (the library's scores): z and logdet
            # bit for bit the full launch's.
            fwd = lc.solve_vec_forward(l, y)
            torch.cuda.synchronize()
            same = torch.equal(fwd[0], got[0]) and torch.equal(fwd[1], got[2])
            ms_fwd = _cuda_ms(torch, lambda: lc.solve_vec_forward(l, y), reps)
            bound_fwd = _bound(*_solve_vec_forward_work(b, t, l.element_size()))[0]
            log(f"  solve_vec forward-only {label} B={b} T={t} {str(dtype)[6:]}: z and logdet equal the "
                f"full launch's: {same}; kernel {ms_fwd:.4f} ms, bound {bound_fwd:.5f} ms")
            ok &= same
            if (b, t) == (S * M, T_HIST):
                composed = lc.chol_solve_composed(ky, y)
                fused = lc.chol_solve(ky, y)
                torch.cuda.synchronize()
                rels = [_rel(g, w_) for g, w_ in zip(composed, fused)]
                ms_c = _cuda_ms(torch, lambda: lc.chol_solve_composed(ky, y), 50)
                ms_f = _cuda_ms(torch, lambda: lc.chol_solve(ky, y), 50)
                log(f"  chol + solve_vec vs chol_solve B={b} T={t} {str(dtype)[6:]}: rel err (L, z, "
                    "alpha, logdet) = " + ", ".join(f"{e:.2e}" for e in rels)
                    + f" (tol {LINALG_TOL}); composed {ms_c:.4f} ms, fused {ms_f:.4f} ms")
                ok &= max(rels) < LINALG_TOL
            del ky, y, l, got, want
        del ky32
        torch.cuda.empty_cache()

    # A zero and a negative diagonal entry come through untrapped, in their
    # own matrices only, as in the plain version.
    x = torch.tensor(hb[0], dtype=torch.float32, device=dev).transpose(1, 2).contiguous()
    noise = torch.full((M, T_HIST), 0.02, device=dev)
    l = lc.chol_reference(_matern_spd(torch, x, noise, dev)).contiguous()
    l[1, 40, 40] = 0.0
    l[2, T_HIST - 1, T_HIST - 1] = -1.0
    y = torch.tensor(rng.normal(size=(M, T_HIST)), dtype=torch.float32, device=dev)
    z, alpha, logdet = lc.solve_vec(l, y)
    _, _, want_ld = lc.solve_vec_reference(l, y)
    torch.cuda.synchronize()
    rest = [0] + list(range(3, M))
    bad_ok = bool(logdet[1] == -float("inf") and want_ld[1] == -float("inf")
                  and not torch.isfinite(z[1]).all() and not torch.isfinite(alpha[1]).all()
                  and torch.isnan(logdet[2]) and torch.isnan(want_ld[2])
                  and all(torch.isfinite(a[rest]).all() for a in (z, alpha, logdet)))
    log(f"  solve_vec zero / negative diagonal entry gives inf / NaN only there: {bad_ok}")
    return ok and bad_ok


def _tensors(torch, arrays, dev, dtype):
    return [torch.tensor(a, dtype=torch.bool if a.dtype == bool else dtype, device=dev)
            for a in arrays]


def run_slice(torch, bt, inputs, dev, dtype, nits, **kw):
    kw.setdefault("dba_iterations", 10)
    return bt.ensemble_multi_scenario_step(*_tensors(torch, inputs, dev, dtype), n_optim_nits=nits,
                                           **kw)


def _collections(torch, inputs, dev, dtype):
    """The merged (S*M, R, T) historical and SSP blocks and masks."""
    hb, hm, sb, sm, _, _ = _tensors(torch, inputs, dev, dtype)
    return [(hb.reshape(S * M, R, -1), hm.reshape(S * M, R)),
            (sb.reshape(S * M, R, -1), sm.reshape(S * M, R))]


def _tail(torch, bt, inputs, marg, dev, dtype, **kw):
    """The multi-scenario tail at given marginals ``[(mean, var), (mean, var)]``
    of the merged collections."""
    hb, hm, _, _, obs, mm = _tensors(torch, inputs, dev, dtype)
    (hmu, hvar), (smu, svar) = [(a.to(dev, dtype).reshape(S, M, -1), b.to(dev, dtype).reshape(S, M, -1))
                                for a, b in marg]
    return bt.multi_scenario_tail(hmu, hvar, smu, svar, obs, hb, hm, mm, **kw)


def _moments_gap(got, want):
    return max(_abs(got[0], want[0]), _abs(got[1], want[1]))


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


class MonthlyCollection:
    """A numpy stand-in for the JAX package's ``ModelCollection``: the
    three things ``pack_dedup_campaign`` reads of a collection."""

    def __init__(self, names, blocks):
        self.model_names = list(names)
        self.blocks = list(blocks)  # (realisations, T) each

    def __len__(self):
        return len(self.model_names)

    @property
    def max_realisations(self):
        return max(b.shape[0] for b in self.blocks)

    def padded_stack(self, dtype=np.float32, r_target=None):
        r = self.max_realisations if r_target is None else r_target
        out = np.zeros((len(self.blocks), r, self.blocks[0].shape[1]), dtype)
        mask = np.zeros((len(self.blocks), r), bool)
        for i, b in enumerate(self.blocks):
            out[i, : b.shape[0]] = b
            mask[i, : b.shape[0]] = True
        return out, mask


def synthetic_monthly(seed, r=R, r_obs=R_OBS):
    """The native-monthly campaign's inputs, GMST-anomaly-like, from a seed.

    A pool of 20 historical models (T = 1980 months), each with a climate
    sensitivity, an offset and 3 to ``r`` realisations of monthly AR(1)
    internal variability; 7 scenarios whose model lists are drawn from the
    pool (65 SSP runs in all, T = 1032 months), each warming at its own
    rate.  A model's historical block is the same array in every scenario
    that lists it, as the dedup requires.
    """
    rng = np.random.default_rng(seed)
    forced_h = 1.2 * (np.arange(T_HIST_M) / (T_HIST_M - 1)) ** 3 - 0.1
    sens = rng.normal(1.0, 0.2, N_HIST_MODELS)
    offset = rng.normal(0.0, 0.15, N_HIST_MODELS)
    # At least three realisations (ROADMAP C6): a two-member model whose
    # noise reaches the 1e-8 floor has a float32 Gram at monthly T that is
    # not positive definite as stored, so its float32 NLML is NaN in the JAX
    # package and in the port alike (tests/test_torch_linalg_blocked.py).
    counts = rng.integers(3, r + 1, N_HIST_MODELS)
    counts[0], counts[-1] = 3, r
    names = [f"model{k:02d}" for k in range(N_HIST_MODELS)]
    hist = [sens[k] * forced_h + offset[k] + _ar1(rng, (counts[k], T_HIST_M), 0.9, 0.15)
            for k in range(N_HIST_MODELS)]
    scenarios = []
    for si, m_s in enumerate(SSP_MODELS):
        if si == 0:
            members = list(range(m_s))
        elif si == 1:
            members = list(range(N_HIST_MODELS - m_s, N_HIST_MODELS))
        else:
            members = sorted(rng.choice(N_HIST_MODELS, m_s, replace=False).tolist())
        rate = (0.005 + 0.035 * si / (len(SSP_MODELS) - 1)) / 12  # degC per month
        forced_s = forced_h[-1] + rate * np.arange(1, T_SSP_M + 1)
        ssp = [sens[k] * forced_s + offset[k] + _ar1(rng, (counts[k], T_SSP_M), 0.9, 0.15)
               for k in members]
        scenarios.append((f"ssp{si}", MonthlyCollection([names[k] for k in members],
                                                        [hist[k] for k in members]),
                          MonthlyCollection([names[k] for k in members], ssp)))
    obs = forced_h + _ar1(rng, (r_obs, T_HIST_M), 0.9, 0.05)
    return scenarios, obs


def _monthly_centres(torch, block, mask, dev):
    """(centres, series) of a collection's first DBA iteration, on the card:
    each realisation paired with its model's masked mean."""
    b, r, t = block.shape
    series = torch.tensor(block.reshape(-1, t), dtype=torch.float32, device=dev)
    w = torch.tensor(mask, dtype=torch.float32, device=dev)
    b3 = series.reshape(b, r, t)
    centers = (b3 * w[:, :, None]).sum(1) / w.sum(1, keepdim=True).clamp(min=1.0)
    return centers.repeat_interleave(r, dim=0).contiguous(), series


def _nlml_step(torch, nlml, ky, y):
    """One NLML value and gradient with respect to K, as a fit step needs."""
    k = ky.detach().requires_grad_(True)
    quad, logdet = nlml(k, y)
    (g,) = torch.autograd.grad((quad + logdet).sum(), (k,))
    return quad.detach(), logdet.detach(), g


def check_monthly_kernels(torch, pack, dev, report):
    """Phase 3, monthly path: the split DBA update, the Cholesky and the
    blocked NLML at the campaign's shapes, and the route timings."""
    from bayesian_ensembling_tpu_torch.ops import dtw_cuda
    from bayesian_ensembling_tpu_torch.ops import linalg_blocked as lb
    from bayesian_ensembling_tpu_torch.ops import linalg_cuda as lc
    from bayesian_ensembling_tpu_torch.parallel.campaign import pad_unique_axis

    ok = True
    uh, um = pad_unique_axis(pack.uh, pack.um, HIST_CHUNK)  # the one historical chunk
    for name, block, mask in (("hist", uh, um), ("ssp", pack.usb, pack.usm)):
        centers, series = _monthly_centres(torch, block, mask, dev)
        n, t = series.shape
        got = dtw_cuda.dba_update_batch(centers, series)
        want = dtw_cuda.dba_update_batch_reference(centers, series)
        torch.cuda.synchronize()
        exact = torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        err = max(_abs(got[0], want[0]), _abs(got[1], want[1]))
        ms = _cuda_ms(torch, lambda: dtw_cuda.dba_update_batch(centers, series), 5)
        plain_ms = _cuda_ms(torch, lambda: dtw_cuda.dba_update_batch_reference(centers, series), 1)
        del got, want
        torch.cuda.empty_cache()
        scratch = dtw_cuda._split_scratch_bytes(t)
        log(f"  dba_update_split N={n} T={t} ({name}): exact={exact} max_abs_err={err:.3e} "
            f"kernel {ms:.3f} ms{_previous(('dba_update_split', n, t))}, plain {plain_ms:.1f} ms; "
            f"move codes {scratch} bytes a pair ({scratch * n / 2**30:.3f} GiB a launch; a byte a "
            f"cell took {(2 * t - 1) * t * n / 2**30:.3f} GiB)")
        ok &= exact
        report["dba_update_split"].append(dict(t=t, n=n, err=err, ms=ms, plain_ms=plain_ms,
                                               work=_dba_work(n, t), library_ms=None))
        # Float64, as the campaign's reference run launches it.
        c64, s64 = centers.double(), series.double()
        got = dtw_cuda.dba_update_batch(c64, s64)
        want = dtw_cuda.dba_update_batch_reference(c64, s64)
        torch.cuda.synchronize()
        exact64 = torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        ms = _cuda_ms(torch, lambda: dtw_cuda.dba_update_batch(c64, s64), 5)
        log(f"  dba_update_split N={n} T={t} ({name}) f64: exact={exact64} kernel {ms:.3f} ms")
        ok &= exact64
        del c64, s64, got, want
        # NaN pairs: in row 0 of one centre (the walk leaves the matrix at
        # (0, T-1) and ends there), in one series, in the middle of another
        # centre; equal to the plain version, NaN for NaN.
        c_nan, s_nan = centers[:16].clone(), series[:16].clone()
        c_nan[1, 0] = float("nan")
        s_nan[7, t // 3] = float("nan")
        c_nan[9, t // 2] = float("nan")
        got = dtw_cuda.dba_update_batch(c_nan, s_nan)
        want = dtw_cuda.dba_update_batch_reference(c_nan, s_nan)
        torch.cuda.synchronize()
        nan_ok = (torch.equal(got[1], want[1]) and torch.equal(got[0].isnan(), want[0].isnan())
                  and torch.equal(got[0].nan_to_num(), want[0].nan_to_num()))
        log(f"  dba_update_split N=16 T={t} ({name}) with NaN pairs: equal to plain, NaN for NaN: "
            f"{nan_ok}")
        ok &= nan_ok
        del c_nan, s_nan, got, want
        torch.cuda.empty_cache()

    # Past the cap of byte-wide codes the fused kernel takes T = 720; impl="auto"
    # sends it there only if it beats the split kernel (ops/dtw_cuda.py,
    # FUSED_AUTO_T_MAX).  Both bit for bit against the plain version.
    rng = np.random.default_rng(3)
    for dtype in (torch.float32, torch.float64):
        c = torch.tensor(rng.normal(size=(HIST_CHUNK * R, 720)), dtype=dtype, device=dev)
        x = torch.tensor(rng.normal(size=(HIST_CHUNK * R, 720)), dtype=dtype, device=dev)
        rows = [_check_dba(torch, dtw_cuda, c, x, 5, impl) for impl in ("fused", "split")]
        ok &= rows[0]["exact"] and rows[1]["exact"]
        if dtype == torch.float32:
            faster = rows[0]["ms"] < rows[1]["ms"]
            log(f"  T=720: fused {rows[0]['ms']:.4f} ms, split {rows[1]['ms']:.4f} ms; auto sends T=720 "
                f"to the {'fused' if dtw_cuda.FUSED_AUTO_T_MAX >= 720 else 'split'} kernel "
                f"(fused faster: {faster})")
        del c, x

    # The split kernel against the fused one at the annual T, same pairs.
    rng = np.random.default_rng(2)
    c = torch.tensor(rng.normal(size=(S * M * R, T_HIST)), dtype=torch.float32, device=dev)
    x = torch.tensor(rng.normal(size=(S * M * R, T_HIST)), dtype=torch.float32, device=dev)
    split = dtw_cuda.dba_update_batch(c, x, impl="split")
    fused = dtw_cuda.dba_update_batch(c, x, impl="fused")
    torch.cuda.synchronize()
    same = torch.equal(split[0], fused[0]) and torch.equal(split[1], fused[1])
    ms_split = _cuda_ms(torch, lambda: dtw_cuda.dba_update_batch(c, x, impl="split"), 10)
    ms_fused = _cuda_ms(torch, lambda: dtw_cuda.dba_update_batch(c, x, impl="fused"), 10)
    log(f"  dba_update_split vs dba_update N={c.shape[0]} T={T_HIST}: equal={same}; split "
        f"{ms_split:.4f} ms, fused {ms_fused:.4f} ms")
    ok &= same

    # The Cholesky at the blocked NLML's leaves: Matern Grams of 128-step
    # windows of the SSP features plus noise, one slot not positive definite.
    nb = lb.DEFAULT_BLOCK
    feats = torch.tensor(pack.usb[:, :, :nb], dtype=torch.float32, device=dev).transpose(1, 2)
    b = feats.shape[0]
    noise = torch.tensor(rng.uniform(0.005, 0.05, (b, nb)), dtype=torch.float32, device=dev)
    ky = _matern_spd(torch, feats.contiguous(), noise, dev)
    got = lc.chol(ky)
    want = lc.chol_reference(ky)
    exact64 = lc.chol_reference(ky.double())
    torch.cuda.synchronize()
    rel, err = _rel(got, want), _abs(got, want)
    ms = _cuda_ms(torch, lambda: lc.chol(ky), 50)
    plain_ms = _cuda_ms(torch, lambda: lc.chol_reference(ky), 20)
    lib_ms = _cuda_ms(torch, lambda: torch.linalg.cholesky_ex(ky), 20)
    log(f"  chol B={b} T={nb}: rel err {rel:.2e} (tol {LINALG_TOL}); vs f64: kernel "
        f"{_rel(got, exact64):.2e}, plain {_rel(want, exact64):.2e}; kernel {ms:.4f} ms, "
        f"plain {plain_ms:.4f} ms, cholesky_ex {lib_ms:.4f} ms")
    ok &= rel < LINALG_TOL
    report["chol"].append(dict(t=nb, err=err, ms=ms, plain_ms=plain_ms,
                               work=_triangle_work(b, nb), library_ms=lib_ms))

    # The triangular inverse at the same leaves, on the kernel's factors.
    got_w = lc.tri_inv(got)
    want_w = lc.tri_inv_reference(got)
    exact_w = lc.tri_inv_reference(got.double())
    torch.cuda.synchronize()
    rel, err = _rel(got_w, want_w), _abs(got_w, want_w)
    ms = _cuda_ms(torch, lambda: lc.tri_inv(got), 50)
    plain_ms = _cuda_ms(torch, lambda: lc.tri_inv_reference(got), 20)
    eye = torch.eye(nb, device=dev).expand_as(got)
    lib_ms = _cuda_ms(torch, lambda: torch.linalg.solve_triangular(got, eye, upper=False), 20)
    log(f"  tri_inv B={b} T={nb}: rel err {rel:.2e} (tol {LINALG_TOL}); vs f64: kernel "
        f"{_rel(got_w, exact_w):.2e}, plain {_rel(want_w, exact_w):.2e}; kernel {ms:.4f} ms, "
        f"plain {plain_ms:.4f} ms, solve_triangular {lib_ms:.4f} ms")
    ok &= rel < LINALG_TOL
    report["tri_inv"].append(dict(t=nb, err=err, ms=ms, plain_ms=plain_ms,
                                  work=_triangle_work(b, nb), library_ms=lib_ms))
    bad = ky.clone()
    bad[3] = -torch.eye(nb, device=dev)
    l_bad = lc.chol(bad)
    torch.cuda.synchronize()
    nan_ok = bool(torch.isnan(l_bad[3].diagonal()).all() and torch.isfinite(l_bad[:3]).all()
                  and torch.isfinite(l_bad[4:]).all())
    log(f"  chol non-PD input at T={nb} gives NaN only there: {nan_ok}")
    ok &= nan_ok

    # The blocked NLML (float32, kernels) against torch.linalg (float64) at
    # the SSP fit's shape (65, 1032) and the historical chunk's (28, 1980),
    # both on the blocked route, then the route timings of one NLML value
    # and gradient there.
    timings = {}
    for name, block, nbatch in (("ssp", pack.usb, None), ("hist", uh, HIST_CHUNK)):
        feats = torch.tensor(block[:nbatch], dtype=torch.float32, device=dev).transpose(1, 2)
        b, t = feats.shape[0], feats.shape[1]
        noise = torch.tensor(rng.uniform(0.005, 0.05, (b, t)), dtype=torch.float32, device=dev)
        ky = _matern_spd(torch, feats.contiguous(), noise, dev)
        y = torch.tensor(rng.normal(size=(b, t)), dtype=torch.float32, device=dev)
        library = lc.nlml_terms  # T is beyond the kernels' cap: torch.linalg
        got = _nlml_step(torch, lb.nlml_terms_blocked, ky, y)
        want = _nlml_step(torch, library, ky.double(), y.double())
        torch.cuda.synchronize()
        rels = [_rel(g, w_) for g, w_ in zip(got, want)]
        log(f"  nlml_terms_blocked B={b} T={t} ({name}, {lc.linalg_path(t, b=b)} route) f32 vs "
            f"library f64: rel err (quad, logdet, dK) = " + ", ".join(f"{e:.2e}" for e in rels)
            + f" (tol {BLOCKED_TOL})")
        ok &= max(rels) < BLOCKED_TOL
        del got, want
        for route, fn in (("blocked", lb.nlml_terms_blocked), ("library", library)):
            timings[(route, b, t)] = _cuda_ms(torch, lambda: _nlml_step(torch, fn, ky, y), 5)
            log(f"  route {route} B={b} T={t}: {timings[(route, b, t)]:.3f} ms per NLML value "
                "and gradient (f32)")
        del ky
        torch.cuda.empty_cache()
    report["routes"] = timings
    return ok


def _campaign(torch, bt, pack, obs, dev, dtype):
    return bt.run_dedup_campaign(pack, obs, hist_chunk=HIST_CHUNK, device=dev, dtype=dtype,
                                 n_optim_nits=MONTHLY_NITS, dba_iterations=10)


def campaign_stage_split(torch, pack, obs, dev):
    """Wall time and peak device memory of each stage of one float32
    campaign, run stage by stage (the composition of ``run_dedup_campaign``
    and ``emulate_marginals``)."""
    from bayesian_ensembling_tpu_torch.ops import gp as gp_ops
    from bayesian_ensembling_tpu_torch.parallel.step import chunked_marginals, multi_scenario_tail

    times, peaks = {}, {}

    def timed(name, fn):
        torch.cuda.reset_peak_memory_stats()
        dt, out = _wall(torch, fn)
        times[name] = times.get(name, 0.0) + dt
        peaks[name] = max(peaks.get(name, 0.0), torch.cuda.max_memory_allocated() / 2**30)
        return out

    def staged(key):
        def em(block, mask):
            x, y, v = timed(f"{key}_dba", lambda: gp_ops.prepare_gp_inputs(block, mask, dba_iterations=10))
            params, _ = timed(f"{key}_fit", lambda: gp_ops.fit_gp_batch(x, y, v, n_optim_nits=MONTHLY_NITS))
            mu, var = timed(f"{key}_posterior", lambda: gp_ops.posterior_marginals_batch(params, x, y, v))
            return mu, var + v
        return em

    def tensor(a):
        return torch.tensor(a, dtype=torch.bool if a.dtype == bool else torch.float32, device=dev)

    h_mu, h_var = chunked_marginals(staged("hist"), tensor(pack.uh), tensor(pack.um), HIST_CHUNK)
    s_mu, s_var = staged("ssp")(tensor(pack.usb), tensor(pack.usm))
    uidx = torch.tensor(pack.uidx, device=dev)
    sidx = torch.tensor(pack.sidx, device=dev)
    timed("tail", lambda: multi_scenario_tail(
        h_mu[uidx], h_var[uidx], s_mu[sidx], s_var[sidx], tensor(obs), tensor(pack.hb),
        tensor(pack.hm), tensor(pack.mmask)))
    return times, peaks


def run_monthly(torch, bt, dev, seed, report):
    """Phase 6: the dedup campaign, float32 checked against float64, timed."""
    from bayesian_ensembling_tpu_torch.ops import linalg_blocked as lb

    scenarios, obs = synthetic_monthly(seed)
    pack = bt.pack_dedup_campaign(scenarios)
    counts = pack.um.sum(axis=1)
    log(f"[monthly] {len(scenarios)} scenarios, {pack.uh.shape[0]} unique historical fits "
        f"(T={T_HIST_M}) + {pack.usb.shape[0]} SSP fits (T={T_SSP_M}), padded M="
        f"{pack.mmask.shape[1]}, R={pack.hb.shape[2]} (realisations {counts.min()}..{counts.max()}), "
        f"R_obs={obs.shape[0]}; {MONTHLY_NITS} Adam steps, 10 DBA iterations, chunks of {HIST_CHUNK}")

    bt.reset_launch_counts()
    dt, (bm, bs, w) = _wall(torch, lambda: _campaign(torch, bt, pack, obs, dev, torch.float32))
    launches, routes = bt.launch_counts(), bt.route_counts()
    n_chunks = -(-pack.uh.shape[0] // HIST_CHUNK)
    # The blocked NLML's leaves: 9 at T = 1032 (padded to 1152), 16 at T =
    # 1980 (padded to 2048).
    n_leaves = -(-T_SSP_M // lb.DEFAULT_BLOCK) + n_chunks * -(-T_HIST_M // lb.DEFAULT_BLOCK)
    expected = {"dba_update": 0, "dba_update_split": 2 * 10, "chol_solve": 0,
                "tri_inv": n_leaves * MONTHLY_NITS, "chol": n_leaves * MONTHLY_NITS, "dtw_cost": 0,
                "solve_vec": 0}
    # One blocked NLML per step of the SSP fit and of each historical chunk's
    # (B = 28); on the library route, a factorisation and a triangular
    # inverse per posterior.
    expected_routes = {"kernel": 0, "blocked": (1 + n_chunks) * MONTHLY_NITS,
                       "library": 2 * n_chunks + 2}
    log(f"[monthly] f32 on the card: {dt:.2f} s; launches {launches} (expected {expected}); "
        f"routes {routes} (expected {expected_routes})")
    wsum = w.double().sum(dim=1)
    finite = all(bool(torch.isfinite(a).all()) for a in (bm, bs, w))
    if (launches != expected or routes != expected_routes or not finite
            or (wsum - 1.0).abs().max().item() > 1e-5):
        print(f"chip_smoke: monthly check failed (finite={finite}, weight sums {wsum.tolist()})",
              file=sys.stderr)
        return None
    report["monthly_launches"] = launches
    # Phase 12 holds the sharded campaign to this run bit for bit.
    report["monthly_f32"] = dict(pack=pack, obs=obs, out=(bm, bs, w), launches=launches,
                                 routes=routes)
    warm = dt

    bt.reset_launch_counts()
    dt, ref = _wall(torch, lambda: _campaign(torch, bt, pack, obs, dev, torch.float64))
    dmean, dstd, dw = _abs(bm, ref[0]), _abs(bs, ref[1]), _abs(w, ref[2])
    log(f"[monthly] f64 on the card: {dt:.2f} s; launches {bt.launch_counts()}, routes "
        f"{bt.route_counts()}; max |dmean| {dmean:.3e} degC, max |dstd| {dstd:.3e} degC "
        f"(gate {PARITY_DEGC}), max |dweight| {dw:.3e}")
    log("[monthly] last-month barycentre by scenario: " + ", ".join(
        f"{m_:.3f}+-{s_:.3f}" for m_, s_ in zip(bm[:, -1].tolist(), bs[:, -1].tolist())))
    if not (dmean < PARITY_DEGC and dstd < PARITY_DEGC):
        print("chip_smoke: the f32 monthly campaign disagrees with the f64 one", file=sys.stderr)
        return None

    walls = []
    for rep in range(MONTHLY_REPS):
        torch.cuda.reset_peak_memory_stats()
        dt, out = _wall(torch, lambda: _campaign(torch, bt, pack, obs, dev, torch.float32))
        walls.append(dt)
        log(f"[monthly] run {rep + 1}: {dt:.3f} s (peak device memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; {PREVIOUS_PEAK_GIB} GiB with "
            "a byte per move code)")
    if not all(bool(torch.isfinite(a).all()) for a in out):
        print("chip_smoke: a timed monthly run gave non-finite output", file=sys.stderr)
        return None
    split, peaks = campaign_stage_split(torch, pack, obs, dev)
    log(f"[monthly] {MONTHLY_NITS} Adam steps, {pack.n_fits} fits: median "
        f"{statistics.median(walls):.3f} s over {len(walls)} runs (warm-up {warm:.3f} s); stages "
        + ", ".join(f"{k} {v:.3f} s" for k, v in split.items()))
    log("[monthly] peak device memory by stage: " + ", ".join(f"{k} {v:.2f} GiB" for k, v in peaks.items()))
    return True


def check_cost_kernel(torch, inputs, pack, dev, report):
    """Phase 3, B7: the squared-DTW cost kernel against its plain version,
    bit for bit, in float32 and float64, at the shapes its paths give it."""
    from bayesian_ensembling_tpu_torch.ops import dtw_cuda
    from bayesian_ensembling_tpu_torch.parallel.campaign import pad_unique_axis

    hb, hm, sb, sm, _, _ = inputs
    uh, um = pad_unique_axis(pack.uh, pack.um, HIST_CHUNK)
    iu, ju = np.triu_indices(R, k=1)
    hist3 = hb.reshape(S * M, R, -1)
    cases = [
        ("subgradient epoch cost, hist", *_epoch_pairs(hb, hm)),
        ("medoid pairs, hist", hist3[:, iu].reshape(-1, T_HIST), hist3[:, ju].reshape(-1, T_HIST)),
        ("subgradient epoch cost, ssp", *_epoch_pairs(sb, sm)),
        ("monthly hist chunk", *_epoch_pairs(uh, um)),
        ("T = 1", *(a[:, :1] for a in _epoch_pairs(hb, hm))),
    ]
    ok = True
    for label, centers_np, series_np in cases:
        for dtype in (torch.float32, torch.float64):
            centers = torch.tensor(centers_np, dtype=dtype, device=dev).contiguous()
            series = torch.tensor(series_np, dtype=dtype, device=dev).contiguous()
            n, t = series.shape
            got = dtw_cuda.squared_dtw_cost_batch(centers, series)
            want = dtw_cuda.squared_dtw_cost_batch_reference(centers, series)
            torch.cuda.synchronize()
            exact = torch.equal(got, want)
            err = _abs(got, want)
            reps = 20 if n * t * t < 2e9 else 5
            ms = _cuda_ms(torch, lambda: dtw_cuda.squared_dtw_cost_batch(centers, series), reps)
            plain_ms = _cuda_ms(torch, lambda: dtw_cuda.squared_dtw_cost_batch_reference(centers, series), 1)
            work = _cost_work(n, t, centers.element_size())
            bound_ms, bound_by = _bound(*work)
            prev = _previous(("dtw_cost", n, t)) if dtype == torch.float32 else ""
            log(f"  dtw_cost {label} N={n} T={t} {str(dtype)[6:]}: exact={exact} max_abs_err={err:.3e} "
                f"kernel {ms:.4f} ms{prev}, plain {plain_ms:.3f} ms, bound {bound_ms:.4f} ms ({bound_by})")
            ok &= exact
            if dtype == torch.float32:
                report["dtw_cost"].append(dict(t=t, n=n, err=err, ms=ms, plain_ms=plain_ms,
                                               work=work, library_ms=None, exact=exact))
            else:
                report["dtw_cost_f64"].append(dict(t=t, n=n, err=err, ms=ms, plain_ms=plain_ms))
            del centers, series, got, want
    torch.cuda.empty_cache()
    return ok


def _epoch_pairs(block, mask):
    """(centres, series) of an epoch cost: every realisation of a stack
    ``(..., R, T)`` paired with its model's masked mean."""
    r, t = block.shape[-2:]
    b3 = block.reshape(-1, r, t)
    w = mask.reshape(-1, r).astype(float)
    centers = (b3 * w[:, :, None]).sum(1) / np.maximum(w.sum(1, keepdims=True), 1.0)
    return np.repeat(centers, r, axis=0), b3.reshape(-1, t)


def _staged(torch, bt, inputs, dev, nits, **kw):
    """The float32 step through ``emulate_marginals`` with the fitted
    hyperparameters and targets kept: (tail output, per collection
    ``(mean, var, params, y_mean, y_var)``)."""
    ems = [bt.emulate_marginals(block, mask, n_optim_nits=nits, dba_iterations=10,
                                return_params=True, return_targets=True, **kw)
           for block, mask in _collections(torch, inputs, dev, torch.float32)]
    return _tail(torch, bt, inputs, [(mu, var) for mu, var, *_ in ems], dev, torch.float32), ems


def _nlml(bt, block, em):
    """Each model's NLML at the fitted hyperparameters of one emulation of
    ``block`` (the value at the start of a one-step fit from them)."""
    _, _, params, y, v = em
    return bt.fit_gp_batch(block.transpose(1, 2), y, v, n_optim_nits=1, init=params)[1][:, 0]


# A BFGS fit stranded on the degenerate plateau of ROADMAP C7: a signal
# variance below softplus(-10) = 4.5e-5 and an NLML worse than the truth's.
C7_RAW_VARIANCE, C7_NLML_GAP = -10.0, 1.0


def _bfgs_gate(torch, bt, inputs, dev, bfgs, truth, scratch_out):
    """The bench's closeness rule for bfgs-30 (bench.py:394-410), and, when
    it fails, whether the models stranded by ROADMAP C7 account for all of
    the failure: the rule must then hold with only those models' fits
    taken from the truth."""
    (bfgs_out, bfgs_ems), (truth_out, truth_ems) = bfgs, truth
    close_bfgs, close_scratch = _moments_gap(bfgs_out, truth_out), _moments_gap(scratch_out, truth_out)
    log(f"[bfgs] distance to the {TRUTH_NITS}-step Adam truth: bfgs-{BFGS_NITS} {close_bfgs:.4e} degC, "
        f"scratch-{TIMING_NITS} {close_scratch:.4e} degC (rule: bfgs <= {BFGS_SLACK} x scratch): "
        f"{'holds' if close_bfgs <= BFGS_SLACK * close_scratch else 'FAILS'}")
    if close_bfgs <= BFGS_SLACK * close_scratch:
        return True
    marg, n_stranded = [], 0
    for name, (block, _), be, te in zip(("hist", "ssp"), _collections(torch, inputs, dev, torch.float32),
                                        bfgs_ems, truth_ems):
        nl_b, nl_t = _nlml(bt, block, be), _nlml(bt, block, te)
        raw_v = be[2].raw_variance.detach()
        stranded = (raw_v < C7_RAW_VARIANCE) & (nl_b - nl_t > C7_NLML_GAP)
        for k in torch.nonzero(stranded).flatten().tolist():
            log(f"[bfgs] {name} model {k} stranded (C7): raw (lengthscale, variance) "
                f"({be[2].raw_lengthscale[k].item():.3f}, {raw_v[k].item():.3f}), NLML "
                f"{nl_b[k].item():.3f} vs the truth's {nl_t[k].item():.3f}")
        worse = int(((nl_b - nl_t > 1e-3) & ~stranded).sum())
        log(f"[bfgs] {name}: {int(stranded.sum())} model(s) stranded; of the others, {worse} end "
            f"above the truth's NLML by more than 1e-3 and "
            f"{int((nl_b - nl_t < -1e-3).sum())} below it")
        n_stranded += int(stranded.sum())
        marg.append(tuple(torch.where(stranded[:, None], t_, b_) for b_, t_ in zip(be[:2], te[:2])))
    swapped = _moments_gap(_tail(torch, bt, inputs, marg, dev, torch.float32), truth_out)
    ok = n_stranded > 0 and swapped <= BFGS_SLACK * close_scratch
    log(f"[bfgs] with the {n_stranded} stranded model(s) taken from the truth: {swapped:.4e} degC; "
        + ("the rule fails only through the models ROADMAP C7 strands (the JAX package's BFGS "
           "takes the same first step)" if ok else "the rule still FAILS"))
    return ok


def check_tail_and_refinement(torch, bt, inputs, dev, step_out, nits):
    """Phase 4, added: the float32 marginals through ``emulate_marginals``
    (with the fitted hyperparameters and targets), which must give the
    step's output bit for bit; every weight kind's tail on the card against
    float64 on the CPU at those marginals; the float64 refinement on the
    card against the CPU.  Returns the emulations for phase 8."""
    again, ems = _staged(torch, bt, inputs, dev, nits)
    marg = [(mu, var) for mu, var, *_ in ems]
    same = all(torch.equal(a, b) for a, b in zip(again, step_out))
    log(f"[tail] emulate_marginals + multi_scenario_tail equal the step bit for bit: {same}")
    ok = same
    cpu = torch.device("cpu")
    for kind in bt.WEIGHT_KINDS:
        dt, got = _wall(torch, lambda: _tail(torch, bt, inputs, marg, dev, torch.float32,
                                             weight_kind=kind))
        t0 = time.perf_counter()
        want = _tail(torch, bt, inputs, marg, cpu, torch.float64, weight_kind=kind)
        cpu_s = time.perf_counter() - t0
        dw, dm = _abs(got[2], want[2]), _moments_gap(got, want)
        finite = all(bool(torch.isfinite(a).all()) for a in got)
        log(f"[tail] {kind}: f32 card {dt * 1e3:.1f} ms vs f64 CPU {cpu_s:.2f} s: max |dweight| "
            f"{dw:.3e} (gate {WEIGHT_TOL}), max |dmoment| {dm:.3e} degC (gate {PARITY_DEGC}), "
            f"finite={finite}")
        ok &= finite and dw < WEIGHT_TOL and dm < PARITY_DEGC
    hb, hm, sb, sm, obs, mm = inputs
    (_, _, hp, hym, hyv), (_, _, sp, sym, syv) = ems
    targets = ((hym, hyv), (sym, syv))
    refined = {}
    for key, where in (("card", dev), ("CPU", cpu)):
        dt, refined[key] = _wall(torch, lambda: bt.refined_multi_scenario_f64(
            hb, hm, sb, sm, obs, mm, hp, sp, targets=targets, device=where))
        log(f"[refined] float64 posterior and tail on the {key}: {dt:.3f} s")
    gap = max(float(np.abs(a - b).max()) for a, b in zip(refined["card"][:2], refined["CPU"][:2]))
    f32_gap = _moments_gap(step_out, [torch.from_numpy(a) for a in refined["card"]])
    log(f"[refined] card vs CPU: max |dmoment| {gap:.3e} degC (gate {REFINED_DEGC}); the float32 "
        f"step differs from the refined moments by {f32_gap:.3e} degC")
    ok &= gap < REFINED_DEGC
    return ok, ems


def run_subgradient(torch, bt, inputs, dev, report):
    """Phase 7: the step with the reference-faithful subgradient DBA."""
    from bayesian_ensembling_tpu_torch.ops import dtw as dtw_ops

    kw = dict(dba_method="subgradient", dba_iterations=SUBGRADIENT_EPOCHS)
    epochs, targets = {}, {}
    for dtype in (torch.float32, torch.float64):
        for name, (block, mask) in zip(("hist", "ssp"), _collections(torch, inputs, dev, dtype)):
            dt, (y, info) = _wall(torch, lambda: dtw_ops.dba_subgradient_batch(
                block, mask, max_iter=SUBGRADIENT_EPOCHS, tol=1e-3, return_info=True))
            epochs[name, dtype], targets[name, dtype] = info["epochs"], y
            log(f"[subgradient] {name} {str(dtype)[6:]}: {info['epochs']} epochs, "
                f"{int(info['converged'].sum())} of {S * M} models converged, {dt:.3f} s")
    for name in ("hist", "ssp"):
        log(f"[subgradient] {name} target f32 vs f64: max |dy| "
            f"{_abs(targets[name, torch.float32], targets[name, torch.float64]):.3e} degC")

    bt.reset_launch_counts()
    dt, out = _wall(torch, lambda: run_slice(torch, bt, inputs, dev, torch.float32, PARITY_NITS, **kw))
    launches = bt.launch_counts()
    n_epochs = epochs["hist", torch.float32] + epochs["ssp", torch.float32]
    expected = {"dba_update": R * n_epochs, "dba_update_split": 0, "chol_solve": 2 * (PARITY_NITS + 1),
                "tri_inv": 2 * (PARITY_NITS + 1), "chol": 0, "dtw_cost": n_epochs, "solve_vec": 0}
    log(f"[subgradient] step f32 on the card, {PARITY_NITS} Adam steps: {dt:.2f} s; launches "
        f"{launches} (expected {expected})")
    report["subgradient_launches"] = launches
    dt, ref = _wall(torch, lambda: run_slice(torch, bt, inputs, dev, torch.float64, PARITY_NITS, **kw))
    dmean, dstd, dw = _abs(out[0], ref[0]), _abs(out[1], ref[1]), _abs(out[2], ref[2])
    log(f"[subgradient] step f64 on the card: {dt:.2f} s; max |dmean| {dmean:.3e} degC, max |dstd| "
        f"{dstd:.3e} degC (gate {PARITY_DEGC}), max |dweight| {dw:.3e}; epochs f32 "
        f"{epochs['hist', torch.float32]}/{epochs['ssp', torch.float32]}, f64 "
        f"{epochs['hist', torch.float64]}/{epochs['ssp', torch.float64]} (hist/ssp)")
    finite = all(bool(torch.isfinite(a).all()) for a in out)
    ok = launches == expected and finite and dmean < PARITY_DEGC and dstd < PARITY_DEGC
    if not ok:
        print("chip_smoke: the subgradient step failed its check", file=sys.stderr)

    medoid = {}
    for dtype in (torch.float32, torch.float64):
        block, mask = _collections(torch, inputs, dev, dtype)[0]
        bt.reset_launch_counts()
        dt, medoid[dtype] = _wall(torch, lambda: bt.dba_batch(block, mask, n_iterations=10,
                                                              init="medoid"))
        counts = bt.launch_counts()
        log(f"[medoid] dba_batch(init='medoid') hist {str(dtype)[6:]}: {dt:.3f} s; dtw_cost "
            f"{counts['dtw_cost']}, dba_update {counts['dba_update']}")
        ok &= counts["dtw_cost"] == 1 and counts["dba_update"] == 10
        if dtype == torch.float32:
            report["medoid_launches"] = counts
    dm = _abs(medoid[torch.float32], medoid[torch.float64])
    log(f"[medoid] f32 vs f64: max |dy| {dm:.3e} degC (gate {PARITY_DEGC})")
    ok &= dm < PARITY_DEGC
    if not ok:
        print("chip_smoke: the subgradient or medoid check failed", file=sys.stderr)
        return False

    walls = []
    for rep in range(TIMING_REPS + 1):
        dt, out = _wall(torch, lambda: run_slice(torch, bt, inputs, dev, torch.float32, TIMING_NITS,
                                                 **kw))
        log(f"[subgradient] {'warm-up' if rep == 0 else f'run {rep}'}: {dt:.3f} s")
        if rep:
            walls.append(dt)
    dba_s = 0.0
    for block, mask in _collections(torch, inputs, dev, torch.float32):
        dt, _ = _wall(torch, lambda: bt.prepare_gp_inputs(block, mask, **kw))
        dba_s += dt
    log(f"[subgradient] {TIMING_NITS} Adam steps, subgradient DBA: median "
        f"{statistics.median(walls):.3f} s over {len(walls)} runs, of which the DBA stage "
        f"(both collections, run alone) {dba_s:.3f} s")
    return all(bool(torch.isfinite(a).all()) for a in out)


def _timed_runs(torch, fn, label):
    """A warm-up and TIMING_REPS runs of ``fn``; returns (median s, last output)."""
    walls = []
    for rep in range(TIMING_REPS + 1):
        dt, out = _wall(torch, fn)
        log(f"[{label}] {'warm-up' if rep == 0 else f'run {rep}'}: {dt:.3f} s")
        if rep:
            walls.append(dt)
    return statistics.median(walls), out


def run_fast_routes(torch, bt, inputs, dev, step_out, ems, scratch_out, report):
    """Phase 8: the coarse-to-fine-in-time route, the 30-step BFGS and the
    chunked fit, at the flagship shape.  Keeps the truth's and bfgs-30's
    moments in ``report`` for phase 13."""
    from bayesian_ensembling_tpu_torch.ops import gp as gp_ops

    ok = True
    warm_s, warm = _timed_runs(torch, lambda: run_slice(torch, bt, inputs, dev, torch.float32,
                                                        WARM_NITS, **WARM_KW), "warm")
    dt, warm64 = _wall(torch, lambda: run_slice(torch, bt, inputs, dev, torch.float64, WARM_NITS,
                                                  **WARM_KW))
    gap = _moments_gap(warm, warm64)
    log(f"[warm] stride {WARM_KW['time_stride']}, {WARM_NITS} coarse + {WARM_KW['fine_steps']} fine "
        f"steps: median {warm_s:.3f} s; f64 on the card "
        f"{dt:.2f} s; f32 vs f64 max |dmoment| {gap:.3e} degC (gate {PARITY_DEGC})")
    ok &= gap < PARITY_DEGC

    bfgs_s, bfgs = _timed_runs(torch, lambda: run_slice(torch, bt, inputs, dev, torch.float32,
                                                        BFGS_NITS, **BFGS_KW), "bfgs")
    dt, bfgs64 = _wall(torch, lambda: run_slice(torch, bt, inputs, dev, torch.float64, BFGS_NITS,
                                                  **BFGS_KW))
    log(f"[bfgs] {BFGS_NITS} steps: median {bfgs_s:.3f} s; f32 vs f64 on the card max |dmoment| "
        f"{_moments_gap(bfgs, bfgs64):.3e} degC (reported only: an accept/reject flip forks the "
        f"trajectory)")
    staged_bfgs = _staged(torch, bt, inputs, dev, BFGS_NITS, **BFGS_KW)
    same = all(torch.equal(a, b) for a, b in zip(staged_bfgs[0], bfgs))
    dt_truth, truth = _wall(torch, lambda: _staged(torch, bt, inputs, dev, TRUTH_NITS))
    log(f"[bfgs] the {TRUTH_NITS}-step Adam truth: {dt_truth:.1f} s; the staged bfgs run equals the "
        f"timed one bit for bit: {same}")
    ok &= same and _bfgs_gate(torch, bt, inputs, dev, staged_bfgs, truth, scratch_out)
    report["truth_out"], report["bfgs_out"] = truth[0], staged_bfgs[0]

    marg, same_params = [], True
    for (block, mask), (_, _, params, _, _) in zip(_collections(torch, inputs, dev, torch.float32), ems):
        x, y, v = gp_ops.prepare_gp_inputs(block, mask, dba_iterations=10)
        chunked, _ = gp_ops.fit_gp_batch_dispatch(x, y, v, n_optim_nits=PARITY_NITS,
                                                  chunk_steps=CHUNK_STEPS)
        same_params &= (torch.equal(chunked.raw_lengthscale, params.raw_lengthscale)
                        and torch.equal(chunked.raw_variance, params.raw_variance))
        mu, var = gp_ops.posterior_marginals_batch(chunked, x, y, v)
        marg.append((mu, var + v))
    out = _tail(torch, bt, inputs, marg, dev, torch.float32)
    same = all(torch.equal(a, b) for a, b in zip(out, step_out))
    log(f"[chunked] {PARITY_NITS} Adam steps in chunks of {CHUNK_STEPS}: hyperparameters equal the "
        f"merged fit's bit for bit: {same_params}; moments and weights equal phase 4's: {same}")
    ok &= same_params and same
    return ok


def library_scenarios(bt, inputs):
    """The flagship inputs as the library API's containers: per scenario the
    historical and SSP ``ModelCollection`` of its real models (no model
    padding, each model with its own number of realisations) on yearly time
    coordinates, and the observations as one ``ProcessModel``."""
    hb, hm, sb, sm, obs, mm = inputs
    dims = ("realisation", "time")

    def years(start, n):
        return (np.datetime64(str(start), "Y") + np.arange(n)).astype("datetime64[ns]")

    t_hist, t_ssp = years(1850, hb.shape[-1]), years(1850 + hb.shape[-1], sb.shape[-1])

    def collection(block, mask, real, time):
        return bt.ModelCollection([
            bt.ProcessModel(bt.DimArray(block[k, : int(mask[k].sum())].copy(), dims,
                                        {"time": time.copy()}, name="tas"), f"model{k}")
            for k in range(block.shape[0]) if real[k] > 0
        ])

    observations = bt.ProcessModel(bt.DimArray(obs.copy(), dims, {"time": t_hist.copy()},
                                               name="tas"), "Observations")
    return [(collection(hb[si], hm[si], mm[si], t_hist), collection(sb[si], sm[si], mm[si], t_ssp))
            for si in range(hb.shape[0])], observations


def _posteriors_f64_on_cpu(bt, collection):
    """A copy of a fitted collection with its posterior moments in float64
    on the CPU."""
    models = []
    for pm in collection:
        arrays = {k: v.astype(np.float64) for k, v in pm.distribution.to_arrays().items()}
        copy = bt.ProcessModel(pm.data, pm.name)
        copy.distribution = bt.Posterior.from_arrays(arrays, pm.blank_template(), device="cpu")
        models.append(copy)
    return bt.ModelCollection(models)


def _library_pass(torch, bt, inputs, dev, dtype, nits, weighter=None, scenarios=None, check=None):
    """``run_scenario`` for each scenario (all when ``scenarios`` is None) on
    fresh collections; ``check(si, n_models)`` is called right after each
    scenario with the launch counters as that scenario left them.  Returns
    the results, the fitted collections and the wall time of the runs."""
    built, observations = library_scenarios(bt, inputs)
    picked = range(len(built)) if scenarios is None else scenarios
    results, wall = [], 0.0
    for si in picked:
        hist, ssp = built[si]
        bt.reset_launch_counts()
        dt, res = _wall(torch, lambda: bt.run_scenario(
            hist, ssp, observations, f"scenario{si}",
            weighter=bt.LogLikelihoodWeight() if weighter is None else weighter,
            emulator=bt.GPDTW1D(dtype=dtype), n_optim_nits=nits, device=dev))
        wall += dt
        if check is not None:
            check(si, len(hist))
        results.append(res)
    return results, [built[si] for si in picked], observations, wall


def _bary(torch, results):
    """(means, stddevs) of the scenarios' barycentres, each a list of (T,) tensors."""
    return ([r.barycentre.gaussian.mean for r in results],
            [torch.sqrt(r.barycentre.gaussian.variance) for r in results])


def _library_options(torch, bt, dev, hist, ssp, observations, weights):
    """Every weighter option, scheme and sigma mode on one scenario's
    float32 posteriors on the card against float64 on the CPU at the same
    posteriors; the four metrics finite."""
    hist64, ssp64 = _posteriors_f64_on_cpu(bt, hist), _posteriors_f64_on_cpu(bt, ssp)
    weighters = [
        ("LogLikelihoodWeight", dict()),
        ("LogLikelihoodWeight", dict(joint=True)),
        ("LogLikelihoodWeight", dict(account_obs_uncertainty=True)),
        ("LogLikelihoodWeight", dict(joint=True, account_obs_uncertainty=True)),
        ("CRPSWeight", dict()),
        ("CRPSWeight", dict(account_obs_uncertainty=True)),
        ("CRPSWeight", dict(compat_variance_as_scale=True)),
        ("KSDWeight", dict()),
        ("KSDWeight", dict(compat_variance_as_scale=True)),
        ("InverseSquareWeight", dict()),
        ("UniformWeight", dict()),
        ("ModelSimilarityWeight", dict(mode="single")),
        ("ModelSimilarityWeight", dict(mode="temporal")),
    ]
    ok = True
    for name, opts in weighters:
        bt.reset_launch_counts()
        dt, got = _wall(torch, lambda: getattr(bt, name)()(hist, observations, **opts))
        counts = bt.launch_counts()
        t0 = time.perf_counter()
        want = getattr(bt, name)()(hist64, observations, **opts)
        cpu_s = time.perf_counter() - t0
        dw = float(np.abs(got.values - want.values).max())
        sums = float(np.abs(got.values.sum(axis=0) - 1.0).max())
        label = name + ("(" + ", ".join(f"{k}={v}" for k, v in opts.items()) + ")" if opts else "")
        log(f"[library] {label}: f32 card {dt * 1e3:.1f} ms vs f64 CPU {cpu_s:.2f} s: max |dweight| "
            f"{dw:.3e} (gate {WEIGHT_TOL}), |sum - 1| {sums:.1e}; chol {counts['chol']}, "
            f"solve_vec {counts['solve_vec']} launches")
        ok &= bool(np.isfinite(got.values).all()) and dw < WEIGHT_TOL and sums < 1e-5
    for mode in ("w2", "compat", "mixture"):
        dt, got = _wall(torch, lambda: bt.Barycentre()(ssp, weights, sigma_mode=mode))
        want = bt.Barycentre()(ssp64, weights, sigma_mode=mode)
        gap = max(_abs(got.gaussian.mean, want.gaussian.mean),
                  _abs(torch.sqrt(got.gaussian.variance), torch.sqrt(want.gaussian.variance)))
        log(f"[library] Barycentre(sigma_mode={mode!r}): f32 card {dt * 1e3:.1f} ms; card vs f64 CPU "
            f"max |dmoment| {gap:.3e} degC (gate {PARITY_DEGC})")
        ok &= gap < PARITY_DEGC
    for name, args in (("MultiModelMean", ()), ("WeightedModelMean", (weights,))):
        got = getattr(bt, name)()(ssp, *args)
        want = getattr(bt, name)()(ssp64, *args)
        gap = max(_abs(got.gaussian.mean, want.gaussian.mean),
                  _abs(got.gaussian.stddev, want.gaussian.stddev))
        log(f"[library] {name}: card vs CPU max |dmoment| {gap:.3e} degC (gate {PARITY_DEGC})")
        ok &= gap < PARITY_DEGC
    obs_values = observations.data.values
    post, other = hist[0].distribution, hist[1].distribution
    scores = {name: getattr(bt.metrics, name)(post, obs_values) for name in ("nll", "rmse", "crps")}
    scores["w2_between_posteriors"] = bt.metrics.w2_between_posteriors(post, other)
    x = post.gaussian.mean + 0.01
    bt.reset_launch_counts()
    scores["log_prob"] = float(post.log_prob(x))
    log_prob_launches = bt.launch_counts()["solve_vec"]
    scores64 = float(hist64[0].distribution.log_prob(x.double().cpu()))
    log("[library] metrics of model 0's historical posterior: "
        + ", ".join(f"{k} {v:.4f}" for k, v in scores.items())
        + f"; log_prob of one vector: {log_prob_launches} vector-solve launch, f64 CPU {scores64:.4f}")
    ok &= all(np.isfinite(v) for v in scores.values()) and log_prob_launches == 1
    ok &= abs(scores["log_prob"] - scores64) < LINALG_TOL * max(1.0, abs(scores64))
    return ok


def run_library(torch, bt, inputs, dev, step_out, report, nits=LIBRARY_NITS):
    """Phase 9: the library API at full width (see the module docstring).
    ``step_out`` is phase 4's output.  Returns ``(ok, fitted, results)``:
    the float32 pass's fitted (historical, SSP) collections and
    ``ScenarioResult`` objects, which phase 11 reuses."""
    ok = True
    totals = dict.fromkeys(bt.launch_counts(), 0)
    expected = {"dba_update": 2 * 10, "dba_update_split": 0, "chol_solve": 2 * (nits + 1),
                "tri_inv": 2 * nits, "chol": 1, "dtw_cost": 0, "solve_vec": 2}
    # Per collection a Cholesky-solve and a triangular inverse per Adam step
    # and a Cholesky-solve for the posterior; one Cholesky of the weighter.
    expected_routes = {"kernel": 2 * (2 * nits + 1) + 1, "blocked": 0, "library": 0}
    log(f"[library] per scenario, expected launches {expected}, routes {expected_routes}")

    def check(si, n_models):
        nonlocal ok
        launches, routes = bt.launch_counts(), bt.route_counts()
        good = launches == expected and routes == expected_routes
        log(f"[library] scenario {si} ({n_models} models): launches {launches}, routes {routes}: "
            f"{'as expected' if good else 'NOT as expected'}")
        ok &= good
        for k, v in launches.items():
            totals[k] += v

    res32, fitted, observations, warm = _library_pass(torch, bt, inputs, dev, torch.float32, nits,
                                                      check=check)
    report["library_launches"] = totals
    m32, s32 = _bary(torch, res32)
    finite = all(bool(torch.isfinite(a).all()) for a in m32 + s32)
    wsum = max(float(np.abs(r.weights.values.sum(axis=0) - 1.0).max()) for r in res32)
    log(f"[library] run_scenario(LogLikelihoodWeight) x {len(res32)} scenarios, f32 on the card, "
        f"{nits} Adam steps: {warm:.2f} s; finite={finite}, max |sum of weights - 1| {wsum:.1e}; "
        f"launches in all {totals}")
    ok &= finite and wsum < 1e-5 and totals["solve_vec"] > 0
    log("[library] 2100 barycentre by scenario: " + ", ".join(
        f"{m_[-1].item():.3f}+-{s_[-1].item():.3f}" for m_, s_ in zip(m32, s32)))

    res64, _, _, dt = _library_pass(torch, bt, inputs, dev, torch.float64, nits)
    m64, s64 = _bary(torch, res64)
    dmean = max(_abs(a, b) for a, b in zip(m32, m64))
    dstd = max(_abs(a, b) for a, b in zip(s32, s64))
    dw = max(float(np.abs(a.weights.values - b.weights.values).max()) for a, b in zip(res32, res64))
    log(f"[library] f64 on the card: {dt:.2f} s; f32 vs f64 max |dmean| {dmean:.3e} degC, max |dstd| "
        f"{dstd:.3e} degC (gate {PARITY_DEGC}), max |dweight| {dw:.3e} (gate {WEIGHT_TOL})")
    ok &= dmean < PARITY_DEGC and dstd < PARITY_DEGC and dw < WEIGHT_TOL
    del res64, m64, s64

    hist0, ssp0 = fitted[0]
    ok &= _library_options(torch, bt, dev, hist0, ssp0, observations, res32[0].weights)

    crps, _, _, dt = _library_pass(torch, bt, inputs, dev, torch.float32, nits,
                                   weighter=bt.CRPSWeight(), scenarios=[0])
    gap = max(_abs(crps[0].barycentre.gaussian.mean, step_out[0][0]),
              _abs(torch.sqrt(crps[0].barycentre.gaussian.variance), step_out[1][0]))
    dw = float(np.abs(crps[0].weights.values[:, 0] - step_out[2][0].cpu().numpy()).max())
    log(f"[library] run_scenario(CRPSWeight) scenario 0 ({dt:.2f} s) vs the fused step: max "
        f"|dmoment| {gap:.3e} degC (gate {PARITY_DEGC}), max |dweight| {dw:.3e}")
    ok &= gap < PARITY_DEGC

    walls, fits = [], []
    for rep in range(LIBRARY_REPS):
        res, timed, _, dt = _library_pass(torch, bt, inputs, dev, torch.float32, nits)
        walls.append(dt)
        fits.append(sum(r.fit_seconds for r in res))
        log(f"[library] run {rep + 1}: {dt:.3f} s, of which the fits {fits[-1]:.3f} s")
    weights_s = scheme_s = 0.0
    for (hist, ssp), r in zip(timed, res):
        dt, _ = _wall(torch, lambda: bt.LogLikelihoodWeight()(hist, observations))
        weights_s += dt
        dt, _ = _wall(torch, lambda: bt.Barycentre()(ssp, r.weights))
        scheme_s += dt
    wall = statistics.median(walls)
    log(f"[library] {len(res)} scenarios, {nits} Adam steps: median {wall:.3f} s over {len(walls)} "
        f"runs (warm-up {warm:.3f} s); fit {statistics.median(fits):.3f} s "
        f"({statistics.median(fits) / wall:.1%}), weights {weights_s:.3f} s ({weights_s / wall:.1%}), "
        f"scheme {scheme_s:.3f} s ({scheme_s / wall:.1%}); weights and scheme timed alone")
    if not ok:
        print("chip_smoke: the library API failed its check", file=sys.stderr)
    return ok, fitted, res32



# ------------------------------------------------------------------ gridded
# The 5-degree gridded workload of benchmarks/gridded_bench.py (``500 36 72
# --profile fast``): 5 models x 36 x 72 cells x 10 realisations x 86 annual
# steps, 10 observation members; 12,960 independent (model, cell) GP fits.
GRID_M, GRID_R, GRID_T, GRID_R_OBS, GRID_SEED = 5, 10, 86, 10, 0
GRID_LAT, GRID_LON = 36, 72
GRID_NITS, GRID_KW = 30, dict(optimizer="bfgs")  # the gridded "fast" profile: scratch bfgs-30
GRID_ADAM_NITS = 500
GRID_WARM_STRIDE, GRID_WARM_FINE = 5, 20
GRID_ORACLE_CELLS = 64
GRID_TOL = 1e-3  # against the JAX package's float64 moments (gridded_bench.py:46-51)
# The bench's closeness-to-truth measure (gridded_bench.quality_gate_check):
# max |d| from the float64 converged Adam-2000 entry, held to a baseline's own
# within 2%.
GRID_TRUTH_NITS, GRID_QUALITY_SLACK = 2000, 1.02
GRID_REPS = 3
GRID_SUB = 8  # the 8 x 8 sub-grids of the library route's f64 check and the svgp mode
SVGP_EPOCHS = 10  # svgp mode: 10 epochs of 5,504 // 500 = 11 steps, 400 inducing points
SVGP_DEGC = 1e-3  # svgp mode, float64 on the card against float64 on the CPU


def make_workload_cells(cell_indices, dtype=np.float32):
    """Copy of ``benchmarks/gridded_common.make_workload_cells``: every
    cell's data from its own substream keyed on the flat cell id, so any
    subset of cells reproduces the full grid's arrays."""
    cell_indices = np.asarray(cell_indices)
    signal = np.sin(np.linspace(0, 3, GRID_T))
    block = np.empty((GRID_M, cell_indices.size, GRID_R, GRID_T), dtype=dtype)
    obs = np.empty((cell_indices.size, GRID_R_OBS, GRID_T), dtype=dtype)
    for i, c in enumerate(cell_indices):
        rng = np.random.default_rng(GRID_SEED + 1000 + int(c))
        block[:, i] = signal + 0.3 * rng.normal(size=(GRID_M, GRID_R, GRID_T))
        obs[i] = signal + 0.3 * rng.normal(size=(GRID_R_OBS, GRID_T))
    return block, obs


def _oracle_entries(name):
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "benchmarks", name)
    with open(path) as fh:
        loaded = json.load(fh)
    return loaded["entries"] if "entries" in loaded else [loaded]


def select_oracle_entry(entries, *, n_iters, n_cells, warm_stride, fine_nits, lat, lon,
                        optimizer="adam"):
    """Copy of ``benchmarks/gridded_bench.select_oracle_entry``: the entry of
    this configuration, or None (entries without an optimizer are Adam)."""
    return next(
        (
            o
            for o in entries
            if o.get("n_optim_nits") == n_iters
            and o["n_cells"] <= n_cells
            and o.get("warm_stride", 0) == warm_stride
            and o.get("optimizer", "adam") == optimizer
            and (not warm_stride or o.get("fine_nits") == fine_nits)
            and (not warm_stride or (o.get("lat"), o.get("lon")) == (lat, lon))
        ),
        None,
    )


def _oracle_gap(out, entry):
    """Max pointwise |d| of the barycentre mean and std on the oracle's cells."""
    nc = entry["n_cells"]
    mean = out[0][:nc].double().cpu().numpy()
    std = out[1][:nc].double().cpu().numpy()
    return (float(np.abs(mean - np.asarray(entry["bary_mean"])).max()),
            float(np.abs(std - np.asarray(entry["bary_std"])).max()))


def quality_gap(mean, std, truth, baseline):
    """The measure of ``benchmarks/gridded_bench.quality_gate_check``: max
    pointwise |d| of the barycentre mean and std from the ``truth`` entry on
    the first cells, for the run and for the ``baseline`` entry:
    ``((run_mean, run_std), (base_mean, base_std))``."""
    nc = min(len(mean), truth["n_cells"], baseline["n_cells"])
    tm, ts = np.asarray(truth["bary_mean"])[:nc], np.asarray(truth["bary_std"])[:nc]

    def gap(m, s):
        return (float(np.abs(np.asarray(m, np.float64)[:nc] - tm).max()),
                float(np.abs(np.asarray(s, np.float64)[:nc] - ts).max()))

    return gap(mean, std), gap(baseline["bary_mean"], baseline["bary_std"])


def quality_ok(run, base):
    """The bench's quality gate: the run no further from the truth than the
    baseline, with its 2% slack, in both moments."""
    return all(r <= b * GRID_QUALITY_SLACK for r, b in zip(run, base))


def _gridded_collections(bt, block, obs, lat, lon):
    """The gridded arrays as the library's containers: one ``ProcessModel``
    of shape (R, T, lat, lon) per model, and the observations."""
    dims = ("realisation", "time", "latitude", "longitude")
    coords = {"time": (np.datetime64("1930", "Y") + np.arange(GRID_T)).astype("datetime64[ns]"),
              "latitude": -87.5 + 5.0 * np.arange(lat), "longitude": 2.5 + 5.0 * np.arange(lon)}

    def grid(a):  # (C, R, T) -> (R, T, lat, lon)
        return np.ascontiguousarray(a.reshape(lat, lon, a.shape[1], GRID_T).transpose(2, 3, 0, 1))

    models = [bt.ProcessModel(bt.DimArray(grid(block[k]), dims, dict(coords), name="tas"),
                              f"model{k}") for k in range(block.shape[0])]
    observations = bt.ProcessModel(bt.DimArray(grid(obs), dims, dict(coords), name="tas"),
                                   "Observations")
    return models, observations


def _busy_share(torch, fn, log_dir):
    """Run ``fn`` once under the port's ``utils.profiling.trace`` (its Chrome
    trace goes to ``log_dir``): (host wall s, device busy s, busy share), the
    busy time being the union of the intervals of the kernels the profiler
    saw on the card (None when it saw none)."""
    from torch.autograd import DeviceType

    from bayesian_ensembling_tpu_torch.utils.profiling import trace

    torch.cuda.synchronize()
    with trace(log_dir) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == DeviceType.CUDA)
    busy_us, end = 0.0, float("-inf")
    for lo, hi in spans:
        if hi > end:
            busy_us += hi - max(lo, end)
            end = hi
    if not spans:
        return wall, None, None
    return wall, busy_us * 1e-6, busy_us * 1e-6 / wall


def check_gridded_kernels(torch, dev, block, report):
    """Phase 10: B1 at the step's (129,600, 86) and B2 / B3 at (12,960, 86)
    and the library route's (2,592, 86), each against its plain version (B1
    on every pair, B2 / B3 on a sample of matrices) and timed beside its
    bound (B3 also beside ``solve_triangular``)."""
    from bayesian_ensembling_tpu_torch.ops import dtw_cuda
    from bayesian_ensembling_tpu_torch.ops import linalg_cuda as lc

    ok = True
    rows = torch.randperm(GRID_M * block.shape[1] * GRID_R,
                          generator=torch.Generator().manual_seed(0))[:512].to(dev)
    series = torch.tensor(block.reshape(-1, GRID_T), device=dev)
    b3 = series.reshape(-1, GRID_R, GRID_T)
    centers = b3.mean(dim=1).repeat_interleave(GRID_R, dim=0).contiguous()
    n = series.shape[0]
    got = dtw_cuda.dba_update_batch(centers, series, impl="fused")
    want = dtw_cuda.dba_update_batch_reference(centers, series)
    torch.cuda.synchronize()
    exact = torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    err = max(_abs(got[0], want[0]), _abs(got[1], want[1]))
    del got, want
    ms = _cuda_ms(torch, lambda: dtw_cuda.dba_update_batch(centers, series, impl="fused"), 10)
    plain_ms = _cuda_ms(torch, lambda: dtw_cuda.dba_update_batch_reference(centers, series), 1)
    work = _dba_work(n, GRID_T)
    bound_ms, bound_by = _bound(*work)
    log(f"  dba_update N={n} T={GRID_T} (gridded step): exact on all {n} pairs={exact}; kernel "
        f"{ms:.4f} ms, plain {plain_ms:.1f} ms, bound {bound_ms:.5f} ms ({bound_by})")
    ok &= exact
    report["dba_update"].append(dict(t=GRID_T, n=n, err=err, ms=ms, plain_ms=plain_ms, work=work,
                                     library_ms=None))
    del centers, series

    x = b3.transpose(1, 2).contiguous()
    noise = b3.var(dim=1).clamp(min=1e-8)
    for b in (x.shape[0], x.shape[0] // GRID_M):
        ky = _matern_spd(torch, x[:b], noise[:b], dev)
        y = b3[:b, 0].contiguous()
        sel = rows[rows < b][:256]
        got = lc.chol_solve(ky, y)
        want = lc.chol_solve_reference(ky[sel], y[sel])
        torch.cuda.synchronize()
        rel = max(_rel(g[sel], w_) for g, w_ in zip(got, want))
        err = max(_abs(g[sel], w_) for g, w_ in zip(got, want))
        ms = _cuda_ms(torch, lambda: lc.chol_solve(ky, y), 20)
        plain_ms = _cuda_ms(torch, lambda: lc.chol_solve_reference(ky, y), 3)
        work = _chol_solve_work(b, GRID_T)
        bound_ms, bound_by = _bound(*work)
        log(f"  chol_solve B={b} T={GRID_T} (gridded): rel err {rel:.2e} on {sel.numel()} sampled "
            f"matrices (tol {LINALG_TOL}); kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
            f"{bound_ms:.5f} ms ({bound_by})")
        ok &= rel < LINALG_TOL
        report["chol_solve"].append(dict(t=GRID_T, n=b, err=err, ms=ms, plain_ms=plain_ms, work=work,
                                         library_ms=None))
        l = got[0]
        got_w = lc.tri_inv(l)
        want_w = lc.tri_inv_reference(l[sel])
        torch.cuda.synchronize()
        rel = _rel(got_w[sel], want_w)
        err = _abs(got_w[sel], want_w)
        ms = _cuda_ms(torch, lambda: lc.tri_inv(l), 20)
        plain_ms = _cuda_ms(torch, lambda: lc.tri_inv_reference(l), 3)
        eye = torch.eye(GRID_T, device=dev).expand_as(l)
        lib_ms = _cuda_ms(torch, lambda: torch.linalg.solve_triangular(l, eye, upper=False), 3)
        work = _triangle_work(b, GRID_T)
        bound_ms, bound_by = _bound(*work)
        log(f"  tri_inv B={b} T={GRID_T} (gridded): rel err {rel:.2e} on {sel.numel()} sampled "
            f"matrices (tol {LINALG_TOL}); kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
            f"solve_triangular {lib_ms:.4f} ms, bound {bound_ms:.5f} ms ({bound_by})")
        ok &= rel < LINALG_TOL
        report["tri_inv"].append(dict(t=GRID_T, n=b, err=err, ms=ms, plain_ms=plain_ms, work=work,
                                      library_ms=lib_ms))
        del ky, got, got_w, want, want_w, l, eye
    torch.cuda.empty_cache()
    return ok


def _gridded_stage_split(torch, bt, blk, ob, mk):
    """Wall time of each stage of one gridded bfgs-30 step, run stage by stage."""
    from bayesian_ensembling_tpu_torch.ops import gp as gp_ops

    m, c, r, t = blk.shape
    b3, m2 = blk.reshape(m * c, r, t), mk.reshape(m * c, r)
    times = {}
    times["dba"], (x, y, v) = _wall(torch, lambda: gp_ops.prepare_gp_inputs(b3, m2, dba_iterations=10))
    times["fit"], (params, _) = _wall(torch, lambda: gp_ops.fit_gp_batch_dispatch(
        x, y, v, n_optim_nits=GRID_NITS, **GRID_KW))
    times["posterior"], (mu, var) = _wall(torch, lambda: gp_ops.posterior_marginals_batch(
        params, x, y, v))
    times["tail"], _ = _wall(torch, lambda: bt.gridded_tail(
        mu.reshape(m, c, t), (var + v).reshape(m, c, t), ob, blk, mk))
    return times, (x, y, v)


def run_gridded(torch, bt, dev, report):
    """Phase 10: the gridded surface at the 5-degree north-star grid (see the
    module docstring)."""
    from bayesian_ensembling_tpu_torch.ops import gp as gp_ops

    ok = True
    c = GRID_LAT * GRID_LON
    t0 = time.perf_counter()
    block, obs = make_workload_cells(np.arange(c))
    log(f"[gridded] M={GRID_M} x {GRID_LAT}x{GRID_LON} cells x R={GRID_R} x T={GRID_T}, "
        f"R_obs={GRID_R_OBS}: {GRID_M * c} fits; inputs made in {time.perf_counter() - t0:.1f} s")
    oracle = _oracle_entries("gridded_oracle.json")
    warm_oracle = _oracle_entries("gridded_oracle_warm.json")
    pick = dict(n_cells=c, warm_stride=0, fine_nits=None, lat=GRID_LAT, lon=GRID_LON)
    bfgs_entry = select_oracle_entry(oracle, n_iters=GRID_NITS, optimizer="bfgs", **pick)
    adam_entry = select_oracle_entry(oracle, n_iters=GRID_ADAM_NITS, **pick)
    truth_entry = select_oracle_entry(oracle, n_iters=GRID_TRUTH_NITS, **pick)
    warm_entry = select_oracle_entry(warm_oracle, n_iters=GRID_NITS, n_cells=c,
                                     warm_stride=GRID_WARM_STRIDE, fine_nits=GRID_WARM_FINE,
                                     lat=GRID_LAT, lon=GRID_LON, optimizer="bfgs")
    if None in (bfgs_entry, adam_entry, truth_entry, warm_entry):
        log("[gridded] an oracle entry is missing from benchmarks/gridded_oracle*.json")
        return False

    log("[kernels] at the gridded shapes")
    ok &= check_gridded_kernels(torch, dev, block, report)

    blk = torch.tensor(block, device=dev)
    ob = torch.tensor(obs, device=dev)
    mk = torch.ones(blk.shape[:3], dtype=torch.bool, device=dev)

    def step(**kw):
        return bt.gridded_ensemble_step(blk, ob, mk, n_optim_nits=GRID_NITS, return_fit=True,
                                        **GRID_KW, **kw)

    # The warm-up run counts the host synchronisations of a step.
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            dt, _ = _wall(torch, step)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    syncs = [f"{os.path.basename(w.filename)}:{w.lineno}" for w in caught
             if "synchroniz" in str(w.message)]
    log(f"[gridded] warm-up {dt:.3f} s; host synchronisations in one step: {len(syncs)}, at "
        f"{sorted(set(syncs))}")
    walls = []
    for rep in range(GRID_REPS):
        bt.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        dt, out = _wall(torch, step)
        walls.append(dt)
        if rep == 0:
            launches, routes = bt.launch_counts(), bt.route_counts()
            peak = torch.cuda.max_memory_allocated() / 2**30
        log(f"[gridded] run {rep + 1}: {dt:.3f} s")
    report["gridded_launches"] = launches
    expected = {"dba_update": 10, "dba_update_split": 0, "chol_solve": 2 * GRID_NITS + 1,
                "tri_inv": GRID_NITS + 1, "chol": 0, "dtw_cost": 0, "solve_vec": 0}
    expected_routes = {"kernel": 3 * GRID_NITS + 2, "blocked": 0, "library": 0}
    wsum = out[2].double().sum(dim=0)
    finite = all(bool(torch.isfinite(a).all()) for a in out[:3])
    gap = _oracle_gap(out, bfgs_entry)
    log(f"[gridded] gridded_ensemble_step bfgs-{GRID_NITS} f32, {GRID_M * c} fits: median "
        f"{statistics.median(walls):.3f} s over {len(walls)} runs; peak device memory {peak:.2f} GiB; "
        f"launches {launches} (expected {expected}); routes {routes} (expected {expected_routes})")
    log(f"[gridded] first {bfgs_entry['n_cells']} cells vs the JAX float64 oracle (bfgs-{GRID_NITS}): "
        f"max |dmean| {gap[0]:.3e}, max |dstd| {gap[1]:.3e} (gate {GRID_TOL}); finite={finite}, "
        f"max |sum of weights - 1| {(wsum - 1).abs().max().item():.1e}")
    ok &= (launches == expected and routes == expected_routes and finite
           and (wsum - 1).abs().max().item() < 1e-5 and max(gap) < GRID_TOL)

    times, (x, y, v) = _gridded_stage_split(torch, bt, blk, ob, mk)
    total = sum(times.values())
    log("[gridded] stages: " + ", ".join(f"{k} {s:.3f} s ({s / total:.1%})" for k, s in times.items())
        + f"; {times['fit'] / GRID_NITS * 1e3:.2f} ms per BFGS step")
    trace_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "gridded_trace")
    wall, dev_s, share = _busy_share(torch, lambda: gp_ops.fit_gp_batch_dispatch(
        x, y, v, n_optim_nits=GRID_NITS, **GRID_KW), trace_dir)
    log(f"[gridded] profiler window over one bfgs-{GRID_NITS} fit (trace in {trace_dir}): wall "
        f"{wall:.3f} s, device "
        + ("time not measured (the profiler saw none)" if dev_s is None else
           f"kernel time {dev_s:.3f} s, busy share {share:.1%}"))
    report["gridded_profile"] = dict(wall=wall, device=dev_s, share=share)
    del x, y, v

    # The float64 refinement of the whole grid at the step's fit, on the card;
    # the first cells again in float64 by the plain versions on the CPU.
    # Phase 12 holds the sharded gridded step to this run bit for bit.
    report["gridded_f32"] = dict(blk=blk, ob=ob, mk=mk, out=out[:3], launches=launches,
                                 routes=routes)
    params, ym, yv = out[3:]
    torch.cuda.reset_peak_memory_stats()
    dt, refined = _wall(torch, lambda: bt.refined_gridded_f64(blk, ob, mk, params, (ym, yv),
                                                                device=dev))
    peak64 = torch.cuda.max_memory_allocated() / 2**30
    nc = GRID_ORACLE_CELLS

    def cells(a):
        return a[:, :nc].cpu()

    cpu = bt.refined_gridded_f64(cells(blk), ob[:nc].cpu(), cells(mk),
                                 bt.BatchedGPParams(cells(params.raw_lengthscale),
                                                    cells(params.raw_variance)),
                                 (cells(ym), cells(yv)), device="cpu")
    rgap = max(float(np.abs(refined[0][:nc] - cpu[0]).max()),
               float(np.abs(refined[1][:nc] - cpu[1]).max()))
    drift = max(_abs(torch.from_numpy(refined[0]), out[0]), _abs(torch.from_numpy(refined[1]), out[1]))
    log(f"[gridded] refined_gridded_f64 on the card, whole grid in one piece: {dt:.3f} s, peak "
        f"device memory {peak64:.2f} GiB; vs float64 plain on the CPU ({nc} cells): {rgap:.3e} "
        f"(gate {REFINED_DEGC}); f32 -> f64 drift {drift:.3e}")
    ok &= rgap < REFINED_DEGC and all(np.isfinite(a).all() for a in refined)
    del out, params, ym, yv, refined

    # Adam-500 on the oracle's cells.
    dt, adam = _wall(torch, lambda: bt.gridded_ensemble_step(
        blk[:, :nc].contiguous(), ob[:nc].contiguous(), mk[:, :nc].contiguous(),
        n_optim_nits=GRID_ADAM_NITS))
    gap = _oracle_gap(adam, adam_entry)
    log(f"[gridded] Adam-{GRID_ADAM_NITS} on the first {nc} cells ({GRID_M * nc} fits): {dt:.3f} s; "
        f"vs the oracle max |dmean| {gap[0]:.3e}, max |dstd| {gap[1]:.3e} (gate {GRID_TOL})")
    ok &= max(gap) < GRID_TOL

    # The coarse-to-fine warm start: bfgs-30 on every 5th row and column,
    # then bfgs-20 on every cell from its nearest coarse cell.
    def warm():
        init = bt.coarse_warm_start(blk, mk, GRID_LAT, GRID_LON, GRID_WARM_STRIDE,
                                    n_optim_nits=GRID_NITS, **GRID_KW)
        return bt.gridded_ensemble_step(blk, ob, mk, gp_init=init, n_optim_nits=GRID_WARM_FINE,
                                        **GRID_KW)

    _wall(torch, warm)
    dt, wout = _wall(torch, warm)
    nc = warm_entry["n_cells"]
    finite = all(bool(torch.isfinite(a).all()) for a in wout[:3])
    first = [a[:nc].double().cpu().numpy() for a in wout[:2]]
    (q32, q_warm), (_, q_500) = (quality_gap(*first, truth_entry, warm_entry),
                                 quality_gap(*first, truth_entry, adam_entry))
    gap = _oracle_gap(wout, warm_entry)
    blk, ob = blk.double(), ob.double()
    dt64, w64 = _wall(torch, warm)
    gap64 = _oracle_gap(w64, warm_entry)
    log(f"[gridded] warm start (stride {GRID_WARM_STRIDE}, bfgs-{GRID_NITS} coarse, "
        f"bfgs-{GRID_WARM_FINE} fine), first {nc} cells: f32 {dt:.3f} s; its max |d| from the "
        f"float64 Adam-{GRID_TRUTH_NITS} truth: mean {q32[0]:.5f}, std {q32[1]:.5f} (gate: no worse "
        f"than the JAX float64 run of this configuration, {q_warm[0]:.5f} / {q_warm[1]:.5f}, "
        f"x{GRID_QUALITY_SLACK}; scratch Adam-{GRID_ADAM_NITS} {q_500[0]:.5f} / {q_500[1]:.5f}, the "
        f"bench's baseline, which that JAX run misses too, ROADMAP C11); f32 vs the warm oracle "
        f"max |dmean| {gap[0]:.3e}, max |dstd| {gap[1]:.3e} (reported); f64 on the card "
        f"{dt64:.3f} s, vs the warm oracle max |dmean| {gap64[0]:.3e}, max |dstd| {gap64[1]:.3e} "
        f"(gate {GRID_TOL})")
    ok &= quality_ok(q32, q_warm) and max(gap64) < GRID_TOL and finite
    del wout, w64, blk, ob, mk
    torch.cuda.empty_cache()
    ok &= run_gridded_library(torch, bt, dev, block, obs)
    if not ok:
        print("chip_smoke: the gridded phase failed its check", file=sys.stderr)
    return ok


def run_gridded_library(torch, bt, dev, block, obs):
    """Phase 10, the library route: ``run_gridded_scenario`` over the five
    gridded ``ProcessModel`` objects (``GPDTW3D`` batched mode, one model's
    2,592 cells a batch, 500 Adam steps); float32 against float64 on an 8 x 8
    sub-grid; ``LogLikelihoodWeight``'s diagonal branch; and ``GPDTW3D``'s
    svgp mode on the card against the CPU."""
    ok = True
    models, observations = _gridded_collections(bt, block, obs, GRID_LAT, GRID_LON)
    # One emulation a model: 10 DBA passes, and a B2 and a B3 launch for each
    # of the Adam steps and for the posterior; the diagonal posteriors send
    # no weighter to B4 or B5.
    fits = GRID_M * (GRID_ADAM_NITS + 1)
    expected = {"dba_update": 10 * GRID_M, "dba_update_split": 0, "chol_solve": fits,
                "tri_inv": fits, "chol": 0, "dtw_cost": 0, "solve_vec": 0}
    bt.reset_launch_counts()
    dt, (w, bary) = _wall(torch, lambda: bt.run_gridded_scenario(
        bt.ModelCollection(models), observations, n_optim_nits=GRID_ADAM_NITS, device=dev))
    launches = bt.launch_counts()
    finite = bool(np.isfinite(bary.mean.values).all() and np.isfinite(bary.stddev.values).all())
    wsum = float(np.abs(w.values.sum(axis=0) - 1.0).max())
    log(f"[gridded-library] run_gridded_scenario(CRPSWeight), {GRID_M} x {GRID_LAT}x{GRID_LON}, "
        f"f32, {GRID_ADAM_NITS} Adam steps: {dt:.3f} s; launches {launches} (expected {expected}); "
        f"finite={finite}, max |sum of weights - 1| {wsum:.1e}")
    ok &= finite and wsum < 1e-5 and launches == expected

    sub = (np.arange(GRID_SUB)[:, None] * GRID_LON + np.arange(GRID_SUB)[None, :]).ravel()
    small, small_obs = _gridded_collections(bt, block[:, sub], obs[sub], GRID_SUB, GRID_SUB)
    res = {}
    for dtype in (torch.float32, torch.float64):
        dt, res[dtype] = _wall(torch, lambda: bt.run_gridded_scenario(
            bt.ModelCollection([bt.ProcessModel(pm.data, pm.name) for pm in small]), small_obs,
            emulator=bt.GPDTW3D(dtype=dtype), device=dev))
        log(f"[gridded-library] {GRID_SUB}x{GRID_SUB} sub-grid, {dtype}: {dt:.3f} s")
    (w32, b32), (w64, b64) = res[torch.float32], res[torch.float64]
    dmean = float(np.abs(b32.mean.values - b64.mean.values).max())
    dstd = float(np.abs(b32.stddev.values - b64.stddev.values).max())
    dw = float(np.abs(w32.values - w64.values).max())
    log(f"[gridded-library] f32 vs f64 on the card: max |dmean| {dmean:.3e} degC, max |dstd| "
        f"{dstd:.3e} degC (gate {PARITY_DEGC}), max |dweight| {dw:.3e}")
    ok &= dmean < PARITY_DEGC and dstd < PARITY_DEGC

    bt.reset_launch_counts()
    dt, (wl, bl) = _wall(torch, lambda: bt.run_gridded_scenario(
        bt.ModelCollection([bt.ProcessModel(pm.data, pm.name) for pm in small]), small_obs,
        weighter=bt.LogLikelihoodWeight(), n_optim_nits=GRID_ADAM_NITS, device=dev))
    launches = bt.launch_counts()
    finite = bool(np.isfinite(bl.mean.values).all())
    log(f"[gridded-library] LogLikelihoodWeight on the diagonal posteriors: {dt:.3f} s; launches "
        f"{launches} (expected {expected}: chol and solve_vec stay 0); finite={finite}")
    ok &= finite and launches == expected

    # The svgp mode: the minibatch indices come from a CPU generator seeded
    # by (seed, step), so the card and the CPU take the same minibatches.
    svgp = []
    for where in (dev, torch.device("cpu")):
        mc = bt.ModelCollection([bt.ProcessModel(small[0].data, small[0].name)])
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            em = bt.GPDTW3D(mode="svgp", dtype=torch.float64)
        dt, _ = _wall(torch, lambda: mc.fit(em, n_optim_nits=SVGP_EPOCHS, device=where))
        g = mc[0].distribution.gaussian
        svgp.append((g.mean.cpu(), torch.sqrt(g.var).cpu()))
        log(f"[gridded-svgp] GPDTW3D(mode='svgp') float64, {GRID_SUB}x{GRID_SUB} cells x {GRID_T} "
            f"steps, {SVGP_EPOCHS} epochs, 400 inducing points, on {where.type}: {dt:.3f} s")
    gap = max(_abs(svgp[0][0], svgp[1][0]), _abs(svgp[0][1], svgp[1][1]))
    log(f"[gridded-svgp] card vs CPU: max |dmoment| {gap:.3e} degC (gate {SVGP_DEGC})")
    ok &= gap < SVGP_DEGC and bool(torch.isfinite(svgp[0][0]).all())
    return ok


# --------------------------------------------------------- validation, serving
# Phase 11: the perfect-model test and the served projections on phase 9's
# float32 posteriors (7 scenarios, 12 to 16 models, R up to 29, T = 165 / 86).
PMT_KINDS = ("crps", "loglik", "ksd", "inverse_square", "uniform")
PMT_PAD = (16, 29)  # the campaign CLI's shape bucket for the 7 scenarios
PMT_DEGC = 1e-3  # f32 card vs f64 CPU at the same posteriors: rmse, crps, w2 (degC)
PMT_NLL_REL = 1e-3  # ... and nll, relative
PMT_LOOP_REL = 1e-4  # the fold loop against the batched function, f32, relative
PMT_FIT_NITS = 500  # fresh fits per fold: phase 9's depth, cut from the CLI's 1,000
PMT_PAD_REL = 1e-5  # padded against unpadded, f32 on the card, relative
SERVE_YEAR = 2100
Z95 = 1.959963984540054  # two-sided 95% Gaussian quantile
# Columns of batched_pmt's (M, 8) scores: nll, rmse, w2, crps for the
# barycentre, then for the multi-model mean.
PMT_COLUMNS = ("nll", "rmse", "w2", "crps", "nll_mmm", "rmse_mmm", "w2_mmm", "crps_mmm")
NLL_COLS, DEGC_COLS = (0, 4), (1, 2, 3, 5, 6, 7)


def pmt_gaps(got, want):
    """(max |d| over the rmse / w2 / crps columns in degC, max |d| of each
    nll column relative to that column's largest |value|, at least 1)
    between two (M, 8) score arrays."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    degc = float(np.abs(got[:, DEGC_COLS] - want[:, DEGC_COLS]).max())
    want_nll = want[:, NLL_COLS]
    scale = np.maximum(np.abs(want_nll).max(axis=0), 1.0)
    nll = float((np.abs(got[:, NLL_COLS] - want_nll) / scale).max())
    return degc, nll


def col_rel_gap(got, want):
    """Largest |d| of each column over that column's largest |value|."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = np.maximum(np.abs(want).max(axis=0), 1e-12)
    return float((np.abs(got - want) / scale).max())


def pmt_launches(kind, n_folds=0, n_models=0):
    """Expected launches of one ``batched_pmt`` call of ``kind`` on
    full-covariance posteriors (the loglik table: one Cholesky of all the
    models' covariances and two forward-only vector solves), plus those of
    ``n_folds`` library ``LogLikelihoodWeight`` calls (the same three a
    fold)."""
    table = 1 if kind == "loglik" else 0
    return {"dba_update": 0, "dba_update_split": 0, "chol_solve": 0, "tri_inv": 0,
            "chol": table + n_folds, "dtw_cost": 0, "solve_vec": 2 * (table + n_folds)}


def fold_fit_launches(n_folds, nits, dba_iterations=10):
    """Expected launches of the fold loop with fresh ``GPDTW1D`` fits: three
    fits a fold (the remaining hindcast models, the remaining forecast
    models, the pseudo truth), each ``dba_iterations`` DBA updates, a
    Cholesky-solve per Adam step and for the posterior and a triangular
    inverse per Adam step; then the fold's ``LogLikelihoodWeight``."""
    out = pmt_launches("uniform", n_folds=n_folds)
    out.update(dba_update=3 * n_folds * dba_iterations, chol_solve=3 * n_folds * (nits + 1),
               tri_inv=3 * n_folds * nits)
    return out


def _get_json(url):
    import urllib.error
    import urllib.request

    try:
        with urllib.request.urlopen(url, timeout=30) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def serve_roundtrip(svc_cls, results, directory, year=SERVE_YEAR):
    """``ProjectionService.from_results`` on ``results`` (name ->
    ``ScenarioResult``), a save / load round trip through ``directory``, and
    an HTTP server on an ephemeral localhost port answering a projection,
    a trajectory and one bad query (400); every answer held against the
    barycentre moments.  Returns ``(ok, lines)``; the server is shut down."""
    import threading

    svc = svc_cls.from_results(results)
    svc.save(directory)
    loaded = svc_cls.load(directory)
    lines = [f"saved and loaded {len(loaded.scenarios())} artifacts"]
    ok = loaded.scenarios() == sorted(results)
    name = sorted(results)[0]
    post = results[name].barycentre
    mean = post.gaussian.mean.detach().double().cpu().numpy()
    std = np.sqrt(post.gaussian.variance.detach().double().cpu().numpy())
    years = post.template.time.astype("datetime64[Y]").astype(int) + 1970
    k = int(np.argmin(np.abs(years - year)))
    server = loaded.make_http_server("127.0.0.1", 0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        base = f"http://127.0.0.1:{server.server_address[1]}"
        code, listed = _get_json(f"{base}/scenarios")
        ok &= code == 200 and listed["scenarios"] == sorted(results)
        code, proj = _get_json(f"{base}/project?scenario={name}&year={year}")
        gap = max(abs(proj["mean"] - mean[k]), abs(proj["hi"] - (mean[k] + Z95 * std[k])),
                  abs(proj["lo"] - (mean[k] - Z95 * std[k])))
        ok &= code == 200 and proj["year"] == int(years[k]) and gap < 1e-9
        lines.append(f"/project {name} {proj['year']}: {proj['mean']:.4f} "
                     f"[{proj['lo']:.4f}, {proj['hi']:.4f}], max |d| from the barycentre {gap:.1e}")
        code, traj = _get_json(f"{base}/trajectory?scenario={name}")
        tgap = max(float(np.abs(np.asarray(traj["mean"]) - mean).max()),
                   float(np.abs(np.asarray(traj["std"]) - std).max()))
        ok &= code == 200 and len(traj["years"]) == len(mean) and tgap < 1e-9
        lines.append(f"/trajectory {name}: {len(traj['years'])} steps, max |d| {tgap:.1e}")
        code, bad = _get_json(f"{base}/project?scenario=no-such-scenario&year={year}")
        ok &= code == 400 and "unknown scenario" in bad["error"]
        lines.append(f"/project of an unknown scenario: {code} ({bad['error'][:40]}...)")
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
    ok &= not thread.is_alive()
    return bool(ok), lines


class recorded_gridded_posteriors:
    """Within the ``with`` block, every ``ProjectionService.from_gridded``
    call also records the posteriors it was built from (the served ones)."""

    def __init__(self, svc_cls):
        self.svc_cls, self.posteriors = svc_cls, {}

    def __enter__(self):
        original = self.original = self.svc_cls.__dict__["from_gridded"]

        def from_gridded(cls, posteriors):
            self.posteriors.update(posteriors)
            return original.__func__(cls, posteriors)

        self.svc_cls.from_gridded = classmethod(from_gridded)
        return self

    def __exit__(self, *exc):
        self.svc_cls.from_gridded = self.original
        return False


def gridded_serve_gap(svc, name, post, year=SERVE_YEAR):
    """Largest |d| between ``project_point`` at every cell / ``map_grid`` of
    the served artifact and the posterior it was built from."""
    mean = post.mean.values.astype(np.float64)
    std = np.sqrt(post.variance.values.astype(np.float64))
    years = post.template.time.astype("datetime64[Y]").astype(int) + 1970
    k = int(np.argmin(np.abs(years - year)))
    lats = post.template.get_coord("latitude")
    lons = post.template.get_coord("longitude")
    gap = 0.0
    for i, la in enumerate(lats):
        for j, lo in enumerate(lons):
            p = svc.project_point(name, year, float(la), float(lo))
            gap = max(gap, abs(p["mean"] - mean[k, i, j]),
                      abs(p["hi"] - (mean[k, i, j] + Z95 * std[k, i, j])))
    grid = svc.map_grid(name, year)
    gap = max(gap, float(np.abs(np.asarray(grid["mean"]) - mean[k]).max()),
              float(np.abs(np.asarray(grid["std"]) - std[k]).max()))
    return gap


def run_validation(torch, bt, dev, inputs, fitted, results, report):
    """Phase 11: the perfect-model test and serving (see the module
    docstring).  ``fitted`` and ``results`` are phase 9's float32 fitted
    (historical, SSP) collections and ``ScenarioResult`` objects."""
    import tempfile

    t_phase = time.perf_counter()
    ok = True
    totals = dict.fromkeys(bt.launch_counts(), 0)

    def counted(expected, label):
        nonlocal ok
        launches = bt.launch_counts()
        good = launches == expected
        if not good:
            log(f"[validation] {label}: launches {launches}, expected {expected}")
        ok &= good
        for k_, v in launches.items():
            totals[k_] += v

    # (a) batched_pmt, every weight kind under the campaign's shape bucket,
    # float32 on the card against float64 on the CPU at the same posteriors.
    t0 = time.perf_counter()
    worst = {}
    card_s = cpu_s = 0.0
    for si, (hist, ssp) in enumerate(fitted):
        hist64, ssp64 = _posteriors_f64_on_cpu(bt, hist), _posteriors_f64_on_cpu(bt, ssp)
        variants = [(kind, {}) for kind in PMT_KINDS]
        if si == 0:
            variants += [("crps", {"sigma_mode": "compat"}), ("crps", {"sigma_mode": "mixture"}),
                         ("crps", {"include_sim": True})]
        for kind, kw in variants:
            bt.reset_launch_counts()
            dt, got = _wall(torch, lambda: bt.batched_pmt(hist, ssp, kind, pad_shape=PMT_PAD, **kw))
            card_s += dt
            counted(pmt_launches(kind), f"scenario {si} {kind} {kw}")
            t1 = time.perf_counter()
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")  # compat's cap warning, on both sides alike
                want = bt.batched_pmt(hist64, ssp64, kind, pad_shape=PMT_PAD, **kw)
            cpu_s += time.perf_counter() - t1
            degc, nll = pmt_gaps(got, want)
            label = kind + "".join(f" {k_}={v}" for k_, v in kw.items())
            prev = worst.get(label, (0.0, 0.0, 0, ""))
            col = PMT_COLUMNS[int(np.argmax(np.abs(np.asarray(got, np.float64) - want).max(
                axis=0) * np.isin(np.arange(8), DEGC_COLS)))]
            worst[label] = (max(prev[0], degc), max(prev[1], nll), prev[2] + 1,
                            col if degc >= prev[0] else prev[3])
            ok &= bool(np.isfinite(got).all()) and degc < PMT_DEGC and nll < PMT_NLL_REL
        if si == 0:
            log(f"[validation] scenario 0 ({len(hist)} models), {label}: means "
                "over the folds: " + ", ".join(
                    f"{n} {v:.4f}" for n, v in zip(PMT_COLUMNS, want.mean(axis=0))))
    for label, (degc, nll, n, col) in worst.items():
        log(f"[validation] batched_pmt {label}, pad_shape {PMT_PAD}: f32 card vs f64 CPU over "
            f"{n} scenario(s): max |d| rmse/w2/crps {degc:.3e} degC ({col}; gate {PMT_DEGC}), "
            f"max rel |d| nll {nll:.3e} (gate {PMT_NLL_REL})")
    log(f"[validation] (a) {sum(v[2] for v in worst.values())} batched_pmt calls: card "
        f"{card_s:.2f} s, f64 CPU reference {cpu_s:.2f} s, all {time.perf_counter() - t0:.1f} s")
    sizes = [len(h) for h, _ in fitted]
    si = int(np.argmin(sizes))
    hist, ssp = fitted[si]
    bt.reset_launch_counts()
    plain = bt.batched_pmt(hist, ssp, "loglik")
    padded = bt.batched_pmt(hist, ssp, "loglik", pad_shape=PMT_PAD)
    counted(pmt_launches("loglik", n_folds=1), "padded vs unpadded")
    gap = col_rel_gap(padded, plain)
    log(f"[validation] scenario {si} ({sizes[si]} models) loglik: padded to {PMT_PAD} vs unpadded, "
        f"max rel |d| {gap:.3e} (gate {PMT_PAD_REL})")
    ok &= gap < PMT_PAD_REL

    # (b) the fold loop on the same prefit posteriors against the batched
    # function: LogLikelihoodWeight on every fold (a Cholesky and two vector
    # solves each), the largest scenario.
    si = int(np.argmax(sizes))
    hist, ssp = fitted[si]
    pmt = bt.PerfectModelTest(hist, ssp, None, bt.LogLikelihoodWeight, bt.Barycentre,
                              f"scenario{si}")
    bt.reset_launch_counts()
    dt_loop, (names, loop) = _wall(torch, lambda: pmt._fold_scores(use_prefit_models=True))
    counted(pmt_launches("uniform", n_folds=len(names)), "fold loop, prefit")
    bt.reset_launch_counts()
    dt_b, batched = _wall(torch, lambda: bt.batched_pmt(hist, ssp, "loglik"))
    counted(pmt_launches("loglik"), "batched, for the loop")
    gap = col_rel_gap(loop, batched)
    log(f"[validation] (b) scenario {si} ({len(names)} folds), LogLikelihoodWeight: fold loop "
        f"{dt_loop:.3f} s vs batched {dt_b * 1e3:.1f} ms, f32 on the card; max rel |d| {gap:.3e} "
        f"(gate {PMT_LOOP_REL}); {len(names)} B4 and {2 * len(names)} B5 launches in the loop")
    ok &= gap < PMT_LOOP_REL and names == hist.model_names

    # (c) the harness with fresh fits per fold (16 folds x 3 GPDTW1D fits),
    # float32 and float64 on the card.
    built, _ = library_scenarios(bt, inputs)
    scores, walls = {}, {}
    for dtype in (torch.float32, torch.float64):
        raw_hist, raw_ssp = built[si]
        fresh = bt.PerfectModelTest(raw_hist, raw_ssp, lambda: bt.GPDTW1D(dtype=dtype),
                                    bt.LogLikelihoodWeight, bt.Barycentre, f"scenario{si}")
        bt.reset_launch_counts()
        walls[dtype], (_, scores[dtype]) = _wall(torch, lambda: fresh._fold_scores(
            n_optim_nits=PMT_FIT_NITS, device=dev))
        counted(fold_fit_launches(len(raw_hist), PMT_FIT_NITS), f"fresh fits {dtype}")
        ok &= all(pm.distribution is None for pm in raw_hist) and bool(
            np.isfinite(scores[dtype]).all())
    degc, nll = pmt_gaps(scores[torch.float32], scores[torch.float64])
    f32, f64 = scores[torch.float32], scores[torch.float64]
    log(f"[validation] (c) fresh fits, {len(f32)} folds x 3 GPDTW1D fits x {PMT_FIT_NITS} Adam steps: "
        f"f32 {walls[torch.float32]:.2f} s, f64 {walls[torch.float64]:.2f} s on the card; "
        f"max |d| rmse/w2/crps {degc:.3e} degC (gate {PARITY_DEGC}); nll f32 "
        f"{f32[:, 0].mean():.4f} vs f64 {f64[:, 0].mean():.4f} (mean over folds, max rel |d| "
        f"{nll:.3e}, not gated)")
    ok &= degc < PARITY_DEGC
    report["validation_launches"] = dict(totals)

    # (d) serving: phase 9's results, then the gridded artifacts.
    serve = bt.serve
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        good, lines = serve_roundtrip(serve.ProjectionService,
                                      {r.ssp: r for r in results}, os.path.join(tmp, "gmst"))
        for line in lines:
            log(f"[serve] {line}")
        log(f"[serve] from_results x {len(results)}, save / load and HTTP: "
            f"{time.perf_counter() - t0:.2f} s; {'as expected' if good else 'FAILED'}")
        ok &= good
        bt.reset_launch_counts()
        with recorded_gridded_posteriors(serve.ProjectionService) as rec:
            dt, svc = _wall(torch, lambda: serve.build_gridded_artifacts(
                os.path.join(tmp, "gridded"), device=dev))
        launches = bt.launch_counts()
        report["serve_launches"] = launches
        m, nits = 5, 500  # build_gridded_artifacts' defaults: 5 models, 500 Adam steps
        expected = {"dba_update": 10 * m, "dba_update_split": 0, "chol_solve": m * (nits + 1),
                    "tri_inv": m * (nits + 1), "chol": 0, "dtw_cost": 0, "solve_vec": 0}
        loaded = serve.ProjectionService.load(os.path.join(tmp, "gridded"))
        gap = gridded_serve_gap(loaded, "gridded", rec.posteriors["gridded"])
        log(f"[serve] build_gridded_artifacts (12 x 24 cells, 5 models, 10 realisations, T = 86, "
            f"{nits} Adam steps) on the card: {dt:.2f} s; launches {launches} (expected "
            f"{expected}); project_point at every cell and map_grid vs the served posterior: max "
            f"|d| {gap:.1e}")
        ok &= launches == expected and gap < 1e-6
    log(f"[validation] phase 11: {time.perf_counter() - t_phase:.1f} s")
    if not ok:
        print("chip_smoke: the validation or serving phase failed its check", file=sys.stderr)
    return ok


# ------------------------------------------------------------- sharded surfaces
# Phase 12: the sharded surfaces (bayesian_ensembling_tpu_torch/parallel/mesh.py)
# through a one-rank NCCL process group, at the widths of phases 4, 6 and 10.
# The annual step on two ranks against one rank: float64 to 1e-5 degC; float32
# to the float32 gate, since at 8 models a batch PyTorch's batched products
# round otherwise than at 16 and Adam carries that on (2.611e-5 degC at 500
# steps on the H100, PERF.md section 6).
SHARDED_TWO_RANK_DEGC = {"float64": 1e-5, "float32": PARITY_DEGC}
SHARDED_TIMEOUT = 300  # seconds for the two-rank run, the processes' start included


def _local(x):
    """A sharded output's block on this rank (on one rank, the whole array)."""
    return x.to_local() if hasattr(x, "to_local") else x


def _bitwise(torch, got, want):
    """(every output equal bit for bit, the largest |difference|)."""
    got = [_local(g) for g in got]
    same = all(g.shape == w.shape and g.dtype == w.dtype and bool(torch.equal(g, w))
               for g, w in zip(got, want))
    return same, max(_abs(g, w) for g, w in zip(got, want))


def _f32(a):
    return a.astype(np.float32) if a.dtype.kind == "f" else a


def sharded_two_rank_worker(rank, world, runs, nits, device_type="cuda"):
    """One rank of the annual sharded step on ``world`` gloo ranks that share
    the card (NCCL refuses two ranks on one device).  First each collective
    of the sharded paths on CUDA tensors; the step on each of ``runs``
    (``{dtype name: the step's arrays}``) only if gloo takes them all.
    Rank 0's return value reaches the parent.  (``device_type="cpu"``
    rehearses it without a card.)"""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    import bayesian_ensembling_tpu_torch as bt
    from bayesian_ensembling_tpu_torch.parallel import mesh as mesh_ops

    def stage(msg):
        log(f"[sharded]   rank {rank} of {world}: {msg}")

    dev = torch.device(device_type, 0) if device_type == "cuda" else torch.device(device_type)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    probe = {}
    for name, call in (
        ("all_reduce", lambda: dist.all_reduce(torch.ones(4, device=dev))),
        ("all_gather_into_tensor", lambda: dist.all_gather_into_tensor(
            torch.empty(4 * world, device=dev), torch.ones(4, device=dev))),
    ):
        try:
            call()
            if dev.type == "cuda":
                torch.cuda.synchronize()
            probe[name] = "ok"
        except RuntimeError as e:
            probe[name] = f"{type(e).__name__}: {e}".splitlines()[0]
    stage(f"collectives on {dev.type} tensors: {probe}")
    out = dict(probe=probe)
    if any(v != "ok" for v in probe.values()):
        return out
    mesh = init_device_mesh(dev.type, (world,), mesh_dim_names=("model",))
    step = bt.make_sharded_step(mesh, n_optim_nits=nits, dba_iterations=10)
    for dtype, arrays in runs.items():
        bt.reset_launch_counts()
        got = step(*arrays)
        out[dtype] = dict(collectives=bt.collective_counts(), launches=bt.launch_counts())
        stage(f"{dtype} step done; collectives {out[dtype]['collectives']}")
        with mesh_ops.use_mesh(mesh):  # every rank's weights, for the comparison
            weights = mesh_ops.all_gather(got[2].to_local(), "model")
        out[dtype]["values"] = [a.cpu().numpy() for a in (got[0], got[1], weights)]
    return out


def run_sharded(torch, bt, dev, inputs, annual, report, backend="nccl"):
    """Phase 12: the sharded surfaces through a one-rank NCCL process group
    and CUDA meshes, each held bit for bit to the unsharded run of an earlier
    phase (``annual``: phase 4's output and counts; ``report``: phase 6's and
    phase 10's), with its collective and launch counts; then the annual step
    on two gloo ranks sharing the card, against one rank.  (A CPU ``dev``
    with ``backend="gloo"`` rehearses it without a card.)"""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    t_phase = time.perf_counter()
    ok = True
    address = f"tcp://127.0.0.1:{bt.parallel.mesh.free_port()}"
    dist.init_process_group(backend, init_method=address, world_size=1, rank=0)
    try:
        mesh_1d = init_device_mesh(dev.type, (1,), mesh_dim_names=("model",))
        mesh_sm = init_device_mesh(dev.type, (1, 1), mesh_dim_names=("scenario", "model"))
        mesh_mc = init_device_mesh(dev.type, (1, 1), mesh_dim_names=("model", "cells"))
        log(f"[sharded] one-rank {backend} group; meshes {mesh_1d}, {mesh_sm}, {mesh_mc}")
        # A group's communicator is made at its first collective: set them up
        # here, so that the surfaces' times are steady ones.
        t0 = time.perf_counter()
        for mesh in (mesh_1d, mesh_sm, mesh_mc):
            for name in mesh.mesh_dim_names:
                dist.all_reduce(torch.zeros(1, device=dev), group=mesh.get_group(name))
        if dev.type == "cuda":
            torch.cuda.synchronize()
        log(f"[sharded] first collective on each of the meshes' 5 groups: "
            f"{time.perf_counter() - t0:.3f} s (communicator set-up)")
        launches = {}

        def surface(name, fn, want, want_collectives, want_launches, want_routes):
            bt.reset_launch_counts()
            dt, got = _wall(torch, fn)
            counts = (bt.collective_counts(), bt.launch_counts(), bt.route_counts())
            for k, v in counts[1].items():
                launches[k] = launches.get(k, 0) + v
            same, gap = _bitwise(torch, got, want)
            good = same and counts == (want_collectives, want_launches, want_routes)
            log(f"[sharded] {name}: {dt:.3f} s; bit for bit the unsharded run's: {same} (largest "
                f"|difference| {gap:.3e}, gate 0); collectives {counts[0]} (expected "
                f"{want_collectives}); launches and routes as the unsharded run's: "
                f"{counts[1:] == (want_launches, want_routes)}")
            if not good:
                log(f"[sharded]   launches {counts[1]} (expected {want_launches}); routes "
                    f"{counts[2]} (expected {want_routes})")
            return good

        # (a) The flagship's 7 SSPs x 16 models on a (scenario 1, model 1) mesh,
        # phase 4's depth.
        step = bt.make_sharded_multi_scenario_step(mesh_sm, scenario_axis="scenario",
                                                   n_optim_nits=PARITY_NITS, dba_iterations=10)
        s_, m_, _, t_h = inputs[0].shape
        ok &= surface(f"make_sharded_multi_scenario_step, {s_} x {m_} models, "
                      f"T={t_h}/{inputs[2].shape[-1]}, {PARITY_NITS} Adam steps", lambda: step(*_tensors(torch, inputs, dev,
                                                                          torch.float32)),
                      annual["out"], {"all_reduce": 3, "all_gather": 0}, annual["launches"],
                      annual["routes"])

        # (b) The native-monthly campaign of phase 6 on the ("model",) mesh.
        m = report.pop("monthly_f32")
        pack = m["pack"]
        campaign = bt.make_sharded_dedup_campaign(mesh_1d, hist_chunk=HIST_CHUNK,
                                                  n_optim_nits=MONTHLY_NITS, dba_iterations=10)
        args = [_f32(np.asarray(a)) for a in (pack.uh, pack.um, pack.usb, pack.usm, pack.uidx,
                                              pack.sidx, m["obs"], pack.hb, pack.hm, pack.mmask)]
        ok &= surface(f"make_sharded_dedup_campaign, {pack.uh.shape[0]} + {pack.usb.shape[0]} fits, "
                      f"T={T_HIST_M}/{T_SSP_M}, {MONTHLY_NITS} Adam steps",
                      lambda: campaign(*args), m["out"], {"all_reduce": 0, "all_gather": 2},
                      m["launches"], m["routes"])
        del m, args

        # (c) The 5-degree grid of phase 10 (bfgs-30) on a (model 1, cells 1) mesh.
        g = report.pop("gridded_f32")
        gstep = bt.make_sharded_gridded_step(mesh_mc, n_optim_nits=GRID_NITS, **GRID_KW)
        ok &= surface(f"make_sharded_gridded_step, {GRID_M} x {GRID_LAT * GRID_LON} cells, "
                      f"bfgs-{GRID_NITS}", lambda: gstep(g["blk"], g["ob"], g["mk"], None),
                      g["out"], {"all_reduce": 3, "all_gather": 0}, g["launches"], g["routes"])
        del g
        report["sharded_launches"] = launches

        # (d) The annual step (scenario 0: 16 models) on one rank, then on two
        # gloo ranks sharing the card.
        hb, hm, sb, sm, obs, mm = inputs
        scenario0 = (hb[0], hm[0], sb[0], sm[0], obs, mm[0])
        runs = {"float64": [a.astype(np.float64) if a.dtype.kind == "f" else a for a in scenario0],
                "float32": [_f32(a) for a in scenario0]}
        one = bt.make_sharded_step(mesh_1d, n_optim_nits=PARITY_NITS, dba_iterations=10)
        ref, ref_launches = {}, {}
        for dtype, arrays in runs.items():
            bt.reset_launch_counts()
            dt, got = _wall(torch, lambda: one(*arrays))
            ref[dtype] = [_local(r).cpu().numpy() for r in got]
            ref_launches[dtype] = bt.launch_counts()
            log(f"[sharded] make_sharded_step, one rank, {m_} models, {PARITY_NITS} Adam steps, "
                f"{dtype}: {dt:.3f} s")
    finally:
        dist.destroy_process_group()
    t0 = time.perf_counter()
    two = bt.parallel.run_local(sharded_two_rank_worker, 2, runs, PARITY_NITS, dev.type,
                                timeout=SHARDED_TIMEOUT)
    dt = time.perf_counter() - t0
    log(f"[sharded] gloo on {dev.type} tensors, two ranks on the card: {two['probe']}")
    if all(dtype in two for dtype in runs):
        log(f"[sharded] make_sharded_step on two ranks ({m_ // 2} models each), float64 then "
            f"float32: {dt:.1f} s with the processes' start")
        for dtype in runs:
            res = two[dtype]
            gap = max(float(np.abs(a - b).max()) for a, b in zip(res["values"], ref[dtype]))
            ok &= (gap < SHARDED_TWO_RANK_DEGC[dtype] and res["launches"] == ref_launches[dtype]
                   and res["collectives"] == {"all_reduce": 3, "all_gather": 0})
            log(f"[sharded]   {dtype}: vs one rank max |d| {gap:.3e} (gate "
                f"{SHARDED_TWO_RANK_DEGC[dtype]}); rank 0's collectives {res['collectives']}, "
                f"launches {res['launches']} (the one-rank run's: "
                f"{res['launches'] == ref_launches[dtype]})")
    else:
        log("[sharded] gloo refuses CUDA tensors for a collective of the sharded paths, so the "
            "two-rank run is not made")
    log(f"[sharded] phase 12: {time.perf_counter() - t_phase:.1f} s")
    if not ok:
        print("chip_smoke: a sharded surface failed its check", file=sys.stderr)
    return ok


# Phase 13: optimizer="lbfgs" (optax.lbfgs(): one zoom line search for each
# fit's summed objective) at the flagship's width.
LBFGS_NITS = 150  # the JAX package's measured configuration (benchmarks/lbfgs_bench.py:45)
LBFGS_CHECK_NITS = 30  # (a): scenario 0 in float64, card against CPU; (d)'s depth
LBFGS_WARMUP_NITS = 10  # (b)'s warm-up
# (a)'s gate on the summed objective at every step, relative.  It sits near
# what round-off allows: a float64 L-BFGS trajectory doubles a change of one
# rounding about every step, so that on scenario 0 a 1e-15 relative change
# of the historical block moves the objective by up to 1.8e-9 within 30
# steps on the CPU, and the JAX package parts from itself as fast
# (tests/test_torch_lbfgs.py::test_fit_free_running_parts_like_jax_from_itself;
# ROADMAP C16).  The card's float64 run, deterministic, parts from the CPU's
# by 5.1e-10 (PERF.md section 6, PR 12).
LBFGS_LOSS_REL = 1e-9
LBFGS_F64_DEGC = 1e-5  # (a): the barycentre, float64 card against float64 CPU


def lbfgs_expected_launches(evals, nits, n_fits=2, dba_iterations=10):
    """The kernel launches of ``n_fits`` lbfgs fits on the kernel route and
    their posteriors: B2 for every value-and-gradient evaluation, for the
    loss recorded after each step and for the posterior; B3 for every
    evaluation's backward and the posterior's variance.  ``evals``: the
    line search's evaluations plus the fresh ones (``ops.lbfgs.counts()``)."""
    launches = {"dba_update": n_fits * dba_iterations, "dba_update_split": 0,
                "chol_solve": evals + n_fits * (nits + 1), "tri_inv": evals + n_fits, "chol": 0,
                "dtw_cost": 0, "solve_vec": 0}
    routes = {"kernel": 2 * evals + n_fits * (nits + 2), "blocked": 0, "library": 0}
    return launches, routes


def run_lbfgs(torch, bt, inputs, dev, report, scratch_out, nits=LBFGS_NITS,
              check_nits=LBFGS_CHECK_NITS):
    """Phase 13: (a) scenario 0 through ``ensemble_scenario_step(optimizer=
    "lbfgs")`` in float64 on the card and on the CPU, equal line-search
    counts at every step; (b) the full flagship through
    ``ensemble_multi_scenario_step(optimizer="lbfgs")`` in float32, every
    launch counter against the evaluations the line search reports, every
    step's objective finite, one run timed after a warm-up, its distance to
    phase 8's truth printed beside Adam-2000's and bfgs-30's; (c) (b) in
    float32 against float64 on the card; (d) ``run_scenario(optimizer=
    "lbfgs")`` for scenario 0, float32 against float64 on the card."""
    from bayesian_ensembling_tpu_torch.ops import lbfgs

    t_phase = time.perf_counter()
    cpu = torch.device("cpu")
    hb, hm, sb, sm, obs, mm = inputs
    scenario0 = (hb[0], hm[0], sb[0], sm[0], obs, mm[0])
    kw = dict(dba_iterations=10, optimizer="lbfgs")
    runs = {}
    for where in (dev, cpu):
        lbfgs.reset_counts()
        dt, out = _wall(torch, lambda: bt.ensemble_scenario_step(
            *_tensors(torch, scenario0, where, torch.float64), n_optim_nits=check_nits, **kw))
        runs[where.type] = (lbfgs.trace(), out, dt)
    (card_tr, card_out, card_s), (cpu_tr, cpu_out, cpu_s) = runs[dev.type], runs["cpu"]
    same_counts = [c for c, _ in card_tr] == [c for c, _ in cpu_tr]
    loss_rel = max(abs(a - b) / max(abs(b), 1e-300) for (_, a), (_, b) in zip(card_tr, cpu_tr))
    gap = _moments_gap(card_out, cpu_out)
    log(f"[lbfgs] (a) scenario 0, {check_nits} steps a fit, float64: card {card_s:.2f} s, CPU "
        f"{cpu_s:.2f} s; line-search steps per step equal at every step: {same_counts} "
        f"({sum(c for c, _ in card_tr)} evaluations on the card, {sum(c for c, _ in cpu_tr)} on the "
        f"CPU); summed objective max rel gap {loss_rel:.3e} (gate {LBFGS_LOSS_REL}); barycentre "
        f"max |dmoment| {gap:.3e} degC (gate {LBFGS_F64_DEGC})")
    ok = same_counts and len(card_tr) == 2 * check_nits and loss_rel < LBFGS_LOSS_REL
    ok &= gap < LBFGS_F64_DEGC

    # (b) The flagship in float32: a short warm-up (the allocator's pools;
    # nothing is compiled), then the counted, timed run.
    run_slice(torch, bt, inputs, dev, torch.float32, LBFGS_WARMUP_NITS, **kw)
    lbfgs.reset_counts()
    bt.reset_launch_counts()
    dt, out = _wall(torch, lambda: run_slice(torch, bt, inputs, dev, torch.float32, nits, **kw))
    launches, routes, counts, tr = (bt.launch_counts(), bt.route_counts(), lbfgs.counts(),
                                    lbfgs.trace())
    evals = counts["linesearch_evals"] + counts["fresh_evals"]
    want_launches, want_routes = lbfgs_expected_launches(evals, nits)
    finite = (len(tr) == 2 * nits and all(np.isfinite(v) for _, v in tr)
              and all(bool(torch.isfinite(a).all()) for a in out))
    steps = 2 * nits
    log(f"[lbfgs] (b) flagship float32, {nits} steps a fit: {dt:.3f} s ({dt / steps * 1e3:.3f} ms a "
        f"step and collection); {evals / steps:.3f} evaluations and "
        f"{counts['host_syncs'] / steps:.3f} host synchronisations a step ({counts}); launches "
        f"{launches} (expected {want_launches}); routes {routes} (expected {want_routes}); every "
        f"step's objective finite: {finite}")
    report["lbfgs_launches"] = launches
    ok &= _counts_match(launches, want_launches) and _counts_match(routes, want_routes) and finite
    if "truth_out" in report:
        truth = report["truth_out"]
        log(f"[lbfgs] (b) distance to phase 8's {TRUTH_NITS}-step Adam truth: lbfgs-{nits} "
            f"{_moments_gap(out, truth):.4e} degC, Adam-{TIMING_NITS} "
            f"{_moments_gap(scratch_out, truth):.4e} degC, bfgs-{BFGS_NITS} "
            f"{_moments_gap(report['bfgs_out'], truth):.4e} degC (printed only: one step size "
            f"serves all {S * M} models of a fit)")

    # (c) The same in float64 on the card.
    dt64, out64 = _wall(torch, lambda: run_slice(torch, bt, inputs, dev, torch.float64, nits, **kw))
    gap = _moments_gap(out, out64)
    log(f"[lbfgs] (c) float64 on the card {dt64:.3f} s; float32 vs float64 max |dmoment| "
        f"{gap:.3e} degC (gate {PARITY_DEGC})")
    ok &= gap < PARITY_DEGC

    # (d) The library entry point for scenario 0, at (a)'s depth.
    built, observations = library_scenarios(bt, inputs)
    hist, ssp = built[0]
    res = {}
    for dtype in (torch.float32, torch.float64):
        bt.reset_launch_counts()
        dt, res[dtype] = _wall(torch, lambda: bt.run_scenario(
            hist, ssp, observations, "scenario0", emulator=bt.GPDTW1D(dtype=dtype),
            n_optim_nits=check_nits, optimizer="lbfgs", device=dev))
        lc = bt.launch_counts()
        log(f"[lbfgs] (d) run_scenario {str(dtype)[6:]}: {dt:.3f} s; launches {lc}")
        ok &= _launched(lc, ("dba_update", "chol_solve", "tri_inv"))
    (m32, s32), (m64, s64) = _bary(torch, [res[torch.float32]]), _bary(torch, [res[torch.float64]])
    gap = max(_abs(m32[0], m64[0]), _abs(s32[0], s64[0]))
    log(f"[lbfgs] (d) float32 vs float64 max |dmoment| {gap:.3e} degC (gate {PARITY_DEGC})")
    ok &= gap < PARITY_DEGC
    log(f"[lbfgs] phase 13: {time.perf_counter() - t_phase:.1f} s")
    if not ok:
        print("chip_smoke: the lbfgs phase failed its check", file=sys.stderr)
    return ok


def _counts_match(got, want):
    return got == want


def _launched(counts, names):
    """Whether every kernel in ``names`` launched in the run just counted."""
    return all(counts[n] > 0 for n in names)


# Phase 14: the port's examples on the card, each against its own float64
# run on the CPU; the numbers compared, and the kernels each must launch.
EXAMPLES = {"quickstart": ("mean", "sd"), "monthly_warm": ("mean", "sd"),
            "gridded_quickstart": ("mean_final",), "gridded_refined": ("refined_mean",)}
EXAMPLE_KERNELS = ("dba_update", "chol_solve", "tri_inv")


def run_examples(torch, bt, dev, report):
    """Phase 14: ``bayesian_ensembling_tpu_torch.examples.*.main`` on the
    card (float32, its default) against ``--device cpu --dtype float64``
    (0.01 degC on the numbers it prints), with each run's launches."""
    import importlib

    t_phase = time.perf_counter()
    ok = True
    total = {k: 0 for k in bt.launch_counts()}
    for name, keys in EXAMPLES.items():
        module = importlib.import_module(f"bayesian_ensembling_tpu_torch.examples.{name}")
        bt.reset_launch_counts()
        dt, got = _wall(torch, lambda: module.main(["--device", str(dev)]))
        launches = bt.launch_counts()
        t0 = time.perf_counter()
        want = module.main(["--device", "cpu", "--dtype", "float64"])
        cpu_s = time.perf_counter() - t0
        gap = max(float(np.max(np.abs(np.asarray(got[k], dtype=np.float64)
                                      - np.asarray(want[k], dtype=np.float64)))) for k in keys)
        launched = _launched(launches, EXAMPLE_KERNELS)
        log(f"[examples] {name}: card float32 {dt:.3f} s, CPU float64 {cpu_s:.3f} s; max |d| over "
            f"{', '.join(keys)} {gap:.3e} degC (gate {PARITY_DEGC}); launches {launches}")
        ok &= gap < PARITY_DEGC and launched
        for k, v in launches.items():
            total[k] += v
    report["examples_launches"] = total
    log(f"[examples] phase 14: {time.perf_counter() - t_phase:.1f} s")
    if not ok:
        print("chip_smoke: a port example failed its check", file=sys.stderr)
    return ok


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0, help="seed of the synthetic inputs")
    args = ap.parse_args(argv)

    import torch

    t_start = time.perf_counter()
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

    log(f"[time] {time.perf_counter() - t_start:.1f} s at the start of phase 3")
    # Phase 3: kernels against their plain versions.
    report = {"dba_update": [], "dba_update_split": [], "chol_solve": [], "tri_inv": [], "chol": [],
              "dtw_cost": [], "dtw_cost_f64": [], "solve_vec": [], "solve_vec_f64": [],
              "chol_solve_f64": [], "tri_inv_f64": []}
    log("[kernels]")
    monthly_pack = bt.pack_dedup_campaign(synthetic_monthly(args.seed)[0])
    if not (check_cost_kernel(torch, inputs, monthly_pack, dev, report)
            and check_kernels(torch, inputs, dev, report)
            and check_monthly_kernels(torch, monthly_pack, dev, report)
            and check_solve_vec(torch, inputs, monthly_pack, dev, report)):
        print("chip_smoke: a kernel disagrees with its plain version", file=sys.stderr)
        return 1
    del monthly_pack

    log(f"[time] {time.perf_counter() - t_start:.1f} s at the start of phase 4")
    # Phase 4: the slice through the kernels, then the f64 plain reference.
    bt.reset_launch_counts()
    dt, (bm, bs, w) = _wall(torch, lambda: run_slice(torch, bt, inputs, dev, torch.float32,
                                                     PARITY_NITS))
    launches, routes = bt.launch_counts(), bt.route_counts()
    expected = {"dba_update": 2 * 10, "dba_update_split": 0, "chol_solve": 2 * (PARITY_NITS + 1),
                "tri_inv": 2 * (PARITY_NITS + 1), "chol": 0, "dtw_cost": 0, "solve_vec": 0}
    expected_routes = {"kernel": 4 * (PARITY_NITS + 1), "blocked": 0, "library": 0}
    log(f"[slice] f32 on the card, {PARITY_NITS} Adam steps: {dt:.2f} s; "
        f"launches {launches} (expected {expected}); routes {routes} (expected {expected_routes})")
    wsum = w.double().sum(dim=1)
    finite = all(bool(torch.isfinite(a).all()) for a in (bm, bs, w))
    if (launches != expected or routes != expected_routes or not finite
            or (wsum - 1.0).abs().max().item() > 1e-5):
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
    step_out = (bm, bs, w)
    tail_ok, ems = check_tail_and_refinement(torch, bt, inputs, dev, step_out, PARITY_NITS)
    if not tail_ok:
        print("chip_smoke: a weight kind's tail or the float64 refinement disagrees", file=sys.stderr)
        return 1

    log(f"[time] {time.perf_counter() - t_start:.1f} s at the start of phase 5")
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
    scratch_out = out
    split = stage_split(torch, bt, inputs, dev, TIMING_NITS)
    per_step = split["fit"] / (2 * TIMING_NITS) * 1e3
    # One chol_solve and one tri_inv per Adam step, averaged over the two
    # collections (the annual shapes only, not the monthly leaves).
    kern = sum(r["ms"] for name in ("chol_solve", "tri_inv") for r in report[name]
               if r["t"] in (T_HIST, T_SSP)) / 2
    log(f"[timing] {TIMING_NITS} Adam steps, 10 DBA iterations, S*M={S * M}: median "
        f"{statistics.median(walls):.3f} s over {len(walls)} runs; stages " + ", ".join(
            f"{k} {v:.3f} s" for k, v in split.items()))
    log(f"[timing] fit: {per_step:.3f} ms per Adam step and collection, of which the two linalg "
        f"kernels take {kern:.3f} ms (the rest is launch overhead and small ops)")

    log(f"[time] {time.perf_counter() - t_start:.1f} s at the start of phase 6")
    # Phase 6: the native-monthly dedup campaign.
    if not run_monthly(torch, bt, dev, args.seed, report):
        return 1

    log(f"[time] {time.perf_counter() - t_start:.1f} s at the start of phase 7")
    # Phase 7: the reference-faithful (subgradient) DBA, and the medoid init.
    if not run_subgradient(torch, bt, inputs, dev, report):
        return 1

    log(f"[time] {time.perf_counter() - t_start:.1f} s at the start of phase 8")
    # Phase 8: the bench's fast fit routes.
    if not run_fast_routes(torch, bt, inputs, dev, step_out, ems, scratch_out, report):
        print("chip_smoke: a fast fit route failed its check", file=sys.stderr)
        return 1

    log(f"[time] {time.perf_counter() - t_start:.1f} s at the start of phase 9")
    # Phase 9: the library API.
    library_ok, fitted, results = run_library(torch, bt, inputs, dev, step_out, report)
    if not library_ok:
        return 1

    log(f"[time] {time.perf_counter() - t_start:.1f} s at the start of phase 10")
    # Phase 10: the gridded surface at the 5-degree grid.
    if not run_gridded(torch, bt, dev, report):
        return 1

    log(f"[time] {time.perf_counter() - t_start:.1f} s at the start of phase 11")
    # Phase 11: the perfect-model test and serving, on phase 9's posteriors.
    if not run_validation(torch, bt, dev, inputs, fitted, results, report):
        return 1

    log(f"[time] {time.perf_counter() - t_start:.1f} s at the start of phase 12")
    # Phase 12: the sharded surfaces, held to phases 4, 6 and 10.
    if not run_sharded(torch, bt, dev, inputs, dict(out=step_out, launches=launches,
                                                   routes=routes), report):
        return 1

    log(f"[time] {time.perf_counter() - t_start:.1f} s at the start of phase 13")
    # Phase 13: optimizer="lbfgs" at the flagship's width.
    if not run_lbfgs(torch, bt, inputs, dev, report, scratch_out):
        return 1

    log(f"[time] {time.perf_counter() - t_start:.1f} s at the start of phase 14")
    # Phase 14: the port's examples on the card.
    if not run_examples(torch, bt, dev, report):
        return 1

    # Each kernel's row: its time and bound at the first shape it was checked
    # at (the annual T = 165 for B1-B3, the leaves for B4, T = 1980 for B6,
    # the subgradient epoch cost at T = 165 for B7, one scenario's historical
    # factors for B5), and its launches in the run of the path it serves
    # (annual, monthly, subgradient or library).
    src = {
        "dba_update": ("bayesian_ensembling_tpu_torch/csrc/dba_update.cu",
                       "bayesian_ensembling_tpu/ops/dtw_pallas.py:337", launches),
        "chol_solve": ("bayesian_ensembling_tpu_torch/csrc/chol_solve.cu",
                       "bayesian_ensembling_tpu/ops/linalg_pallas.py:247", launches),
        "tri_inv": ("bayesian_ensembling_tpu_torch/csrc/tri_inv.cu",
                    "bayesian_ensembling_tpu/ops/linalg_pallas.py:414", launches),
        "chol": ("bayesian_ensembling_tpu_torch/csrc/chol.cu",
                 "bayesian_ensembling_tpu/ops/linalg_pallas.py:153", report["monthly_launches"]),
        "dba_update_split": ("bayesian_ensembling_tpu_torch/csrc/dba_update_split.cu",
                             "bayesian_ensembling_tpu/ops/dtw_pallas.py:405",
                             report["monthly_launches"]),
        "dtw_cost": ("bayesian_ensembling_tpu_torch/csrc/dtw_cost.cu",
                     "bayesian_ensembling_tpu/ops/dtw_pallas.py:34",
                     report["subgradient_launches"]),
        "solve_vec": ("bayesian_ensembling_tpu_torch/csrc/solve_vec.cu",
                      "bayesian_ensembling_tpu/ops/linalg_pallas.py:325",
                      report["library_launches"]),
    }
    kernels = []
    for name, (source, replaces, path_launches) in src.items():
        main_shape = report[name][0]
        bound_ms, bound_by = _bound(*main_shape["work"])
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": path_launches[name],
            "launches_by_path": {"annual": launches[name],
                                 "monthly": report["monthly_launches"][name],
                                 "subgradient": report["subgradient_launches"][name],
                                 "medoid": report["medoid_launches"][name],
                                 "library": report["library_launches"][name],
                                 "gridded": report["gridded_launches"][name],
                                 "validation": report["validation_launches"][name],
                                 "serve": report["serve_launches"][name],
                                 "sharded": report["sharded_launches"].get(name, 0),
                                 "lbfgs": report["lbfgs_launches"][name],
                                 "examples": report["examples_launches"][name]},
            "max_abs_err": max(r["err"] for r in report[name]),
            "ms": main_shape["ms"], "plain_ms": main_shape["plain_ms"],
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": main_shape["library_ms"],
            "shapes": [{"n": r.get("n"), "t": r["t"], "ms": r["ms"], "plain_ms": r["plain_ms"],
                        "bound_ms": _bound(*r["work"])[0]}
                       for r in report[name]],
        })
    log(f"[total] {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
