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
   update (N = 3,248 pairs, T = 165 and 86, exact), the fused
   Cholesky-solve and the triangular inverse (B = 112, T = 165 and 86), and
   one non-positive-definite input that must come back NaN; then the
   monthly path's kernels: the split DBA update (exact, at the monthly
   collections' N and T = 1980 / 1032, and against the fused kernel at
   T = 165), the Cholesky and the triangular inverse at the blocked NLML's
   leaves (B = 65, T = 128; the Cholesky with a non-positive-definite
   slot), the blocked NLML in float32 against
   torch.linalg in float64 (B = 65, T = 1032), and the route timings that
   the linalg_path thresholds are decided from.
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
   median wall time of the step, and a per-stage split.
6. The native-monthly dedup campaign, ``run_dedup_campaign``, on synthetic
   inputs of its full width (20 unique historical models at T = 1980, 7
   scenarios with 65 SSP fits at T = 1032 padded to M = 16, 3 to 29
   realisations, 200 observation members) at the production monthly
   settings (500 Adam steps, 10 DBA iterations, historical chunks of 28):
   float32 on the card with every launch and route counter checked, then
   float64 on the card (the library route for every fit) as the reference,
   within 0.01 degC; then the median wall time of 3 float32 runs and a
   per-stage split.
7. The reference-faithful DBA: the step with the subgradient DBA (50
   epochs, tol 1e-3) at the flagship shape, float32 against float64 on the
   card (0.01 degC), with the DTW cost and DBA-update launches checked
   against the epochs ``dba_subgradient_batch`` reports; the medoid
   ``dba_batch`` float32 against float64 (one cost launch, 10 updates);
   then the median wall time of the subgradient step at 2,000 Adam steps
   and its DBA stage.
8. The bench's fast fit routes at the flagship shape: coarse-to-fine in
   time (stride 12, 1,000 coarse and 250 fine steps) against float64 on the
   card (0.01 degC); the per-model BFGS at 30 steps, whose distance to a
   10,000-step Adam truth may be at most 1.05 times the 2,000-step Adam
   run's (where it is not, the rule must hold once the models that the
   BFGS strands on the plateau of ROADMAP C7 take the truth's fits, and
   the script names them); the chunked fit (chunks of 250) against phase 4's merged fit, bit
   for bit; median wall times of 3 runs.

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

# The native-monthly campaign (benchmarks/monthly_bench.py all): 20 unique
# historical models, 7 scenarios with 65 real SSP fits padded to M = 16.
N_HIST_MODELS, SSP_MODELS = 20, (16, 12, 9, 8, 7, 7, 6)
T_HIST_M, T_SSP_M, HIST_CHUNK = 1980, 1032, 28
MONTHLY_NITS, MONTHLY_REPS = 500, 3
# float32 blocked NLML vs float64 torch.linalg at (65, 1032), relative to the
# largest entry: float32 round-off of the Cholesky of a Gram whose condition
# number is about 1e5 (T / noise).
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

# Peak rates of one H100 SXM (NVIDIA's data sheet) for the kernels' bounds.
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12


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
        report["dba_update"].append(dict(t=t, err=err, ms=ms, plain_ms=plain_ms,
                                         work=_dba_work(n, t), library_ms=None))

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
        report["chol_solve"].append(dict(t=t, err=err, ms=ms, plain_ms=plain_ms,
                                         work=_chol_solve_work(b, t), library_ms=None))

        l = want[0].contiguous()  # torch.linalg returns a column-major factor
        got_w = lc.tri_inv(l)
        want_w = lc.tri_inv_reference(l)
        exact_w = lc.tri_inv_reference(l.double())
        torch.cuda.synchronize()
        rel = _rel(got_w, want_w)
        err = _abs(got_w, want_w)
        ms = _cuda_ms(torch, lambda: lc.tri_inv(l), 50)
        plain_ms = _cuda_ms(torch, lambda: lc.tri_inv_reference(l), 10)
        eye = torch.eye(t, device=dev).expand_as(l)
        lib_ms = _cuda_ms(torch, lambda: torch.linalg.solve_triangular(l, eye, upper=False), 10)
        log(f"  tri_inv B={b} T={t}: rel err {rel:.2e} (tol {LINALG_TOL}); vs f64: kernel "
            f"{_rel(got_w, exact_w):.2e}, plain {_rel(want_w, exact_w):.2e}; "
            f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, solve_triangular {lib_ms:.4f} ms")
        ok &= rel < LINALG_TOL
        report["tri_inv"].append(dict(t=t, err=err, ms=ms, plain_ms=plain_ms,
                                      work=_triangle_work(b, t), library_ms=lib_ms))

        bad = ky.clone()
        bad[5] = -torch.eye(t, device=dev)
        _, _, alpha, logdet = lc.chol_solve(bad, y)
        torch.cuda.synchronize()
        nan_ok = bool(torch.isnan(logdet[5]) and torch.isnan(alpha[5]).all()
                      and torch.isfinite(logdet[:5]).all() and torch.isfinite(alpha[6:]).all())
        log(f"  chol_solve non-PD input at T={t} gives NaN only there: {nan_ok}")
        ok &= nan_ok
    return ok


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
        log(f"  dba_update_split N={n} T={t} ({name}): exact={exact} max_abs_err={err:.3e} "
            f"kernel {ms:.3f} ms, plain {plain_ms:.1f} ms")
        ok &= exact
        report["dba_update_split"].append(dict(t=t, n=n, err=err, ms=ms, plain_ms=plain_ms,
                                               work=_dba_work(n, t), library_ms=None))

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
    # the SSP fit's shape, then the route timings of one NLML value and
    # gradient: blocked vs library at (65, 1032), library (and, beyond
    # BLOCKED_T_CAP, blocked) at the historical chunk (28, 1980).
    timings = {}
    for name, block, nbatch in (("ssp", pack.usb, None), ("hist", uh, HIST_CHUNK)):
        feats = torch.tensor(block[:nbatch], dtype=torch.float32, device=dev).transpose(1, 2)
        b, t = feats.shape[0], feats.shape[1]
        noise = torch.tensor(rng.uniform(0.005, 0.05, (b, t)), dtype=torch.float32, device=dev)
        ky = _matern_spd(torch, feats.contiguous(), noise, dev)
        y = torch.tensor(rng.normal(size=(b, t)), dtype=torch.float32, device=dev)
        library = lc.nlml_terms  # T is beyond the kernels' cap: torch.linalg
        if name == "ssp":
            got = _nlml_step(torch, lb.nlml_terms_blocked, ky, y)
            want = _nlml_step(torch, library, ky.double(), y.double())
            torch.cuda.synchronize()
            rels = [_rel(g, w_) for g, w_ in zip(got, want)]
            log(f"  nlml_terms_blocked B={b} T={t} f32 vs library f64: rel err (quad, logdet, "
                f"dK) = " + ", ".join(f"{e:.2e}" for e in rels) + f" (tol {BLOCKED_TOL})")
            ok &= max(rels) < BLOCKED_TOL
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
    """Wall time of each stage of one float32 campaign, run stage by stage
    (the composition of ``run_dedup_campaign`` and ``emulate_marginals``)."""
    from bayesian_ensembling_tpu_torch.ops import gp as gp_ops
    from bayesian_ensembling_tpu_torch.parallel.step import chunked_marginals, multi_scenario_tail

    times = {}

    def staged(key):
        def em(block, mask):
            dt, (x, y, v) = _wall(torch, lambda: gp_ops.prepare_gp_inputs(block, mask, dba_iterations=10))
            times[f"{key}_dba"] = times.get(f"{key}_dba", 0.0) + dt
            dt, (params, _) = _wall(torch, lambda: gp_ops.fit_gp_batch(x, y, v, n_optim_nits=MONTHLY_NITS))
            times[f"{key}_fit"] = times.get(f"{key}_fit", 0.0) + dt
            dt, (mu, var) = _wall(torch, lambda: gp_ops.posterior_marginals_batch(params, x, y, v))
            times[f"{key}_posterior"] = times.get(f"{key}_posterior", 0.0) + dt
            return mu, var + v
        return em

    def tensor(a):
        return torch.tensor(a, dtype=torch.bool if a.dtype == bool else torch.float32, device=dev)

    h_mu, h_var = chunked_marginals(staged("hist"), tensor(pack.uh), tensor(pack.um), HIST_CHUNK)
    s_mu, s_var = staged("ssp")(tensor(pack.usb), tensor(pack.usm))
    uidx = torch.tensor(pack.uidx, device=dev)
    sidx = torch.tensor(pack.sidx, device=dev)
    dt, _ = _wall(torch, lambda: multi_scenario_tail(
        h_mu[uidx], h_var[uidx], s_mu[sidx], s_var[sidx], tensor(obs), tensor(pack.hb),
        tensor(pack.hm), tensor(pack.mmask)))
    times["tail"] = dt
    return times


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
    n_leaves = -(-T_SSP_M // lb.DEFAULT_BLOCK)  # the blocked NLML's leaves: 9 at T = 1032
    n_chunks = -(-pack.uh.shape[0] // HIST_CHUNK)
    expected = {"dba_update": 0, "dba_update_split": 2 * 10, "chol_solve": 0,
                "tri_inv": n_leaves * MONTHLY_NITS, "chol": n_leaves * MONTHLY_NITS, "dtw_cost": 0}
    # One blocked NLML per SSP fit step; on the library route, a factorisation
    # and a triangular inverse per historical fit step and per posterior.
    expected_routes = {"kernel": 0, "blocked": MONTHLY_NITS,
                       "library": n_chunks * (2 * MONTHLY_NITS + 2) + 2}
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
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB)")
    if not all(bool(torch.isfinite(a).all()) for a in out):
        print("chip_smoke: a timed monthly run gave non-finite output", file=sys.stderr)
        return None
    split = campaign_stage_split(torch, pack, obs, dev)
    log(f"[monthly] {MONTHLY_NITS} Adam steps, {pack.n_fits} fits: median "
        f"{statistics.median(walls):.3f} s over {len(walls)} runs (warm-up {warm:.3f} s); stages "
        + ", ".join(f"{k} {v:.3f} s" for k, v in split.items()))
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
            log(f"  dtw_cost {label} N={n} T={t} {str(dtype)[6:]}: exact={exact} max_abs_err={err:.3e} "
                f"kernel {ms:.4f} ms, plain {plain_ms:.3f} ms, bound {bound_ms:.4f} ms ({bound_by})")
            ok &= exact
            if dtype == torch.float32:
                report["dtw_cost"].append(dict(t=t, n=n, err=err, ms=ms, plain_ms=plain_ms,
                                               work=work, library_ms=None))
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
                "tri_inv": 2 * (PARITY_NITS + 1), "chol": 0, "dtw_cost": n_epochs}
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


def run_fast_routes(torch, bt, inputs, dev, step_out, ems, scratch_out):
    """Phase 8: the coarse-to-fine-in-time route, the 30-step BFGS and the
    chunked fit, at the flagship shape."""
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

    # Phase 3: kernels against their plain versions.
    report = {"dba_update": [], "dba_update_split": [], "chol_solve": [], "tri_inv": [], "chol": [],
              "dtw_cost": [], "dtw_cost_f64": []}
    log("[kernels]")
    monthly_pack = bt.pack_dedup_campaign(synthetic_monthly(args.seed)[0])
    if not (check_cost_kernel(torch, inputs, monthly_pack, dev, report)
            and check_kernels(torch, inputs, dev, report)
            and check_monthly_kernels(torch, monthly_pack, dev, report)):
        print("chip_smoke: a kernel disagrees with its plain version", file=sys.stderr)
        return 1
    del monthly_pack

    # Phase 4: the slice through the kernels, then the f64 plain reference.
    bt.reset_launch_counts()
    dt, (bm, bs, w) = _wall(torch, lambda: run_slice(torch, bt, inputs, dev, torch.float32,
                                                     PARITY_NITS))
    launches, routes = bt.launch_counts(), bt.route_counts()
    expected = {"dba_update": 2 * 10, "dba_update_split": 0, "chol_solve": 2 * (PARITY_NITS + 1),
                "tri_inv": 2 * (PARITY_NITS + 1), "chol": 0, "dtw_cost": 0}
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

    # Phase 6: the native-monthly dedup campaign.
    if not run_monthly(torch, bt, dev, args.seed, report):
        return 1

    # Phase 7: the reference-faithful (subgradient) DBA, and the medoid init.
    if not run_subgradient(torch, bt, inputs, dev, report):
        return 1

    # Phase 8: the bench's fast fit routes.
    if not run_fast_routes(torch, bt, inputs, dev, step_out, ems, scratch_out):
        print("chip_smoke: a fast fit route failed its check", file=sys.stderr)
        return 1

    # Each kernel's row: its time and bound at the first shape it was checked
    # at (the annual T = 165 for B1-B3, the leaves for B4, T = 1980 for B6,
    # the subgradient epoch cost at T = 165 for B7), and its launches in the
    # run of the path it serves (annual, monthly or subgradient).
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
                                 "medoid": report["medoid_launches"][name]},
            "max_abs_err": max(r["err"] for r in report[name]),
            "ms": main_shape["ms"], "plain_ms": main_shape["plain_ms"],
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": main_shape["library_ms"],
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
