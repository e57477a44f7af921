#!/usr/bin/env python3
"""Parity gate of the PyTorch port (bayesian_ensembling_tpu_torch) on one NVIDIA GPU.

Run from the repository root:

    python3 chip_smoke.py [--seed 0]

Each phase runs whole paths of the port in float32 on the card, through its
CUDA kernels, against float64 (on the card, or through the plain versions on
the CPU) or against the JAX package's float64 oracles, with the launch,
route and collective counts the path implies; any failure exits non-zero.
Phase 3 first runs ``tests/test_torch_kernels.py -m gpu``, where each kernel
is held against its plain version, so the kernel checks have one home.
The script times nothing but its own phases (``[time]``, ``[total]``): the
benchmark ``portbench/`` times the cells and ``bayesian_ensembling_tpu_torch/
utils/*_times.py`` time the kernels.  The inputs are the benchmark's:
``portbench``'s generators with ``portbench/configs/annual-flagship.json``
and ``monthly-campaign.json``, and
``benchmarks/gridded_common.make_workload_cells``.

Phases, in order:

1. Device: CUDA must be present; prints the card, torch/CUDA versions and
   the TF32 flags (float32 matmuls must run in full float32).
2. Build: compiles the CUDA kernels in ``bayesian_ensembling_tpu_torch/csrc``
   with nvcc for sm_90a (into ``build/torch_kernels/``) and loads them.
3. The kernels against their plain versions: ``tests/test_torch_kernels.py
   -m gpu`` in a child process (the DBA updates and the DTW cost bit for
   bit, the linear algebra in float32 and float64 at the paths' shapes);
   its summary line is printed, and a failed case fails the script.
4. The slice: ``ensemble_multi_scenario_step`` on the annual flagship's
   inputs (7 SSPs x 16 padded models x 2 to 29 realisations, T = 165 / 86,
   200 observation members), float32 on the card through the kernels, with
   every launch counter checked; then the same inputs in float64 through
   the plain versions on the CPU, and the barycentre mean and std must
   agree within 0.01 degC pointwise.  At the float32 run's marginals
   (recomputed through ``emulate_marginals``, which must give the step's
   output bit for bit), the tail of every weight kind on the card against
   float64 on the CPU (weights within 1e-4, moments within 0.01 degC), and
   ``refined_multi_scenario_f64`` on the card against the CPU at the fitted
   hyperparameters and targets (1e-5 degC).
5. (The faithful workload's time: ``portbench``'s annual-flagship.faithful.)
6. The native-monthly dedup campaign, ``run_dedup_campaign``, on the
   monthly campaign's inputs (20 unique historical models at T = 1980, 7
   scenarios with 65 SSP fits at T = 1032 padded to M = 16, 3 to 29
   realisations, 200 observation members) at the production monthly
   settings (500 Adam steps, 10 DBA iterations, historical chunks of 28):
   float32 on the card with every launch and route counter checked, then
   float64 on the card (the library route for every fit) as the reference,
   within 0.01 degC.
7. The reference-faithful DBA: the step with the subgradient DBA (50
   epochs, tol 1e-3) at the flagship shape, float32 against float64 on the
   card (0.01 degC), with the DTW cost and DBA-update launches checked
   against the epochs ``dba_subgradient_batch`` reports; the medoid
   ``dba_batch`` float32 against float64 (one cost launch, 10 updates).
8. The bench's fast fit routes at the flagship shape: coarse-to-fine in
   time (stride 12, 1,000 coarse and 250 fine steps) against float64 on the
   card (0.01 degC); the per-model BFGS at 30 steps, whose distance to a
   10,000-step Adam truth may be at most 1.05 times the 2,000-step Adam
   run's (where it is not, the rule must hold once the models that the
   BFGS strands on the plateau of ROADMAP C7 take the truth's fits, and
   the script names them); the chunked fit (chunks of 250) against phase
   4's merged fit, bit for bit.
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
   against phase 4's fused step for scenario 0 (0.01 degC).
10. The gridded surface at the 5-degree north-star grid of
   ``benchmarks/gridded_bench.py`` (5 models x 36 x 72 cells x 10
   realisations x 86 annual steps, 10 observation members: 12,960 GP fits):
   ``gridded_ensemble_step`` at the gridded fast profile (scratch
   bfgs-30), float32 on the card, every launch and route counter checked;
   the first 64 cells' barycentre within 1e-3 of the JAX package's float64
   moments in ``benchmarks/gridded_oracle.json`` (bfgs-30);
   ``refined_gridded_f64`` of the whole grid on the card against float64
   plain on the CPU (64 cells, 1e-5); Adam-500 on the first 64 cells and
   the coarse-to-fine warm start (stride 5, bfgs-30 coarse, bfgs-20 fine)
   against their oracle entries (1e-3); ``run_gridded_scenario`` over five
   ``ProcessModel`` objects of (10, 86, 36, 72) (CRPS, float32, 500 Adam
   steps), float32 against float64 on an 8 x 8 sub-grid (0.01 degC), with
   ``LogLikelihoodWeight`` (no Cholesky or vector-solve launch: the
   posteriors are diagonal); and ``GPDTW3D(mode="svgp")`` on the 8 x 8
   sub-grid, float64, card against CPU (1e-3 degC).
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
   crps; nll printed), every launch counter checked; then
   ``serve.ProjectionService.from_results`` on phase 9's results, a save /
   load round trip and an HTTP server on a localhost port answering a
   projection, a trajectory and a bad query (400), each held against the
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
   card, against one rank within 1e-5 degC.
13. ``optimizer="lbfgs"`` (optax's L-BFGS: one zoom line search for each
   fit's summed objective): scenario 0 through ``ensemble_scenario_step``
   (30 steps a fit) in float64 on the card and on the CPU, with equal
   line-search counts at every step, the summed objective within 1e-9
   relative at every step and the barycentre within 1e-5 degC; the full
   flagship through ``ensemble_multi_scenario_step`` at 150 steps in
   float32, every launch and route counter against the evaluations the
   line search reports, every step's objective finite, and its distance to
   phase 8's truth printed beside Adam-2000's and bfgs-30's; the same in
   float64 on the card (0.01 degC); and ``run_scenario(optimizer="lbfgs")``
   for scenario 0 (30 steps), float32 against float64 on the card (0.01
   degC).
14. The port's four examples (``bayesian_ensembling_tpu_torch/examples``:
   quickstart, monthly_warm, gridded_quickstart, gridded_refined) on the
   card in float32, each against its own float64 run on the CPU (0.01 degC
   on the numbers it prints), each launching the DBA update, the fused
   Cholesky-solve and the triangular inverse.

Before the last lines, ``[launches]`` gives each kernel's launches in each
path's run, each read after its own reset.  The last lines are the card's
name and power limit and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import time
import warnings

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))

PARITY_DEGC = 0.01  # f32-vs-f64 gate on barycentre moments (bench.py's gate)
# Adam steps of the f32-kernels vs f64-plain comparison: the f64 run of the
# plain versions on the CPU takes about 2 minutes at 500 steps.
PARITY_NITS = 500
LINALG_TOL = 1e-3  # float32 against float64, relative to the largest entry

# The native-monthly campaign (benchmarks/monthly_bench.py all) at the
# production monthly settings; run_dedup_campaign's historical chunks.
MONTHLY_NITS, HIST_CHUNK = 500, 28

# The reference-faithful DBA (the flagship's subgradient DBA, 50 epochs) and
# the bench's fast fit routes (bench.py:353-410).
SUBGRADIENT_EPOCHS = 50
SCRATCH_NITS = 2000  # the faithful workload's Adam depth: the bfgs rule's baseline
WARM_NITS, WARM_KW = 1000, dict(time_stride=12, fine_steps=250)
BFGS_NITS, BFGS_KW = 30, dict(optimizer="bfgs")
TRUTH_NITS = 10_000  # the converged truth of the bfgs closeness gate
BFGS_SLACK = 1.05
CHUNK_STEPS = 250
WEIGHT_TOL = 1e-4  # float32 tail vs float64 at the same marginals
REFINED_DEGC = 1e-5  # refined moments, card vs CPU (bench.py:539)
LIBRARY_NITS = 500  # phase 9: run_scenario's fit depth
# Phase 3: the card tests of the kernels, run as their docstring says.
KERNEL_TESTS = ("tests/test_torch_kernels.py", "-m", "gpu", "--noconftest",
                "-p", "no:cacheprovider")
KERNEL_TESTS_TIMEOUT = 900  # seconds; they take about 4 minutes on an H100


def log(*a):
    print(*a, flush=True)


def _config(name):
    with open(os.path.join(ROOT, "portbench", "configs", f"{name}.json")) as fh:
        return json.load(fh)


def synthetic_flagship(seed, **shape):
    """The annual flagship's inputs ``(hb, hm, sb, sm, obs, mm)`` in float64:
    ``portbench``'s ``annual`` generator with ``configs/annual-flagship.json``,
    whose shape keys ``shape`` overrides (the CPU rehearsals cut it)."""
    from portbench.generators import annual

    cfg = _config("annual-flagship")
    x = annual.make(dict(cfg["shape"], **shape), cfg["data"], np.random.default_rng(seed))
    return tuple(x[k] for k in ("hist_blocks", "hist_masks", "ssp_blocks", "ssp_masks", "obs",
                                "model_masks"))


class MonthlyCollection:
    """A numpy stand-in for the JAX package's ``ModelCollection``: model
    names and one (realisations, T) block each, the three things
    ``pack_dedup_campaign`` reads of a collection, and float32 padding."""

    def __init__(self, collection):
        self.model_names = list(collection.model_names)
        self.blocks = [b[m] for b, m in zip(collection.block, collection.mask)]

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


def synthetic_monthly(seed, **shape):
    """The native-monthly campaign's inputs ``(scenarios, obs)`` in float64:
    ``portbench``'s ``monthly`` generator with ``configs/monthly-campaign.json``
    (shape keys overridden by ``shape``), laid out by ``portbench.entries.
    dedup_campaign.scenarios`` as ``[(name, hist, ssp), ...]`` collections."""
    from portbench.entries import dedup_campaign
    from portbench.generators import monthly

    cfg = _config("monthly-campaign")
    x = monthly.make(dict(cfg["shape"], **shape), cfg["data"], np.random.default_rng(seed))
    return [(name, MonthlyCollection(hist), MonthlyCollection(ssp))
            for name, hist, ssp in dedup_campaign.scenarios(x)], x["obs"]


def monthly_campaign(seed, **shape):
    """``synthetic_monthly``'s campaign packed by ``pack_dedup_campaign`` (in
    float32) and its observation members (float64): ``(pack, obs)``."""
    from bayesian_ensembling_tpu_torch import pack_dedup_campaign

    scenarios, obs = synthetic_monthly(seed, **shape)
    return pack_dedup_campaign(scenarios), obs


def _gridded_common():
    """``benchmarks/gridded_common`` (numpy only: the gridded bench's
    workload), with ``benchmarks/`` put on ``sys.path`` when first asked."""
    path = os.path.join(ROOT, "benchmarks")
    if path not in sys.path:
        sys.path.insert(0, path)
    import gridded_common

    return gridded_common


def _tally(report, path, counts):
    """Add a run's launch counts, read after its own reset, to ``path``'s
    row of ``report["launches"]``."""
    row = report.setdefault("launches", {}).setdefault(path, {})
    for k, v in counts.items():
        row[k] = row.get(k, 0) + v


def run_kernel_tests():
    """Phase 3: the card tests of ``tests/test_torch_kernels.py`` in a child
    process; its summary line is printed, and a failure fails the phase."""
    proc = subprocess.run([sys.executable, "-m", "pytest", *KERNEL_TESTS], cwd=ROOT,
                          capture_output=True, text=True, timeout=KERNEL_TESTS_TIMEOUT)
    counts = [line for line in proc.stdout.splitlines()
              if re.search(r"\d+ (passed|failed|skipped|errors?)\b", line)]
    log(f"[kernels] pytest {' '.join(KERNEL_TESTS)}: {counts[-1] if counts else '(no count)'}")
    if proc.returncode != 0:
        print(proc.stdout[-20000:], proc.stderr[-4000:], sep="\n", file=sys.stderr)
        print("chip_smoke: a kernel differs from its plain version", file=sys.stderr)
        return False
    return True


def _nvidia_smi():
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return proc.stdout.strip().splitlines()[0]


def _abs(got, want):
    return (got.double().cpu() - want.double().cpu()).abs().max().item()


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
    return [(hb.reshape(-1, *hb.shape[2:]), hm.reshape(-1, hm.shape[-1])),
            (sb.reshape(-1, *sb.shape[2:]), sm.reshape(-1, sm.shape[-1]))]


def _tail(torch, bt, inputs, marg, dev, dtype, **kw):
    """The multi-scenario tail at given marginals ``[(mean, var), (mean, var)]``
    of the merged collections."""
    hb, hm, _, _, obs, mm = _tensors(torch, inputs, dev, dtype)
    (hmu, hvar), (smu, svar) = [(a.to(dev, dtype).reshape(*mm.shape, -1),
                                 b.to(dev, dtype).reshape(*mm.shape, -1)) for a, b in marg]
    return bt.multi_scenario_tail(hmu, hvar, smu, svar, obs, hb, hm, mm, **kw)


def _moments_gap(got, want):
    return max(_abs(got[0], want[0]), _abs(got[1], want[1]))


def _campaign(bt, pack, obs, dev, dtype):
    return bt.run_dedup_campaign(pack, obs, hist_chunk=HIST_CHUNK, device=dev, dtype=dtype,
                                 n_optim_nits=MONTHLY_NITS, dba_iterations=10)


def run_monthly(torch, bt, dev, seed, report):
    """Phase 6: the dedup campaign, float32 checked against float64."""
    from bayesian_ensembling_tpu_torch.ops import linalg_blocked as lb

    pack, obs = monthly_campaign(seed)
    counts = pack.um.sum(axis=1)
    t_hist, t_ssp = pack.uh.shape[-1], pack.usb.shape[-1]
    log(f"[monthly] {len(pack.names)} scenarios, {pack.uh.shape[0]} unique historical fits "
        f"(T={t_hist}) + {pack.usb.shape[0]} SSP fits (T={t_ssp}), padded M="
        f"{pack.mmask.shape[1]}, R={pack.hb.shape[2]} (realisations {counts.min()}..{counts.max()}), "
        f"R_obs={obs.shape[0]}; {MONTHLY_NITS} Adam steps, 10 DBA iterations, chunks of {HIST_CHUNK}")

    bt.reset_launch_counts()
    bm, bs, w = _campaign(bt, pack, obs, dev, torch.float32)
    launches, routes = bt.launch_counts(), bt.route_counts()
    n_chunks = -(-pack.uh.shape[0] // HIST_CHUNK)
    # The blocked NLML's leaves: 9 at T = 1032 (padded to 1152), 16 at T =
    # 1980 (padded to 2048).
    n_leaves = -(-t_ssp // lb.DEFAULT_BLOCK) + n_chunks * -(-t_hist // lb.DEFAULT_BLOCK)
    expected = {"dba_update": 0, "dba_update_split": 2 * 10, "chol_solve": 0,
                "tri_inv": n_leaves * MONTHLY_NITS, "chol": n_leaves * MONTHLY_NITS, "dtw_cost": 0,
                "solve_vec": 0, **gram_launches((1 + n_chunks) * MONTHLY_NITS)}
    # One blocked NLML per step of the SSP fit and of each historical chunk's
    # (B = 28); on the library route, a factorisation and a triangular
    # inverse per posterior.
    expected_routes = {"kernel": 0, "blocked": (1 + n_chunks) * MONTHLY_NITS,
                       "library": 2 * n_chunks + 2}
    log(f"[monthly] f32 on the card: launches {launches} (expected {expected}); "
        f"routes {routes} (expected {expected_routes})")
    wsum = w.double().sum(dim=1)
    finite = all(bool(torch.isfinite(a).all()) for a in (bm, bs, w))
    if (launches != expected or routes != expected_routes or not finite
            or (wsum - 1.0).abs().max().item() > 1e-5):
        print(f"chip_smoke: monthly check failed (finite={finite}, weight sums {wsum.tolist()})",
              file=sys.stderr)
        return None
    _tally(report, "monthly", launches)
    # Phase 12 holds the sharded campaign to this run bit for bit.
    report["monthly_f32"] = dict(pack=pack, obs=obs, out=(bm, bs, w), launches=launches,
                                 routes=routes)

    bt.reset_launch_counts()
    ref = _campaign(bt, pack, obs, dev, torch.float64)
    dmean, dstd, dw = _abs(bm, ref[0]), _abs(bs, ref[1]), _abs(w, ref[2])
    log(f"[monthly] f64 on the card: launches {bt.launch_counts()}, routes "
        f"{bt.route_counts()}; max |dmean| {dmean:.3e} degC, max |dstd| {dstd:.3e} degC "
        f"(gate {PARITY_DEGC}), max |dweight| {dw:.3e}")
    log("[monthly] last-month barycentre by scenario: " + ", ".join(
        f"{m_:.3f}+-{s_:.3f}" for m_, s_ in zip(bm[:, -1].tolist(), bs[:, -1].tolist())))
    if not (dmean < PARITY_DEGC and dstd < PARITY_DEGC):
        print("chip_smoke: the f32 monthly campaign disagrees with the f64 one", file=sys.stderr)
        return None
    return True


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
        f"scratch-{SCRATCH_NITS} {close_scratch:.4e} degC (rule: bfgs <= {BFGS_SLACK} x scratch): "
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
        got = _tail(torch, bt, inputs, marg, dev, torch.float32, weight_kind=kind)
        want = _tail(torch, bt, inputs, marg, cpu, torch.float64, weight_kind=kind)
        dw, dm = _abs(got[2], want[2]), _moments_gap(got, want)
        finite = all(bool(torch.isfinite(a).all()) for a in got)
        log(f"[tail] {kind}: f32 card vs f64 CPU: max |dweight| {dw:.3e} (gate {WEIGHT_TOL}), "
            f"max |dmoment| {dm:.3e} degC (gate {PARITY_DEGC}), finite={finite}")
        ok &= finite and dw < WEIGHT_TOL and dm < PARITY_DEGC
    hb, hm, sb, sm, obs, mm = inputs
    (_, _, hp, hym, hyv), (_, _, sp, sym, syv) = ems
    targets = ((hym, hyv), (sym, syv))
    refined = {key: bt.refined_multi_scenario_f64(hb, hm, sb, sm, obs, mm, hp, sp, targets=targets,
                                                  device=where)
               for key, where in (("card", dev), ("CPU", cpu))}
    gap = max(float(np.abs(a - b).max()) for a, b in zip(refined["card"][:2], refined["CPU"][:2]))
    f32_gap = _moments_gap(step_out, [torch.from_numpy(a) for a in refined["card"]])
    log(f"[refined] float64 posterior and tail, card vs CPU: max |dmoment| {gap:.3e} degC (gate "
        f"{REFINED_DEGC}); the float32 step differs from the refined moments by {f32_gap:.3e} degC")
    ok &= gap < REFINED_DEGC
    return ok, ems


def run_subgradient(torch, bt, inputs, dev, report):
    """Phase 7: the step with the reference-faithful subgradient DBA."""
    from bayesian_ensembling_tpu_torch.ops import dtw as dtw_ops

    kw = dict(dba_method="subgradient", dba_iterations=SUBGRADIENT_EPOCHS)
    epochs, targets = {}, {}
    for dtype in (torch.float32, torch.float64):
        for name, (block, mask) in zip(("hist", "ssp"), _collections(torch, inputs, dev, dtype)):
            y, info = dtw_ops.dba_subgradient_batch(block, mask, max_iter=SUBGRADIENT_EPOCHS,
                                                    tol=1e-3, return_info=True)
            epochs[name, dtype], targets[name, dtype] = info["epochs"], y
            log(f"[subgradient] {name} {str(dtype)[6:]}: {info['epochs']} epochs, "
                f"{int(info['converged'].sum())} of {block.shape[0]} models converged")
    for name in ("hist", "ssp"):
        log(f"[subgradient] {name} target f32 vs f64: max |dy| "
            f"{_abs(targets[name, torch.float32], targets[name, torch.float64]):.3e} degC")

    bt.reset_launch_counts()
    out = run_slice(torch, bt, inputs, dev, torch.float32, PARITY_NITS, **kw)
    launches = bt.launch_counts()
    n_epochs = epochs["hist", torch.float32] + epochs["ssp", torch.float32]
    r = inputs[0].shape[2]
    expected = {"dba_update": r * n_epochs, "dba_update_split": 0, "chol_solve": 2 * (PARITY_NITS + 1),
                "tri_inv": 2 * (PARITY_NITS + 1), "chol": 0, "dtw_cost": n_epochs, "solve_vec": 0,
                **gram_launches(2 * PARITY_NITS)}
    log(f"[subgradient] step f32 on the card, {PARITY_NITS} Adam steps: launches {launches} "
        f"(expected {expected})")
    _tally(report, "subgradient", launches)
    ref = run_slice(torch, bt, inputs, dev, torch.float64, PARITY_NITS, **kw)
    dmean, dstd, dw = _abs(out[0], ref[0]), _abs(out[1], ref[1]), _abs(out[2], ref[2])
    log(f"[subgradient] step f64 on the card: max |dmean| {dmean:.3e} degC, max |dstd| "
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
        medoid[dtype] = bt.dba_batch(block, mask, n_iterations=10, init="medoid")
        counts = bt.launch_counts()
        log(f"[medoid] dba_batch(init='medoid') hist {str(dtype)[6:]}: dtw_cost "
            f"{counts['dtw_cost']}, dba_update {counts['dba_update']}")
        ok &= counts["dtw_cost"] == 1 and counts["dba_update"] == 10
        if dtype == torch.float32:
            _tally(report, "medoid", counts)
    dm = _abs(medoid[torch.float32], medoid[torch.float64])
    log(f"[medoid] f32 vs f64: max |dy| {dm:.3e} degC (gate {PARITY_DEGC})")
    ok &= dm < PARITY_DEGC
    if not ok:
        print("chip_smoke: the subgradient or medoid check failed", file=sys.stderr)
    return ok


def run_fast_routes(torch, bt, inputs, dev, step_out, ems, report):
    """Phase 8: the coarse-to-fine-in-time route, the 30-step BFGS and the
    chunked fit, at the flagship shape.  Keeps the truth's, bfgs-30's and
    Adam-2000's moments in ``report`` for phase 13."""
    from bayesian_ensembling_tpu_torch.ops import gp as gp_ops

    warm = run_slice(torch, bt, inputs, dev, torch.float32, WARM_NITS, **WARM_KW)
    warm64 = run_slice(torch, bt, inputs, dev, torch.float64, WARM_NITS, **WARM_KW)
    gap = _moments_gap(warm, warm64)
    log(f"[warm] stride {WARM_KW['time_stride']}, {WARM_NITS} coarse + {WARM_KW['fine_steps']} fine "
        f"steps: f32 vs f64 on the card max |dmoment| {gap:.3e} degC (gate {PARITY_DEGC})")
    ok = gap < PARITY_DEGC

    bfgs = run_slice(torch, bt, inputs, dev, torch.float32, BFGS_NITS, **BFGS_KW)
    bfgs64 = run_slice(torch, bt, inputs, dev, torch.float64, BFGS_NITS, **BFGS_KW)
    log(f"[bfgs] {BFGS_NITS} steps: f32 vs f64 on the card max |dmoment| "
        f"{_moments_gap(bfgs, bfgs64):.3e} degC (reported only: an accept/reject flip forks the "
        f"trajectory)")
    staged_bfgs = _staged(torch, bt, inputs, dev, BFGS_NITS, **BFGS_KW)
    same = all(torch.equal(a, b) for a, b in zip(staged_bfgs[0], bfgs))
    truth = _staged(torch, bt, inputs, dev, TRUTH_NITS)
    scratch = run_slice(torch, bt, inputs, dev, torch.float32, SCRATCH_NITS)
    finite = all(bool(torch.isfinite(a).all()) for a in scratch)
    log(f"[bfgs] the staged bfgs run equals the stepped one bit for bit: {same}; Adam-{SCRATCH_NITS} "
        f"finite: {finite}")
    ok &= same and finite and _bfgs_gate(torch, bt, inputs, dev, staged_bfgs, truth, scratch)
    report["truth_out"], report["bfgs_out"], report["scratch_out"] = truth[0], staged_bfgs[0], scratch

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


def _library_pass(bt, inputs, dev, dtype, nits, weighter=None, scenarios=None, check=None):
    """``run_scenario`` for each scenario (all when ``scenarios`` is None) on
    fresh collections; ``check(si, n_models)`` is called right after each
    scenario with the launch counters as that scenario left them.  Returns
    the results, the fitted collections and the observations."""
    built, observations = library_scenarios(bt, inputs)
    picked = range(len(built)) if scenarios is None else scenarios
    results = []
    for si in picked:
        hist, ssp = built[si]
        bt.reset_launch_counts()
        res = bt.run_scenario(
            hist, ssp, observations, f"scenario{si}",
            weighter=bt.LogLikelihoodWeight() if weighter is None else weighter,
            emulator=bt.GPDTW1D(dtype=dtype), n_optim_nits=nits, device=dev)
        if check is not None:
            check(si, len(hist))
        results.append(res)
    return results, [built[si] for si in picked], observations


def _bary(torch, results):
    """(means, stddevs) of the scenarios' barycentres, each a list of (T,) tensors."""
    return ([r.barycentre.gaussian.mean for r in results],
            [torch.sqrt(r.barycentre.gaussian.variance) for r in results])


def _library_options(torch, bt, hist, ssp, observations, weights):
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
        got = getattr(bt, name)()(hist, observations, **opts)
        counts = bt.launch_counts()
        want = getattr(bt, name)()(hist64, observations, **opts)
        dw = float(np.abs(got.values - want.values).max())
        sums = float(np.abs(got.values.sum(axis=0) - 1.0).max())
        label = name + ("(" + ", ".join(f"{k}={v}" for k, v in opts.items()) + ")" if opts else "")
        log(f"[library] {label}: f32 card vs f64 CPU: max |dweight| {dw:.3e} (gate {WEIGHT_TOL}), "
            f"|sum - 1| {sums:.1e}; chol {counts['chol']}, solve_vec {counts['solve_vec']} launches")
        ok &= bool(np.isfinite(got.values).all()) and dw < WEIGHT_TOL and sums < 1e-5
    for mode in ("w2", "compat", "mixture"):
        got = bt.Barycentre()(ssp, weights, sigma_mode=mode)
        want = bt.Barycentre()(ssp64, weights, sigma_mode=mode)
        gap = max(_abs(got.gaussian.mean, want.gaussian.mean),
                  _abs(torch.sqrt(got.gaussian.variance), torch.sqrt(want.gaussian.variance)))
        log(f"[library] Barycentre(sigma_mode={mode!r}): f32 card vs f64 CPU max |dmoment| "
            f"{gap:.3e} degC (gate {PARITY_DEGC})")
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
                "tri_inv": 2 * nits, "chol": 1, "dtw_cost": 0, "solve_vec": 2,
                **gram_launches(2 * nits)}
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

    res32, fitted, observations = _library_pass(bt, inputs, dev, torch.float32, nits, check=check)
    _tally(report, "library", totals)
    m32, s32 = _bary(torch, res32)
    finite = all(bool(torch.isfinite(a).all()) for a in m32 + s32)
    wsum = max(float(np.abs(r.weights.values.sum(axis=0) - 1.0).max()) for r in res32)
    log(f"[library] run_scenario(LogLikelihoodWeight) x {len(res32)} scenarios, f32 on the card, "
        f"{nits} Adam steps: finite={finite}, max |sum of weights - 1| {wsum:.1e}; "
        f"launches in all {totals}")
    ok &= finite and wsum < 1e-5 and totals["solve_vec"] > 0
    log("[library] 2100 barycentre by scenario: " + ", ".join(
        f"{m_[-1].item():.3f}+-{s_[-1].item():.3f}" for m_, s_ in zip(m32, s32)))

    res64, _, _ = _library_pass(bt, inputs, dev, torch.float64, nits)
    m64, s64 = _bary(torch, res64)
    dmean = max(_abs(a, b) for a, b in zip(m32, m64))
    dstd = max(_abs(a, b) for a, b in zip(s32, s64))
    dw = max(float(np.abs(a.weights.values - b.weights.values).max()) for a, b in zip(res32, res64))
    log(f"[library] f64 on the card: f32 vs f64 max |dmean| {dmean:.3e} degC, max |dstd| "
        f"{dstd:.3e} degC (gate {PARITY_DEGC}), max |dweight| {dw:.3e} (gate {WEIGHT_TOL})")
    ok &= dmean < PARITY_DEGC and dstd < PARITY_DEGC and dw < WEIGHT_TOL
    del res64, m64, s64

    hist0, ssp0 = fitted[0]
    ok &= _library_options(torch, bt, hist0, ssp0, observations, res32[0].weights)

    crps, _, _ = _library_pass(bt, inputs, dev, torch.float32, nits, weighter=bt.CRPSWeight(),
                               scenarios=[0])
    gap = max(_abs(crps[0].barycentre.gaussian.mean, step_out[0][0]),
              _abs(torch.sqrt(crps[0].barycentre.gaussian.variance), step_out[1][0]))
    dw = float(np.abs(crps[0].weights.values[:, 0] - step_out[2][0].cpu().numpy()).max())
    log(f"[library] run_scenario(CRPSWeight) scenario 0 vs the fused step: max |dmoment| "
        f"{gap:.3e} degC (gate {PARITY_DEGC}), max |dweight| {dw:.3e}")
    ok &= gap < PARITY_DEGC
    if not ok:
        print("chip_smoke: the library API failed its check", file=sys.stderr)
    return ok, fitted, res32


# ------------------------------------------------------------------ gridded
# The 5-degree gridded workload of benchmarks/gridded_bench.py (``500 36 72
# --profile fast``): gridded_common's 5 models x 10 realisations x 86 annual
# steps and 10 observation members on 36 x 72 cells; 12,960 (model, cell)
# GP fits.
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
GRID_SUB = 8  # the 8 x 8 sub-grids of the library route's f64 check and the svgp mode
SVGP_EPOCHS = 10  # svgp mode: 10 epochs of 5,504 // 500 = 11 steps, 400 inducing points
SVGP_DEGC = 1e-3  # svgp mode, float64 on the card against float64 on the CPU


def _oracle_entries(name):
    with open(os.path.join(ROOT, "benchmarks", name)) as fh:
        loaded = json.load(fh)
    return loaded["entries"] if "entries" in loaded else [loaded]


def select_oracle_entry(entries, *, n_iters, n_cells, warm_stride, fine_nits, lat, lon,
                        optimizer="adam"):
    """Copy of ``benchmarks/gridded_bench.select_oracle_entry`` (that module
    imports the JAX package): the entry of this configuration, or None
    (entries without an optimizer are Adam)."""
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
    t = block.shape[-1]
    coords = {"time": (np.datetime64("1930", "Y") + np.arange(t)).astype("datetime64[ns]"),
              "latitude": -87.5 + 5.0 * np.arange(lat), "longitude": 2.5 + 5.0 * np.arange(lon)}

    def cells(a):  # (C, R, T) -> (R, T, lat, lon)
        return np.ascontiguousarray(a.reshape(lat, lon, a.shape[1], t).transpose(2, 3, 0, 1))

    models = [bt.ProcessModel(bt.DimArray(cells(block[k]), dims, dict(coords), name="tas"),
                              f"model{k}") for k in range(block.shape[0])]
    observations = bt.ProcessModel(bt.DimArray(cells(obs), dims, dict(coords), name="tas"),
                                   "Observations")
    return models, observations


def run_gridded(torch, bt, dev, report):
    """Phase 10: the gridded surface at the 5-degree north-star grid (see the
    module docstring)."""
    ok = True
    gridded_common = _gridded_common()
    c = GRID_LAT * GRID_LON
    block, obs = gridded_common.make_workload_cells(np.arange(c))
    log(f"[gridded] M={gridded_common.M} x {GRID_LAT}x{GRID_LON} cells x R={gridded_common.R} x "
        f"T={gridded_common.T}, R_obs={gridded_common.R_OBS}: {gridded_common.M * c} fits")
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

    blk = torch.tensor(block, device=dev)
    ob = torch.tensor(obs, device=dev)
    mk = torch.ones(blk.shape[:3], dtype=torch.bool, device=dev)
    bt.reset_launch_counts()
    out = bt.gridded_ensemble_step(blk, ob, mk, n_optim_nits=GRID_NITS, return_fit=True, **GRID_KW)
    launches, routes = bt.launch_counts(), bt.route_counts()
    expected = {"dba_update": 10, "dba_update_split": 0, "chol_solve": 2 * GRID_NITS + 1,
                "tri_inv": GRID_NITS + 1, "chol": 0, "dtw_cost": 0, "solve_vec": 0,
                **gram_launches(2 * GRID_NITS, GRID_NITS)}
    expected_routes = {"kernel": 3 * GRID_NITS + 2, "blocked": 0, "library": 0}
    wsum = out[2].double().sum(dim=0)
    finite = all(bool(torch.isfinite(a).all()) for a in out[:3])
    gap = _oracle_gap(out, bfgs_entry)
    log(f"[gridded] gridded_ensemble_step bfgs-{GRID_NITS} f32, {gridded_common.M * c} fits: launches "
        f"{launches} (expected {expected}); routes {routes} (expected {expected_routes})")
    log(f"[gridded] first {bfgs_entry['n_cells']} cells vs the JAX float64 oracle (bfgs-{GRID_NITS}): "
        f"max |dmean| {gap[0]:.3e}, max |dstd| {gap[1]:.3e} (gate {GRID_TOL}); finite={finite}, "
        f"max |sum of weights - 1| {(wsum - 1).abs().max().item():.1e}")
    ok &= (launches == expected and routes == expected_routes and finite
           and (wsum - 1).abs().max().item() < 1e-5 and max(gap) < GRID_TOL)
    _tally(report, "gridded", launches)

    # The float64 refinement of the whole grid at the step's fit, on the card;
    # the first cells again in float64 by the plain versions on the CPU.
    # Phase 12 holds the sharded gridded step to this run bit for bit.
    report["gridded_f32"] = dict(blk=blk, ob=ob, mk=mk, out=out[:3], launches=launches,
                                 routes=routes)
    params, ym, yv = out[3:]
    refined = bt.refined_gridded_f64(blk, ob, mk, params, (ym, yv), device=dev)
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
    log(f"[gridded] refined_gridded_f64 on the card, whole grid in one piece, vs float64 plain on "
        f"the CPU ({nc} cells): {rgap:.3e} (gate {REFINED_DEGC}); f32 -> f64 drift {drift:.3e}")
    ok &= rgap < REFINED_DEGC and all(np.isfinite(a).all() for a in refined)
    del out, params, ym, yv, refined

    # Adam-500 on the oracle's cells.
    adam = bt.gridded_ensemble_step(blk[:, :nc].contiguous(), ob[:nc].contiguous(),
                                    mk[:, :nc].contiguous(), n_optim_nits=GRID_ADAM_NITS)
    gap = _oracle_gap(adam, adam_entry)
    log(f"[gridded] Adam-{GRID_ADAM_NITS} on the first {nc} cells ({gridded_common.M * nc} fits): "
        f"vs the oracle max |dmean| {gap[0]:.3e}, max |dstd| {gap[1]:.3e} (gate {GRID_TOL})")
    ok &= max(gap) < GRID_TOL

    # The coarse-to-fine warm start: bfgs-30 on every 5th row and column,
    # then bfgs-20 on every cell from its nearest coarse cell.
    def warm():
        init = bt.coarse_warm_start(blk, mk, GRID_LAT, GRID_LON, GRID_WARM_STRIDE,
                                    n_optim_nits=GRID_NITS, **GRID_KW)
        return bt.gridded_ensemble_step(blk, ob, mk, gp_init=init, n_optim_nits=GRID_WARM_FINE,
                                        **GRID_KW)

    wout = warm()
    nc = warm_entry["n_cells"]
    finite = all(bool(torch.isfinite(a).all()) for a in wout[:3])
    first = [a[:nc].double().cpu().numpy() for a in wout[:2]]
    (q32, q_warm), (_, q_500) = (quality_gap(*first, truth_entry, warm_entry),
                                 quality_gap(*first, truth_entry, adam_entry))
    gap = _oracle_gap(wout, warm_entry)
    blk, ob = blk.double(), ob.double()
    gap64 = _oracle_gap(warm(), warm_entry)
    log(f"[gridded] warm start (stride {GRID_WARM_STRIDE}, bfgs-{GRID_NITS} coarse, "
        f"bfgs-{GRID_WARM_FINE} fine), first {nc} cells: f32 max |d| from the "
        f"float64 Adam-{GRID_TRUTH_NITS} truth: mean {q32[0]:.5f}, std {q32[1]:.5f} (gate: no worse "
        f"than the JAX float64 run of this configuration, {q_warm[0]:.5f} / {q_warm[1]:.5f}, "
        f"x{GRID_QUALITY_SLACK}; scratch Adam-{GRID_ADAM_NITS} {q_500[0]:.5f} / {q_500[1]:.5f}, the "
        f"bench's baseline, which that JAX run misses too, ROADMAP C11); f32 vs the warm oracle "
        f"max |dmean| {gap[0]:.3e}, max |dstd| {gap[1]:.3e} (reported); f64 on the card "
        f"vs the warm oracle max |dmean| {gap64[0]:.3e}, max |dstd| {gap64[1]:.3e} (gate {GRID_TOL})")
    ok &= quality_ok(q32, q_warm) and max(gap64) < GRID_TOL and finite
    del wout, blk, ob, mk
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
    gridded_common = _gridded_common()
    models, observations = _gridded_collections(bt, block, obs, GRID_LAT, GRID_LON)
    # One emulation a model: 10 DBA passes, and a B2 and a B3 launch for each
    # of the Adam steps and for the posterior; the diagonal posteriors send
    # no weighter to B4 or B5.
    fits = gridded_common.M * (GRID_ADAM_NITS + 1)
    expected = {"dba_update": 10 * gridded_common.M, "dba_update_split": 0, "chol_solve": fits,
                "tri_inv": fits, "chol": 0, "dtw_cost": 0, "solve_vec": 0,
                **gram_launches(gridded_common.M * GRID_ADAM_NITS)}
    bt.reset_launch_counts()
    w, bary = bt.run_gridded_scenario(bt.ModelCollection(models), observations,
                                      n_optim_nits=GRID_ADAM_NITS, device=dev)
    launches = bt.launch_counts()
    finite = bool(np.isfinite(bary.mean.values).all() and np.isfinite(bary.stddev.values).all())
    wsum = float(np.abs(w.values.sum(axis=0) - 1.0).max())
    log(f"[gridded-library] run_gridded_scenario(CRPSWeight), {gridded_common.M} x "
        f"{GRID_LAT}x{GRID_LON}, f32, {GRID_ADAM_NITS} Adam steps: launches {launches} (expected "
        f"{expected}); finite={finite}, max |sum of weights - 1| {wsum:.1e}")
    ok &= finite and wsum < 1e-5 and launches == expected

    sub = (np.arange(GRID_SUB)[:, None] * GRID_LON + np.arange(GRID_SUB)[None, :]).ravel()
    small, small_obs = _gridded_collections(bt, block[:, sub], obs[sub], GRID_SUB, GRID_SUB)
    res = {dtype: bt.run_gridded_scenario(
               bt.ModelCollection([bt.ProcessModel(pm.data, pm.name) for pm in small]), small_obs,
               emulator=bt.GPDTW3D(dtype=dtype), device=dev)
           for dtype in (torch.float32, torch.float64)}
    (w32, b32), (w64, b64) = res[torch.float32], res[torch.float64]
    dmean = float(np.abs(b32.mean.values - b64.mean.values).max())
    dstd = float(np.abs(b32.stddev.values - b64.stddev.values).max())
    dw = float(np.abs(w32.values - w64.values).max())
    log(f"[gridded-library] {GRID_SUB}x{GRID_SUB} sub-grid, f32 vs f64 on the card: max |dmean| "
        f"{dmean:.3e} degC, max |dstd| {dstd:.3e} degC (gate {PARITY_DEGC}), max |dweight| {dw:.3e}")
    ok &= dmean < PARITY_DEGC and dstd < PARITY_DEGC

    bt.reset_launch_counts()
    _, bl = bt.run_gridded_scenario(
        bt.ModelCollection([bt.ProcessModel(pm.data, pm.name) for pm in small]), small_obs,
        weighter=bt.LogLikelihoodWeight(), n_optim_nits=GRID_ADAM_NITS, device=dev)
    launches = bt.launch_counts()
    finite = bool(np.isfinite(bl.mean.values).all())
    log(f"[gridded-library] LogLikelihoodWeight on the diagonal posteriors: launches {launches} "
        f"(expected {expected}: chol and solve_vec stay 0); finite={finite}")
    ok &= finite and launches == expected

    # The svgp mode: the minibatch indices come from a CPU generator seeded
    # by (seed, step), so the card and the CPU take the same minibatches.
    svgp = []
    for where in (dev, torch.device("cpu")):
        mc = bt.ModelCollection([bt.ProcessModel(small[0].data, small[0].name)])
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            em = bt.GPDTW3D(mode="svgp", dtype=torch.float64)
        mc.fit(em, n_optim_nits=SVGP_EPOCHS, device=where)
        g = mc[0].distribution.gaussian
        svgp.append((g.mean.cpu(), torch.sqrt(g.var).cpu()))
    gap = max(_abs(svgp[0][0], svgp[1][0]), _abs(svgp[0][1], svgp[1][1]))
    log(f"[gridded-svgp] GPDTW3D(mode='svgp') float64, {GRID_SUB}x{GRID_SUB} cells x {block.shape[-1]} "
        f"steps, {SVGP_EPOCHS} epochs, 400 inducing points, card vs CPU: max |dmoment| {gap:.3e} degC "
        f"(gate {SVGP_DEGC})")
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


def gram_launches(forwards, backwards=None):
    """The Gram kernels' launches of Matern-3/2 fits on the card: one build
    an NLML evaluation of the fit (``forwards``), one contraction a gradient
    (``backwards``, by default one an evaluation, as an Adam step has).  The
    posterior keeps PyTorch's chain."""
    return {"gram_matern32": forwards,
            "gram_matern32_grad": forwards if backwards is None else backwards}


def pmt_launches(kind, n_folds=0, n_models=0):
    """Expected launches of one ``batched_pmt`` call of ``kind`` on
    full-covariance posteriors (the loglik table: one Cholesky of all the
    models' covariances and two forward-only vector solves), plus those of
    ``n_folds`` library ``LogLikelihoodWeight`` calls (the same three a
    fold)."""
    table = 1 if kind == "loglik" else 0
    return {"dba_update": 0, "dba_update_split": 0, "chol_solve": 0, "tri_inv": 0,
            "chol": table + n_folds, "dtw_cost": 0, "solve_vec": 2 * (table + n_folds),
            **gram_launches(0)}


def fold_fit_launches(n_folds, nits, dba_iterations=10):
    """Expected launches of the fold loop with fresh ``GPDTW1D`` fits: three
    fits a fold (the remaining hindcast models, the remaining forecast
    models, the pseudo truth), each ``dba_iterations`` DBA updates, a
    Cholesky-solve per Adam step and for the posterior, a triangular
    inverse and both Gram kernels per Adam step; then the fold's
    ``LogLikelihoodWeight``."""
    out = pmt_launches("uniform", n_folds=n_folds)
    out.update(dba_update=3 * n_folds * dba_iterations, chol_solve=3 * n_folds * (nits + 1),
               tri_inv=3 * n_folds * nits, **gram_launches(3 * n_folds * nits))
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

    ok = True

    def counted(expected, label):
        nonlocal ok
        launches = bt.launch_counts()
        _tally(report, "validation", launches)
        good = launches == expected
        if not good:
            log(f"[validation] {label}: launches {launches}, expected {expected}")
        ok &= good

    # (a) batched_pmt, every weight kind under the campaign's shape bucket,
    # float32 on the card against float64 on the CPU at the same posteriors.
    worst = {}
    for si, (hist, ssp) in enumerate(fitted):
        hist64, ssp64 = _posteriors_f64_on_cpu(bt, hist), _posteriors_f64_on_cpu(bt, ssp)
        variants = [(kind, {}) for kind in PMT_KINDS]
        if si == 0:
            variants += [("crps", {"sigma_mode": "compat"}), ("crps", {"sigma_mode": "mixture"}),
                         ("crps", {"include_sim": True})]
        for kind, kw in variants:
            bt.reset_launch_counts()
            got = bt.batched_pmt(hist, ssp, kind, pad_shape=PMT_PAD, **kw)
            counted(pmt_launches(kind), f"scenario {si} {kind} {kw}")
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")  # compat's cap warning, on both sides alike
                want = bt.batched_pmt(hist64, ssp64, kind, pad_shape=PMT_PAD, **kw)
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
    names, loop = pmt._fold_scores(use_prefit_models=True)
    counted(pmt_launches("uniform", n_folds=len(names)), "fold loop, prefit")
    bt.reset_launch_counts()
    batched = bt.batched_pmt(hist, ssp, "loglik")
    counted(pmt_launches("loglik"), "batched, for the loop")
    gap = col_rel_gap(loop, batched)
    log(f"[validation] (b) scenario {si} ({len(names)} folds), LogLikelihoodWeight: fold loop vs "
        f"batched, f32 on the card; max rel |d| {gap:.3e} (gate {PMT_LOOP_REL}); {len(names)} B4 "
        f"and {2 * len(names)} B5 launches in the loop")
    ok &= gap < PMT_LOOP_REL and names == hist.model_names

    # (c) the harness with fresh fits per fold (16 folds x 3 GPDTW1D fits),
    # float32 and float64 on the card.
    built, _ = library_scenarios(bt, inputs)
    scores = {}
    for dtype in (torch.float32, torch.float64):
        raw_hist, raw_ssp = built[si]
        fresh = bt.PerfectModelTest(raw_hist, raw_ssp, lambda: bt.GPDTW1D(dtype=dtype),
                                    bt.LogLikelihoodWeight, bt.Barycentre, f"scenario{si}")
        bt.reset_launch_counts()
        _, scores[dtype] = fresh._fold_scores(n_optim_nits=PMT_FIT_NITS, device=dev)
        counted(fold_fit_launches(len(raw_hist), PMT_FIT_NITS), f"fresh fits {dtype}")
        ok &= all(pm.distribution is None for pm in raw_hist) and bool(
            np.isfinite(scores[dtype]).all())
    degc, nll = pmt_gaps(scores[torch.float32], scores[torch.float64])
    f32, f64 = scores[torch.float32], scores[torch.float64]
    log(f"[validation] (c) fresh fits, {len(f32)} folds x 3 GPDTW1D fits x {PMT_FIT_NITS} Adam steps, "
        f"f32 vs f64 on the card: max |d| rmse/w2/crps {degc:.3e} degC (gate {PARITY_DEGC}); nll f32 "
        f"{f32[:, 0].mean():.4f} vs f64 {f64[:, 0].mean():.4f} (mean over folds, max rel |d| "
        f"{nll:.3e}, not gated)")
    ok &= degc < PARITY_DEGC

    # (d) serving: phase 9's results, then the gridded artifacts.
    serve = bt.serve
    with tempfile.TemporaryDirectory() as tmp:
        good, lines = serve_roundtrip(serve.ProjectionService,
                                      {r.ssp: r for r in results}, os.path.join(tmp, "gmst"))
        for line in lines:
            log(f"[serve] {line}")
        log(f"[serve] from_results x {len(results)}, save / load and HTTP: "
            f"{'as expected' if good else 'FAILED'}")
        ok &= good
        bt.reset_launch_counts()
        with recorded_gridded_posteriors(serve.ProjectionService) as rec:
            serve.build_gridded_artifacts(os.path.join(tmp, "gridded"), device=dev)
        launches = bt.launch_counts()
        _tally(report, "serve", launches)
        m, nits = 5, 500  # build_gridded_artifacts' defaults: 5 models, 500 Adam steps
        expected = {"dba_update": 10 * m, "dba_update_split": 0, "chol_solve": m * (nits + 1),
                    "tri_inv": m * (nits + 1), "chol": 0, "dtw_cost": 0, "solve_vec": 0,
                    **gram_launches(m * nits)}
        loaded = serve.ProjectionService.load(os.path.join(tmp, "gridded"))
        gap = gridded_serve_gap(loaded, "gridded", rec.posteriors["gridded"])
        log(f"[serve] build_gridded_artifacts (12 x 24 cells, 5 models, 10 realisations, T = 86, "
            f"{nits} Adam steps) on the card: launches {launches} (expected {expected}); "
            f"project_point at every cell and map_grid vs the served posterior: max |d| {gap:.1e}")
        ok &= launches == expected and gap < 1e-6
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

    ok = True
    address = f"tcp://127.0.0.1:{bt.parallel.mesh.free_port()}"
    dist.init_process_group(backend, init_method=address, world_size=1, rank=0)
    try:
        mesh_1d = init_device_mesh(dev.type, (1,), mesh_dim_names=("model",))
        mesh_sm = init_device_mesh(dev.type, (1, 1), mesh_dim_names=("scenario", "model"))
        mesh_mc = init_device_mesh(dev.type, (1, 1), mesh_dim_names=("model", "cells"))
        log(f"[sharded] one-rank {backend} group; meshes {mesh_1d}, {mesh_sm}, {mesh_mc}")

        def surface(name, fn, want, want_collectives, want_launches, want_routes):
            bt.reset_launch_counts()
            got = fn()
            counts = (bt.collective_counts(), bt.launch_counts(), bt.route_counts())
            _tally(report, "sharded", counts[1])
            same, gap = _bitwise(torch, got, want)
            good = same and counts == (want_collectives, want_launches, want_routes)
            log(f"[sharded] {name}: bit for bit the unsharded run's: {same} (largest "
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
                      f"T={t_h}/{inputs[2].shape[-1]}, {PARITY_NITS} Adam steps",
                      lambda: step(*_tensors(torch, inputs, dev, torch.float32)),
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
                      f"T={pack.uh.shape[-1]}/{pack.usb.shape[-1]}, {MONTHLY_NITS} Adam steps",
                      lambda: campaign(*args), m["out"], {"all_reduce": 0, "all_gather": 2},
                      m["launches"], m["routes"])
        del m, args

        # (c) The 5-degree grid of phase 10 (bfgs-30) on a (model 1, cells 1) mesh.
        g = report.pop("gridded_f32")
        gstep = bt.make_sharded_gridded_step(mesh_mc, n_optim_nits=GRID_NITS, **GRID_KW)
        ok &= surface(f"make_sharded_gridded_step, {g['blk'].shape[0]} x {g['blk'].shape[1]} cells, "
                      f"bfgs-{GRID_NITS}", lambda: gstep(g["blk"], g["ob"], g["mk"], None),
                      g["out"], {"all_reduce": 3, "all_gather": 0}, g["launches"], g["routes"])
        del g

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
            ref[dtype] = [_local(r).cpu().numpy() for r in one(*arrays)]
            ref_launches[dtype] = bt.launch_counts()
    finally:
        dist.destroy_process_group()
    two = bt.parallel.run_local(sharded_two_rank_worker, 2, runs, PARITY_NITS, dev.type,
                                timeout=SHARDED_TIMEOUT)
    log(f"[sharded] gloo on {dev.type} tensors, two ranks on the card: {two['probe']}")
    if all(dtype in two for dtype in runs):
        log(f"[sharded] make_sharded_step, {m_} models on one rank and {m_ // 2} on each of two, "
            f"{PARITY_NITS} Adam steps, float64 then float32")
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
    if not ok:
        print("chip_smoke: a sharded surface failed its check", file=sys.stderr)
    return ok


# Phase 13: optimizer="lbfgs" (optax.lbfgs(): one zoom line search for each
# fit's summed objective) at the flagship's width.
LBFGS_NITS = 150  # the JAX package's measured configuration (benchmarks/lbfgs_bench.py:45)
LBFGS_CHECK_NITS = 30  # (a): scenario 0 in float64, card against CPU; (d)'s depth
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
    evaluation's backward and the posterior's variance; the Gram build for
    every evaluation and recorded loss, its contraction for every backward.  ``evals``: the
    line search's evaluations plus the fresh ones (``ops.lbfgs.counts()``)."""
    launches = {"dba_update": n_fits * dba_iterations, "dba_update_split": 0,
                "chol_solve": evals + n_fits * (nits + 1), "tri_inv": evals + n_fits, "chol": 0,
                "dtw_cost": 0, "solve_vec": 0, **gram_launches(evals + n_fits * nits, evals)}
    routes = {"kernel": 2 * evals + n_fits * (nits + 2), "blocked": 0, "library": 0}
    return launches, routes


def run_lbfgs(torch, bt, inputs, dev, report, nits=LBFGS_NITS, check_nits=LBFGS_CHECK_NITS):
    """Phase 13: (a) scenario 0 through ``ensemble_scenario_step(optimizer=
    "lbfgs")`` in float64 on the card and on the CPU, equal line-search
    counts at every step; (b) the full flagship through
    ``ensemble_multi_scenario_step(optimizer="lbfgs")`` in float32, every
    launch counter against the evaluations the line search reports, every
    step's objective finite, its distance to phase 8's truth printed beside
    Adam-2000's and bfgs-30's (``report``); (c) (b) in float32 against
    float64 on the card; (d) ``run_scenario(optimizer="lbfgs")`` for
    scenario 0, float32 against float64 on the card."""
    from bayesian_ensembling_tpu_torch.ops import lbfgs

    cpu = torch.device("cpu")
    hb, hm, sb, sm, obs, mm = inputs
    scenario0 = (hb[0], hm[0], sb[0], sm[0], obs, mm[0])
    kw = dict(dba_iterations=10, optimizer="lbfgs")
    runs = {}
    for where in (dev, cpu):
        lbfgs.reset_counts()
        out = bt.ensemble_scenario_step(*_tensors(torch, scenario0, where, torch.float64),
                                        n_optim_nits=check_nits, **kw)
        runs[where.type] = (lbfgs.trace(), out)
    (card_tr, card_out), (cpu_tr, cpu_out) = runs[dev.type], runs["cpu"]
    same_counts = [c for c, _ in card_tr] == [c for c, _ in cpu_tr]
    loss_rel = max(abs(a - b) / max(abs(b), 1e-300) for (_, a), (_, b) in zip(card_tr, cpu_tr))
    gap = _moments_gap(card_out, cpu_out)
    log(f"[lbfgs] (a) scenario 0, {check_nits} steps a fit, float64, card vs CPU: line-search "
        f"steps per step equal at every step: {same_counts} ({sum(c for c, _ in card_tr)} "
        f"evaluations on the card, {sum(c for c, _ in cpu_tr)} on the CPU); summed objective max "
        f"rel gap {loss_rel:.3e} (gate {LBFGS_LOSS_REL}); barycentre max |dmoment| {gap:.3e} degC "
        f"(gate {LBFGS_F64_DEGC})")
    ok = same_counts and len(card_tr) == 2 * check_nits and loss_rel < LBFGS_LOSS_REL
    ok &= gap < LBFGS_F64_DEGC

    # (b) The flagship in float32, counted.
    lbfgs.reset_counts()
    bt.reset_launch_counts()
    out = run_slice(torch, bt, inputs, dev, torch.float32, nits, **kw)
    launches, routes, counts, tr = (bt.launch_counts(), bt.route_counts(), lbfgs.counts(),
                                    lbfgs.trace())
    evals = counts["linesearch_evals"] + counts["fresh_evals"]
    want_launches, want_routes = lbfgs_expected_launches(evals, nits)
    finite = (len(tr) == 2 * nits and all(np.isfinite(v) for _, v in tr)
              and all(bool(torch.isfinite(a).all()) for a in out))
    log(f"[lbfgs] (b) flagship float32, {nits} steps a fit: {evals / (2 * nits):.3f} evaluations a "
        f"step and collection ({counts}); launches {launches} (expected {want_launches}); routes "
        f"{routes} (expected {want_routes}); every step's objective finite: {finite}")
    ok &= _counts_match(launches, want_launches) and _counts_match(routes, want_routes) and finite
    _tally(report, "lbfgs", launches)
    if "truth_out" in report:
        truth = report["truth_out"]
        log(f"[lbfgs] (b) distance to phase 8's {TRUTH_NITS}-step Adam truth: lbfgs-{nits} "
            f"{_moments_gap(out, truth):.4e} degC, Adam-{SCRATCH_NITS} "
            f"{_moments_gap(report['scratch_out'], truth):.4e} degC, bfgs-{BFGS_NITS} "
            f"{_moments_gap(report['bfgs_out'], truth):.4e} degC (printed only: one step size "
            f"serves all {hb.shape[0] * hb.shape[1]} models of a fit)")

    # (c) The same in float64 on the card.
    out64 = run_slice(torch, bt, inputs, dev, torch.float64, nits, **kw)
    gap = _moments_gap(out, out64)
    log(f"[lbfgs] (c) float64 on the card: float32 vs float64 max |dmoment| {gap:.3e} degC (gate "
        f"{PARITY_DEGC})")
    ok &= gap < PARITY_DEGC

    # (d) The library entry point for scenario 0, at (a)'s depth.
    built, observations = library_scenarios(bt, inputs)
    hist, ssp = built[0]
    res = {}
    for dtype in (torch.float32, torch.float64):
        bt.reset_launch_counts()
        res[dtype] = bt.run_scenario(hist, ssp, observations, "scenario0",
                                     emulator=bt.GPDTW1D(dtype=dtype), n_optim_nits=check_nits,
                                     optimizer="lbfgs", device=dev)
        lc = bt.launch_counts()
        log(f"[lbfgs] (d) run_scenario {str(dtype)[6:]}: launches {lc}")
        ok &= _launched(lc, ("dba_update", "chol_solve", "tri_inv"))
    (m32, s32), (m64, s64) = _bary(torch, [res[torch.float32]]), _bary(torch, [res[torch.float64]])
    gap = max(_abs(m32[0], m64[0]), _abs(s32[0], s64[0]))
    log(f"[lbfgs] (d) float32 vs float64 max |dmoment| {gap:.3e} degC (gate {PARITY_DEGC})")
    ok &= gap < PARITY_DEGC
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


def run_examples(bt, dev, report):
    """Phase 14: ``bayesian_ensembling_tpu_torch.examples.*.main`` on the
    card (float32, its default) against ``--device cpu --dtype float64``
    (0.01 degC on the numbers it prints), with each run's launches."""
    import importlib

    ok = True
    for name, keys in EXAMPLES.items():
        module = importlib.import_module(f"bayesian_ensembling_tpu_torch.examples.{name}")
        bt.reset_launch_counts()
        got = module.main(["--device", str(dev)])
        launches = bt.launch_counts()
        _tally(report, "examples", launches)
        want = module.main(["--device", "cpu", "--dtype", "float64"])
        gap = max(float(np.max(np.abs(np.asarray(got[k], dtype=np.float64)
                                      - np.asarray(want[k], dtype=np.float64)))) for k in keys)
        log(f"[examples] {name}: card float32 vs CPU float64 max |d| over {', '.join(keys)} "
            f"{gap:.3e} degC (gate {PARITY_DEGC}); launches {launches}")
        ok &= gap < PARITY_DEGC and _launched(launches, EXAMPLE_KERNELS)
    if not ok:
        print("chip_smoke: a port example failed its check", file=sys.stderr)
    return ok


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0, help="seed of the generated inputs")
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
    _build.library()
    log(f"[build] {_build.build_info['path']}")
    for line in _build.build_info["log"].splitlines():
        if "Used" in line or "Compiling entry" in line:
            log(f"[build]   {line.strip()}")

    log(f"[time] {time.perf_counter() - t_start:.1f} s at the start of phase 3")
    # Phase 3: the kernels against their plain versions.
    if not run_kernel_tests():
        return 1

    inputs = synthetic_flagship(args.seed)
    counts = inputs[1].sum(axis=2)
    s, m, r, t_hist = inputs[0].shape
    log(f"[inputs] S={s} M={m} R={r} T={t_hist}/{inputs[2].shape[-1]} R_obs={inputs[4].shape[0]}; "
        f"realisations per model {counts[counts > 0].min()}..{counts.max()}; real models per "
        f"scenario {inputs[5].sum(axis=1).astype(int).tolist()}")

    report = {}
    log(f"[time] {time.perf_counter() - t_start:.1f} s at the start of phase 4")
    # Phase 4: the slice through the kernels, then the f64 plain reference.
    bt.reset_launch_counts()
    bm, bs, w = run_slice(torch, bt, inputs, dev, torch.float32, PARITY_NITS)
    launches, routes = bt.launch_counts(), bt.route_counts()
    expected = {"dba_update": 2 * 10, "dba_update_split": 0, "chol_solve": 2 * (PARITY_NITS + 1),
                "tri_inv": 2 * (PARITY_NITS + 1), "chol": 0, "dtw_cost": 0, "solve_vec": 0,
                **gram_launches(2 * PARITY_NITS)}
    expected_routes = {"kernel": 4 * (PARITY_NITS + 1), "blocked": 0, "library": 0}
    log(f"[slice] f32 on the card, {PARITY_NITS} Adam steps: launches {launches} (expected "
        f"{expected}); routes {routes} (expected {expected_routes})")
    wsum = w.double().sum(dim=1)
    finite = all(bool(torch.isfinite(a).all()) for a in (bm, bs, w))
    if (launches != expected or routes != expected_routes or not finite
            or (wsum - 1.0).abs().max().item() > 1e-5):
        print(f"chip_smoke: slice check failed (finite={finite}, weight sums {wsum.tolist()})",
              file=sys.stderr)
        return 1
    _tally(report, "annual", launches)
    ref = run_slice(torch, bt, inputs, torch.device("cpu"), torch.float64, PARITY_NITS)
    dmean = _abs(bm, ref[0])
    dstd = _abs(bs, ref[1])
    dw = _abs(w, ref[2])
    log(f"[slice] f64 plain on the CPU: max |dmean| {dmean:.3e} degC, max |dstd| {dstd:.3e} degC "
        f"(gate {PARITY_DEGC}), max |dweight| {dw:.3e}")
    log("[slice] 2100 barycentre by scenario: "
        + ", ".join(f"{m_:.3f}+-{s_:.3f}" for m_, s_ in zip(bm[:, -1].tolist(), bs[:, -1].tolist())))
    if not (dmean < PARITY_DEGC and dstd < PARITY_DEGC):
        print("chip_smoke: f32 kernel path disagrees with the f64 plain path", file=sys.stderr)
        return 1
    step_out = (bm, bs, w)
    tail_ok, ems = check_tail_and_refinement(torch, bt, inputs, dev, step_out, PARITY_NITS)
    if not tail_ok:
        print("chip_smoke: a weight kind's tail or the float64 refinement disagrees", file=sys.stderr)
        return 1

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
    if not run_fast_routes(torch, bt, inputs, dev, step_out, ems, report):
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
    if not run_lbfgs(torch, bt, inputs, dev, report):
        return 1

    log(f"[time] {time.perf_counter() - t_start:.1f} s at the start of phase 14")
    # Phase 14: the port's examples on the card.
    if not run_examples(bt, dev, report):
        return 1

    by_path = report["launches"]
    log("[launches] each kernel's launches in each path's run: " + json.dumps(
        {k: {path: row.get(k, 0) for path, row in by_path.items()} for k in bt.launch_counts()}))

    log(f"[total] {time.perf_counter() - t_start:.1f} s")
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
