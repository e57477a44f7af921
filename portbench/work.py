"""Operations and bytes that a step needs, counted from shapes, and the peaks.

Frozen here so that a change to the program cannot change the yardstick.
The counts are what the algorithm needs, not what the program happens to
do: floating-point operations (a multiply and an add are two), inputs read
once and outputs written once.

Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at 700 W): 67
TFLOP/s in float32 outside the tensor cores (TF32 is off in every cell) and
3.35 TB/s of HBM3.
"""

from __future__ import annotations

import importlib

FP32_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12


def least_seconds(n_bytes: float, n_ops: float) -> float:
    """The least time the chip could take: bytes over the memory rate or
    operations over the float32 rate, whichever is larger."""
    return max(n_bytes / HBM_BYTES_PER_S, n_ops / FP32_FLOPS)


# Kernels, per launch on a batch of b problems of size t (e bytes an element).

def chol_solve_work(b, t, e=4):
    """B2, the fused Cholesky and two triangular solves: K and y read, L, z,
    alpha and log|K| written; t^3/3 for the factor and t^2 for each solve."""
    return b * (2 * t * t + 4 * t + 1) * e, b * (t ** 3 / 3 + 2 * t * t)


def tri_inv_work(b, t, e=4):
    """B3, the inverse of a triangular factor: its lower triangle read, the
    whole t x t result written; t^3/3 operations."""
    return b * (t * (t + 1) // 2 + t * t) * e, b * t ** 3 / 3


def dba_update_work(n, t, e=4):
    """B1, one DBA update of n (centre, series) pairs: centres and series read,
    sums and counts written; a subtract, a multiply, an add and two
    comparisons for each cell of the t x t table."""
    return 4 * n * t * e, 5 * n * t * t


# The step's operations, term by term, for one batch of b models of t steps
# with d realisations (the features' width).

def distance_ops(b, t, d):
    """The distance statistic of a fit: x x^T and the norms (2 t^2 d), then
    the square root of each entry (3 t^2)."""
    return b * (2 * t * t * d + 3 * t * t)


def gram_ops(b, t):
    """The Matern-3/2 Gram from the distances plus the noise: r, sqrt(3) r,
    the exponential, 1 + sqrt(3) r, two products (6 t^2)."""
    return b * 6 * t * t


def value_ops(b, t):
    """One NLML value: the Gram, the Cholesky (t^3/3), one triangular solve
    (t^2), y^T z and log|K| (3 t)."""
    return gram_ops(b, t) + b * (t ** 3 / 3 + t * t + 3 * t)


def value_and_grad_ops(b, t):
    """One NLML value and gradient: the value with the second solve (t^2),
    the triangular inverse W (t^3/3), K^-1 = W^T W (t^3/3), K^-1 - a a^T
    (2 t^2), dK/dl (5 t^2) and the two contractions with it and with dK/dv
    (4 t^2)."""
    return value_ops(b, t) + b * (2 * t ** 3 / 3 + 12 * t * t)


def posterior_ops(b, t):
    """The posterior marginals: the Gram, the Cholesky and two solves
    (t^3/3 + 2 t^2), W = L^-1 (t^3/3), W K (t^3), K a (2 t^2) and the
    column norms of W K (2 t^2)."""
    return gram_ops(b, t) + b * (t ** 3 / 3 + t ** 3 / 3 + t ** 3 + 6 * t * t)


def optimiser_evaluations(profile):
    """(value-and-gradient, value-only) evaluations a step of the optimiser:
    Adam one of the first, the damped BFGS one of each."""
    return (1, 0) if profile["optimizer"] == "adam" else (1, 1)


def fit_ops(b, t, d, profile):
    """The fit: the distances, then ``n_optim_nits`` steps (at every
    ``time_stride``-th step when that is above 1, then ``fine_steps`` at full
    t)."""
    vg, v = optimiser_evaluations(profile)

    def steps(n, tt):
        return n * (vg * value_and_grad_ops(b, tt) + v * value_ops(b, tt))

    stride = profile.get("time_stride", 1)
    if stride > 1:
        tc = -(-t // stride)
        return (distance_ops(b, tc, d) + steps(profile["n_optim_nits"], tc)
                + distance_ops(b, t, d) + steps(profile["fine_steps"], t))
    return distance_ops(b, t, d) + steps(profile["n_optim_nits"], t)


def emulation_ops(b, t, d, profile):
    """DBA, fit and posterior of one collection of b models: the DBA over
    every (model, realisation) pair of the padded batch as the step runs it,
    the target noise (4 t d), the fit and the posterior (which reuses the
    fit's distances)."""
    dba = profile["dba_iterations"] * dba_update_work(b * d, t)[1]
    return dba + b * 4 * t * d + fit_ops(b, t, d, profile) + posterior_ops(b, t)


def collections(config):
    """The batches one step emulates, as (b, t, d) triples: asked of the
    entry the configuration names (``portbench/entries``)."""
    return importlib.import_module(f"portbench.entries.{config['entry']}").collections(config)


def step_ops(config, profile):
    """Operations one step needs.  The weights and the barycentre (a few
    elementwise passes over the marginals) are left out."""
    return sum(emulation_ops(b, t, d, profile) for b, t, d in collections(config))


def kernel_step_seconds(kernel, config, profile):
    """The least time of one step's launches of ``kernel`` at the cell's
    shapes, each launch bounded alone: B2 takes every evaluation's forward
    pass and the posterior's, B3 every gradient's and the posterior's.  None
    for a coarse-to-fine fit, whose launches this count does not cover."""
    if profile.get("time_stride", 1) > 1:
        return None
    vg, v = optimiser_evaluations(profile)
    n = profile["n_optim_nits"]
    launches, work = {"chol_solve": (n * (vg + v) + 1, chol_solve_work),
                      "tri_inv": (n * vg + 1, tri_inv_work)}[kernel]
    return sum(launches * least_seconds(*work(b, t)) for b, t, _ in collections(config))
