"""Operations and bytes that a step needs, counted from shapes, and the peaks.

Frozen here so that a change to the program cannot change the yardstick.
The counts are what the algorithm needs, not what the program happens to
do: floating-point operations (a multiply and an add are two), inputs read
once and outputs written once.

Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at 700 W), by the
configuration's dtype (``PEAK_FLOPS``):

* float32: 67 TFLOP/s outside the tensor cores (TF32 is off in every
  float32 cell, so no float32 product reaches the tensor cores);
* float64: 67 TFLOP/s, the data sheet's "FP64 Tensor Core" figure.  cuBLAS
  runs float64 products on the tensor cores' DMMA path, and cuSOLVER's
  factorisations and solves spend their operations in those products, so
  they can pass the 34 TFLOP/s of the plain float64 units; 67 is the rate
  that no float64 work on the card can pass, which a share of the peak
  needs.

and 3.35 TB/s of HBM3 in either.
"""

from __future__ import annotations

import importlib

FP32_FLOPS = 67e12
FP64_FLOPS = 67e12
PEAK_FLOPS = {"float32": FP32_FLOPS, "float64": FP64_FLOPS}
ELEMENT_BYTES = {"float32": 4, "float64": 8}
HBM_BYTES_PER_S = 3.35e12


def peak_flops(config) -> float:
    """The card's operations a second in the configuration's dtype."""
    return PEAK_FLOPS[config["dtype"]]


def least_seconds(n_bytes: float, n_ops: float, dtype: str = "float32") -> float:
    """The least time the chip could take: bytes over the memory rate or
    operations over the rate of ``dtype``, whichever is larger."""
    return max(n_bytes / HBM_BYTES_PER_S, n_ops / PEAK_FLOPS[dtype])


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


def entry_of(config):
    """The module of the entry the configuration names (``portbench/entries``)."""
    return importlib.import_module(f"portbench.entries.{config['entry']}")


def collections(config):
    """The batches one step emulates, as (b, t, d) triples: asked of the
    entry the configuration names."""
    return entry_of(config).collections(config)


def counts_its_own(config) -> bool:
    """Whether the configuration's entry counts its step's operations itself
    (``step_ops`` in its module): an entry of another emulator than the
    exact GP, whose step runs none of ``emulation_ops``' terms."""
    return hasattr(entry_of(config), "step_ops")


def step_ops(config, profile):
    """Operations one step needs: the entry's own count where it has one,
    else ``emulation_ops`` over the entry's ``collections``.  The weights
    and the barycentre (a few elementwise passes over the marginals) are
    left out."""
    if counts_its_own(config):
        return entry_of(config).step_ops(config, profile)
    return sum(emulation_ops(b, t, d, profile) for b, t, d in collections(config))


def kernel_step_seconds(kernel, config, profile):
    """The least time of one step's launches of ``kernel`` at the cell's
    shapes, each launch bounded alone: B2 takes every evaluation's forward
    pass and the posterior's, B3 every gradient's and the posterior's.  None
    for a coarse-to-fine fit, whose launches this count does not cover, and
    for an entry that counts its own operations, whose step is not the
    exact GP's."""
    if profile.get("time_stride", 1) > 1 or counts_its_own(config):
        return None
    vg, v = optimiser_evaluations(profile)
    n = profile["n_optim_nits"]
    launches, work = {"chol_solve": (n * (vg + v) + 1, chol_solve_work),
                      "tri_inv": (n * vg + 1, tri_inv_work)}[kernel]
    dtype = config["dtype"]
    return sum(launches * least_seconds(*work(b, t, ELEMENT_BYTES[dtype]), dtype)
               for b, t, _ in collections(config))


# The sparse variational GP of ``GPDTW3D(mode="svgp")`` (the port's
# ``ops/svgp.py``; the reference's ``ensembles/models.py`` GPDTW3D, GPflow's
# SVGP), for the configuration that PERF.md queues: the 5-degree grid in
# float64, one SVGP a model of p inducing points on minibatches of n of its
# N points, whose features (unit-sphere x, y, z, time, one column a
# realisation) fall into groups of widths ``widths``.  No entry calls these
# yet.  Each term is that of b SVGPs; terms of the hyperparameters alone
# (a few scalars a group) are left out.

def svgp_widths(d):
    """The widths of the feature groups of d features: xy, z, time, then
    the realisations (``ops/svgp.default_feature_groups``)."""
    return (2, 1, 1) + ((d - 4,) if d > 4 else ())


def additive_matern32_ops(p, m, widths):
    """The additive Matern-3/2 covariance of p points with m points, a
    group of width w at a time: the coordinates' product (2 p m w), the two
    sides' squared norms (2 (p + m) w), d^2 = |a|^2 + |b|^2 - 2 a.b and its
    clip at 0 (4 p m), the distance sqrt(d^2 + 1e-36) (2 p m), then r =
    distance / lengthscale, sqrt(3) r, exp(-sqrt(3) r), 1 + sqrt(3) r,
    their product and the product with the variance (6 p m), and the sum
    over the groups (p m)."""
    return sum(2 * p * m * w + 2 * (p + m) * w + 13 * p * m for w in widths)


def svgp_step_terms(b, p, n, widths):
    """The operations of one Adam step of b SVGPs on minibatches of n
    points, term by term: the forward pass to the negative ELBO, each
    term's reverse mode written out, and the update.  The inducing points z
    are a parameter, the minibatch's features x are data."""
    g, tri = len(widths), p * (p + 1)  # tri: a product with a p x p triangle, a row
    leaves = 2 * g + p * sum(widths) + p + p * (p + 1) // 2  # ls, var, z, m, L_S's triangle
    terms = {
        # Kzz, with the jitter on its diagonal (p).
        "kzz": additive_matern32_ops(p, p, widths) + p,
        # Its Cholesky factor L.
        "cholesky": p ** 3 / 3,
        # Kzx on the minibatch.
        "kzx": additive_matern32_ops(p, n, widths),
        # A = L^-1 Kzx: a triangular solve, p^2 a column.
        "solve": p * p * n,
        # The mean A^T m.
        "mean": 2 * p * n,
        # A^T L_S, L_S lower triangular: p (p + 1) / 2 multiply-adds a row.
        "a_ls": tri * n,
        # The two column norms |A_i|^2 and |(A^T L_S)_i|^2.
        "column_norms": 4 * p * n,
        # The variance: the amplitude less the first norm plus the second, clipped.
        "variance": 3 * n,
        # Softplus (|x|, exp(-|x|), log1p, max(x, 0), their sum) of the 2 g
        # hyperparameters and of L_S's diagonal.
        "transforms": 5 * (2 * g + p),
        # The expected log-likelihood: log of the noise, the residual, its
        # square, plus the variance, over the noise, the two constants'
        # sums, times -1/2, and the sum over the minibatch.
        "expected_loglik": 9 * n,
        # The KL in whitened form: |m|^2 (2 p), |L_S|^2 over its triangle
        # (p (p + 1)), the log of its diagonal and their sum (2 p).
        "kl": tri + 4 * p,
        # Reverse mode. The mean's adjoint, the residual times the scale
        # over the noise (2 n), and the variance's, half that scale over
        # the noise (n).
        "expected_loglik_grad": 3 * n,
        # The clip's mask (n) and the amplitude's adjoint, a sum (n).
        "variance_grad": 2 * n,
        # Each norm's adjoint 2 A_i v_i: a product and its sum into A's
        # adjoint (2 p n each).
        "column_norms_grad": 4 * p * n,
        # A's adjoint from the mean, an outer product (2 p n), and m's,
        # A times the mean's adjoint (2 p n).
        "mean_grad": 4 * p * n,
        # A's adjoint from A^T L_S (a product with L_S^T), and L_S's, the
        # lower triangle of A (A^T L_S)'s adjoint: two triangles.
        "a_ls_grad": 2 * tri * n,
        # Kzx's adjoint L^-T A's adjoint (p^2 n), and L's, the lower
        # triangle of that times A^T (p (p + 1) n).
        "solve_grad": p * p * n + tri * n,
        # Each entry of a group (12 p n): the variance's adjoint (a product
        # with the saved Matern factor and its sum), r's (r exp(-sqrt(3) r)
        # times -3 variance times the adjoint), the lengthscale's (r times
        # that, summed), d^2's (over the distance and 2 l), the clip's mask,
        # the product's (-2 times that) and the row sums for z's norm; then
        # z's adjoint, the product's adjoint times x (2 p n w), and its
        # norm's, 2 z times the row sums (2 p w + p).
        "kzx_grad": sum(12 * p * n + 2 * p * n * w + 2 * p * w + p for w in widths),
        # The Cholesky's reverse mode: the lower triangle of L^T L's adjoint
        # (p^3 / 3), two triangular solves with p columns each (2 p^3), and
        # the symmetric part (p^2).
        "cholesky_grad": 7 * p ** 3 / 3 + p * p,
        # As Kzx's with z on both sides (14 p^2 a group): the column sums
        # too and the product's adjoint plus its transpose, times z
        # (2 p^2 w), and the norms' 2 z times both sums (2 p w + 2 p); the
        # jitter's adjoint into the amplitude (p).
        "kzz_grad": sum(14 * p * p + 2 * p * p * w + 2 * p * w + 2 * p for w in widths) + p,
        # The KL's adjoints: m (p), L_S's triangle (p (p + 1) / 2) and minus
        # one over its diagonal (2 p).
        "kl_grad": p + p * (p + 1) // 2 + 2 * p,
        # Softplus' derivative exp(x - softplus(x)) times the adjoint.
        "transforms_grad": 3 * (2 * g + p),
        # Adam over the five leaves: the two moments (3 + 4), the bias-
        # corrected step (5) and the update (2), each element.
        "adam": 14 * leaves,
    }
    return {name: b * ops for name, ops in terms.items()}


def svgp_step_ops(b, p, n, widths):
    """Operations of one Adam step of b SVGPs (``svgp_step_terms``)."""
    return sum(svgp_step_terms(b, p, n, widths).values())


def svgp_predict_ops(b, p, n_points, widths):
    """The posterior marginals of b SVGPs at n_points points each: the
    forward terms of ``svgp_step_terms`` with n_points for n, short of the
    likelihood and the KL, and the DBA variance added back (n_points)."""
    g, tri, m = len(widths), p * (p + 1), n_points
    return b * (additive_matern32_ops(p, p, widths) + p + p ** 3 / 3
                + additive_matern32_ops(p, m, widths) + p * p * m + 2 * p * m + tri * m
                + 4 * p * m + 3 * m + 5 * (2 * g + p) + m)


def medoid_dba_ops(b, r, t, iterations):
    """DBA of b problems of r series of t steps from the medoid: the
    squared-DTW cost of each of the b r (r - 1) / 2 pairs (B7; the table's
    cell as ``dba_update_work``'s, 5 t^2), each cost added to both of its
    series' sums (b r (r - 1)) and the least sum picked (b r), then
    ``iterations`` classic updates over the b r pairs, counted as
    ``emulation_ops`` counts them."""
    pairs = b * r * (r - 1) // 2
    return (pairs * 5 * t * t + 2 * pairs + b * r
            + iterations * dba_update_work(b * r, t)[1])
