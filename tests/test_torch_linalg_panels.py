"""The panel schedules of the port's Cholesky, Cholesky-solve and
triangular-inverse kernels, modelled in plain PyTorch and held against the
JAX package and the port's plain versions in float64.

The CUDA kernels (``csrc/chol_factorise.cuh``, ``csrc/chol_solve.cu``,
``csrc/tri_inv.cu``) run only on a card.  Their index algebra does not need
one: the models below walk the same panels, blocks and k-ranges as the
kernels do (32-column panels, a ragged last panel treated as the identity,
32 x 32 blocks of the trailing update and of the doubling levels handed out
to 16 warps), with every block product done by ``torch.matmul``.  The JAX
functions run as they do off the TPU (their XLA branch).

Tolerance: 1e-10 of the largest entry in float64.  The schedules sum in
another order than LAPACK's column sweep (panel by panel; the inverse as
products of inverted blocks), on Grams whose condition number is below 1e4.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from bayesian_ensembling_tpu.ops import linalg_pallas as jlp
from bayesian_ensembling_tpu_torch import _build
from bayesian_ensembling_tpu_torch.ops import linalg_cuda as tlc

torch.set_num_threads(1)

RTOL = 1e-10
PANEL = 32  # csrc/warp_tile.cuh: kPanel
WARPS = 16  # csrc/tri_inv.cu: kThreads / 32
SIZES = [1, 2, 31, 32, 33, 64, 86, 128, 165]
NAN = float("nan")


def make_spd(rng, b, t):
    """Matern-3/2 Grams on sorted 1-D inputs plus noise, as the GP fit sees."""
    x = np.sort(rng.normal(size=(b, t)), axis=1)
    d = np.abs(x[:, :, None] - x[:, None, :]) / 1.3
    k = (1.0 + np.sqrt(3.0) * d) * np.exp(-np.sqrt(3.0) * d)
    return k + rng.uniform(0.05, 0.2, size=(b, t))[:, :, None] * np.eye(t)


def close(got, want, rtol=RTOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * max(1.0, float(np.abs(want).max())))


# ------------------------------------------------- the Cholesky's schedule
def chol_diag_block(d):
    """One warp's work: the factor of ``d`` ``(B, nb, nb)`` with lane i
    holding row i, padded to 32 x 32 with the identity.  Step k updates the
    columns to its right with the unscaled column, u_i u_j / pivot, and
    scales column k by 1 / sqrt(pivot) afterwards.  Returns the factor and
    the 32 reciprocals 1 / L_kk."""
    b, nb, _ = d.shape
    row = torch.eye(PANEL, dtype=d.dtype).repeat(b, 1, 1)
    row[:, :nb, :nb] = torch.tril(d)
    inv_diag = torch.ones((b, PANEL), dtype=d.dtype)
    for k in range(PANEL):
        u = row[:, :, k].clone()
        u[:, :k] = 0.0  # the kernel's lanes above the diagonal hold entries that are never stored
        pivot = u[:, k]
        bad = torch.full_like(pivot, NAN)
        scaled = u * torch.where(pivot > 0, 1.0 / pivot, bad)[:, None]
        row[:, :, k + 1:] -= scaled[:, :, None] * u[:, None, k + 1:]
        inv = torch.where(pivot > 0, pivot.clamp(min=0).rsqrt(), bad)
        row[:, :, k] = u * inv[:, None]
        inv_diag[:, k] = inv
    return torch.tril(row)[:, :nb, :nb], inv_diag


def trailing_units(nblk):
    """(ib, jb), jb <= ib, in the order the kernel decodes them from u."""
    for u in range(nblk * (nblk + 1) // 2):
        ib = 0
        while (ib + 1) * (ib + 2) // 2 <= u:
            ib += 1
        yield ib, u - ib * (ib + 1) // 2


def warp_tri_solve(rhs, inv, coef, backward):
    """``warp_tri_solve`` of csrc/chol_solve.cu: lane c's unknown is
    ``rhs[c] * inv[c]`` once the steps before it have run, then every lane
    subtracts ``coef[lane][c]`` times it; 32 steps, down or up the lanes.
    ``coef`` is zero where the unknown does not enter a lane's row."""
    x = torch.zeros_like(rhs)
    rhs = rhs.clone()
    for c in (range(PANEL - 1, -1, -1) if backward else range(PANEL)):
        x[:, c] = rhs[:, c] * inv[:, c]
        rhs -= coef[:, :, c] * x[:, c, None]
    return x


def block_rows(l11, nb, keep):
    """Lane i's row of the 32 x 32 diagonal block, entries that ``keep(i, c)``
    refuses set to zero (rows past a ragged block's width are zero too)."""
    rows = torch.zeros((l11.shape[0], PANEL, PANEL), dtype=l11.dtype)
    rows[:, :nb, :nb] = l11
    i, c = torch.meshgrid(torch.arange(PANEL), torch.arange(PANEL), indexing="ij")
    return torch.where(keep(i, c) & (i < nb) & (c < nb), rows, torch.zeros_like(rows))


def backward_panels(l, z):
    """The backward substitution of csrc/chol_solve.cu, alpha = L^-T z in
    place: panels from the last up; warp 0 solves L11^T alpha_p = r_p (lane
    i holding column i of L11); then r[0:k0] -= L[k0:k0+32, 0:k0]^T alpha_p
    in four quarters of eight rows, summed as the shuffles do,
    (q0 + q1) + (q2 + q3)."""
    b, t = z.shape
    r = z.clone()
    for k0 in range((t - 1) // PANEL * PANEL, -1, -PANEL):
        nb = min(PANEL, t - k0)
        l11 = l[:, k0:k0 + nb, k0:k0 + nb]
        ucol = block_rows(l11.mT, nb, lambda i, c: c > i)  # lane i: L[c][i], c > i
        rhs = torch.zeros((b, PANEL), dtype=z.dtype)
        rhs[:, :nb] = r[:, k0:k0 + nb]
        inv = torch.ones((b, PANEL), dtype=z.dtype)
        inv[:, :nb] = 1.0 / torch.diagonal(l11, dim1=-2, dim2=-1)
        x = warp_tri_solve(rhs, inv, ucol, backward=True)
        r[:, k0:k0 + nb] = x[:, :nb]
        if k0 == 0:
            break
        part = [torch.einsum("brj,br->bj", l[:, k0 + lo:k0 + min(lo + 8, nb), :k0], x[:, lo:min(lo + 8, nb)])
                for lo in range(0, PANEL, 8)]
        r[:, :k0] -= (part[0] + part[1]) + (part[2] + part[3])
    return r


def panel_chol(k, y=None):
    """``chol_factorise`` panel by panel; with ``y`` also the hooks and the
    backward substitution of the fused Cholesky-solve.  The entries above
    the diagonal start as NaN: the schedule must never read them."""
    b, t, _ = k.shape
    lower = torch.tril(torch.ones((t, t), dtype=torch.bool))
    a = torch.where(lower, k, torch.full_like(k, NAN))
    if y is not None:  # res: y less what the solved columns explain
        res, z, logdet = y.clone(), torch.zeros_like(y), torch.zeros(b, dtype=k.dtype)
    for k0 in range(0, t, PANEL):
        nb, below = min(PANEL, t - k0), k0 + PANEL
        if y is not None and k0 > 0:  # on_diag, beside warp 0: the previous panel's rows below
            kp = k0 - PANEL
            res[:, k0:] -= torch.einsum("bim,bm->bi", a[:, k0:, kp:k0], z[:, kp:k0])
        l11, inv_diag = chol_diag_block(a[:, k0:k0 + nb, k0:k0 + nb])
        a[:, k0:k0 + nb, k0:k0 + nb] = torch.where(lower[:nb, :nb], l11, a[:, k0:k0 + nb, k0:k0 + nb])
        if below < t:  # two threads per row: x L11^T = row, the row in registers
            v = a[:, below:, k0:below].clone()
            for m in range(PANEL):
                x = v[:, :, m] * inv_diag[:, None, m]
                v[:, :, m] = x
                v[:, :, m + 1:] -= x[:, :, None] * l11[:, None, m + 1:, m]
            a[:, below:, k0:below] = v
        if y is not None:  # on_panel, in the last warp: z_p, lane i holding row i of L11
            r = torch.zeros((b, PANEL), dtype=k.dtype)
            r[:, :nb] = res[:, k0:k0 + nb]
            lrow = block_rows(l11, nb, lambda i, c: c < i)
            z[:, k0:k0 + nb] = warp_tri_solve(r, inv_diag, lrow, backward=False)[:, :nb]
            logdet -= 2.0 * torch.log(inv_diag[:, :nb]).sum(-1)
        nblk = (t - below + PANEL - 1) // PANEL if t > below else 0
        for ib, jb in trailing_units(nblk):
            i0, j0 = below + ib * PANEL, below + jb * PANEL
            rows, cols = min(PANEL, t - i0), min(PANEL, t - j0)
            prod = a[:, i0:i0 + rows, k0:below] @ a[:, j0:j0 + cols, k0:below].mT
            keep = lower[i0:i0 + rows, j0:j0 + cols]
            a[:, i0:i0 + rows, j0:j0 + cols] -= torch.where(keep, prod, torch.zeros_like(prod))
    l = torch.tril(a)
    if y is None:
        return l
    return l, z, backward_panels(l, z), logdet


# ----------------------------------------- the triangular inverse's schedule
def invert_diag_block(d):
    """One warp's work: lane c solves x_c D = e_c for row c of the inverse of
    ``d`` ``(B, nb, nb)``, padded to 32 x 32 with the identity, from the
    right: x_i = rhs_i / D_ii, then rhs_m -= x_i D_im for m < i, a row of D
    at a time."""
    b, nb, _ = d.shape
    full = torch.eye(PANEL, dtype=d.dtype).repeat(b, 1, 1)
    full[:, :nb, :nb] = d
    inv = 1.0 / torch.diagonal(full, dim1=-2, dim2=-1)
    rhs = torch.eye(PANEL, dtype=d.dtype).repeat(b, 1, 1)  # rhs[:, c, m]: entry m of lane c's row
    for i in range(PANEL - 1, -1, -1):
        x = rhs[:, :, i] * inv[:, i, None]
        rhs[:, :, i] = x
        rhs[:, :, :i] -= x[:, :, None] * full[:, None, i, :i]
    assert (rhs.triu(1) == 0).all()  # the kernel stores whole rows: zeros above the diagonal
    return rhs[:, :nb, :nb]


def level_unit(s, t, warp):
    """``my_unit`` of csrc/tri_inv.cu: the block (r0, r1, h, ib, jb) of the
    pair that ``warp`` serves at the level of ``s``-row blocks, or None."""
    cols = s // PANEL
    left, r0 = warp, 0
    while r0 + s < t:
        h = min(s, t - (r0 + s))
        n = -(-h // PANEL) * cols
        if left < n:
            return r0, r0 + s, h, left // cols, left % cols
        left -= n
        r0 += 2 * s
    return None


def doubling_tri_inv(l):
    """The kernel's schedule: diagonal 32-blocks, then W21 = -W22 (L21 W11)
    for pairs of 32, 64 and 128 rows, each 32 x 32 block one warp's, every
    product computed from the matrix as it stood before the level's stores."""
    b, t, _ = l.shape
    w = torch.tril(l).clone()
    for k0 in range(0, t, PANEL):
        nb = min(PANEL, t - k0)
        w[:, k0:k0 + nb, k0:k0 + nb] = invert_diag_block(w[:, k0:k0 + nb, k0:k0 + nb])
    s = PANEL
    while s < t:
        units = [u for u in (level_unit(s, t, warp) for warp in range(WARPS)) if u is not None]
        for second in (False, True):
            out = []
            for r0, r1, h, ib, jb in units:
                i0, j0 = r1 + ib * PANEL, r0 + jb * PANEL
                rows = min(PANEL, h - ib * PANEL)
                if not second:  # P = L21 W11, k from the block's own column
                    kbeg, kend = jb * PANEL, s
                    prod = w[:, i0:i0 + rows, r0 + kbeg:r0 + kend] @ w[:, r0 + kbeg:r0 + kend, j0:j0 + PANEL]
                else:  # W21 = -W22 P, k up to the block's own rows
                    kend = min(h, (ib + 1) * PANEL)
                    prod = -(w[:, i0:i0 + rows, r1:r1 + kend] @ w[:, r1:r1 + kend, j0:j0 + PANEL])
                out.append((i0, j0, rows, prod))
            for i0, j0, rows, prod in out:  # after the barrier
                w[:, i0:i0 + rows, j0:j0 + PANEL] = prod
        s *= 2
    return w


# ------------------------------------------------------------------ the tests
def inputs(t, b=3):
    rng = np.random.default_rng(1000 + t)
    return make_spd(rng, b, t), rng.normal(size=(b, t))


@pytest.mark.parametrize("t", SIZES)
def test_panel_cholesky_matches_jax_and_plain(t):
    k, _ = inputs(t)
    got = panel_chol(torch.from_numpy(k))
    want_jax = np.asarray(jlp.cholesky_batched(jnp.asarray(k.transpose(1, 2, 0)))).transpose(2, 1, 0)
    close(got.numpy(), want_jax)
    close(got.numpy(), tlc.chol_reference(torch.from_numpy(k)).numpy())
    assert (got.triu(1) == 0).all()


@pytest.mark.parametrize("t", SIZES)
def test_panel_cholesky_solve_matches_jax_and_plain(t):
    k, y = inputs(t)
    got = panel_chol(torch.from_numpy(k), torch.from_numpy(y))
    lt, z, alpha, logdet = jlp.cholesky_solve_fused(jnp.asarray(k.transpose(1, 2, 0)), jnp.asarray(y.T))
    want_jax = (np.asarray(lt).transpose(2, 1, 0), np.asarray(z).T, np.asarray(alpha).T, np.asarray(logdet))
    want_plain = tlc.chol_solve_reference(torch.from_numpy(k), torch.from_numpy(y))
    for g, wj, wp in zip(got, want_jax, want_plain):
        close(g.numpy(), wj)
        close(g.numpy(), wp.numpy())


@pytest.mark.parametrize("t", SIZES)
def test_doubling_tri_inv_matches_jax_and_plain(t):
    k, _ = inputs(t)
    l = np.linalg.cholesky(k)
    got = doubling_tri_inv(torch.from_numpy(l))
    want_jax = np.asarray(jlp.tri_inv_batched(jnp.asarray(l.transpose(2, 1, 0)))).transpose(2, 0, 1)
    close(got.numpy(), want_jax)
    close(got.numpy(), tlc.tri_inv_reference(torch.from_numpy(l)).numpy())
    assert (got.triu(1) == 0).all()
    eye = np.broadcast_to(np.eye(t), k.shape)
    close((got @ torch.from_numpy(l)).numpy(), eye)


@pytest.mark.parametrize("t,column", [(86, 5), (86, 40), (86, 85), (165, 0), (165, 100), (165, 164)])
def test_non_positive_pivot_gives_nan_in_that_matrix_only(t, column):
    """A non-positive pivot in the first, a middle and the (ragged) last
    panel: NaN from that column on, in that matrix only."""
    k, y = inputs(t)
    k[1, column, column] = -1.0
    l, z, alpha, logdet = panel_chol(torch.from_numpy(k), torch.from_numpy(y))
    rows, cols = np.tril_indices(t)
    bad = l[1].numpy()[rows, cols]
    assert np.isnan(bad[cols >= column]).all() and np.isfinite(bad[cols < column]).all()
    assert torch.isnan(z[1, column:]).all() and torch.isfinite(z[1, :column]).all()
    assert torch.isnan(alpha[1]).all() and torch.isnan(logdet[1])
    l_only = panel_chol(torch.from_numpy(k))
    assert torch.equal(torch.isnan(l_only), torch.isnan(l))
    want = tlc.chol_solve_reference(torch.from_numpy(k), torch.from_numpy(y))
    for g, w_ in zip((l, z, alpha, logdet), want):
        assert torch.isnan(w_[1]).all()  # the plain version: NaN everywhere in that matrix
        close(g[[0, 2]].numpy(), w_[[0, 2]].numpy())


@pytest.mark.parametrize("t", [33, 64, 65, 86, 128, 129, 165, 192, 193, 239, 241, 256])
def test_every_level_block_gets_a_warp_of_its_own(t):
    """At every doubling level the 32 x 32 blocks of every pair's W21 are
    handed out once each, and there are at most 16 of them up to T = 256."""
    s = PANEL
    while s < t:
        units = [level_unit(s, t, warp) for warp in range(WARPS)]
        active = [u for u in units if u is not None]
        want = {(r0, ib, jb)
                for r0 in range(0, t - s, 2 * s)
                for ib in range(-(-min(s, t - r0 - s) // PANEL))
                for jb in range(s // PANEL)}
        assert {(r0, ib, jb) for r0, _, _, ib, jb in active} == want
        assert len(active) == len(want) <= WARPS
        assert level_unit(s, t, WARPS) is None or t > 256
        s *= 2


@pytest.mark.parametrize("t,itemsize,ld", [(1, 4, 4), (86, 4, 88), (128, 4, 132), (165, 4, 168),
                                           (239, 4, 240), (1, 8, 2), (128, 8, 130), (165, 8, 166),
                                           (167, 8, 168), (168, 8, 168)])
def test_shared_memory_rows_start_on_16_bytes(t, itemsize, ld):
    """``_smem_ld`` mirrors ``smem_ld`` of csrc/warp_tile.cuh: the smallest
    multiple of 16 bytes that holds a row, one step more where that would be
    a multiple of 128 bytes."""
    assert tlc._smem_ld(t, itemsize) == ld
    assert ld >= t and ld * itemsize % 16 == 0 and ld * itemsize % 128 != 0


@pytest.mark.parametrize("dtype,cap,chol_cap,tri_inv_cap", [(torch.float32, 239, 240, 240),
                                                             (torch.float64, 168, 170, 170)])
def test_shared_memory_mirror_keeps_the_caps(dtype, cap, chol_cap, tri_inv_cap):
    """``_kernel_smem_bytes`` is the fused Cholesky-solve's request (the
    largest of the three: the matrix, two vectors, 96 values of scratch);
    the Cholesky drops the vectors and the triangular inverse the scratch as
    well.  The caps have not fallen (they were 239 and 167), and T = 165 in
    float64 stays inside."""
    e = dtype.itemsize
    assert tlc._kernel_smem_bytes(10, e) == e * (10 * tlc._smem_ld(10, e) + 2 * 10 + 96)
    assert tlc.KERNEL_T_CAP[dtype] == cap
    assert tlc._kernel_smem_bytes(165, 8) <= _build.SMEM_BYTES
    assert tlc._kernel_smem_bytes(cap, e) <= _build.SMEM_BYTES < tlc._kernel_smem_bytes(cap + 1, e)
    assert _build.largest_t(lambda t: e * (t * tlc._smem_ld(t, e) + 96)) == chol_cap
    assert _build.largest_t(lambda t: e * t * tlc._smem_ld(t, e)) == tri_inv_cap


# ------------------------- the Cholesky-solve's backward panels and spread hook
SOLVE_SIZES = [1, 31, 32, 33, 86, 165, 239]
CHOL_WARPS = 8  # csrc/chol_solve.cu: kThreads / 32


@pytest.mark.parametrize("t", SOLVE_SIZES)
def test_back_substitution_by_panels_matches_jax_and_plain(t):
    """alpha by 32-column panels from the last up (warp 0's shuffle chain,
    then the four row quarters' update), z with the rows under each panel
    updated beside the next diagonal block: against the JAX fused
    Cholesky-solve and the plain version, up to the float32 cap."""
    k, y = inputs(t, b=2)
    l, z, alpha, logdet = panel_chol(torch.from_numpy(k), torch.from_numpy(y))
    _, jz, jalpha, jlogdet = jlp.cholesky_solve_fused(jnp.asarray(k.transpose(1, 2, 0)), jnp.asarray(y.T))
    want = tlc.chol_solve_reference(torch.from_numpy(k), torch.from_numpy(y))
    for got, wj, wp in ((z, np.asarray(jz).T, want[1]), (alpha, np.asarray(jalpha).T, want[2]),
                        (logdet, np.asarray(jlogdet), want[3])):
        close(got.numpy(), wj)
        close(got.numpy(), wp.numpy())
    # The backward pass alone, on the plain factor: L^T alpha = z.
    close(backward_panels(want[0], want[1]).numpy(), want[2].numpy())


@pytest.mark.parametrize("t,column", [(33, 32), (165, 163), (239, 224), (239, 238), (239, 3)])
def test_back_substitution_by_panels_nan_rule(t, column):
    """A non-positive pivot in a ragged last panel (T = 33, 165, 239) or the
    first: z is NaN from that column on, alpha and logdet NaN, in that matrix
    only; the others agree with the plain version."""
    k, y = inputs(t)
    k[1, column, column] = -1.0
    l, z, alpha, logdet = panel_chol(torch.from_numpy(k), torch.from_numpy(y))
    assert torch.isnan(z[1, column:]).all() and torch.isfinite(z[1, :column]).all()
    assert torch.isnan(alpha[1]).all() and torch.isnan(logdet[1])
    want = tlc.chol_solve_reference(torch.from_numpy(k), torch.from_numpy(y))
    for g, w_ in zip((l, z, alpha, logdet), want):
        close(g[[0, 2]].numpy(), w_[[0, 2]].numpy())


@pytest.mark.parametrize("t", SOLVE_SIZES)
def test_spread_hook_and_backward_update_cover_their_work_once(t):
    """The index algebra of the two spread GEMVs: beside panel k0's diagonal
    block, warps 1..7 take the rows from k0 on 32 at a time, each row once;
    in the backward pass, warp w's lane octets take 16-byte column groups
    g0 + (lane % 8) for g0 = 8 w, 8 w + 64, ..., each group of the columns
    left of the panel once, in float32 (4 a group) and float64 (2)."""
    for k0 in range(PANEL, t, PANEL):
        rows = [i0 + lane for warp in range(1, CHOL_WARPS)
                for i0 in range(k0 + (warp - 1) * 32, t, (CHOL_WARPS - 1) * 32)
                for lane in range(32) if i0 + lane < t]
        assert sorted(rows) == list(range(k0, t))
        for vec in (4, 2):
            groups = [g0 + lane % 8 for warp in range(CHOL_WARPS)
                      for g0 in range(warp * 8, k0 // vec, CHOL_WARPS * 8)
                      for lane in range(8)]
            assert sorted(groups) == list(range(k0 // vec)) and k0 // vec % 8 == 0


# ------------------------------------------------- the vector solve (B5)
# csrc/solve_vec.cu: the resident layout (the packed lower triangle in
# shared memory, one solver warp sweeping the columns with each panel's rows
# scaled by the reciprocal of their diagonal, late panels catching up) and
# the streamed layout (32-row panels in chunks of W columns through a ring,
# forward top-down, backward bottom-up, a solver warp on each diagonal
# block).  In both models an entry the kernel never copies is NaN, so a
# schedule that read one would fail.
SOLVE_VEC_SIZES = [1, 31, 32, 33, 86, 165]
SOLVE_VEC_STAGES = 6  # csrc/solve_vec.cu: kStages


def packed_triangle(l):
    """Rows of the lower triangle one after the other: row i at i (i+1)/2."""
    t = l.shape[-1]
    i, c = torch.tril_indices(t, t)
    return l[:, i, c]


def resident_solve_vec(l, y, forward_only=False, reads=None):
    """The resident layout.  Forward, per panel: the solver warp's shuffle
    chain on the panel's rows scaled by 1 / L_ii (the right-hand sides
    minus the sums so far), then every row below the panel adds its 32
    terms; backward, per panel from the last: the chain on the panel's
    columns, then every column left of it subtracts its 32 terms.
    ``reads`` (a list of two int tensors) counts each pass's reads of every
    packed entry.  Returns (z, alpha or None, logdet)."""
    b, t = y.shape
    np_ = -(-t // PANEL)
    tri = packed_triangle(l)
    row = lambda i: i * (i + 1) // 2  # noqa: E731
    reads = reads if reads is not None else [torch.zeros(tri.shape[1], dtype=torch.int64) for _ in range(2)]

    def get(idx, pass_):
        reads[pass_][torch.tensor(idx, dtype=torch.int64)] += 1
        return tri[:, idx]

    diag = get([row(i) + i for i in range(t)], 0)
    rinv = 1.0 / diag
    logdet = 2.0 * torch.log(diag).sum(-1)
    v = y.clone()
    dot = torch.zeros_like(y)
    for p in range(np_):
        j0 = PANEL * p
        n = min(PANEL, t - j0)
        cur = (v[:, j0:j0 + n] - dot[:, j0:j0 + n]) * rinv[:, j0:j0 + n]
        for cc in range(n):
            below = list(range(cc + 1, n))
            if below:
                lv = get([row(j0 + r) + j0 + cc for r in below], 0) * rinv[:, [j0 + r for r in below]]
                cur[:, below] -= lv * cur[:, cc, None]
        v[:, j0:j0 + n] = cur
        rest = list(range(j0 + PANEL, t))
        if rest:  # the rows below, a thread a row
            idx = torch.tensor([[row(i) + j0 + cc for cc in range(n)] for i in rest])
            get(idx.reshape(-1).tolist(), 0)
            dot[:, rest] += torch.einsum("bic,bc->bi", tri[:, idx], cur)
    z = v.clone()
    if forward_only:
        return z, None, logdet
    for p in range(np_ - 1, -1, -1):
        j0 = PANEL * p
        n = min(PANEL, t - j0)
        cur = v[:, j0:j0 + n] * rinv[:, j0:j0 + n]
        for cc in range(n - 1, -1, -1):
            if cc:
                lv = get([row(j0 + cc) + j0 + r for r in range(cc)], 1) * rinv[:, j0:j0 + cc]
                cur[:, :cc] -= lv * cur[:, cc, None]
        v[:, j0:j0 + n] = cur
        if j0:  # the columns left, a thread a column
            idx = torch.tensor([[row(j0 + r) + c for r in range(n)] for c in range(j0)])
            get(idx.reshape(-1).tolist(), 1)
            v[:, :j0] -= torch.einsum("bcr,br->bc", tri[:, idx], cur)
    return z, v, logdet


def chunk_order(t, w, backward_too=True):
    """``for_each_chunk`` of csrc/solve_vec.cu: (panel, chunk, diagonal,
    backward) in the one order producer, consumers and solver follow."""
    np_ = -(-t // PANEL)
    out = [(p, q, q == PANEL * p // w, False) for p in range(np_) for q in range(PANEL * p // w + 1)]
    if backward_too:
        out += [(p, q, q == PANEL * p // w, True) for p in range(np_ - 1, -1, -1)
                for q in range(PANEL * p // w, -1, -1)]
    return out


def stage_of(l, p, q, w):
    """The chunk as the producers copy it: rows j0 .. j0+31 below T, columns
    [q w, q w + w) on or below the diagonal; every other entry NaN."""
    b, t, _ = l.shape
    j0 = PANEL * p
    st = torch.full((b, PANEL, w), NAN, dtype=l.dtype)
    for r in range(min(PANEL, t - j0)):
        hi = min(w, j0 + r + 1 - q * w)
        if hi > 0:
            st[:, r, :hi] = l[:, j0 + r, q * w:q * w + hi]
    return st


def streamed_solve_vec(l, y, w, forward_only=False):
    """The streamed layout: consumers take the columns of a chunk below its
    panel's diagonal block (forward: 32 running dot products a column,
    summed at the panel's end; backward: v_c -= sum_r L[j0+r, c] alpha_r),
    the solver the diagonal block, scaled by the reciprocals.  One vector v
    holds z, then z minus the backward sums, then alpha."""
    b, t = y.shape
    v = torch.full((b, t), NAN, dtype=y.dtype)
    acc = torch.zeros((b, PANEL, w), dtype=y.dtype)
    logdet = torch.zeros(b, dtype=y.dtype)
    z = None
    for p, q, diag, backward in chunk_order(t, w, not forward_only):
        j0 = PANEL * p
        n = min(PANEL, t - j0)
        st = stage_of(l, p, q, w)
        cols = [c for c in range(q * w, q * w + w) if c < j0]  # the consumers' columns
        off = [c - q * w for c in cols]
        if not backward:
            if cols:
                acc[:, :, off] += st[:, :, off] * v[:, None, cols]
            if not diag:
                continue
            rhs = y[:, j0:j0 + n] - acc.sum(-1)[:, :n]  # the consumers' sums; rows past T unused
            acc.zero_()
            block = st[:, :n, j0 - q * w:j0 - q * w + n]
            d = torch.diagonal(block, dim1=-2, dim2=-1)
            rinv = 1.0 / d
            logdet += torch.log(d).sum(-1)
            cur = rhs * rinv
            for cc in range(n):
                cur[:, cc + 1:] -= block[:, cc + 1:, cc] * rinv[:, cc + 1:] * cur[:, cc, None]
            v[:, j0:j0 + n] = cur
            if p == -(-t // PANEL) - 1:
                z = v.clone()
            continue
        if diag:
            block = st[:, :n, j0 - q * w:j0 - q * w + n]
            rinv = 1.0 / torch.diagonal(block, dim1=-2, dim2=-1)
            cur = v[:, j0:j0 + n] * rinv
            for cc in range(n - 1, -1, -1):
                cur[:, :cc] -= block[:, cc, :cc] * rinv[:, :cc] * cur[:, cc, None]
            v[:, j0:j0 + n] = cur
        if cols:
            alpha = v[:, j0:j0 + n]
            v[:, cols] -= torch.einsum("brc,br->bc", st[:, :n][:, :, off], alpha)
    return z, None if forward_only else v, 2.0 * logdet


def model_solve_vec(l, y, forward_only=False):
    """The launcher's choice of layout, as ``linalg_cuda`` makes it."""
    if tlc._solve_vec_layout(y.shape[1], y.dtype) == "resident":
        return resident_solve_vec(l, y, forward_only)
    return streamed_solve_vec(l, y, tlc._solve_vec_chunk_width(y.element_size()), forward_only)


def factors_and_rhs(t, b=3, seed=0):
    rng = np.random.default_rng(2000 + t + seed)
    return (torch.from_numpy(np.linalg.cholesky(make_spd(rng, b, t))),
            torch.from_numpy(rng.normal(size=(b, t))))


@pytest.fixture
def pallas_interpret(monkeypatch):
    monkeypatch.setattr(jlp, "INTERPRET", True)


def jax_solve_vec(l, y):
    """The JAX package's Pallas vector solve, (B, T) outputs."""
    z, alpha, logdet = jlp._solve_vec_batched_tpu(jnp.asarray(l.numpy().transpose(2, 1, 0)),
                                                  jnp.asarray(y.numpy().T))
    return np.asarray(z).T, np.asarray(alpha).T, np.asarray(logdet)


@pytest.mark.parametrize("t", SOLVE_VEC_SIZES)
def test_resident_solve_vec_matches_jax_and_plain(pallas_interpret, t):
    l, y = factors_and_rhs(t)
    got = resident_solve_vec(l, y)
    for g, wj, wp in zip(got, jax_solve_vec(l, y), tlc.solve_vec_reference(l, y)):
        close(g.numpy(), wj)
        close(g.numpy(), wp.numpy())


@pytest.mark.parametrize("t", [1, 31, 33, 86, 165])
def test_resident_reads_every_packed_entry_once_a_pass(t):
    """The packed offsets i (i+1) / 2 + c of the chains and the updates:
    the forward pass reads every entry of the lower triangle once (the
    diagonal for the reciprocals), the backward pass every entry below the
    diagonal once (the reciprocals are reused)."""
    l, y = factors_and_rhs(t, b=1)
    reads = [torch.zeros(t * (t + 1) // 2, dtype=torch.int64) for _ in range(2)]
    resident_solve_vec(l, y, reads=reads)
    i, c = torch.tril_indices(t, t)
    assert bool((reads[0] == 1).all())
    assert bool((reads[1] == (i != c).long()).all())


@pytest.mark.parametrize("w", [32, 64, 128])
@pytest.mark.parametrize("t", SOLVE_VEC_SIZES + [300])
def test_streamed_solve_vec_matches_jax_and_plain(pallas_interpret, t, w):
    """Chunks of 128 (float32) and 64 (float64) columns, and of 32 so that
    small T has panels of several chunks."""
    l, y = factors_and_rhs(t)
    got = streamed_solve_vec(l, y, w)
    want_jax = jax_solve_vec(l, y) if w == 64 else None
    for i, (g, wp) in enumerate(zip(got, tlc.solve_vec_reference(l, y))):
        close(g.numpy(), wp.numpy())
        if want_jax is not None:
            close(g.numpy(), want_jax[i])


@pytest.mark.parametrize("w", [32, 64, 128])
@pytest.mark.parametrize("t", [1, 33, 165, 300, 1032])
def test_streamed_chunk_order_serves_each_pass(t, w):
    """Each chunk once a pass; forward panels top-down, each ending on its
    diagonal block; backward panels bottom-up, each starting on it; every
    chunk a forward consumer reads needs only unknowns of earlier panels,
    and the chunk that completes the next backward panel's right-hand side
    (the one holding column j0 - 1) comes before that panel's diagonal."""
    order = chunk_order(t, w)
    np_ = -(-t // PANEL)
    fwd, bwd = order[:len(order) // 2], order[len(order) // 2:]
    assert [(p, q) for p, q, _, _ in fwd] == sorted((p, q) for p, q, _, _ in bwd)
    assert [p for p, _, d, _ in fwd if d] == list(range(np_))
    assert [p for p, _, d, _ in bwd if d] == list(range(np_ - 1, -1, -1))
    for p, q, diag, _ in fwd:
        assert diag == (q == PANEL * p // w) and q * w < PANEL * p + PANEL
    for p in range(1, np_):
        hand = bwd.index((p, (PANEL * p - 1) // w, (PANEL * p - 1) // w == PANEL * p // w, True))
        assert hand < bwd.index((p - 1, PANEL * (p - 1) // w, True, True))
    assert len(order) == 2 * sum(PANEL * p // w + 1 for p in range(np_))


@pytest.mark.parametrize("t", [39, 40, 41])
def test_layout_switch_at_the_resident_cap(pallas_interpret, monkeypatch, t):
    """At the resident cap and one past it (the cap cut to 40 by
    monkeypatch): the model takes the launcher's layout, and both equal the
    JAX kernel and the plain version."""
    monkeypatch.setattr(tlc, "SOLVE_VEC_RESIDENT_T_CAP", {torch.float64: 40})
    assert tlc._solve_vec_layout(t, torch.float64) == ("resident" if t <= 40 else "streamed")
    l, y = factors_and_rhs(t)
    got = model_solve_vec(l, y)
    for g, wj, wp in zip(got, jax_solve_vec(l, y), tlc.solve_vec_reference(l, y)):
        close(g.numpy(), wj)
        close(g.numpy(), wp.numpy())


@pytest.mark.parametrize("t", [tlc.SOLVE_VEC_RESIDENT_T_CAP[torch.float64],
                               tlc.SOLVE_VEC_RESIDENT_T_CAP[torch.float64] + 1])
def test_layouts_at_the_float64_resident_cap(t):
    """The real switch point in float64 (237 / 238), against the plain version."""
    l, y = factors_and_rhs(t, b=2)
    for g, wp in zip(model_solve_vec(l, y), tlc.solve_vec_reference(l, y)):
        close(g.numpy(), wp.numpy())


@pytest.mark.parametrize("layout", ["resident", "streamed"])
def test_solve_vec_models_forward_only_is_the_full_forward(layout):
    """Forward-only runs the same forward pass: z and logdet bit for bit."""
    l, y = factors_and_rhs(165)
    run = (lambda fo: resident_solve_vec(l, y, fo)) if layout == "resident" else (
        lambda fo: streamed_solve_vec(l, y, 64, fo))
    full, fwd = run(False), run(True)
    assert fwd[1] is None
    assert torch.equal(fwd[0], full[0]) and torch.equal(fwd[2], full[2])


@pytest.mark.parametrize("layout", ["resident", "streamed"])
def test_solve_vec_models_bad_diagonal_rule(layout):
    """A zero diagonal entry: z and alpha non-finite from that row on,
    logdet -inf; a negative one: logdet NaN, z finite; a NaN one: z NaN from
    that row on; the other matrices equal the plain version."""
    l, y = factors_and_rhs(70, b=5)
    l[1, 40, 40] = 0.0
    l[2, 69, 69] = -1.0
    l[3, 5, 5] = NAN
    z, alpha, logdet = (resident_solve_vec(l, y) if layout == "resident"
                        else streamed_solve_vec(l, y, 32))
    z_ref, alpha_ref, ld_ref = tlc.solve_vec_reference(l, y)
    assert logdet[1] == -np.inf and ld_ref[1] == -np.inf
    assert torch.isfinite(z[1, :40]).all() and not torch.isfinite(z[1, 40:]).any()
    assert not torch.isfinite(alpha[1]).all()
    assert torch.isnan(logdet[2]) and torch.isnan(ld_ref[2]) and torch.isfinite(z[2]).all()
    assert torch.isnan(z[3, 5:]).all() and torch.isfinite(z[3, :5]).all() and torch.isnan(logdet[3])
    for g, w_ in zip((z, alpha, logdet), (z_ref, alpha_ref, ld_ref)):
        close(g[[0, 2, 4]].numpy() if g.dim() > 1 else g[[0, 4]].numpy(),
              w_[[0, 2, 4]].numpy() if w_.dim() > 1 else w_[[0, 4]].numpy())


@pytest.mark.parametrize("dtype,cap,width", [(torch.float32, 337, 128), (torch.float64, 237, 64)])
def test_solve_vec_shared_memory_mirror_keeps_the_caps(dtype, cap, width):
    """``_solve_vec_resident_smem_bytes`` is the resident launcher's request
    (128 bytes of mbarriers, three vectors on 16 bytes, the packed triangle)
    and ``_solve_vec_streamed_smem_bytes`` the streamed one's (six dense
    stages of 32 rows of W values, 256 bytes of mbarriers and counters, two
    panels' dot products, one vector); the resident cap covers the
    library's T = 165 in both dtypes and fits the built loads a row (11 in
    float32, 8 in float64); the streamed cap has not fallen below
    28,496 / 13,968."""
    e = dtype.itemsize
    assert tlc._solve_vec_resident_smem_bytes(165, e) == 128 + 3 * -(-165 * e // 16) * 16 + e * 165 * 83
    assert tlc._solve_vec_chunk_width(e) == width
    assert tlc._solve_vec_streamed_smem_bytes(1980, e) == SOLVE_VEC_STAGES * 16384 + 256 + 2 * width * e + 1980 * e
    assert tlc.SOLVE_VEC_RESIDENT_T_CAP[dtype] == cap
    for fn, c in ((tlc._solve_vec_resident_smem_bytes, cap),
                  (tlc._solve_vec_streamed_smem_bytes, tlc.SOLVE_VEC_T_CAP[dtype])):
        assert fn(c, e) <= _build.SMEM_BYTES < fn(c + 1, e)
    assert -(-cap // PANEL) <= (11 if e == 4 else 8)
    assert tlc.SOLVE_VEC_T_CAP[dtype] >= (28_496 if e == 4 else 13_968)
