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
