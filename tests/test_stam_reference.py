"""Each Stam stage against a plain float64 NumPy implementation of the
same formulas (Stam, "Real-Time Fluid Dynamics for Games"; the
stable-fluids step of tpufluids.grid.stam): boundary rules, Jacobi and
red-black solves, divergence and gradient subtraction, forcings, both
advection formulations, the spectral and multigrid solves, and whole
steps for each projection."""

import numpy as np
import jax.numpy as jnp
import pytest
import scipy.fft

from tpufluids.grid import stam

# ---------------------------------------------------------------------------
# NumPy reference


def np_set_bnd3d(b, x):
    x = x.copy()
    sx, sy, sz = (-1.0 if b == k else 1.0 for k in (1, 2, 3))
    x[0], x[-1] = sx * x[1], sx * x[-2]
    x[:, 0], x[:, -1] = sy * x[:, 1], sy * x[:, -2]
    x[:, :, 0], x[:, :, -1] = sz * x[:, :, 1], sz * x[:, :, -2]
    return x


def np_set_bnd2d(b, x):
    x = x.copy()
    sx = -1.0 if b == 1 else 1.0
    sy = -1.0 if b == 2 else 1.0
    x[0, 1:-1], x[-1, 1:-1] = sx * x[1, 1:-1], sx * x[-2, 1:-1]
    x[:, 0], x[:, -1] = sy * x[:, 1], sy * x[:, -2]
    x[0, 0] = 0.5 * (x[1, 0] + x[0, 1])
    x[0, -1] = 0.5 * (x[1, -1] + x[0, -2])
    x[-1, 0] = 0.5 * (x[-2, 0] + x[-1, 1])
    x[-1, -1] = 0.5 * (x[-2, -1] + x[-1, -2])
    return x


def np_nb3d(x):
    return (x[:-2, 1:-1, 1:-1] + x[2:, 1:-1, 1:-1] + x[1:-1, :-2, 1:-1]
            + x[1:-1, 2:, 1:-1] + x[1:-1, 1:-1, :-2] + x[1:-1, 1:-1, 2:])


def np_lin_solve3d(b, x, x0, a, c, iters, red_black=False):
    x = x.copy()
    m = x.shape[0] - 2
    i, j, k = np.indices((m, m, m))
    even = (i + j + k) % 2 == 0
    for _ in range(iters):
        if not red_black:
            x[1:-1, 1:-1, 1:-1] = (x0[1:-1, 1:-1, 1:-1] + a * np_nb3d(x)) / c
            x = np_set_bnd3d(b, x)
            continue
        for mask in (even, ~even):
            new = (x0[1:-1, 1:-1, 1:-1] + a * np_nb3d(x)) / c
            x[1:-1, 1:-1, 1:-1] = np.where(mask, new, x[1:-1, 1:-1, 1:-1])
            x = np_set_bnd3d(b, x)
    return x


def np_lin_solve2d(b, x, x0, a, c, iters):
    x = x.copy()
    for _ in range(iters):
        nb = x[:-2, 1:-1] + x[2:, 1:-1] + x[1:-1, :-2] + x[1:-1, 2:]
        x[1:-1, 1:-1] = (x0[1:-1, 1:-1] + a * nb) / c
        x = np_set_bnd2d(b, x)
    return x


def np_div3d(u, v, w):
    n = u.shape[0] - 2
    return -0.5 / n * (u[2:, 1:-1, 1:-1] - u[:-2, 1:-1, 1:-1]
                       + v[1:-1, 2:, 1:-1] - v[1:-1, :-2, 1:-1]
                       + w[1:-1, 1:-1, 2:] - w[1:-1, 1:-1, :-2])


def np_gradsub3d(p, u, v, w):
    n = u.shape[0] - 2
    u, v, w = u.copy(), v.copy(), w.copy()
    u[1:-1, 1:-1, 1:-1] -= 0.5 * n * (p[2:, 1:-1, 1:-1] - p[:-2, 1:-1, 1:-1])
    v[1:-1, 1:-1, 1:-1] -= 0.5 * n * (p[1:-1, 2:, 1:-1] - p[1:-1, :-2, 1:-1])
    w[1:-1, 1:-1, 1:-1] -= 0.5 * n * (p[1:-1, 1:-1, 2:] - p[1:-1, 1:-1, :-2])
    return np_set_bnd3d(1, u), np_set_bnd3d(2, v), np_set_bnd3d(3, w)


def np_dct_interior(rhs):
    """Neumann solve of (2d) x - sum_nb x = rhs with the mean-free
    gauge, in float64 through scipy's orthonormal DCT-II."""
    lam = 0.0
    for ax, n in enumerate(rhs.shape):
        q = np.arange(n)
        lam1 = 2.0 - 2.0 * np.cos(np.pi * q / n)
        lam = lam + lam1.reshape((-1,) + (1,) * (rhs.ndim - 1 - ax))
    coef = scipy.fft.dctn(rhs, type=2, norm="ortho")
    coef = coef / np.where(lam == 0, 1.0, lam)
    coef[(0,) * rhs.ndim] = 0.0
    return scipy.fft.idctn(coef, type=2, norm="ortho")


def np_dct_solve3d(x0):
    p = np.zeros_like(x0)
    p[1:-1, 1:-1, 1:-1] = np_dct_interior(x0[1:-1, 1:-1, 1:-1])
    return np_set_bnd3d(0, p)


def np_mg_vcycle(p, x0, coarsest=8):
    n = p.shape[0] - 2
    if n <= coarsest or n % 2:
        return np_lin_solve3d(0, p, x0, 1.0, 6.0, 20, red_black=True)
    p = np_lin_solve3d(0, p, x0, 1.0, 6.0, 2, red_black=True)
    r = x0[1:-1, 1:-1, 1:-1] + np_nb3d(p) - 6.0 * p[1:-1, 1:-1, 1:-1]
    h = n // 2
    rc = np.pad(4.0 * r.reshape(h, 2, h, 2, h, 2).mean(axis=(1, 3, 5)), 1)
    ec = np_mg_vcycle(np.zeros((h + 2,) * 3), rc, coarsest)
    e = ec[1:-1, 1:-1, 1:-1]
    for ax in range(3):
        e = np.repeat(e, 2, axis=ax)
    p = p.copy()
    p[1:-1, 1:-1, 1:-1] += e
    p = np_set_bnd3d(0, p)
    return np_lin_solve3d(0, p, x0, 1.0, 6.0, 2, red_black=True)


def np_project3d(u, v, w, cfg):
    div = np.zeros_like(u)
    div[1:-1, 1:-1, 1:-1] = np_div3d(u, v, w)
    div = np_set_bnd3d(0, div)
    if cfg.projection == "dct":
        p = np_dct_solve3d(div)
    elif cfg.projection == "multigrid":
        p = np.zeros_like(div)
        for _ in range(cfg.mg_cycles):
            p = np_mg_vcycle(p, div)
    else:
        p = np_lin_solve3d(0, np.zeros_like(u), div, 1.0, 6.0,
                           cfg.jacobi_iters, cfg.red_black)
    return np_gradsub3d(p, u, v, w)


def np_buoyancy3d(w, dens, temp, cfg):
    w = w.copy()
    w[1:-1, 1:-1, 1:-1] += cfg.dt * (
        -cfg.buoyancy_alpha * dens[1:-1, 1:-1, 1:-1]
        + cfg.buoyancy_beta * (temp[1:-1, 1:-1, 1:-1] - cfg.ambient_temp))
    return np_set_bnd3d(3, w)


def np_vorticity3d(u, v, w, cfg):
    n = u.shape[0] - 2

    def d(q, ax):
        hi = [slice(1, -1)] * 3
        lo = [slice(1, -1)] * 3
        hi[ax], lo[ax] = slice(2, None), slice(0, -2)
        return 0.5 * n * (q[tuple(hi)] - q[tuple(lo)])

    wx, wy, wz = d(w, 1) - d(v, 2), d(u, 2) - d(w, 0), d(v, 0) - d(u, 1)
    mag = np.zeros_like(u)
    mag[1:-1, 1:-1, 1:-1] = np.sqrt(wx * wx + wy * wy + wz * wz)
    gx, gy, gz = d(mag, 0), d(mag, 1), d(mag, 2)
    norm = np.sqrt(gx * gx + gy * gy + gz * gz) + 1e-5
    gx, gy, gz = gx / norm, gy / norm, gz / norm
    e = cfg.vorticity_eps / n * cfg.dt
    u, v, w = u.copy(), v.copy(), w.copy()
    u[1:-1, 1:-1, 1:-1] += e * (gy * wz - gz * wy)
    v[1:-1, 1:-1, 1:-1] += e * (gz * wx - gx * wz)
    w[1:-1, 1:-1, 1:-1] += e * (gx * wy - gy * wx)
    return np_set_bnd3d(1, u), np_set_bnd3d(2, v), np_set_bnd3d(3, w)


def np_advect3d(b, q, u, v, w, cfg):
    """Semi-Lagrangian trilinear backtrace (Stam's advect)."""
    n = q.shape[0] - 2
    dt0 = cfg.dt * n
    i, j, k = np.indices((n, n, n)) + 1.0
    x = np.clip(i - dt0 * u[1:-1, 1:-1, 1:-1], 0.5, n + 0.5)
    y = np.clip(j - dt0 * v[1:-1, 1:-1, 1:-1], 0.5, n + 0.5)
    z = np.clip(k - dt0 * w[1:-1, 1:-1, 1:-1], 0.5, n + 0.5)
    i0, j0, k0 = (np.floor(c).astype(int) for c in (x, y, z))
    s1, t1, r1 = x - i0, y - j0, z - k0
    out = 0.0
    for di, ws in ((0, 1 - s1), (1, s1)):
        for dj, wt in ((0, 1 - t1), (1, t1)):
            for dk, wr in ((0, 1 - r1), (1, r1)):
                out = out + ws * wt * wr * q[i0 + di, j0 + dj, k0 + dk]
    res = q.copy()
    res[1:-1, 1:-1, 1:-1] = out
    return np_set_bnd3d(b, res)


def np_advect3d_stencil(b, q, u, v, w, cfg):
    """27-tap hat-weight form with per-axis displacement clamped to one
    cell and to the [0.5, n+0.5] walls."""
    n = q.shape[0] - 2
    dt0 = cfg.dt * n
    idx = np.indices((n, n, n)) + 1.0
    offs = [np.clip(np.clip(-dt0 * f[1:-1, 1:-1, 1:-1], -1, 1),
                    0.5 - idx[a], n + 0.5 - idx[a])
            for a, f in enumerate((u, v, w))]
    out = 0.0
    for dx in (-1, 0, 1):
        for dy in (-1, 0, 1):
            for dz in (-1, 0, 1):
                wgt = 1.0
                for o, d in zip(offs, (dx, dy, dz)):
                    wgt = wgt * np.maximum(0.0, 1.0 - np.abs(o - d))
                out = out + wgt * q[1 + dx:1 + dx + n, 1 + dy:1 + dy + n,
                                    1 + dz:1 + dz + n]
    res = q.copy()
    res[1:-1, 1:-1, 1:-1] = out
    return np_set_bnd3d(b, res)


def np_step3d(s, cfg):
    u, v, w, dens, temp = s
    if cfg.buoyancy_alpha or cfg.buoyancy_beta:
        w = np_buoyancy3d(w, dens, temp, cfg)
    if cfg.vorticity_eps:
        u, v, w = np_vorticity3d(u, v, w, cfg)
    u, v, w = np_project3d(u, v, w, cfg)
    adv = np_advect3d_stencil if cfg.advect_mode == "stencil" else \
        np_advect3d
    u, v, w = (adv(1, u, u, v, w, cfg), adv(2, v, u, v, w, cfg),
               adv(3, w, u, v, w, cfg))
    u, v, w = np_project3d(u, v, w, cfg)
    return (u, v, w, adv(0, dens, u, v, w, cfg),
            adv(0, temp, u, v, w, cfg))


# ---------------------------------------------------------------------------


def rand(shape, seed, scale=1.0):
    """float32-representable float64 samples"""
    a = np.random.default_rng(seed).normal(0, scale, shape)
    return a.astype(np.float32).astype(np.float64)


def close(got, want, rtol=1e-5, atol=1e-5):
    want = np.asarray(want)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol,
                               atol=atol * scale)


@pytest.mark.parametrize("b", [0, 1, 2, 3])
def test_set_bnd3d_matches_numpy(b):
    x = rand((10, 11, 12), b)
    close(stam.set_bnd3d(b, jnp.asarray(x, jnp.float32)),
          np_set_bnd3d(b, x), rtol=0, atol=0)


@pytest.mark.parametrize("b", [0, 1, 2])
def test_set_bnd2d_matches_numpy(b):
    x = rand((9, 10), 10 + b)
    close(stam.set_bnd2d(b, jnp.asarray(x, jnp.float32)),
          np_set_bnd2d(b, x), atol=1e-6)


@pytest.mark.parametrize("red_black", [False, True])
@pytest.mark.parametrize("b", [0, 1, 2, 3])
def test_lin_solve3d_matches_numpy(b, red_black):
    x = np_set_bnd3d(b, rand((12, 12, 12), b))
    x0 = rand((12, 12, 12), 20 + b)
    a, c = 0.7, 1 + 6 * 0.7
    got = stam.lin_solve3d(b, jnp.asarray(x, jnp.float32),
                           jnp.asarray(x0, jnp.float32), a, c, 6,
                           red_black=red_black)
    close(got, np_lin_solve3d(b, x, x0, a, c, 6, red_black))


@pytest.mark.parametrize("b", [0, 1, 2])
def test_lin_solve2d_matches_numpy(b):
    x = np_set_bnd2d(b, rand((14, 14), b))
    x0 = rand((14, 14), 30 + b)
    got = stam.lin_solve2d(b, jnp.asarray(x, jnp.float32),
                           jnp.asarray(x0, jnp.float32), 0.5, 3.0, 8)
    close(got, np_lin_solve2d(b, x, x0, 0.5, 3.0, 8))


def test_divergence3d_matches_numpy():
    u, v, w = (rand((14, 14, 14), s) for s in (1, 2, 3))
    close(stam.divergence3d(*(jnp.asarray(a, jnp.float32)
                              for a in (u, v, w))), np_div3d(u, v, w))


@pytest.mark.parametrize("projection,red_black", [("jacobi", False),
                                                  ("jacobi", True),
                                                  ("dct", False),
                                                  ("multigrid", False)])
def test_project3d_matches_numpy(projection, red_black):
    cfg = stam.StamConfig(n=16, projection=projection, red_black=red_black,
                          jacobi_iters=10)
    u, v, w = (np_set_bnd3d(b, rand((18, 18, 18), b, 0.3))
               for b in (1, 2, 3))
    got = stam.project3d(*(jnp.asarray(a, jnp.float32) for a in (u, v, w)),
                         cfg)
    for g, r in zip(got, np_project3d(u, v, w, cfg)):
        close(g, r, atol=2e-5)


def test_buoyancy3d_matches_numpy():
    cfg = stam.StamConfig(n=12, dt=0.1, buoyancy_alpha=0.05,
                          buoyancy_beta=0.5, ambient_temp=0.2)
    w, dens, temp = (rand((14, 14, 14), s) for s in (4, 5, 6))
    got = stam.buoyancy3d(*(jnp.asarray(a, jnp.float32)
                            for a in (w, dens, temp)), cfg)
    close(got, np_buoyancy3d(w, dens, temp, cfg))


def test_vorticity_confinement3d_matches_numpy():
    cfg = stam.StamConfig(n=12, dt=0.1, vorticity_eps=2.0)
    u, v, w = (np_set_bnd3d(b, rand((14, 14, 14), b, 0.3))
               for b in (1, 2, 3))
    got = stam.vorticity_confinement3d(
        *(jnp.asarray(a, jnp.float32) for a in (u, v, w)), cfg)
    for g, r in zip(got, np_vorticity3d(u, v, w, cfg)):
        close(g, r, atol=1e-4)


@pytest.mark.parametrize("b", [0, 1, 3])
def test_advect3d_gather_matches_numpy(b):
    cfg = stam.StamConfig(n=12, dt=0.05)
    q, u, v, w = (rand((14, 14, 14), s, 0.5) for s in (b, 7, 8, 9))
    got = stam.advect3d(b, *(jnp.asarray(a, jnp.float32)
                             for a in (q, u, v, w)), cfg)
    close(got, np_advect3d(b, q, u, v, w, cfg))


@pytest.mark.parametrize("b", [0, 2, 3])
def test_advect3d_stencil_matches_numpy(b):
    cfg = stam.StamConfig(n=12, dt=0.05)
    q, u, v, w = (rand((14, 14, 14), s, 0.5) for s in (b, 17, 18, 19))
    got = stam.advect3d_stencil(b, *(jnp.asarray(a, jnp.float32)
                                     for a in (q, u, v, w)), cfg)
    close(got, np_advect3d_stencil(b, q, u, v, w, cfg))


@pytest.mark.parametrize("projection", ["jacobi", "dct", "multigrid"])
def test_step3d_matches_numpy(projection):
    cfg = stam.StamConfig(n=16, dt=0.02, projection=projection,
                          jacobi_iters=8, red_black=True,
                          buoyancy_alpha=0.05, buoyancy_beta=0.5,
                          vorticity_eps=1.0, advect_mode="stencil")
    fields = [np_set_bnd3d(b, rand((18, 18, 18), 40 + b, 0.2))
              for b in (1, 2, 3, 0, 0)]
    state = stam.GridState3D(*(jnp.asarray(a, jnp.float32)
                               for a in fields))
    got = stam.step3d(state, cfg)
    want = np_step3d(fields, cfg)
    for name, g, r in zip(("u", "v", "w", "dens", "temp"),
                          (got.u, got.v, got.w, got.dens, got.temp), want):
        close(g, r, rtol=1e-4, atol=1e-4)
