"""Stam-style stable-fluids solver (2D and 3D).

This module implements the grid-solver reading of the north star
(BASELINE.json): add-source, semi-Lagrangian advection, Jacobi
diffusion, divergence + Jacobi pressure projection, ``set_bnd``
boundary enforcement, vorticity confinement and a buoyancy/temperature
("unidyn plume") forcing — the classic Stam "Real-Time Fluid Dynamics
for Games" step structure, re-designed for XLA:

* fields are dense (N+2)^d float32 arrays (one ghost layer), double-
  buffered implicitly by functional updates;
* the Jacobi/red-black sweeps run under ``lax.fori_loop`` so the whole
  step is one compiled program — no host round-trips;
* boundary enforcement is face-slice updates (fused by XLA), and
  advection is one gather per field with clamped backtraces (or a
  27-tap stencil, advect_mode="stencil");
* the same step runs sharded over a device mesh via
  tpufluids.shard.grid_sharded (halo exchange on the ghost layers).

The reference repo contains a particle solver, not this (SURVEY.md §0
discrepancy note); this module exists to satisfy the BASELINE.json
configs and shares the framework substrate (config/state/io/shard).
"""

from __future__ import annotations

import dataclasses
import functools
from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
from tpufluids.state import pytree_dataclass


@dataclasses.dataclass(frozen=True)
class StamConfig:
    n: int = 128                 # interior cells per axis
    dt: float = 0.1
    diff: float = 0.0            # density diffusion coefficient
    visc: float = 0.0            # kinematic viscosity
    jacobi_iters: int = 20
    red_black: bool = False      # red-black Gauss-Seidel projection
    vorticity_eps: float = 0.0   # vorticity confinement strength
    buoyancy_alpha: float = 0.0  # density weight (pulls smoke down)
    buoyancy_beta: float = 0.0   # temperature weight (pushes plume up)
    ambient_temp: float = 0.0
    temp_diff: float = 0.0
    # advection backend: "gather" = classic unbounded semi-Lagrangian
    # backtrace (one XLA gather per field); "stencil" = 27-tap shifted
    # trilinear accumulation (static slices, no gather) — bit-equivalent
    # for backtraces within one cell (CFL <= 1), with longer backtraces
    # clamped to one cell.
    advect_mode: str = "gather"
    # pressure projection solver: "jacobi" (jacobi_iters sweeps, the
    # BASELINE benchmark definition), "multigrid" (mg_cycles V(2,2)
    # cycles — each reduces the Poisson residual ~10x at the cost of
    # ~8 sweeps, where plain sweeps stall with grid size), or "dct"
    # (exact spectral solve via 3-axis DCT matmuls; residual ~1e-6 in
    # one fixed-cost pass — see dct_solve3d)
    projection: str = "jacobi"
    mg_cycles: int = 2
    # matmul precision of the DCT transforms (jax.lax.Precision):
    # "highest" (full float32), "high" or "default" (on an H100 both
    # run the tensor cores in TF32).  The solve is matmul-bound at large
    # n, so a lower tier trades residual digits for speed.
    dct_precision: str = "highest"
    # radix-2 split threshold for the DCT transforms: axes with even
    # extent >= this use one fold + {DCT-II, DCT-IV} half-size split,
    # halving that axis's matmul FLOPs (see _dct_solve_interior).  0
    # disables; -1 (default) = auto: 256 at dct_precision "highest",
    # off at the lower tiers.  An explicit value is honored at any
    # precision.
    dct_radix_min: int = -1
    # matmul precision for the FIRST (pre-advection) projection of each
    # step only; "" = same as dct_precision.  The reported residual
    # comes from the step's FINAL projection, and the intermediate
    # divergence only needs to be small before advection, so the first
    # solve may run at a cheaper tier while the final one stays exact.
    dct_precision_first: str = ""
    # radix fold levels (see stam._dct2_split_fwd): 1 = a single split;
    # 2 recurses on the even branch (matmuls at n/2 and n/4 — 3n^2/8
    # FLOPs per column vs n^2/2).
    dct_radix_levels: int = 1

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)


@pytree_dataclass
class GridState2D:
    u: jax.Array      # (n+2, n+2) x-velocity
    v: jax.Array      # (n+2, n+2) y-velocity
    dens: jax.Array   # (n+2, n+2)
    temp: jax.Array   # (n+2, n+2)


@pytree_dataclass
class GridState3D:
    u: jax.Array      # (n+2, n+2, n+2)
    v: jax.Array
    w: jax.Array
    dens: jax.Array
    temp: jax.Array


def make_grid2d(cfg: StamConfig) -> GridState2D:
    shape = (cfg.n + 2, cfg.n + 2)
    z = jnp.zeros(shape, jnp.float32)
    return GridState2D(u=z, v=z, dens=z,
                       temp=jnp.full(shape, cfg.ambient_temp, jnp.float32))


def make_grid3d(cfg: StamConfig) -> GridState3D:
    shape = (cfg.n + 2, cfg.n + 2, cfg.n + 2)
    z = jnp.zeros(shape, jnp.float32)
    return GridState3D(u=z, v=z, w=z, dens=z,
                       temp=jnp.full(shape, cfg.ambient_temp, jnp.float32))


# ---------------------------------------------------------------------------
# set_bnd — Stam's boundary enforcement.  b = 0: continuity (copy),
# b = k: negate the component normal to axis k-1 at that face.


def set_bnd2d(b: int, x: jax.Array) -> jax.Array:
    sx = -1.0 if b == 1 else 1.0
    sy = -1.0 if b == 2 else 1.0
    x = x.at[0, 1:-1].set(sx * x[1, 1:-1])
    x = x.at[-1, 1:-1].set(sx * x[-2, 1:-1])
    x = x.at[:, 0].set(sy * x[:, 1])
    x = x.at[:, -1].set(sy * x[:, -2])
    # corners = average of the two adjacent edge cells
    x = x.at[0, 0].set(0.5 * (x[1, 0] + x[0, 1]))
    x = x.at[0, -1].set(0.5 * (x[1, -1] + x[0, -2]))
    x = x.at[-1, 0].set(0.5 * (x[-2, 0] + x[-1, 1]))
    x = x.at[-1, -1].set(0.5 * (x[-2, -1] + x[-1, -2]))
    return x


def set_bnd3d(b: int, x: jax.Array) -> jax.Array:
    sx = -1.0 if b == 1 else 1.0
    sy = -1.0 if b == 2 else 1.0
    sz = -1.0 if b == 3 else 1.0
    x = x.at[0, :, :].set(sx * x[1, :, :])
    x = x.at[-1, :, :].set(sx * x[-2, :, :])
    x = x.at[:, 0, :].set(sy * x[:, 1, :])
    x = x.at[:, -1, :].set(sy * x[:, -2, :])
    x = x.at[:, :, 0].set(sz * x[:, :, 1])
    x = x.at[:, :, -1].set(sz * x[:, :, -2])
    return x


# ---------------------------------------------------------------------------
# linear solvers (diffusion + pressure Poisson)


def _jacobi_iter2d(x, x0, a, c_inv):
    nb = (x[:-2, 1:-1] + x[2:, 1:-1] + x[1:-1, :-2] + x[1:-1, 2:])
    return x.at[1:-1, 1:-1].set((x0[1:-1, 1:-1] + a * nb) * c_inv)


def _jacobi_iter3d(x, x0, a, c_inv):
    nb = (x[:-2, 1:-1, 1:-1] + x[2:, 1:-1, 1:-1]
          + x[1:-1, :-2, 1:-1] + x[1:-1, 2:, 1:-1]
          + x[1:-1, 1:-1, :-2] + x[1:-1, 1:-1, 2:])
    return x.at[1:-1, 1:-1, 1:-1].set((x0[1:-1, 1:-1, 1:-1] + a * nb)
                                      * c_inv)


def _checker(shape3, parity):
    i = jax.lax.broadcasted_iota(jnp.int32, shape3, 0)
    j = jax.lax.broadcasted_iota(jnp.int32, shape3, 1)
    k = jax.lax.broadcasted_iota(jnp.int32, shape3, 2)
    return ((i + j + k) % 2) == parity


def lin_solve2d(b, x, x0, a, c, iters):
    c_inv = 1.0 / c

    def body(_, x):
        x = _jacobi_iter2d(x, x0, a, c_inv)
        return set_bnd2d(b, x)

    return jax.lax.fori_loop(0, iters, body, x)


def lin_solve3d(b, x, x0, a, c, iters, red_black=False):
    c_inv = 1.0 / c
    if not red_black:
        def body(_, x):
            x = _jacobi_iter3d(x, x0, a, c_inv)
            return set_bnd3d(b, x)
        return jax.lax.fori_loop(0, iters, body, x)

    mask0 = _checker((x.shape[0] - 2,) * 3, 0)

    def body_rb(_, x):
        for parity in (0, 1):
            new = _jacobi_iter3d(x, x0, a, c_inv)
            m = mask0 if parity == 0 else ~mask0
            x = x.at[1:-1, 1:-1, 1:-1].set(
                jnp.where(m, new[1:-1, 1:-1, 1:-1], x[1:-1, 1:-1, 1:-1]))
            x = set_bnd3d(b, x)
        return x

    return jax.lax.fori_loop(0, iters, body_rb, x)


def diffuse2d(b, x, cfg, coeff, iters=None):
    n = x.shape[0] - 2
    a = cfg.dt * coeff * n * n
    return lin_solve2d(b, x, x, a, 1 + 4 * a, iters or cfg.jacobi_iters)


def diffuse3d(b, x, cfg, coeff, iters=None):
    # diffusion always uses plain jacobi (matching the dense reference
    # path; red_black only applies to the pressure projection)
    n = x.shape[0] - 2
    a = cfg.dt * coeff * n * n
    return lin_solve3d(b, x, x, a, 1 + 6 * a, iters or cfg.jacobi_iters)


# ---------------------------------------------------------------------------
# semi-Lagrangian advection


def advect2d(b, q, u, v, cfg):
    n = q.shape[0] - 2
    dt0 = cfg.dt * n
    ii = jax.lax.broadcasted_iota(jnp.float32, (n, n), 0) + 1.0
    jj = jax.lax.broadcasted_iota(jnp.float32, (n, n), 1) + 1.0
    x = jnp.clip(ii - dt0 * u[1:-1, 1:-1], 0.5, n + 0.5)
    y = jnp.clip(jj - dt0 * v[1:-1, 1:-1], 0.5, n + 0.5)
    i0 = jnp.floor(x).astype(jnp.int32)
    j0 = jnp.floor(y).astype(jnp.int32)
    s1, t1 = x - i0, y - j0
    s0, t0 = 1 - s1, 1 - t1

    def g(di, dj):
        return q[i0 + di, j0 + dj]

    out = (s0 * (t0 * g(0, 0) + t1 * g(0, 1))
           + s1 * (t0 * g(1, 0) + t1 * g(1, 1)))
    return set_bnd2d(b, q.at[1:-1, 1:-1].set(out))


def advect3d(b, q, u, v, w, cfg):
    n = q.shape[0] - 2
    dt0 = cfg.dt * n
    shape = (n, n, n)
    ii = jax.lax.broadcasted_iota(jnp.float32, shape, 0) + 1.0
    jj = jax.lax.broadcasted_iota(jnp.float32, shape, 1) + 1.0
    kk = jax.lax.broadcasted_iota(jnp.float32, shape, 2) + 1.0
    x = jnp.clip(ii - dt0 * u[1:-1, 1:-1, 1:-1], 0.5, n + 0.5)
    y = jnp.clip(jj - dt0 * v[1:-1, 1:-1, 1:-1], 0.5, n + 0.5)
    z = jnp.clip(kk - dt0 * w[1:-1, 1:-1, 1:-1], 0.5, n + 0.5)
    i0 = jnp.floor(x).astype(jnp.int32)
    j0 = jnp.floor(y).astype(jnp.int32)
    k0 = jnp.floor(z).astype(jnp.int32)
    s1, t1, r1 = x - i0, y - j0, z - k0
    s0, t0, r0 = 1 - s1, 1 - t1, 1 - r1

    def g(di, dj, dk):
        return q[i0 + di, j0 + dj, k0 + dk]

    out = (s0 * (t0 * (r0 * g(0, 0, 0) + r1 * g(0, 0, 1))
                 + t1 * (r0 * g(0, 1, 0) + r1 * g(0, 1, 1)))
           + s1 * (t0 * (r0 * g(1, 0, 0) + r1 * g(1, 0, 1))
                   + t1 * (r0 * g(1, 1, 0) + r1 * g(1, 1, 1))))
    return set_bnd3d(b, q.at[1:-1, 1:-1, 1:-1].set(out))


def _advect_stencil(b, q, disp, set_bnd, ndim):
    """27-tap (9-tap in 2D) stencil trilinear semi-Lagrangian advection.

    ``disp`` is the per-axis backtrace displacement in cells, clamped to
    [-1, 1].  The source value at offset o is the multilinear interp
    sum over shifts d in {-1,0,1}^ndim with hat weights
    max(0, 1 - |o_a - d_a|) per axis — identical to the gather version
    whenever the true backtrace stays within one cell.  All taps are
    static shifted slices, which XLA/Mosaic fuses into one fast pass
    (no gather).
    """
    n = q.shape[0] - 2
    interior = tuple([slice(1, -1)] * ndim)
    # per-cell clamp so the source never leaves [0.5, n+0.5] (matches
    # the gather version's global clip at the walls)
    idx = [jax.lax.broadcasted_iota(jnp.float32, (n,) * ndim, a) + 1.0
           for a in range(ndim)]
    offs = [jnp.clip(jnp.clip(disp[a], -1.0, 1.0),
                     0.5 - idx[a], n + 0.5 - idx[a])
            for a in range(ndim)]

    def shifted(d):
        sl = tuple(slice(1 + da, 1 + da + n) for da in d)
        return q[sl]

    out = jnp.zeros((n,) * ndim, q.dtype)
    for d in _SHIFTS[ndim]:
        wgt = 1.0
        for a in range(ndim):
            wgt = wgt * jnp.maximum(0.0, 1.0 - jnp.abs(offs[a] - d[a]))
        out = out + wgt * shifted(d)
    return set_bnd(b, q.at[interior].set(out))


_SHIFTS = {
    2: [(dx, dy) for dx in (-1, 0, 1) for dy in (-1, 0, 1)],
    3: [(dx, dy, dz) for dx in (-1, 0, 1) for dy in (-1, 0, 1)
        for dz in (-1, 0, 1)],
}


def advect2d_stencil(b, q, u, v, cfg):
    n = q.shape[0] - 2
    dt0 = cfg.dt * n
    disp = (-dt0 * u[1:-1, 1:-1], -dt0 * v[1:-1, 1:-1])
    return _advect_stencil(b, q, disp, set_bnd2d, 2)


def advect3d_stencil(b, q, u, v, w, cfg):
    n = q.shape[0] - 2
    dt0 = cfg.dt * n
    disp = (-dt0 * u[1:-1, 1:-1, 1:-1], -dt0 * v[1:-1, 1:-1, 1:-1],
            -dt0 * w[1:-1, 1:-1, 1:-1])
    return _advect_stencil(b, q, disp, set_bnd3d, 3)


def _advect2(b, q, u, v, cfg):
    if cfg.advect_mode == "stencil":
        return advect2d_stencil(b, q, u, v, cfg)
    return advect2d(b, q, u, v, cfg)


def _advect3(b, q, u, v, w, cfg):
    if cfg.advect_mode == "stencil":
        return advect3d_stencil(b, q, u, v, w, cfg)
    return advect3d(b, q, u, v, w, cfg)


# ---------------------------------------------------------------------------
# projection


def divergence2d(u, v):
    n = u.shape[0] - 2
    h = 1.0 / n
    return -0.5 * h * (u[2:, 1:-1] - u[:-2, 1:-1]
                       + v[1:-1, 2:] - v[1:-1, :-2])


def divergence3d(u, v, w):
    n = u.shape[0] - 2
    h = 1.0 / n
    return -0.5 * h * (u[2:, 1:-1, 1:-1] - u[:-2, 1:-1, 1:-1]
                       + v[1:-1, 2:, 1:-1] - v[1:-1, :-2, 1:-1]
                       + w[1:-1, 1:-1, 2:] - w[1:-1, 1:-1, :-2])


def poisson_residual2d(p, div):
    """Max-norm residual of the compact 5-point Poisson solve
    (the BASELINE "max divergence residual" metric: how well the Jacobi
    projection solved its own system; the raw central-difference
    divergence retains a checkerboard null space on Stam's collocated
    grid and cannot reach zero)."""
    nb = (p[:-2, 1:-1] + p[2:, 1:-1] + p[1:-1, :-2] + p[1:-1, 2:])
    return jnp.max(jnp.abs(div[1:-1, 1:-1] + nb - 4.0 * p[1:-1, 1:-1]))


def poisson_residual3d(p, div):
    nb = (p[:-2, 1:-1, 1:-1] + p[2:, 1:-1, 1:-1]
          + p[1:-1, :-2, 1:-1] + p[1:-1, 2:, 1:-1]
          + p[1:-1, 1:-1, :-2] + p[1:-1, 1:-1, 2:])
    return jnp.max(jnp.abs(div[1:-1, 1:-1, 1:-1] + nb
                           - 6.0 * p[1:-1, 1:-1, 1:-1]))


def project2d(u, v, cfg, with_residual: bool = False):
    n = u.shape[0] - 2
    h = 1.0 / n
    div = jnp.zeros_like(u).at[1:-1, 1:-1].set(divergence2d(u, v))
    div = set_bnd2d(0, div)
    if cfg.projection == "dct":
        p = dct_solve2d(div, cfg)
    else:
        p = lin_solve2d(0, jnp.zeros_like(u), div, 1.0, 4.0,
                        cfg.jacobi_iters)
    u = u.at[1:-1, 1:-1].add(-0.5 * (p[2:, 1:-1] - p[:-2, 1:-1]) / h)
    v = v.at[1:-1, 1:-1].add(-0.5 * (p[1:-1, 2:] - p[1:-1, :-2]) / h)
    u, v = set_bnd2d(1, u), set_bnd2d(2, v)
    if with_residual:
        return u, v, poisson_residual2d(p, div)
    return u, v


# ---------------------------------------------------------------------------
# geometric multigrid for the pressure Poisson system (production
# projection option: V(2,2) cycles reduce the residual ~10x each at
# roughly the cost of 8 red-black iterations, vs the fixed-20-iteration
# Jacobi whose convergence stalls with grid size)


def _mg_residual3d(p, x0):
    """r = x0 + sum(nb) - 6 p on the interior of the ghosted array
    (the h^2-scaled form used by lin_solve3d with a=1, c=6)."""
    nb = (p[:-2, 1:-1, 1:-1] + p[2:, 1:-1, 1:-1]
          + p[1:-1, :-2, 1:-1] + p[1:-1, 2:, 1:-1]
          + p[1:-1, 1:-1, :-2] + p[1:-1, 1:-1, 2:])
    return x0[1:-1, 1:-1, 1:-1] + nb - 6.0 * p[1:-1, 1:-1, 1:-1]


def _mg_restrict3d(r):
    """Cell-centered full-weighting: average 2x2x2 fine interior cells.
    The x4 RHS scale (h_c^2 = 4 h^2 in the h^2-scaled stencil) is
    folded in here.  Input is the INTERIOR residual (n, n, n); output
    is a ghosted coarse RHS ((n/2)+2,)^3 with zero ghosts."""
    n = r.shape[0]
    rc = r.reshape(n // 2, 2, n // 2, 2, n // 2, 2).mean(axis=(1, 3, 5))
    return jnp.pad(4.0 * rc, 1)


def _mg_prolong3d(e):
    """Piecewise-constant prolongation of the ghosted coarse correction
    interior onto the fine interior."""
    ei = e[1:-1, 1:-1, 1:-1]
    for axis in range(3):
        ei = jnp.repeat(ei, 2, axis=axis)
    return ei


def _mg_vcycle(p, x0, cfg, nu1=2, nu2=2, coarsest=8):
    n = p.shape[0] - 2
    if n <= coarsest or n % 2:
        return lin_solve3d(0, p, x0, 1.0, 6.0, 20, red_black=True)
    p = lin_solve3d(0, p, x0, 1.0, 6.0, nu1, red_black=True)
    r = _mg_residual3d(p, x0)
    ec = _mg_vcycle(jnp.zeros((n // 2 + 2,) * 3, jnp.float32),
                    _mg_restrict3d(r), cfg, nu1, nu2, coarsest)
    p = set_bnd3d(0, p.at[1:-1, 1:-1, 1:-1].add(_mg_prolong3d(ec)))
    return lin_solve3d(0, p, x0, 1.0, 6.0, nu2, red_black=True)


def mg_solve3d(x0, cfg, cycles: int = None):
    """Solve the ghosted pressure Poisson system with V(2,2) multigrid
    (red-black smoothing at every level)."""
    p = jnp.zeros_like(x0)
    for _ in range(cycles if cycles is not None else cfg.mg_cycles):
        p = _mg_vcycle(p, x0, cfg)
    return p


def _dct_axis(a, m, ax, prec):
    """Contract matrix m[q, i] against axis ``ax`` of ``a``."""
    out = jnp.tensordot(m, jnp.moveaxis(a, ax, 0), axes=((1,), (0,)),
                        precision=prec)
    return jnp.moveaxis(out, 0, ax)


def _dct_mats(n):
    """(forward DCT-II matrix (q,i), inverse DCT matrix (i,q),
    per-axis Neumann-Laplacian eigenvalues) for extent ``n``."""
    i = jnp.arange(n, dtype=jnp.float32)
    C = jnp.cos(jnp.pi / n * i[:, None] * (i[None, :] + 0.5))
    Ci = C.T * (jnp.where(i == 0, 1.0, 2.0) / n)
    lam1 = 2.0 - 2.0 * jnp.cos(jnp.pi * i / n)
    return C, Ci, lam1


_DCT_PREC = {"highest": jax.lax.Precision.HIGHEST,
             "high": jax.lax.Precision.HIGH,
             "default": jax.lax.Precision.DEFAULT}


def _dct4_mat(m):
    """DCT-IV matrix M[q, i] = cos(pi (2q+1)(2i+1) / (4m)).

    Symmetric and orthogonal up to scale: M @ M = (m/2) I, so its
    inverse is (2/m) M — no divisions by small cosines anywhere
    (numerically stable, unlike Lee's recursive fast-DCT split)."""
    i = jnp.arange(m, dtype=jnp.float32)
    return jnp.cos(jnp.pi / (4 * m)
                   * (2 * i[:, None] + 1) * (2 * i[None, :] + 1))


def _radix_lams(n):
    """(even-block, odd-block) Neumann eigenvalue vectors for a
    radix-2-split axis of extent n: lam[2q] and lam[2q+1]."""
    i = jnp.arange(n, dtype=jnp.float32)
    lam_full = 2.0 - 2.0 * jnp.cos(jnp.pi * i / n)
    return lam_full[0::2], lam_full[1::2]


def _dct2_split_fwd(a, ax, prec, levels):
    """DCT-II along ``ax`` with up to ``levels`` radix-2 fold levels
    recursing on the EVEN (DCT-II) branch — the radix-4-cascade
    generalization of the r4 single split (VERDICT r4 #6): each level
    folds x into x[i]+-x[n-1-i] halves and transforms the sum with a
    half-size DCT-II (recursively) and the difference with a half-size
    DCT-IV.  Returns [(block, eigenvalue-vector)] with the deepest
    even block first, so piece 0 always holds the q=0 gauge mode.

    Eigenvalue bookkeeping is closed under the recursion: the even
    block's true eigenvalues lam_full(n)[0::2] = 2-2cos(pi*(2q)/n)
    EQUAL the half-extent vector 2-2cos(pi*q/(n/2)), so the recursive
    call's vectors are already correct.

    FLOPs per axis column: direct n^2; one level n^2/2; two levels
    3n^2/8 (the DCT-IV(n/2) does not fold — its radix form needs
    rotation pre/post passes that cost about what they save)."""
    n = a.shape[ax]
    if levels <= 0 or n % 2 or n < 4:
        C, _, lam1 = _dct_mats(n)
        return [(_dct_axis(a, C, ax, prec), lam1)]
    m = n // 2
    front = jax.lax.slice_in_dim(a, 0, m, axis=ax)
    back = jnp.flip(jax.lax.slice_in_dim(a, m, n, axis=ax), ax)
    g, h = front + back, front - back
    M4 = _dct4_mat(m)
    _, lam_o = _radix_lams(n)
    return (_dct2_split_fwd(g, ax, prec, levels - 1)
            + [(_dct_axis(h, M4, ax, prec), lam_o)])


def _dct2_split_nblocks(n, levels):
    """Piece count produced by _dct2_split_fwd."""
    if levels <= 0 or n % 2 or n < 4:
        return 1
    return _dct2_split_nblocks(n // 2, levels - 1) + 1


def _dct2_split_inv(blocks, ax, prec):
    """Inverse of _dct2_split_fwd on a list of plain coefficient
    blocks (deepest even block first, one odd DCT-IV block per level
    appended in unwinding order): merges back to one full block."""
    if len(blocks) == 1:
        n = blocks[0].shape[ax]
        return _dct_axis(blocks[0], _dct_mats(n)[1], ax, prec)
    m = blocks[-1].shape[ax]
    g = _dct2_split_inv(blocks[:-1], ax, prec)
    M4i = _dct4_mat(m) * (2.0 / m)
    h = _dct_axis(blocks[-1], M4i, ax, prec)
    return jnp.concatenate(
        [0.5 * (g + h), jnp.flip(0.5 * (g - h), ax)], axis=ax)


def _radix_fwd_axis(pieces, ax, prec, levels=1):
    """Radix forward on ``ax`` over a list of (block, per-axis-
    eigenvalue-list) pieces (see _dct2_split_fwd); multiplies the
    piece count by _dct2_split_nblocks, keeping inverse-time partners
    adjacent when axes unwind in reverse."""
    nxt = []
    for a, lams in pieces:
        for blk, lamv in _dct2_split_fwd(a, ax, prec, levels):
            nxt.append((blk, lams + [lamv]))
    return nxt


def _radix_inv_axis(pieces, ax, prec, levels=1):
    """Inverse of _radix_fwd_axis on a list of plain coefficient
    blocks: consecutive groups merge back to full extent."""
    # the top-level odd (DCT-IV) block is last in every group and has
    # extent n/2 (this inverse is only called when the axis split)
    n = 2 * pieces[-1].shape[ax]
    k = _dct2_split_nblocks(n, levels)
    nxt = []
    for j in range(0, len(pieces), k):
        nxt.append(_dct2_split_inv(pieces[j:j + k], ax, prec))
    return nxt


def _dct_solve_interior(xi, precision="highest", radix_min=0,
                        radix_levels=1):
    """Exact Neumann-Poisson solve on an interior array of any rank.

    Solves `(2d) x - sum_nb x = xi` (the fixed point of lin_solve
    with a=1, c=2*ndim and set_bnd mirror ghosts).  The mirror ghosts
    make the per-axis operator the free Neumann Laplacian, which the
    type-II cosine basis diagonalizes exactly: eigenvectors
    cos(pi*q*(i+0.5)/n), eigenvalues 2 - 2cos(pi*q/n).  Forward DCT,
    diagonal scale with the q=0 gauge mode zeroed, inverse DCT — all
    dense (n, n) matmuls, the alternative to iterative sweeps (the CUDA
    reference has no Poisson solver at all).

    ``precision`` is the matmul precision tier (StamConfig
    .dct_precision).

    ``radix_min``: axes with even extent n >= radix_min use the
    radix-2 split — DCT-II(n) = fold + {DCT-II(n/2) on
    x[i]+x[n-1-i], DCT-IV(n/2) on x[i]-x[n-1-i]} — halving the matmul
    FLOPs of that axis's transform (n^2 -> n^2/2 per column) at the
    cost of cheap fold/unfold VPU passes.  ``radix_levels`` recurses
    the split on the even branch (levels=2: matmuls at n/2 and n/4,
    3n^2/8 per column — see _dct2_split_fwd).  The even/odd coefficient
    interleave is never materialized: the diagonal solve runs on
    permuted eigenvalue blocks, so the permutations cancel between the
    forward and inverse transforms.  0 disables (the dense
    single-matmul path, bit-compatible with earlier rounds)."""
    prec = _DCT_PREC[precision]
    nd = xi.ndim
    radix = [bool(radix_min) and n >= radix_min and n % 2 == 0
             for n in xi.shape]

    if not any(radix):
        # dense path, kept verbatim for bit-compatibility
        lam = 0.0
        invs = []
        for ax, n in enumerate(xi.shape):
            C, Ci, lam1 = _dct_mats(n)
            xi = _dct_axis(xi, C, ax, prec)
            lam = lam + lam1.reshape((-1,) + (1,) * (nd - 1 - ax))
            invs.append(Ci)
        coef = xi / jnp.where(lam == 0.0, 1.0, lam)
        coef = coef.at[(0,) * nd].set(0.0)        # pressure gauge
        for ax, Ci in enumerate(invs):
            coef = _dct_axis(coef, Ci, ax, prec)
        return coef

    # forward: pieces = [(coefficient block, per-axis eigenvalue 1D)].
    # A radix axis doubles the piece count (even-coefficient block,
    # then odd); the list order makes inverse-time partners adjacent
    # when unwinding axes in reverse.
    pieces = [(xi, [])]
    for ax, n in enumerate(xi.shape):
        if radix[ax]:
            pieces = _radix_fwd_axis(pieces, ax, prec, radix_levels)
        else:
            C, _, lam1 = _dct_mats(n)
            pieces = [(_dct_axis(a, C, ax, prec), lams + [lam1])
                      for a, lams in pieces]

    # diagonal solve; the all-even piece 0 holds the q=0 gauge mode at
    # its origin (every other piece has at least one odd-block
    # eigenvalue component, all of which are > 0)
    solved = []
    for k, (a, lams) in enumerate(pieces):
        lam = 0.0
        for ax2, l1 in enumerate(lams):
            lam = lam + l1.reshape((-1,) + (1,) * (nd - 1 - ax2))
        if k == 0:
            a = a / jnp.where(lam == 0.0, 1.0, lam)
            a = a.at[(0,) * nd].set(0.0)          # pressure gauge
        else:
            a = a / lam
        solved.append(a)
    pieces = solved

    # inverse, unwinding axes in reverse so radix partners are adjacent
    for ax in reversed(range(nd)):
        if radix[ax]:
            pieces = _radix_inv_axis(pieces, ax, prec, radix_levels)
        else:
            Ci = _dct_mats(xi.shape[ax])[1]
            pieces = [_dct_axis(a, Ci, ax, prec) for a in pieces]
    return pieces[0]


def _dct_params(cfg, final=True):
    """(precision, radix_min, radix_levels) for one projection solve.
    ``final=False`` = the step's first (pre-advection) projection,
    which may run at the cheaper ``dct_precision_first`` tier; the
    radix auto-gate keys on the tier actually used (the split is a
    measured win only at "highest" — StamConfig.dct_radix_min)."""
    if cfg is None:
        return "highest", 0, 1
    prec = cfg.dct_precision
    if not final and getattr(cfg, "dct_precision_first", ""):
        prec = cfg.dct_precision_first
    if cfg.dct_radix_min >= 0:
        rmin = cfg.dct_radix_min
    else:
        rmin = 256 if prec == "highest" else 0
    return prec, rmin, cfg.dct_radix_levels


def _radix_min(cfg):
    """Back-compat wrapper (final-projection parameters)."""
    return _dct_params(cfg)[1]


def _radix_levels(cfg):
    return 1 if cfg is None else cfg.dct_radix_levels


def dct_solve3d(x0, cfg=None, final=True):
    """Spectral projection solve on the ghosted 3D array (see
    _dct_solve_interior).  Residual ~1e-6-relative (float32 transform
    roundoff) in a fixed ~52 GFLOP at 256^3.  ``final=False`` uses the
    dct_precision_first tier (see _dct_params)."""
    sol = _dct_solve_interior(
        x0[1:-1, 1:-1, 1:-1], *_dct_params(cfg, final))
    p = jnp.zeros_like(x0).at[1:-1, 1:-1, 1:-1].set(sol)
    return set_bnd3d(0, p)


def dct_solve2d(x0, cfg=None):
    """2D spectral projection solve (lin_solve2d b=0, c=4 system)."""
    sol = _dct_solve_interior(
        x0[1:-1, 1:-1],
        "highest" if cfg is None else cfg.dct_precision,
        _radix_min(cfg), _radix_levels(cfg))
    p = jnp.zeros_like(x0).at[1:-1, 1:-1].set(sol)
    return set_bnd2d(0, p)


def project3d(u, v, w, cfg, with_residual: bool = False, final=True):
    n = u.shape[0] - 2
    h = 1.0 / n
    div = jnp.zeros_like(u).at[1:-1, 1:-1, 1:-1].set(
        divergence3d(u, v, w))
    div = set_bnd3d(0, div)
    if cfg.projection == "multigrid":
        p = mg_solve3d(div, cfg)
    elif cfg.projection == "dct":
        p = dct_solve3d(div, cfg, final=final)
    else:
        p = lin_solve3d(0, jnp.zeros_like(u), div, 1.0, 6.0,
                        cfg.jacobi_iters, red_black=cfg.red_black)
    u = u.at[1:-1, 1:-1, 1:-1].add(
        -0.5 * (p[2:, 1:-1, 1:-1] - p[:-2, 1:-1, 1:-1]) / h)
    v = v.at[1:-1, 1:-1, 1:-1].add(
        -0.5 * (p[1:-1, 2:, 1:-1] - p[1:-1, :-2, 1:-1]) / h)
    w = w.at[1:-1, 1:-1, 1:-1].add(
        -0.5 * (p[1:-1, 1:-1, 2:] - p[1:-1, 1:-1, :-2]) / h)
    u, v, w = set_bnd3d(1, u), set_bnd3d(2, v), set_bnd3d(3, w)
    if with_residual:
        return u, v, w, poisson_residual3d(p, div)
    return u, v, w


# ---------------------------------------------------------------------------
# forcings


def vorticity_confinement2d(u, v, cfg):
    n = u.shape[0] - 2
    h = 1.0 / n
    curl = 0.5 * ((v[2:, 1:-1] - v[:-2, 1:-1])
                  - (u[1:-1, 2:] - u[1:-1, :-2])) / h
    mag = jnp.zeros_like(u).at[1:-1, 1:-1].set(jnp.abs(curl))
    gx = 0.5 * (mag[2:, 1:-1] - mag[:-2, 1:-1]) / h
    gy = 0.5 * (mag[1:-1, 2:] - mag[1:-1, :-2]) / h
    norm = jnp.sqrt(gx * gx + gy * gy) + 1e-5
    gx, gy = gx / norm, gy / norm
    fu = cfg.vorticity_eps * h * gy * curl
    fv = -cfg.vorticity_eps * h * gx * curl
    u = u.at[1:-1, 1:-1].add(cfg.dt * fu)
    v = v.at[1:-1, 1:-1].add(cfg.dt * fv)
    return set_bnd2d(1, u), set_bnd2d(2, v)


def vorticity_confinement3d(u, v, w, cfg):
    n = u.shape[0] - 2
    h = 1.0 / n

    def d(q, axis, lo):
        sl = [slice(1, -1)] * 3
        hi_s, lo_s = list(sl), list(sl)
        hi_s[axis] = slice(2, None)
        lo_s[axis] = slice(0, -2)
        return 0.5 * (q[tuple(hi_s)] - q[tuple(lo_s)]) / h

    wx = d(w, 1, 0) - d(v, 2, 0)
    wy = d(u, 2, 0) - d(w, 0, 0)
    wz = d(v, 0, 0) - d(u, 1, 0)
    mag_i = jnp.sqrt(wx * wx + wy * wy + wz * wz)
    mag = jnp.zeros_like(u).at[1:-1, 1:-1, 1:-1].set(mag_i)
    gx, gy, gz = d(mag, 0, 0), d(mag, 1, 0), d(mag, 2, 0)
    norm = jnp.sqrt(gx * gx + gy * gy + gz * gz) + 1e-5
    gx, gy, gz = gx / norm, gy / norm, gz / norm
    eps_h = cfg.vorticity_eps * h
    fu = eps_h * (gy * wz - gz * wy)
    fv = eps_h * (gz * wx - gx * wz)
    fw = eps_h * (gx * wy - gy * wx)
    u = u.at[1:-1, 1:-1, 1:-1].add(cfg.dt * fu)
    v = v.at[1:-1, 1:-1, 1:-1].add(cfg.dt * fv)
    w = w.at[1:-1, 1:-1, 1:-1].add(cfg.dt * fw)
    return set_bnd3d(1, u), set_bnd3d(2, v), set_bnd3d(3, w)


def buoyancy3d(w, dens, temp, cfg):
    """Plume forcing on the vertical (z) velocity:
    f_z = -alpha * dens + beta * (temp - ambient)."""
    f = (-cfg.buoyancy_alpha * dens[1:-1, 1:-1, 1:-1]
         + cfg.buoyancy_beta * (temp[1:-1, 1:-1, 1:-1]
                                - cfg.ambient_temp))
    w = w.at[1:-1, 1:-1, 1:-1].add(cfg.dt * f)
    return set_bnd3d(3, w)


def buoyancy2d(v, dens, temp, cfg):
    f = (-cfg.buoyancy_alpha * dens[1:-1, 1:-1]
         + cfg.buoyancy_beta * (temp[1:-1, 1:-1] - cfg.ambient_temp))
    v = v.at[1:-1, 1:-1].add(cfg.dt * f)
    return set_bnd2d(2, v)


# ---------------------------------------------------------------------------
# full steps


def step2d(state: GridState2D, cfg: StamConfig,
           sources: Optional[dict] = None, with_residual: bool = False):
    """One 2D smoke step: forces -> vel(diffuse, project, advect,
    project) -> dens/temp(add, diffuse, advect)."""
    u, v, dens, temp = state.u, state.v, state.dens, state.temp
    if sources:
        u = u + cfg.dt * sources.get("fu", 0.0)
        v = v + cfg.dt * sources.get("fv", 0.0)
        dens = dens + cfg.dt * sources.get("dens", 0.0)
        temp = temp + cfg.dt * sources.get("temp", 0.0)
    if cfg.buoyancy_alpha or cfg.buoyancy_beta:
        v = buoyancy2d(v, dens, temp, cfg)
    if cfg.vorticity_eps:
        u, v = vorticity_confinement2d(u, v, cfg)
    if cfg.visc:
        u = diffuse2d(1, u, cfg, cfg.visc)
        v = diffuse2d(2, v, cfg, cfg.visc)
    u, v = project2d(u, v, cfg)
    u0, v0 = u, v
    u = _advect2(1, u0, u0, v0, cfg)
    v = _advect2(2, v0, u0, v0, cfg)
    if with_residual:
        u, v, res = project2d(u, v, cfg, with_residual=True)
    else:
        u, v = project2d(u, v, cfg)
    if cfg.diff:
        dens = diffuse2d(0, dens, cfg, cfg.diff)
    dens = _advect2(0, dens, u, v, cfg)
    if cfg.temp_diff:
        temp = diffuse2d(0, temp, cfg, cfg.temp_diff)
    temp = _advect2(0, temp, u, v, cfg)
    out = GridState2D(u=u, v=v, dens=dens, temp=temp)
    return (out, res) if with_residual else out


def step3d(state: GridState3D, cfg: StamConfig,
           sources: Optional[dict] = None, with_residual: bool = False):
    """One 3D step with set_bnd walls; configs 2-4 of BASELINE.json.
    Each stage runs under a named scope (forcing, diffuse, project_first,
    advect_vel, project_final, advect_scalars) so a profiler trace can
    be reduced to per-stage device times."""
    u, v, w, dens, temp = state.u, state.v, state.w, state.dens, state.temp
    if sources:
        u = u + cfg.dt * sources.get("fu", 0.0)
        v = v + cfg.dt * sources.get("fv", 0.0)
        w = w + cfg.dt * sources.get("fw", 0.0)
        dens = dens + cfg.dt * sources.get("dens", 0.0)
        temp = temp + cfg.dt * sources.get("temp", 0.0)

    with jax.named_scope("forcing"):
        if cfg.buoyancy_alpha or cfg.buoyancy_beta:
            w = buoyancy3d(w, dens, temp, cfg)
        if cfg.vorticity_eps:
            u, v, w = vorticity_confinement3d(u, v, w, cfg)
    if cfg.visc:
        with jax.named_scope("diffuse"):
            u = diffuse3d(1, u, cfg, cfg.visc)
            v = diffuse3d(2, v, cfg, cfg.visc)
            w = diffuse3d(3, w, cfg, cfg.visc)
    with jax.named_scope("project_first"):
        u, v, w = project3d(u, v, w, cfg, final=False)
    u0, v0, w0 = u, v, w
    with jax.named_scope("advect_vel"):
        u = _advect3(1, u0, u0, v0, w0, cfg)
        v = _advect3(2, v0, u0, v0, w0, cfg)
        w = _advect3(3, w0, u0, v0, w0, cfg)
    # the post-advect projection is the step's FINAL solve: always at
    # dct_precision, so every step ends at the exact-solve divergence
    with jax.named_scope("project_final"):
        if with_residual:
            u, v, w, res = project3d(u, v, w, cfg, with_residual=True)
        else:
            u, v, w = project3d(u, v, w, cfg)
    with jax.named_scope("advect_scalars"):
        if cfg.diff:
            dens = diffuse3d(0, dens, cfg, cfg.diff)
        if cfg.temp_diff:
            temp = diffuse3d(0, temp, cfg, cfg.temp_diff)
        dens = _advect3(0, dens, u, v, w, cfg)
        temp = _advect3(0, temp, u, v, w, cfg)
    out = GridState3D(u=u, v=v, w=w, dens=dens, temp=temp)
    return (out, res) if with_residual else out


@partial(jax.jit, static_argnames=("cfg", "n_steps"))
def run3d(state: GridState3D, cfg: StamConfig, n_steps: int):
    def body(s, _):
        s, res = step3d(s, cfg, with_residual=True)
        return s, res

    return jax.lax.scan(body, state, None, length=n_steps)


@functools.lru_cache(maxsize=16)
def _jitted_step3d(cfg: StamConfig, with_residual: bool = False):
    return jax.jit(lambda s: step3d(s, cfg, with_residual=with_residual))


@functools.lru_cache(maxsize=16)
def _jitted_step2d(cfg: StamConfig):
    return jax.jit(lambda s, sources: step2d(s, cfg, sources))


def run2d_python(state: GridState2D, cfg: StamConfig, n_steps: int,
                 sources=None, snapshot_every: int = 0, snapshot_fn=None):
    """Python-driven 2D step loop (jit-cached; see run3d_python)."""
    step = _jitted_step2d(cfg)
    for i in range(n_steps):
        state = step(state, sources)
        if (snapshot_fn is not None and snapshot_every > 0
                and (i + 1) % snapshot_every == 0):
            snapshot_fn(i + 1, jax.device_get(state))
    return state


def run3d_python(state: GridState3D, cfg: StamConfig, n_steps: int):
    """Python-driven step loop: the same steps as run3d, one jitted
    dispatch per step (dispatches queue asynchronously; nothing waits
    on the device inside the loop).  Only the final step computes the
    Poisson residual, which per-step would cost ~5 extra full-field
    passes.  Returns (state, residual[-1:] array)."""
    step = _jitted_step3d(cfg)
    for _ in range(max(n_steps - 1, 0)):
        state = step(state)
    state, res = _jitted_step3d(cfg, True)(state)
    return state, jnp.reshape(res, (1,))


@partial(jax.jit, static_argnames=("cfg", "n_steps"))
def run2d(state: GridState2D, cfg: StamConfig, n_steps: int):
    def body(s, _):
        s, res = step2d(s, cfg, with_residual=True)
        return s, res

    return jax.lax.scan(body, state, None, length=n_steps)
