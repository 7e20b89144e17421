"""Sharded 3D stable-fluids step: x-slab decomposition + halo exchange
(BASELINE config 5: 512^3 over a device mesh).

Layout: the global field interior is (n, n+2, n+2) — NO ghost planes
along the sharded x axis (they are materialized locally), ghost layers
kept along y/z.  The array shards evenly along x over the 1-D mesh.
Inside ``shard_map`` each device pads its slab with two halo planes,
refreshed by ``jax.lax.ppermute`` before every stencil application —
the exact communication pattern of the reference's 1-cell-plane halo
buffer (``buffer = GRIDSIZE^2``, solver-unidyn.cu:187), but device to device
instead of host-staged memcpy.

Numerics match the single-device stam.step3d exactly (tests assert
allclose): every Jacobi iteration refreshes halos with the previous
iteration's planes, which is precisely what the dense update reads.
Advection backtraces are clamped to one halo plane across the shard
boundary (CFL <= 1 cell in x across devices).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from tpufluids.grid.stam import GridState3D, StamConfig

AXIS = "x"


# ---------------------------------------------------------------------------
# layout conversion (dense single-device <-> sharded)


def to_sharded_layout(state: GridState3D) -> GridState3D:
    """Strip the x ghost planes: (n+2, n+2, n+2) -> (n, n+2, n+2)."""
    return jax.tree_util.tree_map(lambda a: a[1:-1], state)


def from_sharded_layout(state: GridState3D, cfg: StamConfig) -> GridState3D:
    """Re-attach x ghost planes using set_bnd continuity values."""
    from tpufluids.grid.stam import set_bnd3d

    def pad(a, b):
        full = jnp.pad(a, ((1, 1), (0, 0), (0, 0)))
        return set_bnd3d(b, full)

    return GridState3D(
        u=pad(state.u, 1), v=pad(state.v, 2), w=pad(state.w, 3),
        dens=pad(state.dens, 0), temp=pad(state.temp, 0))


def shard_state(state: GridState3D, mesh: Mesh) -> GridState3D:
    sh = NamedSharding(mesh, P(AXIS, None, None))
    return jax.tree_util.tree_map(lambda a: jax.device_put(a, sh), state)


# ---------------------------------------------------------------------------
# local (per-shard) primitives


def _halo_exchange(a, sx, n_dev):
    """Pad the local slab (c, Y, Z) to (c+2, Y, Z) with neighbor planes;
    domain edges get the set_bnd x-face values (scale sx)."""
    idx = jax.lax.axis_index(AXIS)
    if n_dev > 1:
        right = [(i, (i + 1) % n_dev) for i in range(n_dev)]
        left = [(i, (i - 1) % n_dev) for i in range(n_dev)]
        from_left = jax.lax.ppermute(a[-1:], AXIS, right)   # neighbor's last
        from_right = jax.lax.ppermute(a[:1], AXIS, left)    # neighbor's first
    else:
        from_left = a[-1:]
        from_right = a[:1]
    lo = jnp.where(idx == 0, sx * a[:1], from_left)
    hi = jnp.where(idx == n_dev - 1, sx * a[-1:], from_right)
    return jnp.concatenate([lo, a, hi], axis=0)


def _set_bnd_yz(b, x):
    """y/z faces of set_bnd3d on a local block (x faces are handled by
    the halo exchange)."""
    sy = -1.0 if b == 2 else 1.0
    sz = -1.0 if b == 3 else 1.0
    x = x.at[:, 0, :].set(sy * x[:, 1, :])
    x = x.at[:, -1, :].set(sy * x[:, -2, :])
    x = x.at[:, :, 0].set(sz * x[:, :, 1])
    x = x.at[:, :, -1].set(sz * x[:, :, -2])
    return x


def _bnd(b, a, n_dev):
    """Full set_bnd3d on a local slab WITHOUT x ghosts: returns the slab
    with y/z faces set (x faces live in the halo pad)."""
    return _set_bnd_yz(b, a)


def _halo(b, a, n_dev):
    """set_bnd + halo pad: returns (c+2, Y, Z) ready for a stencil."""
    sx = -1.0 if b == 1 else 1.0
    a = _set_bnd_yz(b, a)
    return _halo_exchange(a, sx, n_dev)


def _lin_solve_local(b, x, x0, a, c, iters, n_dev, red_black=False):
    c_inv = 1.0 / c

    def jacobi(x):
        xp = _halo(b, x, n_dev)
        nb = (xp[:-2, 1:-1, 1:-1] + xp[2:, 1:-1, 1:-1]
              + xp[1:-1, :-2, 1:-1] + xp[1:-1, 2:, 1:-1]
              + xp[1:-1, 1:-1, :-2] + xp[1:-1, 1:-1, 2:])
        return x.at[:, 1:-1, 1:-1].set((x0[:, 1:-1, 1:-1] + a * nb) * c_inv)

    if not red_black:
        def body(_, x):
            return _set_bnd_yz(b, jacobi(x))
        return jax.lax.fori_loop(0, iters, body, x)

    # red-black parity must be computed in GLOBAL x coordinates
    c_local = x.shape[0]
    gx0 = jax.lax.axis_index(AXIS) * c_local
    shape = (c_local, x.shape[1] - 2, x.shape[2] - 2)
    # 0-based interior indices to match the dense _checker parity
    i = jax.lax.broadcasted_iota(jnp.int32, shape, 0) + gx0
    j = jax.lax.broadcasted_iota(jnp.int32, shape, 1)
    k = jax.lax.broadcasted_iota(jnp.int32, shape, 2)
    mask0 = ((i + j + k) % 2) == 0

    def body_rb(_, x):
        for parity in (0, 1):
            new = jacobi(x)
            m = mask0 if parity == 0 else ~mask0
            x = x.at[:, 1:-1, 1:-1].set(
                jnp.where(m, new[:, 1:-1, 1:-1], x[:, 1:-1, 1:-1]))
            x = _set_bnd_yz(b, x)
        return x

    return jax.lax.fori_loop(0, iters, body_rb, x)


def _advect_local(b, q, u, v, w, cfg, n_dev, n):
    """Semi-Lagrangian advection on a local slab; backtraces clamp to
    the one-plane halo across the shard boundary.

    NOTE: the slab step always uses this GATHER formulation regardless
    of cfg.advect_mode — with ``advect_mode="stencil"`` it matches the
    dense stencil path only away from domain edges (the two
    formulations clamp edge backtraces differently, a few % on edge
    cells)."""
    c_local = q.shape[0]
    dt0 = cfg.dt * n
    gx0 = jax.lax.axis_index(AXIS) * c_local  # global x of local row 0
    qp = _halo(b, q, n_dev)  # (c+2, Y, Z); local row i -> qp row i+1
    shape = (c_local, n, n)
    ii = jax.lax.broadcasted_iota(jnp.float32, shape, 0)
    jj = jax.lax.broadcasted_iota(jnp.float32, shape, 1) + 1.0
    kk = jax.lax.broadcasted_iota(jnp.float32, shape, 2) + 1.0
    gi = ii + gx0.astype(jnp.float32) + 1.0  # global x coordinate

    x = jnp.clip(gi - dt0 * u[:, 1:-1, 1:-1], 0.5, n + 0.5)
    y = jnp.clip(jj - dt0 * v[:, 1:-1, 1:-1], 0.5, n + 0.5)
    z = jnp.clip(kk - dt0 * w[:, 1:-1, 1:-1], 0.5, n + 0.5)
    # local coordinate into the halo-padded block qp (row r = global
    # row gx0 + r).  With the one-plane halo, backtraces of up to one
    # cell across the shard boundary are exact (the i0 clamp keeps the
    # lx == c+1 edge interpolating rows c / c+1 with weight 1); longer
    # backtraces clamp to the halo (CFL <= 1 plane in x).
    lx = jnp.clip(x - gx0, 0.0, c_local + 1.0)

    i0 = jnp.clip(jnp.floor(lx).astype(jnp.int32), 0, c_local)
    j0 = jnp.floor(y).astype(jnp.int32)
    k0 = jnp.floor(z).astype(jnp.int32)
    s1, t1, r1 = lx - i0, y - j0, z - k0
    s0, t0, r0 = 1 - s1, 1 - t1, 1 - r1

    def g(di, dj, dk):
        return qp[jnp.clip(i0 + di, 0, c_local + 1), j0 + dj, k0 + dk]

    out = (s0 * (t0 * (r0 * g(0, 0, 0) + r1 * g(0, 0, 1))
                 + t1 * (r0 * g(0, 1, 0) + r1 * g(0, 1, 1)))
           + s1 * (t0 * (r0 * g(1, 0, 0) + r1 * g(1, 0, 1))
                   + t1 * (r0 * g(1, 1, 0) + r1 * g(1, 1, 1))))
    return _set_bnd_yz(b, q.at[:, 1:-1, 1:-1].set(out))


def _dct_solve_local(x0, n, n_dev, cfg=None, final=True):
    """Sharded spectral projection solve (stam._dct_solve_interior over
    x-slabs): y/z cosine transforms are local matmuls; the x transform
    contracts the sharded axis as a per-device partial matmul followed
    by ``psum_scatter`` — one reduce-scatter each way, versus
    the iterative solver's 2 halo exchanges per iteration."""
    from tpufluids.grid.stam import _DCT_PREC, _dct_axis, _dct_mats, \
        _dct_params

    prec = _DCT_PREC[_dct_params(cfg, final)[0]]
    c = x0.shape[0]
    off = jax.lax.axis_index(AXIS) * c
    xi = x0[:, 1:-1, 1:-1]
    C, Ci, lam1 = _dct_mats(n)

    def xmul(a, m):
        cols = jax.lax.dynamic_slice_in_dim(m, off, c, axis=1)
        part = jnp.tensordot(cols, a, axes=((1,), (0,)),
                             precision=prec)
        if n_dev == 1:
            return part
        return jax.lax.psum_scatter(part, AXIS, scatter_dimension=0,
                                    tiled=True)

    def t_ax(a, m, ax):
        return _dct_axis(a, m, ax, prec)

    F = xmul(xi, C)
    F = t_ax(F, C, 1)
    F = t_ax(F, C, 2)
    lam = (jax.lax.dynamic_slice_in_dim(lam1, off, c)[:, None, None]
           + lam1[None, :, None] + lam1[None, None, :])
    coef = F / jnp.where(lam == 0.0, 1.0, lam)
    # zero the global (0,0,0) gauge mode (lives on device 0's slab)
    gauge = ((jnp.arange(c)[:, None, None] + off == 0)
             & (jnp.arange(n)[None, :, None] == 0)
             & (jnp.arange(n)[None, None, :] == 0))
    coef = jnp.where(gauge, 0.0, coef)
    sol = xmul(coef, Ci)
    sol = t_ax(sol, Ci, 1)
    sol = t_ax(sol, Ci, 2)
    p = jnp.zeros_like(x0).at[:, 1:-1, 1:-1].set(sol)
    return _set_bnd_yz(0, p)


def _divergence_local(u, v, w, n, n_dev):
    h = 1.0 / n
    up = _halo(1, u, n_dev)
    return -0.5 * h * (
        up[2:, 1:-1, 1:-1] - up[:-2, 1:-1, 1:-1]
        + v[:, 2:, 1:-1] - v[:, :-2, 1:-1]
        + w[:, 1:-1, 2:] - w[:, 1:-1, :-2])


def _project_local(u, v, w, cfg, n, n_dev, with_residual=True,
                   final=True):
    h = 1.0 / n
    div = jnp.zeros_like(u).at[:, 1:-1, 1:-1].set(
        _divergence_local(u, v, w, n, n_dev))
    div = _set_bnd_yz(0, div)
    if cfg.projection == "dct":
        p = _dct_solve_local(div, n, n_dev, cfg, final)
    else:
        p = _lin_solve_local(0, jnp.zeros_like(u), div, 1.0, 6.0,
                             cfg.jacobi_iters, n_dev,
                             red_black=cfg.red_black)
    pp = _halo(0, p, n_dev)
    u = u.at[:, 1:-1, 1:-1].add(
        -0.5 * (pp[2:, 1:-1, 1:-1] - pp[:-2, 1:-1, 1:-1]) / h)
    v = v.at[:, 1:-1, 1:-1].add(-0.5 * (p[:, 2:, 1:-1] - p[:, :-2, 1:-1]) / h)
    w = w.at[:, 1:-1, 1:-1].add(-0.5 * (p[:, 1:-1, 2:] - p[:, 1:-1, :-2]) / h)
    u = _set_bnd_yz(1, u)
    v = _set_bnd_yz(2, v)
    w = _set_bnd_yz(3, w)
    if not with_residual:
        return u, v, w, jnp.float32(0)
    # Poisson residual (global max via pmax), reusing the halo'd p
    nb = (pp[:-2, 1:-1, 1:-1] + pp[2:, 1:-1, 1:-1]
          + pp[1:-1, :-2, 1:-1] + pp[1:-1, 2:, 1:-1]
          + pp[1:-1, 1:-1, :-2] + pp[1:-1, 1:-1, 2:])
    res = jnp.max(jnp.abs(div[:, 1:-1, 1:-1] + nb - 6.0 * p[:, 1:-1, 1:-1]))
    res = jax.lax.pmax(res, AXIS)
    return u, v, w, res


def _vorticity_local(u, v, w, cfg, n, n_dev):
    """Sharded twin of stam.vorticity_confinement3d: identical stencil
    arithmetic on the halo-padded slab.  x ghosts are materialized
    directly from the neighbor/face values WITHOUT re-running set_bnd
    (the dense version reads whatever ghosts the previous set_bnd3d
    left, which the sx-scaled face value reproduces exactly)."""
    h = 1.0 / n
    up = _halo_exchange(u, -1.0, n_dev)
    vp = _halo_exchange(v, 1.0, n_dev)
    wp = _halo_exchange(w, 1.0, n_dev)

    def dx(q):
        return 0.5 * (q[2:, 1:-1, 1:-1] - q[:-2, 1:-1, 1:-1]) / h

    def dy(q):
        return 0.5 * (q[1:-1, 2:, 1:-1] - q[1:-1, :-2, 1:-1]) / h

    def dz(q):
        return 0.5 * (q[1:-1, 1:-1, 2:] - q[1:-1, 1:-1, :-2]) / h

    wx = dy(wp) - dz(vp)
    wy = dz(up) - dx(wp)
    wz = dx(vp) - dy(up)
    mag_i = jnp.sqrt(wx * wx + wy * wy + wz * wz)
    # dense keeps mag's ghost shell at 0 (zeros_like + interior set):
    # local slab rows are all dense-interior, y/z ghosts zero, and the
    # x halo at the domain edge is the dense ghost plane = 0.
    mag = jnp.zeros_like(u).at[:, 1:-1, 1:-1].set(mag_i)
    magp = _halo_exchange(mag, 0.0, n_dev)
    gx, gy, gz = dx(magp), dy(magp), dz(magp)
    norm = jnp.sqrt(gx * gx + gy * gy + gz * gz) + 1e-5
    gx, gy, gz = gx / norm, gy / norm, gz / norm
    eps_h = cfg.vorticity_eps * h
    u = u.at[:, 1:-1, 1:-1].add(cfg.dt * eps_h * (gy * wz - gz * wy))
    v = v.at[:, 1:-1, 1:-1].add(cfg.dt * eps_h * (gz * wx - gx * wz))
    w = w.at[:, 1:-1, 1:-1].add(cfg.dt * eps_h * (gx * wy - gy * wx))
    return _set_bnd_yz(1, u), _set_bnd_yz(2, v), _set_bnd_yz(3, w)


def _step_local(u, v, w, dens, temp, cfg: StamConfig, n: int, n_dev: int,
                with_residual=True):
    if cfg.buoyancy_alpha or cfg.buoyancy_beta:
        f = (-cfg.buoyancy_alpha * dens[:, 1:-1, 1:-1]
             + cfg.buoyancy_beta * (temp[:, 1:-1, 1:-1] - cfg.ambient_temp))
        w = _set_bnd_yz(3, w.at[:, 1:-1, 1:-1].add(cfg.dt * f))
    if cfg.vorticity_eps:
        u, v, w = _vorticity_local(u, v, w, cfg, n, n_dev)
    if cfg.visc:
        a = cfg.dt * cfg.visc * n * n
        u = _lin_solve_local(1, u, u, a, 1 + 6 * a, cfg.jacobi_iters, n_dev)
        v = _lin_solve_local(2, v, v, a, 1 + 6 * a, cfg.jacobi_iters, n_dev)
        w = _lin_solve_local(3, w, w, a, 1 + 6 * a, cfg.jacobi_iters, n_dev)
    u, v, w, _ = _project_local(u, v, w, cfg, n, n_dev,
                                with_residual=False, final=False)
    u0, v0, w0 = u, v, w
    u = _advect_local(1, u0, u0, v0, w0, cfg, n_dev, n)
    v = _advect_local(2, v0, u0, v0, w0, cfg, n_dev, n)
    w = _advect_local(3, w0, u0, v0, w0, cfg, n_dev, n)
    u, v, w, res = _project_local(u, v, w, cfg, n, n_dev,
                                  with_residual=with_residual)
    if cfg.diff:
        a = cfg.dt * cfg.diff * n * n
        dens = _lin_solve_local(0, dens, dens, a, 1 + 6 * a,
                                cfg.jacobi_iters, n_dev)
    dens = _advect_local(0, dens, u, v, w, cfg, n_dev, n)
    if cfg.temp_diff:
        a = cfg.dt * cfg.temp_diff * n * n
        temp = _lin_solve_local(0, temp, temp, a, 1 + 6 * a,
                                cfg.jacobi_iters, n_dev)
    temp = _advect_local(0, temp, u, v, w, cfg, n_dev, n)
    return u, v, w, dens, temp, res


def make_sharded_step(mesh: Mesh, cfg: StamConfig, n_steps: int = 1):
    """Build a jitted sharded scan of ``n_steps`` 3D steps.

    Takes/returns GridState3D in sharded layout ((n, n+2, n+2) fields,
    sharded along x).  Also returns the last step's Poisson residual."""
    n_dev = mesh.devices.size
    n = cfg.n
    if n % n_dev:
        raise ValueError(f"n={n} must divide over {n_dev} devices")
    if cfg.projection not in ("jacobi", "dct"):
        # silent fallback to jacobi would ignore the user's choice
        # (advisor finding r1); a sharded multigrid is not implemented.
        raise ValueError(
            f"sharded step supports projection in ('jacobi', 'dct'), "
            f"got {cfg.projection!r}")
    spec = P(AXIS, None, None)

    @partial(jax.shard_map, mesh=mesh,
             in_specs=(spec,) * 5, out_specs=((spec,) * 5, P()))
    def run_local(u, v, w, dens, temp):
        def body(carry, _):
            u, v, w, dens, temp, _ = _step_local(
                *carry, cfg, n, n_dev, with_residual=False)
            return (u, v, w, dens, temp), None

        # residual on the FINAL step only (matches stam.run3d_python):
        # computing it per scan step costs ~5 extra full-array passes
        carry, _ = jax.lax.scan(
            body, (u, v, w, dens, temp), None, length=n_steps - 1)
        u, v, w, dens, temp, res = _step_local(*carry, cfg, n, n_dev,
                                               with_residual=True)
        return (u, v, w, dens, temp), res

    @jax.jit
    def step(state: GridState3D):
        (u, v, w, dens, temp), res = run_local(
            state.u, state.v, state.w, state.dens, state.temp)
        return GridState3D(u=u, v=v, w=w, dens=dens, temp=temp), res

    return step
