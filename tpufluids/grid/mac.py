"""MAC (staggered-grid) stable-fluids option, 3D.

The collocated Stam scheme (tpufluids.grid.stam) measures divergence
with central differences, whose operator has a checkerboard null space
— the post-projection divergence cannot reach zero no matter how well
the Poisson system is solved (see stam.poisson_residual3d).  The MAC
arrangement stores velocity components on cell faces, so the discrete
divergence (forward face differences) and gradient are exact adjoints
and the projection drives divergence to the linear-solver tolerance.

This module goes beyond the reference's capability set (the reference
has no Eulerian solver at all; the Stam module exists for the
BASELINE.json configs) — it is the production-quality projection
option.  Design:

* ``u`` (n+1, n, n), ``v`` (n, n+1, n), ``w`` (n, n, n+1) face arrays;
  ``dens``/``temp`` (n, n, n) cell arrays.  No ghost layers on faces;
  pressure is solved on a ghosted (n+2)^3 array so the existing
  Jacobi/red-black machinery is reused verbatim (set_bnd(0, p) = homogeneous Neumann).
* boundary conditions: no-flux (normal velocity pinned to 0 on domain
  faces) + free-slip (tangential components unconstrained).
* advection is the same CFL-clamped 27-tap stencil formulation as
  stam.advect3d_stencil, evaluated in each field's own index space
  (face-centered for velocities, cell-centered for scalars).
"""

from __future__ import annotations

from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp

from tpufluids.grid import stam
from tpufluids.state import pytree_dataclass


@pytree_dataclass
class MacState3D:
    u: jax.Array      # (n+1, n, n) x-velocity on x-faces
    v: jax.Array      # (n, n+1, n)
    w: jax.Array      # (n, n, n+1)
    dens: jax.Array   # (n, n, n) cell-centered
    temp: jax.Array


def make_mac3d(cfg: stam.StamConfig) -> MacState3D:
    n = cfg.n
    return MacState3D(
        u=jnp.zeros((n + 1, n, n), jnp.float32),
        v=jnp.zeros((n, n + 1, n), jnp.float32),
        w=jnp.zeros((n, n, n + 1), jnp.float32),
        dens=jnp.zeros((n, n, n), jnp.float32),
        temp=jnp.full((n, n, n), cfg.ambient_temp, jnp.float32))


def _noflux(u, v, w):
    """Pin normal velocities on the six domain faces to zero."""
    u = u.at[0].set(0.0).at[-1].set(0.0)
    v = v.at[:, 0].set(0.0).at[:, -1].set(0.0)
    w = w.at[:, :, 0].set(0.0).at[:, :, -1].set(0.0)
    return u, v, w


def divergence(u, v, w, n):
    """Exact MAC divergence on cells: forward face differences * n
    (h = 1/n)."""
    return ((u[1:] - u[:-1]) + (v[:, 1:] - v[:, :-1])
            + (w[:, :, 1:] - w[:, :, :-1])) * jnp.float32(n)


def _avg_to_u(v, w):
    """Average v and w to u-face positions (interior u-faces only have
    well-defined 4-face stencils; boundary faces are pinned anyway).
    Returns full-shape arrays built with edge clamping."""
    # v at u-face (i, j+.5... ) — average the 4 surrounding v-faces
    vp = jnp.pad(v, ((1, 1), (0, 0), (0, 0)), mode="edge")
    v_u = 0.25 * (vp[:-1, :-1] + vp[:-1, 1:] + vp[1:, :-1] + vp[1:, 1:])
    wp = jnp.pad(w, ((1, 1), (0, 0), (0, 0)), mode="edge")
    w_u = 0.25 * (wp[:-1, :, :-1] + wp[:-1, :, 1:]
                  + wp[1:, :, :-1] + wp[1:, :, 1:])
    return v_u, w_u


def _avg_to_v(u, w):
    up = jnp.pad(u, ((0, 0), (1, 1), (0, 0)), mode="edge")
    u_v = 0.25 * (up[:-1, :-1] + up[1:, :-1] + up[:-1, 1:] + up[1:, 1:])
    wp = jnp.pad(w, ((0, 0), (1, 1), (0, 0)), mode="edge")
    w_v = 0.25 * (wp[:, :-1, :-1] + wp[:, :-1, 1:]
                  + wp[:, 1:, :-1] + wp[:, 1:, 1:])
    return u_v, w_v


def _avg_to_w(u, v):
    up = jnp.pad(u, ((0, 0), (0, 0), (1, 1)), mode="edge")
    u_w = 0.25 * (up[:-1, :, :-1] + up[1:, :, :-1]
                  + up[:-1, :, 1:] + up[1:, :, 1:])
    vp = jnp.pad(v, ((0, 0), (0, 0), (1, 1)), mode="edge")
    v_w = 0.25 * (vp[:, :-1, :-1] + vp[:, 1:, :-1]
                  + vp[:, :-1, 1:] + vp[:, 1:, 1:])
    return u_w, v_w


def _avg_to_cell(u, v, w):
    return (0.5 * (u[1:] + u[:-1]), 0.5 * (v[:, 1:] + v[:, :-1]),
            0.5 * (w[:, :, 1:] + w[:, :, :-1]))


def _advect_stencil(q, ou, ov, ow, dt0):
    """CFL-clamped 27-tap trilinear semi-Lagrangian advection of ``q``
    in its own index space; ``ou/ov/ow`` are the advecting velocity
    sampled at q's positions.  Backtraces are clamped to one cell and
    to the array extent (mirror of stam.advect3d_stencil semantics)."""
    shape = q.shape
    ii = jax.lax.broadcasted_iota(jnp.float32, shape, 0)
    jj = jax.lax.broadcasted_iota(jnp.float32, shape, 1)
    kk = jax.lax.broadcasted_iota(jnp.float32, shape, 2)

    def offs(vel, coord, extent):
        o = jnp.clip(-dt0 * vel, -1.0, 1.0)
        return jnp.clip(o, -coord, extent - 1.0 - coord)

    ox = offs(ou, ii, shape[0])
    oy = offs(ov, jj, shape[1])
    oz = offs(ow, kk, shape[2])

    def shift(a, d, axis):
        if d == 0:
            return a
        pad = [(0, 0)] * 3
        sl = [slice(None)] * 3
        if d > 0:
            pad[axis] = (0, d)
            sl[axis] = slice(d, None)
        else:
            pad[axis] = (-d, 0)
            sl[axis] = slice(0, d)
        return jnp.pad(a[tuple(sl)], pad, mode="edge")

    def hat(o, d):
        return jnp.maximum(0.0, 1.0 - jnp.abs(o - d))

    out = jnp.zeros_like(q)
    for dx in (-1, 0, 1):
        wx = hat(ox, dx)
        qx = shift(q, dx, 0)
        for dy in (-1, 0, 1):
            wxy = wx * hat(oy, dy)
            qxy = shift(qx, dy, 1)
            for dz in (-1, 0, 1):
                out = out + wxy * hat(oz, dz) * shift(qxy, dz, 2)
    return out


def project(u, v, w, cfg: stam.StamConfig, with_residual: bool = False):
    """MAC pressure projection.  div and p live on a ghosted (n+2)^3
    array so stam's lin_solve machinery applies unchanged; set_bnd(0, .) = homogeneous
    Neumann, the physical BC for no-flux walls."""
    n = cfg.n
    h = 1.0 / n
    div_i = divergence(u, v, w, n)
    div = jnp.zeros((n + 2,) * 3, jnp.float32)
    div = stam.set_bnd3d(0, div.at[1:-1, 1:-1, 1:-1].set(-h * h * div_i))
    if cfg.projection == "multigrid":
        p = stam.mg_solve3d(div, cfg)
    elif cfg.projection == "dct":
        p = stam.dct_solve3d(div, cfg)
    else:
        p = stam.lin_solve3d(0, jnp.zeros_like(div), div, 1.0, 6.0,
                             cfg.jacobi_iters, red_black=cfg.red_black)
    pi = p[1:-1, 1:-1, 1:-1]
    # subtract the pressure gradient on interior faces (h cancels: p
    # solved in units of h^2 * div)
    u = u.at[1:-1].add(-(pi[1:] - pi[:-1]) * n)
    v = v.at[:, 1:-1].add(-(pi[:, 1:] - pi[:, :-1]) * n)
    w = w.at[:, :, 1:-1].add(-(pi[:, :, 1:] - pi[:, :, :-1]) * n)
    u, v, w = _noflux(u, v, w)
    if with_residual:
        return u, v, w, jnp.max(jnp.abs(divergence(u, v, w, n)))
    return u, v, w


def step3d(state: MacState3D, cfg: stam.StamConfig,
           sources: Optional[dict] = None, with_residual: bool = False):
    """One MAC step: sources -> buoyancy -> project -> advect ->
    project -> scalar advection.  Mirrors stam.step3d's ordering."""
    u, v, w, dens, temp = state.u, state.v, state.w, state.dens, state.temp
    n = cfg.n
    if sources:
        dens = dens + cfg.dt * sources.get("dens", 0.0)
        temp = temp + cfg.dt * sources.get("temp", 0.0)
    if cfg.buoyancy_alpha or cfg.buoyancy_beta:
        f = (-cfg.buoyancy_alpha * dens
             + cfg.buoyancy_beta * (temp - cfg.ambient_temp))
        # cell force averaged to interior w-faces
        w = w.at[:, :, 1:-1].add(cfg.dt * 0.5 * (f[:, :, 1:] + f[:, :, :-1]))
    u, v, w = _noflux(u, v, w)
    u, v, w = project(u, v, w, cfg)

    dt0 = float(cfg.dt) * n
    v_u, w_u = _avg_to_u(v, w)
    u_v, w_v = _avg_to_v(u, w)
    u_w, v_w = _avg_to_w(u, v)
    u2 = _advect_stencil(u, u, v_u, w_u, dt0)
    v2 = _advect_stencil(v, u_v, v, w_v, dt0)
    w2 = _advect_stencil(w, u_w, v_w, w, dt0)
    u, v, w = _noflux(u2, v2, w2)
    if with_residual:
        u, v, w, res = project(u, v, w, cfg, with_residual=True)
    else:
        u, v, w = project(u, v, w, cfg)

    uc, vc, wc = _avg_to_cell(u, v, w)
    dens = _advect_stencil(dens, uc, vc, wc, dt0)
    temp = _advect_stencil(temp, uc, vc, wc, dt0)
    out = MacState3D(u=u, v=v, w=w, dens=dens, temp=temp)
    return (out, res) if with_residual else out


@partial(jax.jit, static_argnames=("cfg", "n_steps"))
def run3d(state: MacState3D, cfg: stam.StamConfig, n_steps: int):
    def body(s, _):
        s, res = step3d(s, cfg, with_residual=True)
        return s, res

    return jax.lax.scan(body, state, None, length=n_steps)


import functools as _functools


@_functools.lru_cache(maxsize=16)
def _jitted_step3d(cfg: stam.StamConfig, with_residual: bool = False):
    return jax.jit(lambda s: step3d(s, cfg, with_residual=with_residual))


def run3d_python(state: MacState3D, cfg: stam.StamConfig, n_steps: int):
    """Python-driven step loop (one jitted dispatch per step; see
    stam.run3d_python).  Returns (state, residual[-1:])."""
    step = _jitted_step3d(cfg)
    for _ in range(max(n_steps - 1, 0)):
        state = step(state)
    state, res = _jitted_step3d(cfg, True)(state)
    return state, jnp.reshape(res, (1,))
