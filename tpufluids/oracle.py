"""O(N^2) NumPy reference oracle.

The reference has no tests (SURVEY.md §4); this module is the
correctness pin for this implementation.  It computes one full
physics step for both variants with dense all-pairs math in float64,
following the exact formula set and operation ordering of the CUDA
kernels:

* pair accumulation:  FluidGPU.cu:224-281 (base),
                      FluidGPU-unidyn.cu:249-406 (unidyn)
* granular stress:    FluidGPU-unidyn.cu:410-446
* particle update:    FluidGPU.cuh:270-304 (base),
                      FluidGPU-unidyn.cuh:296-423 (unidyn)

``mask_mode`` selects which pairs interact:
* "radius":  every pair with 0 < ds <= 2h (ideal physics)
* "stencil": additionally require the pair's cells to be within the
  27-cell stencil (|dcx|,|dcy|,|dcz| <= 1) — this reproduces the
  reference's binned truncation (with cell_size < support the stencil
  genuinely drops far neighbors, e.g. base: 0.05 < 0.12) and is what
  the binned implementation computes.
* "subbin": additionally, particles whose home cell population exceeds
  ``subbin_threshold`` use the octant 8-cell stencil of the fine force
  kernel (FluidGPU-unidyn.cu:579-583, 675-677) instead of the 27-cell
  one — the reference's adaptive two-level binning semantics.

Determinism notes (deviations from the reference, by design):
* the reference accumulates with atomicAdd and *reads* drift
  velocities, diffusion and stress tensors while other threads write
  them (order-dependent results).  The oracle (and the JAX build)
  resolve the race deterministically: drift velocities are fully
  accumulated first, then the mixture/transport terms that consume
  them (pass B), then the per-particle granular update.
* the unidyn coarse kernel indexes the viscosity mass by the sorted
  slot instead of the particle (``SPptr[i].mass`` vs ``SPptr[ii]``,
  FluidGPU-unidyn.cu:307); all masses are 1 in the shipped scenes, so
  we use the particle's own mass.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np

from tpufluids.config import PI_REF, SPHConfig

# ---------------------------------------------------------------------------
# smoothing kernels (float64 mirrors of tpufluids.kernels)


def w_cubic_np(r, h):
    q = r / h
    inner = 1.0 - 1.5 * q * q + 0.75 * q ** 3
    outer = 0.25 * (2.0 - q) ** 3
    return np.where(q <= 1.0, inner, np.where(q < 2.0, outer, 0.0)) / (
        PI_REF * h ** 3)


def grad_w_spiky_np(r, h):
    return np.where(r < h, -45.0 / (PI_REF * h ** 6) * (h - r) ** 2, 0.0)


# ---------------------------------------------------------------------------


def cell_coords_np(pos, cfg: SPHConfig):
    """Per-axis cell coordinates with C-style truncation toward zero
    (the ``int(...)`` casts at FluidGPU.cu:419, solver.cu:119)."""
    cx = np.trunc((pos[:, 0] - cfg.xmin) / cfg.cell_size).astype(np.int64)
    cy = np.trunc((pos[:, 1] - cfg.ymin) / cfg.cell_size).astype(np.int64)
    cz = np.trunc((pos[:, 2] - cfg.zmin) / cfg.cell_size).astype(np.int64)
    return cx, cy, cz


def octant_np(pos, cfg: SPHConfig):
    """Sub-bin octant id (FluidGPU-unidyn.cu:182-184): bit0 = x in upper
    half of its cell, bit1 = y upper half, bit2 = z in *lower* half."""
    cs = cfg.cell_size
    bx = (np.trunc((pos[:, 0] - cfg.xmin) / cs)
          != np.trunc((pos[:, 0] - cfg.xmin + cs / 2) / cs)).astype(int)
    by = (np.trunc((pos[:, 1] - cfg.ymin) / cs)
          != np.trunc((pos[:, 1] - cfg.ymin + cs / 2) / cs)).astype(int)
    bz = (np.trunc((pos[:, 2] - cfg.zmin) / cs)
          == np.trunc((pos[:, 2] - cfg.zmin + cs / 2) / cs)).astype(int)
    return bx + 2 * by + 4 * bz


@dataclass
class OracleAccum:
    """Per-step pair accumulators (the reference's ``new*`` fields)."""
    sum_w: np.ndarray
    dpress: np.ndarray
    diffusion: np.ndarray
    vel_grad: np.ndarray
    stress_accel: np.ndarray
    solid_drift: np.ndarray
    fluid_drift: np.ndarray
    mixture_accel: np.ndarray
    delsolid: np.ndarray
    delfluid: np.ndarray
    split_trigger: np.ndarray = field(default=None)


def _pair_mask(state, cfg: SPHConfig, mask_mode: str,
               subbin_threshold: int = 6):
    pos = state["pos"]
    n = pos.shape[0]
    rab = pos[:, None, :] - pos[None, :, :]          # x_i - x_j
    ds = np.sqrt(np.sum(rab * rab, axis=-1))
    alive = state["alive"]
    mask = (ds > 0) & (ds <= 2 * cfg.cutoff)
    mask &= alive[:, None] & alive[None, :]
    if mask_mode == "radius":
        return mask, rab, ds
    cx, cy, cz = cell_coords_np(pos, cfg)
    g = cfg.grid_size
    in_dom = (cx >= 0) & (cx < g) & (cy >= 0) & (cy < g) & (cz >= 0) & (cz < g)
    dcx = cx[None, :] - cx[:, None]   # cell_j - cell_i per axis
    dcy = cy[None, :] - cy[:, None]
    dcz = cz[None, :] - cz[:, None]
    stencil = ((np.abs(dcx) <= 1) & (np.abs(dcy) <= 1) & (np.abs(dcz) <= 1)
               & in_dom[:, None] & in_dom[None, :])
    mask &= stencil
    if mask_mode == "stencil":
        return mask, rab, ds
    assert mask_mode == "subbin"
    # population of each particle's home cell (alive + in-domain only)
    cid = cx * g * g + cy * g + cz
    cid = np.where(in_dom & alive, cid, -1)
    pop = np.zeros(n, np.int64)
    uniq, counts = np.unique(cid[cid >= 0], return_counts=True)
    lut = dict(zip(uniq.tolist(), counts.tolist()))
    for i in range(n):
        pop[i] = lut.get(int(cid[i]), 0)
    overfull = pop > subbin_threshold
    o = octant_np(pos, cfg)
    dirx = np.where(o & 1, 1, -1)
    diry = np.where(o & 2, 1, -1)
    dirz = np.where(o & 4, -1, 1)     # z bit set = lower half -> look -z
    octant_ok = (((dcx == 0) | (dcx == dirx[:, None]))
                 & ((dcy == 0) | (dcy == diry[:, None]))
                 & ((dcz == 0) | (dcz == dirz[:, None])))
    mask &= np.where(overfull[:, None], octant_ok, True)
    return mask, rab, ds


def accumulate(state, cfg: SPHConfig, mask_mode: str = "radius",
               subbin_threshold: int = 6) -> OracleAccum:
    """Dense pair accumulation for one step (both passes)."""
    n = state["pos"].shape[0]
    h = cfg.cutoff
    mask, rab, ds = _pair_mask(state, cfg, mask_mode, subbin_threshold)
    ds_safe = np.where(ds > 0, ds, 1.0)

    vel = state["vel"]
    vab = vel[:, None, :] - vel[None, :, :]
    w = np.where(mask, w_cubic_np(ds, h), 0.0)
    dk = (grad_w_spiky_np(ds, h) / ds_safe)[:, :, None] * rab
    dk = np.where(mask[:, :, None], dk, 0.0)

    dens = state["dens"]
    press = state["press"]
    bnd = state["boundary"].astype(bool)
    mass = state["mass"]
    solid = state["solid"]
    fluid = state["fluid"]

    d = np.sum(vab * rab, axis=-1)
    d2 = ds * ds
    mu = h * (d / (d2 + 0.01 * h * h))
    rho_bar = (dens[:, None] + dens[None, :]) / 2.0
    nb_bnd = (~bnd[:, None]) & bnd[None, :]   # i fluid, j boundary

    if cfg.variant == "base":
        # inline viscosity with quadratic term (FluidGPU.cu:255)
        s = (cfg.alpha_fluid * cfg.sound
             * (mu + cfg.visc_quadratic / cfg.sound * mu ** 2) / rho_bar
             * (d < 0) * (1.0 + nb_bnd * cfg.alpha_boundary))
        mass_j = np.ones_like(w)
    else:
        # unidyn viscosity (FluidGPU-unidyn.cu:307): solid-amplified alpha,
        # mass-weighted linear term, fluid^2-amplified boundary factor
        alpha_i = (solid[:, None] * 9.0 + 1.0) * cfg.alpha_fluid
        bfac = 1.0 + nb_bnd * ((1.0 + 3.0 * fluid[:, None] ** 2)
                               * cfg.alpha_sand_boundary)
        s = (alpha_i * cfg.sound
             * (mass[:, None] * mu + cfg.visc_quadratic / cfg.sound * mu ** 2)
             / rho_bar * (d < 0) * bfac)
        mass_j = np.broadcast_to(mass[None, :], w.shape)

    p_term = (press[None, :] / dens[None, :] ** 2
              + press[:, None] / dens[:, None] ** 2 + s)
    dp = p_term[:, :, None] * dk

    acc = OracleAccum(
        sum_w=np.sum(np.where(mask, w * (1.0 + nb_bnd * cfg.bdensfactor)
                              * mass_j, 0.0), axis=1),
        dpress=np.sum(np.where(mask[:, :, None], dp * mass_j[:, :, None], 0.0),
                      axis=1),
        diffusion=np.zeros((n, 3)),
        vel_grad=np.zeros((n, 3, 3)),
        stress_accel=np.zeros((n, 3)),
        solid_drift=np.zeros((n, 3)),
        fluid_drift=np.zeros((n, 3)),
        mixture_accel=np.zeros((n, 3)),
        delsolid=np.zeros(n),
        delfluid=np.zeros(n),
        split_trigger=np.zeros(n, bool),
    )
    if cfg.variant == "base":
        return acc

    # ---- unidyn extras (FluidGPU-unidyn.cu:314-406) -----------------------
    both_fluid = (~bnd[:, None]) & (~bnd[None, :])
    mj = mass[None, :]
    acc.diffusion = np.sum(
        np.where((mask & both_fluid)[:, :, None],
                 (mj / dens[None, :])[:, :, None] * dk, 0.0), axis=1)

    # velocity gradient & stress accel, gated by mixfactor
    mixfactor = (both_fluid * (solid[:, None] > 0) * (solid[None, :] > 0)
                 * 2.0 * solid[:, None] * solid[None, :]
                 / (solid[:, None] + solid[None, :] + cfg.mixfactor_reg))
    for a in range(3):
        for b in range(3):
            acc.vel_grad[:, a, b] = np.sum(
                np.where(mask, -mixfactor * vab[:, :, b] * dk[:, :, a]
                         / dens[:, None], 0.0), axis=1)
    sig = state["stress"]
    sig_dk = np.einsum("iab,ijb->ija", sig, dk)   # sigma_i[a,:] . dk
    acc.stress_accel = np.sum(
        np.where(mask[:, :, None],
                 (1.0 + mixfactor)[:, :, None] * sig_dk
                 / (dens[:, None, None] ** 2), 0.0), axis=1)

    # pass A: drift velocities (gated by mass fractions + both non-boundary)
    denom = cfg.rho0_sand * solid + cfg.rho0 * fluid
    denom = np.where(denom == 0, 1.0, denom)
    msf = solid * cfg.rho0_sand / denom
    mff = fluid * cfg.rho0 / denom
    gate = ((msf > cfg.mix_frac_min) & (msf < cfg.mix_frac_max)
            & (mff > cfg.mix_frac_min) & (mff < cfg.mix_frac_max))
    pair_gate = mask & both_fluid & gate[:, None]

    si, sj = solid[:, None], solid[None, :]
    fi, fj = fluid[:, None], fluid[None, :]
    pi_, pj = press[:, None], press[None, :]
    s_safe = np.where(solid == 0, 1.0, solid)
    f_safe = np.where(fluid == 0, 1.0, fluid)
    msf_i, mff_i = msf[:, None], mff[:, None]
    sg = (sj - si)[:, :, None] * dk
    fg = (fj - fi)[:, :, None] * dk
    sbrown = (sg / s_safe[:, None, None] * (1 - msf_i)[:, :, None]
              - mff_i[:, :, None] * fg / f_safe[:, None, None])
    fbrown = (fg / f_safe[:, None, None] * (1 - mff_i)[:, :, None]
              - msf_i[:, :, None] * sg / s_safe[:, None, None])
    A = (si * pi_ - sj * pj)[:, :, None] * dk
    B = (fi * pi_ - fj * pj)[:, :, None] * dk
    sslip = A * (1 - msf_i)[:, :, None] - mff_i[:, :, None] * B
    fslip = B * (1 - mff_i)[:, :, None] - msf_i[:, :, None] * A
    v_dk = np.einsum("ia,ija->ij", vel, dk)       # v_i . dk
    body_core = np.concatenate(
        [
            (150.0 / dens)[:, None, None]
            * state["delpress"][:, None, :2] * np.ones_like(dk[:, :, :2]),
            cfg.gravity + (150.0 / dens)[:, None, None]
            * state["delpress"][:, None, 2:3] * np.ones_like(dk[:, :, 2:3]),
        ],
        axis=-1,
    ) - v_dk[:, :, None] * vab
    s_pref = (dens * (solid - msf * solid - mff * fluid))[:, None, None]
    f_pref = (dens * (fluid - msf * solid - mff * fluid))[:, None, None]
    g3 = pair_gate[:, :, None]
    acc.solid_drift = np.sum(
        np.where(g3, cfg.mixpressure * (s_pref * body_core + sslip)
                 - cfg.mixbrownian * sbrown, 0.0), axis=1)
    acc.fluid_drift = np.sum(
        np.where(g3, cfg.mixpressure * (f_pref * body_core + fslip)
                 - cfg.mixbrownian * fbrown, 0.0), axis=1)

    # pass B: mixture accel + phase transport, consuming the completed
    # drift velocities (deterministic resolution of the reference's race)
    sdv, fdv = acc.solid_drift, acc.fluid_drift
    ds_i = np.einsum("ia,ija->ij", sdv, dk)
    ds_j = np.einsum("ja,ija->ij", sdv, dk)
    df_i = np.einsum("ia,ija->ij", fdv, dk)
    df_j = np.einsum("ja,ija->ij", fdv, dk)
    term = (sj * dens[None, :])[:, :, None] * (
        sj[:, :, None] * sdv[None, :, :] * ds_j[:, :, None]
        + si[:, :, None] * sdv[:, None, :] * ds_i[:, :, None]
    ) + (fj * dens[None, :])[:, :, None] * (
        fj[:, :, None] * fdv[None, :, :] * df_j[:, :, None]
        + fi[:, :, None] * fdv[:, None, :] * df_i[:, :, None]
    )
    acc.mixture_accel = np.sum(
        np.where(mask[:, :, None],
                 -term / (dens[:, None] * dens[None, :])[:, :, None], 0.0),
        axis=1)
    dk_vab = np.sum(dk * vab, axis=-1)
    # the velocity-divergence part is boundary-gated; the drift part is not
    # (operator precedence at FluidGPU-unidyn.cu:400-401)
    drift_s = np.einsum("ija,ija->ij",
                        (si[:, :, None] * sdv[:, None, :]
                         + sj[:, :, None] * sdv[None, :, :]), dk)
    drift_f = np.einsum("ija,ija->ij",
                        (fi[:, :, None] * fdv[:, None, :]
                         + fj[:, :, None] * fdv[None, :, :]), dk)
    acc.delsolid = np.sum(
        np.where(mask,
                 both_fluid * (-0.5 / dens[None, :]) * (si + sj) * dk_vab
                 + (-drift_s) / dens[None, :], 0.0), axis=1)
    acc.delfluid = np.sum(
        np.where(mask,
                 both_fluid * (-0.5 / dens[None, :]) * (fi + fj) * dk_vab
                 + (-drift_f) / dens[None, :], 0.0), axis=1)

    # split trigger (FluidGPU-unidyn.cu:278-285): uses previous-step dens
    # and this step's diffusion; requires at least one in-range pair
    has_pair = np.any(mask, axis=1)
    diff2 = np.sum(acc.diffusion ** 2, axis=-1)
    acc.split_trigger = (has_pair & (mass > cfg.split_mass_min) & (~bnd)
                         & ((diff2 > cfg.split_diffusion_min)
                            | (dens < cfg.split_dens_max)))
    return acc


def granular_update(state, acc: OracleAccum, cfg: SPHConfig):
    """Per-particle strain-rate / yield / stress-rate pass
    (FluidGPU-unidyn.cu:410-446).  Returns (stress_scaled, stress_rate)."""
    n = state["pos"].shape[0]
    sig = state["stress"].copy()
    vg = acc.vel_grad
    sr = 0.5 * (vg + np.transpose(vg, (0, 2, 1)))
    tr = np.trace(sr, axis1=1, axis2=2)
    tr3 = 0.5 * np.sum(sig * sig, axis=(1, 2))
    tr5 = np.sum(sr * sr, axis=(1, 2))
    tr4 = np.einsum("ipq,iqp->i", sig, sr)
    press = state["press"]
    ylim = (3.0 * math.tan(cfg.phi) / cfg.yield_denom * press * (press > 0)
            + cfg.kc / cfg.yield_denom)
    scale = np.where((ylim < tr3) & (tr3 != 0),
                     ylim / np.where(tr3 == 0, 1.0, tr3), 1.0)
    active = state["solid"] != 0
    sig = np.where(active[:, None, None], sig * scale[:, None, None], sig)
    eye = np.eye(3)[None]
    rate = (3.0 * cfg.c1 * press[:, None, None]
            * (sr - tr[:, None, None] / 3.0 * eye)
            + cfg.c1 * cfg.c2 * ((tr4 + tr * press * (press > 0))
                                 / (press ** 2 + cfg.stress_rate_reg)
                                 )[:, None, None] * sig
            - cfg.c1 * cfg.c3 * np.sqrt(tr5)[:, None, None] * sig)
    rate = np.where(active[:, None, None], rate, 0.0)
    return sig, rate


def oracle_step(state: dict, cfg: SPHConfig, mask_mode: str = "radius",
                subbin_threshold: int = 6) -> dict:
    """One full physics step.  ``state`` is a dict of numpy arrays with
    the ParticleState field names; returns an updated copy."""
    s = {k: np.array(v, np.float64) if np.asarray(v).dtype.kind == "f"
         else np.array(v) for k, v in state.items()}
    acc = accumulate(s, cfg, mask_mode, subbin_threshold)
    if cfg.variant == "base":
        _, rate = s["stress"], np.zeros_like(s["stress"])
        sig = s["stress"]
    else:
        sig, rate = granular_update(s, acc, cfg)

    h = cfg.cutoff
    w0 = 1.0 / (PI_REF * h ** 3)
    bnd = s["boundary"].astype(bool)
    alive = s["alive"].astype(bool)
    mob = (~bnd) & alive

    # common head of Particle::update (both variants)
    dens = ((acc.sum_w + w0) / cfg.dens_norm_div
            * (1.0 + bnd * cfg.bdensfactor) + cfg.dens_norm_offset)
    if cfg.variant == "base":
        press = (cfg.eos_stiffness * cfg.rho0 / cfg.eos_gamma
                 * ((dens / cfg.rho0) ** cfg.eos_gamma - 1.0))
    else:
        press = ((1.0 - s["solid"]) * cfg.eos_stiffness * cfg.rho0
                 / cfg.eos_gamma * ((dens / cfg.rho0) ** cfg.eos_gamma - 1.0)
                 + s["solid"] * cfg.eos_stiffness * cfg.rho0_sand
                 / cfg.eos_gamma * ((dens / cfg.rho0) ** cfg.eos_gamma - 1.0))
    delpress = acc.dpress
    stress_new = cfg.dt * rate   # overwrite, not integrate (FluidGPU.cuh:280)

    pos, vel, accel = s["pos"].copy(), s["vel"].copy(), s["acc"].copy()
    dt = cfg.dt

    if cfg.variant == "base":
        pos = np.where(mob[:, None], pos + dt * vel
                       + cfg.diff * s["diffusion"], pos)
        vp = vel + dt * accel  # stress_accel == 0 in the active base path
        eps = cfg.friction_eps
        vx = vp[:, 0] - (vp[:, 0] > 0) * eps + (vp[:, 0] < 0) * eps
        vx = vx * (np.abs(vx) > eps)
        vy = vp[:, 1] - (vp[:, 1] > 0) * eps + (vp[:, 1] < 0) * eps
        vy = vy * (np.abs(vy) > eps)
        vz = vp[:, 2] * (np.abs(vp[:, 2]) > eps)
        new_vel = np.stack([vx, vy, vz], axis=1)
        new_acc = -(cfg.accel_prefactor / dens)[:, None] * delpress
        new_acc[:, 2] += cfg.gravity
        vel = np.where(mob[:, None], new_vel, vel)
        accel = np.where(mob[:, None], new_acc, accel)
        solid, fluid = s["solid"], s["fluid"]
    else:
        friction = np.sum(np.abs(s["diffusion"]), axis=-1)
        solid = s["solid"] + dt * acc.delsolid
        solid = solid * (solid >= 0)
        delfluid = np.where(s["fluid"] + acc.delfluid < cfg.fluid_floor,
                            0.0, acc.delfluid)
        fluid = s["fluid"] + dt * delfluid
        fluid = fluid * (fluid >= 0)
        # sequential (non-clean) renormalization, FluidGPU-unidyn.cuh:319-320
        fluid = fluid / (fluid + solid)
        solid = solid / (fluid + solid)
        solid = np.where(mob, solid, s["solid"])
        fluid = np.where(mob, fluid, s["fluid"])

        pos = np.where(mob[:, None],
                       pos + dt * vel + 0.5 * dt * dt * accel
                       + cfg.diff * s["diffusion"], pos)
        below = pos[:, 2] < cfg.floor_recycle_z
        vel = vel.copy()
        vel[:, 0] = np.where(mob & below, 0.0, vel[:, 0])
        vel[:, 1] = np.where(mob & below, 0.0, vel[:, 1])

        sa, ma = acc.stress_accel, acc.mixture_accel
        drag = friction * cfg.solid_drag * solid
        maw = cfg.mixture_accel_weight

        def half_kick(v, a, axis):
            return (v + 0.5 * dt * a + dt * sa[:, axis]
                    + maw * dt * dt * ma[:, axis])

        vx = half_kick(vel[:, 0], accel[:, 0], 0)
        cond_x = vel[:, 0] + dt * accel[:, 0] + dt * sa[:, 0] \
            + dt * dt * ma[:, 0]
        vx = vx - (cond_x > 0) * drag + (cond_x < 0) * drag
        # quirk: the y/z drag conditions read the *already updated* x
        # velocity and x acceleration (FluidGPU-unidyn.cuh:352-353)
        vy = half_kick(vel[:, 1], accel[:, 1], 1)
        cond_y = vx + dt * accel[:, 0] + dt * sa[:, 1] + dt * dt * ma[:, 1]
        vy = vy - (cond_y > 0) * drag + (cond_y < 0) * drag
        vz = half_kick(vel[:, 2], accel[:, 2], 2)
        cond_z = vx + dt * accel[:, 0] + dt * sa[:, 2] + dt * dt * ma[:, 2]
        vz = vz - (cond_z > 0) * drag + (cond_z < 0) * drag

        pref = (cfg.accel_prefactor_unidyn
                - cfg.accel_prefactor_solid * solid) / dens
        nax = -pref * delpress[:, 0]
        nay = -pref * delpress[:, 1]
        naz = cfg.gravity - pref * delpress[:, 2]

        vx = vx + 0.5 * nax * dt
        vy = vy + 0.5 * nay * dt
        vz = vz + 0.5 * naz * dt

        # walls (FluidGPU-unidyn.cuh:404-413)
        zhit = np.abs(pos[:, 2]) > cfg.wall_limit
        pos[:, 2] = np.where(mob & zhit, cfg.wall_clamp / pos[:, 2],
                             pos[:, 2])
        vz = np.where(zhit, 0.0, vz)
        vy = np.where(np.abs(pos[:, 1]) > cfg.wall_limit, -vy, vy)
        vx = np.where(np.abs(pos[:, 0]) > cfg.wall_limit, -vx, vx)

        new_vel = np.stack([vx, vy, vz], axis=1)
        new_acc = np.stack([nax, nay, naz], axis=1)
        vel = np.where(mob[:, None], new_vel, s["vel"])
        accel = np.where(mob[:, None], new_acc, s["acc"])
        # split y-nudge, applied once per newly triggered particle
        newly = acc.split_trigger & (~s["split"].astype(bool))
        pos[:, 1] += np.where(newly, cfg.split_y_nudge, 0.0)

    out = dict(s)
    if cfg.variant != "base":
        out["mass"] = np.where(acc.split_trigger, 1.0, s["mass"])
    out.update(
        pos=pos, vel=vel, acc=accel,
        dens=np.where(alive, dens, s["dens"]),
        press=np.where(alive, press, s["press"]),
        delpress=np.where(alive[:, None], delpress, s["delpress"]),
        diffusion=np.where(alive[:, None], acc.diffusion, s["diffusion"]),
        solid=solid, fluid=fluid,
        stress=np.where(alive[:, None, None], stress_new, s["stress"]),
        split=s["split"].astype(bool) | acc.split_trigger,
    )
    return out


def state_to_dict(state) -> dict:
    """Convert a ParticleState pytree to a dict of numpy arrays."""
    return {k: np.asarray(getattr(state, k)) for k in (
        "pos", "vel", "acc", "mass", "dens", "press", "delpress",
        "diffusion", "solid", "fluid", "stress", "boundary", "alive",
        "split", "pid")}
