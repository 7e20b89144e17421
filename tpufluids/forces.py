"""Pair-force accumulation — deterministic gather replacement for the
reference's atomicAdd force kernels.

Implements the full accumulation sets of:

* base ``mykernel`` (FluidGPU.cu:224-281): density sum, symmetrized
  pressure gradient with inline Monaghan viscosity (quadratic term
  included, FluidGPU.cu:255);
* unidyn ``mykernel``/``mykernel3`` (FluidGPU-unidyn.cu:249-446):
  mass-weighted density/pressure sums, color/diffusion gradient,
  drift-flux mixture model (Brownian + pressure-slip + body-force slip
  terms -> per-phase drift velocities -> mixture acceleration and phase
  transport rates), mixfactor-gated velocity gradient and granular
  stress acceleration, and the per-particle strain-rate / yield /
  stress-rate pass.

Every particle gathers and sums its own neighbor contributions
(deterministic, reproducible) instead of scatter-adding with atomics
(the reference is order-nondeterministic by construction).  The
reference's read-write races on drift velocities are resolved as two
passes: pass A fully accumulates drift velocities, pass B consumes
them (see tpufluids/oracle.py for the full determinism notes).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import jax
import jax.numpy as jnp

from tpufluids.binning import BinTable, Candidates, neighbor_candidates
from tpufluids.config import SPHConfig
from tpufluids.kernels import grad_w_spiky, w_cubic
from tpufluids.state import ParticleState


class ForceAccum(NamedTuple):
    """Per-step accumulators (the reference's ``new*`` fields plus the
    unidyn extras, all reset each step in mykernel2)."""
    sum_w: jax.Array          # (N,)
    dpress: jax.Array         # (N, 3)
    diffusion: jax.Array      # (N, 3)
    vel_grad: jax.Array       # (N, 3, 3)
    stress_accel: jax.Array   # (N, 3)
    solid_drift: jax.Array    # (N, 3)
    fluid_drift: jax.Array    # (N, 3)
    mixture_accel: jax.Array  # (N, 3)
    delsolid: jax.Array       # (N,)
    delfluid: jax.Array       # (N,)
    stress_scaled: jax.Array  # (N, 3, 3) yield-scaled sigma
    stress_rate: jax.Array    # (N, 3, 3)
    split_trigger: jax.Array  # (N,) bool
    merge_partner: jax.Array  # (N,) i32, -1 if none (sorted index)


class PairGeometry(NamedTuple):
    idx: jax.Array    # (N, M) neighbor sorted indices
    mask: jax.Array   # (N, M) pair validity incl. distance gate
    ds: jax.Array     # (N, M) pair distance (safe, >0 where masked)
    rab: jax.Array    # (N, M, 3) x_i - x_j
    vab: jax.Array    # (N, M, 3) v_i - v_j
    w: jax.Array      # (N, M) cubic kernel value
    dk: jax.Array     # (N, M, 3) spiky kernel gradient (points j -> i)
    dens_j: jax.Array   # (N, M) gathered neighbor fields
    press_j: jax.Array
    mass_j: jax.Array
    bnd_j: jax.Array    # (N, M) bool
    solid_j: jax.Array
    fluid_j: jax.Array


def pair_geometry(state: ParticleState, cand: Candidates,
                  cfg: SPHConfig) -> PairGeometry:
    """Gather neighbor fields and compute pair geometry.

    All per-neighbor fields are packed into ONE (N, F) matrix and
    gathered with a single row gather instead of one gather per field.
    """
    n = state.pos.shape[0]
    idx = cand.idx.reshape(n, -1)
    mask = cand.mask.reshape(n, -1)
    h = jnp.float32(cfg.cutoff)

    packed = jnp.concatenate([
        state.pos, state.vel,
        state.dens[:, None], state.press[:, None], state.mass[:, None],
        state.boundary.astype(jnp.float32)[:, None],
        state.solid[:, None], state.fluid[:, None],
    ], axis=1)                                     # (N, 12)
    pj = packed[idx]                               # one gather: (N, M, 12)
    pos_j, vel_j = pj[..., 0:3], pj[..., 3:6]
    dens_j, press_j, mass_j = pj[..., 6], pj[..., 7], pj[..., 8]
    bnd_j = pj[..., 9] > 0.5
    solid_j, fluid_j = pj[..., 10], pj[..., 11]

    rab = state.pos[:, None, :] - pos_j
    ds2 = jnp.sum(rab * rab, axis=-1)
    ds = jnp.sqrt(ds2)
    # ds > 0 excludes self and exact-coincident pairs (FluidGPU.cu:236)
    mask = mask & (ds > 0) & (ds <= 2 * h)
    ds_safe = jnp.where(ds > 0, ds, 1.0)
    vab = state.vel[:, None, :] - vel_j
    w = jnp.where(mask, w_cubic(ds, h), 0.0)
    dk = (grad_w_spiky(ds, h) / ds_safe)[:, :, None] * rab
    dk = jnp.where(mask[:, :, None], dk, 0.0)
    return PairGeometry(idx=idx, mask=mask, ds=ds_safe, rab=rab, vab=vab,
                        w=w, dk=dk, dens_j=dens_j, press_j=press_j,
                        mass_j=mass_j, bnd_j=bnd_j, solid_j=solid_j,
                        fluid_j=fluid_j)


def _msum(x, mask, axis=1):
    return jnp.sum(jnp.where(mask, x, 0.0), axis=axis)


def granular_pass(state: ParticleState, vel_grad: jax.Array,
                  cfg: SPHConfig) -> tuple[jax.Array, jax.Array]:
    """Per-particle granular pass (FluidGPU-unidyn.cu:410-446): strain
    rate from the accumulated velocity gradient, Drucker-Prager yield
    scaling of sigma, and the stress-rate update.  Pure per-particle
    math, shared by the XLA and kernel force backends.

    Returns (stress_scaled, stress_rate)."""
    press, solid = state.press, state.solid
    sr = 0.5 * (vel_grad + jnp.swapaxes(vel_grad, 1, 2))
    tr = jnp.trace(sr, axis1=1, axis2=2)
    tr3 = 0.5 * jnp.sum(state.stress * state.stress, axis=(1, 2))
    tr5 = jnp.sum(sr * sr, axis=(1, 2))
    tr4 = jnp.einsum("ipq,iqp->i", state.stress, sr)
    ppos = press * (press > 0)
    ylim = (3.0 * math.tan(cfg.phi) / cfg.yield_denom * ppos
            + cfg.kc / cfg.yield_denom)
    scale = jnp.where((ylim < tr3) & (tr3 != 0),
                      ylim / jnp.where(tr3 == 0, 1.0, tr3), 1.0)
    active = solid != 0
    sig = jnp.where(active[:, None, None],
                    state.stress * scale[:, None, None], state.stress)
    eye = jnp.eye(3, dtype=jnp.float32)[None]
    rate = (3.0 * cfg.c1 * press[:, None, None]
            * (sr - tr[:, None, None] / 3.0 * eye)
            + cfg.c1 * cfg.c2 * ((tr4 + tr * ppos)
                                 / (press * press + cfg.stress_rate_reg)
                                 )[:, None, None] * sig
            - cfg.c1 * cfg.c3 * jnp.sqrt(tr5)[:, None, None] * sig)
    rate = jnp.where(active[:, None, None], rate, 0.0)
    return sig, rate


def compute_split_trigger(state: ParticleState, diffusion: jax.Array,
                          has_pair: jax.Array, cfg: SPHConfig) -> jax.Array:
    """Adaptive-resolution split trigger (FluidGPU-unidyn.cu:261-285)."""
    diff2 = jnp.sum(diffusion * diffusion, axis=-1)
    return (has_pair & (state.mass > cfg.split_mass_min)
            & (~state.boundary) & state.alive
            & ((diff2 > cfg.split_diffusion_min)
               | (state.dens < cfg.split_dens_max)))


def accum_from_kernel(state: ParticleState, r: dict,
                      cfg: SPHConfig) -> ForceAccum:
    """Assemble a full ForceAccum from the pair-kernel results
    (tpufluids.sph_triton.unidyn_forces), running the shared
    per-particle granular pass and split trigger.  The merge partner
    search runs inside the pass-A kernel when merge_dist > 0 (the
    in-kernel placement of FluidGPU-unidyn.cu:261-275)."""
    n = state.capacity
    sig, rate = granular_pass(state, r["vel_grad"], cfg)
    split = compute_split_trigger(state, r["diffusion"], r["has_pair"],
                                  cfg)
    return ForceAccum(
        sum_w=r["sum_w"], dpress=r["dpress"], diffusion=r["diffusion"],
        vel_grad=r["vel_grad"], stress_accel=r["stress_accel"],
        solid_drift=r["solid_drift"], fluid_drift=r["fluid_drift"],
        mixture_accel=r["mixture_accel"], delsolid=r["delsolid"],
        delfluid=r["delfluid"], stress_scaled=sig, stress_rate=rate,
        split_trigger=split,
        merge_partner=r.get("merge_partner",
                            jnp.full(n, -1, jnp.int32)))


def compute_forces(state: ParticleState, bt: BinTable,
                   cfg: SPHConfig, subbin_parity: bool = False,
                   subbin_threshold: int = 6,
                   drift_fix=None) -> ForceAccum:
    """Full pair + per-particle accumulation for one step.

    ``state`` must already be cell-sorted (see binning.sort_by_cell).
    ``subbin_parity`` enables the reference's two-level-binning stencil
    semantics for overpopulated cells (see binning.neighbor_candidates).
    ``drift_fix``, if given, maps (solid_drift, fluid_drift) -> corrected
    arrays between pass A and pass B — the spatial-decomposition hook
    that replaces halo particles' locally-incomplete drift velocities
    with the owner-computed values (tpufluids.shard.particles).
    """
    cand = neighbor_candidates(
        bt, cfg, subbin_threshold if subbin_parity else None)
    g = pair_geometry(state, cand, cfg)
    n = state.pos.shape[0]
    idx, mask = g.idx, g.mask
    h = jnp.float32(cfg.cutoff)

    dens, press = state.dens, state.press
    dens_j, press_j = g.dens_j, g.press_j
    bnd = state.boundary
    bnd_j = g.bnd_j
    nb_bnd = (~bnd)[:, None] & bnd_j           # i fluid, j boundary
    mass_j = g.mass_j

    d = jnp.sum(g.vab * g.rab, axis=-1)
    d2 = g.ds * g.ds
    mu = h * (d / (d2 + 0.01 * h * h))
    rho_bar = (dens[:, None] + dens_j) / 2.0

    if cfg.variant == "base":
        # inline viscosity of the base force kernel (FluidGPU.cu:255)
        s = (cfg.alpha_fluid * cfg.sound
             * (mu + cfg.visc_quadratic / cfg.sound * mu * mu) / rho_bar
             * (d < 0) * (1.0 + nb_bnd * cfg.alpha_boundary))
        mw = jnp.ones_like(g.w)
    else:
        # unidyn viscosity (FluidGPU-unidyn.cu:307)
        alpha_i = (state.solid[:, None] * 9.0 + 1.0) * cfg.alpha_fluid
        bfac = 1.0 + nb_bnd * ((1.0 + 3.0 * state.fluid[:, None] ** 2)
                               * cfg.alpha_sand_boundary)
        s = (alpha_i * cfg.sound
             * (state.mass[:, None] * mu
                + cfg.visc_quadratic / cfg.sound * mu * mu)
             / rho_bar * (d < 0) * bfac)
        mw = mass_j

    p_term = (press_j / (dens_j * dens_j)
              + (press / (dens * dens))[:, None] + s)
    dp = p_term[:, :, None] * g.dk

    sum_w = _msum(g.w * (1.0 + nb_bnd * cfg.bdensfactor) * mw, mask)
    dpress = _msum(dp * mw[:, :, None], mask[:, :, None])

    zeros3 = jnp.zeros((n, 3), jnp.float32)
    zeros33 = jnp.zeros((n, 3, 3), jnp.float32)
    acc = ForceAccum(
        sum_w=sum_w, dpress=dpress, diffusion=zeros3, vel_grad=zeros33,
        stress_accel=zeros3, solid_drift=zeros3, fluid_drift=zeros3,
        mixture_accel=zeros3, delsolid=jnp.zeros(n, jnp.float32),
        delfluid=jnp.zeros(n, jnp.float32), stress_scaled=state.stress,
        stress_rate=zeros33,
        split_trigger=jnp.zeros(n, bool),
        merge_partner=jnp.full(n, -1, jnp.int32),
    )
    if cfg.variant == "base":
        return acc

    # ---------------- unidyn extras (FluidGPU-unidyn.cu:314-446) ----------
    solid, fluid = state.solid, state.fluid
    si, sj = solid[:, None], g.solid_j
    fi, fj = fluid[:, None], g.fluid_j
    both_fluid = (~bnd)[:, None] & (~bnd_j)

    diffusion = _msum((mw / dens_j)[:, :, None] * g.dk,
                      (mask & both_fluid)[:, :, None])

    # mixfactor-gated velocity gradient + granular stress acceleration
    # (FluidGPU-unidyn.cu:368-381)
    mixfactor = (both_fluid * (si > 0) * (sj > 0) * 2.0 * si * sj
                 / (si + sj + cfg.mixfactor_reg))
    mixfactor = jnp.where(mask, mixfactor, 0.0)
    # vel_grad[a][b] += -mixfactor * vab[b] * dk[a] / dens_i
    # contracted einsum: never materializes the (N, M, 3, 3) outer product
    vel_grad = jnp.einsum("ija,ijb->iab", mixfactor[:, :, None] * g.dk,
                          g.vab) * (-1.0 / dens)[:, None, None]
    # stress_accel[a] = (1+mixfactor) * (sigma_i[a,:] . dk) / dens_i^2
    stress_accel = jnp.einsum(
        "iab,ijb->ia", state.stress,
        (1.0 + mixfactor)[:, :, None] * jnp.where(mask[:, :, None], g.dk, 0.0)
    ) / (dens ** 2)[:, None]

    # ---- pass A: drift velocities (FluidGPU-unidyn.cu:314-356) -----------
    denom = cfg.rho0_sand * solid + cfg.rho0 * fluid
    denom = jnp.where(denom == 0, 1.0, denom)
    msf = solid * cfg.rho0_sand / denom
    mff = fluid * cfg.rho0 / denom
    gate_i = ((msf > cfg.mix_frac_min) & (msf < cfg.mix_frac_max)
              & (mff > cfg.mix_frac_min) & (mff < cfg.mix_frac_max))
    pair_gate = mask & both_fluid & gate_i[:, None]

    s_safe = jnp.where(solid == 0, 1.0, solid)[:, None, None]
    f_safe = jnp.where(fluid == 0, 1.0, fluid)[:, None, None]
    msf_i = msf[:, None, None]
    mff_i = mff[:, None, None]
    sg = (sj - si)[:, :, None] * g.dk
    fg = (fj - fi)[:, :, None] * g.dk
    sbrown = sg / s_safe * (1 - msf_i) - mff_i * fg / f_safe
    fbrown = fg / f_safe * (1 - mff_i) - msf_i * sg / s_safe
    a_slip = ((si * press[:, None] - sj * press_j))[:, :, None] * g.dk
    b_slip = ((fi * press[:, None] - fj * press_j))[:, :, None] * g.dk
    sslip = a_slip * (1 - msf_i) - mff_i * b_slip
    fslip = b_slip * (1 - mff_i) - msf_i * a_slip
    v_dk = jnp.einsum("ia,ija->ij", state.vel, g.dk)
    grav = jnp.array([0.0, 0.0, cfg.gravity], jnp.float32)
    # body core: (150/rho_i)*delpress_i + gravity_z - (v_i . dk) * vab
    # (the literal 150 at FluidGPU-unidyn.cu:342-348 — NOT the 220-70s
    # prefactor of the integrator)
    body_core = ((150.0 / dens)[:, None, None] * state.delpress[:, None, :]
                 + grav[None, None, :]
                 - v_dk[:, :, None] * g.vab)
    s_pref = (dens * (solid - msf * solid - mff * fluid))[:, None, None]
    f_pref = (dens * (fluid - msf * solid - mff * fluid))[:, None, None]
    g3 = pair_gate[:, :, None]
    solid_drift = _msum(cfg.mixpressure * (s_pref * body_core + sslip)
                        - cfg.mixbrownian * sbrown, g3)
    fluid_drift = _msum(cfg.mixpressure * (f_pref * body_core + fslip)
                        - cfg.mixbrownian * fbrown, g3)
    if drift_fix is not None:
        solid_drift, fluid_drift = drift_fix(solid_drift, fluid_drift)

    # ---- pass B: mixture accel + phase transport (consumes pass A) -------
    drift_j = jnp.concatenate([solid_drift, fluid_drift], axis=1)[idx]
    sdv_j = drift_j[..., 0:3]
    fdv_j = drift_j[..., 3:6]
    ds_i = jnp.einsum("ia,ija->ij", solid_drift, g.dk)
    ds_j = jnp.sum(sdv_j * g.dk, axis=-1)
    df_i = jnp.einsum("ia,ija->ij", fluid_drift, g.dk)
    df_j = jnp.sum(fdv_j * g.dk, axis=-1)
    term = ((sj * dens_j)[:, :, None]
            * (sj[:, :, None] * sdv_j * ds_j[:, :, None]
               + si[:, :, None] * solid_drift[:, None, :]
               * ds_i[:, :, None])
            + (fj * dens_j)[:, :, None]
            * (fj[:, :, None] * fdv_j * df_j[:, :, None]
               + fi[:, :, None] * fluid_drift[:, None, :]
               * df_i[:, :, None]))
    mixture_accel = _msum(-term / (dens[:, None] * dens_j)[:, :, None],
                          mask[:, :, None])
    dk_vab = jnp.sum(g.dk * g.vab, axis=-1)
    drift_s = jnp.einsum(
        "ija,ija->ij",
        si[:, :, None] * solid_drift[:, None, :] + sj[:, :, None] * sdv_j,
        g.dk)
    drift_f = jnp.einsum(
        "ija,ija->ij",
        fi[:, :, None] * fluid_drift[:, None, :] + fj[:, :, None] * fdv_j,
        g.dk)
    # the divergence part is boundary-gated; the drift part is not
    # (operator precedence at FluidGPU-unidyn.cu:400-401)
    delsolid = _msum(both_fluid * (-0.5 / dens_j) * (si + sj) * dk_vab
                     + (-drift_s) / dens_j, mask)
    delfluid = _msum(both_fluid * (-0.5 / dens_j) * (fi + fj) * dk_vab
                     + (-drift_f) / dens_j, mask)

    # ---- per-particle granular pass + split trigger (shared with the
    # kernel backend, see accum_from_kernel) --------------------------------
    sig, rate = granular_pass(state, vel_grad, cfg)
    has_pair = jnp.any(mask, axis=1)
    split_trigger = compute_split_trigger(state, diffusion, has_pair, cfg)
    # merge: nearest eligible neighbor within merge_dist (ships disabled
    # via the -10.0 sentinel, FluidGPU-unidyn.cu:261; the whole branch
    # is elided unless enabled)
    if cfg.merge_dist > 0:
        prev_diff2 = jnp.sum(state.diffusion ** 2, axis=-1)
        eligible_i = ((state.mass > 0) & (state.mass < 2) & (~bnd)
                      & (prev_diff2 < cfg.merge_diffusion_max) & state.alive)
        elig_pair = (mask & (g.ds <= cfg.merge_dist) & eligible_i[:, None]
                     & eligible_i[idx])
        dist_masked = jnp.where(elig_pair, g.ds, jnp.inf)
        best = jnp.argmin(dist_masked, axis=1)
        any_elig = jnp.any(elig_pair, axis=1)
        merge_partner = jnp.where(
            any_elig,
            jnp.take_along_axis(idx, best[:, None], axis=1)[:, 0], -1)
    else:
        merge_partner = jnp.full(n, -1, jnp.int32)

    return acc._replace(
        diffusion=diffusion, vel_grad=vel_grad, stress_accel=stress_accel,
        solid_drift=solid_drift, fluid_drift=fluid_drift,
        mixture_accel=mixture_accel, delsolid=delsolid, delfluid=delfluid,
        stress_scaled=sig, stress_rate=rate, split_trigger=split_trigger,
        merge_partner=merge_partner)
