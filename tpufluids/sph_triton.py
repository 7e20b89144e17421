"""SPH pair pass as a cell-list Pallas kernel for the GPU (Triton route).

The XLA pass (``forces.compute_forces``) materialises an
(N, 9, 3 * max_per_cell) candidate table and gathers one packed row per
candidate slot.  This kernel reads the cell-sorted pool directly, the
way the reference's per-cell CUDA kernels did (FluidGPU.cu:150-234):

* a home block is ``RB`` consecutive rows of the sorted pool;
* the stencil candidates of a home block are the 3-5 contiguous sorted
  row ranges of the x-planes [cx_min-1, cx_max+1], each restricted to
  the y-columns [cy_min-1, cy_max+1].  ``NX`` programs share a home
  block, program p taking every NX-th of those planes, and their
  partial sums are added afterwards in a fixed order.  Each program
  reads ``col_start`` itself and streams its ranges in chunks of ``CH``
  rows with loads masked to the range;
* a per-pair cell mask (|dcx|, |dcy|, |dcz| <= 1, from the binning's
  own cell ids) selects exactly the 27-cell stencil set of the XLA path.
  Nothing caps a cell's population, so no pair is ever dropped;
* sums are gathered per home row in a fixed order, with no atomics:
  two runs give the same bits.

The pool is packed one row per field (structure of arrays), so every
load is a contiguous run of one field.  Rows are padded so that every
load is in bounds.  The unidyn variant runs two passes: pass A
accumulates the drift velocities (and, with merging on, finds each
particle's merge partner), pass B consumes them — the deterministic
resolution of the reference's atomic read-write race
(FluidGPU-unidyn.cu:314-401; see tpufluids/oracle.py).

``interpret=True`` runs the kernels under the Pallas interpreter, which
is how the CPU tests exercise them.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from tpufluids.binning import BinTable
from tpufluids.config import SPHConfig
from tpufluids.kernels import grad_w_spiky, w_cubic
from tpufluids.state import ParticleState

# Home rows per block and candidate rows per chunk (powers of two, as
# Triton blocks must be), programs per home block, and the Triton
# launch parameters.  An H100 has 132 SMs and one program's chunk loop
# is a dependent chain, so the step is fastest with many small
# programs: of the settings swept on the card (PERF.md, PR 1) 16-row
# blocks split over 3 programs, 32-row chunks and 4 warps were fastest
# on both reference scenes.
RB = 16
CH = 32
NX = 3
NUM_WARPS = 4
NUM_STAGES = 2

# float rows of the packed pool
_X, _V, _DENS, _PRESS, _BND = 0, 3, 6, 7, 8
_MASS, _SOLID, _FLUID, _DP, _SIG, _ELIG = 9, 10, 11, 12, 15, 24
_SDV, _FDV = 25, 28            # pass B appends the drift velocities
# int rows: sorted cell id, home-cell population, sub-bin octant
_CID, _HCNT, _OCT = 0, 1, 2

# output rows
_BASE_OUT = 4                                     # sum_w, dpress
_A_SUMW, _A_DP, _A_DIFF, _A_VG, _A_SA, _A_SDV, _A_FDV, _A_CNT = \
    0, 1, 4, 7, 16, 19, 22, 25
_A_OUT = 26
_A_BESTD, _A_BESTROW = 26, 27                     # merge partner search
_B_MA, _B_DSOL, _B_DFLU = 0, 3, 4
_B_OUT = 5
_BIG = 3.0e38


class _Home(NamedTuple):
    blk: jax.Array       # first sorted row of the block
    valid: jax.Array     # (1, RB) rows holding a binned particle
    cells: tuple         # (1, RB) int cell coords (x local, y, z)
    x_lo: jax.Array      # candidate x-plane range (inclusive)
    x_hi: jax.Array
    y_lo: jax.Array      # candidate y-column range (inclusive)
    y_hi: jax.Array


def _cells(cid, g):
    return (jax.lax.div(cid, g * g), jax.lax.rem(jax.lax.div(cid, g), g),
            jax.lax.rem(cid, g))


def _home(col_ref, i_ref, *, g, gx):
    """Home block geometry.  The x-plane range is in LOCAL plane ids (a
    sharded x-slab's cell ids are local, binning.GridSpec), the y range
    is global (y is never sharded)."""
    blk = pl.program_id(0) * RB
    total = col_ref[gx * g]
    valid = (blk + jnp.arange(RB, dtype=jnp.int32)) < total
    cx, cy, cz = _cells(i_ref[_CID, pl.ds(blk, RB)], g)
    big, small = jnp.int32(1 << 30), jnp.int32(-(1 << 30))
    x_lo = jnp.maximum(jnp.min(jnp.where(valid, cx, big)) - 1, 0)
    x_hi = jnp.minimum(jnp.max(jnp.where(valid, cx, small)) + 1, gx - 1)
    y_lo = jnp.maximum(jnp.min(jnp.where(valid, cy, big)) - 1, 0)
    y_hi = jnp.minimum(jnp.max(jnp.where(valid, cy, small)) + 1, g - 1)
    return _Home(blk=blk, valid=valid[None, :],
                 cells=(cx[None, :], cy[None, :], cz[None, :]),
                 x_lo=x_lo, x_hi=x_hi, y_lo=y_lo, y_hi=y_hi)


def _sweep(col_ref, home: _Home, body, acc0, *, g):
    """Run ``body(acc, j0, jvalid)`` over this program's candidate
    chunks: the x-planes x_lo + p, x_lo + p + NX, ... (p = the second
    program id), in ascending sorted-row order."""
    y_lo, y_hi = home.y_lo, home.y_hi
    p = pl.program_id(1)

    def x_plane(i, acc):
        xr = home.x_lo + p + i * NX
        start = col_ref[xr * g + y_lo]
        stop = col_ref[xr * g + y_hi + 1]

        def chunk(k, acc):
            j0 = start + k * CH
            jvalid = (j0 + jnp.arange(CH, dtype=jnp.int32)) < stop
            return body(acc, j0, jvalid[:, None])

        return jax.lax.fori_loop(
            0, jax.lax.div(stop - start + CH - 1, CH), chunk, acc)

    n_planes = jnp.maximum(home.x_hi - home.x_lo + 1 - p, 0)
    return jax.lax.fori_loop(0, jax.lax.div(n_planes + NX - 1, NX),
                             x_plane, acc0)


def _hrow(f_ref, home, c):
    return f_ref[c, pl.ds(home.blk, RB)][None, :]            # (1, RB)


def _jcol(f_ref, j0, c):
    return f_ref[c, pl.ds(j0, CH)][:, None]                  # (CH, 1)


def _pair_mask(home, i_ref, j0, jvalid, ds, g, subbin_threshold, hsub):
    """27-cell stencil + support gate (+ octant sub-bin predicate)."""
    jcx, jcy, jcz = _cells(i_ref[_CID, pl.ds(j0, CH)][:, None], g)
    dcx = jcx - home.cells[0]
    dcy = jcy - home.cells[1]
    dcz = jcz - home.cells[2]

    def near(d):
        return (d >= -1) & (d <= 1)

    mask = (home.valid & jvalid & near(dcx) & near(dcy) & near(dcz)
            & (ds > 0))
    if subbin_threshold is not None:
        # octant sub-bin stencil of overfull home cells
        # (FluidGPU-unidyn.cu:579-583; see binning.neighbor_candidates)
        overfull, dirx, diry, dirz = hsub
        ok = (((dcx == 0) | (dcx == dirx)) & ((dcy == 0) | (dcy == diry))
              & ((dcz == 0) | (dcz == dirz)))
        mask = mask & ((~overfull) | ok)
    return mask


def _home_subbin(i_ref, home, subbin_threshold):
    if subbin_threshold is None:
        return None
    o = i_ref[_OCT, pl.ds(home.blk, RB)][None, :]
    overfull = i_ref[_HCNT, pl.ds(home.blk, RB)][None, :] > subbin_threshold
    one, minus = jnp.int32(1), jnp.int32(-1)
    dirx = jnp.where((o & 1) != 0, one, minus)
    diry = jnp.where((o & 2) != 0, one, minus)
    dirz = jnp.where((o & 4) != 0, minus, one)
    return overfull, dirx, diry, dirz


def _geometry(f_ref, hx, hv, j0):
    """Pair geometry on the (CH, RB) tile (neighbours j on axis 0, home
    rows i on axis 1)."""
    jx = [_jcol(f_ref, j0, _X + a) for a in range(3)]
    jv = [_jcol(f_ref, j0, _V + a) for a in range(3)]
    rab = [hx[a] - jx[a] for a in range(3)]
    vab = [hv[a] - jv[a] for a in range(3)]
    ds2 = rab[0] * rab[0] + rab[1] * rab[1] + rab[2] * rab[2]
    ds = jnp.sqrt(ds2)
    d = vab[0] * rab[0] + vab[1] * rab[1] + vab[2] * rab[2]
    return rab, vab, ds2, ds, d


def _msum(mask, x):
    return jnp.sum(jnp.where(mask, x, 0.0), axis=0)          # (RB,)


def _store(o_ref, home, accs):
    """Row k of program p's partial result goes to output row
    p * len(accs) + k."""
    base = pl.program_id(1) * len(accs)
    for k, a in enumerate(accs):
        o_ref[base + k, pl.ds(home.blk, RB)] = a


def _base_kernel(col_ref, f_ref, i_ref, o_ref, *, cfg: SPHConfig, g, gx,
                 subbin_threshold):
    home = _home(col_ref, i_ref, g=g, gx=gx)
    hsub = _home_subbin(i_ref, home, subbin_threshold)
    hx = [_hrow(f_ref, home, _X + a) for a in range(3)]
    hv = [_hrow(f_ref, home, _V + a) for a in range(3)]
    di = _hrow(f_ref, home, _DENS)
    pi = _hrow(f_ref, home, _PRESS)
    bi = _hrow(f_ref, home, _BND) > 0.5
    h = jnp.float32(cfg.cutoff)

    def body(acc, j0, jvalid):
        rab, _, ds2, ds, d = _geometry(f_ref, hx, hv, j0)
        mask = (_pair_mask(home, i_ref, j0, jvalid, ds, g,
                           subbin_threshold, hsub) & (ds <= 2 * h))
        ds_safe = jnp.where(ds > 0, ds, 1.0)
        # base force kernel (FluidGPU.cu:234-281)
        mu = h * (d / (ds2 + 0.01 * h * h))
        dj = _jcol(f_ref, j0, _DENS)
        pj = _jcol(f_ref, j0, _PRESS)
        nb_bnd = ((~bi) & (_jcol(f_ref, j0, _BND) > 0.5)).astype(
            jnp.float32)
        rho_bar = (di + dj) / 2.0
        s = (cfg.alpha_fluid * cfg.sound
             * (mu + cfg.visc_quadratic / cfg.sound * mu * mu) / rho_bar
             * (d < 0).astype(jnp.float32)
             * (1.0 + nb_bnd * cfg.alpha_boundary))
        pk = (pj / (dj * dj) + pi / (di * di) + s) * (
            grad_w_spiky(ds, h) / ds_safe)
        return (acc[0] + _msum(mask, w_cubic(ds, h)
                               * (1.0 + nb_bnd * cfg.bdensfactor)),
                acc[1] + _msum(mask, pk * rab[0]),
                acc[2] + _msum(mask, pk * rab[1]),
                acc[3] + _msum(mask, pk * rab[2]))

    zero = jnp.zeros((RB,), jnp.float32)
    accs = _sweep(col_ref, home, body, (zero,) * _BASE_OUT, g=g)
    _store(o_ref, home, accs)


def _unidyn_a_kernel(col_ref, f_ref, i_ref, o_ref, *, cfg: SPHConfig, g,
                     gx, subbin_threshold):
    """Pass A (FluidGPU-unidyn.cu:249-381): density/pressure sums,
    colour gradient, mixfactor-gated velocity gradient, stress
    acceleration, drift velocities, pair count, and with merging on
    the nearest eligible partner (FluidGPU-unidyn.cu:261-275)."""
    home = _home(col_ref, i_ref, g=g, gx=gx)
    hsub = _home_subbin(i_ref, home, subbin_threshold)

    def hrow(c):
        return _hrow(f_ref, home, c)

    hx = [hrow(_X + a) for a in range(3)]
    hv = [hrow(_V + a) for a in range(3)]
    bi = hrow(_BND) > 0.5
    di, pi = hrow(_DENS), hrow(_PRESS)
    si, fi, mi = hrow(_SOLID), hrow(_FLUID), hrow(_MASS)
    dpi = [hrow(_DP + a) for a in range(3)]
    sig = [hrow(_SIG + k) for k in range(9)]
    h = jnp.float32(cfg.cutoff)
    valid = home.valid
    # mass fractions + mixture gate (FluidGPU-unidyn.cu:314-317)
    denom = cfg.rho0_sand * si + cfg.rho0 * fi
    denom = jnp.where(denom == 0, 1.0, denom)
    msf = si * cfg.rho0_sand / denom
    mff = fi * cfg.rho0 / denom
    gate_i = ((msf > cfg.mix_frac_min) & (msf < cfg.mix_frac_max)
              & (mff > cfg.mix_frac_min) & (mff < cfg.mix_frac_max))
    s_safe = jnp.where(si == 0, 1.0, si)
    f_safe = jnp.where(fi == 0, 1.0, fi)
    # Block-level activity flags: the mixture/stress rows are exactly
    # zero unless some home row has solid > 0 (mixfactor) or nonzero
    # sigma, and the drift rows unless some home row passes the
    # mixture-fraction gate.  The reference's own tank never mixes, so
    # every block skips those row groups there.
    def anyv(b):
        return jnp.max(jnp.where(valid & b, 1, 0)) > 0

    has_mix = anyv((~bi) & (si > 0.0))
    sig_abs = functools.reduce(lambda a, b: a + b,
                               [jnp.abs(s) for s in sig])
    has_sig = anyv(sig_abs > 0.0)
    has_gate = anyv(gate_i)
    merge = cfg.merge_dist > 0
    elig_i = hrow(_ELIG) > 0.5 if merge else None

    def body(acc, j0, jvalid):
        def jcol(c):
            return _jcol(f_ref, j0, c)

        rab, vab, ds2, ds, d = _geometry(f_ref, hx, hv, j0)
        mask = (_pair_mask(home, i_ref, j0, jvalid, ds, g,
                           subbin_threshold, hsub) & (ds <= 2 * h))
        ds_safe = jnp.where(ds > 0, ds, 1.0)
        dkf = grad_w_spiky(ds, h) / ds_safe

        def msum(x):
            return _msum(mask, x)

        bj = jcol(_BND) > 0.5
        nb_bnd = ((~bi) & bj).astype(jnp.float32)
        both_fluid = (~bi) & (~bj)
        mj = jcol(_MASS)
        dj, pj = jcol(_DENS), jcol(_PRESS)
        sj, fj = jcol(_SOLID), jcol(_FLUID)

        # unidyn viscosity (FluidGPU-unidyn.cu:307)
        mu = h * (d / (ds2 + 0.01 * h * h))
        alpha_i = (si * 9.0 + 1.0) * cfg.alpha_fluid
        bfac = 1.0 + nb_bnd * ((1.0 + 3.0 * fi * fi)
                               * cfg.alpha_sand_boundary)
        rho_bar = (di + dj) / 2.0
        s = (alpha_i * cfg.sound
             * (mi * mu + cfg.visc_quadratic / cfg.sound * mu * mu)
             / rho_bar * (d < 0).astype(jnp.float32) * bfac)
        pk = (pj / (dj * dj) + pi / (di * di) + s) * dkf * mj
        out = [msum(w_cubic(ds, h) * (1.0 + nb_bnd * cfg.bdensfactor) * mj)]
        out += [msum(pk * r) for r in rab]
        # diffusion / colour gradient (FluidGPU-unidyn.cu:364-366)
        dfac = jnp.where(both_fluid, mj / dj, 0.0) * dkf
        out += [msum(dfac * r) for r in rab]

        def vg_sa_rows():
            # mixfactor-gated velocity gradient (FluidGPU-unidyn.cu:
            # 368-377) and stress acceleration (:379-381)
            mixfactor = jnp.where(
                both_fluid & (si > 0) & (sj > 0),
                2.0 * si * sj / (si + sj + cfg.mixfactor_reg), 0.0)
            rows = tuple(msum(-mixfactor * vab[b] * dkf * rab[a])
                         for a in range(3) for b in range(3))
            for a in range(3):
                term = dkf * (sig[3 * a] * rab[0] + sig[3 * a + 1] * rab[1]
                              + sig[3 * a + 2] * rab[2])
                rows += (msum((1.0 + mixfactor) * term),)
            return rows

        def drift_rows():
            # drift velocities (FluidGPU-unidyn.cu:314-356)
            g3 = mask & both_fluid & gate_i
            sg = [(sj - si) * dkf * r for r in rab]
            fg = [(fj - fi) * dkf * r for r in rab]
            a_ = [(si * pi - sj * pj) * dkf * r for r in rab]
            b_ = [(fi * pi - fj * pj) * dkf * r for r in rab]
            v_dk = dkf * (hv[0] * rab[0] + hv[1] * rab[1] + hv[2] * rab[2])
            s_pref = di * (si - msf * si - mff * fi)
            f_pref = di * (fi - msf * si - mff * fi)
            grav = (0.0, 0.0, cfg.gravity)
            sdv, fdv = [], []
            for a in range(3):
                bodyf = (150.0 / di) * dpi[a] + grav[a] - v_dk * vab[a]
                sbrown = sg[a] / s_safe * (1 - msf) - mff * fg[a] / f_safe
                fbrown = fg[a] / f_safe * (1 - mff) - msf * sg[a] / s_safe
                sslip = a_[a] * (1 - msf) - mff * b_[a]
                fslip = b_[a] * (1 - mff) - msf * a_[a]
                sdv.append(_msum(g3, cfg.mixpressure * (s_pref * bodyf
                                                        + sslip)
                                 - cfg.mixbrownian * sbrown))
                fdv.append(_msum(g3, cfg.mixpressure * (f_pref * bodyf
                                                        + fslip)
                                 - cfg.mixbrownian * fbrown))
            return tuple(sdv + fdv)

        zero = jnp.zeros((RB,), jnp.float32)
        out += list(jax.lax.cond(has_mix | has_sig, vg_sa_rows,
                                 lambda: (zero,) * 12))
        out += list(jax.lax.cond(has_gate, drift_rows,
                                 lambda: (zero,) * 6))
        out.append(msum(jnp.ones_like(ds)))
        new = tuple(a + b for a, b in zip(acc[:_A_OUT], out))
        if not merge:
            return new
        # nearest eligible partner within merge_dist; on equal
        # distances the lowest sorted row wins (chunks arrive in
        # ascending row order), as in the XLA candidate argmin
        elig = (mask & (ds <= cfg.merge_dist) & elig_i
                & (jcol(_ELIG) > 0.5))
        dmask = jnp.where(elig, ds, _BIG)
        cbest = jnp.min(dmask, axis=0)
        jrow = j0 + jax.lax.broadcasted_iota(jnp.int32, (CH, RB), 0)
        crow = jnp.min(jnp.where(dmask == cbest[None, :], jrow,
                                 jnp.int32(2 ** 30)), axis=0)
        better = cbest < acc[_A_BESTD]
        return new + (jnp.where(better, cbest, acc[_A_BESTD]),
                      jnp.where(better, crow, acc[_A_BESTROW]))

    zero = jnp.zeros((RB,), jnp.float32)
    acc0 = (zero,) * _A_OUT
    if merge:
        acc0 += (jnp.full((RB,), _BIG, jnp.float32),
                 jnp.full((RB,), -1, jnp.int32))
    accs = _sweep(col_ref, home, body, acc0, g=g)
    if merge:
        accs = accs[:-1] + (accs[-1].astype(jnp.float32),)
    _store(o_ref, home, accs)


def _unidyn_b_kernel(col_ref, f_ref, i_ref, o_ref, *, cfg: SPHConfig, g,
                     gx, subbin_threshold):
    """Pass B (FluidGPU-unidyn.cu:391-401): mixture acceleration and
    phase transport from pass A's drift velocities."""
    home = _home(col_ref, i_ref, g=g, gx=gx)
    hsub = _home_subbin(i_ref, home, subbin_threshold)

    def hrow(c):
        return _hrow(f_ref, home, c)

    hx = [hrow(_X + a) for a in range(3)]
    hv = [hrow(_V + a) for a in range(3)]
    bi = hrow(_BND) > 0.5
    di = hrow(_DENS)
    si, fi = hrow(_SOLID), hrow(_FLUID)
    sdvi = [hrow(_SDV + a) for a in range(3)]
    fdvi = [hrow(_FDV + a) for a in range(3)]
    h = jnp.float32(cfg.cutoff)
    # every drift term carries an sdv/fdv factor: when neither the home
    # block nor the chunk holds a nonzero drift (pure-phase flows, the
    # reference's own tank), only the boundary-gated divergence part of
    # the phase-transport rows survives
    dabs = functools.reduce(lambda a, b: a + b,
                            [jnp.abs(x) for x in sdvi + fdvi])
    home_drift = jnp.max(jnp.where(home.valid & (dabs > 0.0), 1, 0)) > 0

    def body(acc, j0, jvalid):
        def jcol(c):
            return _jcol(f_ref, j0, c)

        rab, vab, _, ds, _ = _geometry(f_ref, hx, hv, j0)
        mask = (_pair_mask(home, i_ref, j0, jvalid, ds, g,
                           subbin_threshold, hsub) & (ds <= 2 * h))
        ds_safe = jnp.where(ds > 0, ds, 1.0)
        dkf = grad_w_spiky(ds, h) / ds_safe

        def msum(x):
            return _msum(mask, x)

        bj = jcol(_BND) > 0.5
        bf = ((~bi) & (~bj)).astype(jnp.float32)
        dj = jcol(_DENS)
        sj, fj = jcol(_SOLID), jcol(_FLUID)
        dk_vab = dkf * (rab[0] * vab[0] + rab[1] * vab[1] + rab[2] * vab[2])
        sdvj = [jcol(_SDV + a) for a in range(3)]
        fdvj = [jcol(_FDV + a) for a in range(3)]
        jabs = functools.reduce(lambda a, b: a + b,
                                [jnp.abs(x) for x in sdvj + fdvj])
        chunk_drift = jnp.max(jnp.where(jvalid & (jabs > 0.0), 1, 0)) > 0
        div_s = bf * (-0.5 / dj) * (si + sj) * dk_vab
        div_f = bf * (-0.5 / dj) * (fi + fj) * dk_vab

        def full_rows():
            def dot(v):
                return dkf * (v[0] * rab[0] + v[1] * rab[1] + v[2] * rab[2])

            ds_i, ds_j = dot(sdvi), dot(sdvj)
            df_i, df_j = dot(fdvi), dot(fdvj)
            rows = []
            # mixture acceleration (FluidGPU-unidyn.cu:391-398)
            for a in range(3):
                term = (sj * dj * (sj * sdvj[a] * ds_j
                                   + si * sdvi[a] * ds_i)
                        + fj * dj * (fj * fdvj[a] * df_j
                                     + fi * fdvi[a] * df_i))
                rows.append(msum(-term / (di * dj)))
            # phase transport (FluidGPU-unidyn.cu:400-401): divergence
            # part boundary-gated, drift part ungated (reference
            # precedence)
            drift_s = dkf * sum((si * sdvi[a] + sj * sdvj[a]) * rab[a]
                                for a in range(3))
            drift_f = dkf * sum((fi * fdvi[a] + fj * fdvj[a]) * rab[a]
                                for a in range(3))
            rows.append(msum(div_s + (-drift_s) / dj))
            rows.append(msum(div_f + (-drift_f) / dj))
            return tuple(rows)

        def divergence_only():
            zero = jnp.zeros((RB,), jnp.float32)
            return (zero, zero, zero, msum(div_s), msum(div_f))

        out = jax.lax.cond(home_drift | chunk_drift, full_rows,
                           divergence_only)
        return tuple(a + b for a, b in zip(acc, out))

    zero = jnp.zeros((RB,), jnp.float32)
    accs = _sweep(col_ref, home, body, (zero,) * _B_OUT, g=g)
    _store(o_ref, home, accs)


# ---------------------------------------------------------------------------
# wrappers


def _extents(cfg: SPHConfig, grid):
    """(g, gx): y/z extent and number of x-planes (binning.GridSpec;
    None = the full cube)."""
    if grid is None:
        return cfg.grid_size, cfg.grid_size
    return grid.g, grid.x_planes


def _padded(n):
    """(programs, padded row count): every home load [blk, blk+RB) and
    every candidate chunk [j0, j0+CH) with j0 < n stays in bounds."""
    nb = -(-n // RB)
    return nb, nb * RB + CH


def _merge_elig(state: ParticleState, cfg: SPHConfig):
    """Per-particle merge eligibility (forces.compute_forces semantics,
    FluidGPU-unidyn.cu:261): light fluid particle with last step's
    diffusion magnitude under the threshold."""
    prev_diff2 = jnp.sum(state.diffusion ** 2, axis=-1)
    return ((state.mass > 0) & (state.mass < 2) & (~state.boundary)
            & (prev_diff2 < cfg.merge_diffusion_max)
            & state.alive).astype(jnp.float32)


def _pack(state: ParticleState, bt: BinTable, cfg: SPHConfig, order,
          n_pad, unidyn):
    """(float rows, int rows) of the sorted pool, padded to ``n_pad``.
    With ``order`` given the state is the unsorted pool
    (binning.sort_tables) and the rows are gathered by it."""
    f32 = jnp.float32
    s = state
    n = s.capacity
    cols = [s.pos.T, s.vel.T, s.dens[None], s.press[None],
            s.boundary.astype(f32)[None]]
    if unidyn:
        elig = (_merge_elig(s, cfg) if cfg.merge_dist > 0
                else jnp.zeros((n,), f32))
        cols += [s.mass[None], s.solid[None], s.fluid[None], s.delpress.T,
                 s.stress.reshape(n, 9).T, elig[None]]
    f = jnp.concatenate(cols, axis=0)
    if order is not None:
        f = f[:, order]
    num_cells = bt.cell_start.shape[0] - 2
    ints = jnp.stack([bt.cid, bt.home_count, bt.octant]).astype(jnp.int32)
    pad = ((0, 0), (0, n_pad - n))
    ints = jnp.pad(ints, pad)
    ints = ints.at[_CID, n:].set(num_cells)
    return jnp.pad(f, pad), ints


def _call(kernel, out_rows, col_start, f, ints, nb, cfg, g, gx,
          subbin_threshold, interpret, name):
    kern = functools.partial(kernel, cfg=cfg, g=g, gx=gx,
                             subbin_threshold=subbin_threshold)
    return pl.pallas_call(
        kern,
        out_shape=jax.ShapeDtypeStruct((NX * out_rows, nb * RB),
                                       jnp.float32),
        grid=(nb, NX),
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS,
                                             num_stages=NUM_STAGES),
        interpret=interpret,
        name=name,
    )(col_start.astype(jnp.int32), f, ints).reshape(NX, out_rows, -1)


def _combine(part, merge=False):
    """Add the NX programs' partial sums in a fixed order; with merging
    on, the last two rows hold (best distance, its row) per program and
    combine to the nearest partner, the lowest row on equal distances."""
    if not merge:
        return jnp.sum(part, axis=0)
    sums = jnp.sum(part[:, :_A_OUT], axis=0)
    d, row = part[:, _A_BESTD], part[:, _A_BESTROW]
    best = jnp.min(d, axis=0)
    best_row = jnp.min(jnp.where(d == best[None], row, _BIG), axis=0)
    return jnp.concatenate([sums, best[None], best_row[None]], axis=0)


def _to_pool(res, n, order):
    """(rows, nb*RB) sorted-order results -> (n, rows), in pool order
    when ``order`` is given."""
    res = res[:, :n].T
    if order is None:
        return res
    return jnp.zeros_like(res).at[order].set(res)


def _col_start(bt, g, gx):
    # col_start[c] = first sorted row of (x, y) column c
    return bt.cell_start[0:gx * g * g + 1:g]


def base_forces(state: ParticleState, bt: BinTable, cfg: SPHConfig, *,
                order=None, grid=None, subbin_threshold=None,
                interpret=False):
    """(sum_w, dpress) of the base force kernel (FluidGPU.cu:224-281).
    ``state`` is cell-sorted with ``grid`` (binning.GridSpec, None = the
    full cube), or unsorted with ``order`` (binning.sort_tables), in
    which case the results come back in pool order."""
    g, gx = _extents(cfg, grid)
    n = state.capacity
    nb, n_pad = _padded(n)
    f, ints = _pack(state, bt, cfg, order, n_pad, unidyn=False)
    out = _call(_base_kernel, _BASE_OUT, _col_start(bt, g, gx), f, ints,
                nb, cfg, g, gx, subbin_threshold, interpret,
                "sph_base_pairs")
    res = _to_pool(_combine(out), n, order)
    return res[:, 0], res[:, 1:4]


def unidyn_forces(state: ParticleState, bt: BinTable, cfg: SPHConfig, *,
                  order=None, grid=None, drift_fix=None,
                  subbin_threshold=None, interpret=False):
    """Every unidyn pair accumulator (the pair fields of
    forces.ForceAccum plus ``has_pair`` and ``merge_partner``) as a
    dict, from the two kernel passes.

    ``drift_fix``: optional (sdv, fdv) -> (sdv, fdv) hook run between
    pass A and pass B on sorted-order drift velocities — where the
    sharded step replaces halo particles' locally incomplete drifts by
    the owners' values (same contract as forces.compute_forces).  Only
    with ``order=None``.  Not itself jitted: the hook closes over the
    caller's traced values."""
    if drift_fix is not None and order is not None:
        raise ValueError("drift_fix needs the sorted pool (order=None)")
    g, gx = _extents(cfg, grid)
    n = state.capacity
    nb, n_pad = _padded(n)
    f, ints = _pack(state, bt, cfg, order, n_pad, unidyn=True)
    col_start = _col_start(bt, g, gx)
    merge = cfg.merge_dist > 0
    res_a = _combine(_call(_unidyn_a_kernel, _A_OUT + (2 if merge else 0),
                           col_start, f, ints, nb, cfg, g, gx,
                           subbin_threshold, interpret,
                           "sph_unidyn_pairs_a"), merge)
    sdv = res_a[_A_SDV:_A_SDV + 3, :n]
    fdv = res_a[_A_FDV:_A_FDV + 3, :n]
    if drift_fix is not None:
        sdv_t, fdv_t = drift_fix(sdv.T, fdv.T)
        sdv, fdv = sdv_t.T, fdv_t.T
    drift = jnp.pad(jnp.concatenate([sdv, fdv], axis=0),
                    ((0, 0), (0, n_pad - n)))
    res_b = _combine(_call(_unidyn_b_kernel, _B_OUT, col_start,
                           jnp.concatenate([f, drift], axis=0), ints, nb,
                           cfg, g, gx, subbin_threshold, interpret,
                           "sph_unidyn_pairs_b"))
    a = _to_pool(res_a, n, order)
    b = _to_pool(res_b, n, order)
    if merge:
        best = a[:, _A_BESTROW].astype(jnp.int32)
        found = a[:, _A_BESTD] < _BIG
        rows = jnp.clip(best, 0, n - 1)
        partner = jnp.where(found, rows if order is None else order[rows],
                            -1)
    else:
        partner = jnp.full((n,), -1, jnp.int32)
    dens = state.dens
    return dict(
        sum_w=a[:, _A_SUMW],
        dpress=a[:, _A_DP:_A_DP + 3],
        diffusion=a[:, _A_DIFF:_A_DIFF + 3],
        vel_grad=(a[:, _A_VG:_A_VG + 9] / dens[:, None]).reshape(n, 3, 3),
        stress_accel=a[:, _A_SA:_A_SA + 3] / (dens * dens)[:, None],
        solid_drift=_to_pool(sdv, n, order),
        fluid_drift=_to_pool(fdv, n, order),
        mixture_accel=b[:, _B_MA:_B_MA + 3],
        delsolid=b[:, _B_DSOL],
        delfluid=b[:, _B_DFLU],
        has_pair=a[:, _A_CNT] > 0,
        merge_partner=partner,
    )
