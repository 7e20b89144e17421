"""Tests for the Stam stable-fluids grid module."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tpufluids.grid import stam


def seeded2d(cfg, seed=0):
    rng = np.random.default_rng(seed)
    s = stam.make_grid2d(cfg)
    shape = s.u.shape
    return s.replace(
        u=jnp.asarray(rng.normal(0, 0.5, shape), jnp.float32),
        v=jnp.asarray(rng.normal(0, 0.5, shape), jnp.float32),
        dens=jnp.asarray(rng.uniform(0, 1, shape), jnp.float32))


def seeded3d(cfg, seed=0):
    rng = np.random.default_rng(seed)
    s = stam.make_grid3d(cfg)
    shape = s.u.shape
    return s.replace(
        u=jnp.asarray(rng.normal(0, 0.5, shape), jnp.float32),
        v=jnp.asarray(rng.normal(0, 0.5, shape), jnp.float32),
        w=jnp.asarray(rng.normal(0, 0.5, shape), jnp.float32),
        dens=jnp.asarray(rng.uniform(0, 1, shape), jnp.float32))


def test_projection_reduces_divergence_2d():
    """The collocated central-difference divergence retains a
    checkerboard null space (it cannot reach 0 in Stam's scheme), but
    projection must reduce it and the Poisson solve must converge."""
    cfg = stam.StamConfig(n=32, jacobi_iters=200)
    s = seeded2d(cfg)
    div0 = float(np.abs(stam.divergence2d(s.u, s.v)).max())
    u, v, res = stam.project2d(s.u, s.v, cfg, with_residual=True)
    div1 = float(np.abs(stam.divergence2d(u, v)).max())
    assert div1 < 0.8 * div0
    assert float(res) < 0.02 * div0


def test_projection_reduces_divergence_3d():
    cfg = stam.StamConfig(n=16, jacobi_iters=200)
    s = seeded3d(cfg)
    div0 = float(np.abs(stam.divergence3d(s.u, s.v, s.w)).max())
    u, v, w, res = stam.project3d(s.u, s.v, s.w, cfg, with_residual=True)
    div1 = float(np.abs(stam.divergence3d(u, v, w)).max())
    assert div1 < 0.9 * div0  # 3D random noise is checkerboard-heavy
    assert float(res) < 0.02 * div0


def test_red_black_converges_faster_than_jacobi():
    s = seeded3d(stam.StamConfig(n=16))
    out = {}
    for rb in (False, True):
        cfg = stam.StamConfig(n=16, jacobi_iters=40, red_black=rb)
        *_, res = stam.project3d(s.u, s.v, s.w, cfg, with_residual=True)
        out[rb] = float(res)
    assert out[True] < out[False]


def test_more_jacobi_iters_lower_residual():
    s = seeded3d(stam.StamConfig(n=16))
    res = []
    for iters in (5, 20, 80):
        cfg = stam.StamConfig(n=16, jacobi_iters=iters)
        *_, r = stam.project3d(s.u, s.v, s.w, cfg, with_residual=True)
        res.append(float(r))
    assert res[2] < res[1] < res[0]


def test_advection_conserves_mass_approximately():
    cfg = stam.StamConfig(n=32, dt=0.05)
    s = seeded2d(cfg, seed=2)
    m0 = float(np.asarray(s.dens[1:-1, 1:-1]).sum())
    d = stam.advect2d(0, s.dens, s.u, s.v, cfg)
    m1 = float(np.asarray(d[1:-1, 1:-1]).sum())
    assert abs(m1 - m0) / m0 < 0.15  # semi-Lagrangian is dissipative


def test_diffusion_smooths_and_conserves_sign():
    cfg = stam.StamConfig(n=32, dt=0.1)
    s = stam.make_grid2d(cfg)
    dens = np.zeros_like(np.asarray(s.dens))
    dens[16, 16] = 1.0
    out = np.asarray(stam.diffuse2d(0, jnp.asarray(dens), cfg, coeff=0.01, iters=40))
    assert out[16, 16] < 1.0
    assert out[15, 16] > 0.0
    assert out.min() >= -1e-6


def test_set_bnd_reflects_normal_component():
    cfg = stam.StamConfig(n=8)
    s = seeded3d(cfg, seed=3)
    u = stam.set_bnd3d(1, s.u)
    np.testing.assert_allclose(np.asarray(u[0, :, :]),
                               -np.asarray(u[1, :, :]))
    v = stam.set_bnd3d(2, s.v)
    np.testing.assert_allclose(np.asarray(v[:, 0, :]),
                               -np.asarray(v[:, 1, :]))
    d = stam.set_bnd3d(0, s.dens)
    np.testing.assert_allclose(np.asarray(d[0, :, :]),
                               np.asarray(d[1, :, :]))


def test_buoyancy_plume_rises():
    """BASELINE config 4: temperature + gravity forcing produces an
    upward plume."""
    cfg = stam.StamConfig(n=24, dt=0.05, jacobi_iters=30,
                          buoyancy_alpha=0.05, buoyancy_beta=1.0,
                          ambient_temp=0.0)
    s = stam.make_grid3d(cfg)
    temp = np.zeros_like(np.asarray(s.temp))
    dens = np.zeros_like(np.asarray(s.dens))
    temp[10:14, 10:14, 2:4] = 5.0   # hot pocket near the floor
    dens[10:14, 10:14, 2:4] = 1.0
    s = s.replace(temp=jnp.asarray(temp), dens=jnp.asarray(dens))
    s, res = stam.run3d(s, cfg, 20)
    dens_out = np.asarray(s.dens)
    # center of mass moved up in z
    z = np.arange(dens_out.shape[2])
    com0 = (dens[1:-1, 1:-1, 1:-1].sum(axis=(0, 1)) * z[1:-1]).sum() / max(
        dens[1:-1, 1:-1, 1:-1].sum(), 1e-9)
    com1 = (dens_out[1:-1, 1:-1, 1:-1].sum(axis=(0, 1)) * z[1:-1]).sum() / (
        dens_out[1:-1, 1:-1, 1:-1].sum() + 1e-9)
    assert com1 > com0 + 0.5
    assert np.isfinite(dens_out).all()


def test_vorticity_confinement_preserves_stability():
    cfg = stam.StamConfig(n=24, dt=0.02, jacobi_iters=20,
                          vorticity_eps=5.0)
    s = seeded3d(cfg, seed=4)
    s, res = stam.run3d(s, cfg, 10)
    assert np.isfinite(np.asarray(s.u)).all()
    assert float(res[-1]) < 1.0


def test_smoke_box_2d_runs():
    """BASELINE config 1: 128x128 smoke box, 20 Jacobi iters."""
    cfg = stam.StamConfig(n=128, dt=0.1, diff=1e-5, visc=1e-5,
                          jacobi_iters=20)
    s = stam.make_grid2d(cfg)
    src = np.zeros_like(np.asarray(s.dens))
    src[60:68, 4:8] = 5.0
    fv = np.zeros_like(src)
    fv[60:68, 4:8] = 2.0
    for _ in range(5):
        s = stam.step2d(s, cfg, sources={"dens": src, "fv": fv})
    assert np.isfinite(np.asarray(s.dens)).all()
    assert float(np.asarray(s.dens).max()) > 0
    # divergence stays small after projection
    assert float(np.abs(stam.divergence2d(s.u, s.v)).max()) < 0.5


def test_run3d_python_zg_resident_matches_per_step():
    """run3d_python (one jitted dispatch per step, residual on the last
    step only) is bit-identical to stepping the same jitted step by
    hand."""
    cfg = stam.StamConfig(n=16, dt=0.05, diff=1e-5, visc=1e-5,
                          jacobi_iters=4, red_black=True,
                          advect_mode="stencil", buoyancy_alpha=0.05,
                          buoyancy_beta=1.0, vorticity_eps=2.0)
    s = stam.make_grid3d(cfg)
    s = s.replace(
        dens=stam.set_bnd3d(0, s.dens.at[6:10, 6:10, 2:5].set(1.0)),
        temp=stam.set_bnd3d(0, s.temp.at[6:10, 6:10, 2:5].set(3.0)))
    step = jax.jit(lambda s: stam.step3d(s, cfg))
    last = jax.jit(lambda s: stam.step3d(s, cfg, with_residual=True))
    ref = s
    for _ in range(2):
        ref = step(ref)
    ref, rres = last(ref)
    got, gres = stam.run3d_python(s, cfg, 3)
    for f in ("u", "v", "w", "dens", "temp"):
        np.testing.assert_array_equal(np.asarray(getattr(got, f)),
                                      np.asarray(getattr(ref, f)),
                                      err_msg=f)
    np.testing.assert_array_equal(np.asarray(gres[-1]), np.asarray(rres))
