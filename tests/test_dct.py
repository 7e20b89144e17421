"""Spectral (DCT) projection option: exact solve of the Neumann
Poisson system, and integration into the 3D step."""

import numpy as np
import jax.numpy as jnp
import pytest

from tpufluids.grid import stam

from test_multigrid import _rand_rhs


def test_dct_solves_poisson_to_roundoff():
    """The DCT diagonalization solves the ghosted system exactly up to
    float32 transform roundoff — orders of magnitude below 20 red-black
    sweeps."""
    n = 32
    x0 = _rand_rhs(n)
    p = stam.dct_solve3d(x0)
    res = float(stam.poisson_residual3d(p, x0))
    p_rb = stam.lin_solve3d(0, jnp.zeros_like(x0), x0, 1.0, 6.0, 20,
                            red_black=True)
    res_rb = float(stam.poisson_residual3d(p_rb, x0))
    assert res < 2e-5
    assert res < 0.05 * res_rb


def test_dct_gauge_is_mean_free():
    """The q=0 gauge leaves a mean-free pressure (any constant shift
    solves the singular system; the spectral gauge pins it)."""
    n = 16
    x0 = _rand_rhs(n, seed=3)
    p = stam.dct_solve3d(x0)
    assert abs(float(jnp.mean(p[1:-1, 1:-1, 1:-1]))) < 1e-6


def test_step3d_with_dct_projection():
    n = 24
    cfg = stam.StamConfig(n=n, dt=0.02, jacobi_iters=8, red_black=True,
                          projection="dct", buoyancy_beta=0.5)
    s = stam.make_grid3d(cfg)
    s = s.replace(temp=s.temp.at[8:16, 8:16, 2:6].set(2.0),
                  dens=s.dens.at[8:16, 8:16, 2:6].set(1.0))
    s, res = stam.run3d(s, cfg, 4)
    for f in ("u", "v", "w", "dens", "temp"):
        assert bool(jnp.all(jnp.isfinite(getattr(s, f)))), f
    # exact projection: residual at roundoff while jacobi would be ~1e-3
    assert float(res[-1]) < 1e-4


def test_mac_with_dct_projection_kills_divergence():
    from tpufluids.grid import mac
    n = 24
    cfg = stam.StamConfig(n=n, dt=0.02, projection="dct",
                          buoyancy_beta=0.5)
    s = mac.make_mac3d(cfg)
    s = s.replace(temp=s.temp.at[8:16, 8:16, 2:6].set(2.0))
    s, res = mac.run3d_python(s, cfg, 4)
    # exact face-difference projection: post-step divergence ~ roundoff
    assert float(res[-1]) < 1e-4


def test_dct2d_solves_poisson_to_roundoff():
    n = 32
    rng = np.random.default_rng(7)
    r = rng.normal(0, 1, (n, n)).astype(np.float32)
    r -= r.mean()
    x0 = jnp.zeros((n + 2,) * 2, jnp.float32).at[1:-1, 1:-1].set(r)
    x0 = stam.set_bnd2d(0, x0)
    p = stam.dct_solve2d(x0)
    res = float(stam.poisson_residual2d(p, x0))
    # roundoff-level: ~|p| * eps (2D solutions scale with n^2/pi^2);
    # 20 jacobi sweeps leave ~0.5 on this system
    p_j = stam.lin_solve2d(0, jnp.zeros_like(x0), x0, 1.0, 4.0, 20)
    res_j = float(stam.poisson_residual2d(p_j, x0))
    assert res < 1e-4
    assert res < 1e-3 * res_j


def test_step2d_with_dct_projection():
    n = 32
    cfg = stam.StamConfig(n=n, dt=0.05, projection="dct",
                          buoyancy_beta=0.5)
    s = stam.make_grid2d(cfg)
    s = s.replace(dens=s.dens.at[12:20, 2:6].set(1.0),
                  temp=s.temp.at[12:20, 2:6].set(2.0))
    for _ in range(5):
        s = stam.step2d(s, cfg)
    for f in ("u", "v", "dens", "temp"):
        assert bool(jnp.all(jnp.isfinite(getattr(s, f)))), f


def test_dct_precision_tiers_solve_and_order():
    """dct_precision plumbs through to the transform matmuls: every
    tier solves the system far below the 20-sweep Jacobi residual on
    CPU-sized grids, and cannot beat the full-float32 tier.  (The
    GPU residual and time of each tier are in PERF.md.)"""
    n = 32
    x0 = _rand_rhs(n, seed=5)
    res = {}
    for prec in ("highest", "high", "default"):
        cfg = stam.StamConfig(n=n, projection="dct", dct_precision=prec)
        p = stam.dct_solve3d(x0, cfg)
        res[prec] = float(stam.poisson_residual3d(p, x0))
        assert np.isfinite(res[prec])
    # 20 red-black sweeps for scale
    p_rb = stam.lin_solve3d(0, jnp.zeros_like(x0), x0, 1.0, 6.0, 20,
                            red_black=True)
    res_rb = float(stam.poisson_residual3d(p_rb, x0))
    assert res["highest"] <= res["high"] * 1.01
    assert res["highest"] <= res["default"] * 1.01
    # on CPU all precisions lower to f32 dots; on a GPU "high" and
    # "default" run in TF32 — here just require every tier to be a
    # valid solve
    assert res["default"] < res_rb or res["default"] < 1e-4


def test_dct_radix_split_matches_dense():
    """One radix-2 split level (fold + DCT-II/DCT-IV half blocks with
    permuted eigenvalues) is the same exact solve as the dense
    single-matmul transform, to f32 roundoff — on even extents, on
    mixed even/odd-extent ranks, and bitwise on axes below the
    threshold."""
    rng = np.random.default_rng(11)
    for shape in ((32, 32, 32), (16, 32, 48), (64, 64)):
        x = jnp.asarray(rng.normal(size=shape), jnp.float32)
        a = stam._dct_solve_interior(x, "highest", 0)
        b = stam._dct_solve_interior(x, "highest", 16)
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=0, atol=2e-5 * float(
                                       jnp.max(jnp.abs(a))))
    # odd extents fall back to the dense path bitwise
    x = jnp.asarray(rng.normal(size=(15, 15)), jnp.float32)
    np.testing.assert_array_equal(
        np.asarray(stam._dct_solve_interior(x, "highest", 0)),
        np.asarray(stam._dct_solve_interior(x, "highest", 2)))


def test_dct_radix_solves_poisson():
    """The radix split plumbs through dct_solve3d via
    StamConfig.dct_radix_min and still solves to roundoff."""
    n = 32
    x0 = _rand_rhs(n, seed=9)
    cfg = stam.StamConfig(n=n, projection="dct", dct_radix_min=16)
    p = stam.dct_solve3d(x0, cfg)
    assert float(stam.poisson_residual3d(p, x0)) < 2e-5
    # mean-free gauge up to fold/unfold reassociation roundoff
    # (solution magnitude ~3.6 at f32)
    assert abs(float(jnp.mean(p[1:-1, 1:-1, 1:-1]))) < 5e-6


def test_dct_radix_levels_match_dense():
    """radix_levels=2/3 (recursive even-branch split, r5) still solve
    to roundoff of the dense path at every precision combination the
    auto default can produce."""
    import numpy as np

    from tpufluids.grid.stam import _dct_solve_interior

    rng = np.random.default_rng(3)
    xi = jnp.asarray(rng.standard_normal((32, 32, 32)), jnp.float32)
    dense = _dct_solve_interior(xi, "highest", 0)
    scale = float(jnp.max(jnp.abs(dense)))
    for lv in (1, 2, 3):
        out = _dct_solve_interior(xi, "highest", 8, lv)
        np.testing.assert_allclose(np.asarray(out), np.asarray(dense),
                                   atol=5e-6 * scale,
                                   err_msg=f"levels={lv}")


def test_dct_precision_first_schedule():
    """dct_precision_first (r5): the pre-advection solve runs the
    cheap tier, the post-advect solve stays exact — so per-step
    residuals stay at the exact-solve level while the fields track the
    all-highest schedule closely."""
    import numpy as np

    base = stam.StamConfig(n=32, dt=0.5 / 32, projection="dct",
                           red_black=True, advect_mode="stencil",
                           vorticity_eps=1.0, buoyancy_beta=0.5,
                           buoyancy_alpha=0.05)
    mixed = base.replace(dct_precision_first="default")

    def run(cfg):
        s = stam.make_grid3d(cfg)
        s = s.replace(dens=s.dens.at[12:20, 12:20, 1:5].set(1.0),
                      temp=s.temp.at[12:20, 12:20, 1:5].set(2.0))
        s, res = stam.run3d_python(s, cfg, 4)
        return s, float(res[-1])

    s_hi, r_hi = run(base)
    s_mx, r_mx = run(mixed)
    # residual = post-advect (exact) solve quality in BOTH schedules
    assert r_mx < 1e-5 and r_hi < 1e-5, (r_mx, r_hi)
    assert r_mx < 100 * max(r_hi, 1e-12)
    for f in ("u", "v", "w", "dens", "temp"):
        a = np.asarray(getattr(s_mx, f))
        b = np.asarray(getattr(s_hi, f))
        scale = max(1.0, np.abs(b).max())
        np.testing.assert_allclose(a, b, atol=5e-3 * scale, err_msg=f)


@pytest.mark.parametrize("precision", ["highest", "high", "default"])
@pytest.mark.parametrize("radix_min", [0, 4])
@pytest.mark.parametrize("n", [6, 8, 12, 16])
def test_dct_solve_matches_float64_reference(n, radix_min, precision):
    """The spectral solve, dense or radix-split, at every precision
    tier, against a float64 DCT-II solve (scipy).  On the CPU every
    tier computes in float32, so each must reach float32 roundoff;
    on a GPU "high"/"default" run in TF32 (see PERF.md for the tier
    residuals measured there)."""
    import numpy as np

    from test_stam_reference import np_dct_interior
    from tpufluids.grid.stam import _dct_solve_interior

    rng = np.random.default_rng(n + radix_min)
    xi = rng.standard_normal((n, n + 2, n)).astype(np.float32)
    xi -= xi.mean()
    want = np_dct_interior(xi.astype(np.float64))
    got = _dct_solve_interior(jnp.asarray(xi), precision, radix_min)
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=2e-5 * scale)
