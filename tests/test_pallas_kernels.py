"""The SPH cell-list kernel (tpufluids/sph_triton.py) under the Pallas
interpreter, against the XLA pair pass and the float64 oracle, and the
XLA stencil advection against the gather formulation."""

import numpy as np
import jax.numpy as jnp
import pytest

from tpufluids.grid import stam



@pytest.mark.parametrize("nd", [2, 3])
def test_stencil_advection_matches_gather_under_cfl(nd):
    rng = np.random.default_rng(3)
    n = 20
    cfg = stam.StamConfig(n=n, dt=0.03)
    shape = (n + 2,) * nd
    q = jnp.asarray(rng.uniform(0, 1, shape), jnp.float32)
    vel = [jnp.asarray(rng.uniform(-0.8, 0.8, shape), jnp.float32)
           for _ in range(nd)]
    if nd == 2:
        a = stam.advect2d(0, q, *vel, cfg)
        b = stam.advect2d_stencil(0, q, *vel, cfg)
    else:
        a = stam.advect3d(0, q, *vel, cfg)
        b = stam.advect3d_stencil(0, q, *vel, cfg)
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=3e-6)


def test_stencil_advection_clamps_beyond_one_cell():
    """Backtraces > 1 cell clamp (documented CFL limit) instead of
    producing garbage."""
    n = 16
    cfg = stam.StamConfig(n=n, dt=1.0)  # dt0 = 16 -> huge displacement
    rng = np.random.default_rng(4)
    q = jnp.asarray(rng.uniform(0, 1, (n + 2,) * 3), jnp.float32)
    u = jnp.full((n + 2,) * 3, 2.0, jnp.float32)
    out = stam.advect3d_stencil(0, q, u, u, u, cfg)
    o = np.asarray(out)
    assert np.isfinite(o).all()
    assert o.min() >= -1e-5 and o.max() <= 1.0 + 1e-5


def test_run3d_python_matches_scan():
    cfg = stam.StamConfig(n=12, dt=0.02, jacobi_iters=8,
                          buoyancy_beta=0.5, advect_mode="stencil")
    s = stam.make_grid3d(cfg)
    s = s.replace(temp=s.temp.at[4:8, 4:8, 2:4].set(2.0),
                  dens=s.dens.at[4:8, 4:8, 2:4].set(1.0))
    a, res_a = stam.run3d(s, cfg, 4)
    b, res_b = stam.run3d_python(s, cfg, 4)
    for f in ("u", "v", "w", "dens", "temp"):
        np.testing.assert_array_equal(np.asarray(getattr(a, f)),
                                      np.asarray(getattr(b, f)), err_msg=f)
    np.testing.assert_allclose(float(res_a[-1]), float(res_b[-1]))


def test_sph_force_kernel_matches_xla_interpret():
    from tpufluids import binning
    from tpufluids.config import BASE_CONFIG
    from tpufluids.forces import compute_forces
    from tpufluids.scenes import random_blob
    from tpufluids.sph_triton import base_forces
    cfg = BASE_CONFIG.replace(max_per_cell=32, grid_size=8, cell_size=0.25)
    state = random_blob(150, seed=9, cfg=cfg, span=0.6, boundary_frac=0.2)
    ss, bt = binning.sort_by_cell(state, cfg)
    ref = compute_forces(ss, bt, cfg)
    sw, dp = base_forces(ss, bt, cfg, interpret=True)
    np.testing.assert_allclose(np.asarray(sw), np.asarray(ref.sum_w),
                               rtol=1e-4, atol=1e-4)
    scale = max(1.0, float(np.abs(np.asarray(ref.dpress)).max()))
    np.testing.assert_allclose(np.asarray(dp), np.asarray(ref.dpress),
                               rtol=1e-4, atol=1e-5 * scale)


def test_sph_step_with_pallas_backend_interpret():
    from tpufluids.config import BASE_CONFIG
    from tpufluids.oracle import state_to_dict
    from tpufluids.scenes import random_blob
    from tpufluids.step import sph_step
    cfg = BASE_CONFIG.replace(max_per_cell=32, grid_size=8, cell_size=0.25)
    state = random_blob(100, seed=10, cfg=cfg, span=0.6)
    ref, _ = sph_step(state, cfg)
    got, m = sph_step(state, cfg.replace(force_backend="interpret"))
    rd = state_to_dict(ref)
    gd = state_to_dict(got)
    ri, gi = np.argsort(rd["pid"]), np.argsort(gd["pid"])
    for f in ("pos", "vel", "dens"):
        np.testing.assert_allclose(gd[f][gi], rd[f][ri], rtol=1e-4,
                                   atol=1e-5, err_msg=f)


def test_unidyn_force_kernel_matches_xla_interpret():
    import sys
    from tpufluids import binning
    from tpufluids.config import UNIDYN_CONFIG
    from tpufluids.forces import compute_forces
    from tpufluids.sph_triton import unidyn_forces
    sys.path.insert(0, "tests")
    from test_forces_vs_oracle import mixed_blob
    cfg = UNIDYN_CONFIG.replace(max_per_cell=32, grid_size=8,
                                cell_size=0.25)
    state = mixed_blob(150, 7, cfg, span=0.5)
    ss, bt = binning.sort_by_cell(state, cfg)
    ref = compute_forces(ss, bt, cfg)
    got = unidyn_forces(ss, bt, cfg, interpret=True)
    for name, a in (("sum_w", ref.sum_w), ("dpress", ref.dpress),
                    ("diffusion", ref.diffusion),
                    ("vel_grad", ref.vel_grad),
                    ("stress_accel", ref.stress_accel),
                    ("solid_drift", ref.solid_drift),
                    ("fluid_drift", ref.fluid_drift),
                    ("mixture_accel", ref.mixture_accel),
                    ("delsolid", ref.delsolid),
                    ("delfluid", ref.delfluid)):
        a = np.asarray(a)
        b = np.asarray(got[name])
        scale = max(1.0, np.abs(a).max())
        np.testing.assert_allclose(b, a, rtol=1e-4, atol=1e-5 * scale,
                                   err_msg=name)
    # split trigger derived from the kernel's pair count must match the
    # XLA trigger exactly
    from tpufluids.forces import compute_split_trigger
    split = compute_split_trigger(ss, got["diffusion"], got["has_pair"],
                                  cfg)
    np.testing.assert_array_equal(np.asarray(split),
                                  np.asarray(ref.split_trigger))


def test_unidyn_step_with_pallas_backend_interpret():
    import sys
    from tpufluids.config import UNIDYN_CONFIG
    from tpufluids.oracle import state_to_dict
    from tpufluids.step import sph_step
    sys.path.insert(0, "tests")
    from test_forces_vs_oracle import mixed_blob
    cfg = UNIDYN_CONFIG.replace(max_per_cell=32, grid_size=8,
                                cell_size=0.25)
    state = mixed_blob(120, 11, cfg, span=0.5)
    ref, _ = sph_step(state, cfg)
    got, m = sph_step(state, cfg.replace(force_backend="interpret"))
    rd = state_to_dict(ref)
    gd = state_to_dict(got)
    ri, gi = np.argsort(rd["pid"]), np.argsort(gd["pid"])
    for f in ("pos", "vel", "dens", "solid", "fluid", "stress"):
        scale = max(1.0, np.abs(rd[f][ri]).max())
        np.testing.assert_allclose(gd[f][gi], rd[f][ri], rtol=1e-4,
                                   atol=1e-5 * scale, err_msg=f)


def test_unidyn_subbin_pallas_matches_oracle_interpret():
    """The octant sub-bin predicate inside the kernels (reference
    DEFAULT unidyn semantics, FluidGPU-unidyn.cu:181-192,
    579-583) matches both the XLA subbin path and the O(N^2) oracle."""
    import sys
    from tpufluids import binning
    from tpufluids.config import UNIDYN_CONFIG
    from tpufluids.forces import compute_forces
    from tpufluids.oracle import accumulate, state_to_dict
    from tpufluids.sph_triton import unidyn_forces
    sys.path.insert(0, "tests")
    from test_forces_vs_oracle import mixed_blob
    # default unidyn geometry (cell 0.12 ~ the 0.12 support) so the
    # octant restriction actually removes pairs; dense blob so several
    # home cells exceed the threshold
    cfg = UNIDYN_CONFIG.replace(max_per_cell=64)
    state = mixed_blob(150, 7, cfg, span=0.15)
    ss, bt = binning.sort_by_cell(state, cfg)
    ref = compute_forces(ss, bt, cfg, subbin_parity=True)
    full = compute_forces(ss, bt, cfg, subbin_parity=False)
    # the mode must actually bite on this blob
    assert not np.allclose(np.asarray(ref.sum_w), np.asarray(full.sum_w))
    got = unidyn_forces(ss, bt, cfg, subbin_threshold=6, interpret=True)
    for name, a in (("sum_w", ref.sum_w), ("dpress", ref.dpress),
                    ("diffusion", ref.diffusion),
                    ("vel_grad", ref.vel_grad),
                    ("stress_accel", ref.stress_accel),
                    ("solid_drift", ref.solid_drift),
                    ("fluid_drift", ref.fluid_drift),
                    ("mixture_accel", ref.mixture_accel),
                    ("delsolid", ref.delsolid),
                    ("delfluid", ref.delfluid)):
        a = np.asarray(a)
        b = np.asarray(got[name])
        scale = max(1.0, np.abs(a).max())
        np.testing.assert_allclose(b, a, rtol=1e-4, atol=1e-5 * scale,
                                   err_msg=name)
    # and against the float64 oracle in subbin mode
    oacc = accumulate(state_to_dict(ss), cfg, "subbin")
    for name, o in (("sum_w", oacc.sum_w), ("dpress", oacc.dpress)):
        o = np.asarray(o)
        b = np.asarray(got[name])
        scale = max(1.0, np.abs(o).max())
        np.testing.assert_allclose(b, o, rtol=2e-4, atol=1e-5 * scale,
                                   err_msg="oracle_" + name)


def test_rowblock_base_matches_xla_interpret():
    """The kernel's home blocks (consecutive sorted rows, per-pair cell
    masks, no capacity cap) vs the XLA pass, in sorted and pool order."""
    from tpufluids import binning
    from tpufluids.config import BASE_CONFIG
    from tpufluids.forces import compute_forces
    from tpufluids.scenes import random_blob
    from tpufluids.sph_triton import base_forces
    cfg = BASE_CONFIG.replace(max_per_cell=32, grid_size=8, cell_size=0.25)
    state = random_blob(300, seed=9, cfg=cfg, span=0.6, boundary_frac=0.2)
    ss, bt = binning.sort_by_cell(state, cfg)
    ref = compute_forces(ss, bt, cfg)
    # sorted mode
    sw, dp = base_forces(ss, bt, cfg, interpret=True)
    np.testing.assert_allclose(np.asarray(sw), np.asarray(ref.sum_w),
                               rtol=1e-4, atol=1e-4)
    scale = max(1.0, float(np.abs(np.asarray(ref.dpress)).max()))
    np.testing.assert_allclose(np.asarray(dp), np.asarray(ref.dpress),
                               rtol=1e-4, atol=1e-5 * scale)
    # order mode (unsorted pool)
    from tpufluids.binning import sort_tables
    order, bt2 = sort_tables(state, cfg)
    sw2, dp2 = base_forces(state, bt2, cfg, order=order,
                           interpret=True)
    # pid-match against the sorted reference
    pid_s = np.asarray(ss.pid)
    pid_o = np.asarray(state.pid)
    mp = {int(p): i for i, p in enumerate(pid_s)}
    perm = np.array([mp[int(p)] for p in pid_o])
    np.testing.assert_allclose(np.asarray(sw2), np.asarray(ref.sum_w)[perm],
                               rtol=1e-4, atol=1e-4)


def test_rowblock_unidyn_subbin_matches_xla_interpret():
    """Unidyn kernels incl. the per-pair octant predicate."""
    import sys
    from tpufluids import binning
    from tpufluids.config import UNIDYN_CONFIG
    from tpufluids.forces import compute_forces
    from tpufluids.sph_triton import unidyn_forces
    sys.path.insert(0, "tests")
    from test_forces_vs_oracle import mixed_blob
    cfg = UNIDYN_CONFIG.replace(max_per_cell=64)
    state = mixed_blob(150, 7, cfg, span=0.15)
    ss, bt = binning.sort_by_cell(state, cfg)
    ref = compute_forces(ss, bt, cfg, subbin_parity=True)
    got = unidyn_forces(ss, bt, cfg, subbin_threshold=6, interpret=True)
    for name, a in (("sum_w", ref.sum_w), ("dpress", ref.dpress),
                    ("diffusion", ref.diffusion),
                    ("vel_grad", ref.vel_grad),
                    ("stress_accel", ref.stress_accel),
                    ("solid_drift", ref.solid_drift),
                    ("fluid_drift", ref.fluid_drift),
                    ("mixture_accel", ref.mixture_accel),
                    ("delsolid", ref.delsolid),
                    ("delfluid", ref.delfluid)):
        a = np.asarray(a)
        b = np.asarray(got[name])
        scale = max(1.0, np.abs(a).max())
        np.testing.assert_allclose(b, a, rtol=1e-4, atol=1e-5 * scale,
                                   err_msg=name)


def test_unidyn_merge_partner_matches_xla_interpret():
    """Merge-enabled pass A (FluidGPU-unidyn.cu:261-275): the in-kernel
    nearest-eligible-partner search returns the XLA path's partner rows
    exactly, as sorted rows and, in pool-order mode, as pool rows."""
    import sys
    from tpufluids import binning
    from tpufluids.config import UNIDYN_CONFIG
    from tpufluids.forces import compute_forces
    from tpufluids.binning import sort_tables
    from tpufluids.sph_triton import unidyn_forces
    sys.path.insert(0, "tests")
    from test_forces_vs_oracle import mixed_blob
    cfg = UNIDYN_CONFIG.replace(max_per_cell=32, grid_size=8,
                                cell_size=0.25, merge_dist=0.12)
    state = mixed_blob(150, 7, cfg, span=0.5)
    ss, bt = binning.sort_by_cell(state, cfg)
    ref = compute_forces(ss, bt, cfg)
    assert int((np.asarray(ref.merge_partner) >= 0).sum()) > 10, \
        "scene must exercise the partner search"
    got = unidyn_forces(ss, bt, cfg, interpret=True)
    np.testing.assert_array_equal(np.asarray(got["merge_partner"]),
                                  np.asarray(ref.merge_partner))
    # pool-order mode reports partners as pool rows
    order, bt2 = sort_tables(state, cfg)
    got2 = unidyn_forces(state, bt2, cfg, order=order, interpret=True)
    pool_of_sorted = np.asarray(ss.pid)      # pid == pool row here
    want = np.full(state.capacity, -1)
    mp = np.asarray(ref.merge_partner)
    want[pool_of_sorted] = np.where(mp >= 0, pool_of_sorted[mp], -1)
    np.testing.assert_array_equal(np.asarray(got2["merge_partner"]), want)


def test_unidyn_step_merge_pallas_backend_interpret():
    """End-to-end merge on the kernel backend (sort_tables pool-order
    mode): mutual pairs merge identically to the XLA backend, including
    alive count and absorber masses."""
    from tpufluids.config import UNIDYN_CONFIG
    from tpufluids.oracle import state_to_dict
    from tpufluids.state import make_state
    from tpufluids.step import sph_step
    cfg = UNIDYN_CONFIG.replace(max_per_cell=32, grid_size=16,
                                cell_size=0.125, merge_dist=0.05)
    pts = [[-0.515, 0.3, 0.1], [-0.485, 0.3, 0.1],   # pair
           [0.4, -0.3, 0.2], [0.43, -0.3, 0.2],      # pair
           [-0.6, 0.1, -0.2], [0.7, 0.5, 0.5]]       # singles
    state = make_state(np.array(pts, np.float32), cfg=cfg)
    ref = state
    for _ in range(2):
        ref, rm = sph_step(ref, cfg)
    got = state
    for _ in range(2):
        got, gm = sph_step(got, cfg.replace(force_backend="interpret"))
    assert int(gm.n_alive) == int(rm.n_alive) == 4
    rd, gd = state_to_dict(ref), state_to_dict(got)
    ri, gi = np.argsort(rd["pid"]), np.argsort(gd["pid"])
    for f in ("pos", "vel", "mass", "dens", "alive"):
        scale = max(1.0, np.abs(rd[f][ri]).max())
        np.testing.assert_allclose(gd[f][gi], rd[f][ri], rtol=1e-4,
                                   atol=1e-5 * scale, err_msg=f)
    assert (gd["mass"] == cfg.merge_mass_new).sum() == 2
