"""Golden-step tests: the binned, gather-based implementation must
match the dense O(N^2) NumPy oracle (stencil-masked) to float32
tolerance, for both variants, over multiple steps."""

import dataclasses

import numpy as np
import pytest

from tpufluids import binning
from tpufluids.config import BASE_CONFIG, UNIDYN_CONFIG
from tpufluids.forces import compute_forces
from tpufluids.oracle import accumulate, oracle_step, state_to_dict
from tpufluids.scenes import random_blob, unidyn_tank
from tpufluids.step import run_chunk, sph_step


def mixed_blob(n, seed, cfg, span=0.15, boundary_frac=0.15):
    """Random blob with mixed solid/fluid fractions to exercise the
    mixture and granular paths (the shipped scenes have pure phases)."""
    state = random_blob(n, seed=seed, cfg=cfg, span=span,
                        boundary_frac=boundary_frac)
    rng = np.random.default_rng(seed + 100)
    solid = rng.uniform(0.0, 1.0, n).astype(np.float32)
    # some pure particles too
    solid[rng.uniform(size=n) < 0.3] = 0.0
    solid[np.asarray(state.boundary)] = 1.0
    fluid = (1.0 - solid).astype(np.float32)
    stress = rng.normal(0, 1e-4, (n, 3, 3)).astype(np.float32)
    vel = rng.normal(0, 0.5, (n, 3)).astype(np.float32)
    delpress = rng.normal(0, 1e-3, (n, 3)).astype(np.float32)
    return state.replace(solid=solid, fluid=fluid, stress=stress,
                         vel=vel, delpress=delpress)


def assert_close(a, b, name, rtol=2e-4, atol=1e-6):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    scale = max(1.0, np.abs(b).max())
    np.testing.assert_allclose(a, b, rtol=rtol, atol=atol * scale,
                               err_msg=name)


@pytest.mark.parametrize("seed", [0, 1])
def test_base_forces_match_oracle(seed):
    cfg = BASE_CONFIG.replace(max_per_cell=32)
    state = random_blob(150, seed=seed, span=0.12, boundary_frac=0.2)
    sorted_state, bt = binning.sort_by_cell(state, cfg)
    assert int(bt.overflow) == 0
    acc = compute_forces(sorted_state, bt, cfg)
    oacc = accumulate(state_to_dict(sorted_state), cfg, "stencil")
    assert_close(acc.sum_w, oacc.sum_w, "sum_w")
    assert_close(acc.dpress, oacc.dpress, "dpress")


@pytest.mark.parametrize("seed", [0, 1])
def test_unidyn_forces_match_oracle(seed):
    cfg = UNIDYN_CONFIG.replace(max_per_cell=64)
    state = mixed_blob(120, seed, cfg, span=0.2)
    sorted_state, bt = binning.sort_by_cell(state, cfg)
    assert int(bt.overflow) == 0
    acc = compute_forces(sorted_state, bt, cfg)
    oacc = accumulate(state_to_dict(sorted_state), cfg, "stencil")
    assert_close(acc.sum_w, oacc.sum_w, "sum_w")
    assert_close(acc.dpress, oacc.dpress, "dpress")
    assert_close(acc.diffusion, oacc.diffusion, "diffusion")
    assert_close(acc.vel_grad, oacc.vel_grad, "vel_grad")
    assert_close(acc.stress_accel, oacc.stress_accel, "stress_accel")
    assert_close(acc.solid_drift, oacc.solid_drift, "solid_drift",
                 rtol=1e-3)
    assert_close(acc.fluid_drift, oacc.fluid_drift, "fluid_drift",
                 rtol=1e-3)
    assert_close(acc.mixture_accel, oacc.mixture_accel, "mixture_accel",
                 rtol=1e-3)
    assert_close(acc.delsolid, oacc.delsolid, "delsolid", rtol=1e-3)
    assert_close(acc.delfluid, oacc.delfluid, "delfluid", rtol=1e-3)


def test_unidyn_viscosity_own_mass_nonunit():
    """PARITY.md deviation #7: the unidyn viscosity uses the particle's
    OWN mass — the physically-intended term — where the reference reads
    the slot-indexed ``SPptr[i].mass`` of an unrelated particle
    (FluidGPU-unidyn.cu:307; inert with all-unit masses, live once
    merging produces masses 2.75/0).  Pin our semantics against the
    float64 oracle with non-unit masses so the merge-enabled regime is
    covered, not just the shipped all-ones scenes."""
    import jax.numpy as jnp

    cfg = UNIDYN_CONFIG.replace(max_per_cell=64)
    state = mixed_blob(120, 13, cfg, span=0.2)
    rng = np.random.default_rng(42)
    mass = np.ones(120, np.float32)
    mass[rng.uniform(size=120) < 0.3] = 2.75   # post-merge absorbers
    state = state.replace(mass=jnp.asarray(mass))
    sorted_state, bt = binning.sort_by_cell(state, cfg)
    acc = compute_forces(sorted_state, bt, cfg)
    oacc = accumulate(state_to_dict(sorted_state), cfg, "stencil")
    assert_close(acc.sum_w, oacc.sum_w, "sum_w")
    assert_close(acc.dpress, oacc.dpress, "dpress", rtol=1e-3)
    assert_close(acc.solid_drift, oacc.solid_drift, "solid_drift",
                 rtol=1e-3)


def test_unidyn_subbin_parity_matches_oracle():
    cfg = UNIDYN_CONFIG.replace(max_per_cell=64)
    state = mixed_blob(150, 7, cfg, span=0.15)
    sorted_state, bt = binning.sort_by_cell(state, cfg)
    acc = compute_forces(sorted_state, bt, cfg, subbin_parity=True)
    oacc = accumulate(state_to_dict(sorted_state), cfg, "subbin")
    # with a dense blob some home cells exceed the threshold, so this
    # differs from the full-stencil result
    full = compute_forces(sorted_state, bt, cfg, subbin_parity=False)
    assert not np.allclose(np.asarray(acc.sum_w), np.asarray(full.sum_w))
    assert_close(acc.sum_w, oacc.sum_w, "sum_w")
    assert_close(acc.dpress, oacc.dpress, "dpress")


@pytest.mark.parametrize("steps", [1, 5])
def test_base_step_matches_oracle(steps):
    cfg = BASE_CONFIG.replace(max_per_cell=32)
    state = random_blob(150, seed=3, span=0.12, boundary_frac=0.2)
    ref = state_to_dict(state)
    cur = state
    for _ in range(steps):
        cur, _ = sph_step(cur, cfg)
    # oracle steps (applies its own dense pairing; order-independent)
    for _ in range(steps):
        ref = oracle_step(ref, cfg, "stencil")
    got = state_to_dict(cur)
    # compare by particle id (implementation re-sorts each step)
    gi = np.argsort(got["pid"])
    ri = np.argsort(ref["pid"])
    for key, rtol in [("pos", 2e-4), ("vel", 2e-3), ("dens", 1e-4),
                      ("press", 2e-3), ("acc", 2e-3)]:
        assert_close(got[key][gi], ref[key][ri], key, rtol=rtol,
                     atol=1e-5)


@pytest.mark.parametrize("steps,mode", [(1, "stencil"), (3, "stencil"),
                                        (3, "subbin")])
def test_unidyn_step_matches_oracle(steps, mode):
    # mode "subbin" is the UNIDYN preset default (cfg.subbin_parity);
    # "stencil" overrides per call to pin the full-stencil path too
    cfg = UNIDYN_CONFIG.replace(max_per_cell=64)
    state = mixed_blob(120, 11, cfg, span=0.2)
    ref = state_to_dict(state)
    cur = state
    for _ in range(steps):
        cur, _ = sph_step(cur, cfg,
                          subbin_parity=None if mode == "subbin" else False)
        ref = oracle_step(ref, cfg, mode)
    got = state_to_dict(cur)
    gi = np.argsort(got["pid"])
    ri = np.argsort(ref["pid"])
    for key, rtol in [("pos", 2e-4), ("vel", 2e-3), ("dens", 1e-4),
                      ("press", 2e-3), ("solid", 1e-3), ("fluid", 1e-3),
                      ("stress", 2e-3)]:
        assert_close(got[key][gi], ref[key][ri], key, rtol=rtol, atol=1e-5)


def test_unidyn_tank_scene_runs_stable():
    cfg = UNIDYN_CONFIG
    state = unidyn_tank(cfg)
    state, metrics = run_chunk(state, cfg, 10)
    assert int(metrics.n_alive[-1]) == 14040
    assert np.isfinite(np.asarray(state.pos)).all()
    assert np.isfinite(np.asarray(state.vel)).all()
    assert float(metrics.max_speed[-1]) < 50.0


def test_momentum_symmetry_of_pressure_forces():
    """Property: with uniform density/pressure and no viscosity or
    boundary asymmetry, the pairwise pressure-gradient contributions are
    antisymmetric, so the total momentum change from the symmetrized
    gradient term sums to ~0."""
    cfg = dataclasses.replace(BASE_CONFIG, alpha_fluid=0.0,
                              max_per_cell=32)
    state = random_blob(100, seed=9, span=0.1)
    state = state.replace(vel=np.zeros((100, 3), np.float32),
                          press=np.full(100, 100.0, np.float32))
    sorted_state, bt = binning.sort_by_cell(state, cfg)
    acc = compute_forces(sorted_state, bt, cfg)
    total = np.asarray(acc.dpress).sum(axis=0)
    scale = np.abs(np.asarray(acc.dpress)).max()
    np.testing.assert_allclose(total, 0.0, atol=1e-4 * max(scale, 1.0))


def test_determinism():
    """Two identical runs produce bit-identical states (the reference is
    nondeterministic by construction — atomicAdd ordering)."""
    cfg = UNIDYN_CONFIG.replace(max_per_cell=64)
    state = mixed_blob(100, 13, cfg)
    a, _ = run_chunk(state, cfg, 5)
    b, _ = run_chunk(state, cfg, 5)
    for k, v in state_to_dict(a).items():
        np.testing.assert_array_equal(v, state_to_dict(b)[k], err_msg=k)
