"""Sharded SPH (domain decomposition + halo/migration via ppermute) vs
the single-device step — pid-matched agreement on the CPU fake mesh."""

import jax
import numpy as np
import pytest

from tpufluids.config import BASE_CONFIG, UNIDYN_CONFIG
from tpufluids.oracle import state_to_dict
from tpufluids.scenes import base_dam, random_blob, unidyn_tank
from tpufluids.shard import make_mesh
from tpufluids.shard.particles import (collect, distribute,
                                       make_sharded_step)
from tpufluids.step import sph_step


def by_pid(d):
    alive = d["alive"].astype(bool)
    pids = d["pid"][alive]
    order = np.argsort(pids)
    return {k: v[alive][order] for k, v in d.items()}


def run_and_compare(cfg, state, n_dev, steps, cap, fields, rtol=3e-4,
                    subbin_parity=False, **mk):
    ref = state
    for _ in range(steps):
        ref, _ = sph_step(ref, cfg, subbin_parity=subbin_parity)
    refd = by_pid(state_to_dict(ref))

    mesh = make_mesh(n_dev)
    sharded = distribute(state, mesh, cfg, cap)
    step = make_sharded_step(mesh, cfg, n_steps=steps,
                             subbin_parity=subbin_parity, **mk)
    out, metrics = step(sharded)
    outd = by_pid(state_to_dict(collect(out)))

    assert int(metrics.halo_overflow) == 0
    assert int(metrics.migrate_overflow) == 0
    np.testing.assert_array_equal(outd["pid"], refd["pid"])
    for f in fields:
        a, b = outd[f], refd[f]
        scale = max(1.0, np.abs(b).max())
        np.testing.assert_allclose(a, b, rtol=rtol, atol=1e-5 * scale,
                                   err_msg=f)
    return metrics


@pytest.mark.parametrize("n_dev", [1, 2, 4])
def test_base_sharded_matches_single(n_dev):
    cfg = BASE_CONFIG.replace(max_per_cell=32)
    state = random_blob(200, seed=5, span=0.6)
    run_and_compare(cfg, state, n_dev, steps=3, cap=220,
                    fields=("pos", "vel", "dens", "press", "acc"))


def test_base_dam_sharded_8dev():
    cfg = BASE_CONFIG.replace(max_per_cell=32)
    state = base_dam(cfg, n=2000)
    run_and_compare(cfg, state, 8, steps=5, cap=2000,
                    fields=("pos", "vel", "dens"))


@pytest.mark.parametrize("n_dev", [2, 4])
def test_unidyn_sharded_matches_single(n_dev):
    from tests.test_forces_vs_oracle import mixed_blob
    cfg = UNIDYN_CONFIG.replace(max_per_cell=64, grid_size=16,
                                cell_size=0.125)
    state = mixed_blob(150, 21, cfg, span=0.7, boundary_frac=0.1)
    run_and_compare(
        cfg, state, n_dev, steps=3, cap=170,
        fields=("pos", "vel", "dens", "solid", "fluid", "stress"),
        rtol=1e-3)


@pytest.mark.parametrize("n_dev", [2, 4])
def test_sharded_merge_matches_single(n_dev):
    """Merge under the sharded step (solver-unidyn.cu:339-349): pairs
    straddling a cut merge identically to the single-device step via
    the owner-authoritative pick exchange + pid tiebreak."""
    from tpufluids.state import make_state

    cfg = UNIDYN_CONFIG.replace(max_per_cell=32, grid_size=16,
                                cell_size=0.125, merge_dist=0.05)
    pts = []
    # one close pair straddling every device cut
    for xc in ([0.0] if n_dev == 2 else [-0.5, 0.0, 0.5]):
        pts += [[xc - 0.015, 0.3, 0.1], [xc + 0.015, 0.3, 0.1]]
    pts += [[0.4, -0.3, 0.2], [0.43, -0.3, 0.2]]   # same-device pair
    pts += [[-0.6, 0.1, -0.2], [0.7, 0.5, 0.5]]    # unpaired singles
    n = len(pts)
    state = make_state(np.array(pts, np.float32), cfg=cfg)
    n_pairs = (1 if n_dev == 2 else 3) + 1

    metrics = run_and_compare(cfg, state, n_dev, steps=2, cap=n,
                              fields=("pos", "vel", "mass", "dens"),
                              rtol=1e-3)
    assert int(metrics.n_alive) == n - n_pairs  # every pair merged
    ref = state
    from tpufluids.step import sph_step
    for _ in range(2):
        ref, _ = sph_step(ref, cfg)
    d = by_pid(state_to_dict(ref))
    assert (d["mass"] == cfg.merge_mass_new).sum() == n_pairs


def test_receiver_slot_exhaustion_counted():
    """Migrants that find no free slot on the receiver are dropped AND
    counted into migrate_overflow (receiver-side accounting)."""
    from tpufluids.state import make_state

    cfg = BASE_CONFIG.replace(max_per_cell=32)
    # dev 0 (x < 0): two fast particles just left of the cut; dev 1
    # (x > 0): four stationary particles filling its pool exactly
    pos = np.array([[-0.001, -0.5, 0.0], [-0.001, 0.5, 0.0],
                    [0.3, -0.5, 0.0], [0.3, 0.5, 0.0],
                    [0.6, -0.5, 0.0], [0.6, 0.5, 0.0]], np.float32)
    vel = np.zeros((6, 3), np.float32)
    vel[:2, 0] = 3.0  # crosses the 0.05-wide cut cell within ~2 steps
    state = make_state(pos, vel, cfg=cfg)
    mesh = make_mesh(2)
    sharded = distribute(state, mesh, cfg, capacity_per_device=4)
    step = make_sharded_step(mesh, cfg, n_steps=3)
    out, metrics = step(sharded)
    assert int(metrics.migrate_overflow) == 2
    assert int(metrics.n_alive) == 4


@pytest.mark.parametrize("n_dev", [2, 4])
@pytest.mark.parametrize("variant", ["base", "unidyn"])
def test_sharded_pallas_backend_interpret(variant, n_dev):
    """The sharded step with the kernel force backend (slab GridSpec,
    gx != gy, the drift_fix hook between the unidyn passes) matches the
    XLA sharded step — interpret mode on the CPU mesh."""
    if variant == "base":
        cfg = BASE_CONFIG.replace(max_per_cell=32)
        state = random_blob(120, seed=3, span=0.5)
    else:
        from tests.test_forces_vs_oracle import mixed_blob
        cfg = UNIDYN_CONFIG.replace(max_per_cell=64, grid_size=16,
                                    cell_size=0.125)
        state = mixed_blob(100, 11, cfg, span=0.6, boundary_frac=0.1)
    mesh = make_mesh(n_dev)
    cap = 140

    ref_sharded = distribute(state, mesh, cfg.replace(force_backend="xla"),
                             cap)
    step_xla = make_sharded_step(mesh, cfg.replace(force_backend="xla"),
                                 n_steps=2)
    ref_out, _ = step_xla(ref_sharded)
    refd = by_pid(state_to_dict(collect(ref_out)))

    cfgp = cfg.replace(force_backend="interpret")
    sharded = distribute(state, mesh, cfgp, cap)
    step_p = make_sharded_step(mesh, cfgp, n_steps=2)
    out, metrics = step_p(sharded)
    outd = by_pid(state_to_dict(collect(out)))

    assert int(metrics.bin_overflow) == 0
    np.testing.assert_array_equal(outd["pid"], refd["pid"])
    for f in ("pos", "vel", "dens", "press"):
        scale = max(1.0, np.abs(refd[f]).max())
        np.testing.assert_allclose(outd[f], refd[f], rtol=3e-4,
                                   atol=1e-5 * scale, err_msg=f)


def test_migration_happens():
    """Particles with strong x velocity cross slabs and stay conserved."""
    cfg = BASE_CONFIG.replace(max_per_cell=32)
    state = random_blob(100, seed=7, span=0.5)
    vel = np.asarray(state.vel).copy()
    vel[:, 0] = 3.0  # ~ crosses a 0.05 cell every ~33 steps at dt 5e-4
    state = state.replace(vel=jax.numpy.asarray(vel))
    mesh = make_mesh(4)
    sharded = distribute(state, mesh, cfg, 120)
    step = make_sharded_step(mesh, cfg, n_steps=40)
    out, metrics = step(sharded)
    assert int(metrics.n_alive) == 100
    outd = by_pid(state_to_dict(collect(out)))
    assert outd["pid"].shape[0] == 100

    ref = state
    from tpufluids.step import run_chunk
    ref, _ = run_chunk(ref, cfg, 40)
    refd = by_pid(state_to_dict(ref))
    np.testing.assert_allclose(outd["pos"], refd["pos"], rtol=3e-4,
                               atol=1e-5)


def test_sharded_merge_pallas_backend_interpret():
    """Merge on the sharded kernel backend: the in-kernel partner
    search (sorted slab rows) + owner-authoritative pick exchange
    resolves cut-straddling pairs identically to the XLA sharded step
    and the single-device step."""
    from tpufluids.state import make_state

    cfg = UNIDYN_CONFIG.replace(max_per_cell=32, grid_size=16,
                                cell_size=0.125, merge_dist=0.05)
    pts = [[-0.015, 0.3, 0.1], [0.015, 0.3, 0.1],   # straddles the cut
           [0.4, -0.3, 0.2], [0.43, -0.3, 0.2],     # same-device pair
           [-0.6, 0.1, -0.2], [0.7, 0.5, 0.5]]      # singles
    n = len(pts)
    state = make_state(np.array(pts, np.float32), cfg=cfg)

    mesh = make_mesh(2)
    ref_step = make_sharded_step(mesh, cfg.replace(force_backend="xla"),
                                 n_steps=2)
    ref_out, rmet = ref_step(distribute(state, mesh, cfg, n))
    refd = by_pid(state_to_dict(collect(ref_out)))

    cfgp = cfg.replace(force_backend="interpret")
    step_p = make_sharded_step(mesh, cfgp, n_steps=2)
    out, met = step_p(distribute(state, mesh, cfgp, n))
    outd = by_pid(state_to_dict(collect(out)))

    assert int(met.n_alive) == int(rmet.n_alive) == n - 2
    np.testing.assert_array_equal(outd["pid"], refd["pid"])
    for f in ("pos", "vel", "mass", "dens"):
        scale = max(1.0, np.abs(refd[f]).max())
        np.testing.assert_allclose(outd[f], refd[f], rtol=1e-3,
                                   atol=1e-5 * scale, err_msg=f)
    assert (outd["mass"] == cfg.merge_mass_new).sum() == 2
