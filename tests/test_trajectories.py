"""Short-horizon trajectory regression guards (CPU, XLA backend).

The full reference workloads run solver.cu:19 t<4000 and
solver-unidyn.cu:23 t<1450.  These tests guard the same physics at CI
cost: a few dozen steps of
each scene with quantitative anchors measured from the deterministic
CPU path (gather sums make runs bit-reproducible per backend, so the
anchors are tight; tolerances absorb cross-version XLA drift)."""

import numpy as np

from tpufluids.config import BASE_CONFIG, UNIDYN_CONFIG
from tpufluids.scenes import base_dam, unidyn_tank
from tpufluids.step import run_chunk


def test_base_dam_50step_anchor():
    s = base_dam(BASE_CONFIG)
    s2, m = run_chunk(s, BASE_CONFIG, 50)
    pos = np.asarray(s2.pos)
    vel = np.asarray(s2.vel)
    dens = np.asarray(s2.dens)
    assert int(np.asarray(s2.alive).sum()) == 8000
    assert np.isfinite(pos).all() and np.isfinite(vel).all()
    assert int(np.asarray(m.bin_overflow).max()) == 0
    # anchors (CPU golden, r4): mean_z 0.076874, max speed 0.4868,
    # z in [-0.206, 0.360], dens in [9488, 9881]
    assert abs(pos[:, 2].mean() - 0.076874) < 2e-3
    assert abs(np.linalg.norm(vel, axis=1).max() - 0.4868) < 0.05
    assert -0.25 < pos[:, 2].min() < -0.15
    assert 0.30 < pos[:, 2].max() < 0.42
    assert 9300 < dens.min() and dens.max() < 10000


def test_unidyn_tank_25step_anchor():
    cfg = UNIDYN_CONFIG
    s = unidyn_tank(cfg, nf=2000, nb=808)
    s2, m = run_chunk(s, cfg, 25)
    alive = np.asarray(s2.alive)
    pos = np.asarray(s2.pos)[alive]
    vel = np.asarray(s2.vel)[alive]
    assert int(alive.sum()) == 2808
    assert np.isfinite(pos).all() and np.isfinite(vel).all()
    assert int(np.asarray(m.bin_overflow).max()) == 0
    # anchors (CPU golden, r4): mean_z -0.472181, max speed 0.4950,
    # z in [-0.740, -0.310] — fluid falling toward the floor plane,
    # everything inside the tank walls
    assert abs(pos[:, 2].mean() - (-0.472181)) < 2e-3
    assert np.linalg.norm(vel, axis=1).max() < 1.0
    assert -0.80 < pos[:, 2].min() < -0.70
    assert -0.40 < pos[:, 2].max() < -0.25
    assert np.abs(pos[:, :2]).max() < 0.99
