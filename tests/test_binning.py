"""Tests for the cell-grid binning machinery against brute-force
neighbor enumeration."""

import numpy as np

from tpufluids import binning
from tpufluids.config import BASE_CONFIG
from tpufluids.oracle import cell_coords_np, octant_np, state_to_dict
from tpufluids.scenes import random_blob


def brute_force_stencil_pairs(pos, alive, cfg):
    """Set of (i, j) pairs whose cells are within the clamped 27-stencil."""
    cx, cy, cz = cell_coords_np(pos, cfg)
    g = cfg.grid_size
    in_dom = (cx >= 0) & (cx < g) & (cy >= 0) & (cy < g) & (cz >= 0) & (cz < g)
    pairs = set()
    n = pos.shape[0]
    for i in range(n):
        if not (alive[i] and in_dom[i]):
            continue
        for j in range(n):
            if j == i or not (alive[j] and in_dom[j]):
                continue
            if (abs(cx[i] - cx[j]) <= 1 and abs(cy[i] - cy[j]) <= 1
                    and abs(cz[i] - cz[j]) <= 1):
                pairs.add((i, j))
    return pairs


def test_cell_id_matches_reference_formula():
    cfg = BASE_CONFIG
    state = random_blob(100, seed=1, span=0.9)
    cid, _ = binning.cell_id(state.pos, state.alive, cfg)
    pos = np.asarray(state.pos)
    g = cfg.grid_size
    for i in range(pos.shape[0]):
        expect = (int((pos[i, 0] - cfg.xmin) / cfg.cell_size) * g * g
                  + int((pos[i, 1] - cfg.ymin) / cfg.cell_size) * g
                  + int((pos[i, 2] - cfg.zmin) / cfg.cell_size))
        assert int(cid[i]) == expect


def test_candidates_cover_all_stencil_pairs():
    cfg = BASE_CONFIG.replace(max_per_cell=32)
    state = random_blob(200, seed=2, span=0.2)
    sorted_state, bt = binning.sort_by_cell(state, cfg)
    assert int(bt.overflow) == 0

    cand = binning.neighbor_candidates(bt, cfg)
    n = state.capacity
    idx = np.asarray(cand.idx).reshape(n, -1)
    mask = np.asarray(cand.mask).reshape(n, -1)

    got = set()
    for i in range(n):
        for k in range(idx.shape[1]):
            if mask[i, k] and idx[i, k] != i:
                got.add((i, int(idx[i, k])))

    pos = np.asarray(sorted_state.pos)
    alive = np.asarray(sorted_state.alive)
    want = brute_force_stencil_pairs(pos, alive, cfg)
    # candidates may include self (filtered later by ds > 0); every true
    # stencil pair must be covered, and no non-stencil pair included
    assert want == got


def test_out_of_domain_particles_have_no_candidates():
    cfg = BASE_CONFIG
    state = random_blob(50, seed=3, span=0.2)
    pos = np.array(state.pos)
    pos[:10] = np.array([5.0, 5.0, 5.0])  # way outside
    state = state.replace(pos=pos)
    sorted_state, bt = binning.sort_by_cell(state, cfg)
    cand = binning.neighbor_candidates(bt, cfg)
    mask = np.asarray(cand.mask).reshape(50, -1)
    cid = np.asarray(bt.cid)
    out = cid == cfg.num_cells
    assert out.sum() == 10
    assert not mask[out].any()


def test_overflow_is_counted():
    cfg = BASE_CONFIG.replace(max_per_cell=1)
    state = random_blob(100, seed=4, span=0.02)  # everyone in ~1 cell
    _, bt = binning.sort_by_cell(state, cfg)
    assert int(bt.overflow) > 0


def test_octant_matches_reference_bit_layout():
    cfg = BASE_CONFIG
    state = random_blob(300, seed=5, span=0.9)
    got = np.asarray(binning.octant(state.pos, cfg))
    want = octant_np(np.asarray(state.pos, np.float64), cfg)
    np.testing.assert_array_equal(got, want)


def test_sort_preserves_fields():
    cfg = BASE_CONFIG
    state = random_blob(64, seed=6)
    sorted_state, bt = binning.sort_by_cell(state, cfg)
    d0 = state_to_dict(state)
    d1 = state_to_dict(sorted_state)
    order = np.asarray(bt.order)
    for k in d0:
        np.testing.assert_array_equal(d1[k], d0[k][order])
    # sorted cell ids are nondecreasing
    cid = np.asarray(bt.cid)
    assert np.all(np.diff(cid) >= 0)


def test_morton_roundtrip():
    """Z-order codec round-trip (the reference's morton/demorton,
    FluidGPU.cu:63-102 — inactive there, provided for parity)."""
    rng = np.random.default_rng(8)
    x = rng.integers(0, 1024, 200)
    y = rng.integers(0, 1024, 200)
    z = rng.integers(0, 1024, 200)
    code = binning.morton_encode(x, y, z)
    np.testing.assert_array_equal(np.asarray(binning.morton_decode(code, 0)), x)
    np.testing.assert_array_equal(np.asarray(binning.morton_decode(code, 1)), y)
    np.testing.assert_array_equal(np.asarray(binning.morton_decode(code, 2)), z)
    # spot-check against the reference bit pattern: morton(1,0,0)=1,
    # morton(0,1,0)=2, morton(0,0,1)=4, morton(1,1,1)=7
    assert int(binning.morton_encode(1, 0, 0)) == 1
    assert int(binning.morton_encode(0, 1, 0)) == 2
    assert int(binning.morton_encode(0, 0, 1)) == 4
    assert int(binning.morton_encode(3, 3, 3)) == 63
