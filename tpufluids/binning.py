"""Cell-grid neighbor binning — the replacement for the reference's
sort/bin/prefix machinery.

The reference pipeline per step is: thrust::sort_by_key on cell ids
(solver.cu:181), ``findneighbours`` marking per-cell start/end indices
(FluidGPU.cu:106-117), then a shared-memory population-count + compacted
prefix map assigning one CUDA thread per neighbor particle
(FluidGPU.cu:150-213).

Here the same structure becomes dense, static-shape tensor ops:

1. sort particles by linearized cell id (``jnp.argsort`` stable) —
   out-of-domain or dead particles get a sentinel id that sorts last
   (the analog of the reference's 90.99 teleport trick,
   FluidGPU-unidyn.cu:272);
2. a cell-start table via cell-id histogram + exclusive cumsum — the
   analog of ``findneighbours``'s start/end arrays;
3. neighbor candidates as 9 contiguous *runs*: because the cell id is
   row-major with z fastest, the three stencil cells (z-1, z, z+1) of
   any (x+dx, y+dy) column are contiguous both in cell-id space and in
   the sorted particle array.  The 27-cell stencil (FluidGPU.cu:124-126)
   is therefore 9 contiguous index ranges of at most 3*max_per_cell
   slots each — a gather pattern that XLA handles well, and the
   contiguous row ranges the pair kernel (tpufluids/sph_triton.py)
   streams.

Capacity overflow (a run holding more than 3*max_per_cell particles) is
deterministic — the highest sorted ranks are dropped — and surfaced as a
count (the reference silently skips cells with population >= 64 in its
thread-budget sum, FluidGPU.cu:174).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

from tpufluids.config import SPHConfig
from tpufluids.state import ParticleState

# The 9 (dx, dy) run offsets of the 27-cell stencil.
RUN_OFFSETS = [(dx, dy) for dx in (-1, 0, 1) for dy in (-1, 0, 1)]


class GridSpec(NamedTuple):
    """Binning-grid extent — the full cube by default, or a local x-slab
    (plus halo planes) under spatial domain decomposition (the sharded
    analog of the reference's per-device cell range Ns[dev]+buffer,
    solver-unidyn.cu:187-195)."""
    g: int          # y/z extent (= cfg.grid_size)
    x_planes: int   # number of x planes covered
    x_offset: int   # global cx of local plane 0

    @property
    def num_cells(self) -> int:
        return self.x_planes * self.g * self.g


def full_grid(cfg: SPHConfig) -> GridSpec:
    return GridSpec(g=cfg.grid_size, x_planes=cfg.grid_size, x_offset=0)


def cell_coords(pos: jax.Array, cfg: SPHConfig):
    """Per-axis cell coordinates with C-style truncation toward zero,
    matching ``int((x - XMIN)/CELLSIZE)`` (FluidGPU.cu:419)."""
    scaled = (pos - jnp.array([cfg.xmin, cfg.ymin, cfg.zmin],
                              pos.dtype)) / jnp.float32(cfg.cell_size)
    c = jnp.trunc(scaled).astype(jnp.int32)
    return c[:, 0], c[:, 1], c[:, 2]


def cell_id(pos: jax.Array, alive: jax.Array, cfg: SPHConfig,
            grid: Optional[GridSpec] = None):
    """Linear cell id; out-of-domain or dead particles get the sentinel
    ``num_cells`` so they sort to the end and never appear in a run."""
    grid = grid or full_grid(cfg)
    g = grid.g
    cx, cy, cz = cell_coords(pos, cfg)
    lx = cx - grid.x_offset
    in_dom = ((lx >= 0) & (lx < grid.x_planes) & (cy >= 0) & (cy < g)
              & (cz >= 0) & (cz < g))
    lin = lx * (g * g) + cy * g + cz
    return jnp.where(in_dom & alive, lin, grid.num_cells), in_dom


class BinTable(NamedTuple):
    """Sorted-order binning tables for one step."""
    order: jax.Array        # (N,) permutation applied to the state
    cid: jax.Array          # (N,) sorted cell ids (sentinel = num_cells)
    cx: jax.Array           # (N,) sorted per-axis coords
    cy: jax.Array
    cz: jax.Array
    in_dom: jax.Array       # (N,) bool, sorted
    cell_start: jax.Array   # (num_cells + 2,) first sorted index of cell c
    run_start: jax.Array    # (N, 9) start of each (dx,dy) neighbor run
    run_len: jax.Array      # (N, 9) clipped run length
    home_count: jax.Array   # (N,) population of the particle's own cell
    octant: jax.Array       # (N,) sub-bin octant id (for subbin parity mode)
    overflow: jax.Array     # () total dropped candidate slots this step


def permute_pool(state, order):
    """Apply a row permutation to every pool array as ONE packed row
    gather: the leaves are flattened to (N, k) int32 views (bools
    widened, floats bitcast — exact round trips; int32 rather than
    float32 as the carrier because a device that flushes f32 subnormals
    would zero small bitcast integer payloads), concatenated to a
    single (N, 33) matrix, gathered once, and split back: one row
    gather instead of 15 narrow per-field gathers."""
    leaves, treedef = jax.tree_util.tree_flatten(state)
    n = leaves[0].shape[0]
    cols, metas = [], []
    for a in leaves:
        flat = a.reshape(n, -1)
        if flat.dtype == jnp.bool_:
            f = flat.astype(jnp.int32)
        elif flat.dtype == jnp.float32:
            f = jax.lax.bitcast_convert_type(flat, jnp.int32)
        elif flat.dtype == jnp.int32:
            f = flat
        else:
            raise TypeError(f"permute_pool: unsupported leaf dtype "
                            f"{flat.dtype}")
        metas.append((a.shape, a.dtype, flat.shape[1]))
        cols.append(f)
    packed = jnp.concatenate(cols, axis=1)[order]
    out, off = [], 0
    for shape, dtype, w in metas:
        seg = packed[:, off:off + w]
        off += w
        if dtype == jnp.bool_:
            seg = seg != 0
        elif dtype == jnp.float32:
            seg = jax.lax.bitcast_convert_type(seg, jnp.float32)
        out.append(seg.reshape(shape))
    return jax.tree_util.tree_unflatten(treedef, out)


def sort_by_cell(state: ParticleState, cfg: SPHConfig,
                 grid: Optional[GridSpec] = None, runs: bool = True):
    """Reorder the whole particle pool by cell id (the reference's
    thrust::sort_by_key over the AoS array, solver.cu:181) and build the
    run tables.  ``runs=False`` skips the per-particle neighbor-run
    tables (9 gather passes) — the kernel force backend derives its
    candidate ranges from ``cell_start`` alone."""
    cid, _ = cell_id(state.pos, state.alive, cfg, grid)
    n = cid.shape[0]
    num_cells = (grid or full_grid(cfg)).num_cells
    if (num_cells + 1) * n <= 2 ** 31 - 1:
        # pack (cid, row) into ONE int32 key: a single-operand sort
        # runs ~2x faster than the two-operand stable argsort (which
        # drags the index array through every bitonic stage), and the
        # unique row bits make the order identical to the stable sort
        key = cid * n + jnp.arange(n, dtype=jnp.int32)
        order = jnp.sort(key) % n
    else:
        order = jnp.argsort(cid, stable=True)
    state = permute_pool(state, order)
    bt = build_bins(state, cfg, order=order, grid=grid, runs=runs)
    return state, bt


def sort_tables(state: ParticleState, cfg: SPHConfig,
                grid: Optional[GridSpec] = None):
    """Sorted-order binning tables WITHOUT permuting the pool.

    The kernel force path gathers its packed input directly by
    ``order`` (one row gather) and maps results straight back to the
    unpermuted pool — skipping the 33-column ``permute_pool`` gather
    and the post-permute cell-id recompute of ``sort_by_cell``.  The
    reference's thrust sort (solver.cu:181) reorders storage; only the
    sorted ADJACENCY is semantically needed.  Returns (order, BinTable)
    with every BinTable field in sorted order (run tables empty — this
    path serves the kernel backend only)."""
    grid = grid or full_grid(cfg)
    g = grid.g
    num_cells = grid.num_cells
    cid, _ = cell_id(state.pos, state.alive, cfg, grid)
    n = cid.shape[0]
    if (num_cells + 1) * n <= 2 ** 31 - 1:
        # one packed-key sort yields BOTH the order and the sorted ids
        key = cid * n + jnp.arange(n, dtype=jnp.int32)
        skey = jnp.sort(key)
        order = skey % n
        scid = skey // n
    else:
        order = jnp.argsort(cid, stable=True)
        scid = cid[order]

    # histogram + cumsum over the UNSORTED ids (order-independent)
    counts = jnp.zeros(num_cells + 1, jnp.int32).at[cid].add(
        jnp.ones_like(cid, jnp.int32))
    cell_start = jnp.concatenate(
        [jnp.zeros(1, jnp.int32), jnp.cumsum(counts, dtype=jnp.int32)])

    in_dom = scid < num_cells
    cc = jnp.clip(scid, 0, num_cells)
    home_count = jnp.where(in_dom, cell_start[cc + 1] - cell_start[cc], 0)
    # per-axis coords decoded from the sorted id (valid where in-dom)
    cz = cc % g
    cy = (cc // g) % g
    cx = cc // (g * g)
    z1 = jnp.zeros((n, 9), jnp.int32)
    bt = BinTable(
        order=order, cid=scid, cx=cx, cy=cy, cz=cz, in_dom=in_dom,
        cell_start=cell_start, run_start=z1, run_len=z1,
        home_count=home_count, octant=octant(state.pos, cfg)[order],
        overflow=jnp.zeros((), jnp.int32))
    return order, bt


def build_bins(state: ParticleState, cfg: SPHConfig, order=None,
               grid: Optional[GridSpec] = None,
               runs: bool = True) -> BinTable:
    """Build the BinTable for an already-cell-sorted state."""
    grid = grid or full_grid(cfg)
    g = grid.g
    num_cells = grid.num_cells
    k3 = 3 * cfg.max_per_cell

    cid, in_dom = cell_id(state.pos, state.alive, cfg, grid)
    cx, cy, cz = cell_coords(state.pos, cfg)
    cx = cx - grid.x_offset  # local plane index
    n = cid.shape[0]
    if order is None:
        order = jnp.arange(n, dtype=jnp.int32)

    # cell_start[c] = first sorted index of cell c; c in [0, num_cells+1].
    # Built as histogram + exclusive cumsum: bit-identical to
    # searchsorted(cid, arange) on the sorted ids, without a gather per
    # binary-search step.
    counts = jnp.zeros(num_cells + 1, jnp.int32).at[cid].add(
        jnp.ones_like(cid, jnp.int32))
    cell_start = jnp.concatenate(
        [jnp.zeros(1, jnp.int32),
         jnp.cumsum(counts, dtype=jnp.int32)])

    home_count = cell_start[jnp.clip(cid, 0, num_cells) + 1] - cell_start[
        jnp.clip(cid, 0, num_cells)]
    home_count = jnp.where(cid < num_cells, home_count, 0)

    if not runs:
        z1 = jnp.zeros((n, 9), jnp.int32)
        return BinTable(
            order=order, cid=cid, cx=cx, cy=cy, cz=cz, in_dom=in_dom,
            cell_start=cell_start, run_start=z1, run_len=z1,
            home_count=home_count, octant=octant(state.pos, cfg),
            overflow=jnp.zeros((), jnp.int32))

    zlo = jnp.maximum(cz - 1, 0)
    zhi = jnp.minimum(cz + 1, g - 1)
    starts, lens = [], []
    overflow = jnp.zeros((), jnp.int32)
    for dx, dy in RUN_OFFSETS:
        nx, ny = cx + dx, cy + dy
        valid = ((nx >= 0) & (nx < grid.x_planes) & (ny >= 0) & (ny < g)
                 & (cid < num_cells))
        base = nx * (g * g) + ny * g
        lo_cell = jnp.clip(base + zlo, 0, num_cells)
        hi_cell = jnp.clip(base + zhi + 1, 0, num_cells + 1)
        lo = cell_start[lo_cell]
        hi = cell_start[hi_cell]
        raw_len = jnp.where(valid, hi - lo, 0)
        overflow = overflow + jnp.sum(jnp.maximum(raw_len - k3, 0))
        starts.append(lo)
        lens.append(jnp.minimum(raw_len, k3))
    return BinTable(
        order=order, cid=cid, cx=cx, cy=cy, cz=cz, in_dom=in_dom,
        cell_start=cell_start,
        run_start=jnp.stack(starts, axis=1),
        run_len=jnp.stack(lens, axis=1),
        home_count=home_count,
        octant=octant(state.pos, cfg),
        overflow=overflow,
    )


class Candidates(NamedTuple):
    """Per-particle neighbor candidate slots (static shape (N, 9, 3K))."""
    idx: jax.Array    # gather indices into the sorted arrays
    mask: jax.Array   # slot validity (run length + self/subbin exclusions)


def neighbor_candidates(bt: BinTable, cfg: SPHConfig,
                        subbin_threshold: int | None = None) -> Candidates:
    """Materialize the candidate index table.

    With ``subbin_threshold`` set (parity mode for the reference's
    adaptive two-level binning, FluidGPU-unidyn.cu:181-192 + mykernel3),
    particles whose home cell population exceeds the threshold restrict
    their stencil to the 8-cell octant neighborhood
    (FluidGPU-unidyn.cu:579-583): allowed per-axis offsets become
    {0, dir_axis} where dir is the half-cell octant direction.
    """
    n = bt.cid.shape[0]
    k3 = 3 * cfg.max_per_cell
    slot = jnp.arange(k3, dtype=jnp.int32)
    idx = bt.run_start[:, :, None] + slot[None, None, :]       # (N, 9, K3)
    mask = slot[None, None, :] < bt.run_len[:, :, None]
    idx = jnp.clip(idx, 0, n - 1)

    if subbin_threshold is not None:
        # per-candidate (dx, dy, dz) relative cell offsets
        dxy = jnp.array(RUN_OFFSETS, jnp.int32)                 # (9, 2)
        dz = bt.cz[idx] - bt.cz[:, None, None]
        dx = jnp.broadcast_to(dxy[None, :, 0:1], idx.shape)
        dy = jnp.broadcast_to(dxy[None, :, 1:2], idx.shape)
        o = bt.octant
        dirx = jnp.where(o & 1, 1, -1)[:, None, None]
        diry = jnp.where(o & 2, 1, -1)[:, None, None]
        dirz = jnp.where(o & 4, -1, 1)[:, None, None]
        octant_ok = (((dx == 0) | (dx == dirx))
                     & ((dy == 0) | (dy == diry))
                     & ((dz == 0) | (dz == dirz)))
        overfull = (bt.home_count > subbin_threshold)[:, None, None]
        mask = mask & jnp.where(overfull, octant_ok, True)
    return Candidates(idx=idx, mask=mask)


def morton_encode(x, y, z):
    """3D -> 1D Z-order interleave (reference ``morton``,
    FluidGPU.cu:63-85; present on host and device but commented out of
    the active path in favor of row-major ids — provided for parity).
    Supports coordinates up to 10 bits per axis."""
    def m(c):
        return jnp.uint32(c)

    def spread(v):
        v = jnp.asarray(v, jnp.uint32)
        v = (v | (v << 16)) & m(0x030000FF)
        v = (v | (v << 8)) & m(0x0300F00F)
        v = (v | (v << 4)) & m(0x030C30C3)
        v = (v | (v << 2)) & m(0x09249249)
        return v

    return (spread(x) | (spread(y) << 1) | (spread(z) << 2)).astype(
        jnp.int32)


def morton_decode(code, axis: int):
    """Inverse of morton_encode for one axis (reference ``demorton``,
    FluidGPU.cu:87-102); ``axis`` = 0 for x, 1 for y, 2 for z."""
    v = jnp.asarray(code, jnp.uint32) >> axis
    v = v & jnp.uint32(0x09249249)
    v = (v | (v >> 2)) & jnp.uint32(0x030C30C3)
    v = (v | (v >> 4)) & jnp.uint32(0x0300F00F)
    v = (v | (v >> 8)) & jnp.uint32(0xFF0000FF)
    v = (v | (v >> 16)) & jnp.uint32(0x000003FF)
    return v.astype(jnp.int32)


def octant(pos: jax.Array, cfg: SPHConfig) -> jax.Array:
    """Sub-bin octant id (FluidGPU-unidyn.cu:182-184).  bit0 = x in the
    upper half of its cell, bit1 = y upper half, bit2 = z *lower* half
    (the z test is inverted in the reference)."""
    cs = jnp.float32(cfg.cell_size)
    mins = jnp.array([cfg.xmin, cfg.ymin, cfg.zmin], pos.dtype)
    a = jnp.trunc((pos - mins) / cs)
    b = jnp.trunc((pos - mins + cs / 2) / cs)
    upper = a != b
    return (upper[:, 0].astype(jnp.int32)
            + 2 * upper[:, 1].astype(jnp.int32)
            + 4 * (~upper[:, 2]).astype(jnp.int32))
