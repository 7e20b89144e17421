"""Single-device step function and scan-based run loop.

The reference's per-step pipeline (solver.cu:171-216;
solver-unidyn.cu:313-573) is: thrust sort -> (unidyn) merge compaction
count -> findneighbours binning -> coarse force kernel -> (unidyn) fine
force kernel -> update kernel -> (multi-dev) exchange -> periodic VTK
write -> cell recompute, with a host sync and print every step.

Here the entire step is one pure function under ``jit``, and ``run``
drives it with ``lax.scan`` so there are no host round-trips inside the
loop (snapshots are taken between scan chunks).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from tpufluids import adapt, binning
from tpufluids.config import SPHConfig
from tpufluids.forces import ForceAccum, accum_from_kernel, compute_forces
from tpufluids.integrate import update
from tpufluids.state import ParticleState

FORCE_BACKENDS = ("auto", "xla", "triton", "interpret")


class StepMetrics(NamedTuple):
    """Per-step diagnostics (the reference only prints particle/merge
    counts and kernel ms, solver-unidyn.cu:347-348)."""
    n_alive: jax.Array
    max_speed: jax.Array
    total_mass: jax.Array
    dens_residual: jax.Array   # max |dens - rho0| / rho0 over fluid
    bin_overflow: jax.Array
    n_split: jax.Array


def resolve_force_backend(cfg: SPHConfig) -> str:
    """The pair-pass backend for ``cfg.force_backend``: "auto" is the
    cell-list kernel (tpufluids.sph_triton) on a GPU and the XLA gather
    pass anywhere else; "interpret" runs the kernel under the Pallas
    interpreter (CPU tests) and is never chosen by "auto"."""
    backend = cfg.force_backend
    if backend not in FORCE_BACKENDS:
        raise ValueError(f"force_backend={backend!r}: expected one of "
                         f"{FORCE_BACKENDS}")
    if backend == "auto":
        return "triton" if jax.default_backend() == "gpu" else "xla"
    return backend


def resolve_subbin(cfg: SPHConfig, subbin_parity) -> bool:
    """Per-call override (bool) or the config default (None) — the
    UNIDYN preset defaults to True, the reference's active two-level
    binning behavior (solver-unidyn.cu:379)."""
    return cfg.subbin_parity if subbin_parity is None else subbin_parity


def dispatch_forces(state: ParticleState, bt, cfg: SPHConfig,
                    subbin_parity=None, drift_fix=None, grid=None,
                    order=None) -> ForceAccum:
    """The ForceAccum from the resolved backend.  Shared by the
    single-device step and the sharded step (which passes its local
    GridSpec and the drift_fix hook).

    ``order``: binning.sort_tables mode — the state is the UNSORTED
    pool and results come back in pool order (kernel backends only)."""
    subbin_parity = resolve_subbin(cfg, subbin_parity)
    backend = resolve_force_backend(cfg)
    if backend == "xla":
        if order is not None:
            raise ValueError("sort_tables mode needs the kernel backend")
        return compute_forces(state, bt, cfg, subbin_parity=subbin_parity,
                              subbin_threshold=cfg.subbin_threshold,
                              drift_fix=drift_fix)
    from tpufluids import sph_triton
    kw = dict(order=order, grid=grid, interpret=backend == "interpret",
              subbin_threshold=(cfg.subbin_threshold if subbin_parity
                                else None))
    if cfg.variant == "base":
        sw, dp = sph_triton.base_forces(state, bt, cfg, **kw)
        n = state.capacity
        z3 = jnp.zeros((n, 3), jnp.float32)
        z33 = jnp.zeros((n, 3, 3), jnp.float32)
        return ForceAccum(
            sum_w=sw, dpress=dp, diffusion=z3, vel_grad=z33,
            stress_accel=z3, solid_drift=z3, fluid_drift=z3,
            mixture_accel=z3, delsolid=jnp.zeros(n, jnp.float32),
            delfluid=jnp.zeros(n, jnp.float32),
            stress_scaled=state.stress, stress_rate=z33,
            split_trigger=jnp.zeros(n, bool),
            merge_partner=jnp.full(n, -1, jnp.int32))
    r = sph_triton.unidyn_forces(state, bt, cfg, drift_fix=drift_fix, **kw)
    return accum_from_kernel(state, r, cfg)


def sph_step(state: ParticleState, cfg: SPHConfig,
             subbin_parity=None) -> tuple[ParticleState, StepMetrics]:
    """One physics step. Pure; safe under jit/scan/shard_map.  Its
    stages run under named scopes (sort, pair_pass, update) for the
    trace reduction (tpufluids/trace.py).

    ``subbin_parity``: None (default) resolves from cfg.subbin_parity;
    a bool overrides per call."""
    subbin_parity = resolve_subbin(cfg, subbin_parity)
    with jax.named_scope("sort"):
        if resolve_force_backend(cfg) == "xla":
            state, bt = binning.sort_by_cell(state, cfg, runs=True)
            order = None
        else:
            # sort_tables mode: the pool is never permuted — the
            # kernel's pack gathers by ``order`` and results come back
            # in pool order (saves the 33-column permute per step; the
            # sorted adjacency the kernel needs is in bt)
            order, bt = binning.sort_tables(state, cfg)
    with jax.named_scope("pair_pass"):
        acc = dispatch_forces(state, bt, cfg, subbin_parity=subbin_parity,
                              order=order)
    with jax.named_scope("update"):
        return _finish_step(state, bt, acc, cfg)


def _finish_step(state, bt, acc, cfg):
    """Merge/update/split + per-step metrics (shared by sph_step and
    the stale-tables step)."""
    if cfg.variant != "base" and cfg.merge_dist > 0:
        state = adapt.apply_merges(state, acc.merge_partner, cfg)
    state = update(state, acc, cfg)
    if cfg.variant != "base" and cfg.split_reinjection:
        state = adapt.apply_splits(state, cfg)

    fluid_alive = state.alive & (~state.boundary)
    metrics = StepMetrics(
        n_alive=adapt.count_alive(state),
        max_speed=jnp.max(jnp.where(
            fluid_alive, jnp.linalg.norm(state.vel, axis=-1), 0.0)),
        total_mass=jnp.sum(jnp.where(state.alive, state.mass, 0.0)),
        dens_residual=jnp.max(jnp.where(
            fluid_alive, jnp.abs(state.dens - cfg.rho0) / cfg.rho0, 0.0)),
        bin_overflow=bt.overflow,
        n_split=jnp.sum(state.split.astype(jnp.int32)),
    )
    return state, metrics


def sph_step_stale(state: ParticleState, bt, cfg: SPHConfig):
    """One step against a PREVIOUSLY built BinTable (cfg.sort_every
    amortization): the pool storage is still in the last sort's order,
    so the kernel reads it directly — no per-step sort and no per-step
    order gather.  The kernel's candidate ranges and cell masks come
    from the sort; distances are current.  Base variant and kernel
    backend only — enforced by use_sort_every()."""
    acc = dispatch_forces(state, bt, cfg)
    return _finish_step(state, bt, acc, cfg)


def use_sort_every(cfg: SPHConfig, subbin_parity=None) -> bool:
    """Whether the drivers should amortize the sort (cfg.sort_every>1).
    Requires the kernel backend and the base variant: unidyn's
    octant/home_count sub-bin inputs and merge compaction live in the
    tables and would go stale."""
    if cfg.sort_every <= 1:
        return False
    if cfg.variant != "base":
        raise ValueError("sort_every > 1 supports the base variant "
                         "only (unidyn sub-bin/merge state would go "
                         "stale between sorts)")
    if resolve_force_backend(cfg) == "xla":
        raise ValueError("sort_every > 1 requires the kernel force "
                         "backend")
    return True


def _scan_sort_every(state, cfg: SPHConfig, n_steps: int):
    """``n_steps`` steps that re-sort every cfg.sort_every steps (and at
    the start of the call)."""
    k = cfg.sort_every

    def group(s, length):
        s, bt = binning.sort_by_cell(s, cfg, runs=False)
        return jax.lax.scan(lambda s, _: sph_step_stale(s, bt, cfg), s,
                            None, length=length)

    full, rem = divmod(n_steps, k)
    parts = []
    if full:
        state, m = jax.lax.scan(lambda s, _: group(s, k), state, None,
                                length=full)
        parts.append(jax.tree_util.tree_map(
            lambda x: x.reshape((full * k,) + x.shape[2:]), m))
    if rem:
        state, m = group(state, rem)
        parts.append(m)
    return state, jax.tree_util.tree_map(
        lambda *xs: jnp.concatenate(xs), *parts)


@partial(jax.jit, static_argnames=("cfg", "n_steps", "subbin_parity"))
def run_chunk(state: ParticleState, cfg: SPHConfig, n_steps: int,
              subbin_parity=None):
    """Run ``n_steps`` under lax.scan; returns final state + stacked
    per-step metrics."""
    if use_sort_every(cfg, subbin_parity):
        return _scan_sort_every(state, cfg, n_steps)

    def body(s, _):
        return sph_step(s, cfg, subbin_parity)

    return jax.lax.scan(body, state, None, length=n_steps)


def run(state: ParticleState, cfg: SPHConfig, n_steps: int,
        snapshot_every: int = 0, snapshot_fn=None,
        subbin_parity=None):
    """Drive the simulation; host callbacks only at snapshot cadence
    (replacing the per-step device sync of the reference,
    solver.cu:189-197).  Steps between snapshots run as one scan."""
    chunk = snapshot_every if snapshot_every > 0 else n_steps
    all_metrics = []
    step = 0
    while step < n_steps:
        this = min(chunk, n_steps - step)
        state, metrics = run_chunk(state, cfg, this,
                                   subbin_parity=subbin_parity)
        all_metrics.append(metrics)
        step += this
        if snapshot_fn is not None and snapshot_every > 0:
            snapshot_fn(step, jax.device_get(state))
    metrics = jax.tree_util.tree_map(
        lambda *xs: jnp.concatenate(xs), *all_metrics)
    return state, metrics
