"""Particle state as a structure-of-arrays pytree.

The reference stores an array-of-structures ``Particle`` of ~340 bytes
(FluidGPU.cuh:59-305; FluidGPU-unidyn.cuh:68-424).  Here we keep one
array per field (SoA) so every physics pass is a dense vector op, and
the whole state is a pytree that moves through ``jit``/``lax.scan``/
``shard_map`` untouched.

Persistent fields only — per-step accumulators (the reference's
``new*`` double buffers, drift velocities, ``vel_grad``, ``stress_accel``
etc., reset each step in ``mykernel2``, FluidGPU-unidyn.cu:475-483) are
transient values inside the step function, not state.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import jax
import jax.numpy as jnp

from tpufluids.config import SPHConfig


def pytree_dataclass(cls):
    """Frozen dataclass whose fields are all pytree leaves, with a
    ``replace(**fields)`` copy method."""
    cls = dataclasses.dataclass(frozen=True)(cls)
    cls.replace = lambda self, **kw: dataclasses.replace(self, **kw)
    return jax.tree_util.register_dataclass(cls)


@pytree_dataclass
class ParticleState:
    """SoA particle pool of static capacity N.

    ``alive`` implements the fixed-capacity pool used for merge/split
    (the reference instead teleports merged particles to 90.99 and
    compacts after the sort, FluidGPU-unidyn.cu:261-275, 554-562).
    """

    pos: jax.Array          # (N, 3) f32
    vel: jax.Array          # (N, 3) f32
    acc: jax.Array          # (N, 3) f32 — acceleration from previous step
    mass: jax.Array         # (N,)  f32
    dens: jax.Array         # (N,)  f32
    press: jax.Array        # (N,)  f32
    delpress: jax.Array     # (N, 3) f32 — pressure gradient of previous step
    diffusion: jax.Array    # (N, 3) f32 — color/surface gradient accumulator
    solid: jax.Array        # (N,)  f32 — solid volume fraction (unidyn)
    fluid: jax.Array        # (N,)  f32 — fluid volume fraction (unidyn)
    stress: jax.Array       # (N, 3, 3) f32 — granular stress tensor sigma
    boundary: jax.Array     # (N,)  bool
    alive: jax.Array        # (N,)  bool
    split: jax.Array        # (N,)  bool — split-requested flag
    pid: jax.Array          # (N,)  i32 — stable particle id (reference `index`)

    @property
    def capacity(self) -> int:
        return self.pos.shape[0]

    def num_alive(self) -> jax.Array:
        return jnp.sum(self.alive.astype(jnp.int32))


def make_state(
    pos,
    vel=None,
    *,
    boundary=None,
    solid=None,
    fluid=None,
    mass=None,
    cfg: Optional[SPHConfig] = None,
    capacity: Optional[int] = None,
    rho0: float = 9550.0,
    gravity: float = -9.8,
) -> ParticleState:
    """Build a ParticleState from seed arrays, padding to ``capacity``.

    Initial values mirror the reference constructors: fluid particles
    start with ``acc = (0, 0, GRAVITY)`` (FluidGPU.cuh:99-110), boundary
    particles with zero acceleration (FluidGPU.cuh:88-96), density rho0,
    mass 1, zero pressure.
    """
    if cfg is not None:
        rho0, gravity = cfg.rho0, cfg.gravity
    pos = jnp.asarray(pos, jnp.float32)
    n = pos.shape[0]
    cap = capacity or n
    if vel is None:
        vel = jnp.zeros((n, 3), jnp.float32)
    if boundary is None:
        boundary = jnp.zeros((n,), bool)
    else:
        boundary = jnp.asarray(boundary, bool)
    if solid is None:
        solid = jnp.zeros((n,), jnp.float32)
    if fluid is None:
        fluid = 1.0 - jnp.asarray(solid, jnp.float32)
    if mass is None:
        mass = jnp.ones((n,), jnp.float32)

    acc = jnp.where(
        boundary[:, None],
        jnp.zeros((n, 3), jnp.float32),
        jnp.broadcast_to(jnp.array([0.0, 0.0, gravity], jnp.float32), (n, 3)),
    )

    def pad(a, fill=0):
        if cap == n:
            return jnp.asarray(a)
        a = jnp.asarray(a)
        width = [(0, cap - n)] + [(0, 0)] * (a.ndim - 1)
        return jnp.pad(a, width, constant_values=fill)

    return ParticleState(
        pos=pad(pos),
        vel=pad(jnp.asarray(vel, jnp.float32)),
        acc=pad(acc),
        mass=pad(jnp.asarray(mass, jnp.float32)),
        dens=pad(jnp.full((n,), rho0, jnp.float32)),
        press=pad(jnp.zeros((n,), jnp.float32)),
        delpress=pad(jnp.zeros((n, 3), jnp.float32)),
        diffusion=pad(jnp.zeros((n, 3), jnp.float32)),
        solid=pad(jnp.asarray(solid, jnp.float32)),
        fluid=pad(jnp.asarray(fluid, jnp.float32)),
        stress=pad(jnp.zeros((n, 3, 3), jnp.float32)),
        boundary=pad(boundary, fill=False),
        alive=pad(jnp.ones((n,), bool), fill=False),
        split=pad(jnp.zeros((n,), bool), fill=False),
        pid=pad(jnp.arange(n, dtype=jnp.int32), fill=-1),
    )
