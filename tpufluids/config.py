"""Simulation configuration.

The reference (robbergen/FluidSolverGPU) hard-codes every physics and
domain constant as a compile-time ``#define`` (FluidGPU.cuh:1-31,
FluidGPU-unidyn.cuh:1-36) and hand-edits scene sizes in the drivers
(solver.cu:17-19, solver-unidyn.cu:21-23).  Here everything is a frozen
dataclass field so scenes are runtime-configurable; the two presets
``BASE_CONFIG`` and ``UNIDYN_CONFIG`` reproduce the reference values
verbatim, including the quirky magic numbers called out by name
(density normalization, static-friction threshold, acceleration
prefactors, wall constants).
"""

from __future__ import annotations

import dataclasses
import math

# The reference uses the literal 3.14159 in its smoothing kernels
# (FluidGPU.cu:13,16,25,28,37), not machine pi.  Kept for parity.
PI_REF = 3.14159


@dataclasses.dataclass(frozen=True)
class SPHConfig:
    """All solver constants. Defaults = base variant (FluidGPU.cuh:1-31)."""

    # --- variant selection -------------------------------------------------
    # "base": single-phase WCSPH, explicit Euler (FluidGPU.cuh / solver.cu)
    # "unidyn": two-phase mixture + granular stress, leapfrog
    #           (FluidGPU-unidyn.cuh / solver-unidyn.cu)
    variant: str = "base"

    # --- domain / binning grid (FluidGPU.cuh:1-9) ---------------------------
    xmin: float = -1.0
    ymin: float = -1.0
    zmin: float = -1.0
    xmax: float = 1.0
    ymax: float = 1.0
    zmax: float = 1.0
    cell_size: float = 0.05
    grid_size: int = 40          # (xmax - xmin) / cell_size

    # --- physical constants (FluidGPU.cuh:10-14) ----------------------------
    gravity: float = -9.8
    sound: float = 1450.0
    rho0: float = 9550.0         # reference density of "water"
    rho0_sand: float = 9550.0    # unidyn RHO_0_SAND (FluidGPU-unidyn.cuh:13)
    p0: float = 101325.0
    diff: float = 0.0            # DIFF diffusion magnitude (disabled)

    # --- artificial viscosity (FluidGPU.cuh:16-20; -unidyn.cuh:17-21) -------
    alpha_fluid: float = -1.0        # -0.01e2
    alpha_boundary: float = 200.0    # 2000e-1
    alpha_sand: float = -1.55        # unidyn ALPHA_SAND (-0.0155e2)
    alpha_sand_boundary: float = 10.0  # unidyn ALPHA__SAND_BOUNDARY (100e-1)
    # quadratic term weight inside the inline viscosity of the force kernel:
    # s ~ alpha*SOUND*(h*mu + (visc_quad/SOUND)*(h*mu)^2)/rho_bar
    # (the literal 50 at FluidGPU.cu:255, FluidGPU-unidyn.cu:307)
    visc_quadratic: float = 50.0

    # --- boundary densification (FluidGPU.cuh:22) ---------------------------
    bdensfactor: float = 1.5

    # --- granular stress constants (FluidGPU.cuh:24-28; -unidyn.cuh:26-30) --
    c1: float = 15.0
    c2: float = 0.0
    c3: float = 0.0              # unidyn: 50.0
    phi: float = 1.23            # friction angle (radians)
    kc: float = 1e3              # cohesion; unidyn: 1e9
    # denominator regularizer in the stress-rate middle term
    # (the literal 1e8 at FluidGPU.cu:393, FluidGPU-unidyn.cu:439)
    stress_rate_reg: float = 1e8

    # --- mixture (drift-flux) couplings (FluidGPU-unidyn.cuh:32-33) ---------
    mixpressure: float = 1e-12
    mixbrownian: float = 5e-9
    # volume-fraction gate for the mixture terms (FluidGPU-unidyn.cu:317)
    mix_frac_min: float = 0.001
    mix_frac_max: float = 0.999
    # mixfactor denominator regularizer (the 0.01 at FluidGPU-unidyn.cu:368)
    mixfactor_reg: float = 0.01
    # drag prefactor in the leapfrog friction term
    # (the 0.0000002 at FluidGPU-unidyn.cuh:351-353)
    solid_drag: float = 2e-7
    # mixture_accel weight in the velocity kick
    # (the literal 5 at FluidGPU-unidyn.cuh:351-353)
    mixture_accel_weight: float = 5.0
    # minimum fluid fraction before transport freezes
    # (FluidGPU-unidyn.cuh:315: if fluid + delfluid < 0.2 -> delfluid = 0)
    fluid_floor: float = 0.2

    # --- kernel support & timestep (FluidGPU.cuh:30-31) ---------------------
    cutoff: float = 0.06         # smoothing length h; support radius = 2h
    dt: float = 0.0005           # unidyn: 0.0018

    # --- quirky named constants (SURVEY.md §7 "reproducing quirky constants")
    # density normalization: dens = (sum + W(0))/23 * (1 + bnd*BDENS) + 9250
    # (FluidGPU.cuh:165-167)
    dens_norm_div: float = 23.0
    dens_norm_offset: float = 9250.0
    # Tait EOS stiffness multiplier: press = 1000 * rho0/7 * ((rho/rho0)^7-1)
    # (FluidGPU.cuh:256-260; SOUND^0 == 1 so the stiffness is literally 1000)
    eos_stiffness: float = 1000.0
    eos_gamma: float = 7.0
    # static-friction hack threshold (FluidGPU.cuh:290-295)
    friction_eps: float = 0.003
    # pressure-gradient acceleration prefactors:
    # base: a = -(150/rho) * delpress (FluidGPU.cuh:298-300)
    accel_prefactor: float = 150.0
    # unidyn: a = -((220 - 70*solid)/rho) * delpress (FluidGPU-unidyn.cuh:357-359)
    accel_prefactor_unidyn: float = 220.0
    accel_prefactor_solid: float = 70.0
    # unidyn wall handling (FluidGPU-unidyn.cuh:332, 404-413)
    floor_recycle_z: float = -0.89
    wall_limit: float = 0.98
    wall_clamp: float = 0.97

    # --- two-level binning (FluidGPU-unidyn.cu:181-192, 569-869) ------------
    # In the reference's unidyn variant the octant sub-bin refinement is
    # the ACTIVE default: every cell with population > subbin_threshold
    # skips the coarse kernel and is processed by the fine kernel
    # mykernel3 with the 8-cell octant stencil (launch at
    # solver-unidyn.cu:379).  subbin_parity=True reproduces those
    # stencil semantics (UNIDYN_CONFIG default); False uses the full
    # 27-cell stencil everywhere (a superset of the interaction set).
    # Callers may override per call (step.sph_step(subbin_parity=...)).
    subbin_parity: bool = False
    subbin_threshold: int = 6

    # --- adaptive resolution (merge/split; FluidGPU-unidyn.cu:261-285) ------
    # merge distance threshold; the reference ships with the sentinel -10.0
    # which disables merging (ds <= -10 is never true for ds > 0).
    merge_dist: float = -10.0
    merge_mass_new: float = 2.75
    merge_diffusion_max: float = 20.0
    split_mass_min: float = 3.0
    split_diffusion_min: float = 35000.0
    split_dens_max: float = 9400.0
    split_y_nudge: float = 0.015
    # host split re-injection (solver-unidyn.cu:495-542, commented out in the
    # reference; implemented here as a masked pool op, off by default)
    split_reinjection: bool = False
    split_child_y_offset: float = -0.03

    # --- pair-pass backend and sort cadence (no reference equivalent) -----
    # SPH pair-pass backend (step.resolve_force_backend): "auto" (the
    # cell-list kernel of tpufluids/sph_triton.py on a GPU, the XLA
    # gather pass anywhere else), "xla", "triton", or "interpret" (the
    # kernel under the Pallas interpreter, for CPU tests).
    force_backend: str = "auto"
    # Spatial-sort cadence: 1 = re-sort the pool every step (the
    # reference's thrust::sort_by_key cadence, solver.cu:181).  K > 1
    # re-sorts every K-th step (and at the start of each run_chunk) and
    # reuses the binning tables in between: the pool storage stays in
    # the last sort's order, so the kernel reads it without the
    # per-step sort and order gather.  Between sorts the candidate
    # ranges and the 27-cell masks come from sort-time cells while
    # distances (ds <= 2h) are current, so the pair set is the
    # sort-time stencil set: with per-step drift bounded by
    # max_speed*dt (a few % of a cell at the reference scenes), the
    # pairs it misses sit in the outer-support tail the reference's own
    # 27-cell stencil already truncates (FluidGPU.cu:124-126).  Base
    # variant and kernel backend only (unidyn's octant/home_count
    # sub-bin state would go stale).
    sort_every: int = 1
    # dense neighbor-run capacity: each of the 9 (dx,dy) stencil runs covers
    # the contiguous cells (z-1, z, z+1) and holds at most 3*max_per_cell
    # particle slots; overflow is deterministic (highest-rank dropped) and
    # surfaced in diagnostics (vs the reference silently dropping cells with
    # population >= 64, FluidGPU.cu:174).
    max_per_cell: int = 16

    # ------------------------------------------------------------------------
    @property
    def num_cells(self) -> int:
        return self.grid_size ** 3

    @property
    def support(self) -> float:
        return 2.0 * self.cutoff

    @property
    def yield_denom(self) -> float:
        """sqrt(9 + 12 tan^2 phi) of the Drucker-Prager-style yield rule
        (FluidGPU-unidyn.cu:436-438)."""
        t = math.tan(self.phi)
        return math.sqrt(9.0 + 12.0 * t * t)

    def replace(self, **kw) -> "SPHConfig":
        return dataclasses.replace(self, **kw)


# Base variant preset: FluidGPU.cuh:1-31 + solver.cu scene constants.
BASE_CONFIG = SPHConfig()

# unidyn variant preset: FluidGPU-unidyn.cuh:1-36.
UNIDYN_CONFIG = SPHConfig(
    variant="unidyn",
    cell_size=0.12,
    grid_size=17,
    alpha_fluid=-0.155,        # -0.0155e1
    alpha_boundary=80.0,       # 80e0
    alpha_sand=-1.55,          # -0.0155e2
    alpha_sand_boundary=10.0,  # 100e-1
    c1=15.0,
    c2=0.0,                    # 0e6
    c3=50.0,                   # 5e1
    kc=1e9,
    dt=0.0018,
    max_per_cell=32,
    # the reference's default: cells with population > 6 use the octant
    # sub-bin stencil (mykernel3, solver-unidyn.cu:379)
    subbin_parity=True,
)
