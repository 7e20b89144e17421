"""tpufluids — a fluid simulation framework in JAX.

A from-scratch JAX/XLA/Pallas rebuild of the capabilities of
robbergen/FluidSolverGPU (CUDA SPH solver, reference mounted at
/root/reference):

* weakly-compressible SPH (cubic-spline / spiky kernels, Tait EOS,
  Monaghan artificial viscosity) — reference FluidGPU.cu / solver.cu
* the "unidyn" extensions: two-phase sand/water drift-flux mixture model,
  granular Drucker-Prager-style stress, leapfrog integration, adaptive
  particle merge/split — reference FluidGPU-unidyn.cu / solver-unidyn.cu
* multi-device spatial domain decomposition with halo exchange
  (reference: host-staged 2-GPU memcpy, solver-unidyn.cu:396-470;
  here: shard_map + ppermute between devices)
* legacy-VTK snapshot export (reference: visit_writer.cpp)
* a Stam stable-fluids grid module for the BASELINE.json configs.

Design: SoA pytree state, deterministic gathered pair sums (no
atomics), whole timestep under jit/lax.scan, and on a GPU the SPH pair
pass as a Pallas (Triton) cell-list kernel.
"""

__version__ = "0.1.0"

from tpufluids.config import SPHConfig, BASE_CONFIG, UNIDYN_CONFIG  # noqa: F401
from tpufluids.state import ParticleState  # noqa: F401
