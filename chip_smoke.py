"""Smoke run of tpufluids on one GPU: the main paths at full size.

    python chip_smoke.py               # one card: grid + SPH phases
    python chip_smoke.py --devices 4   # four cards: the sharded paths only

One process.  Each phase prints its time per step, the error it
compares and the tolerance, and whether the fields stayed finite; any
failed check raises, so the exit code is non-zero and no result line is
printed.  Without a GPU it fails at once.  The last line of stdout is
``{"ok": true, "device": {"platform", "kind", "count"}}``.

One card:
* grid 256^3, the bench headline (DCT projection with a TF32 first
  solve, vorticity confinement, buoyancy, stencil advection), 20 steps,
  against the same steps with every matmul at "highest"; the final
  Poisson residual must be <= 1e-9;
* grid 64^3, BASELINE config 4 (the plume; config 2 without forcing),
  10 steps on the GPU against the same jitted step on the CPU at
  "highest" matmul precision;
* SPH base_dam (8,000 particles) and unidyn_tank (14,040): one step's
  pair accumulators from the default backend against
  forces.compute_forces; merge partners (tank with merging on) must be
  identical; 200 steps must stay finite with bin_overflow == 0 and the
  mass conserved; two identical runs must give the same bits.

Four cards:
* grid 512^3 (BASELINE config 5) with the DCT projection, sharded over
  the 4-card mesh, against the same sharded step on a 1-card mesh;
* sharded SPH base_dam and unidyn_tank: one step against the
  single-device step, then 50 steps that must lose no particle and
  overflow no buffer.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

from tpufluids import compile_cache, device

# float32 sums taken in another order (the pair kernel's chunk order,
# the GPU's reduction trees) differ from the reference in the last bits
# of each term; relative to a field's largest value that stays far
# below this
SPH_TOL = 1e-4
# the 256^3 headline's first solve runs in TF32 (10-bit mantissa, about
# 5e-4 relative per matmul): over 20 steps that error reaches the
# fields once per step
GRID256_TOL = 2e-2
RESIDUAL_MAX = 1e-9
# GPU vs CPU, float32 stencils and sweeps, no matmuls
GRID64_TOL = 1e-4
# sharded vs one-card step: the same float32 operations, partial
# matmuls summed in another order by the reduce-scatter
SHARD_GRID_TOL = 1e-4
SHARD_SPH_TOL = 3e-4


def rel_l2(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want)
                 / max(np.linalg.norm(want), 1e-30))


def check(name, value, tol):
    print(f"  {name}: {value:.3e} (tolerance {tol:.1e})", flush=True)
    if not value <= tol:
        raise AssertionError(f"{name} = {value:.3e} exceeds {tol:.1e}")


def check_finite(name, *arrays):
    ok = all(bool(jnp.isfinite(a).all()) for a in arrays)
    print(f"  {name} finite: {ok}", flush=True)
    if not ok:
        raise AssertionError(f"{name}: non-finite values")


def timed(fn, *args):
    t0 = time.perf_counter()
    out = fn(*args)
    jax.block_until_ready(out)
    return out, time.perf_counter() - t0


# ---------------------------------------------------------------------------
# one card


def grid_headline(n=256, steps=20):
    from tpufluids.grid import stam

    kw = dict(n=n, dt=0.5 / n, jacobi_iters=20, red_black=True,
              vorticity_eps=2.0, buoyancy_beta=0.5, buoyancy_alpha=0.05,
              advect_mode="stencil", projection="dct")
    cfg = stam.StamConfig(dct_precision_first="default", **kw)
    ref_cfg = stam.StamConfig(dct_precision="highest", **kw)
    s0 = stam.make_grid3d(cfg)
    k = n // 8
    s0 = s0.replace(
        dens=s0.dens.at[3 * k:5 * k, 3 * k:5 * k, 1:k].set(1.0),
        temp=s0.temp.at[3 * k:5 * k, 3 * k:5 * k, 1:k].set(3.0))
    print(f"[grid {n}^3 headline] {steps} steps", flush=True)
    stam.run3d_python(s0, cfg, 2)              # compile
    (out, res), t = timed(stam.run3d_python, s0, cfg, steps)
    print(f"  ms/step: {t / steps * 1e3:.3f}", flush=True)
    with jax.default_matmul_precision("highest"):
        stam.run3d_python(s0, ref_cfg, 2)
        (ref, _), t_ref = timed(stam.run3d_python, s0, ref_cfg, steps)
    print(f"  ms/step at 'highest': {t_ref / steps * 1e3:.3f}", flush=True)
    check_finite("fields", out.u, out.v, out.w, out.dens, out.temp)
    err = max(rel_l2(getattr(out, f), getattr(ref, f))
              for f in ("u", "v", "w", "dens", "temp"))
    check("rel L2 vs all-highest", err, GRID256_TOL)
    check("final Poisson residual", float(res[-1]), RESIDUAL_MAX)


def grid_config4(n=64, steps=10):
    from tpufluids.grid import stam

    cfg = stam.StamConfig(n=n, dt=0.05, diff=1e-5, visc=1e-5,
                          jacobi_iters=20, red_black=True,
                          advect_mode="stencil", buoyancy_alpha=0.05,
                          buoyancy_beta=1.0, vorticity_eps=2.0)
    s0 = stam.make_grid3d(cfg)
    a, b = 3 * n // 8, 5 * n // 8
    s0 = s0.replace(dens=s0.dens.at[a:b, a:b, 1:n // 8 + 1].set(1.0),
                    temp=s0.temp.at[a:b, a:b, 1:n // 8 + 1].set(3.0))
    print(f"[grid {n}^3 config 4] {steps} steps, GPU vs CPU", flush=True)
    step = jax.jit(lambda s: stam.step3d(s, cfg))

    def run(s):
        for _ in range(steps):
            s = step(s)
        return s

    run(s0)
    out, t = timed(run, s0)
    print(f"  ms/step: {t / steps * 1e3:.3f}", flush=True)
    cpu = jax.devices("cpu")[0]
    with jax.default_device(cpu), jax.default_matmul_precision("highest"):
        ref = run(jax.device_put(s0, cpu))
    check_finite("fields", out.u, out.v, out.w, out.dens, out.temp)
    err = max(rel_l2(getattr(out, f), getattr(ref, f))
              for f in ("u", "v", "w", "dens", "temp"))
    check("rel L2 vs CPU", err, GRID64_TOL)


def max_rel_err(got, want):
    want = np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-30)
    return float(np.abs(np.asarray(got) - want).max()) / scale


def sph_scene(name, cfg, scene):
    from tpufluids import binning
    from tpufluids.forces import compute_forces
    from tpufluids.step import dispatch_forces, resolve_force_backend, run

    backend = resolve_force_backend(cfg)
    print(f"[SPH {name}] backend {backend}", flush=True)
    s0 = scene(cfg)
    # one step's accumulators, after a few steps of motion
    s1, _ = run(s0, cfg, 5)
    ss, bt = binning.sort_by_cell(s1, cfg, runs=True)
    ref = compute_forces(ss, bt, cfg, subbin_parity=cfg.subbin_parity,
                         subbin_threshold=cfg.subbin_threshold)
    got = jax.jit(lambda ss, bt: dispatch_forces(ss, bt, cfg))(ss, bt)
    fields = ("sum_w", "dpress") if cfg.variant == "base" else (
        "sum_w", "dpress", "diffusion", "vel_grad", "stress_accel",
        "solid_drift", "fluid_drift", "mixture_accel", "delsolid",
        "delfluid")
    err = max(max_rel_err(getattr(got, f), getattr(ref, f))
              for f in fields if np.abs(np.asarray(getattr(ref, f))).max())
    check("pair accumulators vs compute_forces (max err / max value)",
          err, SPH_TOL)

    steps = 200
    run(s0, cfg, steps)                         # compile
    (a, ma), t = timed(run, s0, cfg, steps)
    print(f"  ms/step: {t / steps * 1e3:.4f}", flush=True)
    (b, _), _ = timed(run, s0, cfg, steps)
    check_finite("positions", a.pos, a.vel)
    overflow = int(np.asarray(ma.bin_overflow).max())
    check("bin_overflow", overflow, 0)
    m = np.asarray(ma.total_mass)
    m0 = float(np.sum(np.where(np.asarray(s0.alive), np.asarray(s0.mass),
                               0.0)))
    check("relative mass drift", abs(float(m[-1]) - m0) / m0, 1e-6)
    same = all(np.array_equal(np.asarray(x), np.asarray(y))
               for x, y in zip(jax.tree_util.tree_leaves(a),
                               jax.tree_util.tree_leaves(b)))
    print(f"  two runs bit-identical: {same}", flush=True)
    if not same:
        raise AssertionError("two identical runs differ")


def sph_merge_partners():
    from tpufluids import binning
    from tpufluids.config import UNIDYN_CONFIG
    from tpufluids.forces import compute_forces
    from tpufluids.scenes import unidyn_tank
    from tpufluids.step import dispatch_forces, run

    cfg = UNIDYN_CONFIG.replace(merge_dist=0.06)
    print("[SPH unidyn_tank merge partners]", flush=True)
    s1, _ = run(unidyn_tank(cfg), cfg.replace(merge_dist=-10.0), 5)
    ss, bt = binning.sort_by_cell(s1, cfg, runs=True)
    ref = compute_forces(ss, bt, cfg, subbin_parity=True,
                         subbin_threshold=cfg.subbin_threshold)
    got = jax.jit(lambda ss, bt: dispatch_forces(ss, bt, cfg))(ss, bt)
    want = np.asarray(ref.merge_partner)
    have = np.asarray(got.merge_partner)
    print(f"  partners found: {int((want >= 0).sum())}", flush=True)
    check("merge partner mismatches", int((want != have).sum()), 0)


def one_card():
    from tpufluids.config import BASE_CONFIG, UNIDYN_CONFIG
    from tpufluids.scenes import base_dam, unidyn_tank

    grid_headline()
    grid_config4()
    sph_scene("base_dam", BASE_CONFIG, base_dam)
    sph_scene("unidyn_tank", UNIDYN_CONFIG, unidyn_tank)
    sph_merge_partners()


# ---------------------------------------------------------------------------
# four cards


def sharded_grid(n_dev, n=512, steps=4):
    from tpufluids.grid import stam
    from tpufluids.shard import grid_sharded, make_mesh

    cfg = stam.StamConfig(n=n, dt=0.5 / n, jacobi_iters=20, red_black=True,
                          vorticity_eps=2.0, buoyancy_beta=0.5,
                          buoyancy_alpha=0.05, projection="dct")
    s0 = stam.make_grid3d(cfg)
    k = n // 8
    s0 = grid_sharded.to_sharded_layout(s0.replace(
        dens=s0.dens.at[3 * k:5 * k, 3 * k:5 * k, 1:k].set(1.0),
        temp=s0.temp.at[3 * k:5 * k, 3 * k:5 * k, 1:k].set(3.0)))
    print(f"[grid {n}^3 config 5, DCT] {steps} steps on {n_dev} cards "
          "vs 1", flush=True)
    out = {}
    for d in (n_dev, 1):
        mesh = make_mesh(d)
        print(f"  mesh {d}: {list(mesh.devices.flat)}", flush=True)
        step = grid_sharded.make_sharded_step(mesh, cfg, n_steps=steps)
        s = grid_sharded.shard_state(s0, mesh)
        step(s)
        (o, res), t = timed(step, s)
        print(f"  {d} card(s): ms/step {t / steps * 1e3:.3f}, residual "
              f"{float(res):.3e}", flush=True)
        out[d] = (jax.device_get(o), float(res))
    got, want = out[n_dev][0], out[1][0]
    check_finite("fields", *(getattr(got, f) for f in
                             ("u", "v", "w", "dens", "temp")))
    err = max(rel_l2(getattr(got, f), getattr(want, f))
              for f in ("u", "v", "w", "dens", "temp"))
    check(f"rel L2, {n_dev} cards vs 1", err, SHARD_GRID_TOL)
    check("final Poisson residual", out[n_dev][1], RESIDUAL_MAX)


def sharded_sph(n_dev):
    from tpufluids.config import BASE_CONFIG, UNIDYN_CONFIG
    from tpufluids.oracle import state_to_dict
    from tpufluids.scenes import base_dam, unidyn_tank
    from tpufluids.shard import make_mesh
    from tpufluids.shard.particles import (collect, distribute,
                                           make_sharded_step)
    from tpufluids.step import run_chunk

    # the tank's 17 cells do not split over 4 cards; 20 cells of the
    # same size cover the same particles with the same pairs
    for name, cfg, scene in (
            ("base_dam", BASE_CONFIG, base_dam),
            ("unidyn_tank", UNIDYN_CONFIG.replace(grid_size=20),
             unidyn_tank)):
        print(f"[sharded SPH {name}] on {n_dev} cards vs the "
              "single-device step", flush=True)
        s0 = scene(cfg)
        mesh = make_mesh(n_dev)
        print(f"  mesh: {list(mesh.devices.flat)}", flush=True)
        sh = distribute(s0, mesh, cfg)
        kw = dict(halo_capacity=4096, migrate_capacity=1024)

        def by_pid(d):
            alive = d["alive"].astype(bool)
            o = np.argsort(d["pid"][alive])
            return {f: v[alive][o] for f, v in d.items()}

        # one step against the single-device step: the tank's
        # static-friction switch and stiff equation of state turn
        # last-bit differences into visible ones within a few steps
        ref, _ = run_chunk(s0, cfg, 1)
        out, _ = make_sharded_step(mesh, cfg, n_steps=1, **kw)(sh)
        rd = by_pid(state_to_dict(ref))
        od = by_pid(state_to_dict(collect(out)))
        err = max(max_rel_err(od[f], rd[f])
                  for f in ("pos", "vel", "dens"))
        check("one step, max err / max value vs single device", err,
              SHARD_SPH_TOL)
        steps = 50
        step = make_sharded_step(mesh, cfg, n_steps=steps, **kw)
        step(sh)
        (out, met), t = timed(step, sh)
        print(f"  {steps} steps, ms/step: {t / steps * 1e3:.4f}",
              flush=True)
        for k in ("halo_overflow", "migrate_overflow", "bin_overflow"):
            check(k, int(getattr(met, k)), 0)
        check("particles lost", abs(int(met.n_alive)
                                    - int(s0.num_alive())), 0)
        check_finite("positions", collect(out).pos)


# ---------------------------------------------------------------------------


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--devices", type=int, default=1,
                    help="4: run only the sharded paths over 4 cards")
    args = ap.parse_args(argv)
    compile_cache.enable()
    dev = device.require_gpu()
    print(device.nvidia_smi_name_power(), flush=True)
    print(f"jax devices: {jax.devices()}", flush=True)
    t0 = time.perf_counter()
    if args.devices == 1:
        one_card()
    else:
        if dev["count"] < args.devices:
            raise RuntimeError(f"need {args.devices} GPUs, have "
                               f"{dev['count']}")
        sharded_grid(args.devices)
        sharded_sph(args.devices)
    print(f"total {time.perf_counter() - t0:.1f}s", flush=True)
    print(json.dumps({"ok": True, "device": dev}), flush=True)


if __name__ == "__main__":
    sys.exit(main())
