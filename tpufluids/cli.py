"""Command-line runner.

The reference's drivers are two hard-coded ``main()`` functions whose
argv is ignored (solver.cu:64, solver-unidyn.cu:68) and where changing
anything requires recompiling.  Here every scene and BASELINE.json
config is a named preset with overridable flags::

    python -m tpufluids.cli base_dam --steps 4000 --out anim/
    python -m tpufluids.cli unidyn_tank --steps 1450 --snapshot-every 20
    python -m tpufluids.cli smoke2d --steps 200 --out frames/
    python -m tpufluids.cli plume3d --size 64 --steps 100
    python -m tpufluids.cli grid3d --size 256 --steps 10 --red-black
    python -m tpufluids.cli grid3d_sharded --size 64 --devices 4
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def _add_common(p):
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--out", type=str, default=None,
                   help="VTK output directory (omit to skip snapshots)")
    p.add_argument("--snapshot-every", type=int, default=20)
    p.add_argument("--binary", action="store_true",
                   help="binary (big-endian) VTK instead of ASCII")
    p.add_argument("--metrics", type=str, default=None,
                   help="JSONL metrics path")
    p.add_argument("--checkpoint", type=str, default=None)
    p.add_argument("--checkpoint-every", type=int, default=0)
    p.add_argument("--resume", type=str, default=None)
    p.add_argument("--cpu", action="store_true", help="force CPU backend")


def build_parser():
    ap = argparse.ArgumentParser(prog="tpufluids")
    sub = ap.add_subparsers(dest="scene", required=True)
    for name in ("base_dam", "unidyn_tank"):
        p = sub.add_parser(name)
        _add_common(p)
        p.add_argument("--particles", type=int, default=None)
        if name == "base_dam":
            p.add_argument("--boundary-particles", type=int, default=0,
                           help="boundary lattice plane at z=-0.24 "
                                "(solver.cu:122-128; the driver ships "
                                "nbpts=000)")
        p.add_argument("--subbin-parity",
                       action=argparse.BooleanOptionalAction, default=None,
                       help="reference two-level-binning stencil semantics "
                            "(default: on for unidyn, off for base — the "
                            "reference's active behavior)")
        p.add_argument("--split-reinjection", action="store_true")
        if name == "base_dam":
            p.add_argument("--sort-every", type=int, default=1,
                           help="spatial-sort cadence: 1 = every step "
                                "(the reference's thrust cadence, "
                                "solver.cu:181); K > 1 amortizes the "
                                "sort over K steps (base variant + "
                                "kernel backend; SPHConfig.sort_every)")
    for name in ("smoke2d", "plume3d", "grid3d", "grid3d_sharded"):
        p = sub.add_parser(name)
        _add_common(p)
        p.add_argument("--size", type=int, default=None)
        p.add_argument("--jacobi-iters", type=int, default=20)
        p.add_argument("--red-black", action="store_true")
        # grid3d_sharded has no sharded multigrid (make_sharded_step
        # raises); restrict its choices so argparse reports it upfront
        p.add_argument("--projection", default="jacobi",
                       choices=(("jacobi", "dct")
                                if name == "grid3d_sharded" else
                                ("jacobi", "multigrid", "dct")),
                       help="Poisson solver: 'dct' (exact spectral "
                            "solve by dense DCT matmuls, the bench "
                            "default), 'jacobi' (fixed-iteration "
                            "sweeps, the reference-style scheme), "
                            "'multigrid' (V-cycles; reference/"
                            "correctness option)")
        p.add_argument("--vorticity", type=float, default=0.0)
        if name in ("plume3d", "grid3d"):
            p.add_argument("--mac", action="store_true",
                           help="staggered (MAC) grid: exact face-"
                                "difference divergence driven to solver"
                                " tolerance (tpufluids.grid.mac)")
        if name == "grid3d_sharded":
            p.add_argument("--devices", type=int, default=None)
    return ap


def run_sph(args):
    import jax

    from tpufluids import diagnostics
    from tpufluids.config import BASE_CONFIG, UNIDYN_CONFIG
    from tpufluids.io import checkpoint
    from tpufluids.io.snapshots import SnapshotWriter
    from tpufluids.scenes import base_dam, unidyn_tank
    from tpufluids.step import run

    if args.scene == "base_dam":
        cfg = BASE_CONFIG
        state = base_dam(cfg, n=args.particles or 8000,
                         nb=args.boundary_particles)
        varnames = ("dens", "cellnumber")   # solver.cu:108
        if args.sort_every > 1:
            cfg = cfg.replace(sort_every=args.sort_every)
    else:
        cfg = UNIDYN_CONFIG
        if args.split_reinjection:
            cfg = cfg.replace(split_reinjection=True)
        state = unidyn_tank(cfg)
        varnames = ("mass", "surface_level")  # solver-unidyn.cu:118

    if args.resume:
        state, meta = checkpoint.load(args.resume)
        print(f"resumed from step {meta['step']}", file=sys.stderr)

    snap = None
    if args.out:
        snap = SnapshotWriter(args.out, prefix=f"{args.scene}_",
                              varnames=varnames, use_binary=args.binary,
                              cfg=cfg)
    log = diagnostics.MetricsLogger(args.metrics) if args.metrics else None

    def cb(step, host_state):
        if snap is not None:
            snap(step, host_state)
        if (args.checkpoint and args.checkpoint_every
                and step % args.checkpoint_every == 0):
            checkpoint.save(args.checkpoint, host_state, cfg, step=step)

    t0 = time.perf_counter()
    state, metrics = run(state, cfg, args.steps,
                         snapshot_every=args.snapshot_every
                         if (snap or args.checkpoint_every) else 0,
                         snapshot_fn=cb,
                         subbin_parity=getattr(args, "subbin_parity", None))
    jax.block_until_ready(state.pos)
    dt = time.perf_counter() - t0
    if snap:
        snap.close()
    if log:
        log.log(args.steps, metrics, wall_s=dt)
        log.close()
    diagnostics.check_state(state, cfg)
    if args.checkpoint:
        checkpoint.save(args.checkpoint, jax.device_get(state), cfg,
                        step=args.steps)
    n = int(state.num_alive())
    print(json.dumps({
        "scene": args.scene, "steps": args.steps, "wall_s": dt,
        "steps_per_sec": args.steps / dt, "particles": n,
        "particle_updates_per_sec": n * args.steps / dt,
        "max_speed": float(metrics.max_speed[-1]),
        "bin_overflow": int(metrics.bin_overflow.max()),
    }))


def run_grid(args):
    import jax
    import numpy as np

    from tpufluids.grid import stam
    from tpufluids.io import vtk

    n = args.size or (128 if args.scene == "smoke2d" else 64)
    cfg = stam.StamConfig(
        n=n, dt=0.1 if args.scene == "smoke2d" else 0.05,
        diff=1e-5, visc=1e-5, jacobi_iters=args.jacobi_iters,
        red_black=args.red_black, projection=args.projection,
        vorticity_eps=args.vorticity,
        buoyancy_alpha=0.05 if args.scene == "plume3d" else 0.0,
        buoyancy_beta=1.0 if args.scene == "plume3d" else 0.0)

    t0 = time.perf_counter()
    if args.scene == "smoke2d":
        s = stam.make_grid2d(cfg)
        src = np.zeros((n + 2, n + 2), np.float32)
        src[n // 2 - 4:n // 2 + 4, 4:8] = 5.0
        fv = np.zeros_like(src)
        fv[n // 2 - 4:n // 2 + 4, 4:8] = 2.0
        frame = [0]

        def snap(step, host_state):
            vtk.write_regular_mesh(
                f"{args.out}/smoke_{frame[0]}", int(args.binary),
                [n + 2, n + 2, 1], 1, [1], [1], ["dens"],
                [np.asarray(host_state.dens).reshape(-1)])
            frame[0] += 1

        sources = {"dens": jax.numpy.asarray(src), "fv": jax.numpy.asarray(fv)}
        s = stam.run2d_python(
            s, cfg, args.steps, sources=sources,
            snapshot_every=args.snapshot_every if args.out else 0,
            snapshot_fn=snap if args.out else None)
        res = float("nan")
        state_leaf = s.dens
    elif args.scene == "grid3d_sharded":
        from tpufluids.shard import grid_sharded, make_mesh
        mesh = make_mesh(args.devices)
        s = grid_sharded.shard_state(
            grid_sharded.to_sharded_layout(stam.make_grid3d(cfg)), mesh)
        step_fn = grid_sharded.make_sharded_step(mesh, cfg,
                                                 n_steps=args.steps)
        s, res = step_fn(s)
        res = float(res)
        state_leaf = s.dens
    elif getattr(args, "mac", False):
        from tpufluids.grid import mac
        s = mac.make_mac3d(cfg)
        k = max(n // 8, 1)
        s = s.replace(
            dens=s.dens.at[3 * k:5 * k, 3 * k:5 * k, 0:k].set(1.0),
            temp=s.temp.at[3 * k:5 * k, 3 * k:5 * k, 0:k].set(3.0))
        s, residuals = mac.run3d_python(s, cfg, args.steps)
        res = float(residuals[-1])
        state_leaf = s.dens
        if args.out:
            vtk.write_regular_mesh(
                f"{args.out}/{args.scene}_mac_final", int(args.binary),
                [n, n, n], 1, [1], [1], ["dens"],
                [np.asarray(s.dens).reshape(-1)])
    else:
        s = stam.make_grid3d(cfg)
        k = max(n // 8, 1)
        s = s.replace(
            dens=s.dens.at[3 * k:5 * k, 3 * k:5 * k, 1:k + 1].set(1.0),
            temp=s.temp.at[3 * k:5 * k, 3 * k:5 * k, 1:k + 1].set(3.0))
        s, residuals = stam.run3d_python(s, cfg, args.steps)
        res = float(residuals[-1])
        state_leaf = s.dens
        if args.out:
            vtk.write_regular_mesh(
                f"{args.out}/{args.scene}_final", int(args.binary),
                [n + 2, n + 2, n + 2], 1, [1], [1], ["dens"],
                [np.asarray(s.dens).reshape(-1)])
    jax.block_until_ready(state_leaf)
    dt = time.perf_counter() - t0
    cells = (n ** 2 if args.scene == "smoke2d" else n ** 3)
    print(json.dumps({
        "scene": args.scene, "steps": args.steps, "wall_s": dt,
        "steps_per_sec": args.steps / dt,
        "cell_updates_per_sec": cells * args.steps / dt,
        "poisson_residual": res,
        # the --mac residual is max |div(u)| after projection (exact
        # face-difference divergence), NOT the collocated Poisson-system
        # residual of the other scenes — incomparable scales
        "residual_kind": ("mac_max_divergence"
                          if getattr(args, "mac", False)
                          else "poisson_system"),
    }))


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.cpu:
        import jax
        jax.config.update("jax_platforms", "cpu")
    from tpufluids import compile_cache
    compile_cache.enable()
    import os
    if args.out:
        os.makedirs(args.out, exist_ok=True)
    if args.scene in ("base_dam", "unidyn_tank"):
        run_sph(args)
    else:
        run_grid(args)


if __name__ == "__main__":
    main()
