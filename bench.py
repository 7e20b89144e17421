"""Benchmark harness — prints ONE JSON line on stdout.

Headline metric (BASELINE.json): cell-updates/sec for the 3D
stable-fluids step at 256^3 with the spectral (DCT) projection,
vorticity confinement, buoyancy and stencil advection, plus the final
Poisson residual.  The line names the device it ran on (platform,
device kind, count, and the card's name and power limit).

The stdout line is printed right after the headline segments.
Everything after it is a secondary that logs to stderr (and
BENCH_EXTRAS.json), each gated on a wall-clock deadline (env
BENCH_DEADLINE, seconds from process start) so the process exits well
inside an external time limit.

Runs on a GPU; without one it fails.  ``--cpu`` is the explicit
smoke-test mode (tests/test_bench_json.py): the same code path on the
CPU, whose times are no device metric.  ``--trace=DIR`` also profiles
five headline steps into DIR and logs the device time per stage
(tpufluids/trace.py).
"""

from __future__ import annotations

import json
import os
import sys
import time

_T0 = time.monotonic()
_DEADLINE = float(os.environ.get("BENCH_DEADLINE", 900))


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def remaining() -> float:
    return _DEADLINE - (time.monotonic() - _T0)


def budget(name: str, need: float) -> bool:
    """True if a secondary expected to take ``need`` seconds fits in
    the remaining deadline budget; logs the skip otherwise."""
    r = remaining()
    if r < need:
        log(f"[deadline] skipping {name}: needs ~{need:.0f}s, "
            f"{r:.0f}s left of BENCH_DEADLINE={_DEADLINE:.0f}")
        return False
    return True


def timed(fn, *args):
    """(result, seconds) of fn(*args), waiting for the device."""
    import jax

    t0 = time.perf_counter()
    out = fn(*args)
    jax.block_until_ready(out)
    return out, time.perf_counter() - t0


def main():
    cpu = "--cpu" in sys.argv
    no_secondaries = "--no-secondaries" in sys.argv
    import jax
    import jax.numpy as jnp

    if cpu:
        jax.config.update("jax_platforms", "cpu")
    from tpufluids import compile_cache, device

    compile_cache.enable()
    dev = device.describe() if cpu else device.require_gpu()
    if not cpu:
        dev["name_power_limit"] = device.nvidia_smi_name_power()

    n = 256
    steps = None
    warmup = 3
    for a in sys.argv[1:]:
        if a.startswith("--size="):
            n = int(a.split("=")[1])
        if a.startswith("--steps="):
            steps = int(a.split("=")[1])
    if steps is None:
        steps = 150 if n <= 256 else 30

    from tpufluids.grid import stam

    log(f"device: {dev}, grid {n}^3, {steps} steps, "
        f"deadline {_DEADLINE:.0f}s")

    # dt keeps CFL <= 1 cell for the stencil advection backend.
    base_kw = dict(n=n, dt=0.5 / n, jacobi_iters=20, red_black=True,
                   vorticity_eps=2.0, buoyancy_beta=0.5,
                   buoyancy_alpha=0.05, advect_mode="stencil")
    # the step's first (pre-advection) projection runs at the cheap
    # tier; the final one, which the residual reports, stays "highest"
    cfg = stam.StamConfig(projection="dct",
                          dct_precision_first="default", **base_kw)

    def seeded(c):
        s = stam.make_grid3d(c)
        k = c.n // 8
        return s.replace(
            dens=s.dens.at[3 * k:5 * k, 3 * k:5 * k, 1:k].set(1.0),
            temp=s.temp.at[3 * k:5 * k, 3 * k:5 * k, 1:k].set(3.0))

    (state, res), t_warm = timed(stam.run3d_python, seeded(cfg), cfg,
                                 warmup)
    log(f"compile+warmup ({warmup} steps): {t_warm:.1f}s")

    # median of three segments
    seg = max(steps // 3, 1)
    rates = []
    for _ in range(3):
        (state, res), dt_ = timed(stam.run3d_python, state, cfg, seg)
        rates.append(dt_ / seg)
    residual = float(res[-1])
    dt = sorted(rates)[1]

    cell_updates = n ** 3 / dt
    log(f"segment ms/step: {[r * 1e3 for r in rates]}")
    log(f"median {dt * 1e3} ms/step; {cell_updates:.6e} "
        f"cell-updates/s; residual {residual:.3e}")
    finite = bool(jnp.isfinite(state.dens).all()
                  and jnp.isfinite(state.u).all())

    extra = {
        "ms_per_step": dt * 1e3,
        "poisson_residual": residual,
        "grid": n,
        "finite": finite,
        "projection": "dct",
        "dct_precision": cfg.dct_precision,
        "dct_precision_first": cfg.dct_precision_first,
        "dct_radix_min": stam._dct_params(cfg)[1],
        "xla_flags": os.environ.get("XLA_FLAGS", ""),
    }
    print(json.dumps({
        "metric": "cell-updates/sec @ 256^3 stable-fluids step "
                  "(spectral DCT projection, vorticity confinement, "
                  "buoyancy)",
        "value": cell_updates,
        "unit": "cell-updates/s",
        "device": dev,
        "extra": extra,
    }), flush=True)

    trace_dir = next((a.split("=", 1)[1] for a in sys.argv[1:]
                      if a.startswith("--trace=")), None)
    if trace_dir:
        from tpufluids import trace

        step = stam._jitted_step3d(cfg)
        names = trace.scope_map(step.lower(state).compile().as_text(),
                                trace.GRID_SCOPES)
        path = trace.capture(lambda: step(state), trace_dir, calls=5)
        extra["trace_5_steps"] = trace.summarize(
            trace.device_events(path), trace.GRID_SCOPES, names)
        log("trace (5 steps): " + json.dumps(extra["trace_5_steps"]))

    if no_secondaries:
        return

    # ---- secondaries: stderr + BENCH_EXTRAS.json only ----------------
    # Each is wrapped (never crashes the process) and budget-gated.

    if budget("jacobi continuity", 200):
        try:
            jcfg = stam.StamConfig(projection="jacobi", **base_kw)
            (jstate, _), _ = timed(stam.run3d_python, seeded(jcfg), jcfg,
                                   warmup)
            (jstate, jres), t = timed(stam.run3d_python, jstate, jcfg, seg)
            extra["jacobi_ms_per_step"] = t / seg * 1e3
            extra["jacobi_poisson_residual"] = float(jres[-1])
            log(f"jacobi continuity: {extra['jacobi_ms_per_step']} "
                f"ms/step, residual "
                f"{extra['jacobi_poisson_residual']:.3e}")
        except Exception as e:
            log(f"jacobi secondary bench skipped: {e!r}")

    # the reference's own two scenes (SPH) on the default backend, plus
    # the merge-enabled tank and the amortised-sort dam; each cell is
    # guarded on its own so one failure never hides the others
    from tpufluids.config import BASE_CONFIG, UNIDYN_CONFIG
    from tpufluids.scenes import base_dam, unidyn_tank
    from tpufluids.step import run_chunk
    for sname, scfg, scene in (
            ("base_dam_8000p", BASE_CONFIG, base_dam),
            ("base_dam_sort_every8", BASE_CONFIG.replace(sort_every=8),
             base_dam),
            ("unidyn_tank_14040p", UNIDYN_CONFIG, unidyn_tank),
            ("unidyn_tank_merge_on", UNIDYN_CONFIG.replace(merge_dist=0.06),
             unidyn_tank)):
        if not budget(f"SPH {sname}", 60):
            continue
        try:
            (s, _), _ = timed(run_chunk, scene(scfg), scfg, 300)
            (s, _), t = timed(run_chunk, s, scfg, 300)
            extra[sname + "_ms_per_step"] = t / 300 * 1e3
            log(f"SPH {sname}: {extra[sname + '_ms_per_step']} ms/step")
        except Exception as e:
            log(f"SPH {sname} skipped: {e!r}")

    if budget("sharded SPH 1-device", 120):
        try:
            # sharded SPH on ONE device (solver-unidyn.cu:396-470's
            # decomposition): per-step overhead vs the unsharded dam
            from tpufluids.shard import make_mesh
            from tpufluids.shard.particles import (distribute,
                                                   make_sharded_step)
            mesh1 = make_mesh(1)
            s = base_dam(BASE_CONFIG)
            sh = distribute(s, mesh1, BASE_CONFIG, s.capacity)
            stepn = make_sharded_step(mesh1, BASE_CONFIG, n_steps=300)
            (sh, _), _ = timed(stepn, sh)
            (sh, _), t = timed(stepn, sh)
            extra["sph_sharded_1dev_ms"] = t / 300 * 1e3
            log(f"SPH sharded (1 device) base_dam: "
                f"{extra['sph_sharded_1dev_ms']} ms/step")
        except Exception as e:
            log(f"sharded SPH secondary bench skipped: {e!r}")

    # the remaining BASELINE.json configs (1: 2D smoke box, 2: 64^3
    # step, 4: buoyant plume)
    if budget("BASELINE configs 1/2/4", 150):
        try:
            c1 = stam.StamConfig(n=128, dt=0.1, diff=1e-5, visc=1e-5,
                                 jacobi_iters=20, advect_mode="stencil")
            src = jnp.zeros((130, 130), jnp.float32
                            ).at[60:68, 4:8].set(5.0)
            fv = jnp.zeros_like(src).at[60:68, 4:8].set(2.0)
            sources = {"dens": src, "fv": fv}
            s1, _ = timed(stam.run2d_python, stam.make_grid2d(c1), c1, 3,
                          sources)
            s1, t = timed(stam.run2d_python, s1, c1, 400, sources)
            extra["config1_smoke2d_128_ms"] = t / 400 * 1e3

            for key, kw in (("config2_grid3d_64_ms", {}),
                            ("config4_plume3d_64_ms",
                             dict(buoyancy_alpha=0.05, buoyancy_beta=1.0,
                                  vorticity_eps=2.0))):
                c = stam.StamConfig(n=64, dt=0.05, diff=1e-5, visc=1e-5,
                                    jacobi_iters=20, red_black=True,
                                    advect_mode="stencil", **kw)
                s3 = stam.make_grid3d(c)
                s3 = s3.replace(
                    dens=s3.dens.at[24:40, 24:40, 1:9].set(1.0),
                    temp=s3.temp.at[24:40, 24:40, 1:9].set(3.0))
                (s3, _), _ = timed(stam.run3d_python, s3, c, 3)
                (s3, _), t = timed(stam.run3d_python, s3, c, 400)
                extra[key] = t / 400 * 1e3
            log("BASELINE configs 1/2/4: "
                + str({k: extra[k] for k in
                       ("config1_smoke2d_128_ms", "config2_grid3d_64_ms",
                        "config4_plume3d_64_ms") if k in extra}))
        except Exception as e:
            log(f"BASELINE-config secondary bench skipped: {e!r}")

    if budget("config5 sharded grid", 120):
        try:
            # the sharded step on ONE device at the headline size; the
            # gap to the unsharded step is the sharding overhead
            from tpufluids.shard import grid_sharded, make_mesh
            mesh = make_mesh(1)
            s5 = grid_sharded.shard_state(
                grid_sharded.to_sharded_layout(state), mesh)
            step5 = grid_sharded.make_sharded_step(mesh, cfg, n_steps=seg)
            (s5, _), _ = timed(step5, s5)
            (s5, r5), t = timed(step5, s5)
            extra["config5_sharded_1dev_ms"] = t / seg * 1e3
            log(f"config5 sharded (1 device) {n}^3: "
                f"{extra['config5_sharded_1dev_ms']} ms/step, "
                f"residual {float(r5):.3e}")
        except Exception as e:
            log(f"sharded secondary bench skipped: {e!r}")

    if n == 256 and budget("512^3 probe", 200):
        try:
            c512 = cfg.replace(n=512, dt=0.5 / 512)
            (s512, _), _ = timed(stam.run3d_python, seeded(c512), c512, 2)
            (s512, r512), t = timed(stam.run3d_python, s512, c512, 24)
            extra["grid512_ms_per_step"] = t / 24 * 1e3
            extra["grid512_cell_updates_per_sec"] = 512 ** 3 / (t / 24)
            log(f"512^3 (dct): {extra['grid512_ms_per_step']} ms/step, "
                f"residual {float(r512[-1]):.3e}")
            del s512
        except Exception as e:
            log(f"512^3 secondary bench skipped: {e!r}")

    try:
        with open(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                               "BENCH_EXTRAS.json"), "w") as f:
            json.dump({"value": cell_updates, "device": dev,
                       "extra": extra}, f, indent=1)
    except OSError as e:
        log(f"could not write BENCH_EXTRAS.json: {e}")
    log("extras: " + json.dumps(extra))


if __name__ == "__main__":
    main()
