"""The cell-list pair kernel (tpufluids/sph_triton.py) against the XLA
pair pass across variant, sub-bin mode, merging and pool order; the
backend resolver; and the helpers the entry points share (compile
cache, device description, trace reduction)."""

import os

import jax
import numpy as np
import pytest

from tpufluids import binning, compile_cache, device, trace
from tpufluids.config import BASE_CONFIG, UNIDYN_CONFIG
from tpufluids.forces import compute_forces
from tpufluids.scenes import random_blob
from tpufluids.step import dispatch_forces, resolve_force_backend

FIELDS = ("sum_w", "dpress", "diffusion", "vel_grad", "stress_accel",
          "solid_drift", "fluid_drift", "mixture_accel", "delsolid",
          "delfluid")


def _scene(variant, subbin, merge):
    if variant == "base":
        cfg = BASE_CONFIG.replace(max_per_cell=48, grid_size=8,
                                  cell_size=0.25)
        state = random_blob(160, seed=21, cfg=cfg, span=0.6,
                            boundary_frac=0.2)
    else:
        from tests.test_forces_vs_oracle import mixed_blob
        # default unidyn cells with a dense blob, so the octant sub-bin
        # predicate removes pairs
        cfg = UNIDYN_CONFIG.replace(max_per_cell=64,
                                    merge_dist=0.05 if merge else -10.0)
        state = mixed_blob(140, 23, cfg, span=0.18)
    return cfg.replace(subbin_parity=subbin), state


def _pid_perm(sorted_state, pool_state):
    """Index into sorted-order arrays for each pool row."""
    at = {int(p): i for i, p in enumerate(np.asarray(sorted_state.pid))}
    return np.array([at[int(p)] for p in np.asarray(pool_state.pid)])


@pytest.mark.parametrize("order_mode", [False, True])
@pytest.mark.parametrize("variant,subbin,merge", [
    ("base", False, False), ("base", True, False),
    ("unidyn", False, False), ("unidyn", True, False),
    ("unidyn", False, True), ("unidyn", True, True)])
def test_kernel_matches_xla(variant, subbin, merge, order_mode):
    cfg, state = _scene(variant, subbin, merge)
    ss, bt = binning.sort_by_cell(state, cfg)
    ref = compute_forces(ss, bt, cfg, subbin_parity=subbin,
                         subbin_threshold=cfg.subbin_threshold)
    kcfg = cfg.replace(force_backend="interpret")
    if order_mode:
        order, bt2 = binning.sort_tables(state, cfg)
        got = dispatch_forces(state, bt2, kcfg, order=order)
        perm = _pid_perm(ss, state)
    else:
        got = dispatch_forces(ss, bt, kcfg)
        perm = np.arange(state.capacity)
    for name in FIELDS:
        a = np.asarray(getattr(ref, name))[perm]
        b = np.asarray(getattr(got, name))
        scale = max(1.0, float(np.abs(a).max()))
        np.testing.assert_allclose(b, a, rtol=1e-4, atol=1e-5 * scale,
                                   err_msg=name)
    want_mp = np.asarray(ref.merge_partner)[perm]
    if order_mode:
        # sorted rows -> pool rows
        pool_row = np.empty(state.capacity, int)
        pool_row[perm] = np.arange(state.capacity)
        want_mp = np.where(want_mp >= 0, pool_row[want_mp], -1)
    np.testing.assert_array_equal(np.asarray(got.merge_partner), want_mp)
    if merge:
        assert (want_mp >= 0).sum() > 5, "scene must exercise merging"


def test_kernel_skips_dead_and_out_of_domain_rows():
    """Dead and out-of-domain particles sort past the binned rows: they
    get zero sums and take part in no pair, as on the XLA path."""
    cfg = BASE_CONFIG.replace(max_per_cell=48, grid_size=8,
                              cell_size=0.25)
    state = random_blob(120, seed=5, cfg=cfg, span=0.6)
    pos = np.asarray(state.pos).copy()
    pos[:10, 0] = 5.0                                   # out of domain
    alive = np.asarray(state.alive).copy()
    alive[10:20] = False
    state = state.replace(pos=jax.numpy.asarray(pos),
                          alive=jax.numpy.asarray(alive))
    order, bt = binning.sort_tables(state, cfg)
    got = dispatch_forces(state, bt, cfg.replace(force_backend="interpret"),
                          order=order)
    sw = np.asarray(got.sum_w)
    assert (sw[:20] == 0).all()
    assert (sw[20:] > 0).any()
    ss, bts = binning.sort_by_cell(state, cfg)
    ref = compute_forces(ss, bts, cfg)
    np.testing.assert_allclose(np.sort(sw), np.sort(np.asarray(ref.sum_w)),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("name,want", [("xla", "xla"),
                                       ("triton", "triton"),
                                       ("interpret", "interpret"),
                                       ("auto", "xla")])
def test_resolve_force_backend(name, want):
    """"auto" is the kernel on a GPU only; here (CPU) it is XLA, and
    the interpreter is never chosen implicitly."""
    assert resolve_force_backend(BASE_CONFIG.replace(force_backend=name)) \
        == want


def test_resolve_force_backend_rejects_unknown():
    with pytest.raises(ValueError, match="force_backend"):
        resolve_force_backend(BASE_CONFIG.replace(force_backend="pallas"))


def test_compile_cache_follows_env(monkeypatch, tmp_path):
    monkeypatch.setenv(compile_cache.ENV, str(tmp_path))
    before = jax.config.jax_compilation_cache_dir
    assert compile_cache.enable() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before


def test_compile_cache_default_is_in_checkout(monkeypatch):
    monkeypatch.delenv(compile_cache.ENV, raising=False)
    before = jax.config.jax_compilation_cache_dir
    try:
        path = compile_cache.enable()
        repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        assert path == os.path.join(repo, ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == path
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_device_describe_and_require_gpu():
    dev = device.describe()
    assert dev == {"platform": "cpu", "kind": dev["kind"], "count": 8}
    with pytest.raises(RuntimeError, match="no GPU"):
        device.require_gpu()


def test_trace_summary_busy_and_scopes():
    ev = [dict(name="fusion.1", start=0, dur=10, line="Stream #1",
               text="jit(f)/sort/x"),
          dict(name="sph_base_pairs", start=5, dur=10, line="Stream #1",
               text="jit(f)/pair_pass/pallas_call"),
          dict(name="copy", start=30, dur=10, line="Stream #2", text="")]
    s = trace.summarize(ev, trace.SPH_SCOPES)
    assert s["window_ms"] == 40e-6 and s["busy_ms"] == 25e-6
    assert abs(s["idle_share"] - 15 / 40) < 1e-12
    assert s["scopes_ms"] == {"sort": 10e-6, "pair_pass": 10e-6,
                              "update": 0.0, "other": 10e-6}


@pytest.fixture
def gpu_device():
    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU (the compiled kernel has no CPU path)")
    return jax.devices()[0]


@pytest.mark.gpu
def test_compiled_kernel_matches_xla_on_gpu(gpu_device):
    from tpufluids.scenes import base_dam
    cfg = BASE_CONFIG
    ss, bt = binning.sort_by_cell(base_dam(cfg), cfg)
    ref = compute_forces(ss, bt, cfg)
    got = dispatch_forces(ss, bt, cfg.replace(force_backend="triton"))
    for name in ("sum_w", "dpress"):
        a = np.asarray(getattr(ref, name))
        scale = max(1.0, float(np.abs(a).max()))
        np.testing.assert_allclose(np.asarray(getattr(got, name)), a,
                                   rtol=1e-4, atol=1e-5 * scale)


@pytest.mark.parametrize("n", [1, 15, 16, 17, 1000])
def test_padding_keeps_every_load_in_bounds(n):
    """Every home load [blk, blk+RB) and every candidate chunk
    [j0, j0+CH) with j0 < n lies inside the padded rows, and the
    programs cover every row."""
    from tpufluids import sph_triton as st
    nb, n_pad = st._padded(n)
    assert nb * st.RB >= n > (nb - 1) * st.RB
    assert n_pad >= nb * st.RB and n_pad >= (n - 1) + st.CH


def test_combine_adds_partials_and_picks_nearest_lowest_row():
    from tpufluids import sph_triton as st
    rows = st._A_OUT + 2
    part = np.zeros((3, rows, 4), np.float32)
    part[:, 0] = [[1, 2, 3, 4], [10, 20, 30, 40], [100, 200, 300, 400]]
    big = st._BIG
    # (distance, row) per program for four home rows: a unique nearest,
    # a tie broken by the lower row, nothing found, one program only
    part[:, st._A_BESTD] = [[0.5, 0.2, big, big],
                            [0.3, 0.2, big, 0.7],
                            [0.4, 0.9, big, big]]
    part[:, st._A_BESTROW] = [[5, 9, -1, -1],
                              [7, 3, -1, 11],
                              [2, 1, -1, -1]]
    out = np.asarray(st._combine(jax.numpy.asarray(part), merge=True))
    np.testing.assert_array_equal(out[0], [111, 222, 333, 444])
    np.testing.assert_array_equal(
        out[st._A_BESTD], np.float32([0.3, 0.2, big, 0.7]))
    np.testing.assert_array_equal(out[st._A_BESTROW], [7, 3, -1, 11])


def test_scope_map_reads_op_names():
    hlo = "\n".join([
        'ENTRY %main {',
        '  %loop_select_fusion.2 = f32[8] fusion(%p), kind=kLoop, '
        'metadata={op_name="jit(f)/advect_vel/add"}',
        '  %custom-call.1 = f32[8] custom-call(%p), '
        'metadata={op_name="jit(f)/pair_pass/sph_base_pairs/pallas_call"}',
        '  %loop_add_fusion.4 = f32[8] fusion(%p), kind=kLoop, '
        'calls=%fused_add.4',
        '}',
        '%fused_add.4 (param_0: f32[8]) -> f32[8] {',
        '  %a.1 = f32[8] add(%param_0, %param_0), '
        'metadata={op_name="jit(f)/forcing/add"}',
        '  ROOT %copy.3 = f32[8] copy(%q), '
        'metadata={op_name="jit(f)/mystery/copy"}',
        '}'])
    m = trace.scope_map(hlo, trace.GRID_SCOPES + trace.SPH_SCOPES)
    assert m["loop_select_fusion_2"] == "advect_vel"
    assert m["custom_call_1"] == "pair_pass"
    assert m["sph_base_pairs"] == "pair_pass"
    assert m["loop_add_fusion_4"] == "forcing"
    assert "copy_3" not in m


@pytest.mark.parametrize("spans,busy", [
    ([(0, 10)], 10),
    ([(0, 10), (5, 10), (30, 5)], 20),
    ([(0, 100), (10, 5), (20, 5), (200, 1)], 101)])
def test_busy_ns_is_union_of_intervals(spans, busy):
    ev = [dict(start=s, dur=d) for s, d in spans]
    assert trace.busy_ns(ev) == busy
