"""Sort-cadence amortization (cfg.sort_every > 1): the pool is
re-sorted every K-th step and the binning tables are reused in
between (replacing the reference's every-step thrust::sort_by_key,
solver.cu:181).  The kernel backend runs under the Pallas interpreter
here."""

import numpy as np
import pytest

from tpufluids import binning
from tpufluids.config import BASE_CONFIG, UNIDYN_CONFIG
from tpufluids.oracle import state_to_dict
from tpufluids.scenes import random_blob
from tpufluids.step import (run, run_chunk, sph_step, sph_step_stale,
                            use_sort_every)


def by_pid(d):
    o = np.argsort(d["pid"])
    return {k: v[o] for k, v in d.items()}


CFG = BASE_CONFIG.replace(force_backend="interpret", max_per_cell=32)


@pytest.mark.parametrize("span", [0.5, 0.7])
def test_sort_step_matches_fresh_step(span):
    """The re-sort step of the amortized driver (sort_by_cell + stale
    step) matches the every-step path: on a just-sorted table the
    sort-time cells ARE the current cells."""
    import jax

    state = random_blob(150, seed=5, span=span)
    ref, _ = jax.jit(lambda s: sph_step(s, CFG))(state)

    def sort_step(s):
        s, bt = binning.sort_by_cell(s, CFG, runs=False)
        return sph_step_stale(s, bt, CFG)

    out, _ = jax.jit(sort_step)(state)
    refd = by_pid(state_to_dict(ref))
    outd = by_pid(state_to_dict(out))
    np.testing.assert_array_equal(outd["pid"], refd["pid"])
    for f in ("pos", "vel", "dens", "press"):
        np.testing.assert_allclose(outd[f], refd[f], rtol=1e-6,
                                   atol=1e-7, err_msg=f)


@pytest.mark.parametrize("k", [3, 4])
def test_sort_every_k_tracks_every_step(k):
    """9 steps at sort_every=k stay within tolerance of every-step
    sorting: between sorts only pairs whose endpoints drifted a full
    cell apart can differ, and those sit in the outer-support tail
    (W -> 0 at the support edge)."""
    cfgk = CFG.replace(sort_every=k)
    state = random_blob(150, seed=11, span=0.7)
    ref, _ = run_chunk(state, CFG, 9)
    out, m = run(state, cfgk, 9)
    assert m.n_alive.shape == (9,)
    refd = by_pid(state_to_dict(ref))
    outd = by_pid(state_to_dict(out))
    np.testing.assert_array_equal(outd["pid"], refd["pid"])
    for f in ("pos", "vel"):
        scale = max(1.0, np.abs(refd[f]).max())
        np.testing.assert_allclose(outd[f], refd[f], rtol=3e-4,
                                   atol=2e-4 * scale, err_msg=f)


def test_sort_every_rejects_unidyn_and_xla():
    with pytest.raises(ValueError, match="base variant"):
        use_sort_every(UNIDYN_CONFIG.replace(sort_every=4,
                                             force_backend="interpret"))
    with pytest.raises(ValueError, match="kernel"):
        use_sort_every(BASE_CONFIG.replace(sort_every=4,
                                           force_backend="xla"))
    assert not use_sort_every(BASE_CONFIG)
