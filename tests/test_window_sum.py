"""Window sums of the boringbits device path (prefix-sum form) against the
NumPy oracle, including tracks deep and long enough for the int32 prefix
sum to wrap."""

import numpy as np
import pytest

from cornetto_tpu.kernels.window_sum import (window_stats_jax,
                                             window_stats_numpy)


@pytest.mark.parametrize("n,w,inc", [(8192, 2500, 50), (4096, 64, 7),
                                     (2048, 1, 1)])
def test_window_form_matches_numpy(n, w, inc):
    rng = np.random.default_rng(n + w)
    d = rng.integers(0, 65536, n).astype(np.uint16)
    m = rng.integers(0, 65536, n).astype(np.uint16)
    got = window_stats_jax(d, m, w, inc, pad_bucket=1 << 12)
    want = window_stats_numpy(d, m, w, inc)
    for g, x in zip(got, want):
        np.testing.assert_array_equal(g, x)


@pytest.mark.parametrize("n", [40_000, 100_003])
def test_prefix_sum_wraps_exactly(n):
    """65,535-deep tracks: the int32 prefix sum passes 2^31 (after ~32,768
    bases) and wraps, yet every window sum stays exact."""
    d = np.full(n, 65535, dtype=np.uint16)
    m = d.copy()
    m[::3] = 0
    assert int(d.astype(np.int64).sum()) > 2 ** 31
    got = window_stats_jax(d, m, 32767, 50, pad_bucket=1 << 16)
    want = window_stats_numpy(d, m, 32767, 50)
    for g, x in zip(got, want):
        np.testing.assert_array_equal(g, x)
    assert (got[2][got[1] - got[0] == 32767] == 65535).all()


@pytest.mark.gpu
def test_window_form_on_gpu_chr1_sized():
    rng = np.random.default_rng(1)
    n = 248_956_422
    d = rng.integers(0, 65536, n).astype(np.uint16)
    m = rng.integers(0, 65536, n).astype(np.uint16)
    got = window_stats_jax(d, m, 2500, 50)
    want = window_stats_numpy(d, m, 2500, 50)
    for g, x in zip(got, want):
        np.testing.assert_array_equal(g, x)
