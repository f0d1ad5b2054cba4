"""Hybrid device/host SDUST: a device candidate filter plus the exact native
finisher.

The SDUST DP is sequential with data-dependent evictions (SURVEY.md §7 hard
parts) — hostile to SPMD.  The hybrid splits it:

1. **Device filter** (this module, JAX): per position, sliding 64-symbol
   triplet histograms over the W-window give the window duplicate count
   rw = sum_t C(n_t, 2) and the eviction trigger max_t n_t.  A position is
   a *candidate* iff the exact perfect-interval search could fire there:

     candidate[i] = (rw[i]*10 > count[i]*T)        (the exact rw test when
                                                    no eviction is active)
                    OR trigger within the last window  (evictions need a
                                                    triplet with cv*10>2T,
                                                    and cv <= n_t)
                    OR an N/invalid base nearby       (sequence-split paths)

   This is a proven superset of the positions where the reference DP calls
   find_perfect, so masking can only happen inside candidate regions.

2. **Host finisher**: candidate runs are dilated by 2W and merged; the
   exact native DP (native/sdust) re-runs each region with 2W of left
   context — enough to reconstruct the windowed state — producing
   bit-identical intervals at a fraction of full-sequence cost whenever
   low-complexity sequence is sparse (the common case).

Validated against the full-sequence oracle on randomized sequences with
embedded repeats and Ns (tests/test_sdust_device.py).
"""

from typing import List, Tuple

import numpy as np

SD_WLEN = 3


def sdust_candidates_jax(codes, T: int = 20, W: int = 64):
    """codes: (L,) uint8 (0-3, 4=N).  Returns (L,) bool candidate mask
    (indexed by word-end base position)."""
    import jax.numpy as jnp
    L = codes.shape[0]
    nw = W - SD_WLEN + 1  # window capacity in words
    c = jnp.minimum(codes, 3).astype(jnp.int32)
    bad = codes >= 4
    if L < SD_WLEN:
        return jnp.zeros((L,), dtype=bool)
    m = L - SD_WLEN + 1
    word = (c[0:m] << 4) | (c[1:m + 1] << 2) | c[2:m + 2]
    word_bad = bad[0:m] | bad[1:m + 1] | bad[2:m + 2]
    onehot = (word[:, None] == jnp.arange(64, dtype=jnp.int32)[None, :])
    onehot = jnp.where(word_bad[:, None], False, onehot).astype(jnp.int32)
    # sliding histogram over the trailing `nw` words (inclusive) via
    # doubling shifted adds along axis 0 (64-lane friendly)
    n_t = _trailing_sum(onehot, nw)
    count = jnp.sum(n_t, axis=1)
    rw = jnp.sum((n_t * (n_t - 1)) // 2, axis=1)
    trig = (jnp.max(n_t, axis=1) * 10 > 2 * T) | word_bad
    trig_near = _trailing_sum(trig.astype(jnp.int32)[:, None], nw)[:, 0] > 0
    cand_word = (rw * 10 > count * T) | trig_near
    # map word-end word index -> base position of the word end
    cand = jnp.zeros((L,), dtype=bool)
    cand = cand.at[SD_WLEN - 1:].set(cand_word)
    return cand


def _trailing_sum(x, w: int):
    """y[i] = sum(x[max(i-w+1,0) : i+1]) along axis 0, doubling form."""
    import jax.numpy as jnp
    total = None
    offset = 0
    cur = x
    width = 1
    rem = w
    while rem:
        if rem & 1:
            part = _shift_down(cur, offset)
            total = part if total is None else total + part
            offset += width
        rem >>= 1
        if rem:
            cur = cur + _shift_down(cur, width)
            width <<= 1
    return total


def _shift_down(a, s: int):
    """out[i] = a[i - s], zero above."""
    import jax.numpy as jnp
    if s == 0:
        return a
    pad = jnp.zeros((s,) + a.shape[1:], dtype=a.dtype)
    return jnp.concatenate([pad, a[:-s]], axis=0)


def candidate_regions(cand: np.ndarray, W: int,
                      length: int) -> List[Tuple[int, int]]:
    """Dilate the candidate mask by 2W and merge into regions.

    Vectorized: idx is ascending so lo/hi are non-decreasing and the merge
    reduces to splitting where lo[i] > hi[i-1] (on dense input idx has one
    entry per base — a Python loop here cost seconds per Mb)."""
    idx = np.flatnonzero(cand)
    if len(idx) == 0:
        return []
    lo = np.maximum(idx - 2 * W, 0)
    hi = np.minimum(idx + 2 * W, length)
    starts = np.concatenate([[0], np.flatnonzero(lo[1:] > hi[:-1]) + 1])
    ends = np.concatenate([starts[1:] - 1, [len(idx) - 1]])
    return [(int(lo[s]), int(hi[e])) for s, e in zip(starts, ends)]


def sdust_hybrid(seq: bytes, T: int = 20, W: int = 64,
                 _filter_backend="jax", dense_cutoff: float = 0.5,
                 workers: int = None) -> List[Tuple[int, int]]:
    """Device-filtered, host-exact SDUST; bit-identical to the full DP.

    Two regime guards keep the hybrid from LOSING to the plain DP:

    - **dense fallback**: when candidate regions cover more than
      ``dense_cutoff`` of the sequence (satellite/low-complexity-dominated
      input — exactly where DUST fires) the filter cannot save work; if the
      dense mask is also unfragmented (few mergeable regions, so no
      parallelism to win either) the full-sequence exact DP runs directly;
      output is the oracle's by construction.  Fragmented-dense input still
      goes through the region path so the thread pool can split the work.
    - **parallel finisher**: independent candidate regions are re-run on a
      thread pool — the native DP is a ctypes call, which releases the GIL,
      so region finishing scales with cores (the reference is
      single-threaded here; its pthread pool never reached sdust,
      /root/reference/src/thread.c:48-156).
    """
    from cornetto_tpu.kernels.minimizer import encode_seq
    from cornetto_tpu.native.sdust import sdust as sdust_exact
    codes = encode_seq(seq.decode("latin-1"))
    if _filter_backend == "jax":
        cand = _filter_jax_bucketed(codes, T, W)
    else:
        cand = _candidates_np(codes, T=T, W=W)
    regions = candidate_regions(cand, W, len(codes))
    span = sum(b - a for a, b in regions)
    if span > dense_cutoff * max(len(codes), 1) and len(regions) < 4:
        return sdust_exact(seq, T=T, W=W)

    def _finish(reg):
        a, b = reg
        ctx = max(a - 2 * W, 0)
        return [(s + ctx, e + ctx)
                for s, e in sdust_exact(seq[ctx:b], T=T, W=W)]

    if len(regions) > 3:
        import os
        from concurrent.futures import ThreadPoolExecutor
        nw = min(len(regions), workers or os.cpu_count() or 1)
        with ThreadPoolExecutor(max_workers=nw) as ex:
            parts = list(ex.map(_finish, regions))
    else:
        parts = [_finish(r) for r in regions]
    # regions are > 2W apart so intervals cannot overlap across regions;
    # map preserves region order, so parts concatenate in ascending order
    out: List[Tuple[int, int]] = []
    for p in parts:
        out.extend(p)
    return out


_FILTER_JIT = {}


def _filter_jax_bucketed(codes: np.ndarray, T: int, W: int) -> np.ndarray:
    """Jitted candidate filter with quarter-power-of-2 length buckets.

    Eager (unjitted) dispatch of the doubling-sum graph costs more than the
    exact DP it is meant to replace; bucketing bounds recompiles across
    ragged contig lengths.  Padding uses code 4 (N): trailing sums only
    look backward, so the first len(codes) mask entries are unaffected by
    the pad (verified against the np twin in tests)."""
    import jax
    import jax.numpy as jnp
    L = len(codes)
    Lp = 256
    while Lp < L:
        Lp = Lp * 5 // 4
    key = (Lp, T, W)
    f = _FILTER_JIT.get(key)
    if f is None:
        f = jax.jit(lambda a: sdust_candidates_jax(a, T=T, W=W))
        _FILTER_JIT[key] = f
    padded = np.full(Lp, 4, np.uint8)
    padded[:L] = codes
    return np.asarray(f(jnp.asarray(padded)))[:L]


def _candidates_np(codes: np.ndarray, T: int, W: int) -> np.ndarray:
    """NumPy twin of the device filter (oracle/fallback)."""
    nw = W - SD_WLEN + 1
    L = len(codes)
    if L < SD_WLEN:
        return np.zeros(L, dtype=bool)
    c = np.minimum(codes, 3).astype(np.int64)
    bad = codes >= 4
    m = L - SD_WLEN + 1
    word = (c[0:m] << 4) | (c[1:m + 1] << 2) | c[2:m + 2]
    word_bad = bad[0:m] | bad[1:m + 1] | bad[2:m + 2]
    onehot = np.zeros((m, 64), dtype=np.int32)
    ok = ~word_bad
    onehot[np.arange(m)[ok], word[ok]] = 1
    cs = np.cumsum(onehot, axis=0)
    n_t = cs - np.concatenate([np.zeros((min(nw, m), 64), np.int32),
                               cs[:-nw]])[:m]
    count = n_t.sum(axis=1)
    rw = ((n_t * (n_t - 1)) // 2).sum(axis=1)
    trig = (n_t.max(axis=1) * 10 > 2 * T) | word_bad
    trig_cs = np.cumsum(trig.astype(np.int64))
    trig_near = trig_cs - np.concatenate(
        [np.zeros(min(nw, m), np.int64), trig_cs[:-nw]])[:m] > 0
    cand_word = (rw * 10 > count * T) | trig_near
    cand = np.zeros(L, dtype=bool)
    cand[SD_WLEN - 1:] = cand_word
    return cand
