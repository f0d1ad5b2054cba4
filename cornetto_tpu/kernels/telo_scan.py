"""Device telomere-motif scan kernels.

Batched shifted-compare over 2-bit codes: match[i] = AND_j (codes[i+j] ==
motif[j]) — k compares + k-1 ANDs per base, fused by XLA into a single
elementwise kernel.  Used by the livefish path to tag telomeric reads on
device, and by `telofind --backend device` (telo_match_mask_long +
scan_runs_from_mask), whose rows are byte-identical to the host scan.
"""

import numpy as np


def telo_match_mask_jax(codes, motif_codes):
    """codes (B, L) uint8, motif_codes tuple of ints (0-3).
    Returns (B, L-k+1) bool match mask."""
    import jax.numpy as jnp
    k = len(motif_codes)
    B, L = codes.shape
    m = L - k + 1
    ok = codes[:, 0:m] == motif_codes[0]
    for j in range(1, k):
        ok = ok & (codes[:, j:m + j] == motif_codes[j])
    return ok


def telo_run_stats_jax(codes, motif_codes, min_run_bases: int = 24):
    """Per-read telomere content: (n_matches (B,), longest tandem run in
    motif copies (B,), any_terminal (B,) bool — a run touching either end).

    Tandem-run length via log-doubling AND-chains over the match mask at
    stride k (a run of c consecutive matches spaced k apart = c motif
    copies), entirely static-shape.
    """
    import jax.numpy as jnp
    k = len(motif_codes)
    ok = telo_match_mask_jax(codes, motif_codes)
    B, m = ok.shape
    n = jnp.sum(ok, axis=1, dtype=jnp.int32)
    # runlen[i] = number of consecutive matches at stride k starting at i
    max_copies = max(m // k, 1)
    steps = max(int(np.ceil(np.log2(max_copies))), 0)
    run = ok.astype(jnp.int32)
    width = 1
    for _ in range(steps):
        shifted = jnp.pad(run[:, width * k:], ((0, 0), (0, width * k)))
        run = jnp.where(run == width, run + shifted, run)
        width *= 2
    longest = jnp.max(run, axis=1)
    thresh = -(-min_run_bases // k)
    terminal = (run[:, 0] >= thresh)
    return n, longest, terminal


_MASK_FNS = {}


def telo_match_mask_long(seq_codes: np.ndarray, motif_codes) -> np.ndarray:
    """Match mask for ONE long sequence (a contig), (len(seq),) bool.  The
    codes are padded with 4 (never matches) to a power-of-two length of at
    least 2^16, so a genome's contigs share a few compiled shapes."""
    import jax
    import jax.numpy as jnp
    motif_codes = tuple(int(c) for c in motif_codes)
    k = len(motif_codes)
    L = len(seq_codes)
    if L < k:
        return np.zeros(L, dtype=bool)
    n = max(1 << (L + k - 2).bit_length(), 1 << 16)
    padded = np.full(n, 4, dtype=np.uint8)
    padded[:L] = seq_codes
    fn = _MASK_FNS.get(motif_codes)
    if fn is None:
        fn = _MASK_FNS[motif_codes] = jax.jit(
            lambda c: telo_match_mask_jax(c[None, :], motif_codes)[0])
    return np.asarray(fn(jnp.asarray(padded)))[:L]


def scan_runs_from_mask(mask: np.ndarray, k: int):
    """Reconstruct tools/telofind.scan_runs' greedy walk from a match mask:
    next occurrence >= cursor, extend in k-steps while matching, resume at
    end+1 (reference: src/find_telomere.c:44-74).  O(#matches), exact."""
    idx = np.flatnonzero(mask)
    pos = 0
    out = []
    for q in idx:
        if q < pos:
            continue
        p = int(q)
        while p < len(mask) and mask[p]:
            p += k
        out.append((int(q), p, p - int(q)))
        pos = p + 1
    return out
