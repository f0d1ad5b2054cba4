"""Minimizer extraction kernels (device + host twins).

The livefish decision loop replaces the reference protocol's dependency on
readfish+minimap2 for real-time accept/reject decisions
(reference: docs/protocol.md:137-161 hands this to readfish).  Reads are
2-bit packed, k-mers built with shifted ORs, canonicalised, hashed with an
invertible finalizer, and windowed minima taken at stride w — all static
shapes, all elementwise ops, so XLA fuses the entire extraction into a
handful of kernels.

Design notes:
- dense stride-w sampling (one minimizer per w-window) instead of the
  classic (w,k) scheme keeps every shape static under jit;
- the k-mer build is O(k) shifted ors on uint32 lanes; sliding minima use
  log2(w) doubling steps — no data-dependent control flow anywhere.
"""

import numpy as np

DEFAULT_K = 15
DEFAULT_W = 10

_CODE = np.full(256, 4, dtype=np.uint8)
for _i, _c in enumerate("ACGT"):
    _CODE[ord(_c)] = _i
    _CODE[ord(_c.lower())] = _i


def encode_seq(seq: str) -> np.ndarray:
    """ASCII -> 2-bit codes (4 = N/other)."""
    return _CODE[np.frombuffer(seq.encode("latin-1"), dtype=np.uint8)]


def _hash32_np(x: np.ndarray) -> np.ndarray:
    """Invertible 32-bit mix (minimap2-style finalizer), numpy."""
    x = x.astype(np.uint64)
    mask = np.uint64(0xFFFFFFFF)
    x = (~x + (x << np.uint64(21))) & mask
    x = x ^ (x >> np.uint64(24))
    x = (x + (x << np.uint64(3)) + (x << np.uint64(8))) & mask
    x = x ^ (x >> np.uint64(14))
    x = (x + (x << np.uint64(2)) + (x << np.uint64(4))) & mask
    x = x ^ (x >> np.uint64(28))
    x = (x + (x << np.uint64(31))) & mask
    return x.astype(np.uint32)


def minimizers_np(codes: np.ndarray, k: int = DEFAULT_K, w: int = DEFAULT_W):
    """Host twin of the device kernel: returns (positions, hashes) of the
    stride-w windowed minima over canonical k-mer hashes."""
    n = len(codes)
    if n < k:
        return (np.empty(0, dtype=np.int32), np.empty(0, dtype=np.uint32))
    m = n - k + 1
    valid = np.ones(m, dtype=bool)
    fwd = np.zeros(m, dtype=np.uint64)
    rev = np.zeros(m, dtype=np.uint64)
    for j in range(k):
        c = codes[j:m + j]
        valid &= c < 4
        fwd = (fwd << np.uint64(2)) | c.astype(np.uint64)
        rev = rev | ((np.uint64(3) - np.minimum(c, 3).astype(np.uint64))
                     << np.uint64(2 * j))
    mask = np.uint64((1 << (2 * k)) - 1)
    fwd &= mask
    canon = np.minimum(fwd, rev)
    h = _hash32_np(canon.astype(np.uint64))
    h = np.where(valid, h, np.uint32(0xFFFFFFFF))
    nwin = m // w
    if nwin == 0:
        return (np.empty(0, dtype=np.int32), np.empty(0, dtype=np.uint32))
    hw = h[:nwin * w].reshape(nwin, w)
    arg = hw.argmin(axis=1)
    pos = (np.arange(nwin) * w + arg).astype(np.int32)
    hmin = hw[np.arange(nwin), arg]
    keep = hmin != np.uint32(0xFFFFFFFF)
    return pos[keep], hmin[keep]


def minimizers_native(codes: np.ndarray, k: int = DEFAULT_K,
                      w: int = DEFAULT_W):
    """Threaded C twin of minimizers_np (native/minimizer_native.c):
    bit-identical output, ~200x the NumPy rate (the k-pass uint64 NumPy
    build was 380 s for a 500 Mbp genome — the index-build bottleneck).
    Falls back to minimizers_np when no compiler is available."""
    import ctypes
    from cornetto_tpu import native
    lib = native.load("minimizer_native", "minimizer_native.c")
    if lib is None:
        return minimizers_np(codes, k, w)
    n = len(codes)
    m = n - k + 1
    nwin = m // w if m > 0 else 0
    if nwin <= 0:
        return (np.empty(0, dtype=np.int32), np.empty(0, dtype=np.uint32))
    codes = np.ascontiguousarray(codes, dtype=np.uint8)
    hashes = np.empty(nwin, dtype=np.uint32)
    pos = np.empty(nwin, dtype=np.int32)
    import os
    lib.mz_extract(
        ctypes.c_void_p(codes.ctypes.data), ctypes.c_int64(n),
        ctypes.c_int(k), ctypes.c_int(w),
        ctypes.c_int(min(os.cpu_count() or 1, 16)),
        ctypes.c_void_p(hashes.ctypes.data), ctypes.c_void_p(pos.ctypes.data))
    keep = hashes != np.uint32(0xFFFFFFFF)
    return pos[keep], hashes[keep]


# ---------------------------------------------------------------------------
# JAX device kernel
# ---------------------------------------------------------------------------

def hash32_jax(x):
    import jax.numpy as jnp
    x = x.astype(jnp.uint32)
    x = (~x) + (x << 21)
    x = x ^ (x >> 24)
    x = x + (x << 3) + (x << 8)
    x = x ^ (x >> 14)
    x = x + (x << 2) + (x << 4)
    x = x ^ (x >> 28)
    x = x + (x << 31)
    return x


def read_minimizers_jax(codes, k: int = DEFAULT_K, w: int = DEFAULT_W,
                        want_pos: bool = True):
    """Batched device kernel: codes (B, L) uint8 -> (positions (B, M) int32,
    hashes (B, M) uint32, valid (B, M) bool), M = (L-k+1)//w, static.

    The k-mer build uses log2(k) doubling steps (width-1 words combined
    into width-2, width-4, ... words) instead of k shifted ORs, ~4x fewer
    elementwise passes for k=15.

    NOTE: the 32-bit hash finalizes the low 32 bits of the canonical k-mer
    (k<=16); the host index build (livefish.index.build_index) hashes with
    the same function, so device and host agree bit-for-bit.
    """
    import jax.numpy as jnp
    B, L = codes.shape
    m = L - k + 1

    c = jnp.minimum(codes, 3).astype(jnp.uint32)
    v = codes < 4
    r = jnp.uint32(3) - c

    # doubling pyramids: fwd_w[i] = packed word of width `width` starting
    # at i (big-endian base order); rev_w[i] = complement packed
    # little-endian (so the full-k combine yields the reverse complement).
    widths = [1]
    fwds = {1: c}
    revs = {1: r}
    vals = {1: v}
    width = 1
    while width * 2 <= k:
        f, rv, vv = fwds[width], revs[width], vals[width]
        n = f.shape[1] - width
        fwds[width * 2] = (f[:, :n] << (2 * width)) | f[:, width:]
        revs[width * 2] = rv[:, :n] | (rv[:, width:] << (2 * width))
        vals[width * 2] = vv[:, :n] & vv[:, width:]
        width *= 2
        widths.append(width)

    # combine binary decomposition of k
    fwd = None
    rev = None
    valid = None
    off = 0
    for width in reversed(widths):
        if k & width:
            f = fwds[width][:, off:off + m]
            rv = revs[width][:, off:off + m]
            vv = vals[width][:, off:off + m]
            if fwd is None:
                fwd, rev, valid = f, rv, vv
                covered = width
            else:
                fwd = (fwd << (2 * width)) | f
                rev = rev | (rv << (2 * covered))
                valid = valid & vv
                covered += width
            off += width
    canon = jnp.minimum(fwd, rev)
    h = hash32_jax(canon)
    h = jnp.where(valid, h, jnp.uint32(0xFFFFFFFF))
    nwin = m // w
    hw = h[:, :nwin * w].reshape(B, nwin, w)
    if want_pos:
        arg = jnp.argmin(hw, axis=2).astype(jnp.int32)
        win_base = (jnp.arange(nwin, dtype=jnp.int32) * w)[None, :]
        pos = win_base + arg
        hmin = jnp.take_along_axis(hw, arg[:, :, None], axis=2)[:, :, 0]
    else:
        # the decision path only needs the hash minima; skipping the
        # argmin + gather shaves the extraction kernel
        pos = None
        hmin = jnp.min(hw, axis=2)
    vmin = hmin != jnp.uint32(0xFFFFFFFF)
    return pos, hmin, vmin


def pack_reads(codes: np.ndarray):
    """Host-side 2-bit packing for cheap host->device transfer:
    (B, L) uint8 codes (0..4) -> (packed (B, ceil(L/4)) uint8,
    nmask (B, ceil(L/8)) uint8 bitmap of N positions)."""
    B, L = codes.shape
    L4 = -(-L // 4) * 4
    L8 = -(-L // 8) * 8
    c4 = np.full((B, L4), 0, dtype=np.uint8)
    c4[:, :L] = codes & 3
    packed = (c4[:, 0::4] | (c4[:, 1::4] << 2) | (c4[:, 2::4] << 4)
              | (c4[:, 3::4] << 6))
    n8 = np.zeros((B, L8), dtype=np.uint8)
    n8[:, :L] = codes >= 4
    bits = np.packbits(n8, axis=1, bitorder="little")
    return packed, bits


def unpack_reads_jax(packed, nmask, L: int):
    """Device-side unpack: inverse of pack_reads -> (B, L) uint8 codes."""
    import jax.numpy as jnp
    B = packed.shape[0]
    shifts = jnp.arange(4, dtype=jnp.uint8) * 2
    c = ((packed[:, :, None] >> shifts[None, None, :]) & 3)
    c = c.reshape(B, -1)[:, :L]
    bit = jnp.arange(8, dtype=jnp.uint8)
    nm = ((nmask[:, :, None] >> bit[None, None, :]) & 1)
    nm = nm.reshape(B, -1)[:, :L]
    return jnp.where(nm == 1, jnp.uint8(4), c.astype(jnp.uint8))
