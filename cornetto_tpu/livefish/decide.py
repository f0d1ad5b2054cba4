"""Real-time adaptive-sampling decision engine.

The new capability on top of the reference toolkit (SURVEY.md §0: the
reference delegates live decisions to readfish — docs/protocol.md:137-161).
Design (SPMD over a ("dp", "ep") mesh):

- read chunks are data-parallel over ``dp``;
- the minimizer index is hash-range sharded over ``ep`` (livefish.index);
- each device extracts minimizers from its read shard (elementwise XLA
  fusions), looks them up in its local index shard (bucket-row gathers),
  and contributes per-(read, contig) hit votes;
- per-contig stats are merged with ``psum_scatter`` over ``ep``, and
  decisions (accept / reject-from-boring-region) are emitted per read.

Everything is static-shape; one jit compile per (batch, read-len) bucket.
"""

import functools
from dataclasses import dataclass

import numpy as np

from cornetto_tpu.kernels.minimizer import (read_minimizers_jax,
                                            unpack_reads_jax)
from cornetto_tpu.livefish.index import MinimizerIndex


@dataclass
class DecisionParams:
    min_hits: int = 3
    bin_size: int = 1000


def _lookup_votes(btable, bucket_shift, q_hash, q_valid, n_contigs,
                  two_choice: bool = True):
    """Local-shard lookup against the fingerprinted bucket table: one
    32-byte row-gather per query (two independent ones under two_choice —
    the index's high-occupancy placement, livefish.index) — instead of a
    binary search's ~20 dependent gather rounds.  `two_choice` must match
    how the index was BUILT (MinimizerIndex.two_choice); the engines
    thread it through.

    btable: (2^B, 2K) int32 rows of [fp pairs | contig pairs | K
    positions], K slots per bucket derived from the row width (layout in
    livefish.index.MinimizerIndex; the uint16 fingerprint comparison is
    exact because shard+bucket bits pin the rest of the key — callers on
    a sharded mesh must therefore mask q_valid down to the queries this
    shard OWNS, see _decide_from_minima).

    A unique index hash occupies one slot; a multi-occurrence (ambiguous,
    MAPQ<20-analog) hash occupies up to TWO slots holding its first two
    genome occurrences, both with the position sign bit set
    (livefish.index).  Each query hash counts ONCE toward its contig's
    vote; ambiguous hits are tallied separately so the decision layer can
    exclude them from high-confidence coverage and split repeat reads
    across both copies.

    Returns per-contig (b, C) int32 stats, 9 planes:
      votes     — all hits (mapping evidence),
      votes_un  — unambiguous hits, (nu_hi, nu_lo) their position sums,
      votes_amb — ambiguous hits,   (a1_hi, a1_lo) / (a2_hi, a2_lo) the
                  position sums of their first / second occurrences.
    Position sums are SPLIT into high/low 16-bit halves (sum of pos>>16
    and of pos&0xFFFF): each half stays < 2^31 for any int32 positions
    and <= 2^15 hits, so position means are EXACT for chromosome-scale
    contigs (a single int32 sum wrapped beyond ~47 Mb contigs at the
    45-minimizer chunk norm — human chr1 is 248 Mb).  _mean_split
    reconstructs floor((hi*2^16 + lo)/n) without overflow.
    """
    import jax.numpy as jnp
    b, M = q_hash.shape
    n_buckets = btable.shape[0]
    K = btable.shape[1] // 2                  # slots per bucket
    log2b = int(n_buckets).bit_length() - 1
    q = q_hash.ravel()
    bucket = ((q >> jnp.uint32(bucket_shift))
              & jnp.uint32(n_buckets - 1)).astype(jnp.int32)
    # fingerprint = the top bits above shard+bucket (always <= 16 of them;
    # <= 15 under two_choice, where bit 15 of the stored half is the
    # placement tag)
    qfp = (q >> jnp.uint32(bucket_shift + log2b)).astype(jnp.int32)
    if two_choice:
        # the alternate bucket + its tagged fingerprint: the two gathers
        # are address-independent, so they can be in flight together
        g = ((qfp.astype(jnp.uint32) * jnp.uint32(0x9E3779B1))
             >> jnp.uint32(32 - log2b)).astype(jnp.int32) \
            & (n_buckets - 1)
        probes = ((bucket, qfp), (bucket ^ g, qfp | (1 << 15)))
    else:
        probes = ((bucket, qfp),)
    qv = q_valid.ravel()
    found = jnp.zeros_like(qv)
    contig = jnp.zeros_like(qfp)
    pos1 = jnp.zeros_like(qfp)
    pos2 = jnp.zeros_like(qfp)
    has2 = jnp.zeros_like(qv)
    for bk, want in probes:
        row = jnp.take(btable, bk, axis=0)                    # (Q, 2K)
        for s in range(K):
            word = row[:, s // 2]
            ctw = row[:, K // 2 + s // 2]
            fp = (word >> (16 * (s % 2))) & 0xFFFF
            ct = (ctw >> (16 * (s % 2))) & 0xFFFF
            m = (fp == want) & (ct != 0xFFFF)
            is2 = m & found & ~has2   # second slot of an ambiguous hash
            is1 = m & ~found
            contig = jnp.where(is1, ct, contig)
            pos1 = jnp.where(is1, row[:, K + s], pos1)
            pos2 = jnp.where(is2, row[:, K + s], pos2)
            has2 = has2 | is2
            found = found | m
    found = found & qv
    ambig = found & (pos1 < 0)
    p1 = jnp.where(found, pos1 & 0x7FFFFFFF, 0)
    # 2nd occurrence may have been bucket-overflow-dropped: fall back to p1
    p2 = jnp.where(found & has2, pos2 & 0x7FFFFFFF, p1)
    contig = jnp.where(found, contig, 0)

    def _reduce(found, ambig, contig, p1, p2):
        fr = found.reshape(b, M)
        ar = ambig.reshape(b, M)
        cr = contig.reshape(b, M)
        p1r = p1.reshape(b, M)
        p2r = p2.reshape(b, M)
        p1h, p1l = p1r >> 16, p1r & 0xFFFF
        p2h, p2l = p2r >> 16, p2r & 0xFFFF
        if n_contigs <= 8:
            # dense one-hot reduction: the (b, M, C) intermediates fuse
            # into the reductions.  On an H100 it beat scatter-add at 8
            # contigs and lost from 32 up (16,384 x 43 queries).  The
            # scatter-add below uses atomics there; integer sums stay exact.
            oh = (cr[:, :, None]
                  == jnp.arange(n_contigs, dtype=jnp.int32)[None, None, :]) \
                & fr[:, :, None]
            un = oh & ~ar[:, :, None]
            am = oh & ar[:, :, None]

            def acc(m, v):
                return jnp.sum(m * v[:, :, None], axis=1, dtype=jnp.int32)
            return (jnp.sum(oh, axis=1, dtype=jnp.int32),
                    jnp.sum(un, axis=1, dtype=jnp.int32),
                    acc(un, p1h), acc(un, p1l),
                    jnp.sum(am, axis=1, dtype=jnp.int32),
                    acc(am, p1h), acc(am, p1l),
                    acc(am, p2h), acc(am, p2l))
        rows = jnp.broadcast_to(jnp.arange(b, dtype=jnp.int32)[:, None],
                                (b, M)).ravel()
        cols = cr.ravel()
        un = (fr & ~ar).ravel()
        am = (fr & ar).ravel()
        z = jnp.zeros((b, n_contigs), dtype=jnp.int32)
        at = z.at[rows, cols]
        return (at.add(fr.ravel().astype(jnp.int32)),
                at.add(un.astype(jnp.int32)),
                at.add((un * p1h.ravel()).astype(jnp.int32)),
                at.add((un * p1l.ravel()).astype(jnp.int32)),
                at.add(am.astype(jnp.int32)),
                at.add((am * p1h.ravel()).astype(jnp.int32)),
                at.add((am * p1l.ravel()).astype(jnp.int32)),
                at.add((am * p2h.ravel()).astype(jnp.int32)),
                at.add((am * p2l.ravel()).astype(jnp.int32)))

    return _reduce(found, ambig, contig, p1, p2)


def _mean_split(hi, lo, n):
    """floor((hi*2^16 + lo) / n) in overflow-free int32: with hi = q*n+r,
    it equals q*2^16 + (r*2^16 + lo)//n, and r*2^16 + lo < n*2^16 + n*2^16
    stays well under 2^31 for n <= 2^14 hits."""
    import jax.numpy as jnp
    n = jnp.maximum(n, 1)
    q = hi // n
    r = hi - q * n
    return (q << 16) + ((r << 16) + lo) // n


def decision_core(btable, reads, panel_mask,
                  k: int, w: int, min_hits: int, bin_size: int,
                  bucket_shift: int, ep_axis: str = None, ep_size: int = 1,
                  two_choice: bool = True):
    """Single-device (or per-shard, when ep_axis is set) decision step.

    btable: (2^B, 2K) int32 fingerprinted lookup rows (livefish.index).
    reads: (b, L) uint8 codes — with ep_axis set this is the device's OWN
    (dp, ep) slice; extraction runs once per read, not once per ep shard.
    Returns (decision (b,) int8 — 1 accept / 0 reject, best_contig (b,)
    int32, est_pos (b,) int32, nhits (b,) int32, nhits_hq (b,) int32 —
    unambiguous hits, the MAPQ>=20 analog — and est_pos2 (b,) int32, the
    second repeat-copy estimate, == est_pos for uniquely anchored reads).
    """
    pos, h, valid = read_minimizers_jax(reads, k=k, w=w, want_pos=False)
    return _decide_from_minima(btable, h, valid, panel_mask,
                               min_hits, bin_size, bucket_shift, ep_axis,
                               ep_size, two_choice)


def decision_core_packed(btable, packed, nmask, panel_mask,
                         L: int, k: int, w: int, min_hits: int,
                         bin_size: int, bucket_shift: int,
                         ep_axis: str = None, ep_size: int = 1,
                         lengths=None, two_choice: bool = True):
    """Decision step on 2-bit packed reads (~2.6x less host->device
    traffic; nmask=None for N-free batches — the ONT norm — drops the
    bitmap transfer too, optionally replaced by 4-byte per-read lengths).
    Unpack, k-mer build, hash and window minimum are plain XLA: on an H100
    a hand-written Triton kernel for them sped up the device step but not
    `livefish run`, which is host-bound."""
    import jax.numpy as jnp
    if nmask is None:
        B = packed.shape[0]
        nmask = jnp.zeros((B, -(-L // 8)), dtype=jnp.uint8)
        if lengths is not None:
            # mark bases at/after each read's length as N
            pos = jnp.arange(-(-L // 8) * 8, dtype=jnp.int32)
            bits = (pos[None, :] >= lengths.astype(jnp.int32)[:, None])
            nmask = jnp.sum(
                bits.reshape(B, -1, 8).astype(jnp.uint8)
                << jnp.arange(8, dtype=jnp.uint8)[None, None, :],
                axis=2, dtype=jnp.uint8)
    reads = unpack_reads_jax(packed, nmask, L)
    _, h, valid = read_minimizers_jax(reads, k=k, w=w, want_pos=False)
    return _decide_from_minima(btable, h, valid, panel_mask,
                               min_hits, bin_size, bucket_shift, ep_axis,
                               ep_size, two_choice)


def _decide_from_minima(btable, h, valid, panel_mask, min_hits: int,
                        bin_size: int, bucket_shift: int,
                        ep_axis: str = None, ep_size: int = 1,
                        two_choice: bool = True):
    """Votes + decision from extracted minimizer hashes.

    With ep_axis set, this is the extract-once sharded protocol (SURVEY.md
    §7 item 7): the caller extracts minimizers from ITS OWN (dp, ep) read
    slice only (no replicated extraction); hashes are all_gather'd within
    the ep group, each shard masks the gathered queries down to the hash
    range it owns (low log2(ep) bits — which also makes the fingerprint
    comparison exact across shards), looks them up locally, and the
    per-contig stats return to each read's owner via ONE psum_scatter
    (half the wire bytes of the old full-psum of votes).
    """
    import jax
    import jax.numpy as jnp
    n_contigs = panel_mask.shape[0]
    if ep_axis is not None:
        h = jax.lax.all_gather(h, ep_axis, axis=0, tiled=True)
        valid = jax.lax.all_gather(valid, ep_axis, axis=0, tiled=True)
        my = jax.lax.axis_index(ep_axis).astype(jnp.uint32)
        own = (h & jnp.uint32(ep_size - 1)) == my
        valid = valid & own
    stats9 = _lookup_votes(btable, bucket_shift, h, valid, n_contigs,
                           two_choice)
    if ep_axis is not None:
        stats = jnp.concatenate(stats9, axis=1)
        stats = jax.lax.psum_scatter(stats, ep_axis, scatter_dimension=0,
                                     tiled=True)
        stats9 = [stats[:, i * n_contigs:(i + 1) * n_contigs]
                  for i in range(9)]
    return decision_from_stats(stats9, panel_mask, min_hits, bin_size)


def decision_from_stats(stats9, panel_mask, min_hits: int, bin_size: int):
    """The decision tail: per-contig stats (the 9 planes of _lookup_votes,
    summed over index shards) -> (decision, best, est, nhits, nhits_hq,
    est2)."""
    import jax.numpy as jnp
    (votes, votes_un, nu_hi, nu_lo, votes_amb,
     a1_hi, a1_lo, a2_hi, a2_lo) = stats9
    best = jnp.argmax(votes, axis=1).astype(jnp.int32)

    def _pick(a):
        return jnp.take_along_axis(a, best[:, None], axis=1)[:, 0]
    nhits = _pick(votes)
    nhits_hq = _pick(votes_un)          # MAPQ>=20 analog: unambiguous hits
    va = _pick(votes_amb)
    # position estimate prefers unambiguous hits; a read whose hits are
    # ALL ambiguous (wholly inside an exact repeat) gets both copies'
    # estimates so coverage mass can split across them (est == est2
    # whenever the read has any unique anchor)
    have_un = nhits_hq > 0
    est_amb1 = _mean_split(_pick(a1_hi), _pick(a1_lo), va)
    est = jnp.where(have_un,
                    _mean_split(_pick(nu_hi), _pick(nu_lo), nhits_hq),
                    est_amb1)
    est2 = jnp.where(have_un, est,
                     _mean_split(_pick(a2_hi), _pick(a2_lo), va))
    mapped = nhits >= min_hits
    est_bin = jnp.clip(est // bin_size, 0, panel_mask.shape[1] - 1)
    in_panel = panel_mask[best, est_bin]
    # adaptive-sampling policy: reject (unblock) reads mapping into the
    # boring (already-resolved) panel; keep sequencing everything else
    reject = mapped & in_panel
    decision = (~reject).astype(jnp.int8)
    return decision, best, est, nhits, nhits_hq, est2


def decision_core_packed_fused(btable, packed, nmask, panel_mask,
                               lengths=None, **kw):
    """decision_core_packed with the decision outputs packed into ONE (2, B)
    int32 array: a single host readback instead of four, at 8 B/read
    instead of 16.

    row 0 = decision<<30 | min(nhits, 0x3FFF)<<16 | best_contig
    row 1 = est position (int32)

    best_contig needs < 2^16 contigs (checked at index build; hifiasm
    emits thousands) and nhits saturates at 16383 (a read has at most
    ~L/w minimizers, ~45 at the 450-bp chunk length).  Decode with
    unpack_fused."""
    import jax.numpy as jnp
    # nhits_hq / est2 are NOT carried on the fused wire: the fused path
    # feeds the streaming TSV + chunk engines; the coverage tally
    # (livefish.coverage) uses the unfused 6-tuple path
    d, b, e, nh, _, _ = decision_core_packed(btable, packed, nmask,
                                             panel_mask, lengths=lengths,
                                             **kw)
    w0 = ((d.astype(jnp.int32) << 30)
          | (jnp.minimum(nh, 0x3FFF) << 16)
          | (b & 0xFFFF))
    return jnp.stack([w0, e])


def unpack_fused(arr):
    """Decode a host-side (2, B) fused result array back into
    (decision, best_contig, est_pos, nhits) int32 vectors."""
    import numpy as np
    w0 = np.asarray(arr[0])
    est = np.asarray(arr[1])
    d = (w0 >> 30) & 1
    nhits = (w0 >> 16) & 0x3FFF
    best = w0 & 0xFFFF
    return d, best, est, nhits


class SingleChipEngine:
    """jitted single-device decision engine over a host-resident index."""

    def __init__(self, index: MinimizerIndex, panel_mask: np.ndarray,
                 params: DecisionParams = DecisionParams()):
        import jax
        import jax.numpy as jnp
        assert index.n_shards == 1
        # fused readback packs best_contig into 16 bits (unpack_fused)
        assert panel_mask.shape[0] < (1 << 16), "too many contigs"
        self._btable = jnp.asarray(index.btable[0])
        self._panel = jnp.asarray(panel_mask)
        self._fn = jax.jit(functools.partial(
            decision_core, k=index.k, w=index.w,
            min_hits=params.min_hits, bin_size=params.bin_size,
            bucket_shift=index.bucket_shift,
            two_choice=getattr(index, "two_choice", False)))
        self._index = index
        self._params = params

    def decide(self, reads: np.ndarray):
        import jax.numpy as jnp
        return self._fn(self._btable, jnp.asarray(reads), self._panel)

    def decide_packed(self, packed: np.ndarray, nmask, L: int,
                      lengths=None):
        """2-bit-packed input path: ~2.6x less host->device traffic
        (kernels.minimizer.pack_reads); unpack + extraction run on
        device.  nmask=None for N-free batches (skips the bitmap
        transfer); lengths (B,) int32 for short reads."""
        import jax
        import jax.numpy as jnp
        cache = getattr(self, "_pfns", None)
        if cache is None:
            cache = self._pfns = {}
        if L not in cache:
            idx, params = self._index, self._params
            cache[L] = jax.jit(functools.partial(
                decision_core_packed, L=L, k=idx.k, w=idx.w,
                min_hits=params.min_hits, bin_size=params.bin_size,
                bucket_shift=idx.bucket_shift,
                two_choice=getattr(idx, "two_choice", False)))
        kw = {}
        if lengths is not None:
            kw["lengths"] = jnp.asarray(lengths)
        return cache[L](self._btable, jnp.asarray(packed),
                        None if nmask is None else jnp.asarray(nmask),
                        self._panel, **kw)

    def decide_packed_fused(self, packed: np.ndarray, nmask, L: int,
                            lengths=None):
        """decide_packed with all outputs stacked into one (4, B) int32
        device array — ONE readback per batch (see
        decision_core_packed_fused).  np.asarray the result and unpack
        rows [decision, best, est, nhits]."""
        import jax
        import jax.numpy as jnp
        cache = getattr(self, "_pfns_fused", None)
        if cache is None:
            cache = self._pfns_fused = {}
        if L not in cache:
            idx, params = self._index, self._params
            cache[L] = jax.jit(functools.partial(
                decision_core_packed_fused, L=L, k=idx.k, w=idx.w,
                min_hits=params.min_hits, bin_size=params.bin_size,
                bucket_shift=idx.bucket_shift,
                two_choice=getattr(idx, "two_choice", False)))
        kw = {}
        if lengths is not None:
            kw["lengths"] = jnp.asarray(lengths)
        return cache[L](self._btable, jnp.asarray(packed),
                        None if nmask is None else jnp.asarray(nmask),
                        self._panel, **kw)

    def init_chunk_state(self, n_channels: int, chunk_len: int,
                         max_chunks: int):
        """Allocate the on-device packed chunk buffer for
        livefish.chunks.DeviceChunkEngine: row n_channels is the
        sacrificial scatter row for batch padding."""
        import jax.numpy as jnp
        assert chunk_len % 4 == 0, "chunk_len must pack to whole bytes"
        return jnp.zeros((n_channels + 1, max_chunks, chunk_len // 4),
                         dtype=jnp.uint8)

    def decide_chunk_tick(self, buf, rows, s_chans, s_slots, d_chans,
                          lengths):
        """Scatter this tick's new packed chunk rows into the donated
        device buffer, then decide the accumulated prefixes — one jitted
        call, one (2, B) fused readback (see chunk_tick_core).  Returns
        (new_buf, fused); decode fused with unpack_fused."""
        import jax
        import jax.numpy as jnp
        cache = getattr(self, "_ctick", None)
        if cache is None:
            cache = self._ctick = {}
        key = (buf.shape, rows.shape[0])
        if key not in cache:
            idx, params = self._index, self._params
            L = buf.shape[1] * buf.shape[2] * 4
            cache[key] = jax.jit(functools.partial(
                chunk_tick_core, L=L, k=idx.k, w=idx.w,
                min_hits=params.min_hits, bin_size=params.bin_size,
                bucket_shift=idx.bucket_shift,
                two_choice=getattr(idx, "two_choice", False)),
                donate_argnums=(0,))
        return cache[key](buf, self._btable, jnp.asarray(rows),
                          jnp.asarray(s_chans), jnp.asarray(s_slots),
                          jnp.asarray(d_chans), jnp.asarray(lengths),
                          self._panel)


def chunk_tick_core(buf, btable, rows, s_chans, s_slots, d_chans, lengths,
                    panel_mask, **kw):
    """One read-until tick with the accumulated per-channel chunk state
    living ON DEVICE (livefish.chunks.DeviceChunkEngine).

    buf: (C+1, max_chunks, chunk_len//4) uint8 — 2-bit packed chunk slots
    per channel (row C is a sacrificial scatter target for batch padding).
    rows/s_chans/s_slots: this tick's NEW chunk bytes and where they land
    (s_chans = C for pad rows or channels with nothing new).
    d_chans/lengths: the channels to DECIDE and their accumulated read
    lengths — kept separate from the scatter targets because a pipelined
    channel can need a re-decision with no new chunk to write.

    The scatter, the per-channel prefix gather and the decision all run in
    ONE jitted program (one dispatch per tick), and per-tick upload drops
    from the full accumulated prefix (max_len/4 B/channel, re-sent every
    tick) to just the new chunk (chunk_len/4 B).
    """
    import jax.numpy as jnp
    buf = buf.at[s_chans, s_slots].set(rows)
    g = jnp.take(buf, d_chans, axis=0).reshape(d_chans.shape[0], -1)
    return buf, decision_core_packed_fused(btable, g, None, panel_mask,
                                           lengths=lengths, **kw)


def make_sharded_engine(mesh, index: MinimizerIndex, panel_mask: np.ndarray,
                        params: DecisionParams = DecisionParams()):
    """shard_map'd decision step over a ("dp", "ep") mesh.

    The returned callable takes reads (B, L) uint8 (B divisible by
    dp*ep) and returns decisions (B,) int8.  Index tables are sharded over
    ep; reads are sharded over BOTH axes so minimizer extraction runs
    exactly once per read (SURVEY.md §7 item 7 — round 1 replicated the
    extraction ep times); gathered hashes are masked to each shard's owned
    hash range and per-contig stats ride ONE psum_scatter back to the
    read's owner (see _decide_from_minima).
    """
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P
    from jax import shard_map

    ep = mesh.shape["ep"]
    assert index.n_shards == ep, (index.n_shards, ep)
    RSPEC = P(("dp", "ep"))

    def local_step(btable, reads, panel):
        return decision_core(btable[0], reads, panel,
                             k=index.k, w=index.w,
                             min_hits=params.min_hits,
                             bin_size=params.bin_size,
                             bucket_shift=index.bucket_shift,
                             ep_axis="ep", ep_size=ep,
                             two_choice=getattr(index, "two_choice",
                                                False))

    fn = shard_map(
        local_step, mesh=mesh,
        in_specs=(P("ep", None, None), P(("dp", "ep"), None), P(None, None)),
        out_specs=(RSPEC,) * 6,
        check_vma=False)
    jfn = jax.jit(fn)

    btable = jax.device_put(
        index.btable, NamedSharding(mesh, P("ep", None, None)))
    panel = jax.device_put(np.asarray(panel_mask),
                           NamedSharding(mesh, P(None, None)))

    def decide(reads):
        reads = jax.device_put(np.asarray(reads),
                               NamedSharding(mesh, P(("dp", "ep"), None)))
        return jfn(btable, reads, panel)

    # packed fast path, same as SingleChipEngine.decide_packed: 2-bit
    # codes (+ optional N bitmap or 4-byte lengths) are the only
    # batch-sharded transfer
    pcache = {}

    def decide_packed(packed, nmask, L, lengths=None):
        has_nm = nmask is not None
        has_ln = lengths is not None
        key = (L, has_nm, has_ln)
        if key not in pcache:
            core = functools.partial(
                decision_core_packed, L=L, k=index.k, w=index.w,
                min_hits=params.min_hits, bin_size=params.bin_size,
                bucket_shift=index.bucket_shift, ep_axis="ep", ep_size=ep,
                two_choice=getattr(index, "two_choice", False))
            if has_nm:
                def local(bt, pk, nm, pn):
                    return core(bt[0], pk, nm, pn)
                extra = (P(("dp", "ep"), None),)
            elif has_ln:
                def local(bt, pk, ln, pn):
                    return core(bt[0], pk, None, pn, lengths=ln)
                extra = (RSPEC,)
            else:
                def local(bt, pk, pn):
                    return core(bt[0], pk, None, pn)
                extra = ()
            specs = (P("ep", None, None), P(("dp", "ep"), None)) + extra \
                + (P(None, None),)
            # reorder: panel is always the last arg
            pf = shard_map(local, mesh=mesh, in_specs=specs,
                           out_specs=(RSPEC,) * 6,
                           check_vma=False)
            pcache[key] = jax.jit(pf)
        args = [btable,
                jax.device_put(np.asarray(packed),
                               NamedSharding(mesh, P(("dp", "ep"), None)))]
        if has_nm:
            args.append(jax.device_put(
                np.asarray(nmask),
                NamedSharding(mesh, P(("dp", "ep"), None))))
        elif has_ln:
            args.append(jax.device_put(np.asarray(lengths),
                                       NamedSharding(mesh, RSPEC)))
        args.append(panel)
        return pcache[key](*args)

    decide.decide_packed = decide_packed
    return decide
