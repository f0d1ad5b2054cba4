"""Minimizer extraction on the device path (XLA): bit-parity with the host
index build (minimizers_np), plus the fingerprinted-lookup decision path on
packed reads."""

import numpy as np
import pytest

import jax.numpy as jnp

from cornetto_tpu.kernels.minimizer import (encode_seq, minimizers_np,
                                            pack_reads, read_minimizers_jax,
                                            unpack_reads_jax)


@pytest.mark.parametrize("B,L,k,w", [
    (64, 450, 15, 10),
    (32, 300, 15, 10),
    (16, 1024, 13, 8),
    (8, 200, 15, 12),
])
def test_extract_parity(B, L, k, w):
    """Packed reads -> device unpack + extraction == the host twin, read by
    read (window positions, hashes and the N-invalidated windows)."""
    rng = np.random.default_rng(7 + B)
    reads = rng.integers(0, 4, size=(B, L)).astype(np.uint8)
    reads[rng.random((B, L)) < 0.01] = 4      # sprinkle Ns
    packed, nmask = pack_reads(reads)
    codes = unpack_reads_jax(jnp.asarray(packed), jnp.asarray(nmask), L)
    np.testing.assert_array_equal(np.asarray(codes), reads)
    pos, h, v = (np.asarray(a) for a in read_minimizers_jax(codes, k=k,
                                                            w=w))
    for b in range(B):
        p_ref, h_ref = minimizers_np(reads[b], k=k, w=w)
        np.testing.assert_array_equal(h[b][v[b]], h_ref)
        np.testing.assert_array_equal(pos[b][v[b]], p_ref)
    # want_pos=False (the decision path) keeps the same minima
    _, h2, v2 = read_minimizers_jax(codes, k=k, w=w, want_pos=False)
    np.testing.assert_array_equal(np.asarray(h2), h)
    np.testing.assert_array_equal(np.asarray(v2), v)


@pytest.mark.gpu
def test_extract_parity_on_gpu():
    """The same parity at the production batch (16,384 x 450) on the
    card."""
    rng = np.random.default_rng(0)
    reads = rng.integers(0, 4, size=(16384, 450)).astype(np.uint8)
    packed, nmask = pack_reads(reads)
    codes = unpack_reads_jax(jnp.asarray(packed), jnp.asarray(nmask), 450)
    pos, h, v = (np.asarray(a) for a in read_minimizers_jax(codes))
    for b in range(0, 16384, 997):
        p_ref, h_ref = minimizers_np(reads[b])
        np.testing.assert_array_equal(h[b][v[b]], h_ref)
        np.testing.assert_array_equal(pos[b][v[b]], p_ref)


def test_decide_packed_matches_unpacked():
    """decision_core_packed (2-bit packed reads + N bitmap) ==
    decision_core on unpacked reads, including the fingerprinted lookup."""
    from cornetto_tpu.livefish.decide import (decision_core,
                                              decision_core_packed)
    from cornetto_tpu.livefish.index import build_index, build_panel_mask
    rng = np.random.default_rng(11)
    bases = np.array(list("ACGT"))
    genome = {"c1": "".join(bases[rng.integers(0, 4, 30000)]),
              "c2": "".join(bases[rng.integers(0, 4, 20000)])}
    idx = build_index(genome, n_shards=1)
    panel = build_panel_mask(idx, [("c1", 5000, 15000)])
    L = 400
    reads = np.zeros((32, L), dtype=np.uint8)
    for i in range(16):
        s = int(rng.integers(0, 30000 - L))
        reads[i] = encode_seq(genome["c1"][s:s + L])
    reads[16:] = rng.integers(0, 4, size=(16, L)).astype(np.uint8)
    reads[20, 100:110] = 4                    # an interior N run
    packed, nmask = pack_reads(reads)
    kw = dict(k=idx.k, w=idx.w, min_hits=3, bin_size=1000,
              bucket_shift=idx.bucket_shift)
    ref = decision_core(jnp.asarray(idx.btable[0]), jnp.asarray(reads),
                        jnp.asarray(panel), **kw)
    got = decision_core_packed(jnp.asarray(idx.btable[0]),
                               jnp.asarray(packed), jnp.asarray(nmask),
                               jnp.asarray(panel), L=L, **kw)
    for r, g in zip(ref, got):
        np.testing.assert_array_equal(np.asarray(r), np.asarray(g))
    # sanity: genome reads map, random mostly don't
    assert int(np.asarray(ref[3])[:16].min()) >= 3


def test_decide_packed_lengths_paths_agree():
    """The packed input variants (N bitmap / 4-byte lengths) produce
    identical decisions for short, N-free reads."""
    from cornetto_tpu.livefish.decide import decision_core_packed
    from cornetto_tpu.livefish.index import build_index, build_panel_mask
    rng = np.random.default_rng(21)
    bases = np.array(list("ACGT"))
    genome = {"c1": "".join(bases[rng.integers(0, 4, 20000)])}
    idx = build_index(genome, n_shards=1)
    panel = build_panel_mask(idx, [("c1", 2000, 9000)])
    L = 300
    rows = np.full((16, L), 4, dtype=np.uint8)
    lens = rng.integers(60, L + 1, size=16).astype(np.int32)
    for i in range(16):
        s = int(rng.integers(0, 20000 - L))
        rows[i, :lens[i]] = encode_seq(genome["c1"][s:s + int(lens[i])])
    packed, nmask = pack_reads(rows)
    kw = dict(L=L, k=idx.k, w=idx.w, min_hits=3, bin_size=1000,
              bucket_shift=idx.bucket_shift)
    bt, pn = jnp.asarray(idx.btable[0]), jnp.asarray(panel)
    ref = decision_core_packed(bt, jnp.asarray(packed), jnp.asarray(nmask),
                               pn, **kw)
    got_len = decision_core_packed(bt, jnp.asarray(packed), None, pn,
                                   lengths=jnp.asarray(lens), **kw)
    for r, a in zip(ref, got_len):
        np.testing.assert_array_equal(np.asarray(r), np.asarray(a))


def test_fingerprint_lookup_exact():
    """Every indexed minimizer must be found by the fingerprint lookup with
    its exact contig and position (zero drops at this scale).  One query per
    row so the per-contig stats pin each hash individually: exactly one
    vote, on the right contig, with the position sum equal to the stored
    refpos.  The genome carries a deliberate exact repeat so ambiguous
    (multi-occurrence) hashes exercise the two-slot path: their first AND
    second occurrences must both come back (numer_a1 / numer_a2)."""
    from cornetto_tpu.livefish.decide import _lookup_votes
    from cornetto_tpu.livefish.index import build_index
    rng = np.random.default_rng(3)
    bases = np.array(list("ACGT"))
    g1 = bases[rng.integers(0, 4, 30000)]
    g1[20000:23000] = g1[2000:5000]          # exact repeat -> ambiguity
    genome = {"c1": "".join(g1),
              "c2": "".join(bases[rng.integers(0, 4, 20000)])}
    idx = build_index(genome, n_shards=1)
    assert idx.dropped_frac == 0.0
    n = int(idx.shard_counts[0])
    h = idx.hashes[0, :n]
    pos_raw = idx.positions[0, :n]
    amb = pos_raw < 0
    assert amb.any(), "repeat failed to produce ambiguous hashes"
    pos = pos_raw & 0x7FFFFFFF
    q = jnp.asarray(h[:, None])                      # (n, 1): one per row
    (votes, votes_un, nu_hi, nu_lo, votes_amb,
     a1_hi, a1_lo, a2_hi, a2_lo) = (
        np.asarray(x, dtype=np.int64) for x in _lookup_votes(
            jnp.asarray(idx.btable[0]), idx.bucket_shift, q,
            jnp.ones_like(q, dtype=bool), 2))
    numer_un = (nu_hi << 16) + nu_lo
    numer_a1 = (a1_hi << 16) + a1_lo
    numer_a2 = (a2_hi << 16) + a2_lo
    rows = np.arange(n)
    exp_ctg = idx.contigs[0, :n]
    assert (votes.sum(axis=1) == 1).all()            # found, exactly once
    np.testing.assert_array_equal(votes[rows, exp_ctg], 1)
    # ambiguity classification matches the index marks
    np.testing.assert_array_equal(votes_un[rows, exp_ctg], (~amb) * 1)
    np.testing.assert_array_equal(votes_amb[rows, exp_ctg], amb * 1)
    # unambiguous hashes: exact stored position
    np.testing.assert_array_equal(numer_un[rows, exp_ctg][~amb], pos[~amb])
    # ambiguous hashes are stored as adjacent (first, second) occurrence
    # pairs: both dup rows of a pair answer with (first_pos, second_pos)
    first = np.flatnonzero(amb[:-1] & (h[:-1] == h[1:]))
    assert len(first), "expected adjacent ambiguous pairs"
    for i in first:
        for r in (i, i + 1):
            assert numer_a1[r, exp_ctg[r]] == pos[i]
            assert numer_a2[r, exp_ctg[r]] == pos[i + 1]
