"""Two-choice device-table placement (round-4 verdict item 4): the tagged
two-choice layout must roughly halve the directory bytes/entry at the same
0.5% overflow bound, while decisions stay exact and the lookup stays
32-byte row-gathers (cornetto_tpu/livefish/index.py layout comment).

Reference for the role: the readfish+minimap2 index the reference protocol
delegates to (docs/protocol.md) — this table is livefish's on-device
replacement."""

import numpy as np
import pytest

from cornetto_tpu.livefish.index import build_index, build_panel_mask


def _genome(mbp: float, seed: int = 3):
    rng = np.random.default_rng(seed)
    bases = np.array(list("ACGT"))
    n = int(mbp * 1e6)
    return {"g": "".join(bases[rng.integers(0, 4, n)])}


def _stored_entries(idx):
    K = idx.bucket_slots
    bt = idx.btable
    ct = np.stack([(bt[:, :, K // 2 + s // 2] >> (16 * (s % 2))) & 0xFFFF
                   for s in range(K)], axis=2)
    return int((ct != 0xFFFF).sum())


@pytest.mark.slow
def test_two_choice_shrinks_table_at_scale():
    # sized so the overflow-growth loop binds (the 16/17-log2E
    # fingerprint floor dominates below ~1M entries and would hide the
    # occupancy effect)
    g = _genome(6.0)
    legacy = build_index(g, two_choice=False, keep_tables=False)
    tc = build_index(g, keep_tables=False)
    assert legacy.dropped_frac <= 0.005
    assert tc.dropped_frac <= 0.005
    nl, nt = _stored_entries(legacy), _stored_entries(tc)
    bpe_l = legacy.btable.nbytes / nl
    bpe_t = tc.btable.nbytes / nt
    # the headline claim: >= 1.8x fewer table bytes per stored entry
    assert bpe_t <= 0.55 * bpe_l, (bpe_l, bpe_t)
    occ = nt / (tc.btable.shape[1] * tc.bucket_slots)
    assert occ >= 0.45, occ


def test_decisions_identical_across_placements():
    # at a scale where NO bucket overflows, single-choice, two-choice and
    # every slot width store the exact same entry set -> the full 6-tuple
    # decision output must match across all of them
    from cornetto_tpu.livefish.decide import DecisionParams, SingleChipEngine
    g = _genome(0.1)   # small enough that no bucket overflows anywhere
    rng = np.random.default_rng(11)
    bases = np.array(list("ACGT"))
    seq = g["g"]
    reads = np.empty((64, 450), dtype=np.uint8)
    from cornetto_tpu.kernels.minimizer import encode_seq
    for i in range(64):
        if i % 2 == 0:
            s = int(rng.integers(0, len(seq) - 450))
            reads[i] = encode_seq(seq[s:s + 450])
        else:
            reads[i] = rng.integers(0, 4, 450).astype(np.uint8)
    outs = []
    for kw in ({"two_choice": False}, {}, {"bucket_slots": 8},
               {"bucket_slots": 16}):
        idx = build_index(g, **kw)
        assert idx.dropped_frac == 0.0
        panel = build_panel_mask(idx, [("g", 0, len(seq) // 2)])
        eng = SingleChipEngine(idx, panel, DecisionParams())
        outs.append([np.asarray(x) for x in eng.decide(reads)])
    for got in outs[1:]:
        for a, b in zip(outs[0], got):
            np.testing.assert_array_equal(a, b)


def test_two_choice_lookup_finds_displaced_entries():
    # force real displacements (high load) and check every stored entry
    # is found by the two-probe lookup with its exact stored position
    import jax.numpy as jnp
    from cornetto_tpu.livefish.decide import _lookup_votes
    g = _genome(2.0, seed=5)
    idx = build_index(g, keep_tables=True)
    bt = idx.btable[0]
    K = idx.bucket_slots
    # displaced entries exist (tag bit set in some stored fp half)
    fph = np.stack([(bt[:, s // 2] >> (16 * (s % 2))) & 0xFFFF
                    for s in range(K)], axis=1)
    ct = np.stack([(bt[:, K // 2 + s // 2] >> (16 * (s % 2))) & 0xFFFF
                   for s in range(K)], axis=1)
    assert ((fph >= 0x8000) & (ct != 0xFFFF)).any(), "no displacements"
    n = int(idx.shard_counts[0])
    h = idx.hashes[0, :256]
    q = jnp.asarray(h[None, :])
    stats = _lookup_votes(jnp.asarray(bt), idx.bucket_shift, q,
                          jnp.ones_like(q, bool), 1, True)
    votes = np.asarray(stats[0])
    # all queried hashes are real index entries; drops are < 0.5%, so at
    # least 99% of a 256-hash sample must be found
    assert votes.sum() >= 254, votes.sum()
