"""Telomere-scan kernels (kernels.telo_scan): bit-parity with NumPy
references and the telofind golden outputs, device path against the host
scan."""

import io
import os

import numpy as np
import pytest

from cornetto_tpu.kernels.telo_scan import (scan_runs_from_mask,
                                            telo_match_mask_jax,
                                            telo_match_mask_long,
                                            telo_run_stats_jax)

HERE = os.path.dirname(os.path.abspath(__file__))
TD = os.path.join(os.path.dirname(HERE), "test_data")

MOTIF = (3, 3, 0, 2, 2, 2)  # TTAGGG


def _codes(rng, B, L, plant=True):
    codes = rng.integers(0, 5, size=(B, L)).astype(np.uint8)  # incl. N=4
    if plant:
        telo = np.tile(np.array(MOTIF, np.uint8), min(60, L // 12))
        codes[0, :len(telo)] = telo                      # terminal run
        codes[1 % B, 37:37 + len(telo)] = telo           # internal run
        codes[2 % B, L - len(telo):] = telo              # tail run
    return codes


def _mask_np(codes, motif):
    k = len(motif)
    win = np.lib.stride_tricks.sliding_window_view(codes, k, axis=-1)
    return (win == np.array(motif, np.uint8)).all(axis=-1)


def _stats_np(codes, motif, min_run_bases=24):
    """Per read: matches, longest run of back-to-back motif copies, and
    whether a run of >= min_run_bases starts at position 0."""
    k = len(motif)
    ok = _mask_np(codes, motif)
    n, longest, terminal = [], [], []
    for row in ok:
        run = np.zeros(len(row) + k, dtype=np.int64)
        for i in range(len(row) - 1, -1, -1):
            run[i] = run[i + k] + 1 if row[i] else 0
        n.append(int(row.sum()))
        longest.append(int(run[:len(row)].max()))
        terminal.append(bool(run[0] >= -(-min_run_bases // k)))
    return np.array(n), np.array(longest), np.array(terminal)


@pytest.mark.parametrize("B,L", [(4, 512), (32, 4096), (7, 300), (1, 128)])
def test_stats_matches_numpy(B, L):
    import jax.numpy as jnp
    rng = np.random.default_rng(B * 1000 + L)
    codes = _codes(rng, B, L)
    got = telo_run_stats_jax(jnp.asarray(codes), MOTIF)
    for w, g in zip(_stats_np(codes, MOTIF), got):
        np.testing.assert_array_equal(w, np.asarray(g))


def test_mask_matches_numpy():
    import jax.numpy as jnp
    rng = np.random.default_rng(0)
    codes = _codes(rng, 16, 1024)
    got = np.asarray(telo_match_mask_jax(jnp.asarray(codes), MOTIF))
    np.testing.assert_array_equal(got, _mask_np(codes, MOTIF))


def test_mask_long_padding():
    """One long sequence, padded to a power-of-two bucket: runs at the
    sequence end and across the old 64 kb chunk boundary are kept, and
    nothing matches in the padding."""
    rng = np.random.default_rng(1)
    seq = rng.integers(0, 5, size=200_000).astype(np.uint8)
    telo = np.tile(np.array(MOTIF, np.uint8), 30)
    seq[65520:65520 + len(telo)] = telo
    seq[-len(telo):] = telo
    got = telo_match_mask_long(seq, MOTIF)
    want = np.zeros(len(seq), dtype=bool)
    want[:len(seq) - len(MOTIF) + 1] = _mask_np(seq, MOTIF)
    np.testing.assert_array_equal(want, got)
    assert not telo_match_mask_long(seq[:4], MOTIF).any()


def test_scan_runs_from_mask_matches_host_walk():
    from cornetto_tpu.tools.telofind import scan_runs
    rng = np.random.default_rng(2)
    motif = b"TTAGGG"
    bases = np.array(list("ACGTN"))
    seq = "".join(bases[rng.integers(0, 5, 5000)])
    # dense motif region with interruptions
    seq = seq[:900] + "TTAGGG" * 40 + "T" + "TTAGGG" * 3 + seq[900:]
    sb = seq.encode()
    k = len(motif)
    mask = np.zeros(len(sb), dtype=bool)
    for i in range(len(sb) - k + 1):
        mask[i] = sb[i:i + k] == motif
    assert scan_runs_from_mask(mask, k) == list(scan_runs(sb, motif))


def test_telofind_device_backend_golden():
    """Device-scanned telofind output is byte-identical to the golden
    produced by the reference C binary."""
    from cornetto_tpu.tools import telofind
    fasta = os.path.join(TD, "synth", "asm.fasta")
    golden = os.path.join(TD, "golden", "telofind.txt")
    buf = io.StringIO()
    telofind.run(fasta, backend="device", out=buf)
    with open(golden) as f:
        assert buf.getvalue() == f.read()


def test_telofind_device_backend_golden_ccctaa():
    from cornetto_tpu.tools import telofind
    fasta = os.path.join(TD, "synth", "asm.fasta")
    golden = os.path.join(TD, "golden", "telofind_ccctaa.txt")
    buf = io.StringIO()
    telofind.run(fasta, "CCCTAA", backend="device", out=buf)
    with open(golden) as f:
        assert buf.getvalue() == f.read()


def test_telofind_cli_backend_flag():
    """`telofind <fa> --backend device` matches the golden; an unknown
    backend is refused."""
    import contextlib
    from cornetto_tpu.tools import telofind
    fasta = os.path.join(TD, "synth", "asm.fasta")
    golden = os.path.join(TD, "golden", "telofind.txt")
    for argv in ([fasta, "--backend", "device"],
                 [fasta, "--backend=device"]):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            assert telofind.main(argv) == 0
        with open(golden) as f:
            assert buf.getvalue() == f.read()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert telofind.main([fasta, "--backend", "nope"]) == 1
    assert buf.getvalue() == ""


@pytest.mark.parametrize("seed,motif", [(0, "TTAGGG"), (1, "CCCTAA"),
                                        (2, "TTTAGGG")])
def test_telofind_device_matches_host_seeded(tmp_path, seed, motif):
    """Seeded contigs with planted tandem runs (ends, interior, broken
    runs, lowercase, Ns): device rows == host rows."""
    from cornetto_tpu.tools import telofind
    rng = np.random.default_rng(seed)
    bases = np.array(list("ACGTNacgt"))
    fa = tmp_path / "x.fa"
    with open(fa, "w") as f:
        for c in range(3):
            parts = ["".join(bases[rng.integers(0, 9, 3000)])]
            for _ in range(4):
                parts.append(motif * int(rng.integers(1, 40)))
                parts.append("".join(bases[rng.integers(0, 9, 500)]))
            f.write(">c%d\n%s%s\n" % (c, motif * 50, "".join(parts)))
    out = {}
    for backend in ("device", "host"):
        buf = io.StringIO()
        telofind.run(str(fa), motif, backend=backend, out=buf)
        out[backend] = buf.getvalue()
    assert out["device"] == out["host"] and out["host"].count("\n") > 10


@pytest.mark.gpu
def test_telofind_on_gpu_long_contig(tmp_path):
    from cornetto_tpu.tools import telofind
    rng = np.random.default_rng(3)
    seq = bytearray(np.frombuffer(b"ACGT", np.uint8)[
        rng.integers(0, 4, 50_000_000)].tobytes())
    seq[:600] = b"CCCTAA" * 100
    seq[-600:] = b"TTAGGG" * 100
    fa = tmp_path / "long.fa"
    fa.write_bytes(b">chr\n" + bytes(seq) + b"\n")
    out = {}
    for backend in ("device", "host"):
        buf = io.StringIO()
        telofind.run(str(fa), backend=backend, out=buf)
        out[backend] = buf.getvalue()
    assert out["device"] == out["host"]
