"""telofind: report tandem telomere-motif runs per contig.

Reference behavior: src/find_telomere.c (find :44-74 — forward hits then
reverse-complement hits per contig; the intended scan-to-end semantics are
implemented rather than the reference's UB-reliant strstr loop, verified
equivalent on its outputs).
"""

import sys

from cornetto_tpu.io.fasta import read_fastx
from cornetto_tpu.kernels.motif import revcomp_motif


def scan_runs(seq: bytes, motif: bytes):
    """Left-to-right scan-cursor over bytes.find (memchr-fast, the same
    access pattern as the reference's strstr loop): yields maximal exact
    tandem runs (start, end, matched_len)."""
    k = len(motif)
    pos = 0
    n = len(seq)
    while True:
        pos = seq.find(motif, pos)
        if pos < 0:
            return
        start = pos
        length = 0
        while seq[pos:pos + k] == motif:
            pos += k
            length += k
        yield (start, pos, length)
        pos += 1


def _device_runs(seq: bytes, motif: bytes):
    """Device path: the XLA match-mask kernel scans the O(L) bases
    (kernels.telo_scan); the host walks only the sparse match positions —
    byte-identical rows."""
    from cornetto_tpu.kernels.minimizer import encode_seq
    from cornetto_tpu.kernels.telo_scan import (scan_runs_from_mask,
                                                telo_match_mask_long)
    codes = encode_seq(seq.decode("latin-1"))
    mcodes = encode_seq(motif.decode("latin-1"))
    if (mcodes >= 4).any():
        return scan_runs(seq, motif)  # non-ACGT motif: host scan
    mask = telo_match_mask_long(codes, mcodes)
    return scan_runs_from_mask(mask, len(motif))


def run(fasta_path: str, motif: str = "TTAGGG", out=None,
        backend: str = "host") -> None:
    """backend="device" scans with the XLA kernel (CLI: `--backend
    device`); the default is the memchr host scan."""
    out = out or sys.stdout
    rmotif = revcomp_motif(motif)
    for rec in read_fastx(fasta_path):
        # disambiguate: uppercase (reference :76-81)
        seq = rec.seq.upper().encode("latin-1")
        L = len(seq)
        for strand, m in ((0, motif), (1, rmotif)):
            mb = m.encode("latin-1")
            runs = (_device_runs(seq, mb)
                    if backend == "device" else scan_runs(seq, mb))
            rows = ["%s\t%d\t%d\t%d\t%d\t%d\n"
                    % (rec.name, L, strand, st, end, ln)
                    for st, end, ln in runs]
            out.write("".join(rows))


def main(argv) -> int:
    args = argv[1:] if argv and argv[0] == "telofind" else argv
    # --backend {host|device} follows the tool-flag convention used across
    # the CLI (an extension slot: the reference CLI is positional-only,
    # src/find_telomere.c:83-110); CORNETTO_TELOFIND_DEVICE=1 is honored
    # for back-compat.
    import os
    backend = "device" if os.environ.get("CORNETTO_TELOFIND_DEVICE") \
        else "host"
    pos = []
    i = 0
    while i < len(args):
        a = args[i]
        if a == "--backend" and i + 1 < len(args):
            backend = args[i + 1]
            i += 2
        elif a.startswith("--backend="):
            backend = a.split("=", 1)[1]
            i += 1
        else:
            pos.append(a)
            i += 1
    if backend not in ("host", "device"):
        sys.stderr.write("Error: --backend must be host or device\n")
        return 1
    if len(pos) < 1:
        sys.stderr.write("Error: invalid number of parameters\n")
        sys.stderr.write("Usage: find <input fasta> [optional sequence to "
                         "search for, default is vertebrate TTAGGG] "
                         "[--backend host|device]\n")
        return 1
    motif = pos[1] if len(pos) >= 2 else "TTAGGG"
    run(pos[0], motif, backend=backend)
    return 0
