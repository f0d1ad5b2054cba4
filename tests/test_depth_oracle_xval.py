"""Cross-validate tools/depth.py and io/bam.py against the independent
stdlib-only samtools-depth oracle (tests/_depth_oracle.py) on the
reference's own real-data BAM (reference: test/example.bam), and validate
BamWriter output with that independent parser (VERDICT.md round-1 items
#7 and weak #5)."""

import io
import os

import numpy as np
import pytest

import _depth_oracle as oracle

HERE = os.path.dirname(os.path.abspath(__file__))
BAM = os.path.join(os.path.dirname(HERE), "test_data", "example.bam")


@pytest.fixture(scope="module")
def envelopes():
    return oracle.covered_envelopes(BAM, pad=500)


def test_oracle_reads_the_bam(envelopes):
    names, lens, records = oracle.read_bam(BAM)
    assert names[0] == "chr1" and lens[0] == 248956422
    assert len(records) == 50
    assert envelopes  # at least one covered region


@pytest.mark.parametrize("minq", [0, 20, 60])
def test_depth_rows_match_oracle(envelopes, minq):
    """CLI `depth -Q minq -b regions` rows == the oracle's
    samtools-depth-equivalent rows, byte for byte."""
    from cornetto_tpu.tools import depth as depth_tool
    buf = io.StringIO()
    depth_tool.run(BAM, min_mapq=minq, regions=envelopes, out=buf)
    assert buf.getvalue() == oracle.depth_rows(BAM, envelopes, minq)


def test_depth_bedgraph_rows_match_oracle(envelopes):
    """The protocol's awk-converted 1-bp bedgraph (reference:
    shitflow/create-launch.pbs.sh:66-67) against the oracle depths."""
    from cornetto_tpu.tools import depth as depth_tool
    buf = io.StringIO()
    depth_tool.run(BAM, min_mapq=20, regions=envelopes, bedgraph=True,
                   out=buf)
    d = oracle.depth_in_regions(BAM, envelopes, 20)
    want = []
    for name, beg, end in envelopes:
        for i, v in enumerate(d[(name, beg, end)]):
            want.append("%s\t%d\t%d\t%d\n" % (name, beg + i, beg + i + 1, v))
    assert buf.getvalue() == "".join(want)


def test_zero_depth_regions(envelopes):
    """-aa semantics: zero rows for read-free regions."""
    from cornetto_tpu.tools import depth as depth_tool
    names, lens, _ = oracle.read_bam(BAM)
    covered = {n for n, _, _ in envelopes}
    empty_ref = next(n for n in names if n not in covered)
    regions = [(empty_ref, 100, 160)]
    buf = io.StringIO()
    depth_tool.run(BAM, regions=regions, out=buf)
    assert buf.getvalue() == oracle.depth_rows(BAM, regions)
    assert set(line.split("\t")[2] for line in
               buf.getvalue().splitlines()) == {"0"}


def test_bam_writer_validated_by_oracle(tmp_path, envelopes):
    """BamWriter's output parsed by the INDEPENDENT oracle gives identical
    records and depths (round 1 only round-tripped through our own
    reader)."""
    from cornetto_tpu.io.bam import BamFile, BamWriter, _iter_raw_records
    src = BamFile(BAM)
    out = str(tmp_path / "rewritten.bam")
    with BamWriter(out, src.ref_names, src.ref_lens,
                   header_text=src.header_text) as w:
        for payload, ref_id, pos, ref_end in _iter_raw_records(
                src._all(), src._aln_off):
            w.write_raw(payload, ref_id, pos, ref_end)
    n1, l1, r1 = oracle.read_bam(BAM)
    n2, l2, r2 = oracle.read_bam(out)
    assert n1 == n2 and l1 == l2 and r1 == r2
    assert oracle.depth_in_regions(out, envelopes, 20) \
        == oracle.depth_in_regions(BAM, envelopes, 20)
