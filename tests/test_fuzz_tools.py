"""Fuzzed differential coverage for the telomere/eval/dotplot tools against
reference-binary goldens (test_data/fuzz/manifest2.json)."""

import io
import json

import pytest

from conftest import DATA

FUZZ = DATA / "fuzz"
MANIFEST = json.load(open(FUZZ / "manifest2.json"))
ORACLE = [c for c in MANIFEST if "args" in c]
FIXASM = [c for c in MANIFEST if c.get("fixasm")]


def _cap(fn, *args, **kw):
    out = io.StringIO()
    fn(*args, out=out, **kw)
    return out.getvalue()


@pytest.mark.parametrize("case", ORACLE, ids=[c["out"] for c in ORACLE])
def test_oracle_case(case, monkeypatch):
    monkeypatch.chdir(DATA)
    args = case["args"]
    tool = args[0]
    want = (FUZZ / case["out"]).read_text()
    if tool == "telofind":
        from cornetto_tpu.tools import telofind
        got = _cap(telofind.run, args[1], *(args[2:] or []))
    elif tool == "sdust":
        from cornetto_tpu.tools import sdust
        kw = {}
        rest = args[1:]
        while rest[0].startswith("-"):
            if rest[0] == "-w":
                kw["W"] = int(rest[1])
            else:
                kw["T"] = int(rest[1])
            rest = rest[2:]
        got = _cap(sdust.run, rest[0], **kw)
    elif tool == "fa2bed":
        from cornetto_tpu.tools import fa2bed
        got = _cap(fa2bed.run, args[1])
    elif tool == "nx":
        from cornetto_tpu.tools import nx
        if args[1] == "-g":
            from cornetto_tpu.utils.parsing import parse_num_suffix
            got = _cap(nx.run, args[3], parse_num_suffix(args[2]))
        else:
            got = _cap(nx.run, args[1])
    elif tool == "report":
        from cornetto_tpu.tools import report
        got = _cap(report.run, args[1:])
    elif tool == "telowin":
        from cornetto_tpu.tools import telowin
        got = _cap(telowin.run, args[1], float(args[2]), float(args[3]))
    elif tool == "telobreaks":
        from cornetto_tpu.tools import telobreaks
        got = _cap(telobreaks.run, args[1], args[2], args[3])
    elif tool == "telocontigs":
        from cornetto_tpu.tools import telocontigs
        got = _cap(telocontigs.run, args[1], args[2])
    elif tool == "minidot":
        from cornetto_tpu.tools import minidot
        got = _cap(minidot.run, args[-1], min_span=10, min_match=1,
                   min_iden=0.01)
    else:
        pytest.skip("unhandled tool %s" % tool)
    assert got == want


@pytest.mark.parametrize("case", FIXASM, ids=["fixasm_%d" % c["t"]
                                              for c in FIXASM])
def test_fixasm_case(case, monkeypatch, tmp_path):
    from cornetto_tpu.tools import fixasm
    monkeypatch.chdir(DATA)
    t = case["t"]
    out, err = io.StringIO(), io.StringIO()
    fixasm.run(case["fa"], case["paf"],
               report_fn=str(tmp_path / "r.tsv"),
               out_paf=str(tmp_path / "w.paf"), out=out, err=err)
    assert out.getvalue() == (FUZZ / ("fx_%d.fasta" % t)).read_text()
    assert (tmp_path / "r.tsv").read_text() == \
        (FUZZ / ("fxr_%d.tsv" % t)).read_text()
    assert (tmp_path / "w.paf").read_text() == \
        (FUZZ / ("fxp_%d.paf" % t)).read_text()
