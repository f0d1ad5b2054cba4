"""Fuzzed differential coverage: randomized depth tracks and flag
combinations, goldens from the reference binary (test_data/fuzz/)."""

import io
import json

import pytest

from cornetto_tpu.tools import boringbits
from conftest import DATA

FUZZ = DATA / "fuzz"
MANIFEST = json.load(open(FUZZ / "manifest.json"))


def _opts(params, boring):
    opt = boringbits.BoringbitsOptions(boring=boring, backend="numpy")
    it = iter(params)
    for flag in it:
        val = next(it)
        if flag == "-w":
            opt.window_size = int(val)
        elif flag == "-i":
            opt.window_inc = int(val)
        elif flag == "-m":
            opt.min_ctg_len = int(val)
        elif flag == "-e":
            opt.edge_len = int(val)
        elif flag == "-L":
            opt.low_cov_thresh = float(val)
        elif flag == "-H":
            opt.high_cov_thresh = float(val)
        elif flag == "-Q":
            opt.low_mq_cov_thresh = float(val)
    return opt


@pytest.mark.parametrize("case", MANIFEST,
                         ids=[c["out"] for c in MANIFEST])
def test_fuzz_case(case):
    opt = _opts(case["params"], case["tool"] == "boringbits")
    out = io.StringIO()
    boringbits.run(str(FUZZ / ("cov%d.total.bg" % case["cov"])),
                   str(FUZZ / ("cov%d.mq.bg" % case["cov"])), opt, out=out)
    assert out.getvalue() == (FUZZ / case["out"]).read_text()
