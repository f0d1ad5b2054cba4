"""Fuzzed bigenough -T threshold sweep vs reference-binary goldens
(exercises the int32-overflow threshold arithmetic across contig sizes)."""

import io
import json

import pytest

from cornetto_tpu.tools import bigenough
from conftest import DATA

FUZZ = DATA / "fuzz"
MANIFEST = json.load(open(FUZZ / "manifest_be.json"))


@pytest.mark.parametrize("case", MANIFEST,
                         ids=[c["out"] for c in MANIFEST])
def test_bigenough_fuzz(case, tmp_path):
    csv = tmp_path / "out.csv"
    opt = bigenough.BigenoughOptions(threshold=case["T"],
                                     outreadfish=str(csv))
    out = io.StringIO()
    bigenough.run(str(DATA / "bigenough" / "chroms.bed"),
                  str(FUZZ / ("be_in%d.bed" % case["t"])), opt, out=out)
    assert out.getvalue() == (FUZZ / (case["out"] + ".bed")).read_text()
    assert csv.read_text() == (FUZZ / (case["out"] + ".csv")).read_text()
