"""KHashStr must reproduce klib khash's bucket iteration order exactly
(goldens generated from a C program using the reference's khash.h —
test_data/khash_golden.json)."""

import json

from cornetto_tpu.utils.khash import KHashStr
from conftest import DATA


def test_iteration_order_matches_c_khash():
    cases = json.load(open(DATA / "khash_golden.json"))
    assert len(cases) >= 10
    for case in cases:
        h = KHashStr()
        for k in case["keys"]:
            h.put(k)
        assert h.keys_in_order() == case["iter_order"]


def test_basic_map_ops():
    h = KHashStr()
    h["a"] = 1
    h["b"] = 2
    h["a"] = 3
    assert h["a"] == 3 and h["b"] == 2
    assert len(h) == 2
    assert "a" in h and "zz" not in h
    assert h.get("zz", 9) == 9
