import os

# Tests run on a virtual 8-device CPU mesh so multi-device sharding logic is
# exercised without a GPU (SURVEY.md §4: multi-host simulation layer).
# Tests marked `gpu` run on the card with:
#   JAX_PLATFORMS=cuda python -m pytest -m gpu tests/
os.environ.setdefault("JAX_PLATFORMS", "cpu")
xla_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in xla_flags:
    os.environ["XLA_FLAGS"] = (
        xla_flags + " --xla_force_host_platform_device_count=8").strip()

import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
DATA = ROOT / "test_data"
SYNTH = DATA / "synth"
GOLD = DATA / "golden"


@pytest.fixture(scope="session")
def synth():
    assert (SYNTH / "cov-total.bg").exists(), \
        "run: python3 test_data/gen_synth.py"
    return SYNTH


@pytest.fixture(scope="session")
def gold():
    assert (GOLD / "boring_t1.txt").exists(), \
        "run: bash test_data/gen_goldens.sh"
    return GOLD


@pytest.fixture(scope="session")
def bigenough_fixtures():
    return DATA / "bigenough"


# ---- slow-test lanes (round-2 verdict item #9) -------------------------
# `pytest -q` is the fast inner loop (< 5 min); slow tiers (multiprocess
# gloo runs, composed-pipeline goldens, crash-injection, 20 Mbp diffs)
# run with --runslow, which CI always passes.  RUNSLOW=1 also enables
# them (for the driver's plain `pytest tests/` invocations).


def pytest_addoption(parser):
    parser.addoption("--runslow", action="store_true", default=False,
                     help="run tests marked slow (CI always does)")


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "slow: long-running tier, deselected unless --runslow")
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA GPU; skipped where JAX sees none")


@pytest.fixture(autouse=True)
def _gpu_only(request):
    """Skip `gpu`-marked tests unless JAX sees a GPU (decided per test at
    run time, so every worker collects the same tests)."""
    if request.node.get_closest_marker("gpu") is None:
        return
    from cornetto_tpu.utils.device import gpu_attached
    if not gpu_attached():
        pytest.skip("needs an NVIDIA GPU: JAX_PLATFORMS=cuda python -m "
                    "pytest -m gpu tests/")


def pytest_collection_modifyitems(config, items):
    if config.getoption("--runslow") or os.environ.get("RUNSLOW") == "1":
        return
    skip = pytest.mark.skip(reason="slow tier: pass --runslow (CI does)")
    for item in items:
        if "slow" in item.keywords:
            item.add_marker(skip)
