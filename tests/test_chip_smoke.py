"""chip_smoke.py: its phases at a tiny size on the CPU (the card runs them
at full size), and its refusal to run without a GPU or without the
program."""

import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

import chip_smoke

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def draft(tmp_path_factory):
    work = tmp_path_factory.mktemp("smoke")
    return work, chip_smoke.Draft(work, 3.0, seed=0)


@pytest.fixture(scope="module")
def index(draft):
    work, d = draft
    return chip_smoke.phase_livefish(work, d, 2048, 1024, 1024,
                                     np.random.default_rng(1))


def test_draft_shape(draft):
    work, d = draft
    assert len(d.lens) == 15 and d.lens[0] == max(d.lens)
    assert abs(d.bp - 3_000_000) < 500_000
    # telomeric repeats at the ends of every third contig
    assert (d.codes[0][-6:] == [3, 3, 0, 2, 2, 2]).all()
    assert (d.codes[0][:6] == [1, 1, 1, 2, 0, 0]).all()
    codes, kinds, origin = d.reads(400, 450, np.random.default_rng(2))
    assert codes.shape == (400, 450)
    assert sorted(set(kinds)) == ["nonpanel", "panel", "random"]


def test_livefish_phase(index):
    assert os.path.exists(str(index) + ".npz")


def test_replay_phase(draft, index):
    work, d = draft
    chip_smoke.phase_replay(work, d, index, 256, 2000,
                            np.random.default_rng(3))


def test_panel_phase(draft):
    work, _ = draft
    chip_smoke.phase_panel(work, 300_000, np.random.default_rng(4))


def test_telofind_phase(draft):
    work, d = draft
    chip_smoke.phase_telofind(work, d)


def test_multi_phase(draft):
    import jax
    work, d = draft
    chip_smoke.phase_multi(work, d, 512, jax.devices()[:4],
                           np.random.default_rng(5))


def _run(script, cwd):
    env = {k: v for k, v in os.environ.items()
           if k not in ("PYTHONPATH", "JAX_PLATFORMS")}
    return subprocess.run([sys.executable, script], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_fails_without_gpu():
    p = _run(os.path.join(ROOT, "chip_smoke.py"), ROOT)
    assert p.returncode != 0
    assert '"ok": true' not in p.stdout


def test_fails_without_the_program(tmp_path):
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    p = _run("chip_smoke.py", str(tmp_path))
    assert p.returncode != 0
    assert '"ok": true' not in p.stdout


def test_read_origins(draft):
    _, d = draft
    codes, kinds, origin = d.reads(300, 450, np.random.default_rng(6))
    assert ((origin[:, 0] >= 0) == (kinds != "random")).all()
    for i in np.flatnonzero(kinds != "random"):
        j, s = origin[i]
        assert (d.codes[j][s:s + 450] == codes[i]).all()
        ln = d.lens[j]
        in_panel = ln // 4 <= s and s + 450 <= 3 * ln // 4
        assert in_panel == (kinds[i] == "panel")
