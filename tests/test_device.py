"""The one capability check (utils.device.gpu_attached), the compile-cache
placement, and the CLI paths that depend on them."""

import io
import os
import types

import pytest

import jax

from cornetto_tpu.kernels import window_sum
from cornetto_tpu.utils import device


def _fake_devices(*platforms):
    return lambda *a, **k: [types.SimpleNamespace(platform=p)
                            for p in platforms]


def test_gpu_attached_false_on_cpu():
    assert device.gpu_attached() is False
    assert window_sum.resolve_backend("auto") == "numpy"


def test_gpu_reported_picks_the_device_path(monkeypatch):
    monkeypatch.setattr(jax, "devices", _fake_devices("gpu"))
    assert device.gpu_attached() is True
    assert window_sum.resolve_backend("auto") == "jax"
    # explicit user choices stay as documented
    assert window_sum.resolve_backend("numpy") == "numpy"


def test_device_errors_propagate(monkeypatch):
    def boom(*a, **k):
        raise RuntimeError("Unable to initialize backend 'cuda'")
    monkeypatch.setattr(jax, "devices", boom)
    with pytest.raises(RuntimeError):
        device.gpu_attached()
    with pytest.raises(RuntimeError):
        window_sum.resolve_backend("auto")


@pytest.fixture
def restore_cache_dir():
    old = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", old)


def test_compile_cache_env_wins(monkeypatch, tmp_path, restore_cache_dir):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    jax.config.update("jax_compilation_cache_dir", None)
    assert device.use_compile_cache() == str(tmp_path)
    # JAX reads the variable itself: nothing is set in code
    assert jax.config.jax_compilation_cache_dir is None


def test_compile_cache_default_in_checkout(monkeypatch, restore_cache_dir):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    want = os.path.join(str(device.CHECKOUT), ".jax_cache")
    assert device.use_compile_cache() == want
    assert jax.config.jax_compilation_cache_dir == want
    assert os.path.isfile(os.path.join(str(device.CHECKOUT),
                                       "chip_smoke.py"))


def test_sdust_device_backend_rejected(tmp_path, capsys):
    from cornetto_tpu.tools import sdust
    fa = tmp_path / "x.fa"
    fa.write_text(">c\n" + "ATTCC" * 200 + "\n")
    for argv in (["--backend", "device", str(fa)],
                 ["--backend=device", str(fa)]):
        assert sdust.main(argv) == 1
        out = capsys.readouterr()
        assert out.out == ""
        assert "host only" in out.err
    buf = io.StringIO()
    sdust.run(str(fa), out=buf)
    assert buf.getvalue()
    assert sdust.main(["--backend", "host", str(fa)]) == 0


def test_no_interpreter_in_program_code():
    """interpret=True belongs to tests; no program path may fall back to
    the Pallas interpreter."""
    root = os.path.join(str(device.CHECKOUT), "cornetto_tpu")
    for dirpath, _, files in os.walk(root):
        for f in files:
            if f.endswith(".py"):
                with open(os.path.join(dirpath, f)) as fh:
                    assert "interpret=True" not in fh.read(), f
