"""Native (C) host kernels, built lazily with the system compiler and loaded
via ctypes — no pip packages required.  Every native kernel has a pure-Python
twin used as the correctness oracle and fallback."""

import ctypes
import os
import subprocess
import sys
import threading

_HERE = os.path.dirname(os.path.abspath(__file__))
_LOCK = threading.Lock()
_LIBS = {}


def _sanitize() -> bool:
    """CORNETTO_NATIVE_SANITIZE=1 builds every native kernel with ASan +
    UBSan (matching the reference's `make asan=1` + valgrind CI legs,
    /root/reference/Makefile:32-35, test/test.sh:16-22).  The host python
    is not ASan-linked, so the caller must LD_PRELOAD libasan/libubsan —
    tests/run_sanitized.sh does both."""
    return os.environ.get("CORNETTO_NATIVE_SANITIZE", "") == "1"


def _build(name: str, source: str, cflags=("-O3",)) -> str:
    suffix = ".asan" if _sanitize() else ""
    so_path = os.path.join(_HERE, "_%s%s.so" % (name, suffix))
    src_path = os.path.join(_HERE, source)
    if (os.path.exists(so_path)
            and os.path.getmtime(so_path) >= os.path.getmtime(src_path)):
        return so_path
    cc = os.environ.get("CC", "cc")
    if _sanitize():
        cflags = (*cflags, "-fsanitize=address,undefined",
                  "-fno-sanitize-recover=all", "-g")
    # build under a private name and rename into place, so concurrent
    # processes (test workers) never dlopen a half-written library
    tmp_path = "%s.%d.tmp" % (so_path, os.getpid())
    cmd = [cc, *cflags, "-shared", "-fPIC", "-pthread", src_path,
           "-o", tmp_path]
    subprocess.run(cmd, check=True, capture_output=True)
    os.replace(tmp_path, so_path)
    return so_path


def load(name: str, source: str, cflags=("-O3",)):
    """Build (if stale) and dlopen a native kernel; returns None when no
    compiler is available (callers fall back to Python).

    cflags: per-kernel optimisation flags — the branch-heavy sdust DP is
    2x FASTER at -O2 than -O3 (aggressive unroll/vectorise thrashes its
    data-dependent inner loops), while the streaming parsers like -O3."""
    with _LOCK:
        if name in _LIBS:
            return _LIBS[name]
        try:
            lib = ctypes.CDLL(_build(name, source, cflags))
        except Exception as e:  # no toolchain / build failure
            sys.stderr.write("[native] %s unavailable (%s); using Python "
                             "fallback\n" % (name, e.__class__.__name__))
            lib = None
        _LIBS[name] = lib
        return lib
