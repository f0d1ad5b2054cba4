"""Profiling hooks: the reference exposes a --profile-cpu sectional-timing
knob (reference: src/cornetto.c:252-272); the device equivalent is a
jax.profiler trace around a region, switched by CORNETTO_PROFILE=<dir>."""

import contextlib
import os
import time

from cornetto_tpu.utils import logging as log


@contextlib.contextmanager
def maybe_trace(tag: str):
    """jax.profiler trace context if CORNETTO_PROFILE is set; always logs
    the section wall time at VERBOSE level (the reference's sectional
    timers)."""
    trace_dir = os.environ.get("CORNETTO_PROFILE")
    t0 = time.time()
    if trace_dir:
        import jax
        with jax.profiler.trace(os.path.join(trace_dir, tag)):
            yield
    else:
        yield
    log.verbose("%s in %.2f seconds" % (tag, time.time() - t0))
