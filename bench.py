#!/usr/bin/env python3
"""Headline benchmark: adaptive-sampling decision throughput (reads/s) on
one GPU via the livefish engine.

Prints ONE JSON line:
  {"metric": "adaptive_sampling_decisions", "value": <reads/s>,
   "unit": "reads/s", "device": {...}, "device_step_ms": ..., ...}

  value           — slope-timed rate ((T(n2)-T(n1)) / (n2-n1) cancels
                    warm-up + thread setup) of the production-shaped
                    pipeline: fused decide (one result array per batch),
                    uploads back-to-back, readbacks on a drain thread
  device_step_ms  — one decision step on device-resident inputs, timed to
                    block_until_ready

It fails (non-zero exit, no line) when no GPU is attached: a number taken
on the CPU is not a device number.
"""

import json
import sys
import time

import numpy as np


def build_problem(genome_mb: float = 8.0, batch: int = 16384,
                  read_len: int = 450):
    from cornetto_tpu.livefish.index import build_index, build_panel_mask
    rng = np.random.default_rng(12345)
    bases = np.array(list("ACGT"))
    n = int(genome_mb * 1e6)
    half = n // 2
    genome = {
        "ctg1": "".join(bases[rng.integers(0, 4, half)]),
        "ctg2": "".join(bases[rng.integers(0, 4, n - half)]),
    }
    idx = build_index(genome, n_shards=1)
    panel = build_panel_mask(idx, [("ctg1", half // 4, half // 2),
                                   ("ctg2", 0, (n - half) // 3)])
    # reads: half sampled from the genome, half random
    reads = np.empty((batch, read_len), dtype=np.uint8)
    from cornetto_tpu.kernels.minimizer import encode_seq
    g1 = genome["ctg1"]
    for i in range(batch // 2):
        s = int(rng.integers(0, half - read_len))
        reads[i] = encode_seq(g1[s:s + read_len])
    reads[batch // 2:] = rng.integers(
        0, 4, size=(batch - batch // 2, read_len)).astype(np.uint8)
    return idx, panel, reads


def main() -> int:
    import queue
    import threading

    import jax
    import jax.numpy as jnp

    from bench_kernels import device_ms, device_record
    from cornetto_tpu.kernels.minimizer import pack_reads
    from cornetto_tpu.livefish.decide import (DecisionParams,
                                              SingleChipEngine,
                                              decision_core_packed)
    from cornetto_tpu.utils.device import gpu_attached, use_compile_cache

    if not gpu_attached():
        sys.stderr.write("bench.py: no GPU attached\n")
        return 1
    use_compile_cache()
    batch = 16384
    idx, panel, reads = build_problem(batch=batch)
    eng = SingleChipEngine(idx, panel, DecisionParams())
    read_len = reads.shape[1]
    # N-free batch (basecallers emit pure ACGT): the 2-bit packed codes are
    # the ONLY per-read host->device traffic — 113 B/read at L=450
    packed, _ = pack_reads(reads)
    np.asarray(eng.decide_packed_fused(packed, None, read_len))   # compile

    def run_pipelined(n):
        dq: "queue.Queue" = queue.Queue(maxsize=4)
        done = object()
        err = []

        def drain():
            while True:
                item = dq.get()
                if item is done:
                    return
                if err:
                    continue      # keep consuming so the producer unblocks
                try:
                    np.asarray(item)   # full (2, B) readback
                except BaseException as e:
                    err.append(e)

        th = threading.Thread(target=drain, daemon=True)
        th.start()
        t0 = time.perf_counter()
        for _ in range(n):
            dq.put(eng.decide_packed_fused(packed, None, read_len))
        dq.put(done)
        th.join()
        if err:
            raise err[0]
        return time.perf_counter() - t0

    run_pipelined(3)   # steady state
    best = None
    for _ in range(3):
        dt = (run_pipelined(18) - run_pipelined(6)) / 12
        best = dt if best is None else min(best, dt)
    reads_per_s = batch / best

    step = jax.jit(lambda p: decision_core_packed(
        jnp.asarray(idx.btable[0]), p, None, jnp.asarray(panel), L=read_len,
        k=idx.k, w=idx.w, min_hits=3, bin_size=1000,
        bucket_shift=idx.bucket_shift, two_choice=idx.two_choice))
    step_ms = device_ms(step, jax.device_put(packed))

    print(json.dumps({
        "metric": "adaptive_sampling_decisions",
        "value": round(reads_per_s, 1),
        "unit": "reads/s",
        "device": device_record(),
        "device_step_ms": round(step_ms, 4),
        "device_reads_per_s": round(batch / step_ms * 1e3, 1),
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
