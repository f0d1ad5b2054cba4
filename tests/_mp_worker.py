"""Worker process for the multi-process distributed validation test.

Each process owns 2 virtual CPU devices; jax.distributed (gloo collectives)
joins them into one global runtime.  The worker runs the REAL sharded
programs — the extract-once livefish decision step over a ("dp","ep") mesh
and the sp halo-exchange window scan — and byte-checks its addressable
output shards against the single-process oracle computed locally.

Usage: python tests/_mp_worker.py <coordinator> <num_procs> <proc_id>
"""

import os
import sys

os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_force_host_platform_device_count=2")
os.environ["JAX_PLATFORMS"] = "cpu"

import numpy as np  # noqa: E402


def main() -> int:
    coordinator, num_procs, proc_id = (
        sys.argv[1], int(sys.argv[2]), int(sys.argv[3]))
    import jax

    from cornetto_tpu.dist import multihost
    started = multihost.initialize(coordinator_address=coordinator,
                                   num_processes=num_procs,
                                   process_id=proc_id)
    assert started, "multihost.initialize did not start jax.distributed"
    assert jax.process_count() == num_procs
    n_global = len(jax.devices())
    n_local = len(jax.local_devices())
    assert n_global == 2 * num_procs and n_local == 2, (n_global, n_local)

    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
    from cornetto_tpu.livefish.decide import (DecisionParams,
                                              SingleChipEngine,
                                              make_sharded_engine)
    from cornetto_tpu.livefish.index import build_index, build_panel_mask

    # --- (1) cross-process psum smoke check -----------------------------
    mesh1 = Mesh(np.array(jax.devices()), ("dp",))
    ones = jax.device_put(
        np.ones(n_global, np.int32),
        NamedSharding(mesh1, P("dp")))
    total = jax.jit(
        jax.shard_map(lambda x: jax.lax.psum(x.sum(), "dp"),
                      mesh=mesh1, in_specs=P("dp"), out_specs=P()))(ones)
    assert int(np.asarray(total.addressable_data(0))) == n_global

    # --- (2) sharded decision step over ("dp","ep") spanning processes --
    rng = np.random.default_rng(0)
    bases = np.array(list("ACGT"))
    genome = {"ctgA": "".join(bases[rng.integers(0, 4, 60000)]),
              "ctgB": "".join(bases[rng.integers(0, 4, 30000)])}
    panel_rows = [("ctgA", 10000, 40000)]
    ep = 2
    dp = n_global // ep
    idxE = build_index(genome, n_shards=ep)
    panel = build_panel_mask(idxE, panel_rows)
    mesh = Mesh(np.array(jax.devices()).reshape(dp, ep), ("dp", "ep"))
    eng = make_sharded_engine(mesh, idxE, panel)

    B, L = 32, 400
    reads = np.empty((B, L), dtype=np.uint8)
    for i in range(B):
        if i % 4 == 3:
            reads[i] = rng.integers(0, 4, L).astype(np.uint8)
        else:
            ctg = "ctgA" if i % 2 == 0 else "ctgB"
            s = int(rng.integers(0, len(genome[ctg]) - L))
            reads[i] = np.frombuffer(
                genome[ctg][s:s + L].encode(), np.uint8)
            reads[i] = (np.searchsorted(np.frombuffer(b"ACGT", np.uint8),
                                        reads[i])).astype(np.uint8)
    out = eng(reads)

    # single-process oracle (local single-chip engine on shard-1 index)
    idx1 = build_index(genome, n_shards=1)
    oracle = SingleChipEngine(idx1, build_panel_mask(idx1, panel_rows),
                              DecisionParams())
    want = [np.asarray(x) for x in oracle.decide(reads)]

    for got_g, want_full in zip(out, want):
        for shard in got_g.addressable_shards:
            lo = shard.index[0].start or 0
            got = np.asarray(shard.data)
            np.testing.assert_array_equal(got, want_full[lo:lo + len(got)])

    # --- (3) sp halo-exchange window scan across processes --------------
    from cornetto_tpu.dist.scan import make_sharded_sliding_sum
    W = 64
    n = 256 * n_global
    depth = np.zeros(n, dtype=np.int32)
    depth[:n - W] = (np.arange(n - W) * 7) % 101
    mesh_sp = Mesh(np.array(jax.devices()), ("sp",))
    fn = make_sharded_sliding_sum(mesh_sp, W)
    got_g = fn(jax.device_put(depth, NamedSharding(mesh_sp, P("sp"))))
    # forward sums over x[i:i+W] with implicit zero padding past n
    want_sum = np.convolve(depth, np.ones(W, np.int64))[W - 1:n + W - 1] \
        .astype(np.int64)
    for shard in got_g.addressable_shards:
        lo = shard.index[0].start or 0
        got = np.asarray(shard.data)
        np.testing.assert_array_equal(got.astype(np.int64),
                                      want_sum[lo:lo + len(got)])

    print("proc %d/%d OK" % (proc_id, num_procs))
    return 0


if __name__ == "__main__":
    sys.exit(main())
