#!/usr/bin/env python3
"""Proof that cornetto-tpu's device paths run end to end on an NVIDIA GPU.

    python chip_smoke.py [--genome-mbp 3100] [--seed 0]   # one card
    python chip_smoke.py --multi [--genome-mbp 500]       # four cards

One card runs four phases through the program's own CLI entry points, each
compared with a plain reference; any mismatch exits non-zero:

1. livefish at human scale: `livefish index` on a seeded synthetic draft
   (about 300 contigs with heavy-tailed lengths, the largest chr1-sized,
   telomeric repeats at some contig ends) with a panel BED over the middle
   half of each contig, then `livefish run` on 65,536 reads (half from
   panel regions, a quarter from non-panel regions, a quarter random).
   The GPU's rows for the first 16,384 reads must equal the same engine
   run on the CPU, and every read the engine anchors at its true origin
   must be rejected exactly when the panel covers it.
2. read-until on device: `livefish replay --state device` and
   `--state host` at 512 channels (448-base chunks: the device state
   needs a multiple of 4) print identical metric lines.
3. panel chain: `noboringbits --backend jax` and `--backend numpy` on
   seeded 1-bp coverage tracks of a chr1-sized contig are byte-identical.
4. telofind: `--backend device` and `--backend host` on the draft's
   largest contig are byte-identical.

--multi runs only the sharded livefish engine on four cards (dp=4 x ep=1
and dp=2 x ep=2, the index built with n_shards=ep) and checks decisions,
hit counts and positions against one card.

Early lines name the card (nvidia-smi name and power limit), the device
kind and the JAX version; the last line of stdout is one JSON object,
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
With no GPU the script exits non-zero before any phase.  Work files live in
tmp_chip_smoke/ beside this script and are removed at exit.
"""

import argparse
import contextlib
import io
import json
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
CHR1_BP = 248_956_422
ACGT = np.frombuffer(b"ACGT", dtype=np.uint8)
READ_LEN = 450
TELO_COPIES = 1000          # 6 kb of (TTAGGG)n / (CCCTAA)n at contig ends
END_MARGIN = 10_000         # non-panel reads stay clear of telomeric ends
PANEL_MARGIN = 2_000        # reads stay clear of panel borders


class SmokeError(Exception):
    pass


def check(cond, msg: str) -> None:
    if not cond:
        raise SmokeError(msg)


def log(msg: str) -> None:
    print(msg, flush=True)


def cli(*argv, stdout_path=None) -> str:
    """Run `cornetto <argv>` in-process; return its stdout (or write it to
    stdout_path and return "")."""
    from cornetto_tpu.cli import main
    buf = open(stdout_path, "w") if stdout_path else io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(["cornetto", *[str(a) for a in argv]])
    text = "" if stdout_path else buf.getvalue()
    buf.close()
    check(rc == 0, "cornetto %s exited %s" % (" ".join(map(str, argv)), rc))
    return text


# ---------------------------------------------------------------- inputs

class Draft:
    """A seeded synthetic draft assembly: contig codes (0..3), FASTA and a
    panel BED over the middle half of every contig."""

    def __init__(self, work: Path, genome_mbp: float, seed: int):
        rng = np.random.default_rng(seed)
        total = int(genome_mbp * 1e6)
        n = int(min(300, max(total // 200_000, 4)))
        big = min(CHR1_BP, total * 2 // 5)
        w = rng.lognormal(0.0, 1.5, n - 1)
        rest = np.maximum((w / w.sum() * (total - big)).astype(np.int64),
                          50_000)
        self.lens = [big] + sorted(np.minimum(rest, big).tolist(),
                                   reverse=True)
        self.names = ["ctg%03d" % i for i in range(n)]
        tel_l = np.tile(np.array([1, 1, 1, 2, 0, 0], np.uint8), TELO_COPIES)
        tel_r = np.tile(np.array([3, 3, 0, 2, 2, 2], np.uint8), TELO_COPIES)
        self.codes = []
        self.fasta = work / "draft.fa"
        with open(self.fasta, "wb") as f:
            for i, (name, ln) in enumerate(zip(self.names, self.lens)):
                c = rng.integers(0, 4, ln, dtype=np.uint8)
                if i % 3 == 0:
                    c[:len(tel_l)] = tel_l
                    c[-len(tel_r):] = tel_r
                self.codes.append(c)
                f.write(b">%s\n" % name.encode())
                f.write(ACGT[c].tobytes())
                f.write(b"\n")
        self.panel_bed = work / "panel.bed"
        with open(self.panel_bed, "w") as f:
            for name, ln in zip(self.names, self.lens):
                f.write("%s\t%d\t%d\n" % (name, ln // 4, 3 * ln // 4))

    @property
    def bp(self) -> int:
        return int(sum(self.lens))

    def reads(self, n: int, length: int, rng):
        """(codes (n, length) uint8, kind (n,) array of 'panel' /
        'nonpanel' / 'random', origin (n, 2) int64 of (contig, start), -1
        for random reads), shuffled: half panel, a quarter each of the
        rest."""
        lens = np.asarray(self.lens, dtype=np.float64)
        kinds = np.array(["panel"] * (n // 2) + ["nonpanel"] * (n // 4)
                         + ["random"] * (n - n // 2 - n // 4))
        rng.shuffle(kinds)
        out = rng.integers(0, 4, (n, length), dtype=np.uint8)
        origin = np.full((n, 2), -1, dtype=np.int64)
        # non-panel ranges [END_MARGIN, L/4 - m) need room for a read
        room = lens // 4 - PANEL_MARGIN - END_MARGIN > 2 * length
        for i in np.flatnonzero(kinds != "random"):
            ok = room if kinds[i] == "nonpanel" else np.ones_like(room)
            p = np.where(ok, lens, 0)
            j = int(rng.choice(len(lens), p=p / p.sum()))
            ln = self.lens[j]
            if kinds[i] == "panel":
                s = rng.integers(ln // 4 + PANEL_MARGIN,
                                 3 * ln // 4 - PANEL_MARGIN - length)
            elif rng.random() < 0.5:
                s = rng.integers(END_MARGIN, ln // 4 - PANEL_MARGIN - length)
            else:
                s = rng.integers(3 * ln // 4 + PANEL_MARGIN,
                                 ln - END_MARGIN - length)
            out[i] = self.codes[j][s:s + length]
            origin[i] = (j, s)
        return out, kinds, origin


def write_fastq(path: Path, codes: np.ndarray) -> None:
    qual = b"I" * codes.shape[1]
    seqs = ACGT[codes]
    with open(path, "wb") as f:
        f.write(b"".join(b"@r%d\n%s\n+\n%s\n" % (i, seqs[i].tobytes(), qual)
                         for i in range(len(codes))))


def coverage_tracks(n: int, rng):
    """Seeded 1-bp depth tracks: gamma-distributed 5 kb block levels with
    zero-coverage and collapsed (3x) blocks, per-base jitter, and a
    high-MAPQ track that loses most depth in 8% of blocks."""
    blk = 5000
    nb = -(-n // blk)
    level = rng.gamma(4.0, 7.5, nb)
    u = rng.random(nb)
    level[u < 0.04] = 0.0
    level[(u >= 0.04) & (u < 0.07)] *= 3.0
    depth = np.repeat(np.rint(level).astype(np.int64), blk)[:n]
    depth += rng.integers(-3, 4, n)
    np.clip(depth, 0, 65535, out=depth)
    keep = np.where(rng.random(nb) < 0.08, 3, 10)
    mq = depth * np.repeat(keep, blk)[:n] // 10
    return depth, mq


# ---------------------------------------------------------------- phases

def phase_livefish(work: Path, draft: Draft, n_reads: int, n_ref: int,
                   batch: int, rng) -> Path:
    """livefish index + run on the GPU; rows equal the CPU engine's on the
    first n_ref reads; reads mapped at their true origin are decided by
    the panel.  Returns the index path."""
    import jax
    from cornetto_tpu.dist.checkpoint import load_index
    from cornetto_tpu.livefish.decide import DecisionParams, SingleChipEngine
    from cornetto_tpu.livefish.stream import stream_decisions

    idx = work / "idx"
    t0 = time.perf_counter()
    cli("livefish", "index", draft.fasta, "-o", idx, "-p", draft.panel_bed)
    log("livefish index: %d contigs, %d bp in %.1f s"
        % (len(draft.lens), draft.bp, time.perf_counter() - t0))
    codes, kinds, origin = draft.reads(n_reads, READ_LEN, rng)
    fq, fq_ref = work / "reads.fq", work / "reads_ref.fq"
    write_fastq(fq, codes)
    write_fastq(fq_ref, codes[:n_ref])
    out = work / "run.tsv"
    t0 = time.perf_counter()
    cli("livefish", "run", idx, fq, "-b", batch, stdout_path=out)
    wall = time.perf_counter() - t0
    rows = out.read_text().splitlines()
    check(len(rows) == n_reads, "livefish run wrote %d rows for %d reads"
          % (len(rows), n_reads))
    log("livefish run: %d reads in %.3f s = %.1f decisions/s (CLI wall: "
        "index load, compile and stream)" % (n_reads, wall, n_reads / wall))

    # the same engine on the CPU: the pipeline is integer-only, so the
    # rows must be identical
    ix, panel, _ = load_index(str(idx))
    cpu = jax.devices("cpu")[0]
    ref = io.StringIO()
    with jax.default_device(cpu):
        eng = SingleChipEngine(ix, panel)
        check(eng._btable.devices() == {cpu}, "reference not on the CPU")
        eng.contig_names = ix.contig_names
        stream_decisions(eng, str(fq_ref), batch=batch, read_len=READ_LEN,
                         out=ref)
    ref_rows = ref.getvalue().splitlines()
    same = sum(a == b for a, b in zip(rows[:n_ref], ref_rows))
    check(len(ref_rows) == n_ref and same == n_ref,
          "GPU rows differ from the CPU engine: %d of %d equal"
          % (same, n_ref))
    log("livefish run vs CPU engine: %d of %d rows identical" % (same, n_ref))

    # ground truth.  A genome read is ANCHORED when the engine maps it
    # (nhits >= min_hits) to its true contig at a position within one read
    # length of its middle; every anchored read must then be rejected
    # exactly when the panel covers it.  How many reads anchor, and how
    # random reads fare, is a property of the engine (k, min_hits, votes)
    # at this genome size, logged rather than asserted.
    f = [r.split("\t") for r in rows]
    proceed = np.array([x[1] == "proceed" for x in f])
    ctg_id = {name: i for i, name in enumerate(ix.contig_names)}
    ctg = np.array([ctg_id.get(x[2], -1) for x in f])
    pos = np.array([int(x[3]) for x in f])
    nhits = np.array([int(x[4]) for x in f])
    anchored = ((ctg == origin[:, 0]) & (origin[:, 0] >= 0)
                & (np.abs(pos - origin[:, 1] - READ_LEN // 2) <= READ_LEN)
                & (nhits >= DecisionParams().min_hits))
    for k in ("panel", "nonpanel", "random"):
        m = kinds == k
        log("%s reads: %d, proceed rate %.5f, anchored %.5f"
            % (k, int(m.sum()), float(proceed[m].mean()),
               float(anchored[m].mean())))
    want = kinds == "nonpanel"
    wrong = anchored & (proceed != want)
    check(not wrong.any(), "%d anchored reads decided against the panel"
          % int(wrong.sum()))
    for k in ("panel", "nonpanel"):
        check(anchored[kinds == k].mean() >= 0.1,
              "fewer than 10%% of %s reads anchored" % k)
    check(proceed[kinds == "random"].mean()
          > proceed[kinds == "panel"].mean(),
          "random reads were rejected as often as panel reads")
    return idx


def phase_replay(work: Path, draft: Draft, idx: Path, n_reads: int,
                 length: int, rng) -> None:
    codes, _, _ = draft.reads(n_reads, length, rng)
    fq = work / "replay.fq"
    write_fastq(fq, codes)
    res = {}
    for state in ("device", "host"):
        t0 = time.perf_counter()
        # --state device packs chunks 4 bases to a byte, so it needs a
        # chunk length divisible by 4: 448 instead of the CLI's 450
        res[state] = cli("livefish", "replay", idx, fq, "--state", state,
                         "-c", 448)
        log("livefish replay --state %s: %d reads in %.3f s"
            % (state, n_reads, time.perf_counter() - t0))
    check(res["device"] == res["host"],
          "replay metrics differ:\n%s\nvs\n%s" % (res["device"], res["host"]))
    check("reads\t%d\n" % n_reads in res["device"], "replay lost reads")
    log("livefish replay device == host: "
        + res["device"].strip().replace("\n", "; "))


def phase_panel(work: Path, n_bp: int, rng) -> None:
    from cornetto_tpu.native.depth_write import write_rows
    depth, mq = coverage_tracks(n_bp, rng)
    tot, mqp = work / "cov-total.bg", work / "cov-mq20.bg"
    write_rows(str(tot), "chr1", depth)
    write_rows(str(mqp), "chr1", mq)
    del depth, mq
    res = {}
    for backend in ("jax", "numpy"):
        t0 = time.perf_counter()
        res[backend] = cli("noboringbits", tot, "-q", mqp, "--backend",
                           backend)
        log("noboringbits --backend %s: %d bp in %.3f s"
            % (backend, n_bp, time.perf_counter() - t0))
    check(res["jax"] == res["numpy"], "noboringbits jax != numpy")
    check(res["jax"].count("\n") > 0, "noboringbits found no windows")
    log("noboringbits jax == numpy: %d rows" % res["jax"].count("\n"))


def phase_telofind(work: Path, draft: Draft) -> None:
    fa = work / "largest.fa"
    with open(fa, "wb") as f:
        f.write(b">%s\n%s\n" % (draft.names[0].encode(),
                                ACGT[draft.codes[0]].tobytes()))
    res = {}
    for backend in ("device", "host"):
        t0 = time.perf_counter()
        res[backend] = cli("telofind", fa, "--backend", backend)
        log("telofind --backend %s: %d bp in %.3f s"
            % (backend, draft.lens[0], time.perf_counter() - t0))
    check(res["device"] == res["host"], "telofind device != host")
    check(res["device"].count("\n") >= 2, "telofind found no runs")
    log("telofind device == host: %d rows" % res["device"].count("\n"))


def one_device_decisions(ix, panel, packed, device):
    """Plain one-device reference for an index of any shard count: every
    query hash is looked up in the shard that owns it (its low log2(E)
    bits) and the per-contig stats are summed over shards."""
    import jax
    import jax.numpy as jnp
    from cornetto_tpu.kernels.minimizer import (read_minimizers_jax,
                                                unpack_reads_jax)
    from cornetto_tpu.livefish.decide import (DecisionParams, _lookup_votes,
                                              decision_from_stats)
    prm = DecisionParams()

    def step(btable, packed, panel):
        nmask = jnp.zeros((packed.shape[0], -(-READ_LEN // 8)), jnp.uint8)
        _, h, valid = read_minimizers_jax(
            unpack_reads_jax(packed, nmask, READ_LEN), k=ix.k, w=ix.w,
            want_pos=False)
        E = btable.shape[0]
        total = None
        for e in range(E):
            own = valid & ((h & jnp.uint32(E - 1)) == e)
            st = _lookup_votes(btable[e], ix.bucket_shift, h, own,
                               panel.shape[0], ix.two_choice)
            total = st if total is None else [a + b
                                              for a, b in zip(total, st)]
        return decision_from_stats(total, panel, prm.min_hits, prm.bin_size)

    with jax.default_device(device):
        out = jax.jit(step)(jnp.asarray(ix.btable), jnp.asarray(packed),
                            jnp.asarray(panel))
    return [np.asarray(a) for a in out]


def phase_multi(work: Path, draft: Draft, n_reads: int, devices,
                rng) -> None:
    """The sharded engine on four devices at dp=4 x ep=1 and dp=2 x ep=2
    equals one device on every output.  Each run is compared with one
    device over the SAME index: the 1- and 2-shard tables drop different
    bucket-overflow entries, so their decisions may legitimately differ."""
    from cornetto_tpu.dist.checkpoint import load_index
    from cornetto_tpu.dist.mesh import make_mesh
    from cornetto_tpu.kernels.minimizer import pack_reads
    from cornetto_tpu.livefish.decide import (SingleChipEngine,
                                              make_sharded_engine)
    check(len(devices) >= 4, "--multi needs four devices")
    codes, _, _ = draft.reads(n_reads, READ_LEN, rng)
    packed, _ = pack_reads(codes)
    names = ("decision", "best_contig", "est_pos", "nhits", "nhits_hq",
             "est_pos2")

    def same(tag, got, ref):
        for nm, a, b in zip(names, got, ref):
            check(np.array_equal(a, b), "%s: %s differs on %d of %d reads"
                  % (tag, nm, int((a != b).sum()), a.size))
        log("%s: equal on %s" % (tag, ", ".join(names)))

    for dp, ep in ((4, 1), (2, 2)):
        path = work / ("idx_ep%d" % ep)
        t0 = time.perf_counter()
        cli("livefish", "index", draft.fasta, "-o", path, "-s", ep,
            "-p", draft.panel_bed)
        log("livefish index -s %d: %.1f s" % (ep, time.perf_counter() - t0))
        ix, panel, _ = load_index(str(path))
        ref = one_device_decisions(ix, panel, packed, devices[0])
        if ep == 1:
            eng = SingleChipEngine(ix, panel)
            same("one-device reference vs SingleChipEngine", [
                np.asarray(a)
                for a in eng.decide_packed(packed, None, READ_LEN)], ref)
        t0 = time.perf_counter()
        mesh = make_mesh({"dp": dp, "ep": ep}, devices[:4])
        got = [np.asarray(a) for a in make_sharded_engine(
            mesh, ix, panel).decide_packed(packed, None, READ_LEN)]
        log("sharded decide dp=%d ep=%d: %d reads in %.3f s (incl. compile)"
            % (dp, ep, n_reads, time.perf_counter() - t0))
        same("dp=%d x ep=%d vs one device" % (dp, ep), got, ref)


# ---------------------------------------------------------------- main

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--multi", action="store_true",
                    help="four cards: the sharded livefish engine only")
    ap.add_argument("--genome-mbp", type=float, default=None,
                    help="draft size (default 3100, or 500 with --multi)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import jax
    # a CUDA plugin that fails to start must stop the run, not fall back
    jax.config.update("jax_platforms", "cuda,cpu")
    from cornetto_tpu.utils.device import use_compile_cache
    devices = jax.devices()
    if devices[0].platform != "gpu":
        sys.stderr.write("chip_smoke: no GPU (first device: %s)\n"
                         % devices[0].platform)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    for line in smi.stdout.strip().splitlines():
        log("card: %s" % line)
    log("device_kind: %s, count: %d, jax %s"
        % (devices[0].device_kind, len(devices), jax.__version__))
    log("compile cache: %s" % use_compile_cache())

    work = HERE / "tmp_chip_smoke"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir()
    rng = np.random.default_rng(args.seed + 1)
    t_all = time.perf_counter()
    try:
        mbp = args.genome_mbp or (500.0 if args.multi else 3100.0)
        t0 = time.perf_counter()
        draft = Draft(work, mbp, args.seed)
        log("draft: %d contigs, %d bp, largest %d bp in %.1f s"
            % (len(draft.lens), draft.bp, draft.lens[0],
               time.perf_counter() - t0))
        if args.multi:
            phase_multi(work, draft, 65_536, devices, rng)
        else:
            idx = phase_livefish(work, draft, 65_536, 16_384, 16_384, rng)
            phase_replay(work, draft, idx, 4_096, 2_000, rng)
            phase_panel(work, min(CHR1_BP, draft.lens[0]), rng)
            phase_telofind(work, draft)
    except SmokeError as e:
        sys.stderr.write("chip_smoke FAILED: %s\n" % e)
        return 1
    finally:
        shutil.rmtree(work, ignore_errors=True)
    log("all phases passed in %.1f s" % (time.perf_counter() - t_all))
    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform, "kind": devices[0].device_kind,
        "count": len(devices)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
