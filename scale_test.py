#!/usr/bin/env python3
"""Large-input scale test (BASELINE configs[2]/[3] shape): synthesizes a
multi-contig genome with depth tracks, runs the full panel + evaluation +
livefish chain, and (when the reference binary is available at $CORNETTO_C)
diffs the tool outputs byte-for-byte.

Not part of the CI suite (minutes of runtime); run manually:
    python3 scale_test.py [--mbp 50] [--workdir /tmp/scale]
"""

import argparse
import io
import os
import subprocess
import sys
import time

import numpy as np


def log(msg):
    sys.stderr.write("[scale] %s\n" % msg)


def _build_gen_track() -> str:
    here = os.path.dirname(os.path.abspath(__file__))
    src = os.path.join(here, "test_data", "gen_track.c")
    exe = os.path.join(here, "test_data", "_gen_track")
    if (not os.path.exists(exe)
            or os.path.getmtime(exe) < os.path.getmtime(src)):
        subprocess.run(["cc", "-O2", src, "-lz", "-o", exe], check=True)
    return exe


def gen(workdir: str, mbp: float, gz: bool = False):
    rng = np.random.default_rng(50)
    total = int(mbp * 1e6)
    lens = []
    while sum(lens) < total:
        lens.append(int(rng.integers(400_000, 9_000_000)))
    os.makedirs(workdir, exist_ok=True)
    fa = os.path.join(workdir, "asm.fasta")
    t0 = time.time()
    acgt = np.frombuffer(b"ACGT", dtype=np.uint8)
    with open(fa, "wb") as f:
        for i, ln in enumerate(lens):
            f.write(b">ptg%06dl\n" % i)
            # bytes path: ~50x the '<U1'-join rate (matters at 3 Gbp)
            s = acgt[rng.integers(0, 4, ln, dtype=np.int64)].tobytes()
            if i % 3 == 0:
                s = b"TTAGGG" * 300 + s + b"CCCTAA" * 300
            body = np.frombuffer(s, dtype=np.uint8)
            pad = -len(body) % 80
            nrows = (len(body) + pad) // 80
            flat = np.zeros(nrows * 80, dtype=np.uint8)
            flat[:len(body)] = body
            wrapped = np.empty((nrows, 81), dtype=np.uint8)
            wrapped[:, :80] = flat.reshape(nrows, 80)
            wrapped[:, 80] = ord("\n")
            out = wrapped.tobytes()
            if pad:
                # drop the pad cells of the final row (keep its newline)
                out = out[:-(pad + 1)] + b"\n"
            f.write(out)
    log("fasta %.1f Mbp in %.0fs" % (sum(lens) / 1e6, time.time() - t0))
    t0 = time.time()
    # native row generator (test_data/gen_track.c): pandas-side row
    # generation tops out around 15 MB/s — a 3 Gbp track is ~60 GB of
    # text.  Same seed => same depth walk, so mq <= total everywhere.
    exe = _build_gen_track()
    lens_path = os.path.join(workdir, "lens.tsv")
    with open(lens_path, "w") as f:
        for i, ln in enumerate(lens):
            ln_eff = ln + (3600 if i % 3 == 0 else 0)
            f.write("ptg%06dl\t%d\n" % (i, ln_eff))
    ext = ".gz" if gz else ""
    procs = [subprocess.Popen(
        [exe, lens_path, os.path.join(workdir, "asm" + suffix + ext),
         "50", str(jitter)])
        for suffix, jitter in ((".cov-total.bg", 0), (".cov-mq20.bg", 2))]
    for pr in procs:
        assert pr.wait() == 0
    if gz:
        # the framework's loaders sniff gzip by magic bytes, so gz content
        # can carry the pipeline's plain .bg names (a 3 Gbp plain track is
        # ~63 GB of text x2 — more than this box's disk)
        for suffix in (".cov-total.bg", ".cov-mq20.bg"):
            os.replace(os.path.join(workdir, "asm" + suffix + ext),
                       os.path.join(workdir, "asm" + suffix))
    log("bedgraphs%s in %.0fs" % (" (gz)" if gz else "", time.time() - t0))
    with open(os.path.join(workdir, "asm.bp.p_ctg.lowQ.bed"), "w") as f:
        for i, ln in enumerate(lens):
            for _ in range(3):
                a = int(rng.integers(0, max(ln - 50000, 1)))
                f.write("ptg%06dl\t%d\t%d\n" % (i, a, a + 20000))


_FOOTER_RE = None


def _run_footer(argv, stdout_path=None, env=None):
    """Run a subprocess whose stderr footer reports its own peak RSS (both
    our CLI and the reference binary print '... Peak RAM: X GB'); returns
    (wall_s, peak_gb, stderr_text)."""
    import re
    t0 = time.time()
    so = open(stdout_path, "w") if stdout_path else subprocess.DEVNULL
    try:
        p = subprocess.run(argv, stdout=so, stderr=subprocess.PIPE,
                           env=env, text=True)
    finally:
        if stdout_path:
            so.close()
    wall = time.time() - t0
    if p.returncode != 0:
        sys.stderr.write(p.stderr)
        raise RuntimeError("command failed: %s" % argv)
    m = None
    for m in re.finditer(r"Peak RAM:\s*([0-9.]+)\s*GB", p.stderr):
        pass
    return wall, float(m.group(1)) if m else None, p.stderr


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--mbp", type=float, default=50)
    ap.add_argument("--workdir", default="/tmp/scale")
    ap.add_argument("--gz", action="store_true",
                    help="gz-content coverage tracks under plain .bg "
                         "names (3 Gbp plain tracks exceed this disk); "
                         "the reference binary cannot read these, so the "
                         "oracle diff is skipped")
    ap.add_argument("--json", default=None,
                    help="write stage wall-clock/RSS results to this file")
    ap.add_argument("--skip-gen", action="store_true")
    ap.add_argument("--only", default=None,
                    help="comma list of stages to run (default all); "
                         "others keep their values from an existing "
                         "--json file")
    ap.add_argument("--ref-bin",
                    default=os.environ.get("CORNETTO_C",
                                           "/tmp/refsrc/cornetto"))
    args = ap.parse_args()
    wd = args.workdir
    repo = os.path.dirname(os.path.abspath(__file__))
    results = {"mbp": args.mbp, "gz_tracks": args.gz, "stages": {}}
    only = set(args.only.split(",")) if args.only else None
    if only and args.json:
        import json as _json
        path = args.json if os.path.isabs(args.json) \
            else os.path.join(repo, args.json)
        if os.path.exists(path):
            results = _json.load(open(path))

    def want(stage):
        return only is None or stage in only

    def flush_json():
        # checkpoint after every stage so an interrupted run still
        # leaves the completed-stage numbers on disk
        if args.json:
            import json
            path = args.json if os.path.isabs(args.json) \
                else os.path.join(repo, args.json)
            with open(path, "w") as f:
                json.dump(results, f, indent=1)
    if not args.skip_gen:
        t0 = time.time()
        gen(wd, args.mbp, gz=args.gz)
        results["stages"]["generate"] = {"wall_s": round(time.time() - t0,
                                                         1)}
        flush_json()
    os.chdir(wd)
    results["track_bytes_on_disk"] = (
        os.path.getsize("asm.cov-total.bg")
        + os.path.getsize("asm.cov-mq20.bg"))

    # the hot tool, our CLI as its own process so the footer RSS is clean.
    # PYTHONPATH resolves the package from the workdir CWD; JAX_PLATFORMS
    # pins jax to the CPU (the host-path baseline)
    cli = [sys.executable, "-m", "cornetto_tpu.cli"]
    env = dict(os.environ, PYTHONPATH=repo, JAX_PLATFORMS="cpu")
    if want("noboringbits"):
        wall, rss, _ = _run_footer(
            cli + ["noboringbits", "asm.cov-total.bg",
                   "-q", "asm.cov-mq20.bg"],
            stdout_path="my_fun.txt", env=env)
        log("our noboringbits %.1fs peakRSS %s GB" % (wall, rss))
        results["stages"]["noboringbits_ours"] = {"wall_s": round(wall, 1),
                                                  "peak_rss_gb": rss}
        flush_json()

    if want("noboringbits_lowmem"):
        # forced two-pass streaming (auto only engages for plain text;
        # at 3 Gbp gz this pays the inflate twice to run a whole human
        # genome in ~the largest contig of RAM)
        wall, rss, _ = _run_footer(
            cli + ["noboringbits", "asm.cov-total.bg",
                   "-q", "asm.cov-mq20.bg", "--low-mem"],
            stdout_path="my_fun_lowmem.txt", env=env)
        same = (os.path.exists("my_fun.txt")
                and open("my_fun_lowmem.txt").read()
                == open("my_fun.txt").read())
        log("our noboringbits --low-mem %.1fs peakRSS %s GB identical=%s"
            % (wall, rss, same))
        results["stages"]["noboringbits_ours_lowmem"] = {
            "wall_s": round(wall, 1), "peak_rss_gb": rss,
            "identical_to_default_mode": same}
        flush_json()
        assert same or not os.path.exists("my_fun.txt")

    if want("noboringbits_bgzf"):
        # bgzip'd tracks: BGZF's independent <=64 KiB members inflate
        # across threads (io/bgzf.py), where the gzip FORMAT serializes
        # each stream.  On this 2-core box both cores are already busy
        # (two tracks load concurrently), so little wall gain is
        # expected HERE — the datapoint pins that the path works at
        # scale; real nodes with cores > tracks see the parallelism.
        sys.path.insert(0, repo)
        from cornetto_tpu.io.bgzf import BgzfWriter
        import gzip as _gzip
        t0 = time.time()
        for suffix in (".cov-total", ".cov-mq20"):
            src, dst = "asm%s.bg" % suffix, "asm%s.bgzf.bg" % suffix
            if not os.path.exists(dst):
                opener = (_gzip.open if
                          open(src, "rb").read(2) == b"\x1f\x8b"
                          else open)
                with opener(src, "rb") as fin, \
                        BgzfWriter(dst, level=2) as w:
                    while True:
                        chunk = fin.read(1 << 24)
                        if not chunk:
                            break
                        w.write(chunk)
        recompress_s = round(time.time() - t0, 1)
        wall, rss, _ = _run_footer(
            cli + ["noboringbits", "asm.cov-total.bgzf.bg",
                   "-q", "asm.cov-mq20.bgzf.bg"],
            stdout_path="my_fun_bgzf.txt", env=env)
        same = (os.path.exists("my_fun.txt")
                and open("my_fun_bgzf.txt").read()
                == open("my_fun.txt").read())
        log("our noboringbits BGZF %.1fs peakRSS %s GB identical=%s"
            % (wall, rss, same))
        results["stages"]["noboringbits_bgzf"] = {
            "wall_s": round(wall, 1), "peak_rss_gb": rss,
            "recompress_gz_to_bgzf_s": recompress_s,
            "bgzf_bytes_on_disk": (
                os.path.getsize("asm.cov-total.bgzf.bg")
                + os.path.getsize("asm.cov-mq20.bgzf.bg")),
            "host_cores": os.cpu_count(),
            "identical_to_plain_mode": same}
        flush_json()
        assert same or not os.path.exists("my_fun.txt")

    # oracle diff for the hot tool (plain-text tracks only: the reference
    # fscanf-parses, /root/reference/src/boringbits_main.c:184-214)
    if want("reference") and os.path.exists(args.ref_bin) and not args.gz:
        wall, rss, _ = _run_footer(
            [args.ref_bin, "noboringbits", "asm.cov-total.bg",
             "-q", "asm.cov-mq20.bg"], stdout_path="ref_fun.txt")
        log("reference noboringbits %.1fs peakRSS %s GB" % (wall, rss))
        results["stages"]["noboringbits_reference_C"] = {
            "wall_s": round(wall, 1), "peak_rss_gb": rss}
        same = open("ref_fun.txt").read() == open("my_fun.txt").read()
        log("noboringbits outputs identical: %s" % same)
        results["noboringbits_byte_identical_vs_reference"] = same
        flush_json()
        assert same

    if want("create_panel"):
        if os.path.isdir("tmp_create_cornetto"):
            import shutil
            shutil.rmtree("tmp_create_cornetto")
        wall, rss, stderr_txt = _run_footer(
            cli + ["create-panel", "asm.fasta", "--backend=numpy"],
            env=env)
        panel_rows = sum(1 for _ in open("asm.boringbits.bed"))
        log("create-panel %.1fs peakRSS %s GB -> %d rows"
            % (wall, rss, panel_rows))
        import re as _re
        # "peak RSS so far" = ru_maxrss at stage end, footer units (GiB):
        # a monotone running peak, NOT a per-stage peak — so every value
        # here is <= the stage's peak_rss_gb by construction
        breakdown = {m.group(1): {"wall_s": float(m.group(2)),
                                  "peak_rss_so_far_gb": float(m.group(3))}
                     for m in _re.finditer(
                         r"panel-stage (\S+): ([0-9.]+) s "
                         r"\(peak RSS so far ([0-9.]+) GB\)", stderr_txt)}
        results["stages"]["create_panel"] = {"wall_s": round(wall, 1),
                                             "peak_rss_gb": rss,
                                             "panel_rows": panel_rows,
                                             "breakdown": breakdown}
        flush_json()

    if want("create_panel_lowmem"):
        # --low-mem routes the fun-windows stage through the two-pass
        # streaming scan (peak = largest contig, not both whole-genome
        # tracks); byte-identity vs the default-mode panel is asserted
        import shutil
        have_default = os.path.exists("asm.boringbits.bed")
        if have_default:
            shutil.copyfile("asm.boringbits.bed", "asm.boringbits.ref.bed")
            shutil.copyfile("asm.boringbits.txt", "asm.boringbits.ref.txt")
        if os.path.isdir("tmp_create_cornetto"):
            shutil.rmtree("tmp_create_cornetto")
        wall, rss, stderr_txt = _run_footer(
            cli + ["create-panel", "asm.fasta", "--backend=numpy",
                   "--low-mem"], env=env)
        import re as _re
        breakdown = {m.group(1): {"wall_s": float(m.group(2)),
                                  "peak_rss_so_far_gb": float(m.group(3))}
                     for m in _re.finditer(
                         r"panel-stage (\S+): ([0-9.]+) s "
                         r"\(peak RSS so far ([0-9.]+) GB\)", stderr_txt)}
        same = (have_default
                and open("asm.boringbits.bed").read()
                == open("asm.boringbits.ref.bed").read()
                and open("asm.boringbits.txt").read()
                == open("asm.boringbits.ref.txt").read())
        log("create-panel --low-mem %.1fs peakRSS %s GB identical=%s"
            % (wall, rss, same))
        results["stages"]["create_panel_lowmem"] = {
            "wall_s": round(wall, 1), "peak_rss_gb": rss,
            "identical_to_default_mode": same, "breakdown": breakdown}
        flush_json()
        assert same or not have_default

    if want("telostats"):
        wall, rss, _ = _run_footer(cli + ["telostats", "asm.fasta"],
                                   env=env)
        log("telostats %.1fs peakRSS %s GB" % (wall, rss))
        results["stages"]["telostats"] = {"wall_s": round(wall, 1),
                                          "peak_rss_gb": rss}
        flush_json()

    if want("livefish_index"):
        wall, rss, _ = _run_footer(
            cli + ["livefish", "index", "asm.fasta", "-o", "asm.lfidx",
                   "-p", "asm.boringbits.bed"], env=env)
        # size of the on-device lookup table: read just the btable .npy
        # header out of the checkpoint (round-4 verdict item 4 tracks
        # table bytes <= 4.5 GB at 3 Gbp)
        import zipfile
        import numpy.lib.format as _nf
        with zipfile.ZipFile("asm.lfidx.npz") as zf, \
                zf.open("btable.npy") as f:
            shape, _fortran, dtype = _nf._read_array_header(
                f, _nf.read_magic(f))
        table_gb = float(np.prod(shape) * dtype.itemsize / 1e9)
        log("livefish index %.1fs peakRSS %s GB (device table %.2f GB)"
            % (wall, rss, table_gb))
        results["stages"]["livefish_index"] = {
            "wall_s": round(wall, 1), "peak_rss_gb": rss,
            "device_table_gb": round(table_gb, 2)}
        flush_json()
    if args.json:
        log("results -> %s" % args.json)
    log("OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
