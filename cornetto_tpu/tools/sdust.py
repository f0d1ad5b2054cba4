"""sdust CLI (reference: src/sdust/sdust.c:179-207).

Contigs are masked on a thread pool (the native DP is a ctypes call and
releases the GIL), with a bounded in-flight window so memory stays at
O(workers) contigs; rows are written in FASTA order, byte-identical to the
serial run.  The reference's sdust is single-threaded — its pthread pool
(src/thread.c:48-156) is never wired to any subcommand."""

import os
import sys
from collections import deque
from concurrent.futures import ThreadPoolExecutor

from cornetto_tpu.io.fasta import read_fastx
from cornetto_tpu.native.sdust import sdust


def run(fasta_path: str, T: int = 20, W: int = 64, out=None,
        workers: int = None) -> None:
    """The native DP on a thread pool of `workers` (default: all cores)."""
    out = out or sys.stdout
    nw = workers or os.cpu_count() or 1

    def _mask(item):
        name, seq = item
        return name, sdust(seq.encode("latin-1"), T=T, W=W)

    def _emit(fut_name_ivals):
        name, ivals = fut_name_ivals.result()
        if ivals:
            out.write("".join("%s\t%d\t%d\n" % (name, a, b)
                              for a, b in ivals))

    with ThreadPoolExecutor(max_workers=nw) as ex:
        inflight = deque()
        for rec in read_fastx(fasta_path):
            inflight.append(ex.submit(_mask, (rec.name, rec.seq)))
            while len(inflight) > 2 * nw:
                _emit(inflight.popleft())
        while inflight:
            _emit(inflight.popleft())


def main(argv) -> int:
    from cornetto_tpu.utils.parsing import c_atoi
    W, T = 64, 20
    args = []
    i = 0
    while i < len(argv):
        a = argv[i]
        if a == "-w":
            W = c_atoi(argv[i + 1]); i += 2
        elif a.startswith("-w"):
            W = c_atoi(a[2:]); i += 1
        elif a == "-t":
            T = c_atoi(argv[i + 1]); i += 2
        elif a.startswith("-t"):
            T = c_atoi(a[2:]); i += 1
        elif a.startswith("--backend"):
            backend = a.split("=", 1)[1] if "=" in a else argv[i + 1]
            i += 1 if "=" in a else 2
            if backend != "host":
                # the SDUST DP has no GPU kernel (a sequential DP with
                # data-dependent evictions; see ROADMAP.md)
                sys.stderr.write("Error: sdust --backend %s is not "
                                 "available: the DP runs on the host only "
                                 "(--backend host, the default)\n"
                                 % backend)
                return 1
        else:
            args.append(a); i += 1
    if not args:
        sys.stderr.write("Usage: sdust [-w %d] [-t %d] "
                         "[--backend host] <in.fa>\n" % (W, T))
        return 1
    run(args[0], T=T, W=W)
    return 0
