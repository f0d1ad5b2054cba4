"""`cornetto` CLI dispatcher (reference: src/main.c:56-152) — same subcommand
tree, usage text shape, and end-of-run Real time / CPU time / Peak RAM
footer."""

import sys

from cornetto_tpu.utils import timing
from cornetto_tpu.utils.device import use_compile_cache
from cornetto_tpu.version import __version__


def print_usage(fp) -> int:
    fp.write("Usage: cornetto <command> [options]\n\n")
    fp.write("commands:\n")
    fp.write("   create panel:\n")
    fp.write("       noboringbits    print no boring bits in an assembly\n")
    fp.write("       bigenough       find contigs that have sufficient boring bits\n")
    fp.write("   dotplot:\n")
    fp.write("       fixasm          fix the direction of contigs in an assembly\n")
    fp.write("       minidot         create dot plot (from https://github.com/lh3/miniasm)\n")
    fp.write("   eval:\n")
    fp.write("       asmstats        calculate assembly statistics\n")
    fp.write("       nx              nx or ngx plot tables\n")
    fp.write("       report          generate a report table for one or more assemblies\n")
    fp.write("       telocontigs     prints contigs from largest to smallest with number of telomeres\n")
    fp.write("   telo:\n")
    fp.write("       telowin         analyse telomere windows in a fasta file\n")
    fp.write("       telobreaks      find telomere breaks in a fasta file\n")
    fp.write("       telofind        find telomere sequences in a fasta file\n")
    fp.write("       sdust           symmetric DUST (https://github.com/lh3/sdust)\n")
    fp.write("   misc:\n")
    fp.write("       fa2bed          create a bed file with assembly contig lengths\n")
    fp.write("       seq             extract reads equal or longer than a threshold from a fastq\n")
    fp.write("   pipelines (replacements for the reference shell pipelines):\n")
    fp.write("       create-panel    create-cornetto pipeline (fa2bed+noboringbits+intervals+bigenough)\n")
    fp.write("       recreate-panel  recreate-cornetto pipeline\n")
    fp.write("       telostats       telomere statistics pipeline\n")
    fp.write("       livefish        real-time adaptive-sampling decision engine\n")
    fp.write("       flow            one-iteration orchestrator (align/cov+panel+telostats+index)\n")
    fp.write("       flow-eval       evaluation chain: minidotplot+telostats+asmstats+quast/compleasm/yak\n")
    fp.write("       flow-sv         SV concordance chain: dipcall -> >50bp filter -> truvari\n")
    fp.write("       flow-simplex    basecall->filter->assemble chain ([--duplex] for the legacy path)\n")
    fp.write("       gfa2fa          assembly graph S-lines to FASTA (gfatools gfa2fa stage)\n")
    fp.write("       depth           per-base BAM depth (working; the reference's is a skeleton)\n")
    fp.write("       bammerge        merge position-sorted BAMs (+ .bai)\n")
    fp.write("\n")
    fp.write("       --help, -h      print this help message\n")
    fp.write("       --version, -V   print version information\n")
    return 1 if fp is sys.stderr else 0


def main(argv=None) -> int:
    argv = list(sys.argv if argv is None else argv)
    realtime0 = timing.realtime()
    if len(argv) < 2:
        return print_usage(sys.stderr)
    cmd = argv[1]
    rest = argv[2:]
    ret = 1
    use_compile_cache()
    if cmd == "fixasm":
        from cornetto_tpu.tools import fixasm
        ret = fixasm.main(rest)
    elif cmd == "boringbits":
        from cornetto_tpu.tools import boringbits
        ret = boringbits.main(rest, boring=True)
    elif cmd == "noboringbits":
        from cornetto_tpu.tools import boringbits
        ret = boringbits.main(rest, boring=False)
    elif cmd == "telowin":
        from cornetto_tpu.tools import telowin
        ret = telowin.main(rest)
    elif cmd == "telobreaks":
        from cornetto_tpu.tools import telobreaks
        ret = telobreaks.main(rest)
    elif cmd == "telofind":
        from cornetto_tpu.tools import telofind
        ret = telofind.main(rest)
    elif cmd == "minidot":
        from cornetto_tpu.tools import minidot
        ret = minidot.main(rest)
    elif cmd == "bigenough":
        from cornetto_tpu.tools import bigenough
        ret = bigenough.main(rest)
    elif cmd == "sdust":
        from cornetto_tpu.tools import sdust
        ret = sdust.main(rest)
    elif cmd == "fa2bed":
        from cornetto_tpu.tools import fa2bed
        ret = fa2bed.main(rest)
    elif cmd == "seq":
        from cornetto_tpu.tools import seq
        ret = seq.main(rest)
    elif cmd == "asmstats":
        from cornetto_tpu.tools import asmstats
        ret = asmstats.main(rest)
    elif cmd == "nx":
        from cornetto_tpu.tools import nx
        ret = nx.main(rest)
    elif cmd == "report":
        from cornetto_tpu.tools import report
        ret = report.main(rest)
    elif cmd == "telocontigs":
        from cornetto_tpu.tools import telocontigs
        ret = telocontigs.main(rest)
    elif cmd == "depth":
        from cornetto_tpu.tools import depth
        ret = depth.main(rest)
    elif cmd == "bammerge":
        from cornetto_tpu.tools import depth
        ret = depth.merge_main(rest)
    elif cmd == "create-panel":
        from cornetto_tpu.pipelines import create_cornetto
        ret = create_cornetto.main(rest)
    elif cmd == "recreate-panel":
        from cornetto_tpu.pipelines import recreate_cornetto
        ret = recreate_cornetto.main(rest)
    elif cmd == "telostats":
        from cornetto_tpu.pipelines import telostats
        ret = telostats.main(rest)
    elif cmd == "minidotplot":
        from cornetto_tpu.pipelines import minidotplot
        ret = minidotplot.main(rest)
    elif cmd == "hapnetto":
        from cornetto_tpu.pipelines import hapnetto
        ret = hapnetto.main(rest)
    elif cmd == "refine":
        from cornetto_tpu.pipelines import refine
        ret = refine.main(rest)
    elif cmd == "asmstats-pipeline":
        from cornetto_tpu.pipelines import asmstats_sh
        ret = asmstats_sh.main(rest)
    elif cmd == "flow":
        from cornetto_tpu.flow import runner
        ret = runner.main(rest)
    elif cmd == "flow-eval":
        from cornetto_tpu.flow import evaljobs
        ret = evaljobs.eval_main(rest)
    elif cmd == "flow-sv":
        from cornetto_tpu.flow import evaljobs
        ret = evaljobs.sv_main(rest)
    elif cmd == "flow-simplex":
        from cornetto_tpu.flow import simplex
        ret = simplex.main(rest)
    elif cmd == "gfa2fa":
        from cornetto_tpu.io import gfa
        ret = gfa.main(rest)
    elif cmd == "livefish":
        from cornetto_tpu.livefish import cli as livefish_cli
        ret = livefish_cli.main(rest)
    elif cmd in ("--version", "-V"):
        sys.stdout.write("cornetto-tpu %s\n" % __version__)
        return 0
    elif cmd in ("--help", "-h"):
        return print_usage(sys.stdout)
    else:
        sys.stderr.write("[cornetto] Unrecognised command %s\n" % cmd)
        return print_usage(sys.stderr)

    timing.print_footer(__version__, argv[1:], realtime0)
    return ret


if __name__ == "__main__":
    sys.exit(main())
