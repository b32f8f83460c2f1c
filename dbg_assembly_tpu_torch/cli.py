"""Command line: the reference binaries' flags, plus --device.

    python -m dbg_assembly_tpu_torch kmerfreq -k 17 -m 1 reads.lib
    python -m dbg_assembly_tpu_torch debruijn_contig -k 31 -o prefix reads.lib
    python -m dbg_assembly_tpu_torch debruijn_contig --readout doubling ...

Flag letters match dbg_assembly_tpu's cli (kmerfreq as the workflow runs it,
test/01.clean_correct/work.sh:31; debruijn_contig as DBG_contig/main.cpp:
162-196).  --device cuda (the default) runs on the GPU and fails when
there is none; --device cpu runs the kernels' plain PyTorch versions.
"""

from __future__ import annotations

import argparse
import sys


def _device_flag(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the chop, sort and segment reductions run")


def _kmerfreq(argv):
    ap = argparse.ArgumentParser(prog="kmerfreq")
    ap.add_argument("-k", type=int, default=17)
    ap.add_argument("-m", type=int, default=1,
                    help="low frequency cutoff (bit set iff count > m)")
    ap.add_argument("-q", type=int, default=0,
                    help="quality cutoff: k-mer windows covering a base "
                         "with Phred quality < q are not counted")
    ap.add_argument("--qshift", type=int, default=33,
                    help="quality ASCII shift (Quality_shift convention, "
                         "clean_lowqual.cpp:26)")
    ap.add_argument("-f", type=int, default=1)
    _device_flag(ap)
    ap.add_argument("lib")
    a = ap.parse_args(argv)
    from .kmer import kmerfreq
    return kmerfreq.run(a.lib, ksize=a.k, low_freq_cutoff=a.m,
                        fmt="fq" if a.f == 1 else "fa", qual_cutoff=a.q,
                        qual_shift=a.qshift, device=a.device)


def _debruijn_contig(argv):
    ap = argparse.ArgumentParser(prog="debruijn_contig")
    ap.add_argument("-k", type=int, default=31)
    ap.add_argument("-r", type=int, default=250)
    ap.add_argument("-f", type=int, default=1)
    ap.add_argument("-o", default="output")
    ap.add_argument("-t", type=int, default=10)
    ap.add_argument("-i", type=float, default=1.0)
    ap.add_argument("-l", type=float, default=0.7)
    ap.add_argument("-e", type=int, default=10)
    ap.add_argument("-b", type=int, default=10000)
    ap.add_argument("-D", type=int, default=2)
    ap.add_argument("-T", type=int, default=1)
    ap.add_argument("-I", type=int, default=100)
    ap.add_argument("-P", type=float, default=3.0)
    ap.add_argument("-W", type=int, default=1)
    ap.add_argument("-C", type=int, default=100)
    ap.add_argument("-G", type=float, default=3.0)
    ap.add_argument("-B", type=int, default=1)
    ap.add_argument("-U", type=int, default=100)
    ap.add_argument("-L", type=float, default=0.1)
    ap.add_argument("-E", type=float, default=0.1)
    ap.add_argument("-M", type=int, default=125)
    ap.add_argument("--readout", choices=("exact", "doubling"),
                    default="exact",
                    help="contig extraction engine: 'exact' (the "
                    "byte-exact serial replay) or 'doubling' (bulk pruning "
                    "+ pointer-doubling chains on --device)")
    ap.add_argument("--mesh", type=int, default=0, metavar="N",
                    help="distributed contig stage over N devices (not "
                    "ported yet)")
    _device_flag(ap)
    ap.add_argument("lib")
    a = ap.parse_args(argv)
    from .contig import pipeline
    from .contig.refassemble import AssembleParams
    params = AssembleParams(
        ksize=a.k, kmer_freq_cutoff=a.D, init_hash_size=a.i,
        load_factor=a.l, is_remove_tip=bool(a.T), tip_len_cutoff=a.I,
        tip_depth_cutoff=a.P, is_remove_lowedge=bool(a.W),
        lowedge_len_cutoff=a.C, lowedge_depth_cutoff=a.G,
        is_remove_bubble=bool(a.B), bubble_len_cutoff=a.U,
        bubble_len_diff_rate=a.L, bubble_base_diff_rate=a.E,
        contig_len_cutoff=a.M)
    return pipeline.run(a.lib, a.o, ksize=a.k, fmt=a.f, max_read_len=a.r,
                        params=params, readout=a.readout,
                        log_stream=sys.stderr, log_threads=a.t,
                        log_buffer=a.b, log_doublings=a.e,
                        mesh_devices=a.mesh, device=a.device)


COMMANDS = {
    "kmerfreq": _kmerfreq,
    "debruijn_contig": _debruijn_contig,
}


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help"):
        print("usage: python -m dbg_assembly_tpu_torch <command> [args]\n"
              "commands: " + " ".join(sorted(COMMANDS)))
        return 0
    cmd = argv[0]
    if cmd not in COMMANDS:
        print(f"unknown command {cmd}; commands: "
              + " ".join(sorted(COMMANDS)), file=sys.stderr)
        return 2
    COMMANDS[cmd](argv[1:])
    return 0


if __name__ == "__main__":
    sys.exit(main())
