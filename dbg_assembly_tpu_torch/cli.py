"""Command line: the reference binaries' flags, plus --device.

    python -m dbg_assembly_tpu_torch clean_lowqual -e 0.001 -r 75 in.fq out.gz out.stat
    python -m dbg_assembly_tpu_torch clean_adapter -a Both-adapter -s 12 in out stat
    python -m dbg_assembly_tpu_torch kmerfreq -k 17 -m 1 reads.lib
    python -m dbg_assembly_tpu_torch correct_error_reads -k 17 freq.cz reads.lib
    python -m dbg_assembly_tpu_torch correct_error -k 17 freq8.cz reads.lib
    python -m dbg_assembly_tpu_torch debruijn_contig -k 31 -o prefix reads.lib
    python -m dbg_assembly_tpu_torch debruijn_contig --readout doubling ...
    python -m dbg_assembly_tpu_torch map_pair -l 125 -r 250 -o outdir ctg.fa reads.lib
    python -m dbg_assembly_tpu_torch link_scaffold -i 400 -o prefix ctg.fa twoctg.lib

Flag letters match dbg_assembly_tpu's cli (clean_lowqual as
clean_lowqual.cpp:191-209; clean_adapter as clean_adapter.cpp:272-291;
kmerfreq as the workflow runs it, test/01.clean_correct/work.sh:31;
correct_error_reads as main_parallel_senior.cpp:142-163; debruijn_contig as
DBG_contig/main.cpp:162-196; map_pair as map_pair.cpp:50-66; link_scaffold
as link_scaffold.cpp:89-104).  --device cuda (the default) runs on the GPU
and fails when there is none; --device cpu runs the kernels' plain PyTorch
versions and the device programs on the CPU.
"""

from __future__ import annotations

import argparse
import sys


def _device_flag(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the chop, sort, segment reductions and "
                    "device programs run")


def _clean_lowqual(argv):
    ap = argparse.ArgumentParser(prog="clean_lowqual")
    ap.add_argument("-e", type=float, default=0.001)
    ap.add_argument("-q", type=int, default=33)
    ap.add_argument("-r", type=int, default=75)
    ap.add_argument("-t", type=int, default=3)    # accepted, unused
    _device_flag(ap)
    ap.add_argument("input")
    ap.add_argument("output")
    ap.add_argument("stat")
    a = ap.parse_args(argv)
    from .clean import lowqual
    return lowqual.run_file(a.input, a.output, a.stat, err_cutoff=a.e,
                            min_read_len=a.r, quality_shift=a.q,
                            device=a.device)


def _clean_adapter(argv):
    ap = argparse.ArgumentParser(prog="clean_adapter")
    ap.add_argument("-a", default="Both-adapter")
    ap.add_argument("-b", type=int, default=0)
    ap.add_argument("-s", type=int, default=12)
    ap.add_argument("-r", type=int, default=75)
    ap.add_argument("-t", type=int, default=3)    # accepted, unused
    _device_flag(ap)
    ap.add_argument("input")
    ap.add_argument("output")
    ap.add_argument("stat")
    a = ap.parse_args(argv)
    from .clean import adapter
    return adapter.run_file(a.input, a.output, a.stat, adapter_file=a.a,
                            score_cutoff=a.s, min_read_len=a.r,
                            use_rc=bool(a.b), device=a.device)


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


def _correct(argv):
    ap = argparse.ArgumentParser(prog="correct_error_reads")
    ap.add_argument("-k", type=int, default=17)
    ap.add_argument("-m", type=int, default=0)
    ap.add_argument("-c", type=int, default=2)
    ap.add_argument("-x", type=int, default=0)
    ap.add_argument("-n", type=int, default=5_000_000)
    ap.add_argument("-r", type=int, default=75)
    ap.add_argument("-t", type=int, default=10)
    ap.add_argument("-f", type=int, default=1)
    ap.add_argument("-j", type=int, default=0)
    ap.add_argument("--engine", choices=("auto", "torch", "native", "python"),
                    default="auto",
                    help="correction engine: auto = torch, the device "
                    "engine on --device; native = the shared C++ engine; "
                    "python = the host engine")
    ap.add_argument("--mesh", type=int, default=0, metavar="N",
                    help="sharded corrector over N devices (not ported "
                    "yet)")
    _device_flag(ap)
    ap.add_argument("cz")
    ap.add_argument("lib")
    a = ap.parse_args(argv)
    from .correct import pipeline
    from .correct.engine import CorrectParams
    params = CorrectParams(ksize=a.k, high_freq_reg_len=a.m, max_change=a.c,
                           further_trim=a.x, max_bbt_nodes=a.n,
                           min_read_len=a.r)
    out = pipeline.run(a.cz, a.lib, params, fmt=a.f, engine=a.engine,
                       device=a.device, mesh_devices=a.mesh)
    if a.j == 1:
        from .contig.pipeline import read_file_list
        from .utils.helpers import merge_corrected_pair
        files = read_file_list(a.lib)
        for i in range(0, len(files), 2):
            merge_corrected_pair(files[i] + ".correct.fa.gz",
                                 files[i + 1] + ".correct.fa.gz")
    return out


def _correct_8bit(argv):
    ap = argparse.ArgumentParser(prog="correct_error")
    ap.add_argument("-k", type=int, default=17)
    ap.add_argument("-l", type=int, default=10)
    ap.add_argument("-m", type=int, default=0)
    ap.add_argument("-c", type=int, default=2)
    ap.add_argument("-x", type=int, default=0)
    ap.add_argument("-n", type=int, default=15_000_000)
    ap.add_argument("-r", type=int, default=50)
    ap.add_argument("-f", type=int, default=1)
    ap.add_argument("-j", type=int, default=1)
    ap.add_argument("cz")
    ap.add_argument("lib")
    a = ap.parse_args(argv)
    from .correct import pipeline
    return pipeline.run_8bit(a.cz, a.lib, ksize=a.k, low_freq_cutoff=a.l,
                             max_change=a.c, high_freq_reg_len=a.m,
                             further_trim=a.x, min_read_len=a.r,
                             max_bbt_nodes=a.n, fmt=a.f, join=(a.j == 1))


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


def _map_pair(argv):
    ap = argparse.ArgumentParser(prog="map_pair")
    ap.add_argument("-k", type=int, default=31)
    ap.add_argument("-s", type=int, default=5)
    ap.add_argument("-l", type=int, default=125)
    ap.add_argument("-r", type=int, default=250)
    ap.add_argument("-i", type=float, default=0.97)
    ap.add_argument("-f", type=int, default=1)
    ap.add_argument("-o", default="./")
    ap.add_argument("--engine", choices=("torch", "native"), default="torch",
                    help="mapper: torch = the index and mapper on --device; "
                    "native = the shared C++ engine")
    ap.add_argument("--mesh", type=int, default=0, metavar="N",
                    help="shard read batches over N devices (not ported "
                    "yet)")
    _device_flag(ap)
    ap.add_argument("contig_fa")
    ap.add_argument("lib")
    a = ap.parse_args(argv)
    from .scaffold import map_pair
    return map_pair.run(a.contig_fa, a.lib, a.o, ksize=a.k,
                        seed_kmer_num=a.s, min_ctg_len=a.l, min_read_len=a.r,
                        min_identity=a.i, fmt=a.f, mesh_devices=a.mesh,
                        engine=a.engine, device=a.device)


def _link_scaffold(argv):
    ap = argparse.ArgumentParser(prog="link_scaffold")
    ap.add_argument("-m", type=int, default=0)
    ap.add_argument("-n", type=int, default=3)
    ap.add_argument("-i", type=int, default=400)
    ap.add_argument("-o", default="Output")
    _device_flag(ap)
    ap.add_argument("contig_fa")
    ap.add_argument("twoctg_lib")
    a = ap.parse_args(argv)
    # the link graph and the readout run on the host; the device is
    # checked as every command's is, so a run meant for the card fails
    # where there is none
    from . import resolve_device
    resolve_device(a.device)
    from .scaffold import scaffold
    return scaffold.run(a.contig_fa, a.twoctg_lib, a.o, insert_size=a.i,
                        pair_num_cut=a.n, is_mate=bool(a.m))


COMMANDS = {
    "clean_lowqual": _clean_lowqual,
    "clean_adapter": _clean_adapter,
    "kmerfreq": _kmerfreq,
    "correct_error_reads": _correct,
    "correct_error": _correct_8bit,
    "debruijn_contig": _debruijn_contig,
    "map_pair": _map_pair,
    "link_scaffold": _link_scaffold,
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
