""".stat files and C++ number formatting (counterpart of the parts of
dbg_assembly_tpu/io/stat.py that cleaning, counting, correction, the contig
stage and mapping use):
``ostream << double`` prints with precision 6, as printf("%g");
``boost::lexical_cast<std::string>(double)`` round-trips with 17 digits, as
printf("%.17g") (the contig headers' avgDepth, contig.cpp:1006).
"""

from __future__ import annotations


def fmt_g6(x: float) -> str:
    """Format like C++ `ostream << double` (printf %g, 6 significant digits)."""
    return "%g" % x


def fmt_lexical(x: float) -> str:
    """Format like boost::lexical_cast<string>(double) (printf %.17g)."""
    return "%.17g" % x


def fmt_lexical_int(x: int) -> str:
    return "%d" % x


def write_clean_lowqual_stat(path: str, raw_reads: int, raw_bases: int,
                             lowqual_reads: int, lowqual_bases: int,
                             short_reads: int, short_bases: int,
                             clean_reads: int, clean_bases: int) -> None:
    """clean_lowqual's .stat (clean_lowqual.cpp:314-325)."""
    def pct(a, b):
        return fmt_g6(a / b * 100 if b else float("nan"))
    with open(path, "w") as f:
        f.write(f"#total_raw_reads:   {raw_reads}\n")
        f.write(f"#total_raw_bases:   {raw_bases}\n")
        f.write(f"#filtered_lowqual_reads: {lowqual_reads}\t"
                f"{pct(lowqual_reads, raw_reads)}%\n")
        f.write(f"#filtered_lowqual_bases: {lowqual_bases}\t"
                f"{pct(lowqual_bases, raw_bases)}%\n")
        f.write(f"#filtered_short_reads: {short_reads}\t"
                f"{pct(short_reads, raw_reads)}%\n")
        f.write(f"#filtered_short_bases: {short_bases}\t"
                f"{pct(short_bases, raw_bases)}%\n")
        f.write(f"#total_clean_reads: {clean_reads}\t"
                f"{pct(clean_reads, raw_reads)}%\n")
        f.write(f"#total_clean_bases: {clean_bases}\t"
                f"{pct(clean_bases, raw_bases)}%\n")


def write_clean_adapter_stat(path: str, raw_reads: int, raw_bases: int,
                             trimmed_reads: int, trimmed_bases: int,
                             short_reads: int, short_bases: int,
                             clean_reads: int, clean_bases: int) -> None:
    """clean_adapter's .stat (clean_adapter.cpp:458-471)."""
    with open(path, "w") as f:
        f.write(f"total_raw_reads:  {raw_reads}\n")
        f.write(f"total_raw_bases:  {raw_bases}\n")
        f.write(f"total_adapter_trimmed_reads:  {trimmed_reads}\n")
        f.write(f"total_adapter_trimmed_bases:  {trimmed_bases}\t"
                f"{fmt_g6(trimmed_bases / raw_bases)}\n")
        f.write(f"total_short_trimmed_reads:  {short_reads}\n")
        f.write(f"total_short_trimmed_bases:  {short_bases}\t"
                f"{fmt_g6(short_bases / raw_bases)}\n")
        f.write(f"total_clean_reads:  {clean_reads}\n")
        f.write(f"total_clean_bases:  {clean_bases}\t"
                f"{fmt_g6(clean_bases / raw_bases)}\n")


def write_map_pair_stat(path: str, total: int, diff: int, same: int,
                        gap: int, none: int) -> None:
    """map_pair's .map_pair.stat (map_pair.cpp:348-352)."""
    def pct(a):
        return fmt_g6(a / total * 100 if total else float("nan"))
    with open(path, "w") as f:
        f.write(f"\ttotal_read_pair_num: {total}\n")
        f.write(f"\tmap_ctg_diff_num: {diff}  {pct(diff)}%\n")
        f.write(f"\tmap_ctg_same_num: {same}  {pct(same)}%\n")
        f.write(f"\tmap_ctg_gap_num: {gap}  {pct(gap)}%\n")
        f.write(f"\tmap_no_no_num: {none}  {pct(none)}%\n")


def write_correct_stat(path: str, raw_reads: int, raw_bases: int,
                       res_reads: int, res_bases: int,
                       trimmed_reads: int, trimmed_bases: int,
                       deleted_reads: int, fast_score: int,
                       bbt_score: int) -> None:
    """correct_error_reads' .correct.stat (main_parallel_senior.cpp:
    661-675)."""
    _correct_stat(path, ("filter_ratio: (num_raw_bases - num_res_bases) / "
                         "num_raw_bases",
                         "correct_ratio: total_all_base_correct_score / "
                         "num_res_bases"),
                  raw_reads, raw_bases, res_reads, res_bases, trimmed_reads,
                  trimmed_bases, deleted_reads, fast_score, bbt_score)


def write_cor_stat(path: str, **tallies: int) -> None:
    """correct_error's .cor.stat (correct_error/correct.cpp:639-848):
    write_correct_stat's tallies, by its parameter names, with the 8-bit
    program's older names of the two ratios."""
    _correct_stat(path, ("low_quality_bases_filter_ratio",
                         "estimated_raw_base_error_ratio"), **tallies)


def _correct_stat(path: str, ratio_names: tuple, raw_reads: int,
                  raw_bases: int, res_reads: int, res_bases: int,
                  trimmed_reads: int, trimmed_bases: int, deleted_reads: int,
                  fast_score: int, bbt_score: int) -> None:
    all_score = fast_score + bbt_score
    filt = (raw_bases - res_bases) / raw_bases if raw_bases else float("nan")
    corr = all_score / res_bases if res_bases else float("nan")
    with open(path, "w") as f:
        f.write(f"num_raw_reads {raw_reads}\n")
        f.write(f"num_raw_bases {raw_bases}\n")
        f.write(f"num_result_reads {res_reads}\n")
        f.write(f"num_result_bases {res_bases}\n")
        f.write(f"\nnum_trimmed_reads {trimmed_reads}\n")
        f.write(f"num_trimmed_bases {trimmed_bases}\n")
        f.write(f"num_deleted_reads {deleted_reads}\n")
        f.write(f"\nnum_corrected_bases_by_Fast_method {fast_score}\n")
        f.write(f"num_corrected_bases_by_BBtree_method {bbt_score}\n")
        f.write(f"num_corrected_bases_by_two_methods {all_score}\n")
        f.write(f"\n{ratio_names[0]} {fmt_g6(filt)}\n")
        f.write(f"{ratio_names[1]} {fmt_g6(corr)}\n")


def write_kmerfreq_stat(path: str, ksize: int, max_freq: int,
                        individual_num: int, species_num: int,
                        theory_total: int, spectrum) -> None:
    """k-mer spectrum stat, in the format of the kmerfreq output shipped in
    test/01.clean_correct/clean_reads.lib.kmer.freq.stat:1-10."""
    with open(path, "w") as f:
        f.write(f"#Kmer size: {ksize}\n")
        f.write(f"#Maximum Kmer frequency: {max_freq}\n")
        f.write(f"#Kmer indivdual number: {individual_num}\n")
        f.write(f"#Kmer species number: {species_num}\n")
        occ = species_num / theory_total if theory_total else 0.0
        f.write(f"#Theoretic space of Kmer species: {theory_total}  "
                f"occupied ratio: {fmt_g6(occ)}\n")
        f.write("\n#Kmer_Frequency\tKmer_Species_Number\tKmer_Species_Ratio\t"
                "Kmer_Species_accumulate_Ratio\tKmer_Individual_Number\t"
                "Kmer_Individual_Ratio\tKmer_Individual_accumulate_ratio\n")
        acc_sp = 0
        acc_ind = 0
        for freq in range(1, len(spectrum)):
            n_sp = int(spectrum[freq])
            if n_sp == 0 and freq > max_freq:
                continue
            n_ind = n_sp * freq
            acc_sp += n_sp
            acc_ind += n_ind
            f.write(f"{freq}\t{n_sp}\t{fmt_g6(n_sp / species_num)}\t"
                    f"{fmt_g6(acc_sp / species_num)}\t{n_ind}\t"
                    f"{fmt_g6(n_ind / individual_num)}\t"
                    f"{fmt_g6(acc_ind / individual_num)}\n")
