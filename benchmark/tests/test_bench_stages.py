"""The chain's directory and its templates: the argument lists of the
three traffic files as the harness gave them before set-up stages,
per-library keys and lists existed; each library's .lib and keys, for any
library name; the lists; an unknown key."""

import json
import os

import pytest

from benchmark import gen, harness
from conftest import BENCH

# (traffic, configuration) -> [(span, command, argv)] in /w, on the card:
# the timed chain, then the warm-up's where the traffic has warmup_args
PARITY = {
    ("correct", "ecoli_mg1655_pe250"): [
        [["kmerfreq", "kmerfreq", ["kmerfreq", "-k", "17", "-m", "1", "-q",
                                   "10", "/w/reads.lib", "--device",
                                   "cuda"]],
         ["correct", "correct_error_reads",
          ["correct_error_reads", "-k", "17", "-c", "2",
           "/w/reads.lib.kmer.freq.cz", "/w/reads.lib", "--device", "cuda"]]],
        [["kmerfreq", "kmerfreq", ["kmerfreq", "-k", "17", "-m", "1", "-q",
                                   "10", "/w/reads.lib", "-k", "13",
                                   "--device", "cuda"]],
         ["correct", "correct_error_reads",
          ["correct_error_reads", "-k", "17", "-c", "2",
           "/w/reads.lib.kmer.freq.cz", "/w/reads.lib", "-k", "13",
           "--device", "cuda"]]]],
    ("contig", "saureus_usa300_pe101"): [
        [["contig", "debruijn_contig",
          ["debruijn_contig", "-f", "1", "-k", "31", "-r", "101", "-i",
           "0.1", "-M", "125", "-o", "/w/asm", "/w/reads.lib", "--device",
           "cuda"]]]],
    ("clean", "ecoli_mg1655_pe250"): [
        [["lowqual", "clean_lowqual",
          ["clean_lowqual", "-e", "0.01", "-r", "75", "/w/insert400_1.fq.gz",
           "/w/insert400_1.fq.gz.nonLowQual.gz",
           "/w/insert400_1.fq.gz.nonLowQual.stat", "--device", "cuda"]],
         ["lowqual", "clean_lowqual",
          ["clean_lowqual", "-e", "0.01", "-r", "75", "/w/insert400_2.fq.gz",
           "/w/insert400_2.fq.gz.nonLowQual.gz",
           "/w/insert400_2.fq.gz.nonLowQual.stat", "--device", "cuda"]],
         ["adapter", "clean_adapter",
          ["clean_adapter", "-s", "12", "-r", "75",
           "/w/insert400_1.fq.gz.nonLowQual.gz",
           "/w/insert400_1.fq.gz.nonLowQual.gz.nonAdapter.gz",
           "/w/insert400_1.fq.gz.nonLowQual.gz.nonAdapter.stat", "--device",
           "cuda"]],
         ["adapter", "clean_adapter",
          ["clean_adapter", "-s", "12", "-r", "75",
           "/w/insert400_2.fq.gz.nonLowQual.gz",
           "/w/insert400_2.fq.gz.nonLowQual.gz.nonAdapter.gz",
           "/w/insert400_2.fq.gz.nonLowQual.gz.nonAdapter.stat", "--device",
           "cuda"]]]],
}


def _load(*parts):
    with open(os.path.join(BENCH, *parts)) as f:
        return json.load(f)


@pytest.mark.parametrize("traffic,config", sorted(PARITY))
def test_argvs_as_before(traffic, config):
    t = _load("traffic", traffic + ".json")
    c = _load("configs", config + ".json")
    files = [f"/w/{lib}_{mate}.fq.gz"
             for lib in gen.select_libraries(c, t) for mate in (1, 2)]
    env = harness.template_env(c, t, "/w")
    got = [harness.stage_argvs(t["stages"], env, files, "cuda")]
    if "warmup_args" in t:
        got.append(harness.stage_argvs(t["stages"], env, files, "cuda",
                                       t["warmup_args"]))
    assert json.loads(json.dumps(got)) == PARITY[(traffic, config)]


def _libraries(*names):
    return {"libraries": [{"name": n, "read_len": 100 + i, "insert": 300 * i,
                           "depth": 1} for i, n in enumerate(names, 1)]}


# library names of every kind a configuration may hold: digits alone, a
# dot, a dash, and the name of the .lib of every file
@pytest.mark.parametrize("names", [("insert400", "insert800"),
                                   ("400", "a.b-c", "reads")])
def test_per_library_lib_and_keys(tmp_path, names):
    config = _libraries(*names)
    traffic = {"libraries": "all", "lists": {
        "two.lib": ["{work}/m/%s_1.fq.gz.map_pair.2ctg.gz" % n
                    for n in names],
        "keys.txt": ["{lib.%s} {insert.%s} {read_len.%s} {read_len}"
                     % (n, n, n) for n in names]}}
    src = tmp_path / "inputs"
    src.mkdir()
    names_of = [(n, m) for n in names for m in (1, 2)]
    files = []
    for n, m in names_of:
        (src / f"{n}_{m}.fq.gz").write_bytes(b"")
        files.append(str(src / f"{n}_{m}.fq.gz"))
    made = tmp_path / "setup_out.fa"
    made.write_text(">1\nACGT\n")
    d = harness.stage_dir(str(tmp_path / "pass0"), files, names_of, config,
                          traffic, [str(made)])
    work = d.path

    def read(path):
        with open(path) as f:
            return f.read().split("\n")[:-1]
    assert read(d.env["lib"]) == d.links == [
        os.path.join(work, f"{n}_{m}.fq.gz") for n, m in names_of]
    for i, n in enumerate(names, 1):
        assert d.env[f"lib.{n}"] == os.path.join(work, f"{n}.pair.lib")
        assert read(d.env[f"lib.{n}"]) == [
            os.path.join(work, f"{n}_{m}.fq.gz") for m in (1, 2)]
        for m in (1, 2):
            assert os.path.realpath(os.path.join(work, f"{n}_{m}.fq.gz")) \
                == os.path.realpath(src / f"{n}_{m}.fq.gz")
    longest = 100 + len(names)
    assert read(os.path.join(work, "keys.txt")) == [
        f"{work}/{n}.pair.lib {300 * i} {100 + i} {longest}"
        for i, n in enumerate(names, 1)]
    assert read(os.path.join(work, "two.lib")) == [
        f"{work}/m/{n}_1.fq.gz.map_pair.2ctg.gz" for n in names]
    # set-up's output is a link, and the harness's files are its own
    assert os.path.islink(os.path.join(work, "setup_out.fa"))
    assert d.own == set(os.listdir(work))
    argv = harness.stage_argvs(
        [{"span": "s", "command": "c",
          "args": ["-i", "{insert.%s}" % names[-1], "{lib.%s}" % names[0]]}],
        d.env, d.links, "cpu")
    assert argv == [("s", "c", ["c", "-i", str(300 * len(names)),
                                f"{work}/{names[0]}.pair.lib", "--device",
                                "cpu"])]


def test_only_the_traffics_libraries_have_keys():
    config = _libraries("insert400", "insert800")
    env = harness.template_env(config, {"libraries": "first"}, "/w")
    assert env["read_len"] == 101 and "lib.insert800" not in env
    with pytest.raises(SystemExit, match="no template key 'lib.insert800'"):
        harness.expand("{lib.insert800}", env)


def test_a_list_may_not_overwrite_the_harness_files(tmp_path):
    config = _libraries("x")
    with pytest.raises(FileExistsError):
        harness.stage_dir(str(tmp_path / "d"), [], [], config,
                          {"libraries": "all", "lists": {"reads.lib": []}})


def test_digests_read_the_pass_path_as_work(tmp_path):
    """Two passes whose files name their own directory, one in a
    subdirectory, digest alike; links and the harness's files do not
    count."""
    from benchmark import checks
    out = []
    for p in ("pass0", "pass1"):
        d = tmp_path / p
        (d / "map").mkdir(parents=True)
        (d / "x.lib").write_text(f"{d}/map/a.gz\n")
        (d / "map" / "a.stat").write_text(f"{d}/a\n")
        (d / "own.lib").write_text(p)
        os.symlink(tmp_path / "elsewhere", d / "link")
        out.append(checks.digests(str(d), {"own.lib"}))
    assert out[0] == out[1] and set(out[0]) == {"x.lib", "map/a.stat"}
