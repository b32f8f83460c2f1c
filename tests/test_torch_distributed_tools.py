"""The port's two distributed-path tools on the CPU:
tools/verify_comm_volume.py (the ingest step's bytes between slots equal
the kept records of the segments that leave their slot, at every slot
count; the raw step within JAX's band of the 16 B model at the tool's
shape) and tools/measure_scaling.py (a row a slot count, the exact step's
tables equal across them, nothing dropped by it).  Neither writes a
file."""

import os

import pytest

from dbg_assembly_tpu_torch.tools import measure_scaling as ms
from dbg_assembly_tpu_torch.tools import verify_comm_volume as vcv
from test_torch_mesh import two_torch_threads  # noqa: F401 (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _distributed_md() -> bytes:
    with open(os.path.join(ROOT, "DISTRIBUTED.md"), "rb") as f:
        return f.read()


@pytest.mark.parametrize("D", [2, 4, 8])
def test_comm_volume_identity(D):
    # measure() raises unless each step's bytes equal the segments'
    codes, lengths = vcv.tool_batch(96, 80)
    r = vcv.measure(codes, lengths, 21, D, "cpu")
    assert r["record_bytes"] == 8 + 1 + 1 + 8
    raw, exact = r["graph_ingest_step"], r["graph_ingest_step_exact"]
    assert raw["bytes"] > 0 and exact["bytes"] >= raw["bytes"]
    assert exact["dropped"] == 0
    assert exact["capacity"] == r["capacity"] << exact["capacity_doublings"]
    if raw["dropped"]:
        assert exact["capacity_doublings"] > 0


def test_comm_volume_one_slot_moves_nothing():
    codes, lengths = vcv.tool_batch(96, 80)
    r = vcv.measure(codes, lengths, 21, 1, "cpu")
    for step in ("graph_ingest_step", "graph_ingest_step_exact"):
        assert r[step]["bytes"] == 0 and r[step]["dropped"] == 0


def test_comm_volume_tool_shape(capsys, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    before = _distributed_md()
    assert vcv.main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    # N 1024 x L 150, k 31, D 8: 122 880 k-mer slots, 18 B a routed k-mer
    assert "k-mer slots per step: 122880" in out
    assert "a routed k-mer carries 18 B" in out
    assert "graph_ingest_step: 1705284 B between slots, 13.88 B" in out
    assert "dropped 14608" in out
    assert out.rstrip().splitlines()[-1].startswith("OK: graph_ingest_step")
    assert os.listdir(tmp_path) == [] and _distributed_md() == before


def test_comm_volume_band_is_checked():
    # at 2 slots half the k-mers stay on their own slot: 0.56 of the model
    with pytest.raises(AssertionError, match="the model is off"):
        vcv.main(["--device", "cpu", "--slots", "2"])


def test_measure_scaling_small_batch(capsys, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    before = _distributed_md()
    rows = ms.run(512, "cpu")
    assert [r["n"] for r in rows] == [1, 2, 4, 8]
    for r in rows:
        assert r["exact"]["dropped"] == 0
        for step in ("raw", "exact"):
            s = r[step]
            assert s["efficiency"] == pytest.approx(s["speedup"] / r["n"])
            assert s["best_s"] > 0 and s["rate"] == pytest.approx(
                512 * (150 - 21 + 1) / s["best_s"])
            assert (s["bytes"] == 0) == (r["n"] == 1)
    assert rows[0]["raw"]["speedup"] == rows[0]["exact"]["speedup"] == 1.0
    text = ms.table(rows, 512)
    assert len([ln for ln in text.splitlines() if ln.startswith("| ")]) \
        == 1 + 2 * 4
    assert os.listdir(tmp_path) == [] and _distributed_md() == before


def test_measure_scaling_checks_tables(monkeypatch):
    real = ms._merged
    calls = []

    def broken(out):
        cols = real(out)
        calls.append(1)
        if len(calls) == 2:        # the second slot count's table
            cols[4] = cols[4] + 1
        return cols

    monkeypatch.setattr(ms, "_merged", broken)
    with pytest.raises(AssertionError, match="merged node table"):
        ms.run(64, "cpu")


def test_tools_need_a_card_for_cuda(monkeypatch, tmp_path):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.chdir(tmp_path)
    for main in (vcv.main, ms.main):
        with pytest.raises(RuntimeError, match="CUDA"):
            main([])
    assert os.listdir(tmp_path) == []
