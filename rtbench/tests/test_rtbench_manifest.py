"""BENCHMARK.json against the benchmark's own files: every name found by a
file, every cell reporting what it must, every metric's ``moves`` reported
where the metric is."""
import json
import os
import re
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

from rtbench.tests.tiny import REPO, RTBENCH, manifest  # noqa: E402

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
MAN = manifest()
CELLS = [w["name"] for w in MAN["workloads"]]


def reports(cell, section):
    return [m["name"] for m in MAN[section]
            if cell in m.get("workloads", CELLS)]


def test_keys_and_names():
    assert list(MAN) == ["command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"]
    names = ([c["name"] for c in MAN["configs"]] + CELLS
             + [m["name"] for s in ("end_to_end", "per_layer")
                for m in MAN[s]])
    assert all(NAME.match(n) for n in names)
    assert len(set(names)) == len(names)
    for s in ("end_to_end", "per_layer"):
        for m in MAN[s]:
            assert UNIT.match(m["unit"]) and m["better"] in ("lower",
                                                             "higher")
    assert len(json.dumps(MAN)) < 64 * 1024


@pytest.mark.parametrize("cell", CELLS)
def test_each_cell_has_its_files_and_metrics(cell):
    w = next(w for w in MAN["workloads"] if w["name"] == cell)
    wl = json.load(open(os.path.join(RTBENCH, "workloads", f"{cell}.json")))
    assert (wl["config"], wl["traffic"]) == (w["config"], w["traffic"])
    assert os.path.exists(os.path.join(RTBENCH, "entries",
                                       f"{wl['entry']}.py"))
    assert w["chips"] == 1 and len(w["why"]) <= 200
    e2e = reports(cell, "end_to_end")
    assert "setup_s" in e2e and len(e2e) >= 2
    assert reports(cell, "per_layer")
    assert set(wl["limits"]) <= {"path_mismatch", "loss_gap", "grad_gap",
                                 "change_gap"}


def test_metrics_have_readers_and_move_what_their_cells_report():
    for s in ("end_to_end", "per_layer"):
        for m in MAN[s]:
            assert os.path.exists(os.path.join(RTBENCH, "metrics",
                                               f"{m['name']}.py"))
            assert set(m.get("workloads", CELLS)) <= set(CELLS)
    for m in MAN["per_layer"]:
        for cell in m.get("workloads", CELLS):
            assert m["moves"] in reports(cell, "end_to_end")
    for m in MAN["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in (
            "host_clock", "device_trace")


def test_configs_are_files_under_paths():
    for c in MAN["configs"]:
        assert c["file"].startswith("rtbench/configs/")
        cfg = json.load(open(os.path.join(REPO, c["file"])))
        assert cfg["source"] == c["source"] and len(c["source"]) <= 200
        assert cfg["reduced"] == c["reduced"] == []
        assert any(w["config"] == c["name"] for w in MAN["workloads"])
