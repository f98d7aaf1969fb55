"""BENCHMARK.json against the benchmark's contract, and discovery by name:
a new cell, configuration or metric is a new file and a new entry."""

import json
import re
import shutil

import pytest

from zkbench import manifest
from zkbench.tests.conftest import REPO, TINY_CELL, make_root

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_benchmark_json_keeps_the_contract():
    raw = (REPO / "BENCHMARK.json").read_text()
    assert len(raw.encode()) <= 64 * 1024
    b = json.loads(raw)
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    assert 1 <= len(b["command"]) <= 32 and all(_line(w) for w in b["command"])
    assert all(PATH.match(p) and not p.startswith("/") and ".." not in p for p in b["paths"])
    assert isinstance(b["run_seconds"], int) and 1 <= b["run_seconds"] <= 51
    assert 2 + 14 * 24 <= 43200 and (2 + 14 * 24) * (b["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    names = set()
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line(c["source"]) and _line(c["why"])
        assert (REPO / c["file"]).is_file() and c["file"].startswith(tuple(b["paths"]))
        assert len(c["reduced"]) <= 16
        names.add(c["name"])
    cells = set()
    four = 0
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and _line(w["why"])
        assert w["config"] in names and w["chips"] in (1, 4)
        assert (REPO / "zkbench" / "traffic" / f"{w['traffic']}.json").is_file()
        four += w["chips"] == 4
        cells.add(w["name"])
    assert len(cells) == len(b["workloads"]) and four <= max(1, len(cells) // 4)
    used = {w["config"] for w in b["workloads"]}
    assert used == names
    metric_names = set()
    e2e = {m["name"] for m in b["end_to_end"]}
    assert "setup_s" in e2e
    for m in b["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        metric_names.add(m["name"])
    for m in b["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["moves"] in e2e and _line(m["layer"])
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert set(m.get("workloads", cells)) <= cells
        assert (REPO / "zkbench" / "metrics" / f"{m['name']}.py").is_file()
        if m["unit"] == "%" and "roofline" in m["name"]:
            assert m["name"].endswith("_roofline")
        metric_names.add(m["name"])
    for m in b["end_to_end"] + b["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    assert len(metric_names) == len(b["end_to_end"]) + len(b["per_layer"])
    for cell in cells:  # every cell reports set-up, another end-to-end and a per-layer metric
        man = manifest.Manifest(REPO)
        assert len(man.end_to_end(cell)) >= 2 and man.per_layer(cell)


def test_every_cell_resolves_by_name():
    man = manifest.Manifest(REPO)
    for w in man.data["workloads"]:
        cfg = man.config(w["config"])
        assert manifest.adapter(cfg["adapter"]).System
        assert manifest.reference(cfg["reference"]).prove
        assert man.traffic(w["traffic"])["gates_log2"] > 0
        for m in man.per_layer(w["name"]):
            assert callable(man.reader(m["name"]))


def test_a_new_cell_and_metric_are_files_and_entries(tmp_path):
    root = make_root(tmp_path)
    before = {p: p.read_bytes() for p in (root / "zkbench").rglob("*") if p.is_file()}
    # a new traffic mix, a new cell and a new per-layer metric
    (root / "zkbench" / "traffic" / "closed-n5.json").write_text(json.dumps(
        {"gates_log2": 5, "loop": "closed", "in_flight": 1, "fresh": ["V"]}))
    (root / "zkbench" / "metrics" / "jobs_seen.py").write_text(
        "def read(ctx):\n    return float(ctx['jobs'])\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["workloads"].append(dict(bench["workloads"][0], name="tiny.n5", traffic="closed-n5"))
    bench["per_layer"].append({"name": "jobs_seen", "unit": "jobs", "better": "higher",
                               "source": "host_clock", "layer": "harness", "moves": "prove_device_s",
                               "workloads": ["tiny.n5"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    man = manifest.Manifest(root)
    assert man.traffic(man.workload("tiny.n5")["traffic"])["gates_log2"] == 5
    assert [m["name"] for m in man.per_layer("tiny.n5")] == ["jobs_seen"]
    assert "jobs_seen" not in [m["name"] for m in man.per_layer(TINY_CELL)]
    assert man.reader("jobs_seen")({"jobs": 3}) == 3.0
    assert all(p.read_bytes() == b for p, b in before.items())


def test_unknown_names_raise(tiny_root):
    man = manifest.Manifest(tiny_root)
    with pytest.raises(KeyError):
        man.workload("no-such-cell")
    with pytest.raises(FileNotFoundError):
        man.traffic("no-such-traffic")
    shutil.rmtree(tiny_root / "zkbench" / "metrics")
    with pytest.raises(FileNotFoundError):
        man.reader("device_kernels")


def test_the_generator_refuses_a_loop_it_does_not_serve():
    from zkbench import traffic

    cfg = manifest.Manifest(REPO).config("dhp-leader-l8")
    with pytest.raises(ValueError):
        traffic.table_shapes(cfg, {"gates_log2": 4, "loop": "open", "in_flight": 1, "fresh": []})
    with pytest.raises(ValueError):
        traffic.table_shapes(cfg, {"gates_log2": 4, "loop": "closed", "in_flight": 2, "fresh": []})
    shapes = traffic.table_shapes(cfg, {"gates_log2": 6, "loop": "closed", "in_flight": 1,
                                        "fresh": []})
    assert shapes["V"] == (1, 4 * 64 // 8) and shapes["challenge_r1"] == (8,)
    assert shapes["alpha"] == ()
