"""The harness finds configurations, cells, drivers and per-layer readers
by name, a cell dropped into a copy as new files is found there, and
`BENCHMARK.json` keeps to the rules a benchmark file is checked against."""
from __future__ import annotations

import json
import os
import re
import shutil
import subprocess
import sys

import pytest

from benchmark import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


@pytest.fixture(scope="module")
def bench():
    return harness.read_json(os.path.join(harness.ROOT, "BENCHMARK.json"))


def test_benchmark_file_keeps_the_rules(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert bench["paths"] == ["benchmark"]
    assert 1 <= bench["run_seconds"] <= 51
    cfgs = {c["name"]: c for c in bench["configs"]}
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["file"].startswith("benchmark/")
        assert os.path.isfile(os.path.join(harness.ROOT, c["file"]))
        assert all(NAME.match(k) for k in c["reduced"])
    cells = {}
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["config"] in cfgs and w["chips"] in (1, 4)
        assert len(w["why"]) <= 200
        cells[w["name"]] = w
    assert len({(w["config"], w["traffic"]) for w in cells.values()}) == len(cells)
    assert {w["config"] for w in cells.values()} == set(cfgs)
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in bench["end_to_end"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert 0.01 <= m["bound"] <= 0.25 and m["better"] in ("lower", "higher")
        assert m["source"] in ("host_clock", "device_trace")
        assert set(m.get("workloads", cells)) <= set(cells)
    layer_names = set()
    for m in bench["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves",
                          "workloads"}
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["source"] in SOURCES and m["moves"] in e2e
        assert "\n" not in m["layer"] and len(m["layer"]) <= 200
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"
        for cell in m["workloads"]:
            moved = e2e[m["moves"]]
            assert cell in moved.get("workloads", cells)
        layer_names.add(m["name"])
    names = [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    assert len(names) == len(set(names))
    for cell in cells:
        reported = [m for m in harness.metrics_of(bench, cell, "end_to_end")]
        assert "setup_s" in {m["name"] for m in reported} and len(reported) >= 2
        assert harness.metrics_of(bench, cell, "per_layer")
    assert len(json.dumps(bench)) < 64 * 1024


@pytest.mark.parametrize("cell", ["uni.preprocess", "brca.train", "brca.predict",
                                  "brca.predict-cached"])
def test_cell_found_by_name(cell, bench):
    _, entry, config, traffic = harness.load_cell(cell)
    assert entry["name"] == cell and config["name"] == entry["config"]
    assert os.path.isfile(os.path.join(harness.BENCH, "drivers",
                                       f"{traffic['driver']}.py"))
    for m in harness.metrics_of(bench, cell, "per_layer"):
        assert callable(harness.reader(m["name"]))


def test_unknown_cell_is_refused():
    with pytest.raises(SystemExit):
        harness.load_cell("no.such-cell")


def _copy(tmp_path):
    dst = tmp_path / "checkout"
    dst.mkdir()
    shutil.copy(os.path.join(harness.ROOT, "BENCHMARK.json"), dst)
    shutil.copytree(harness.BENCH, dst / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    return dst


def test_cell_dropped_into_a_copy_is_found(tmp_path):
    dst = _copy(tmp_path)
    b = json.loads((dst / "BENCHMARK.json").read_text())
    b["workloads"].append({"name": "brca.predict-16", "config": "brca_paths_0",
                           "traffic": "requests_16", "chips": 1, "why": "x"})
    b["per_layer"].append({"name": "request_p99_ms.predict", "unit": "ms",
                           "better": "lower", "source": "host_clock",
                           "layer": "session", "moves": "predict_slides_per_s",
                           "workloads": ["brca.predict-16"]})
    b["end_to_end"][2]["workloads"].append("brca.predict-16")
    (dst / "BENCHMARK.json").write_text(json.dumps(b))
    tr = json.loads((dst / "benchmark/traffic/requests_distinct.json").read_text())
    tr["request_slides"] = 16
    (dst / "benchmark/traffic/requests_16.json").write_text(json.dumps(tr))
    (dst / "benchmark/metrics/request_p99_ms.predict.py").write_text(
        "def read(layer):\n    return 99.0\n")
    code = ("import json; from benchmark import harness as h; "
            "b, c, cfg, tr = h.load_cell('brca.predict-16'); "
            "print(json.dumps([h.ROOT, tr['request_slides'], "
            "[m['name'] for m in h.metrics_of(b, 'brca.predict-16', 'per_layer')], "
            "h.reader('request_p99_ms.predict')(None)]))")
    out = subprocess.run([sys.executable, "-c", code], cwd=dst, text=True,
                         capture_output=True, check=True).stdout
    root, slides, metrics, value = json.loads(out)
    assert os.path.realpath(root) == os.path.realpath(dst)
    assert slides == 16 and metrics == ["request_p99_ms.predict"] and value == 99.0


def test_no_card_no_result(tmp_path):
    """Without a card (as here), and in a copy holding only the benchmark's
    files, the command prints no result and exits non-zero."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    for cwd in (harness.ROOT, _copy(tmp_path)):
        p = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload",
                            "brca.predict", "--seed", "3000000000", "--seconds", "1"],
                           cwd=cwd, text=True, capture_output=True, env=env)
        assert p.returncode != 0
        assert p.stdout.strip() == ""


@pytest.mark.parametrize("threads", [None, 2])
def test_traffic_file_sets_the_runs_thread_count(threads):
    import torch

    before = torch.get_num_threads()
    traffic = {} if threads is None else {"torch_threads": threads}
    with harness.host_threads(traffic):
        inside = torch.get_num_threads()
    assert inside == (before if threads is None else threads)
    assert torch.get_num_threads() == before
