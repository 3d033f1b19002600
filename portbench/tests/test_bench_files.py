"""BENCHMARK.json against the benchmark's contract, and every file it names
found by name."""

import json
import math
import os
import re

import pytest
import yaml

from portbench.lib import bench

ROOT = bench.ROOT
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")
WIDTH = re.compile(r"(_DIM|_dim|_RANK|_rank|SIZE|HEADS|_heads|_size)$")


def spec():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def line_ok(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys_and_paths():
    s = spec()
    assert set(s) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    assert 1 <= len(s["paths"]) <= 16 and all(PATH.match(p) for p in s["paths"])
    assert not any(p.endswith("_torch") or p.startswith("/") or ".." in p for p in s["paths"])
    assert len(s["command"]) <= 32 and all(line_ok(w) for w in s["command"])
    for word in s["command"][1:]:
        assert not word.startswith("/") and ".." not in word
        if os.path.exists(os.path.join(ROOT, word)):
            assert any(word.startswith(p + "/") for p in s["paths"])
    assert isinstance(s["run_seconds"], int) and 1 <= s["run_seconds"] <= 51
    # a full check of 24 cells fits its time
    assert (2 + 14 * 24) * (s["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200
    assert len(json.dumps(s).encode()) <= 64 * 1024


def test_names_units_and_entries():
    s = spec()
    names = [c["name"] for c in s["configs"]]
    cells = [w["name"] for w in s["workloads"]]
    metrics = [m["name"] for m in s["end_to_end"] + s["per_layer"]]
    for group in (names, cells, metrics):
        assert len(group) == len(set(group))
        assert all(NAME.match(n) for n in group)
    for c in s["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert line_ok(c["source"]) and line_ok(c["why"]) and c["source"].startswith("https://")
        assert any(c["file"].startswith(p + "/") for p in s["paths"])
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])
        assert not any(WIDTH.search(k) for k in c["reduced"])
        assert c["name"] in {w["config"] for w in s["workloads"]}
    assert len({c["file"] for c in s["configs"]}) == len(s["configs"])
    pairs = set()
    for w in s["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in names and NAME.match(w["traffic"]) and line_ok(w["why"])
        assert w["chips"] in (1, 4)
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
    assert sum(w["chips"] == 4 for w in s["workloads"]) <= max(1, len(cells) // 4)
    for m in s["end_to_end"] + s["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert all(w in cells for w in m.get("workloads", []))
    for m in s["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in s["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert line_ok(m["layer"]) and m["moves"] in {e["name"] for e in s["end_to_end"]}
        if m["name"].split(".")[0].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"


def test_every_cell_reports_what_it_must():
    s = spec()
    for w in s["workloads"]:
        e2e = [m["name"] for m in bench.metric_entries(s, w, False)]
        assert "setup_s" in e2e and len(e2e) >= 2
        per = bench.metric_entries(s, w, True)
        assert per and any("mfu" in m["name"] for m in per)
        for m in per:
            assert m["moves"] in e2e


@pytest.mark.parametrize("kind", ["configs", "traffic", "limits", "metrics", "drivers"])
def test_files_found_by_name(kind):
    s = spec()
    if kind == "configs":
        files = [c["file"] for c in s["configs"]]
    elif kind == "traffic":
        files = [f"portbench/traffic/{w['traffic']}.json" for w in s["workloads"]]
    elif kind == "limits":
        files = [f"portbench/limits/{w['name']}.json" for w in s["workloads"]]
    elif kind == "metrics":
        files = [f"portbench/metrics/{m['name']}.py" for m in s["end_to_end"] + s["per_layer"]]
    else:
        files = []
        for w in s["workloads"]:
            with open(os.path.join(ROOT, "portbench/traffic", w["traffic"] + ".json")) as f:
                files.append(f"portbench/drivers/{json.load(f)['driver']}.py")
    for f in files:
        assert os.path.isfile(os.path.join(ROOT, f)), f
        assert PATH.match(f)


def test_limits_cover_the_compared_numbers():
    for w in spec()["workloads"]:
        with open(os.path.join(ROOT, "portbench/limits", w["name"] + ".json")) as f:
            limits = json.load(f)
        want = ({"g_err", "change_gap"} if "train" in w["traffic"]
                else {"logits_err", "boxes_err"})
        assert want <= set(limits)
        assert all(isinstance(v, (int, float)) and math.isfinite(v) and v >= 0
                   for v in limits.values())


@pytest.mark.parametrize("name", ["interactron", "interactron_scaled"])
def test_config_file_is_the_shipped_yaml(name):
    """A configuration is run as the repository ships it: nothing reduced."""
    with open(os.path.join(ROOT, "portbench/configs", name + ".json")) as f:
        cfg = json.load(f)
    with open(os.path.join(ROOT, cfg["yaml"])) as f:
        assert cfg["config"] == yaml.safe_load(f)
    assert cfg["reduced"] == [] and cfg["assumed"]
    assert set(cfg["flops"]) == {"train_episode", "serve_episode", "fwconv_train_episode",
                                 "fwconv_serve_episode"}
