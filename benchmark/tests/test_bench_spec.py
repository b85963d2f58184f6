"""BENCHMARK.json against the contract's limits on names, units, keys and
cross references, and every named file there."""
from __future__ import annotations

import json
import re

from benchmark.common import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")
TOP = {"command", "paths", "run_seconds", "configs", "workloads",
       "end_to_end", "per_layer"}


def one_line(s: str) -> bool:
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_shape_and_names():
    spec = harness.load_spec()
    assert set(spec) == TOP
    assert len((harness.ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert 1 <= len(spec["command"]) <= 32
    assert all(one_line(w) for w in spec["command"])
    assert all(PATH.match(p) and ".." not in p for p in spec["paths"])
    assert isinstance(spec["run_seconds"], int) and 1 <= spec["run_seconds"] <= 51
    names = []
    for c in spec["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and one_line(c["source"]) and one_line(c["why"])
        assert c["file"].startswith(spec["paths"][0] + "/")
        assert (harness.ROOT / c["file"]).exists()
        assert all(NAME.match(k) for k in c["reduced"])
        names.append(c["name"])
    cells = []
    for w in spec["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["config"] in names and w["chips"] in (1, 4)
        assert one_line(w["why"])
        assert (harness.BENCH / "traffic" / f"{w['traffic']}.json").exists()
        assert (harness.BENCH / "limits" / f"{w['name']}.json").exists()
        cells.append(w["name"])
    assert len(set(cells)) == len(cells)
    assert len({(w["config"], w["traffic"]) for w in spec["workloads"]}) == len(cells)
    e2e = {}
    for m in spec["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        e2e[m["name"]] = m
    assert "setup_s" in e2e and "workloads" not in e2e["setup_s"]
    for m in spec["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves",
                          "workloads"}
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert one_line(m["layer"]) and m["moves"] in e2e
        for cell in m["workloads"]:
            assert harness.applies(e2e[m["moves"]], cell)
        assert (harness.BENCH / "metrics" / f"{m['name']}.py").exists()
    for cell in cells:
        e = [m for m in spec["end_to_end"] if harness.applies(m, cell)]
        p = [m for m in spec["per_layer"] if harness.applies(m, cell)]
        assert len(e) >= 2 and p
    all_names = names + cells + list(e2e) + [m["name"] for m in spec["per_layer"]]
    assert len(set(all_names)) == len(all_names)


def test_config_files_hold_their_sizes():
    spec = harness.load_spec()
    for c in spec["configs"]:
        sizes = json.loads((harness.ROOT / c["file"]).read_text())
        assert sizes["name"] == c["name"] and sizes["source"] == c["source"]
        harness.config_module(c["name"]).model_config(sizes)
