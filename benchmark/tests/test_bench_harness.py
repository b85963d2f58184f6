"""The harness: found by name (a later change adds a configuration, a mix
and a metric as new files), no result without a card or outside a
checkout, and no JAX anywhere."""
from __future__ import annotations

import ast
import json
import os
import shutil
import subprocess
import sys

from benchmark.common import card, harness

ROOT = harness.ROOT
ENV = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}


def checkout(tmp_path):
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    return tmp_path


def add_entries(root, configs=(), workloads=(), end_to_end=(), per_layer=()):
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["configs"] += list(configs)
    spec["workloads"] += list(workloads)
    spec["end_to_end"] += list(end_to_end)
    spec["per_layer"] += list(per_layer)
    (root / "BENCHMARK.json").write_text(json.dumps(spec))


def run_code(root, code: str):
    """``code`` in a checkout ``root`` beside the port."""
    (root / "tpuseg_torch").symlink_to(ROOT / "tpuseg_torch")
    out = subprocess.run([sys.executable, "-c", code], cwd=root, env=ENV,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    return out.stdout.strip()


def snapshot(root) -> dict:
    return {p: p.read_bytes() for p in (root / "benchmark").rglob("*")
            if p.is_file() and "__pycache__" not in p.parts}


def test_new_files_are_found_by_name(tmp_path):
    root = checkout(tmp_path)
    before = snapshot(root)
    b = root / "benchmark"
    (b / "configs" / "tiny.json").write_text(json.dumps(
        {"name": "tiny", "source": "https://example.org/tiny", "depth": 1}))
    (b / "configs" / "tiny.py").write_text(
        "def model_config(sizes):\n    return sizes['depth']\n")
    (b / "configs" / "tiny.stream.py").write_text("ENTRY = 'stream'\n")
    (b / "reference" / "tiny.stream.py").write_text("REF = 'stream'\n")
    (b / "traffic" / "tiny_mix.json").write_text(json.dumps(
        {"window": "stream", "arrivals": {"process": "open", "rate_hz": 5.0,
                                          "gaps": "exponential", "burst": 2,
                                          "seed": 1},
         "frames": 2, "frame_hw": [8, 8], "sample": 1}))
    (b / "metrics" / "tiny_ms.stream.py").write_text(
        "def read(ctx):\n    return ctx['x'] * 2\n")
    (b / "limits" / "tiny.tiny_mix.json").write_text(json.dumps(
        {"limits": {"det_miss": 0.1}}))
    add_entries(root, configs=[{
        "name": "tiny", "source": "https://example.org/tiny",
        "file": "benchmark/configs/tiny.json", "reduced": [], "why": "a test"}],
        workloads=[{"name": "tiny.tiny_mix", "config": "tiny",
                    "traffic": "tiny_mix", "chips": 1, "why": "a test"}])
    assert run_code(root, (
        "from benchmark.common import harness, check\n"
        "spec = harness.load_spec()\n"
        "cell = harness.cell_of(spec, 'tiny.tiny_mix')\n"
        "sizes = harness.config_sizes(cell['config'])\n"
        "mix = harness.traffic(cell['traffic'])\n"
        "assert harness.config_module('tiny').model_config(sizes) == 1\n"
        "assert harness.entry_module('tiny', mix).ENTRY == 'stream'\n"
        "assert harness.reference_module('tiny', mix).REF == 'stream'\n"
        "assert hasattr(harness.window_module(mix), 'run')\n"
        "assert harness.metric_reader('tiny_ms.stream')({'x': 21}) == 42\n"
        "assert check.limits_of('tiny.tiny_mix') == {'det_miss': 0.1}\n"
        "print('found')\n")) == "found"
    assert snapshot(root) == {**before, **{p: v for p, v in snapshot(root).items()
                                           if p not in before}}


TINY_WINDOW = """
def run(entry, sizes, mix, seed, seconds, trace, dev, t_start, dtype):
    n = entry.items(sizes, mix, seed)
    return {"e2e": {"setup_s": 1.5, "tiny_img_s": n / seconds},
            "items": n, "failed": 0, "peak": 0, "launches": {},
            "item_name": "images", "window_s": seconds, "x": n}


def check(ref, run, sizes, mix, seed, dev):
    return {"gap": ref.gap(run["items"])}, {}
"""


def test_a_new_kind_of_cell_of_a_configuration_is_only_new_files(tmp_path):
    """A second kind of cell for a configuration that has one: its window,
    entry points, reference, mix, limits and metrics as new files, and its
    end-to-end metric in the result line."""
    root = checkout(tmp_path)
    before = snapshot(root)
    b = root / "benchmark"
    (b / "windows" / "tiny.py").write_text(TINY_WINDOW)
    (b / "configs" / "maskrcnn_r50fpn.tiny.py").write_text(
        "def items(sizes, mix, seed):\n"
        "    return sizes['num_classes'] * mix['per_class']\n")
    (b / "reference" / "maskrcnn_r50fpn.tiny.py").write_text(
        "def gap(n):\n    return 0.0 if n == 81 * 2 else 1.0\n")
    (b / "traffic" / "tiny_offline.json").write_text(json.dumps(
        {"window": "tiny", "per_class": 2}))
    (b / "limits" / "maskrcnn_r50fpn.tiny_offline.json").write_text(
        json.dumps({"limits": {"gap": 0.5}}))
    (b / "metrics" / "tiny_ms.offline.py").write_text(
        "def read(ctx):\n    return ctx['x'] / 2\n")
    cell = "maskrcnn_r50fpn.tiny_offline"
    add_entries(
        root, workloads=[{"name": cell, "config": "maskrcnn_r50fpn",
                          "traffic": "tiny_offline", "chips": 1,
                          "why": "a test"}],
        end_to_end=[{"name": "tiny_img_s", "unit": "img/s", "better": "higher",
                     "bound": 0.05, "source": "host_clock",
                     "workloads": [cell]}],
        per_layer=[{"name": "tiny_ms.offline", "unit": "ms", "better": "lower",
                    "source": "program_span", "layer": "models",
                    "moves": "tiny_img_s", "workloads": [cell]}])
    line = run_code(root, (
        "import json, time, torch\n"
        "from benchmark.common import harness\n"
        "spec = harness.load_spec()\n"
        f"res, checks, _ = harness.run_cell(spec, harness.cell_of(spec, {cell!r}),"
        " 7, 2.0, False, time.perf_counter(), dev=torch.device('cpu'))\n"
        "print(json.dumps(res))\n"))
    res = json.loads(line)
    assert res["correct"] and res["attempted"] == 162
    assert res["metrics"] == {"setup_s": {"value": 1.5, "unit": "s"},
                              "tiny_img_s": {"value": 81.0, "unit": "img/s"}}
    assert res["checks"] == {"gap": {"value": 0.0, "limit": 0.5}}
    assert snapshot(root) == {**before, **{p: v for p, v in snapshot(root).items()
                                           if p not in before}}


def run_bench(cwd):
    return subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload",
         "maskrcnn_r50fpn.train_b2", "--seed", "3000000000", "--seconds", "1",
         "--trace", "0"], cwd=cwd, env=ENV, capture_output=True, text=True,
        timeout=120)


def test_without_a_card_no_result():
    out = run_bench(ROOT)
    assert out.returncode != 0 and out.stdout == ""


def test_outside_a_checkout_no_result(tmp_path):
    out = run_bench(checkout(tmp_path))
    assert out.returncode != 0 and out.stdout == ""


def imports_of(path) -> set:
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", "")
              == "import_module" and node.args
              and isinstance(node.args[0], ast.Constant)):
            names.add(node.args[0].value.split(".")[0])
    return names


def test_no_jax_under_the_benchmark():
    files = [p for p in (ROOT / "benchmark").rglob("*.py")
             if "tests" not in p.parts]
    assert files
    for p in files:
        bad = imports_of(p) & set(card.FORBIDDEN)
        assert not bad, f"{p}: {bad}"


def test_the_reference_imports_nothing_of_the_port():
    for p in (ROOT / "benchmark" / "reference").rglob("*.py"):
        assert "tpuseg_torch" not in imports_of(p), p
        assert "tpuseg_torch" not in p.read_text().replace(
            "``tpuseg_torch/", "").split('"""', 2)[-1], p


def test_forbidden_modules_compare_whole_names():
    assert card.forbidden_modules(["tpuseg_torch", "tpuseg_torch.kernels",
                                   "jaxtyping", "numpy"]) == []
    assert card.forbidden_modules(["jax.numpy", "tpuseg.ops", "flax"]) == [
        "flax", "jax", "tpuseg"]
