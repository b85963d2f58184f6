"""One run of one cell: everything the cell needs is found by name, so a
later change adds a configuration, a traffic mix, a kind of cell or a
per-layer metric as new files alone.

- ``BENCHMARK.json``'s workload names a configuration and a traffic mix;
- ``traffic/<mix>.json`` holds the mix's parameters and names its window,
  ``windows/<window>.py``, which drives the port and says which end-to-end
  metrics it measured;
- ``configs/<config>.json`` holds the sizes, ``configs/<config>.py`` what
  every kind of cell of the configuration shares (its model config and
  weight scheme), and ``configs/<config>.<window>.py`` the port's entry
  points that the window drives;
- ``reference/<config>.<window>.py`` is the plain reference of that kind
  of cell, ``limits/<cell>.json`` the limits of its check;
- ``metrics/<metric>.py`` reads one per-layer metric from a traced run.

The window is driven, the output is checked against the reference, and the
result line is put together."""
from __future__ import annotations

import importlib.util
import json
import sys
import time
from pathlib import Path

import torch

from benchmark.common import card, check, trace

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent


def load_spec(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def cell_of(spec: dict, name: str) -> dict:
    for w in spec["workloads"]:
        if w["name"] == name:
            return w
    raise SystemExit(f"no workload {name!r} in BENCHMARK.json")


def applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_file(folder: str, stem: str):
    """``benchmark/<folder>/<stem>.py`` as a module, loaded once a process
    (a stem may hold dots, as ``maskrcnn_r50fpn.train`` does)."""
    name = f"benchmark.{folder}.{stem.replace('.', '__')}"
    if name not in sys.modules:
        spec = importlib.util.spec_from_file_location(
            name, BENCH / folder / f"{stem}.py")
        mod = importlib.util.module_from_spec(spec)
        sys.modules[name] = mod
        try:
            spec.loader.exec_module(mod)
        except BaseException:
            del sys.modules[name]
            raise
    return sys.modules[name]


def config_module(name: str):
    """What every kind of cell of configuration ``name`` shares."""
    return load_file("configs", name)


def config_sizes(name: str) -> dict:
    return json.loads((BENCH / "configs" / f"{name}.json").read_text())


def traffic(name: str) -> dict:
    return json.loads((BENCH / "traffic" / f"{name}.json").read_text())


def window_module(mix: dict):
    return load_file("windows", mix["window"])


def entry_module(config: str, mix: dict):
    """The port's entry points of ``config`` that the mix's window drives."""
    return load_file("configs", f"{config}.{mix['window']}")


def reference_module(config: str, mix: dict):
    return load_file("reference", f"{config}.{mix['window']}")


def metric_reader(name: str):
    return load_file("metrics", name).read


def device_info(run: dict, dev) -> dict:
    return {"platform": "gpu" if dev.type == "cuda" else "cpu",
            "kind": card.device_name(dev),
            "count": 1, "memory_peak_bytes": int(run["peak"])}


def run_cell(spec: dict, cell: dict, seed: int, seconds: float,
             traced: bool, t_start: float, dev=None, control=None) -> tuple:
    """-> (result dict, the numbers compared with their limits, log
    lines). ``control`` "bf16" runs the configuration's lower-precision
    path in the program's place (the check's control; never in a run of
    the benchmark itself)."""
    dev = dev or torch.device("cuda", 0)
    sizes = config_sizes(cell["config"])
    mix = traffic(cell["traffic"])
    entry = entry_module(cell["config"], mix)
    window = window_module(mix)
    dtype = torch.bfloat16 if control == "bf16" else None
    run = window.run(entry, sizes, mix, seed, seconds, traced, dev, t_start,
                     dtype)
    t_check = time.perf_counter()
    numbers, about = window.check(reference_module(cell["config"], mix), run,
                                  sizes, mix, seed, dev)
    limits = check.limits_of(cell["name"])
    correct = check.verdict(numbers, limits) and run["items"] > 0
    log = [f"launches in the window: {run['launches']} over {run['items']} "
           f"{run['item_name']}",
           f"peak device memory {run['peak']} bytes; {card.nvidia_smi()}",
           f"check: {json.dumps(dict(numbers, **about))} "
           f"({time.perf_counter() - t_check:.1f} s)"]
    log += run.get("log", [])
    if traced:
        metrics = {}
        ctx = dict(run, events=trace.events_of(run["prof"]))
        for m in spec["per_layer"]:
            if applies(m, cell["name"]):
                v = metric_reader(m["name"])(ctx)
                if v is not None:
                    metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        ev = ctx["events"]
        lo = min(e.start_ns for e in ev)
        hi = max(e.end_ns for e in ev)
        busy = trace.busy_ns(ev, lo, hi) / 1e9
        dev_info = dict(device_info(run, dev), busy_s=busy,
                        window_s=run["window_s"])
        breakdown = {"device_ops": trace.top_ops(ev),
                     "idle_gaps": trace.longest_gaps(ev, lo, hi)}
    else:
        metrics = {m["name"]: {"value": run["e2e"][m["name"]],
                               "unit": m["unit"]}
                   for m in spec["end_to_end"] if applies(m, cell["name"])}
        dev_info = device_info(run, dev)
        breakdown = None
    checks = {k: {"value": numbers[k], "limit": v} for k, v in limits.items()}
    result = {"correct": bool(correct), "attempted": run["items"] + run["failed"],
              "failed": run["failed"], "metrics": metrics, "device": dev_info}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = checks
    return result, checks, log
