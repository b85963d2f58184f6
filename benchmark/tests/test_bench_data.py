"""The traffic generators: the dataset writer and the stream's frames are
functions of their parameters and seed."""
from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from benchmark.common import arrivals, dataset, frames, harness
from benchmark.reference.frozen import detectron_data as DD

SPEC = {"seed": 3, "images": 6, "sizes": [[96, 64], [64, 96], [80, 80]],
        "instances_mean": 7.3, "instances_max": 50, "crowd_share": 0.2,
        "box_side": [0.05, 0.6]}


def test_dataset_is_a_function_of_its_spec(tmp_path):
    a = dataset.ensure(SPEC, tmp_path / "a")
    b = dataset.ensure(SPEC, tmp_path / "b")
    assert (a / "instances.json").read_text() == (b / "instances.json").read_text()
    for f in sorted((a / "images").iterdir()):
        assert f.read_bytes() == (b / "images" / f.name).read_bytes()
    d = json.loads((a / "instances.json").read_text())
    assert len(d["images"]) == 6
    assert {(i["width"], i["height"]) for i in d["images"]} <= {
        (96, 64), (64, 96), (80, 80)}
    assert any(x["iscrowd"] for x in d["annotations"])
    c = dataset.ensure(dict(SPEC, seed=4), tmp_path / "a")
    assert (c / "instances.json").read_text() != (a / "instances.json").read_text()
    # a second call finds the written dataset and writes nothing
    before = (a / "instances.json").stat().st_mtime_ns
    dataset.ensure(SPEC, tmp_path / "a")
    assert (a / "instances.json").stat().st_mtime_ns == before


def test_the_port_reads_the_dataset_as_the_reference(tmp_path):
    from tpuseg_torch.data.coco_dataset import CocoDetectionDataset

    root = dataset.ensure(SPEC, tmp_path)
    port = CocoDetectionDataset(str(root / "images"), str(root / "instances.json"))
    ref = DD.CocoData(str(root / "images"), str(root / "instances.json"))
    assert port.image_ids == ref.image_ids
    for iid in ref.image_ids:
        assert np.array_equal(port.load_image(iid), ref.load_image(iid))
        p, r = port.load_target(iid), ref.load_target(iid)
        for k in ("boxes", "classes", "iscrowd", "masks"):
            assert np.array_equal(p[k], r[k]), k


def test_instance_counts_have_the_mean_and_a_tail():
    n = dataset.instance_counts(np.random.default_rng(0), 20000, 7.3, 50)
    assert abs(n.mean() - 7.3) < 0.2 and n.min() >= 1 and n.max() == 50


def test_frames_are_a_function_of_the_seed():
    dev = torch.device("cpu")
    a = frames.frames(2**31 + 5, 3, 48, 64, dev)
    assert a.shape == (3, 48, 64, 3) and a.dtype == np.uint8
    assert np.array_equal(a, frames.frames(2**31 + 5, 3, 48, 64, dev))
    assert not np.array_equal(a, frames.frames(2**31 + 6, 3, 48, 64, dev))


def test_batch_plan_visits_each_image_once_a_pass(tmp_path):
    root = dataset.ensure(dict(SPEC, images=12), tmp_path)
    data = DD.CocoData(str(root / "images"), str(root / "instances.json"))
    plan = DD.batch_plan(data, 2**33 + 1, 2, 5)
    seen = [iid for chunk in plan for iid, _ in chunk]
    assert len(seen) == len(set(seen)) == 10
    assert plan == DD.batch_plan(data, 2**33 + 1, 2, 5)
    for chunk in plan:
        w = [data.imgs[i]["width"] >= data.imgs[i]["height"] for i, _ in chunk]
        assert len(set(w)) == 1


def test_every_cell_finds_its_window_entry_points_and_reference():
    for w in harness.load_spec()["workloads"]:
        mix = harness.traffic(w["traffic"])
        for folder, stem in (("windows", mix["window"]),
                             ("configs", f"{w['config']}.{mix['window']}"),
                             ("reference", f"{w['config']}.{mix['window']}")):
            assert (harness.BENCH / folder / f"{stem}.py").exists(), (w, stem)
        if "arrivals" in mix:
            arrivals.is_closed(mix["arrivals"])


@pytest.mark.parametrize("gaps,burst", [("fixed", 1), ("exponential", 1),
                                        ("exponential", 4)])
def test_open_arrivals_offer_the_same_set_in_another_order(gaps, burst):
    spec = {"process": "open", "rate_hz": 8.0, "gaps": gaps, "burst": burst,
            "seed": 5}
    a = arrivals.open_due(spec, 2**31 + 3, 30.0)
    assert np.array_equal(a, arrivals.open_due(spec, 2**31 + 3, 30.0))
    assert np.all(np.diff(a) >= 0) and a[0] == 0.0 and a[-1] < 30.0
    assert abs(len(a) / 30.0 - 8.0) <= 8.0 * 0.1
    assert np.all(np.bincount(np.unique(a, return_inverse=True)[1]) == burst)
    b = arrivals.open_due(spec, 2**31 + 4, 30.0)
    if gaps == "exponential":
        assert not np.array_equal(a, b)
        ga, gb = (np.round(np.diff(np.unique(x)), 9) for x in (a, b))
        # the window cuts each order at another place: most gaps are shared
        assert len(np.intersect1d(ga, gb)) >= 0.8 * min(len(ga), len(gb))
    else:
        assert np.array_equal(a, b)


def test_arrival_processes_are_named():
    assert arrivals.is_closed({"process": "closed"})
    assert not arrivals.is_closed({"process": "open"})
    with pytest.raises(ValueError):
        arrivals.is_closed({"process": "poisson"})
