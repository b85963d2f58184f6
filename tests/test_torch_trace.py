"""The program's spans and counters (``tpuseg_torch/utils/timer.py``): off
and shared while no profiler records; under ``torch.profiler`` nested
``tpuseg_torch/<stage>`` ranges and exact counters in ``do_train`` and
``YolactPredictor.predict_images``; and the training loops' console lines
timing whole iterations, batch build included."""
import dataclasses
import functools
import re
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from chip_smoke import synthetic_yolact_state_dict
from tests.test_torch_yolact_train_bn import _Dataset
from tests.test_yolact_engine import _write_synth_dataset
from tpuseg_torch.configs.presets import yolact_loss_config, yolact_model_config
from tpuseg_torch.data.coco_dataset import CocoDetectionDataset
from tpuseg_torch.engine import detectron_train_loop as TD
from tpuseg_torch.engine import yolact_train_loop as YTL
from tpuseg_torch.engine.yolact_engine import YolactPredictor
from tpuseg_torch.models import maskrcnn as M
from tpuseg_torch.models import yolact as Y
from tpuseg_torch.nn.resnet import ResNet
from tpuseg_torch.utils import profiler, timer

# pytest-xdist runs several workers on the CPU's cores: more torch threads
# each would only oversubscribe them
torch.set_num_threads(2)

SLEEP = 0.2  # seconds added to each example's build


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    """``tests/test_torch_train_loop.py``'s two 128x128 images, read by the
    port's dataset."""
    img_dir, ann = _write_synth_dataset(str(tmp_path_factory.mktemp("coco")))
    return CocoDetectionDataset(img_dir, ann, label_map={1: 1, 2: 2})


@pytest.fixture
def narrow(monkeypatch):
    """Mask R-CNN at a ResNet stem width of 16: the loop, not the model,
    is under test."""
    monkeypatch.setattr(M, "ResNet", functools.partial(ResNet, width=16))
    return M.MaskRCNNConfig(num_classes=3, rpn_pre_nms_top_n_train=64,
                            fpn_post_nms_top_n_train=32)


def ranges(prof) -> dict:
    """name -> [(start_ns, end_ns)] of the profiler's host ranges of the
    program's spans, the prefix taken off."""
    out = {}
    for e in prof.profiler.kineto_results.events():
        if (str(e.activity_type()) == "user_annotation"
                and e.name().startswith(timer.SPAN_PREFIX)):
            out.setdefault(e.name()[len(timer.SPAN_PREFIX):], []).append(
                (e.start_ns(), e.end_ns()))
    return out


def inside(child, parent) -> bool:
    return parent[0] <= child[0] and child[1] <= parent[1]


def children(spans: dict, parent: str, name: str) -> list:
    """For each ``parent`` range, how many ``name`` ranges lie in it."""
    return [sum(inside(c, p) for c in spans.get(name, []))
            for p in spans[parent]]


def test_spans_and_counters_are_off_without_a_profiler():
    timer.reset()
    a, b = timer.span("a"), timer.span("b")
    assert a is b and not isinstance(a, timer._Span)
    with a:
        with b:
            pass
    timer.count("n", 3)
    assert timer.counters() == {}
    assert timer.print_stats().splitlines()[2:] == []


def test_nested_spans_are_profiler_ranges_and_timers(capsys):
    timer.reset()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with timer.span("a"):
            with timer.span("b"):
                torch.ones(8) + 1
            timer.count("n", 3)
            timer.count("n")
    spans = ranges(prof)
    assert len(spans["a"]) == len(spans["b"]) == 1
    assert inside(spans["b"][0], spans["a"][0])
    assert timer.counters() == {"n": 4}
    out = timer.print_stats()
    rows = {r.split("|")[0].strip(): r for r in out.splitlines()}
    assert rows["a"].split("|")[1].strip() == "1" and "b" in rows
    assert rows["n"].split("|")[1].strip() == "4"
    timer.reset()
    assert timer.counters() == {}


def test_do_train_spans_and_counters(dataset, narrow, monkeypatch, tmp_path):
    """Two steps: each iteration holds one batch, step and readback; a
    decode per image; the crops counted are the images' non-crowd objects
    among their first ``max_gt``; the bytes counted are the batches'."""
    sent = []
    upload = TD.batch_to_device

    def spy(examples, dev):
        out = upload(examples, dev)
        sent.append(sum(t.nbytes for t in (out[0], out[1], *out[2].values())))
        return out

    monkeypatch.setattr(TD, "batch_to_device", spy)
    timer.reset()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _, it, _ = TD.do_train(dataset, narrow, max_steps=2,
                               checkpoint_period=10, log_every=10,
                               output_dir=str(tmp_path), device="cpu",
                               min_size=128, max_size=128)
    assert it == 2
    spans = ranges(prof)
    assert len(spans["loop.iter"]) == 2
    for name in ("loop.batch", "loop.step", "loop.readback"):
        assert children(spans, "loop.iter", name) == [1, 1], name
    per_pass = len(dataset.image_ids)  # both images are landscape
    for name in ("loop.decode", "loop.gt_masks", "loop.resize",
                 "loop.mask_crops"):
        assert children(spans, "loop.batch", name) == [per_pass] * 2, name
    assert children(spans, "loop.batch", "loop.upload") == [1, 1]
    objects = sum(int((~dataset.load_target(i)["iscrowd"].astype(bool)
                       )[:64].sum()) for i in dataset.image_ids)
    assert timer.counters() == {
        "loop.images": 2 * per_pass, "loop.gt_objects": 2 * objects,
        "loop.batches": 2, "loop.upload_bytes": sum(sent)}
    assert objects == 3


def test_predictor_spans_and_counters():
    cfg = dataclasses.replace(yolact_model_config("yolact_plus_resnet50"),
                              img_size=128)
    sd = synthetic_yolact_state_dict(Y.build_model(cfg), 2)
    pred = YolactPredictor(cfg, state_dict=sd, batch_size=2, device="cpu")
    rng = np.random.default_rng(4)
    imgs = [rng.integers(0, 256, hw + (3,), dtype=np.uint8)
            for hw in ((120, 160), (90, 70), (120, 160))]
    timer.reset()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        res = pred.predict_images(imgs)
    spans = ranges(prof)
    assert len(spans["predictor.request"]) == 1
    # two sizes: a batch of two and a batch of one
    assert children(spans, "predictor.request", "predictor.run") == [2]
    assert children(spans, "predictor.request", "predictor.download") == [2]
    assert children(spans, "predictor.request", "predictor.paste") == [3]
    c = timer.counters()
    assert c["predictor.images"] == 3
    assert c["predictor.masks"] == sum(len(r["scores"]) for r in res) > 0
    batches = [np.stack([imgs[0], imgs[2]]), imgs[1][None]]
    assert c["predictor.download_bytes"] == sum(
        v.nbytes for b in batches for v in pred.run_batch(b).values())
    timer.reset()
    assert pred.predict_images(imgs[:1])[0].keys() == res[0].keys()
    assert timer.counters() == {}


def test_trace_prints_the_span_table(tmp_path, capsys):
    with profiler.trace(str(tmp_path / "t")):
        with timer.span("stage"):
            timer.count("items", 2)
    out = capsys.readouterr().out
    assert "trace written to" in out
    assert re.search(r"stage\s+\|\s+1 \|", out), out
    assert re.search(r"items\s+\|\s+2\b", out), out


def slowed(fn):
    @functools.wraps(fn)
    def slow(*args, **kwargs):
        time.sleep(SLEEP)
        return fn(*args, **kwargs)
    return slow


def quick_step(keys):
    """A training step that takes no time: only the batch build is slow,
    so a figure that left it out would read far below ``SLEEP``."""
    def step(*args, **kwargs):
        return {k: torch.zeros(()) for k in keys}
    return step


def test_do_train_time_covers_the_batch_build(dataset, narrow, monkeypatch,
                                              tmp_path, capsys):
    monkeypatch.setattr(TD, "build_train_example",
                        slowed(TD.build_train_example))
    monkeypatch.setattr(TD, "train_step", quick_step(["total"]))
    TD.do_train(dataset, narrow, max_steps=2, checkpoint_period=10,
                log_every=1, output_dir=str(tmp_path), device="cpu",
                min_size=128, max_size=128)
    lines = re.findall(r"time: ([0-9.]+)  data: ([0-9.]+)  eta: ",
                       capsys.readouterr().out)
    assert len(lines) == 2
    sleep = SLEEP * len(dataset.image_ids)  # one batch holds both images
    for t, d in lines:
        assert float(t) >= float(d) >= sleep


def test_yolact_train_s_per_it_covers_the_batch_build(monkeypatch, tmp_path,
                                                      capsys):
    monkeypatch.setattr(YTL, "batch_to_device", slowed(YTL.batch_to_device))
    monkeypatch.setattr(YTL, "train_step",
                        quick_step(YTL.LOSS_KEYS + ("total",)))
    cfg = dataclasses.replace(yolact_model_config("yolact_plus_resnet50"),
                              img_size=64, num_classes=4, nms_top_k=8,
                              max_num_detections=5)
    YTL.train(_Dataset(), cfg, batch_size=2, max_steps=2, save_every=10,
              save_folder=str(tmp_path), cfg_name="tiny", log_every=1,
              loss_cfg=yolact_loss_config("yolact_plus_resnet50"),
              model=Y.build_model(cfg, torch.Generator().manual_seed(0)),
              device="cpu")
    per_it = re.findall(r"\|\| ([0-9.]+)s/it", capsys.readouterr().out)
    assert len(per_it) == 2
    assert all(float(s) >= SLEEP for s in per_it)
