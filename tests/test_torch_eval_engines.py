"""The port's evaluation engines, config and CLIs: evaluate_coco and
evaluate_dataset against tpuseg's with one stub predictor (fixed
detections, the duck-typed path both engines allow: equal stats, maps and
json dumps), ConfigNode against tpuseg's on every configs/*.yaml, and the
two YOLACT CLIs' main() with --device=cpu on a five-image dataset at a
64x64 input (the model's size cut by the test)."""
import dataclasses
import json
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from tpuseg.data.coco_dataset import CocoDetectionDataset as JDataset
from tpuseg.engine import maskrcnn_engine as J_ME
from tpuseg.engine import trainer as J_T
from tpuseg.engine import yolact_engine as J_YE
from tpuseg.engine.config import ConfigNode as JConfigNode
from tpuseg.eval import rle as J_R
from tpuseg.models import yolact as J_Y
from tpuseg_torch.configs import presets
from tpuseg_torch.data.coco_dataset import CocoDetectionDataset
from tpuseg_torch.engine import maskrcnn_engine as ME
from tpuseg_torch.engine import yolact_engine as YE
from tpuseg_torch.engine.config import ConfigNode
from tpuseg_torch.models import yolact as Y
from tpuseg_torch.tools import yolact_eval, yolact_train
from tpuseg_torch.weights.from_jax import yolact_state_dict_from_jax
from tpuseg_torch.weights.npz_io import load_params_npz

torch.set_num_threads(2)  # pytest-xdist's workers share the CPU's cores
ROOT = Path(__file__).resolve().parent.parent
CATS = (1, 18, 90)  # contiguous classes 0, 16, 79


@pytest.fixture(scope="module")
def coco(tmp_path_factory):
    """Five PNG images (three landscape 48x64, two portrait 64x48), 2-4
    polygon objects each, a crowd on image 2; categories 1, 18, 90."""
    root = tmp_path_factory.mktemp("coco")
    (root / "images").mkdir()
    rng = np.random.default_rng(0)
    images, anns = [], []
    for i, (h, w) in enumerate([(48, 64), (64, 48), (48, 64), (64, 48),
                                (48, 64)], 1):
        img = rng.integers(40, 90, (h, w, 3)).astype(np.uint8)
        for j in range(int(rng.integers(2, 5))):
            bw, bh = (int(v) for v in rng.integers(8, 24, 2))
            x, y = int(rng.integers(0, w - bw)), int(rng.integers(0, h - bh))
            img[y:y + bh, x:x + bw] = rng.integers(120, 255, 3)
            anns.append({"id": len(anns) + 1, "image_id": i,
                         "category_id": int(CATS[j % 3]),
                         "bbox": [x, y, bw, bh], "area": float(bw * bh),
                         "iscrowd": 0, "segmentation": [[
                             x, y, x + bw, y, x + bw, y + bh, x, y + bh]]})
        if i == 2:
            m = np.zeros((h, w), np.uint8)
            m[2:10, 2:20] = 1
            anns.append({"id": len(anns) + 1, "image_id": i,
                         "category_id": 1, "bbox": [2, 2, 18, 8],
                         "area": 144.0, "iscrowd": 1, "segmentation": {
                             "size": [h, w], "counts": [
                                 int(c) for c in J_R.encode_counts(m)]}})
        Image.fromarray(img).save(root / "images" / f"{i:03d}.png")
        images.append({"id": i, "height": h, "width": w,
                       "file_name": f"{i:03d}.png"})
    ann = root / "instances.json"
    ann.write_text(json.dumps({
        "images": images, "annotations": anns,
        "categories": [{"id": c, "name": f"c{c}"} for c in CATS]}))
    return str(root / "images"), str(ann)


def _fake_dets(rng, h, w, n):
    x1 = rng.uniform(0, w - 10, n)
    y1 = rng.uniform(0, h - 10, n)
    boxes = np.stack([x1, y1, x1 + rng.uniform(4, 20, n),
                      y1 + rng.uniform(4, 20, n)], 1).astype(np.float32)
    boxes[:, 0::2] = boxes[:, 0::2].clip(0, w - 1)
    boxes[:, 1::2] = boxes[:, 1::2].clip(0, h - 1)
    masks = np.zeros((n, h, w), np.uint8)
    for k, (a, b, c, d) in enumerate(boxes.astype(int)):
        masks[k, b:d + 1, a:c + 1] = 1
    return boxes, masks


class StubMaskRCNN:
    """Fixed detections for each image of ``coco``, which it knows by its
    pixels: its gt boxes jittered (their classes, mostly) and a few random
    boxes, scores drawn from a generator seeded with the image id."""

    def __init__(self, coco):
        ds = CocoDetectionDataset(*coco, label_map=None)
        self.ds = ds
        self.ids = {ds.load_image(i)[:, :, ::-1].tobytes(): i
                    for i in ds.image_ids}

    def run_on_bgr_image(self, img):
        return self.run_on_bgr_images([img])[0]

    def run_on_bgr_images(self, imgs):
        out = []
        for img in imgs:
            iid = self.ids[img.tobytes()]
            rng = np.random.default_rng(iid)
            anns = [a for a in self.ds.coco.imgToAnns[iid]
                    if not a["iscrowd"]]
            gt = np.asarray([a["bbox"] for a in anns], np.float32)
            gt[:, 2:] += gt[:, :2]
            k = int(rng.integers(1, 6))
            boxes, _ = _fake_dets(rng, *img.shape[:2], k)
            boxes = np.concatenate(
                [gt + rng.normal(0, 1, gt.shape).astype(np.float32), boxes])
            boxes[:, 0::2] = boxes[:, 0::2].clip(0, img.shape[1] - 1)
            boxes[:, 1::2] = boxes[:, 1::2].clip(0, img.shape[0] - 1)
            masks = np.zeros((len(boxes), *img.shape[:2]), np.uint8)
            for j, (a, b, c, d) in enumerate(boxes.astype(int)):
                masks[j, b:d + 1, a:c + 1] = 1
            classes = [ME.COCO_CATEGORY_IDS.index(a["category_id"])
                       for a in anns] + list(rng.choice([0, 16, 79], k))
            out.append({"boxes": boxes, "scores": rng.uniform(
                0.05, 1, len(boxes)).astype(np.float32),
                "classes": np.asarray(classes), "masks": masks})
        return out


def test_evaluate_coco_equals_tpuseg(coco):
    img_dir, ann = coco
    got = ME.evaluate_coco(StubMaskRCNN(coco), CocoDetectionDataset(
        img_dir, ann, label_map=None), batch_size=2, progress=False)
    want = J_ME.evaluate_coco(StubMaskRCNN(coco), JDataset(
        img_dir, ann, label_map=None), batch_size=2, progress=False)
    assert got.keys() == want.keys() == {"bbox", "segm"}
    for k in got:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        assert (got[k][:3] > 0).all()
    assert ME.COCO_CATEGORY_IDS == J_ME.COCO_CATEGORY_IDS


class StubYolact:
    """YOLACT's detection layout at a 32x32 mask size, and its own
    postprocess_image (nearest-neighbour mask upsampling). The n-th image
    of a run is the n-th of ``coco`` (evaluate_dataset goes in id order):
    its gt boxes jittered and a few random boxes, drawn from a generator
    seeded with n."""

    def __init__(self, coco, batch_size):
        self.cfg = presets.yolact_model_config("yolact_plus_resnet50")
        self.batch_size = batch_size
        self.ds = CocoDetectionDataset(*coco)
        self.n = 0

    def run_batch(self, batch):
        b, k = len(batch), 12
        out = {n: [] for n in ("boxes", "scores", "classes", "masks",
                               "valid", "mask_scores")}
        for _ in range(b):
            rng = np.random.default_rng(100 + self.n)
            iid = self.ds.image_ids[min(self.n, len(self.ds) - 1)]
            self.n += 1
            info, t = self.ds.coco.imgs[iid], self.ds.load_target(iid)
            scale = np.asarray([info["width"], info["height"]] * 2)
            gt = t["boxes"][:k] / scale
            n_gt = len(gt)
            boxes, _ = _fake_dets(rng, 32, 32, k - n_gt)
            boxes = np.concatenate([gt + rng.normal(0, 0.02, gt.shape),
                                    boxes / 32]).clip(0, 1).astype(
                np.float32)
            masks = np.zeros((k, 32, 32), np.float32)
            for j, (x1, y1, x2, y2) in enumerate((boxes * 32).astype(int)):
                masks[j, y1:y2 + 1, x1:x2 + 1] = 1
            out["boxes"].append(boxes)
            out["masks"].append(masks)
            out["scores"].append(rng.uniform(0, 1, k).astype(np.float32))
            out["mask_scores"].append(rng.uniform(0, 1, k).astype(np.float32))
            out["classes"].append(np.concatenate(
                [t["classes"][:k], rng.choice([0, 16, 79], k - n_gt)]))
            out["valid"].append(rng.random(k) < 0.9)
        return {n: np.stack(v) for n, v in out.items()}

    def postprocess_image(self, det_i, h, w, score_threshold=0.0):
        valid = det_i["valid"] & (det_i["scores"] > score_threshold)
        iy = np.arange(h) * 32 // h
        ix = np.arange(w) * 32 // w
        masks = (det_i["masks"][valid][:, iy][:, :, ix] > 0.5).astype(
            np.uint8)
        boxes = (det_i["boxes"][valid] * [w, h, w, h]).astype(
            np.int64).astype(np.float32)
        return {"boxes": boxes, "scores": det_i["scores"][valid],
                "classes": det_i["classes"][valid], "masks": masks,
                "mask_scores": det_i["mask_scores"][valid]}


@pytest.mark.parametrize("batch_size", [2, 5])  # a padded last chunk, none
def test_evaluate_dataset_equals_tpuseg(coco, tmp_path, batch_size):
    img_dir, ann = coco
    got = YE.evaluate_dataset(
        StubYolact(coco, batch_size), CocoDetectionDataset(img_dir, ann),
        progress=False, output_coco_json=str(tmp_path / "p/y"))
    want = J_YE.evaluate_dataset(
        StubYolact(coco, batch_size), JDataset(img_dir, ann), progress=False,
        output_coco_json=str(tmp_path / "j/y"))
    assert got == want
    assert 0 < got["box"]["all"] < 100 and 0 < got["mask"]["all"] < 100
    for kind in ("bbox", "mask"):
        g = (tmp_path / f"p/y_{kind}.json").read_text()
        assert g == (tmp_path / f"j/y_{kind}.json").read_text()
        assert len(json.loads(g)) > 20


@pytest.mark.parametrize("yaml_file", sorted(
    p.name for p in (ROOT / "configs").glob("*.yaml")))
def test_config_node_equals_tpuseg(yaml_file):
    opts = ["MODEL.WEIGHT", "w.pth", "SOLVER.BASE_LR", "0.01",
            "SOLVER.STEPS", "[3, 5]", "NEW.KEY", "text"]
    got, want = ConfigNode({"MODEL": {"WEIGHT": ""}}), JConfigNode(
        {"MODEL": {"WEIGHT": ""}})
    for cfg in (got, want):
        cfg.merge_from_file(str(ROOT / "configs" / yaml_file))
        cfg.merge_from_list(opts)
    assert got._to_dict() == want._to_dict()
    assert got.dump() == want.dump()
    assert got.SOLVER.STEPS == [3, 5] and got.SOLVER.BASE_LR == 0.01
    clone = got.clone().freeze()
    with pytest.raises(AttributeError, match="frozen"):
        clone.MODEL.WEIGHT = "x"
    assert clone.copy({"MODEL": {"WEIGHT": "y"}}).MODEL.WEIGHT == "y"
    # every yaml dispatches to tpuseg's variant, with its config's values
    # in every field the two configs share
    variant, mcfg = ME.model_config_from_node(got)
    j_variant, j_mcfg = J_ME.model_config_from_node(want)
    assert variant == j_variant == ("retinanet" if "retinanet" in yaml_file
                                    else "c4" if "C4" in yaml_file else "fpn")
    assert mcfg.depth == (101 if "R_101" in yaml_file else 50)
    shared = [f.name for f in dataclasses.fields(mcfg)
              if hasattr(j_mcfg, f.name)]
    assert len(shared) == len(dataclasses.fields(mcfg))
    for name in shared:
        assert getattr(mcfg, name) == getattr(j_mcfg, name), name
    if variant != "retinanet":
        assert mcfg.mask_on == ("faster" not in yaml_file)


# --- the YOLACT CLIs on the CPU (Mask R-CNN's: test_torch_maskrcnn_cli.py) ---


@pytest.fixture
def small_yolact(monkeypatch):
    """YOLACT's presets at a 64x64 input and 10 detections an image."""
    full = presets.yolact_model_config

    def small(preset):
        return dataclasses.replace(full(preset), img_size=64, nms_top_k=20,
                                   max_num_detections=10)

    monkeypatch.setattr(presets, "yolact_model_config", small)


def test_yolact_eval_cli_on_cpu(coco, small_yolact, tmp_path, monkeypatch,
                                capsys):
    img_dir, ann = coco
    monkeypatch.chdir(tmp_path)  # --output_coco_json writes results/
    maps = yolact_eval.main([
        "--config", "yolact_plus_resnet50_config", "--valid_images", img_dir,
        "--valid_info", ann, "--max_images", "4", "--batch_size", "2",
        "--output_coco_json", "--device=cpu"])
    assert maps.keys() == {"box", "mask"}
    assert np.isfinite(maps["box"]["all"])
    for kind in ("bbox", "mask"):
        json.loads((tmp_path / f"results/yolact_{kind}.json").read_text())
    out = capsys.readouterr().out
    assert "config: yolact_plus_resnet50_config" in out
    assert "== COCOeval segm ==" in out
    src = str(Path(img_dir) / "001.png")
    yolact_eval.main(["--config", "yolact_plus_resnet50_config",
                      f"--image={src}:{tmp_path / 'out.png'}",
                      "--device=cpu"])
    assert Image.open(tmp_path / "out.png").size == (64, 48)
    assert yolact_eval.infer_config_name(
        "w/yolact_plus_resnet50_54_800000.pth", None) == (
            "yolact_plus_resnet50_config")
    with pytest.raises(NotImplementedError, match="Multi-GPU"):
        yolact_eval.main(["--devices", "2", "--device=cpu"])


def test_yolact_train_cli_on_cpu(coco, small_yolact, tmp_path, capsys):
    img_dir, ann = coco
    history = yolact_train.main([
        "--config", "yolact_plus_resnet50_config", "--train_images",
        img_dir, "--train_info", ann, "--batch_size", "2", "--max_steps",
        "1", "--save_interval", "1", "--save_folder", str(tmp_path),
        "--device=cpu"])
    assert len(history) == 1
    assert set(history[0]) == {"B", "C", "M", "S", "I", "total"}
    assert all(np.isfinite(v) for v in history[0].values())
    assert (tmp_path / "yolact_plus_resnet50_0_1.pth").exists()
    assert "1 iterations; last losses: B" in capsys.readouterr().out
    # bf16 mixed precision and the JAX tree's npz, which tpuseg's
    # load_params_npz reads on its own template and the port reads back
    history = yolact_train.main([
        "--config", "yolact_plus_resnet50_config", "--train_images",
        img_dir, "--train_info", ann, "--batch_size", "2", "--max_steps",
        "1", "--save_interval", "1", "--save_folder", str(tmp_path),
        "--save_format", "npz", "--compute_dtype", "bfloat16",
        "--device=cpu"])
    assert all(np.isfinite(v) for v in history[0].values())
    path = str(tmp_path / "yolact_plus_resnet50_0_1.npz")
    cfg = presets.yolact_model_config("yolact_plus_resnet50")
    jcfg = J_Y.YolactConfig(**{f.name: getattr(cfg, f.name)
                               for f in dataclasses.fields(cfg)})
    like = jax.eval_shape(lambda: J_Y.init_params(jax.random.PRNGKey(0),
                                                  jcfg))
    tree = J_T.load_params_npz(path, like)
    for got, want in zip(jax.tree.leaves(tree), jax.tree.leaves(like)):
        assert got.shape == want.shape and got.dtype == np.float32
    model = Y.build_model(cfg)
    model.load_state_dict(yolact_state_dict_from_jax(
        load_params_npz(path), cfg), strict=True)


def test_clis_default_to_the_card(coco):
    """Without --device each CLI asks for the card, and raises where there
    is none."""
    from tpuseg_torch.tools import test_net, train_net

    if torch.cuda.is_available():
        pytest.skip("a card is present: the CLIs would run on it")
    img_dir, ann = coco
    for main, argv in (
            (test_net.main, ["--images", img_dir, "--annotations", ann]),
            (train_net.main, ["DATASETS.IMAGES", img_dir,
                              "DATASETS.ANNOTATIONS", ann]),
            (yolact_eval.main, ["--config", "yolact_resnet50_config"]),
            (yolact_train.main, ["--train_images", img_dir,
                                 "--train_info", ann])):
        with pytest.raises(RuntimeError, match="CUDA"):
            main(argv)


def test_dataset_presets_match_tpuseg():
    from tpuseg.engine.config import get_config

    for name, ds in presets.DATASETS.items():
        assert ds == dict(get_config(name)), name
    for name, preset in presets.PRESETS.items():
        assert preset["dataset"] == get_config(f"{name}_config").dataset
