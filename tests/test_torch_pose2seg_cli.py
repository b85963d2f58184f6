"""Pose2Seg's evaluation and its two CLIs on the CPU: evaluate_pose2seg
against tpuseg's with a ground-truth-driven stub predictor (stats equal),
pose2seg_test and pose2seg_train through main(argv) with --device cpu on
a keypoint dataset in tmp_path (the model cut to a 64 canvas, a ResNet of
stem width 16 and one seg unit), and the training CLI's canvas and masks
against tpuseg's cv2 recipe."""
import functools

import cv2
import numpy as np
import pytest
import torch

import chip_smoke
from tests.test_torch_pose2seg import WIDTH
from tpuseg.data.coco_dataset import CocoDetectionDataset as JDataset
from tpuseg.engine import pose2seg_engine as JE
from tpuseg.eval import rle as jrle
from tpuseg_torch.data.coco_dataset import CocoDetectionDataset
from tpuseg_torch.engine import pose2seg_engine as TE
from tpuseg_torch.eval import rle
from tpuseg_torch.models import pose2seg as TP
from tpuseg_torch.tools import pose2seg_test, pose2seg_train
from tpuseg_torch.weights.pose2seg_map import load_pose2seg_weights

torch.set_num_threads(2)

SMALL = dict(input_size=64, feature_channels=32, seg_units=1, align_size=16,
             max_people=4, paste_size=32)


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    """chip_smoke's keypoint dataset (2-5 people an image, a crowd and a
    one-keypoint person each) at 60x80 and 80x60."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(chip_smoke, "P2S_DATASET_HW", (60, 80))
        return chip_smoke.write_keypoint_dataset(
            tmp_path_factory.mktemp("keypoints"), 3)


@pytest.fixture
def small(monkeypatch):
    """The CLIs' default config and ResNet cut to a size the CPU runs."""
    monkeypatch.setattr(TP, "Pose2SegConfig",
                        functools.partial(TP.Pose2SegConfig, **SMALL))
    monkeypatch.setattr(TP, "ResNetFPN", functools.partial(TP.ResNetFPN,
                                                           width=WIDTH))


class StubPredictor:
    """Each person's ground-truth mask, found by its keypoints: shifted by
    0-3 px (a few IoUs below 1) and every fifth person invalid."""

    def __init__(self, dataset, decode):
        self.anns = [a for a in dataset.coco.dataset["annotations"]
                     if a.get("keypoints")]
        self.decode, self.calls = decode, 0

    def run_on_image(self, img, kpts):
        h, w = img.shape[:2]
        masks, valid = [], []
        for kp in kpts:
            ann = next(a for a in self.anns if np.array_equal(
                np.asarray(a["keypoints"]).reshape(-1, 3), kp))
            m = self.decode(ann["segmentation"], h, w)
            masks.append(np.roll(m, ann["id"] % 4, axis=1))
            valid.append(ann["id"] % 5 != 0)
        self.calls += 1
        return {"masks": np.asarray(masks, np.uint8),
                "valid": np.asarray(valid)}


def test_evaluate_matches_tpuseg(dataset):
    """evaluate_pose2seg of the port and of tpuseg over the same dataset
    and the same stub predictions: COCOeval's 12 stats equal."""
    img_dir, ann = dataset
    got_pred = StubPredictor(CocoDetectionDataset(img_dir, ann, None),
                             lambda s, h, w: rle.decode(rle.segm_to_rle(
                                 s, h, w)))
    got = TE.evaluate_pose2seg(got_pred, CocoDetectionDataset(img_dir, ann,
                                                              None),
                               progress=False)
    want = JE.evaluate_pose2seg(
        StubPredictor(JDataset(img_dir, ann, label_map=None),
                      lambda s, h, w: jrle.decode(jrle.segm_to_rle(s, h, w))),
        JDataset(img_dir, ann, label_map=None), progress=False)
    assert got_pred.calls == chip_smoke.P2S_DATASET_IMAGES
    np.testing.assert_array_equal(got, want)
    assert 0.3 < got[0] < 1.0


def test_pose2seg_test_cli(dataset, small, tmp_path):
    """pose2seg_test --coco and --OCHuman (the dataset as val and test)
    with --weights: each run's 12 stats finite and equal to
    evaluate_pose2seg's of a predictor built on the same checkpoint."""
    img_dir, ann = dataset
    model = TP.build_model(TP.Pose2SegConfig(),
                           torch.Generator().manual_seed(2))
    ckpt = str(tmp_path / "last.pkl")
    TE.save_pose2seg_checkpoint(ckpt, model)
    stats = pose2seg_test.main([
        "--weights", ckpt, "--coco", "--coco_images", img_dir, "--coco_ann",
        ann, "--OCHuman", "--ochuman_images", img_dir, "--ochuman_val", ann,
        "--ochuman_test", ann, "--device", "cpu"])
    assert sorted(stats) == ["OCHumanTest", "OCHumanVal", "cocoVal"]
    want = TE.evaluate_pose2seg(
        TE.Pose2SegPredictor(weights=ckpt, device="cpu"),
        CocoDetectionDataset(img_dir, ann, None), progress=False)
    for s in stats.values():
        assert s.shape == (12,) and np.isfinite(s).all()
        np.testing.assert_array_equal(s, want)


def test_pose2seg_train_cli(dataset, small, tmp_path):
    """pose2seg_train for 3 steps with --device cpu (--batch_size parsed,
    one canvas a step, as the reference CLI): finite losses, and the saved
    checkpoint reads back through load_pose2seg_weights, moved from the
    seed-0 initialisation."""
    img_dir, ann = dataset
    save = tmp_path / "out" / "pose2seg_last.pth"
    losses = pose2seg_train.main([
        "--images", img_dir, "--annotations", ann, "--steps", "3",
        "--batch_size", "4", "--save", str(save), "--device", "cpu"])
    assert len(losses) == 3 and np.isfinite(losses).all()
    sd, cfg = load_pose2seg_weights(str(save), TP.Pose2SegConfig())
    assert cfg.cat_skeleton and cfg.seg_units == 1
    init = TP.build_model(TP.Pose2SegConfig(),
                          torch.Generator().manual_seed(0)).state_dict()
    assert not torch.equal(sd["segnet.conv1.weight"],
                           init["segnet.conv1.weight"])
    model = TP.build_model(cfg)
    model.load_state_dict(sd, strict=True)


def test_train_example_matches_the_reference_recipe(dataset, small):
    """train_example against tpuseg's CLI recipe with cv2: the canvas
    within one uint8 level of cv2.resize (normalised), the people's
    thetas and skeleton features equal (the first max_people people), the
    ground-truth masks on at most 1 % other pixels."""
    img_dir, ann = dataset
    ds = CocoDetectionDataset(img_dir, ann, None)
    cfg = TP.Pose2SegConfig()
    s = cfg.input_size
    n = 0
    for iid in ds.image_ids:
        ex = pose2seg_train.train_example(ds, iid, cfg)
        img = ds.load_image(iid)
        h, w = img.shape[:2]
        scale = s / max(h, w)
        nh, nw = int(h * scale), int(w * scale)
        canvas = np.zeros((s, s, 3), np.float32)
        canvas[:nh, :nw] = cv2.resize(img, (nw, nh))
        canvas = ((canvas / 255.0 - [0.485, 0.456, 0.406])
                  / [0.229, 0.224, 0.225])
        np.testing.assert_allclose(ex["images"][0].transpose(1, 2, 0),
                                   canvas, rtol=0, atol=1.01 / 255 / 0.224)
        people = [a for a in ds.coco.imgToAnns[iid] if not a["iscrowd"]
                  and (np.asarray(a["keypoints"])[2::3] > 0).sum() >= 2
                  ][:cfg.max_people]
        for i, a in enumerate(people):
            kp = np.asarray(a["keypoints"], np.float64).reshape(-1, 3)
            kp[:, :2] *= scale
            A, _, _ = TP.choose_template(kp, cfg)
            np.testing.assert_array_equal(ex["theta"][0, i],
                                          TP.affine_to_theta(A, s, s))
            np.testing.assert_array_equal(
                ex["skel"][0, i], TP.skeleton_feats_for_person(kp, A, cfg))
            m = rle.decode(rle.segm_to_rle(a["segmentation"], h, w))
            want = cv2.resize(m.astype(np.float32), (nw, nh)) > 0.5
            assert (ex["gt_masks"][0, i, :nh, :nw] != want).mean() <= 0.01
            n += 1
        assert ex["valid"][0].sum() == len(people)
    assert n >= 2 * len(ds.image_ids)
