"""tpuseg_torch.data.coco_dataset and load_image_rgb, the port's COCO reader
and image decode, against tpuseg's on a tiny COCO dataset written here:
polygons, compressed and uncompressed RLE, a crowd and an unknown
category; PNG and JPEG images, with and without an EXIF orientation."""
import json

import numpy as np
import pytest
from PIL import Image

from tpuseg.data import coco_dataset as J_DS
from tpuseg.data.catalog import DatasetCatalog as J_Catalog
from tpuseg.data.image_io import load_image_rgb as j_load_rgb
from tpuseg.eval import rle as J_R
from tpuseg_torch.data import coco_dataset as DS
from tpuseg_torch.data.catalog import DatasetCatalog
from tpuseg_torch.data.image_io import load_image_bgr, load_image_rgb


def _write_dataset(root, rng, unknown_category=False):
    """Three PNG images (landscape, portrait, square) with polygon objects,
    a compressed-RLE object, an uncompressed-RLE crowd; category ids from
    the 91-id space (``unknown_category``: one id outside the label map)."""
    (root / "images").mkdir(exist_ok=True)
    images, anns = [], []
    for i, (h, w) in enumerate([(48, 64), (64, 48), (40, 40)], 1):
        Image.fromarray(rng.integers(0, 256, (h, w, 3)).astype(
            np.uint8)).save(root / "images" / f"{i:03d}.png")
        images.append({"id": i, "height": h, "width": w,
                       "file_name": f"{i:03d}.png"})
        for j, cat in enumerate((1, 18, 90)):
            x, y = 2 + 6 * j, 3 + 5 * j
            poly = [x, y, x + 15.5, y + 1.2, x + 12.3, y + 14.7, x - 0.4,
                    y + 10]
            anns.append({"id": len(anns) + 1, "image_id": i,
                         "category_id": cat, "bbox": [x, y, 15.5, 14.7],
                         "area": 150.0, "iscrowd": 0,
                         "segmentation": [poly, [x + 1, y + 1, x + 4, y + 1,
                                                 x + 4, y + 4]]})
        m = np.zeros((h, w), np.uint8)
        m[20:30, 10:35] = 1
        anns.append({"id": len(anns) + 1, "image_id": i, "category_id": 44,
                     "bbox": [10, 20, 25, 10], "area": 250.0, "iscrowd": 0,
                     "segmentation": J_R.encode(m)})
        m[5:12, 30:40] = 1
        anns.append({"id": len(anns) + 1, "image_id": i, "category_id": 1,
                     "bbox": [10, 5, 30, 25], "area": float(m.sum()),
                     "iscrowd": 1, "segmentation": {
                         "size": [h, w], "counts": [
                             int(c) for c in J_R.encode_counts(m)]}})
    if unknown_category:
        anns.append({**anns[0], "id": len(anns) + 1, "category_id": 12})
    ann = {"images": images, "annotations": anns,
           "categories": [{"id": c, "name": f"c{c}"}
                          for c in (1, 12, 18, 44, 90)]}
    path = root / "instances.json"
    path.write_text(json.dumps(ann))
    return str(root / "images"), str(path)


@pytest.mark.parametrize("include_crowd", [True, False])
@pytest.mark.parametrize("label_map", [DS.COCO_LABEL_MAP, None])
def test_load_target_equals_tpuseg(tmp_path, rng, include_crowd, label_map):
    img_dir, ann = _write_dataset(tmp_path, rng)
    got = DS.CocoDetectionDataset(img_dir, ann, label_map=label_map,
                                  include_crowd=include_crowd)
    want = J_DS.CocoDetectionDataset(img_dir, ann, label_map=label_map,
                                     include_crowd=include_crowd)
    assert got.image_ids == want.image_ids and len(got) == 3
    for iid in got.image_ids:
        assert got.image_path(iid) == want.image_path(iid)
        for with_masks in (True, False):
            g = got.load_target(iid, with_masks=with_masks)
            w = want.load_target(iid, with_masks=with_masks)
            assert g.keys() == w.keys()
            for k in g:
                np.testing.assert_array_equal(g[k], w[k], err_msg=k)
                assert np.asarray(g[k]).dtype == np.asarray(w[k]).dtype
        t = got.load_target(iid)
        assert t["masks"].shape == (len(t["boxes"]), t["height"], t["width"])
        assert t["masks"].sum() > 0
        assert int(t["iscrowd"].sum()) == int(include_crowd)
        # the annotation frame: the image decodes at the json's size
        np.testing.assert_array_equal(got.load_image(iid),
                                      want.load_image(iid))
    assert DS.COCO_LABEL_MAP == J_DS.COCO_LABEL_MAP
    assert DS.COCO_CLASSES == J_DS.COCO_CLASSES == 80


def test_unknown_category_raises_like_tpuseg(tmp_path, rng):
    img_dir, ann = _write_dataset(tmp_path, rng, unknown_category=True)
    with pytest.raises(KeyError) as want:
        J_DS.CocoDetectionDataset(img_dir, ann).load_target(1)
    with pytest.raises(KeyError) as got:
        DS.CocoDetectionDataset(img_dir, ann).load_target(1)
    assert got.value.args == want.value.args == (12,)


def test_load_image_rgb_png_is_exact(tmp_path, rng):
    img = rng.integers(0, 256, (37, 53, 3)).astype(np.uint8)
    path = str(tmp_path / "a.png")
    Image.fromarray(img).save(path)
    for ignore in (False, True):
        got = load_image_rgb(path, ignore_orientation=ignore)
        assert got.dtype == np.uint8 and got.flags["C_CONTIGUOUS"]
        np.testing.assert_array_equal(got, img)
        np.testing.assert_array_equal(
            got, j_load_rgb(path, ignore_orientation=ignore))
    np.testing.assert_array_equal(load_image_bgr(path), img[:, :, ::-1])


# measured here (PIL's libjpeg-turbo against cv2's): 0 levels; allowed 2,
# since two libjpeg builds may round the IDCT and upsampling differently
JPEG_TOLERANCE = 2


@pytest.mark.parametrize("orientation", [None, 1, 2, 3, 4, 5, 6, 7, 8])
def test_load_image_rgb_jpeg_with_exif_matches_tpuseg(tmp_path, rng,
                                                      orientation):
    """A JPEG written by PIL, with the EXIF orientation tag set (or none):
    in the display frame (the tag applied, as cv2.imread applies it) and
    in the annotation frame (the raw pixels)."""
    low = rng.integers(0, 256, (6, 9, 3)).astype(np.float64)
    img = np.clip(np.kron(low, np.ones((8, 8, 1)))[:45, :70]
                  + rng.normal(0, 20, (45, 70, 3)), 0, 255).astype(np.uint8)
    path = str(tmp_path / "e.jpg")
    im = Image.fromarray(img)
    if orientation is None:
        im.save(path, quality=92)
    else:
        exif = Image.Exif()
        exif[0x0112] = orientation
        im.save(path, quality=92, exif=exif.tobytes())
    for ignore in (False, True):
        got = load_image_rgb(path, ignore_orientation=ignore)
        want = j_load_rgb(path, ignore_orientation=ignore)
        assert got.shape == want.shape, (ignore, got.shape, want.shape)
        err = np.abs(got.astype(int) - want).max()
        assert err <= JPEG_TOLERANCE, (ignore, err)
    rotated = orientation in (5, 6, 7, 8)
    assert load_image_rgb(path).shape[:2] == ((70, 45) if rotated
                                              else (45, 70))
    assert load_image_rgb(path, ignore_orientation=True).shape[:2] == (45, 70)


def test_dataset_catalog_matches_tpuseg():
    assert DatasetCatalog.DATASETS.keys() == J_Catalog.DATASETS.keys()
    for name in DatasetCatalog.DATASETS:
        assert DatasetCatalog.get(name) == J_Catalog.get(name)
    with pytest.raises(KeyError, match="unknown dataset"):
        DatasetCatalog.get("no_such_set")
    DatasetCatalog.register("tiny_val", "tiny/images", "tiny/ann.json")
    try:
        assert DatasetCatalog.get("tiny_val")["args"] == {
            "root": "datasets/tiny/images",
            "ann_file": "datasets/tiny/ann.json"}
    finally:
        del DatasetCatalog.DATASETS["tiny_val"]
