"""RetinaNet, YOLOv3 and Pose2Seg through the port's ``ShardedInference``
on 4 CPU replicas against tpuseg's single-device programs, with
``tests/test_parallel.py``'s configs, weights (tpuseg's ``init_params``),
inputs and tolerances (the port's YOLACT and Mask R-CNN predictors:
``tests/test_torch_parallel.py``)."""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from tpuseg.models import pose2seg as JP2S
from tpuseg.models import retinanet as JRN
from tpuseg.models import yolov3 as JY3
from tpuseg_torch.models import pose2seg as P2S
from tpuseg_torch.models import retinanet as RN
from tpuseg_torch.models import yolov3 as Y3
from tpuseg_torch.parallel.inference import ShardedInference
from tpuseg_torch.weights.from_jax import (pose2seg_state_dict_from_jax,
                                           retinanet_state_dict_from_jax,
                                           yolov3_state_dict_from_jax)

torch.set_num_threads(2)  # pytest-xdist's workers share the CPU's cores

DEVICES = ["cpu"] * 4


def _init(module, cfg):
    params = jax.jit(lambda k: module.init_params(k, cfg))(
        jax.random.PRNGKey(0))
    return params, jax.tree.map(np.asarray, params)


def _nchw(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(a.transpose(0, 3, 1, 2).copy())


def test_retinanet_on_4_replicas_matches_tpuseg(rng):
    kw = dict(pre_nms_top_n=32, detections_per_img=8, num_classes=5)
    jcfg = JRN.RetinaNetConfig(**kw)
    params, tree = _init(JRN, jcfg)
    images = rng.standard_normal((8, 128, 128, 3)).astype(np.float32) * 2.0
    hw = np.asarray([[120, 128]] * 8, np.int32)
    want = jax.device_get(jax.jit(
        lambda p, im, h: JRN.forward_inference(p, im, h, jcfg))(
            params, jnp.asarray(images), jnp.asarray(hw)))

    model = RN.build_model(RN.RetinaNetConfig(**kw))
    model.load_state_dict(retinanet_state_dict_from_jax(tree))
    si = ShardedInference(RN.forward_inference, model, DEVICES,
                          n_batch_args=2)
    got = {k: v.numpy() for k, v in si(
        _nchw(images), torch.from_numpy(hw).long()).items()}
    v = np.asarray(want["valid"])
    assert v.any()
    np.testing.assert_array_equal(got["valid"], v)
    for k, atol in (("scores", 1e-4), ("boxes", 1e-2), ("classes", 0)):
        np.testing.assert_allclose(got[k][v], np.asarray(want[k])[v],
                                   rtol=1e-4, atol=atol, err_msg=k)


def test_yolov3_on_4_replicas_matches_tpuseg(rng):
    kw = dict(input_size=96, num_classes=6, max_det=8, pre_nms_topk=64)
    jcfg = JY3.YoloV3Config(**kw)
    cfg = Y3.YoloV3Config(**kw)
    params, tree = _init(JY3, jcfg)
    images = (rng.standard_normal((8, 96, 96, 3)).astype(np.float32) * 0.2
              + 0.5)

    def pipe(p, im):
        return JY3.postprocess(*JY3.decode(JY3.forward(p, im, jcfg), jcfg),
                               jcfg)

    want = jax.device_get(jax.jit(pipe)(params, jnp.asarray(images)))
    model = Y3.build_model(cfg)
    model.load_state_dict(yolov3_state_dict_from_jax(tree))
    si = ShardedInference(lambda m, im: Y3.detect(m, im, cfg), model,
                          DEVICES)
    got = {k: v.numpy() for k, v in si(_nchw(images)).items()}
    v = np.asarray(want["valid"])
    assert v.any()
    np.testing.assert_array_equal(got["valid"], v)
    for k in ("scores", "classes"):
        np.testing.assert_allclose(got[k][v], np.asarray(want[k])[v],
                                   rtol=1e-2, atol=1e-4, err_msg=k)
    # random weights send exp() of the wh decode to huge or infinite
    # coordinates, where the two frameworks' last bits of the exponent
    # move the box by percents: the boxes held where tpuseg's are below
    # 1e6 px, at tests/test_parallel.py's tolerances
    box, ref = got["boxes"][v], np.asarray(want["boxes"])[v]
    sane = np.abs(ref) < 1e6
    assert sane.sum() >= 20
    np.testing.assert_allclose(box[sane], ref[sane], rtol=1e-2, atol=1e-4)
    np.testing.assert_array_equal(np.abs(box[~sane]) >= 1e6, True)


def test_pose2seg_on_4_replicas_matches_tpuseg(rng):
    kw = dict(input_size=64, align_size=16, max_people=2, paste_size=32)
    jcfg = JP2S.Pose2SegConfig(**kw)
    cfg = P2S.Pose2SegConfig(**kw)
    params, tree = _init(JP2S, jcfg)
    b, pp = 8, jcfg.max_people
    images = rng.standard_normal((b, 64, 64, 3)).astype(np.float32)
    theta = np.tile(np.asarray([[0.3, 0.0, 0.1], [0.0, 0.3, 0.1]],
                               np.float32), (b, pp, 1, 1))
    inv_theta = np.tile(np.asarray([[3.0, 0.0, -0.3], [0.0, 3.0, -0.3]],
                                   np.float32), (b, pp, 1, 1))
    pvalid = np.ones((b, pp), bool)
    skel = rng.standard_normal(
        (b, pp, cfg.align_size, cfg.align_size,
         cfg.skeleton_channels)).astype(np.float32)
    want = jax.device_get(jax.jit(
        lambda p, *a: JP2S.forward(p, *a[:4], jcfg, skel_feats=a[4]))(
            params, *map(jnp.asarray, (images, theta, inv_theta, pvalid,
                                       skel))))

    model = P2S.build_model(cfg)
    model.load_state_dict(pose2seg_state_dict_from_jax(tree))
    si = ShardedInference(lambda m, batch: m(*batch), model, DEVICES)
    got = si((_nchw(images), *map(torch.from_numpy,
                                  (theta, inv_theta, pvalid, skel))))
    np.testing.assert_allclose(got["masks"].numpy(),
                               np.asarray(want["masks"]), rtol=1e-4,
                               atol=1e-5)
    # logits are ~1e4 under random weights: 1e-2 relative, as
    # tests/test_parallel.py
    np.testing.assert_allclose(got["aligned_logits"].numpy(),
                               np.asarray(want["aligned_logits"]), rtol=1e-2,
                               atol=1e-4)
