"""The port's multi-device layer (``tpuseg_torch/parallel``) on the CPU:
``make_devices``, ``shard_batch`` and ``ShardedInference`` themselves, the
launch counter under threads, and the YOLACT and Mask R-CNN predictors on 4
CPU replicas (``devices=4``, one thread each) against tpuseg's
single-device predictors, with ``tests/test_parallel.py``'s configs,
weights (tpuseg's ``init_params``), inputs and tolerances. RetinaNet,
YOLOv3 and Pose2Seg through ``ShardedInference``:
``tests/test_torch_parallel_family.py``."""
import sys
import threading

import jax
import numpy as np
import pytest
import torch

from tpuseg.engine import maskrcnn_engine as JME
from tpuseg.engine.yolact_engine import YolactPredictor as JYolactPredictor
from tpuseg.models import maskrcnn as JM
from tpuseg.models import yolact as JY
from tpuseg_torch import kernels as K
from tpuseg_torch.engine.maskrcnn_engine import MaskRCNNPredictor
from tpuseg_torch.engine.yolact_engine import YolactPredictor
from tpuseg_torch.models import maskrcnn as M
from tpuseg_torch.models import yolact as Y
from tpuseg_torch.parallel.inference import ShardedInference
from tpuseg_torch.parallel.mesh import (make_devices, resolve_devices,
                                        shard_batch)
from tpuseg_torch.weights.from_jax import (state_dict_from_jax,
                                           yolact_state_dict_from_jax)

torch.set_num_threads(2)  # pytest-xdist's workers share the CPU's cores


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def test_make_devices_refuses_to_under_provision():
    visible = torch.cuda.device_count()
    with pytest.raises(ValueError, match="under-provision"):
        make_devices(visible + 1, "cuda")
    assert make_devices(4, "cpu") == [torch.device("cpu")] * 4
    assert make_devices("all", "cpu") == [torch.device("cpu")]
    assert resolve_devices(None, "cpu") == [torch.device("cpu")]
    assert resolve_devices("1", "cpu") == [torch.device("cpu")]
    assert len(resolve_devices("3", "cpu")) == 3
    assert resolve_devices(["cpu", "cpu"], "cuda") == [
        torch.device("cpu")] * 2


def test_shard_batch_keeps_the_batch_order():
    x = torch.arange(24).reshape(8, 3)
    shards = shard_batch({"x": x, "pair": (x[:, 0], [x[:, 1]])}, 4)
    assert len(shards) == 4
    for i, s in enumerate(shards):
        assert torch.equal(s["x"], x[2 * i:2 * i + 2])
        assert torch.equal(s["pair"][0], x[2 * i:2 * i + 2, 0])
        assert torch.equal(s["pair"][1][0], x[2 * i:2 * i + 2, 1])
    with pytest.raises(ValueError, match="does not divide"):
        shard_batch(torch.zeros(6, 2), 4)


def test_sharded_inference_order_and_replicas():
    """Each shard runs on its own replica, from a thread of its own, under
    inference mode; the rows come back in batch order."""
    seen = []
    lock = threading.Lock()

    def fn(module, x, extra):
        with lock:
            seen.append((threading.get_ident(), id(module),
                         torch.is_inference_mode_enabled()))
        return {"y": module(x) + extra["offset"], "n": x[:, :1]}

    lin = torch.nn.Linear(3, 2)
    si = ShardedInference(fn, lin, ["cpu"] * 4, n_batch_args=2)
    assert si.data_size == 4 and all(r is lin for r in si.replicas)
    x = torch.randn(8, 3)
    out = si(x, {"offset": torch.arange(8.0)[:, None]})
    with torch.no_grad():
        want = lin(x) + torch.arange(8.0)[:, None]
    assert torch.equal(out["y"], want) and torch.equal(out["n"], x[:, :1])
    assert len(seen) == 4 and all(mode for _, _, mode in seen)
    with pytest.raises(ValueError, match="does not divide"):
        si(torch.randn(6, 3), {"offset": torch.zeros(6, 1)})
    with pytest.raises(TypeError, match="batch argument"):
        si(x)


def test_launch_counter_is_exact_under_threads():
    """The kernels' launch counter, bumped from more threads than cores
    with a short switch interval, loses no count."""
    K.reset_launch_counts()
    n_threads, per = 32, 500
    prev = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(
            target=lambda: [K.count_launch("nms") for _ in range(per)])
            for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(prev)
    assert K.launch_counts()["nms"] == n_threads * per
    K.reset_launch_counts()


def test_yolact_predictor_on_4_replicas_matches_tpuseg(rng):
    """``tests/test_parallel.py::test_yolact_sharded_eval_matches_single_
    device``'s config, weights and images: the port on 4 CPU replicas
    against tpuseg's single-device predictor, valid detections at its
    tolerances (rtol 5e-3, atol 1e-4)."""
    jcfg = JY.YolactConfig(img_size=128, num_classes=5, nms_top_k=8,
                           max_num_detections=5)
    params = jax.jit(lambda k: JY.init_params(k, jcfg))(
        jax.random.PRNGKey(0))
    imgs = rng.integers(0, 255, (8, 128, 128, 3)).astype(np.uint8)
    want = JYolactPredictor(jcfg, params=params, batch_size=8).run_batch(imgs)

    cfg = Y.YolactConfig(img_size=128, num_classes=5, nms_top_k=8,
                         max_num_detections=5)
    sd = yolact_state_dict_from_jax(_np_tree(params), cfg)
    p4 = YolactPredictor(cfg, state_dict=sd, batch_size=8, device="cpu",
                         devices=4)
    assert p4.n_devices == 4
    got = {k: v.numpy() for k, v in p4.run_batch(imgs).items()}
    assert set(got) == set(want)
    np.testing.assert_array_equal(got["valid"], want["valid"])
    v = want["valid"]
    assert v.any()
    for k in ("boxes", "scores", "classes", "masks"):
        np.testing.assert_allclose(got[k][v], want[k][v], rtol=5e-3,
                                   atol=1e-4, err_msg=k)
    # a batch that does not divide runs padded with blank images
    got3 = {k: v.numpy() for k, v in p4.run_batch(imgs[:3]).items()}
    np.testing.assert_array_equal(got3["valid"], want["valid"][:3])
    v3 = want["valid"][:3]
    for k in ("boxes", "scores", "classes", "masks"):
        np.testing.assert_allclose(got3[k][v3], want[k][:3][v3], rtol=5e-3,
                                   atol=1e-4, err_msg=k)


def test_maskrcnn_predictor_on_4_replicas_matches_tpuseg(rng):
    """``test_maskrcnn_sharded_eval_matches_single_device``'s config,
    weights and images (48 x 96 canvas): the port on one device against
    tpuseg's single-device predictor, and on 4 CPU replicas against one
    device at rtol 1e-4 / atol 1e-4; 5 images pad to 8 and 1 image to 4,
    not to 2."""
    kw = dict(rpn_pre_nms_top_n=32, rpn_post_nms_top_n=32,
              fpn_post_nms_top_n=16, detections_per_img=4,
              pre_final_nms_topk=64, num_classes=5)
    jcfg = JM.MaskRCNNConfig(**kw)
    params = jax.jit(lambda k: JM.init_params(k, jcfg))(
        jax.random.PRNGKey(0))
    imgs = [rng.integers(0, 255, (50, 75, 3)).astype(np.uint8)
            for _ in range(8)]
    want = JME.MaskRCNNPredictor(
        cfg=jcfg, params=params, batch_size=8, min_image_size=48,
        max_image_size=96).run_on_bgr_images(imgs)

    cfg = M.MaskRCNNConfig(**kw)
    model = M.build_model(cfg)
    model.load_state_dict(state_dict_from_jax(_np_tree(params), cfg))
    p1 = MaskRCNNPredictor(model=model, min_image_size=48, max_image_size=96,
                           device="cpu")
    one = p1.run_on_bgr_images(imgs)
    # the port on one device against tpuseg: the cross-parity tolerances
    # of tests/test_torch_maskrcnn.py (the two frameworks round apart)
    assert sum(len(r["scores"]) for r in want) > 0
    for a, b in zip(one, want):
        np.testing.assert_array_equal(a["classes"], b["classes"])
        np.testing.assert_allclose(a["scores"], b["scores"], rtol=2e-4,
                                   atol=1e-5)
        np.testing.assert_allclose(a["boxes"], b["boxes"], rtol=1e-3,
                                   atol=0.05)
        assert (a["masks"] != b["masks"]).mean() <= 1e-3

    p4 = MaskRCNNPredictor(model=model, min_image_size=48, max_image_size=96,
                           device="cpu", devices=4)
    assert p4.n_devices == 4
    shapes = []
    forward = p4.forward
    p4.forward = lambda im, hw: shapes.append(im.shape[0]) or forward(im, hw)

    def check(got, ref):
        # 4 replicas against one device: test_parallel.py's tolerances
        assert len(got) == len(ref)
        for a, b in zip(got, ref):
            assert a.keys() == b.keys()
            for k in a:
                np.testing.assert_allclose(a[k], b[k], rtol=1e-4, atol=1e-4,
                                           err_msg=k)

    check(p4.run_on_bgr_images(imgs), one)
    check(p4.run_on_bgr_images(imgs[:5]), one[:5])
    check(p4.run_on_bgr_images(imgs[:1]), one[:1])
    assert shapes == [8, 8, 4]
