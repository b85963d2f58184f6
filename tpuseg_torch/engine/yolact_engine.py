"""YOLACT predictor and evaluation engine (port of
``tpuseg/engine/yolact_engine.py``, Yolact.jittor eval.py parity).

Device side: ``yolact_preprocess`` (bilinear resize to the square input,
normalisation), the model's forward in ``dtype``, predictions cast to f32,
:func:`~tpuseg_torch.models.yolact.detect`.
:meth:`YolactPredictor.postprocess_image`: upstream's
``output_utils.postprocess``, the masks upsampled to the image with
half-pixel bilinear interpolation (``F.interpolate``, which equals the
JAX engine's ``cv2.resize(INTER_LINEAR)``), binarised at 0.5, the boxes
scaled to pixels and truncated to integers. Masks that lie on a CUDA
device are pasted there by ``kernels/mask_paste.py`` and only the uint8
masks come back; masks on the host are pasted on the host.
:func:`evaluate_dataset` gives YOLACT's own mAP table over a COCO dataset
(``tpuseg_torch/eval``), and with ``output_coco_json`` the two COCO result
jsons and their COCOeval.
"""
from __future__ import annotations

import json
import os
import time

import numpy as np
import torch
import torch.nn.functional as F

from tpuseg_torch.kernels.mask_paste import paste_masks
from tpuseg_torch.models import yolact as Y
from tpuseg_torch.ops.preprocess import yolact_preprocess
from tpuseg_torch.parallel.inference import ShardedInference
from tpuseg_torch.parallel.mesh import resolve_devices
from tpuseg_torch.utils import timer
from tpuseg_torch.weights.yolact_map import load_yolact_weights


class YolactPredictor:
    """YOLACT inference on ``device``. Weights: a ``state_dict`` with
    upstream's keys, an upstream ``.pth`` (``weights``), or random ones from
    a ``torch.Generator`` seeded with 0. ``dtype`` is the model's (f32 or
    bf16); ``batch_size`` the chunk :meth:`predict_images` runs at once.
    ``devices`` (``parallel/mesh.py::resolve_devices``): more than one
    shards each batch across a replica per device
    (``parallel/inference.py``)."""

    def __init__(self, cfg: Y.YolactConfig, state_dict: dict | None = None,
                 weights: str | None = None, batch_size: int = 1,
                 dtype: torch.dtype = torch.float32, device="cuda",
                 devices=None):
        if (torch.device(device).type == "cuda"
                and not torch.cuda.is_available()):
            raise RuntimeError(
                "device 'cuda' requested but CUDA is unavailable")
        device_list = resolve_devices(devices, device)
        self.device = device_list[0]
        self.n_devices = len(device_list)
        self.cfg = cfg
        self.batch_size = batch_size
        self.dtype = dtype
        if weights:
            state_dict = load_yolact_weights(weights)
        model = Y.build_model(
            cfg, None if state_dict else torch.Generator().manual_seed(0))
        if state_dict:
            model.load_state_dict(state_dict, strict=True)
        self.model = model.to(self.device, dtype).eval()
        self.priors = torch.from_numpy(Y.make_priors_np(cfg)).to(self.device)
        self._sharded = (ShardedInference(self._run, self.model, device_list)
                         if self.n_devices > 1 else None)

    def _run(self, model: Y.Yolact, images: torch.Tensor) -> dict:
        x = yolact_preprocess(images, self.cfg.img_size).to(self.dtype)
        preds = {k: v.float() for k, v in model(x).items()}
        return Y.detect(preds, self.priors.to(images.device), self.cfg,
                        maskiou_net=model.maskiou_net)

    def run_batch(self, images_u8) -> dict:
        """uint8 RGB [B, H, W, 3] (numpy or tensor; one size for the batch,
        resized to the model's square input on the device) -> detections
        on the (first) device: boxes [B, K, 4] normalised xyxy, scores,
        classes, masks [B, K, Sp, Sp], valid (and mask_scores for
        YOLACT++). With several devices, a batch that does not divide
        across them runs padded with blank images."""
        with timer.span("predictor.run"):
            images = torch.as_tensor(images_u8)
            if self._sharded is not None:
                b = images.shape[0]
                pad = (-b) % self.n_devices
                if pad:
                    images = torch.cat([images, images.new_zeros(
                        (pad,) + images.shape[1:])])
                return {k: v[:b] for k, v in self._sharded(images).items()}
            with torch.inference_mode():
                return self._run(self.model, images.to(self.device))

    def postprocess_image(self, det_i: dict, h: int, w: int,
                          score_threshold: float = 0.0) -> dict:
        """Slot i of a batch (numpy or tensors; masks [K, Sp, Sp] may stay
        on a CUDA device) -> its detections in image coordinates: boxes
        [n, 4] (integer pixels), scores, classes, masks [n, h, w] uint8
        (and mask_scores), all numpy."""
        with timer.span("predictor.paste"):
            masks = det_i["masks"]
            on_card = torch.is_tensor(masks) and masks.device.type == "cuda"
            det_i = {k: v.cpu().numpy() if torch.is_tensor(v) else v
                     for k, v in det_i.items()
                     if not (on_card and k == "masks")}
            valid = det_i["valid"] & (det_i["scores"] > score_threshold)
            if on_card:
                # pasted on the card; the uint8 masks come back into a fresh
                # pinned tensor, since the caller keeps the array
                kept = np.flatnonzero(valid)
                pasted = paste_masks(masks, kept, h, w)
                host = torch.empty(pasted.shape, dtype=torch.uint8,
                                   pin_memory=True)
                host.copy_(pasted)
                masks = host.numpy()
                timer.count("predictor.masks_pasted_on_device", len(kept))
                timer.count("predictor.download_bytes", host.nbytes)
            else:
                # paste_masks_plain's arithmetic, kept inline: the harness's
                # fault benchmark/tests/faults.py::masks_nearest plants
                # nearest sampling through this module's F
                masks = torch.from_numpy(
                    np.ascontiguousarray(det_i["masks"][valid]))
                if len(masks):
                    masks = F.interpolate(masks[:, None].float(),
                                          size=(h, w), mode="bilinear",
                                          align_corners=False)[:, 0]
                masks = (masks > 0.5).numpy().astype(np.uint8).reshape(
                    -1, h, w)
            px = det_i["boxes"][valid] * np.asarray([w, h, w, h], np.float32)
            px[:, 0::2] = np.clip(px[:, 0::2], 0, w)
            px[:, 1::2] = np.clip(px[:, 1::2], 0, h)
            out = {"boxes": px.astype(np.int64).astype(np.float32),
                   "scores": det_i["scores"][valid],
                   "classes": det_i["classes"][valid], "masks": masks}
            if "mask_scores" in det_i:
                out["mask_scores"] = det_i["mask_scores"][valid]
            return out

    def predict_images(self, imgs_rgb: list,
                       score_threshold: float = 0.0) -> list:
        """uint8 RGB images of any sizes -> per image, the detections of
        :meth:`postprocess_image`. Images of one size run ``batch_size`` at
        a time. Masks on a CUDA device stay there for the paste; the other
        detections come to the host."""
        with timer.span("predictor.request"):
            results = [None] * len(imgs_rgb)
            by_size = {}
            for i, img in enumerate(imgs_rgb):
                by_size.setdefault(img.shape[:2], []).append(i)
            for (h, w), ids in by_size.items():
                for s in range(0, len(ids), self.batch_size):
                    chunk = ids[s:s + self.batch_size]
                    det = self.run_batch(np.stack([imgs_rgb[i]
                                                   for i in chunk]))
                    on_card = det["masks"].is_cuda
                    with timer.span("predictor.download"):
                        host = {k: v.cpu().numpy() for k, v in det.items()
                                if not (on_card and k == "masks")}
                    timer.count("predictor.download_bytes",
                                sum(v.nbytes for v in host.values()))
                    det = {**det, **host}
                    for j, i in enumerate(chunk):
                        results[i] = self.postprocess_image(
                            {k: v[j] for k, v in det.items()}, h, w,
                            score_threshold)
        timer.count("predictor.images", len(results))
        timer.count("predictor.masks", sum(len(r["scores"]) for r in results))
        return results


def evaluate_dataset(predictor: YolactPredictor, dataset, max_images=None,
                     score_threshold: float = 0.0, progress=True,
                     output_coco_json: str | None = None) -> dict:
    """Full-val mAP table (eval.py's mode without image arguments) ->
    all_maps.

    Images are decoded in the annotation frame by
    :class:`NativeImageLoader` and stretched to the model's square input,
    ``predictor.batch_size`` at a time, the next chunk decoding on one
    thread while the device runs the current one. With
    ``output_coco_json``, also dumps COCO-format results to
    ``<path>_{bbox,mask}.json`` and runs the port's COCOeval on them
    (eval.py --output_coco_json parity).
    """
    from concurrent.futures import ThreadPoolExecutor

    from tpuseg_torch.data.native_loader import NativeImageLoader
    from tpuseg_torch.eval.yolact_map import (calc_map, make_ap_data,
                                              prep_metrics, print_maps)

    cfg = predictor.cfg
    ids = dataset.image_ids
    if max_images:
        ids = ids[:max_images]
    bs = predictor.batch_size
    ap_data = make_ap_data(cfg.num_classes - 1)
    t_infer = 0.0
    n_done = 0
    coco_results = [] if output_coco_json is not None else None
    label_map_inv = (
        {v: k for k, v in dataset.label_map.items()}
        if getattr(dataset, "label_map", None) else {})
    loader = NativeImageLoader()
    prefetcher = ThreadPoolExecutor(1)

    def load_chunk(chunk):
        paths = [dataset.image_path(iid) for iid in chunk]
        batch, hw = loader.load_batch(paths, cfg.img_size, cfg.img_size)
        metas = [(iid, int(hw[i, 0]), int(hw[i, 1]))
                 for i, iid in enumerate(chunk)]
        return batch, metas

    chunks = [ids[s:s + bs] for s in range(0, len(ids), bs)]
    # pipeline: the next chunk decodes on the loader pool while the device
    # runs the current one
    pending = prefetcher.submit(load_chunk, chunks[0]) if chunks else None
    try:
        for start in range(0, len(ids), bs):
            chunk = ids[start:start + bs]
            batch, metas = pending.result()
            nxt = start // bs + 1
            pending = (prefetcher.submit(load_chunk, chunks[nxt])
                       if nxt < len(chunks) else None)
            if len(chunk) < bs:
                batch = np.pad(batch, ((0, bs - len(chunk)), (0, 0), (0, 0),
                                       (0, 0)))
            t0 = time.perf_counter()
            dets = {k: v.cpu().numpy() if torch.is_tensor(v)
                    else np.asarray(v)
                    for k, v in predictor.run_batch(batch).items()}
            t_infer += time.perf_counter() - t0
            for bi, (iid, h, w) in enumerate(metas):
                det_i = {k: v[bi] for k, v in dets.items()}
                final = predictor.postprocess_image(det_i, h, w,
                                                    score_threshold)
                gt = dataset.load_target(iid)
                prep_metrics(ap_data, final, gt)
                if coco_results is not None:
                    coco_results.extend(
                        detections_to_coco_json(final, iid, label_map_inv))
                n_done += 1
            if progress:
                print(f"\r{n_done}/{len(ids)} images "
                      f"({n_done / max(t_infer, 1e-9):.1f} img/s device)",
                      end="", flush=True)
    finally:
        # the prefetch pool must not leak a worker thread per
        # evaluate_dataset call (one process may evaluate many checkpoints)
        if pending is not None:
            pending.cancel()
        prefetcher.shutdown(wait=False)
    if progress:
        print()
    all_maps = calc_map(ap_data, cfg.num_classes - 1)
    print_maps(all_maps)
    if coco_results is not None:
        from tpuseg_torch.eval.cocoeval import COCOeval

        # two jsons like the reference: the mask file must NOT carry bbox
        # keys (loadRes' bbox branch would take precedence and bin segm
        # detections by box area instead of mask area) and uses the
        # maskiou-rescored score when present
        bbox_res = [
            {k: v for k, v in r.items()
             if k not in ("segmentation", "mask_score")}
            for r in coco_results
        ]
        mask_res = [
            {**{k: v for k, v in r.items()
                if k not in ("bbox", "mask_score")},
             "score": r.get("mask_score", r["score"])}
            for r in coco_results
        ]
        d = os.path.dirname(output_coco_json)
        if d:
            os.makedirs(d, exist_ok=True)
        with open(f"{output_coco_json}_bbox.json", "w") as f:
            json.dump(bbox_res, f)
        with open(f"{output_coco_json}_mask.json", "w") as f:
            json.dump(mask_res, f)
        for iou_type, res in (("bbox", bbox_res), ("segm", mask_res)):
            print(f"== COCOeval {iou_type} ==")
            E = COCOeval(dataset.coco, dataset.coco.loadRes(res), iou_type)
            E.evaluate()
            E.accumulate()
            E.summarize()
    return all_maps


def detections_to_coco_json(final: dict, image_id: int, label_map_inv: dict):
    """One image's final dets -> COCO result dicts (bbox + segm).

    The combined dicts carry a 'mask_score' side-key (YOLACT++ maskiou
    rescoring) that the dump step splits into the reference's separate
    bbox/mask jsons."""
    from tpuseg_torch.eval import rle as rle_mod

    out = []
    for i in range(len(final["scores"])):
        x1, y1, x2, y2 = final["boxes"][i]
        cat = label_map_inv.get(int(final["classes"][i]) + 1,
                                int(final["classes"][i]) + 1)
        det = {
            "image_id": int(image_id),
            "category_id": int(cat),
            "bbox": [float(x1), float(y1), float(x2 - x1), float(y2 - y1)],
            "score": float(final["scores"][i]),
            "segmentation": rle_mod.encode(final["masks"][i]),
        }
        if "mask_scores" in final:
            det["mask_score"] = float(final["mask_scores"][i])
        out.append(det)
    return out
