#!/usr/bin/env python3
"""GPU smoke test of tpuseg_torch, the PyTorch + CUDA port.

    python3 chip_smoke.py

Needs one CUDA card and nvcc (builds the kernels from tpuseg_torch/csrc).
Phases, one line each; any failure raises and exits non-zero:
  1. the card (nvidia-smi name and power limit);
  2. build of the CUDA kernels (each kernel's registers and spills from
     ptxas);
  3. the NMS kernel against its plain version at the main paths' shapes,
     at N = 2049 (one row block past 2048) and at the C4 budget N = 12 000
     (keep masks identical);
  4. the RoIAlign kernel against its plain version at the main paths'
     shapes: equal bit for bit in f32 and bf16; bf16 also |err| <= 2^-8
     |ref| + 1e-3, ref the plain version computed in f32 on the same bf16
     inputs;
  5. the RoIAlign backward kernel against its plain version at the training
     step's shapes, at a ragged C (130, the narrow vector reductions, with
     d(pooled) channels-last) and at P = 14 with rois that touch more
     columns than the kernel merges (its direct adds) (f32: atol 1e-5 max|ref|,
     rtol 1e-5, since atomics add in an order that changes from run to run;
     bf16: |err| <= 2^-8 |ref| + 1e-3 against the plain version in f32),
     and the differentiable pooler's feature gradient against the
     kernel's;
  6. the DCN sampling kernel against its plain version at the six DCN
     geometries of YOLACT++-550 R-50, B = 8, and at a ragged C (130, the
     kernel's narrow path): f32 and bf16 bit for bit, bf16 also as
     RoIAlign's against the plain version in f32; grid_sample against the
     plain version (1e-4 max|ref|), and a zero-offset DCN against F.conv2d
     (TF32 off, 1e-4);
  7. the DCN sampling backward kernel against its plain version at the
     same geometries and at the ragged C (its narrow vector reductions),
     with the offsets of phase 6 and with zero offsets (every sample on an
     integer), f32 and bf16 (d feats as the RoIAlign backward's; d sy, d sx
     and d m rtol 1e-5 / atol 1e-6 max|ref|);
  8. Mask R-CNN R-50-FPN inference through MaskRCNNPredictor on the card
     (full width, 81 classes, synthetic upstream-keyed weights from a numpy
     seed): launch counts per forward (every CUDA MaskRCNNPredictor batch,
     here and in the later phases, also launches the canvas kernel once),
     sane outputs, and the heads run on one shared pyramid through the
     kernels and through the plain versions must agree detection for
     detection;
  9. Mask R-CNN R-50-FPN training through do_train: 3 iterations at B = 2
     on the 800x1344 canvas over an in-memory synthetic dataset, launch
     counts per step, finite losses, frozen stages still and the rest
     moved; then one step on one batch with the same draws and TF32 off,
     through the kernels and through the plain versions (losses rtol 1e-6,
     gradients rtol 1e-4 / atol 1e-6 max|g|);
  10. YOLACT++-550 R-50-FPN inference through YolactPredictor on the card
     (full width, synthetic upstream-keyed weights with non-zero DCN
     offsets), f32 and bf16 at B = 1 and 8: 13 DCN sampling launches per
     forward, sane detections, and kernels vs plain detection for
     detection, also with greedy NMS (use_fast_nms=False, one NMS launch);
     then YOLACT's mask paste as the stream runs it: predict_images over
     four 640x480 frames (one mask_paste launch a frame with masks, every
     mask counted by predictor.masks_pasted_on_device, the uint8 masks
     downloaded), the card's masks against the host paste of the same
     detections, and the kernel against its plain version on the card at
     the detector's layout and the stream's shape (n = 100, S = 138,
     480x640; a pixel may differ only where the plain value lies within
     1e-5 of 0.5), timed beside its bound;
  11. YOLACT++-550 R-50-FPN training through yolact_train_loop.train: 3
     iterations at B = 8 in f32 (TF32 convolutions, train-mode BatchNorm)
     over an in-memory synthetic dataset of 480-640 px images with 5-15
     elliptic masks each: 13 dcn_sample and 13 dcn_sample_bwd launches per
     step, finite B/C/M/S/I, every parameter moved, every running
     statistic updated, the checkpoint loads; then one step on one batch
     with the same draws and TF32 off through the kernels and through the
     plain versions (as phase 9);
  12. timings: each kernel against its plain version and its bound (DCN
     sampling also against grid_sample, its backward against
     grid_sample's; NMS, RoIAlign and the DCN backward also the kernel
     launch alone, without the torch work of the dispatch around it;
     RoIAlign also at the training step's shapes; the RoIAlign backward
     also with direct adds only, and the vector reductions of its two
     designs counted on the host; the DCN backward at 69x69x128 also with
     d feats only and with the coordinates only),
     Mask R-CNN forward img/s at B = 1 and 2 and its
     training step at B = 2 on the 800x1344 canvas, YOLACT++ forward and
     run_batch img/s at B = 1 and 8 in f32 and bf16, and its training step
     at B = 8, through both paths, with the host's batch time apart;
  13. the COCO data path, from a dataset the smoke writes to its temporary
     directory (16 PNG images, alternately landscape 640x480 and portrait
     480x640, 10 polygon objects and an uncompressed-RLE crowd each,
     category ids from COCO's 91-id space) and checkpoints of the synthetic
     weights: the reader (every target; the ground truth scored against
     itself by COCOeval, AP 1.0), the decode at the images' own size
     (equal to the written pixels), DevicePrefetcher's uploads of the
     YOLACT++ batches (equal bit for bit); evaluate_coco of
     MaskRCNNPredictor at 800/1333 and evaluate_dataset of YOLACT++-550
     (with its COCO jsons), each through the kernels and the plain versions
     (TF32 off, deterministic cuDNN: the detections equal bit for bit, the
     json dumps byte for byte, the stats and maps equal or within 1e-3);
     the four CLIs through their main() (test_net and yolact_eval on 8
     images, train_net and yolact_train for 5 steps, losses finite), each
     one's launches counted; timings of the reader, the decode, both
     evaluations and the training CLIs' s/it (the median interval after
     the first step's).
  14. the rest of the detectron family at full width (R-50, 81 classes,
     800x1344, synthetic upstream-keyed weights from a numpy seed; C4's
     with upstream's duplicate of res5 under the mask head): Mask R-CNN C4,
     Faster R-CNN FPN and RetinaNet through build_predictor_from_cfg on
     their yamls at B = 1 and 2 (launches per forward, sane detections,
     every NMS call of the path equal to the plain version on its inputs
     bit for bit: C4's RPN at N = 6000, RetinaNet's class-aware NMS over
     4693 candidates; the heads through kernels vs plain on one feature map
     detection for detection, TF32 off); the class scores calibrated so
     that the final NMS has real work; 3 do_train iterations at B = 2 each
     (launches per step, C4's RPN NMS at N = 12 000, finite losses, frozen
     stages still, the rest moved) and one step kernels vs plain (as phase
     9); their timings (forward img/s at B = 1 and 2, the training step at
     B = 2, K1 at the new shapes on the models' own inputs against its
     plain version and its bound, the C4 pooler's forward and backward);
     every yaml of configs/ through build_predictor_from_cfg and do_train
     (random weights: a forward and a training step each, its launches);
     after phase 13, test_net and train_net with the C4 and RetinaNet
     yamls over its dataset.
  15. Pose2Seg at full width (ResNet-50 with the dilated C5, the 512
     canvas, P2 128x128x256, max_people 16, 10 seg units, skeleton
     features; synthetic upstream-keyed weights from a numpy seed, written
     to last.pkl and read by the port's loader): Pose2SegPredictor in f32
     and bf16 on an image with 6 people and one with 20 (one K4 launch per
     chunk of 16, one backbone pass an image, sane masks); the heads on
     one P2 map through the kernels and the plain versions (TF32 off:
     within 1e-5 max|ref|); 3 Pose2SegTrainer steps at B = 4 with the
     ground-truth warp over a keypoint dataset the smoke writes (2 K4 + 1
     K4c per step, finite losses, every parameter moved, every running
     statistic updated) and one step kernels vs plain (phase 9's gate,
     its atol raised to ten times the plain runs' own spread for the
     gradients, named, where that is larger); the kernels at the path's own inputs (K4 bit for bit in f32 and bf16 and
     against grid_sample, K4 at the warp's C = 1, K4c with d feats only);
     pose2seg_test over the 8 images through both paths (stats equal or
     within 1e-3 at equal counts) and pose2seg_train for 5 steps; timings
     (K4 and K4c at its shapes against plain, bound, grid_sample; the
     forward at B = 1 in f32 and bf16; run_on_image; the step at B = 4;
     the CLIs).
  16. YOLOv3-416 (DarkNet-53, 80 classes; a synthetic yolov3.weights from
     a numpy seed, read by the port's darknet reader) and ViT-B/16
     (synthetic jeonsworld-keyed .pth and google-research .npz of the same
     numpy weights, read by load_vit_weights): YoloPredictor in f32 and
     bf16 at B = 1 and 8 (one K1 launch a batch, every K1 call equal to
     the plain version on its inputs bit for bit, sane detections); a
     B = 8 batch through the kernels and the plain versions detection for
     detection and the raw head maps against the same model on the CPU
     (TF32 off, 1e-4 max|ref|); evaluate_coco_boxes over phase 13's
     dataset through both paths (stats equal or within 1e-3 at equal
     counts); 3 YoloTrainer steps at B = 8 on the 832 canvas (no launch,
     finite losses, every parameter moved, every running statistic
     updated); yolo_detect, yolo_eval (8 images) and yolo_train (5 steps,
     its npz read back); ViTClassifier.run_on_image and forwards at B = 1
     and 32 (no launch), the logits against the CPU's (TF32 off, 1e-4
     max|ref|), 3 ViTTrainer steps at B = 32 (finite, every parameter
     moved), vit_infer and vit_train (5 steps, its npz read back);
     timings (YOLOv3's device pipeline at B = 1 and 8 in f32 and bf16
     through both paths and run_batch, its step at B = 8, K1 at [8, 1000]
     class-aware against plain and its bound, ViT-B/16's forward at B = 1
     and 32 and its step at B = 32, the CLIs).
  17. bf16 mixed precision, YOLACT-550 DarkNet53-FPN and the npz writers:
     Mask R-CNN R-50-FPN, Faster R-CNN FPN, Mask R-CNN C4 and RetinaNet
     through build_predictor_from_cfg(dtype=bf16) on their yamls with
     phase 14's calibrated weights (launches per forward at B = 1 and 2,
     sane detections returned in f32, every K1 and K2 call equal to the
     plain version on its inputs, the heads on one bf16 pyramid kernels vs
     plain detection for detection; the agreement with the f32 predictor
     printed, not gated); 3 do_train(compute_dtype=bf16) steps of Mask
     R-CNN at B = 2 (K2 and K3 in bf16) and 3 train(compute_dtype=bf16)
     steps of YOLACT++ at B = 8 in train-mode BatchNorm (13 K4 + 13 K4c in
     bf16): launches, finite losses, f32 masters, every trainable
     parameter moved, the f32 running statistics updated; one step each
     kernels vs plain by relative L2 per gradient within ten times either
     path's spread between its own runs, at least one bf16 rounding and at
     most BF16_STEP_CAP (YOLACT++: BF16_TRAIN_MODE_CAP); YOLACT DarkNet-53
     through YolactPredictor in f32 and bf16 at B = 1 and 8 (no launch), its raw
     predictions on the card against the CPU's (TF32 off, 1e-4 max|ref|),
     one bf16 yolact_train step of the preset through the CLI; the JAX
     trees of the detectron models, YOLACT++ and Pose2Seg through the npz
     writers, read back equal; K2, K3, K4 and K4c at the bf16 paths' own
     inputs against plain, their bounds and grid_sample; the bf16
     forwards and steps timed beside the f32 ones.
  18. multi-GPU on one card (tpuseg_torch/parallel): (a) YolactPredictor
     with two replicas on cuda:0 at B = 8 and MaskRCNNPredictor with two at
     B = 2 and B = 1 (padded to 2), against devices=None on the same shards
     (phase 8's and phase 10's tolerances), each replica's launches
     counted; (b) one rank spawned under NCCL at world size 1: phase 11's
     YOLACT++ step (B = 8) and phase 9's Mask R-CNN step (B = 2) through
     DDP against the plain step (losses bit for bit; each gradient that
     the plain step reproduces bit for bit; the others within phase 9's
     gate, its atol raised to ten times the plain step's own run-to-run
     difference, or for YOLACT++ phase 11's train-mode gate), and the DDP
     overhead in ms per step; (c) two gloo ranks on cuda:0:
     YOLACT++ at a global B = 12 as 2 x 6, train-mode BatchNorm
     synchronised, against one process at B = 12 (phase 11's train-mode
     gate), the running statistics updated; Mask R-CNN at a global B = 2
     as 2 x 1 against one process running the two halves with the global
     normalisers (phase 9's gate); the ranks' launches and step times
     ("two ranks on one card"); (d) yolact_train under
     torch.distributed.run at world size 1 against phase 13's run,
     yolact_eval --devices all and test_net --devices 1 against phase 13's,
     and test_net asking for one GPU more than there are, refused.
  19. the parity gate (tpuseg_torch/tools/parity_gate.py) as a user runs
     it, with --device cuda: (a) its smoke mode (the six families on its
     2-image dataset, random weights) through the kernels and the plain
     versions (TF32 off, deterministic cuDNN): six rows measured, none
     FAILED, each family's K1, K2 and K4 launches as its code makes them,
     what each family's evaluation scored (loadRes's results; YOLACT's
     postprocess_image) equal bit for bit; (b) its real mode at the
     published sizes (YOLACT 550, the detectron family 800/1333, YOLOv3
     608, Pose2Seg 512) over phase 13's dataset and a keypoint dataset as
     --ochuman_*, --max_images 16, on six checkpoints under upstream's
     file names and in upstream's formats written from numpy seeds: every
     row measured, the PASS or ATTENTION line, the launches, every K1, K2
     and K4 call of the run equal bit for bit to its plain version on its
     own inputs, each family's seconds and img/s on the host clock; (c) in
     subprocesses: without yolov3.weights its row is SKIP and the exit
     status 0; a family made to raise gives its FAILED row, the verdict
     FAIL and exit status 1;
  20. ViTDet-B Mask R-CNN (MaskRCNNPredictor(cfg=ViTDetConfig()), the
     1024x1024 canvas, relative-position tables drawn non-zero, the class
     layer scaled until each frame sends 50 candidates to the final NMS):
     run_on_bgr_image over three 640x480 frames, a canvas, 6 NMS and 2
     RoIAlign launches on each, each frame's canvas from the kernel equal
     bit for bit to preprocess_image_bgr's, sane detections and masks,
     every NMS and RoIAlign call of the frames equal bit for bit to its
     plain version on its own inputs; at a 640x480 frame onto ViTDet's 1024
     canvas and onto the FPN's 800/1333 one, and a 1920x1080 frame onto the
     FPN's, the kernel's and the plain version's canvases equal
     preprocess_image_bgr's bit for bit, and the kernel timed.
Then the smoke's seconds, one JSON line of kernel results, the nvidia-smi
line, and as the last line {"ok": true, "device": {...}}. Phase 18 runs
this file as its ranks' program: ``--rank JOB BACKEND DIR`` (a rank of
(b) or (c)) and ``--cli-rank OUT ARGV...`` (yolact_train under torchrun).
"""
from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import io
import json
import os
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import torch
import torch.nn.functional as F
from torch.profiler import ProfilerActivity, profile

from tpuseg_torch import kernels
from tpuseg_torch.configs.presets import (yolact_loss_config,
                                          yolact_model_config)
from tpuseg_torch.data.coco_dataset import CocoDetectionDataset
from tpuseg_torch.data.native_loader import NativeImageLoader
from tpuseg_torch.data.prefetch import DevicePrefetcher
from tpuseg_torch.engine import classify as VC
from tpuseg_torch.engine import detectron_train_loop as TL
from tpuseg_torch.engine import maskrcnn_engine as ME
from tpuseg_torch.engine import pose2seg_engine as P2SE
from tpuseg_torch.engine import yolact_engine as YE
from tpuseg_torch.engine import vit_train as VT
from tpuseg_torch.engine import yolact_train_loop as YTL
from tpuseg_torch.engine import yolo_engine as YOE
from tpuseg_torch.engine.maskrcnn_engine import (COCO_CATEGORY_IDS,
                                                 MaskRCNNPredictor,
                                                 preprocess_image_bgr)
from tpuseg_torch.engine.config import get_config
from tpuseg_torch.engine.trainer import (Bound, call_in_dtype, ckpt_path,
                                         make_optimizer,
                                         make_yolact_optimizer,
                                         yolact_lr_schedule)
from tpuseg_torch.data.image_io import resize_bilinear_u8
from tpuseg_torch.engine.yolact_engine import YolactPredictor
from tpuseg_torch.eval import rle, yolact_map
from tpuseg_torch.eval.coco import COCO
from tpuseg_torch.eval.cocoeval import COCOeval
from tpuseg_torch.kernels import canvas as CV
from tpuseg_torch.kernels.mask_paste import paste_masks
from tpuseg_torch.models import maskrcnn as M
from tpuseg_torch.models import maskrcnn_c4 as C4
from tpuseg_torch.models import pose2seg as P2S
from tpuseg_torch.models import pose2seg_loss as P2SL
from tpuseg_torch.models import retinanet as RN
from tpuseg_torch.models import yolact as YM
from tpuseg_torch.models import yolact_loss as YLOSS
from tpuseg_torch.models import yolov3 as Y3
from tpuseg_torch.nn import vit as VIT
from tpuseg_torch.nn.layers import FrozenBatchNorm2d
from tpuseg_torch.ops import nms as nms_ops
from tpuseg_torch.ops import sampling
from tpuseg_torch.ops.deform_conv import dcn_sample_coords, deform_conv2d
from tpuseg_torch.ops.preprocess import vit_preprocess as VIT_PRE
from tpuseg_torch.ops.preprocess import yolact_preprocess
from tpuseg_torch.parallel import ddp as PDDP
from tpuseg_torch.parallel.mesh import ThreadGroup
from tpuseg_torch.parallel.sync_bn import convert_sync_bn
from tpuseg_torch.tools import parity_gate as PG
from tpuseg_torch.utils import timer
from tpuseg_torch.weights import from_jax as FJ
from tpuseg_torch.weights.npz_io import load_params_npz, save_params_npz
from tpuseg_torch.weights.pose2seg_map import load_pose2seg_weights

SEED = 0
CANVAS = (800, 1344)
LEVEL_HW = [(200, 336), (100, 168), (50, 84), (25, 42)]
STRIDES = (4, 8, 16, 32)
# cls_score weights N(0, 1/fan) times this: a few hundred class-box
# candidates pass score_thresh = 0.05 (so the final NMS has real work), fewer
# than the 2048 slots (so the candidate cut is not decided by near-ties), and
# no softmax score saturates at 1.0 (272 candidates at a 320x480 canvas)
CLS_SCORE_SCALE = 0.008
TRAIN_STEPS = 3
PER_STEP = {"nms": 5, "roi_align": 2, "roi_align_bwd": 2,
            "dcn_sample": 0, "dcn_sample_bwd": 0,
            "mask_paste": 0, "canvas": 0}
# the backward's shapes at B = 2: the box pooler's 2 x 512 sampled rois at
# P = 7 and the mask pooler's 2 x 128 at P = 14
BWD_SHAPES = ((1024, 7), (256, 14))
# csrc/roi_align_bwd.cu's kMaxCols: a roi whose samples touch more columns
# of its level adds its corners directly, without merging
BWD_MAX_COLS = 32
PIXEL_VAR = 75.0 ** 2  # of textured_image's pixels less the pixel mean
# DCN offset convs' weights: N(0, 1/fan) times this, so the offsets have a
# standard deviation of 1.5-3.5 px (see synthetic_yolact_state_dict)
OFFSET_SCALE = 2.0
# the DCN offset convs of the training phase: offsets of ~0.2-0.4 px, off
# the integers; at OFFSET_SCALE the first SGD step at upstream's warm-up lr
# blows the losses up (B = 8 at 550: total 203, 17357, 4.9e7 in three
# steps), since a random offset field of a few pixels is no state that
# training from upstream's zero offsets passes through (measured on an H100)
TRAIN_OFFSET_SCALE = 0.2
# YOLACT's class-logit layer: N(0, 1/fan) times this spreads the best
# class scores, so that few of them lie near the 0.05 gate
CONF_SCALE = 3.0
# DarkNet-53's residual convs' BatchNorm affine (conv2.bn of each block)
# times this: at 1 its 23 residual adds grow C5 to ~100 and YOLACT's class
# logits to a standard deviation of ~35 (every score saturated); at 0.3 the
# taps stay O(1), as ResNet's (measured on the CPU at a 128 canvas)
DARKNET_RESIDUAL_SCALE = 0.3
# the least time of a kernel's work: bytes over the H100 SXM's memory rate,
# f32 operations over its rate outside the tensor cores (the H100 SXM's
# published peaks; the kernels compute in f32 for bf16 data too)
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
NMS_OPS_PER_PAIR = 16  # the IoU: 2 min, 2 max, 4 sub/add, 2 clamp, mul,
#                        add, sub, clamp, div; the threshold compare
ROI_OPS_PER_SAMPLE = 12  # per channel: 4 corner weights, 4 mul, 4 add
# YOLACT++-550 R-50's deformable 3x3 convs, (H, W, C, stride) of their
# inputs: layer2 block 0, blocks 1-3, layer3 block 0, blocks 1-5, layer4
# block 0, blocks 1-2 (13 per forward)
DCN_SHAPES = ((138, 138, 128, 2), (69, 69, 128, 1), (69, 69, 256, 2),
              (35, 35, 256, 1), (35, 35, 512, 2), (18, 18, 512, 1))
DCN_PER_FORWARD = (1, 3, 1, 5, 1, 2)
# a channel count that no 16-byte vector divides (the kernel's narrow path)
DCN_RAGGED = (69, 69, 130, 1)
DCN_BATCH = 8
DCN_OPS_PER_VALUE = 12  # per sample and channel: 4 corner weights, 4 mul,
#                         3 add, the modulation
DCN_BWD_OPS_PER_VALUE = 36  # per sample and channel: g * m, 4 corner
# weights times it and 4 adds into d feats; 3 x (4 mul + 3 add) for the
# d sy, d sx and d m terms; 3 mul + 3 add into their sums
# phase 10's mask paste: the stream's frames, one forward each
STREAM_HW = (480, 640)
MASK_PASTE_FRAMES = 4
MASK_PASTE_OPS_PER_PIXEL = 3
YOLACT_TRAIN_STEPS = 3
YOLACT_BATCH = 8
YOLACT_PER_STEP = {"nms": 0, "roi_align": 0, "roi_align_bwd": 0,
                   "dcn_sample": sum(DCN_PER_FORWARD),
                   "dcn_sample_bwd": sum(DCN_PER_FORWARD),
                   "mask_paste": 0, "canvas": 0}


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def cuda_time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean time of ``fn()`` on the current stream, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


@contextlib.contextmanager
def exact_convs():
    """TF32 off and deterministic cuDNN, so that two runs differ only where
    the kernels do."""
    prev = (torch.backends.cudnn.allow_tf32, torch.backends.cudnn.deterministic)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cudnn.deterministic = prev


def random_boxes(g: torch.Generator, shape, dev, extent=CANVAS, clusters=40):
    """Boxes [..., 4] in clusters (so NMS has real work) over the canvas,
    side lengths log-uniform in [8, 512] px."""
    n = int(np.prod(shape))
    cy = torch.rand(clusters, generator=g) * extent[0]
    cx = torch.rand(clusters, generator=g) * extent[1]
    k = torch.randint(0, clusters, (n,), generator=g)
    yc = cy[k] + torch.randn(n, generator=g) * 12.0
    xc = cx[k] + torch.randn(n, generator=g) * 12.0
    h = torch.exp(torch.empty(n).uniform_(np.log(8), np.log(512), generator=g))
    w = h * torch.exp(torch.randn(n, generator=g) * 0.5)
    b = torch.stack([xc - w / 2, yc - h / 2, xc + w / 2, yc + h / 2], 1)
    b[:, 0::2] = b[:, 0::2].clamp(0, extent[1] - 1)
    b[:, 1::2] = b[:, 1::2].clamp(0, extent[0] - 1)
    return b.reshape(*shape, 4).to(dev)


# ---------------------------------------------------------------------------
# phase 3: NMS
# ---------------------------------------------------------------------------


def nms_cases(dev):
    """(label, boxes, scores, valid, classes or None, thr) at the main paths'
    shapes: B = 2; N = 819 (P6), 1000 (RPN levels at inference), 2000 (RPN
    levels in training), 2048 (final, class-aware); also N = 2049 (one row
    block past 2048) and 12 000 (Mask R-CNN C4's training RPN budget)."""
    g = torch.Generator().manual_seed(SEED + 3)
    cases = []
    for n, thr in ((819, 0.7), (1000, 0.7), (2000, 0.7), (2048, 0.5),
                   (2049, 0.7), (12000, 0.7)):
        boxes = random_boxes(g, (2, n), dev)
        scores = torch.rand(2, n, generator=g).to(dev)
        valid = (torch.rand(2, n, generator=g) < 0.9).to(dev)
        cases.append((f"N={n} thr={thr}", boxes, scores, valid, None, thr))
    # duplicates with tied scores, and an all-invalid image
    boxes = random_boxes(g, (2, 1000), dev)
    boxes[0, 100:300] = boxes[0, 50]
    scores = (torch.rand(2, 1000, generator=g) * 10).round().div(10).to(dev)
    valid = torch.ones(2, 1000, dtype=torch.bool, device=dev)
    valid[1] = False
    cases.append(("duplicates, ties, all-invalid image", boxes, scores, valid,
                  None, 0.7))
    # class-aware final NMS through the coordinate offset, 80 classes
    boxes = random_boxes(g, (2, 2048), dev)
    scores = torch.rand(2, 2048, generator=g).to(dev)
    valid = (torch.rand(2, 2048, generator=g) < 0.8).to(dev)
    classes = torch.randint(0, 80, (2, 2048), generator=g).to(dev)
    cases.append(("class-aware N=2048", boxes, scores, valid, classes, 0.5))
    return cases


def run_nms(boxes, scores, valid, classes, thr):
    if classes is None:
        return nms_ops.nms_mask_batch(boxes, scores, thr, valid, to_remove=1.0)
    return nms_ops.batched_nms_mask_batch(boxes, scores, classes, thr, valid,
                                          to_remove=1.0)


def phase_nms(dev) -> dict:
    lines, worst = [], 0.0
    for label, boxes, scores, valid, classes, thr in nms_cases(dev):
        got = run_nms(boxes, scores, valid, classes, thr)
        with kernels.force_plain():
            want = run_nms(boxes, scores, valid, classes, thr)
        torch.cuda.synchronize()
        bad = int((got != want).sum())
        if bad:
            raise AssertionError(f"NMS {label}: {bad} keep bits differ")
        worst = max(worst, float((got.float() - want.float()).abs().max()))
        lines.append(f"{label}: {int(got.sum())}/{int(valid.sum())} kept")
    log("[3 nms] keep masks identical to the plain version: "
        + "; ".join(lines))
    return {"max_abs_err": worst}


# ---------------------------------------------------------------------------
# phase 4: RoIAlign
# ---------------------------------------------------------------------------


def roi_case(dev, n: int, dtype=torch.float32):
    g = torch.Generator().manual_seed(SEED + 4 + n)
    feats = [torch.randn(2, 256, h, w, generator=g).to(dev, dtype)
             .contiguous(memory_format=torch.channels_last) for h, w in LEVEL_HW]
    boxes = random_boxes(g, (n,), dev)
    bidx = torch.randint(0, 2, (n,), generator=g).to(dev)
    levels = sampling.clamp_levels_to_window(feats, boxes,
                                             M.assign_levels(boxes), STRIDES)
    return feats, boxes, bidx, levels


def run_roi(case, p):
    feats, boxes, bidx, levels = case
    return sampling.multilevel_roi_align(feats, boxes, bidx, levels, p, 2,
                                         STRIDES)


def phase_roi_align(dev) -> dict:
    worst = 0.0
    lines = []
    for n, p in ((2000, 7), (200, 14)):
        case = roi_case(dev, n)
        got = run_roi(case, p)
        with kernels.force_plain():
            want = run_roi(case, p)
        torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
        if not torch.equal(got, want):
            raise AssertionError(f"RoIAlign f32 N={n} P={p}: differs from "
                                 "the plain version")
        err = float((got - want).abs().max())
        worst = max(worst, err)
        # bf16: the reference is the plain version computed in f32 on the
        # same bf16 inputs, so the kernel's only error is the rounding of
        # its output to bf16 (half an ulp, <= 2^-8 |ref|) plus sum order
        case_bf = roi_case(dev, n, torch.bfloat16)
        got_bf = run_roi(case_bf, p).float()
        feats_bf, boxes, bidx, levels = case_bf
        with kernels.force_plain():
            want_bf = run_roi(([f.float() for f in feats_bf], boxes, bidx,
                               levels), p)
        err_bf = (got_bf - want_bf).abs()
        with kernels.force_plain():
            plain_bf = run_roi(case_bf, p).float()
        if not torch.equal(got_bf, plain_bf):
            raise AssertionError(f"RoIAlign bf16 N={n} P={p}: differs from "
                                 "the plain version")
        err_bf_plain = float((got_bf - plain_bf).abs().max())
        excess = float((err_bf - (2.0 ** -8 * want_bf.abs() + 1e-3)).max())
        if excess > 0:
            raise AssertionError(f"RoIAlign bf16 N={n} P={p}: error exceeds "
                                 f"2^-8|ref| + 1e-3 by {excess}")
        levels = torch.bincount(case[3].long(), minlength=4).tolist()
        lines.append(f"N={n} P={p} levels {levels}: f32 max err {err:.3g}; "
                     f"bf16 max err {float(err_bf.max()):.3g} vs the f32 "
                     f"plain, {err_bf_plain:.3g} vs the bf16 plain")
    log("[4 roi_align] equal to the plain version bit for bit: "
        + "; ".join(lines))
    return {"max_abs_err": worst}


# ---------------------------------------------------------------------------
# phase 5: RoIAlign backward
# ---------------------------------------------------------------------------


def bwd_case(dev, n: int, p: int, dtype=torch.float32, c: int = 256,
             large: bool = False):
    """(d(pooled) [N, C, P, P], boxes, batch_idx, levels, level shapes).
    ``large``: boxes of 120-240 px all on P2 (30-60 cells a side), which
    at P = 14 touch more columns than the kernel merges."""
    g = torch.Generator().manual_seed(SEED + 5 + n + c + large)
    shapes = [(2, c, h, w) for h, w in LEVEL_HW]
    boxes = random_boxes(g, (n,), dev)
    if large:
        side = torch.empty(n, 2).uniform_(120, 240, generator=g).to(dev)
        boxes[:, 2:] = (boxes[:, :2] + side).clamp(max=CANVAS[1] - 1)
        boxes[:, 3] = boxes[:, 3].clamp(max=CANVAS[0] - 1)
    bidx = torch.randint(0, 2, (n,), generator=g).to(dev)
    probe = [torch.empty(sh, dtype=dtype, device="meta") for sh in shapes]
    levels = (torch.zeros(n, dtype=torch.int64, device=dev) if large else
              sampling.clamp_levels_to_window(probe, boxes,
                                              M.assign_levels(boxes), STRIDES))
    grad = torch.randn(n, c, p, p, generator=g).to(dev, dtype)
    return grad, boxes, bidx, levels, shapes


def run_bwd(case, p: int, dtype):
    grad, boxes, bidx, levels, shapes = case
    return sampling.multilevel_roi_align_backward(grad, boxes, bidx, levels,
                                                  shapes, dtype, p, 2, STRIDES)


def bwd_error(got, want, dtype, label: str) -> float:
    """Max |got - want| over the levels; raises past the tolerance. f32:
    atomics add in an order that changes from run to run, so the kernel
    meets the plain backward to rounding: atol 1e-5 max|ref| (per level),
    rtol 1e-5. bf16 features: ``want`` is the plain backward in f32, and
    the kernel's f32 sum is rounded once to bf16: 2^-8 |ref| + 1e-3."""
    worst = 0.0
    for lv, (a, w) in enumerate(zip(got, want)):
        if a.shape != w.shape or a.dtype != dtype:
            raise AssertionError(f"{label} level {lv}: {a.dtype} "
                                 f"{tuple(a.shape)}, want {dtype} "
                                 f"{tuple(w.shape)}")
        err = (a.float() - w).abs()
        if dtype == torch.float32:
            tol = 1e-5 * w.abs() + 1e-5 * float(w.abs().max())
        else:
            tol = 2.0 ** -8 * w.abs() + 1e-3
        excess = float((err - tol).max())
        if excess > 0:
            raise AssertionError(f"{label} level {lv}: error exceeds the "
                                 f"tolerance by {excess}")
        worst = max(worst, float(err.max()))
    return worst


def phase_roi_align_bwd(dev) -> dict:
    worst, lines = 0.0, []
    # the training shapes; a ragged C with d(pooled) channels-last; P = 14
    # with large rois (the kernel's direct adds)
    cases = [(n, p, 256, False, False) for n, p in BWD_SHAPES] + [
        (*BWD_SHAPES[0], 130, False, True), (*BWD_SHAPES[1], 256, True, False)]
    for n, p, c, large, cl in cases:
        for dt in (torch.float32, torch.bfloat16):
            case = bwd_case(dev, n, p, dt, c, large)
            if cl:
                case = (case[0].contiguous(memory_format=torch.channels_last),
                        *case[1:])
            got = run_bwd(case, p, dt)
            grad, boxes, bidx, levels, shapes = case
            with kernels.force_plain():
                want = sampling.multilevel_roi_align_backward(
                    grad.float(), boxes, bidx, levels, shapes, torch.float32,
                    p, 2, STRIDES)
            label = (f"N={n} P={p} C={c}" + (" large rois" if large else "")
                     + (" channels-last d(pooled)" if cl else ""))
            err = bwd_error(got, want, dt, f"{label} {dt}")
            if dt == torch.float32:
                worst = max(worst, err)
            lines.append(f"{label} {str(dt)[6:]} max err {err:.3g}")
    # the differentiable pooler on channels-last levels that need grad:
    # one forward and one backward launch, and .grad equal to the kernel's
    # output for the same d(pooled)
    case = bwd_case(dev, *BWD_SHAPES[0])
    grad, boxes, bidx, levels, shapes = case
    g = torch.Generator().manual_seed(SEED + 6)
    feats = [torch.randn(sh, generator=g).to(dev)
             .contiguous(memory_format=torch.channels_last).requires_grad_()
             for sh in shapes]
    kernels.reset_launch_counts()
    out = sampling.multilevel_roi_align(feats, boxes, bidx, levels,
                                        BWD_SHAPES[0][1], 2, STRIDES)
    out.backward(grad)
    counts = kernels.launch_counts()
    if counts != {"nms": 0, "roi_align": 1, "roi_align_bwd": 1,
                  "dcn_sample": 0, "dcn_sample_bwd": 0,
                  "mask_paste": 0, "canvas": 0}:
        raise AssertionError(f"pooler forward + backward launched {counts}")
    err = bwd_error([f.grad for f in feats],
                    run_bwd(case, BWD_SHAPES[0][1], torch.float32),
                    torch.float32, "autograd .grad vs the kernel")
    log("[5 roi_align_bwd] within tolerance of the plain backward: "
        + "; ".join(lines) + f"; the pooler's autograd .grad (channels-last "
        f"leaves) vs the kernel's output: max err {err:.3g}")
    return {"max_abs_err": worst}


# ---------------------------------------------------------------------------
# phase 6: DCN sampling
# ---------------------------------------------------------------------------


def dcn_case(dev, h: int, w: int, c: int, stride: int, dtype=torch.float32,
             zero: bool = False):
    """Features [B, C, H, W] (channels-last) and the points that
    deform_conv2d samples on them: offsets ~ N(0, 2^2) px, 1 % of them
    pushed 8-25 px further out (or, with ``zero``, no offsets: every sample
    on an integer), modulation sigmoid(N(0, 1))."""
    g = torch.Generator().manual_seed(SEED + 10 + h + c + stride)
    b = DCN_BATCH
    ho, wo = (h - 1) // stride + 1, (w - 1) // stride + 1
    feats = torch.randn(b, c, h, w, generator=g).to(dev, dtype).contiguous(
        memory_format=torch.channels_last)
    off = torch.randn(b, 18, ho, wo, generator=g) * 2.0
    far = torch.rand(off.shape, generator=g) < 0.01
    n = int(far.sum())
    off[far] += (8.0 + 17.0 * torch.rand(n, generator=g)) * torch.sign(
        torch.randn(n, generator=g))
    if zero:
        off.zero_()
    mask = torch.sigmoid(torch.randn(b, 9, ho, wo, generator=g))
    return (feats, *dcn_sample_coords(off.to(dev), mask.to(dev), 3, stride,
                                      1, 1))


def grid_sample_points(feats, sy, sx, m):
    """The sampler's function as one PyTorch call (the yardstick for
    library_ms; nothing on the port's path calls it): grid_sample with
    align_corners=True maps -1 and 1 to the first and last pixel centres,
    zero padding, then the modulation. grid_sample takes its grid in the
    features' dtype, so for bf16 features the points are rounded to bf16."""
    h, w = feats.shape[2:]
    grid = torch.stack([2.0 * sx / (w - 1) - 1.0, 2.0 * sy / (h - 1) - 1.0],
                       -1)[:, :, None, :]
    out = F.grid_sample(feats, grid.to(feats.dtype), mode="bilinear",
                        padding_mode="zeros", align_corners=True)
    return out[..., 0].transpose(1, 2) * m[..., None].to(feats.dtype)


def phase_dcn(dev) -> dict:
    """At each DCN geometry of YOLACT++-550 R-50 and at DCN_RAGGED, B = 8:
    f32 and bf16 equal to the plain version bit for bit; bf16 also within
    2^-8 |ref| + 1e-3 of the plain version in f32; grid_sample within 1e-4
    max|ref| of the plain version; a DCN with zero offsets and unit
    modulation equal to F.conv2d (TF32 off) within rtol 1e-4 / atol 1e-4
    max|ref|."""
    worst, lines = 0.0, []
    prev_tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        for h, w, c, st in DCN_SHAPES + (DCN_RAGGED,):
            feats, sy, sx, m = dcn_case(dev, h, w, c, st)
            got = sampling.sample_points(feats, sy, sx, m)
            want = sampling.sample_points_plain(feats, sy, sx, m)
            worst = max(worst, float((got - want).abs().max()))
            if not torch.equal(got, want):
                raise AssertionError(f"dcn_sample {h}x{w}x{c}: f32 differs "
                                     f"from the plain version by "
                                     f"{float((got - want).abs().max())}")
            fb = feats.bfloat16()
            got_bf = sampling.sample_points(fb, sy, sx, m)
            if not torch.equal(got_bf, sampling.sample_points_plain(fb, sy, sx,
                                                                    m)):
                raise AssertionError(f"dcn_sample {h}x{w}x{c}: bf16 differs "
                                     "from the plain version")
            got_bf = got_bf.float()
            ref = sampling.sample_points_plain(fb.float(), sy, sx, m)
            err_bf = (got_bf - ref).abs()
            excess = float((err_bf - (2.0 ** -8 * ref.abs() + 1e-3)).max())
            if excess > 0:
                raise AssertionError(f"dcn_sample bf16 {h}x{w}x{c}: error "
                                     f"exceeds 2^-8|ref| + 1e-3 by {excess}")
            lib_err = float((grid_sample_points(feats, sy, sx, m)
                             - want).abs().max())
            # grid_sample carries each point through [-1, 1] and back:
            # ~(W - 1) 2^-24 px of rounding, 5e-5 of max|ref| at 138 px
            if lib_err > 1e-4 * float(want.abs().max()):
                raise AssertionError(f"grid_sample {h}x{w}x{c}: {lib_err}")
            wt = torch.randn(c, c, 3, 3, device=dev) * (9 * c) ** -0.5
            bias = torch.randn(c, device=dev) * 0.1
            ho, wo = (h - 1) // st + 1, (w - 1) // st + 1
            dcn = deform_conv2d(feats, torch.zeros(DCN_BATCH, 18, ho, wo,
                                                   device=dev),
                                torch.ones(DCN_BATCH, 9, ho, wo, device=dev),
                                wt, bias, 3, st, 1, 1)
            conv = F.conv2d(feats, wt, bias, stride=st, padding=1)
            conv_err = float((dcn - conv).abs().max())
            torch.testing.assert_close(dcn, conv, rtol=1e-4,
                                       atol=1e-4 * float(conv.abs().max()))
            outside = float((want[:, :, 0] == 0).float().mean())
            lines.append(f"{h}x{w}x{c} s{st}: f32 and bf16 equal, bf16 vs "
                         f"the f32 plain max err "
                         f"{float(err_bf.max()):.3g}, grid_sample "
                         f"{lib_err:.3g}, zero-offset DCN vs conv "
                         f"{conv_err:.3g}, {100 * outside:.1f} % of samples "
                         f"wholly outside")
    finally:
        torch.backends.cudnn.allow_tf32 = prev_tf32
    log(f"[6 dcn_sample] B = {DCN_BATCH}: " + "; ".join(lines))
    return {"max_abs_err": worst}


# ---------------------------------------------------------------------------
# phase 7: DCN sampling backward
# ---------------------------------------------------------------------------


def dcn_grad(dev, feats, sy) -> torch.Tensor:
    """A gradient of the sampled values [B, S, C] ~ N(0, 1), in the feature
    dtype."""
    g = torch.Generator().manual_seed(SEED + 20 + feats.shape[1])
    return torch.randn(feats.shape[0], sy.shape[1], feats.shape[1],
                       generator=g).to(dev, feats.dtype)


def run_dcn_bwd(grad, feats, sy, sx, m) -> tuple:
    return sampling.sample_points_backward(grad, feats, sy, sx, m)


def dcn_bwd_error(got, want, dtype, label: str) -> float:
    """Max |got - want| over d feats, d sy, d sx, d m; raises past the
    tolerance. d feats: f32 atol 1e-5 max|ref| / rtol 1e-5 (atomics add in
    an order that changes from run to run); bf16 features: ``want`` is the
    plain backward in f32 and the kernel's f32 sum is rounded once to
    bf16, 2^-8 |ref| + 1e-3. d sy, d sx, d m (f32 for either dtype): rtol
    1e-5 / atol 1e-6 max|ref| (the warp sums the channels in another
    order)."""
    worst = 0.0
    for i, (a, w) in enumerate(zip(got, want)):
        want_dt = dtype if i == 0 else torch.float32
        if a.shape != w.shape or a.dtype != want_dt:
            raise AssertionError(f"{label} output {i}: {a.dtype} "
                                 f"{tuple(a.shape)}, want {want_dt} "
                                 f"{tuple(w.shape)}")
        err = (a.float() - w).abs()
        scale = float(w.abs().max())
        if i == 0 and dtype == torch.bfloat16:
            tol = 2.0 ** -8 * w.abs() + 1e-3
        elif i == 0:
            tol = 1e-5 * w.abs() + 1e-5 * scale
        else:
            tol = 1e-5 * w.abs() + 1e-6 * scale
        excess = float((err - tol).max())
        if excess > 0:
            raise AssertionError(f"{label} output {i}: error exceeds the "
                                 f"tolerance by {excess}")
        worst = max(worst, float(err.max()))
    return worst


def phase_dcn_bwd(dev) -> dict:
    """At each DCN geometry of YOLACT++-550 R-50 and at DCN_RAGGED (8-byte
    vectors and float2 reductions), B = 8, with phase 6's offsets and with
    none: the backward kernel against its plain version (computed in f32
    on the same values), f32 and bf16."""
    worst, lines = 0.0, []
    for h, w, c, st in DCN_SHAPES + (DCN_RAGGED,):
        errs = []
        for zero in (False, True):
            for dt in (torch.float32, torch.bfloat16):
                feats, sy, sx, m = dcn_case(dev, h, w, c, st, dt, zero)
                grad = dcn_grad(dev, feats, sy)
                got = run_dcn_bwd(grad, feats, sy, sx, m)
                with kernels.force_plain():
                    want = run_dcn_bwd(grad.float(), feats.float(), sy, sx, m)
                label = (f"dcn_sample_bwd {h}x{w}x{c} s{st} {str(dt)[6:]}"
                         + (" zero offsets" if zero else ""))
                err = dcn_bwd_error(got, want, dt, label)
                if dt == torch.float32:
                    worst = max(worst, err)
                errs.append(f"{err:.3g}")
        lines.append(f"{h}x{w}x{c} s{st}: max err f32 {errs[0]}, bf16 "
                     f"{errs[1]}, zero offsets f32 {errs[2]}, bf16 {errs[3]}")
    torch.cuda.synchronize()
    log(f"[7 dcn_sample_bwd] B = {DCN_BATCH}, within tolerance of the plain "
        "backward: " + "; ".join(lines))
    return {"max_abs_err": worst}


# ---------------------------------------------------------------------------
# phase 8: Mask R-CNN inference
# ---------------------------------------------------------------------------


def synthetic_state_dict(model: torch.nn.Module, seed: int) -> dict:
    """Upstream-keyed random weights from a numpy seed (the scheme of
    tests/test_cross_parity.py::_synth_state): FrozenBN stats near 1,
    weights N(0, 1/fan), small biases, tame RPN outputs (no saturated
    objectness or clipped deltas)."""
    rng = np.random.default_rng(seed)
    special = {"rpn.head.cls_logits.weight": 3e-4,
               "rpn.head.bbox_pred.weight": 1e-4}
    sd = {}
    for k, v in model.state_dict().items():
        shape = tuple(v.shape)
        if k.endswith("running_var") or (k.endswith(".weight") and len(shape) == 1):
            a = rng.uniform(0.7, 1.3, shape)
        elif k in special:
            a = rng.standard_normal(shape) * special[k]
        elif k.endswith(".weight"):
            a = rng.standard_normal(shape) * np.prod(shape[1:]) ** -0.5
            if k == "roi_heads.box.predictor.cls_score.weight":
                a *= CLS_SCORE_SCALE
            elif k == "roi_heads.box.predictor.bbox_pred.weight":
                a *= 0.05
        elif k.endswith("running_mean"):
            a = rng.standard_normal(shape) * 0.05
        else:  # biases
            a = rng.standard_normal(shape) * 0.02
        sd[k] = torch.from_numpy(a.astype(np.float32))
    return sd


def textured_image(rng: np.random.Generator, h: int, w: int) -> np.ndarray:
    """[h, w, 3] uint8: smooth random blobs plus noise, so the backbone sees
    structure."""
    low = rng.uniform(0, 255, (h // 40 + 1, w // 40 + 1, 3))
    img = np.kron(low, np.ones((40, 40, 1)))[:h, :w]
    img += rng.normal(0, 20, (h, w, 3))
    return np.clip(img, 0, 255).astype(np.uint8)


def synthetic_images(seed: int):
    """Two landscape 800x1200 and one portrait 1200x800 BGR images."""
    rng = np.random.default_rng(seed)
    return ([textured_image(rng, 800, 1200), textured_image(rng, 800, 1200)],
            textured_image(rng, 1200, 800))


def check_result(res: dict, h: int, w: int, masks: bool = True) -> int:
    n = len(res["scores"])
    assert res["boxes"].shape == (n, 4) and res["classes"].shape == (n,)
    assert ("masks" in res) == masks
    if masks:
        assert res["masks"].shape == (n, h, w)
        assert res["masks"].dtype == np.uint8
    assert np.isfinite(res["boxes"]).all() and np.isfinite(res["scores"]).all()
    assert ((res["scores"] > 0) & (res["scores"] <= 1)).all()
    assert (res["boxes"][:, 0::2] <= w - 1).all()
    assert (res["boxes"][:, 1::2] <= h - 1).all()
    assert ((res["classes"] >= 0) & (res["classes"] < 80)).all()
    return n


def compare_heads(got: dict, want: dict) -> str:
    """Kernel path vs plain path on one pyramid: detection for detection
    (the masks too where the model has a mask head)."""
    lines = []
    fields = ("boxes", "scores") + (("masks",) if "masks" in want else ())
    for i in range(got["valid"].shape[0]):
        gv, wv = got["valid"][i], want["valid"][i]
        if int(gv.sum()) != int(wv.sum()):
            raise AssertionError(f"image {i}: {int(gv.sum())} vs "
                                 f"{int(wv.sum())} detections")
        if not torch.equal(got["classes"][i][gv], want["classes"][i][wv]):
            raise AssertionError(f"image {i}: classes differ")
        torch.testing.assert_close(got["boxes"][i][gv], want["boxes"][i][wv],
                                   atol=1e-3, rtol=0)
        torch.testing.assert_close(got["scores"][i][gv], want["scores"][i][wv],
                                   atol=0, rtol=1e-5)
        if "masks" in want:
            torch.testing.assert_close(got["masks"][i][gv],
                                       want["masks"][i][wv], atol=1e-4, rtol=0)
        err = {k: float((got[k][i][gv] - want[k][i][wv]).abs().max())
               if int(gv.sum()) else 0.0 for k in fields}
        lines.append(f"image {i}: {int(gv.sum())} dets, max err "
                     + " ".join(f"{k} {v:.3g}" for k, v in err.items()))
    return "; ".join(lines)


def phase_slice(dev, tmp: Path) -> tuple:
    cfg = M.MaskRCNNConfig()
    ckpt = tmp / "synthetic_e2e_mask_rcnn_R_50_FPN.pth"
    torch.save({"model": synthetic_state_dict(M.build_model(cfg), SEED)}, ckpt)
    pred = MaskRCNNPredictor(cfg, weights=str(ckpt), device=dev)
    landscape, portrait = synthetic_images(SEED)

    kernels.reset_launch_counts()
    res_l = pred.run_on_bgr_images(landscape)
    after_l = kernels.launch_counts()
    res_p = pred.run_on_bgr_image(portrait)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    per_forward = {"nms": 6, "roi_align": 2, "roi_align_bwd": 0,
                   "dcn_sample": 0, "dcn_sample_bwd": 0,
                   "mask_paste": 0, "canvas": 1}
    if after_l != per_forward or counts != {k: 2 * v for k, v in per_forward.items()}:
        raise AssertionError(f"launches: {after_l} after the landscape batch, "
                             f"{counts} after the portrait image; want "
                             f"{per_forward} per forward")
    ndet = [check_result(r, *img.shape[:2])
            for r, img in zip(res_l + [res_p], landscape + [portrait])]
    if min(ndet) == 0:
        raise AssertionError(f"no detections: {ndet}")
    log(f"[8 inference] predictor on 2 landscape 800x1200 + 1 portrait 1200x800 "
        f"images: launches {counts} (a canvas, 6 NMS + 2 RoIAlign per "
        f"forward), "
        f"detections {ndet}")

    # heads on one pyramid, kernels vs plain; TF32 off for the heads so the
    # comparison sees the kernels' differences only
    images, image_hw = canvas_batch(pred, landscape)
    prev_tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        with torch.inference_mode():
            pyramid = pred.model.backbone(images)
            got = M.forward_heads(pred.model, pyramid, image_hw, CANVAS)
            with kernels.force_plain():
                want = M.forward_heads(pred.model, pyramid, image_hw, CANVAS)
        torch.cuda.synchronize()
    finally:
        torch.backends.cudnn.allow_tf32 = prev_tf32
    log(f"[8 inference] heads on one pyramid, kernels vs plain: "
        f"{compare_heads(got, want)}; valid proposals "
        f"{got['proposal_valid'].sum(1).tolist()}, class-box candidates "
        f"{got['candidate_valid'].sum(1).tolist()}")
    return pred, counts


def canvas_batch(pred: MaskRCNNPredictor, imgs: list):
    canv, hws = [], []
    for img in imgs:
        c, hw, _ = preprocess_image_bgr(img)
        canv.append(c)
        hws.append(hw)
    images = torch.from_numpy(np.stack(canv).transpose(0, 3, 1, 2).copy())
    return (images.to(pred.device),
            torch.tensor(hws, dtype=torch.int64, device=pred.device))


# ---------------------------------------------------------------------------
# phase 9: Mask R-CNN training
# ---------------------------------------------------------------------------


def elliptic_instances(rng: np.random.Generator, img: np.ndarray,
                       n_gt: int) -> tuple:
    """(img, target): ``n_gt`` boxes of 4-33 % of the image's sides, each
    with an elliptic mask inside it painted into ``img`` in a colour of its
    own, classes 0..79, no crowd."""
    h, w = img.shape[:2]
    yy, xx = np.mgrid[:h, :w]
    wh = rng.uniform(0.04, 0.33, (n_gt, 2)) * [w, h]
    xy = rng.uniform(0, 1, (n_gt, 2)) * ([w, h] - wh)
    boxes = np.concatenate([xy, xy + wh], 1).astype(np.float32)
    masks = np.zeros((n_gt, h, w), np.uint8)
    for j, (x1, y1, x2, y2) in enumerate(boxes):
        cx, cy, rx, ry = (x1 + x2) / 2, (y1 + y2) / 2, (x2 - x1) / 2, (y2 - y1) / 2
        masks[j] = ((xx - cx) / rx) ** 2 + ((yy - cy) / ry) ** 2 <= 1
        img[masks[j] > 0] = rng.integers(0, 256, 3)
    return img, {"boxes": boxes,
                 "classes": rng.integers(0, 80, n_gt).astype(np.int64),
                 "masks": masks, "iscrowd": np.zeros(n_gt, np.int64)}


class SyntheticDataset:
    """In memory, with the interface do_train reads (that of the JAX
    package's CocoDetectionDataset): landscape 800x1200 RGB images, so the
    800x1344 canvas takes them without a resize, each with ``n_gt`` gt
    boxes, elliptic blob masks inside them painted into the image, and
    classes 0..79."""

    def __init__(self, seed: int, n_images: int = 4, n_gt: int = 10,
                 h: int = 800, w: int = 1200):
        rng = np.random.default_rng(seed)
        self.image_ids = list(range(1, n_images + 1))
        self.coco = SimpleNamespace(
            imgs={i: {"width": w, "height": h} for i in self.image_ids})
        self._data = {}
        for i in self.image_ids:
            self._data[i] = elliptic_instances(rng, textured_image(rng, h, w),
                                               n_gt)

    def load_image(self, iid) -> np.ndarray:
        return self._data[iid][0].copy()

    def load_target(self, iid) -> dict:
        return {k: v.copy() for k, v in self._data[iid][1].items()}


class SyntheticYolactDataset(SyntheticDataset):
    """In memory, with the interface yolact_train_loop.train reads:
    textured RGB images of 480-640 px a side (height and width drawn
    apart), each with 5-15 elliptic masks painted in."""

    def __init__(self, seed: int, n_images: int = YOLACT_BATCH):
        rng = np.random.default_rng(seed)
        self.image_ids = list(range(1, n_images + 1))
        self._data = {}
        for i in self.image_ids:
            h, w = (int(v) for v in rng.integers(480, 641, 2))
            self._data[i] = elliptic_instances(
                rng, textured_image(rng, h, w), int(rng.integers(5, 16)))


def frozen_names(model) -> list:
    """State-dict keys that must not train: the stem and layer1
    (FREEZE_CONV_BODY_AT 2) and every FrozenBN buffer."""
    names = [k for k in model.state_dict()
             if k.startswith(("backbone.body.stem.", "backbone.body.layer1."))]
    for m_name, m in model.named_modules():
        if isinstance(m, FrozenBatchNorm2d):
            names += [f"{m_name}.{b}" for b, _ in m.named_buffers()]
    return sorted(set(names))


def check_moved(model, before: dict, what: str = "") -> tuple:
    """After training from the state ``before``: every frozen tensor still
    and every trainable parameter moved -> (frozen names, trainable
    names)."""
    after = model.state_dict()
    frozen = frozen_names(model)
    moved_frozen = [k for k in frozen if not torch.equal(after[k], before[k])]
    trainable = [n for n, p in model.named_parameters() if p.requires_grad]
    still = [n for n in trainable if torch.equal(after[n], before[n])]
    if moved_frozen or still or set(trainable) & set(frozen):
        raise AssertionError(f"{what}: frozen that moved: {moved_frozen}; "
                             f"trainable that did not: {still}")
    return frozen, trainable


def step_grads(model, images, image_hw, targets, seed: int) -> tuple:
    """Losses and parameter gradients of one training forward + backward,
    the samplers drawing from a generator seeded with ``seed``."""
    model.zero_grad(set_to_none=True)
    gen = torch.Generator(device=images.device).manual_seed(seed)
    losses = TL.train_losses(model, images, image_hw, targets, gen)
    losses["total"].backward()
    grads = {n: p.grad.detach().clone() for n, p in model.named_parameters()
             if p.grad is not None}
    model.zero_grad(set_to_none=True)
    return {k: float(v.detach()) for k, v in losses.items()}, grads


def compare_steps(got: tuple, want: tuple, atol: float = 1e-6,
                  split: str | None = None) -> str:
    """Kernel path vs plain path of one step: losses rtol 1e-6 (the forward
    is the same: the forward kernels equal their plain versions bit for
    bit), every gradient rtol 1e-4 / atol ``atol`` max|g| (the backward
    kernels add with atomics, in an order that changes from run to run, as
    does the plain versions' index_add_ on the card). A failure names the
    three gradients furthest past the tolerance. With ``split``, the
    largest error of the gradients whose name holds it is reported apart
    from the rest's."""
    (gl, gg), (wl, wg) = got, want
    for k, w in wl.items():
        if not abs(gl[k] - w) <= 1e-6 * abs(w):
            raise AssertionError(f"loss {k}: kernels {gl[k]!r}, plain {w!r}")
    if sorted(gg) != sorted(wg):
        raise AssertionError("the two paths give gradients to other parameters")
    worst, zero, bad = {True: 0.0, False: 0.0}, [], []
    for name, w in wg.items():
        scale = float(w.abs().max())
        if scale == 0.0:
            zero.append(name)
            if bool(gg[name].abs().max() > 0):
                raise AssertionError(f"{name}: plain gradient 0, kernels not")
            continue
        err = (gg[name] - w).abs()
        excess = float((err - (1e-4 * w.abs() + atol * scale)).max())
        if excess > 0:
            bad.append((excess / scale, name, float(err.max()) / scale))
        apart = split is not None and split in name
        worst[apart] = max(worst[apart], float(err.max()) / scale)
    if bad:
        raise AssertionError(
            f"gradients past rtol 1e-4 / atol {atol:g} max|g| (excess and "
            "largest error, both of max|g|): " + "; ".join(
                f"{n} {e:.3g} {m:.3g}" for e, n, m in sorted(bad)[::-1][:3]))
    largest = (f"largest error {worst[False]:.3g} of max|g|" if split is None
               else f"largest error of max|g|: {worst[True]:.3g} in the "
               f"{split} gradients, {worst[False]:.3g} in the others")
    return (f"losses equal to rtol 1e-6 ({', '.join(f'{k} {v:.6g}' for k, v in gl.items())}); "
            f"{len(wg)} gradients within rtol 1e-4 / atol {atol:g} max|g|, "
            f"{largest}; zero on both paths: {len(zero)}")


def phase_train(dev, tmp: Path) -> dict:
    cfg = M.MaskRCNNConfig()
    model = M.build_model(cfg)
    sd = synthetic_state_dict(model, SEED + 7)
    # a trained network's FrozenBN statistics match its activations: the
    # stem's variance is set to that of the mean-subtracted pixels it sees,
    # so activations are of unit scale and SGD at upstream's learning rate
    # does not blow them up in a few steps, as it does from unit variances
    sd["backbone.body.stem.bn1.running_var"] *= PIXEL_VAR
    model.load_state_dict(sd, strict=True)
    data = SyntheticDataset(SEED + 7)
    model = model.to(dev)
    before = {k: v.clone() for k, v in model.state_dict().items()}

    kernels.reset_launch_counts()
    model, it, history = TL.do_train(
        data, cfg, model=model, max_steps=TRAIN_STEPS, ims_per_batch=2,
        checkpoint_period=TRAIN_STEPS, log_every=1, output_dir=str(tmp),
        device=dev)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    want = {k: TRAIN_STEPS * v for k, v in PER_STEP.items()}
    if it != TRAIN_STEPS or counts != want:
        raise AssertionError(f"{it} iterations launched {counts}; want "
                             f"{TRAIN_STEPS} launching {want}")
    bad = [h for h in history if not all(np.isfinite(v) for v in h.values())]
    if bad or len(history) != TRAIN_STEPS:
        raise AssertionError(f"losses not finite: {bad}")
    frozen, trainable = check_moved(model, before)
    fresh = M.build_model(cfg)
    ckpt = torch.load(tmp / f"model_{TRAIN_STEPS:07d}.pth", weights_only=True)
    fresh.load_state_dict(ckpt["model"], strict=True)
    log(f"[9 train] do_train {it} iterations at B = 2 on the 800x1344 canvas: "
        f"launches {counts} ({PER_STEP} per step); total loss "
        f"{[round(h['total'], 4) for h in history]}; {len(frozen)} frozen "
        f"tensors still, {len(trainable)} trainable parameters moved; "
        f"model_{TRAIN_STEPS:07d}.pth loads with strict=True")

    # one step on one batch through the kernels and the plain versions,
    # with the same draws; TF32 off so only the kernels differ
    rng = np.random.default_rng(SEED + 8)
    batch = TL.batch_to_device([TL.build_train_example(data, i, rng=rng)
                                for i in data.image_ids[:2]], dev)
    prev_tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        kernels.reset_launch_counts()
        got = step_grads(model, *batch, seed=SEED + 9)
        path_counts = kernels.launch_counts()
        with kernels.force_plain():
            want = step_grads(model, *batch, seed=SEED + 9)
        torch.cuda.synchronize()
    finally:
        torch.backends.cudnn.allow_tf32 = prev_tf32
    if path_counts != PER_STEP:
        raise AssertionError(f"kernel-path step launched {path_counts}")
    log(f"[9 train] one step, kernels vs plain (cudnn.allow_tf32 False, "
        f"matmul precision {torch.get_float32_matmul_precision()}): "
        f"{compare_steps(got, want)}")
    return {"model": model, "batch": batch, "counts": counts}


# ---------------------------------------------------------------------------
# phase 10: YOLACT++ inference
# ---------------------------------------------------------------------------


def synthetic_yolact_state_dict(model: torch.nn.Module, seed: int,
                                offset_scale: float = OFFSET_SCALE) -> dict:
    """Upstream-keyed random YOLACT weights from a numpy seed: BN stats
    near 1, conv weights N(0, 1/fan), small biases. The DCN offset convs
    get ``offset_scale`` times that (upstream zero-initialises them, and
    zero offsets would make every DCN a plain conv): at OFFSET_SCALE their
    offsets span a few pixels with fractional parts and some taps leave
    the map. A DarkNet-53's residual branches are damped by
    ``DARKNET_RESIDUAL_SCALE``."""
    rng = np.random.default_rng(seed)
    sd = {}
    for k, v in model.state_dict().items():
        shape = tuple(v.shape)
        if k.endswith("num_batches_tracked"):
            sd[k] = torch.zeros((), dtype=torch.int64)
            continue
        if k.endswith("running_var") or (k.endswith(".weight")
                                         and len(shape) == 1):
            a = rng.uniform(0.7, 1.3, shape)
        elif k.endswith(".weight"):
            a = rng.standard_normal(shape) * np.prod(shape[1:]) ** -0.5
            if "conv_offset_mask" in k:
                a *= offset_scale
            elif k.endswith("conf_layer.weight"):
                a *= CONF_SCALE
        elif k.endswith("running_mean"):
            a = rng.standard_normal(shape) * 0.05
        else:  # biases
            a = rng.standard_normal(shape) * 0.02
        if ".conv2.bn." in k and not k.endswith("running_var"):
            a = a * DARKNET_RESIDUAL_SCALE  # DarkNet's residual branch
        sd[k] = torch.from_numpy(a.astype(np.float32))
    return sd


def calibrate_yolact_gate(model, images: torch.Tensor, want=(10, 80),
                          margin: float = 1e-4) -> float:
    """Add to the class layer's background biases the least shift (a grid
    of 0.05) after which every image of ``images`` (normalised [B, 3, S,
    S]) has ``want[0]``..``want[1]`` priors whose best class score passes
    ``conf_thresh``, and no prior's best score lies within ``margin`` of
    it (random weights give no trained network's wide gap between
    background and objects). A shift of the background logit moves every
    score without another forward. Returns the shift."""
    cfg = model.cfg
    with torch.no_grad():
        conf = model(images)["conf"].double()
        fg_max = conf[..., 1:].amax(-1)
        fg_lse = torch.logsumexp(conf[..., 1:], -1)
        # plain YOLACT R-50's logits (phase 19) need a shift past 40
        for shift in np.arange(0.0, 80.0, 0.05):
            # the best foreground softmax score with the shifted background
            best = torch.exp(fg_max - torch.logaddexp(conf[..., 0] + shift,
                                                      fg_lse))
            n = (best > cfg.conf_thresh).sum(1)
            if (bool(((n >= want[0]) & (n <= want[1])).all())
                    and float((best - cfg.conf_thresh).abs().min()) > margin):
                bias = model.prediction_layers[0].conf_layer.bias
                bias.view(-1, cfg.num_classes)[:, 0] += float(shift)
                return float(shift)
    raise AssertionError("no background shift puts the gate in a gap")


def yolact_images(seed: int, b: int, size: int) -> np.ndarray:
    """[b, size, size, 3] uint8 RGB textured images."""
    rng = np.random.default_rng(seed)
    return np.stack([textured_image(rng, size, size) for _ in range(b)])


def check_yolact(pred: YolactPredictor, det: dict, b: int) -> list:
    """Shapes, finite values, boxes inside the image after upstream's
    post-processing, masks in [0, 1], a detection in every image; returns
    the detection counts."""
    k, s = pred.cfg.max_num_detections, 2 * YM.level_sizes(pred.cfg)[0]
    shapes = {"boxes": (b, k, 4), "scores": (b, k), "classes": (b, k),
              "masks": (b, k, s, s), "valid": (b, k)}
    if pred.cfg.use_maskiou:
        shapes["mask_scores"] = (b, k)
    if {n: tuple(v.shape) for n, v in det.items()} != shapes:
        raise AssertionError(f"YOLACT detections {det.keys()}")
    det = {n: v.float().cpu().numpy() if v.is_floating_point()
           else v.cpu().numpy() for n, v in det.items()}
    counts = det["valid"].sum(1).tolist()
    v = det["valid"]
    if min(counts) == 0 or not all(np.isfinite(det[n][v]).all() for n in (
            "boxes", "scores", "masks", "mask_scores") if n in det):
        raise AssertionError(f"YOLACT detections: counts {counts}, or not "
                             "finite")
    if not ((det["masks"] >= 0) & (det["masks"] <= 1)).all() or not (
            (det["scores"][v] > 0) & (det["scores"][v] <= 1)).all():
        raise AssertionError("YOLACT masks or scores outside [0, 1]")
    size = pred.cfg.img_size
    for i in range(b):
        res = pred.postprocess_image({n: a[i] for n, a in det.items()},
                                     size, size)
        if not ((res["boxes"] >= 0) & (res["boxes"] <= size)).all() or (
                res["masks"].shape != (counts[i], size, size)):
            raise AssertionError(f"YOLACT image {i}: post-processed boxes "
                                 "outside the image")
    return counts


def compare_yolact(got: dict, want: dict) -> tuple:
    """Kernel path vs plain path on one batch, detection for detection:
    counts and classes equal, boxes atol 1e-5, scores and mask_scores rtol
    1e-5, masks atol 1e-4. Returns the largest errors."""
    err = {n: 0.0 for n in ("boxes", "scores", "mask_scores", "masks")}
    for i in range(got["valid"].shape[0]):
        gv, wv = got["valid"][i], want["valid"][i]
        if int(gv.sum()) != int(wv.sum()) or not torch.equal(
                got["classes"][i][gv], want["classes"][i][wv]):
            raise AssertionError(f"YOLACT image {i}: detections differ")
        for n, (atol, rtol) in (("boxes", (1e-5, 0)), ("scores", (0, 1e-5)),
                                ("mask_scores", (0, 1e-5)),
                                ("masks", (1e-4, 0))):
            torch.testing.assert_close(got[n][i][gv], want[n][i][wv],
                                       atol=atol, rtol=rtol)
            err[n] = max(err[n], float((got[n][i][gv] - want[n][i][wv])
                                       .abs().max()))
    return err


def phase_yolact(dev) -> dict:
    """YOLACT++-550 R-50-FPN through YolactPredictor on the card, f32 and
    bf16, B = 1 and 8, on synthetic upstream-keyed weights whose DCN
    offsets are not zero: 13 dcn_sample launches per forward, sane
    detections, and kernels vs plain (TF32 off) detection for detection."""
    cfg = yolact_model_config("yolact_plus_resnet50")
    model = YM.build_model(cfg)
    model.load_state_dict(synthetic_yolact_state_dict(model, SEED),
                          strict=True)
    images = yolact_images(SEED, 8, cfg.img_size)
    model = model.to(dev)
    shift = calibrate_yolact_gate(
        model, yolact_preprocess(torch.from_numpy(images).to(dev),
                                 cfg.img_size), want=(10, 500), margin=0.0)
    sd = {k: v.cpu() for k, v in model.state_dict().items()}
    del model
    preds = {dt: YolactPredictor(cfg, state_dict=sd, dtype=dt, device=dev)
             for dt in (torch.float32, torch.bfloat16)}
    per_forward = {"nms": 0, "roi_align": 0, "roi_align_bwd": 0,
                   "dcn_sample": sum(DCN_PER_FORWARD), "dcn_sample_bwd": 0,
                   "mask_paste": 0, "canvas": 0}
    lines = []
    for dt, pred in preds.items():
        for b in (1, 8):
            kernels.reset_launch_counts()
            det = pred.run_batch(images[:b])
            torch.cuda.synchronize()
            counts = kernels.launch_counts()
            if counts != per_forward:
                raise AssertionError(f"YOLACT {dt} B={b} launched {counts}; "
                                     f"want {per_forward}")
            lines.append(f"{str(dt)[6:]} B={b}: detections "
                         f"{check_yolact(pred, det, b)}")
    prev_tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        got = preds[torch.float32].run_batch(images)
        with kernels.force_plain():
            want = preds[torch.float32].run_batch(images)
        torch.cuda.synchronize()
    finally:
        torch.backends.cudnn.allow_tf32 = prev_tf32
    err = compare_yolact(got, want)
    # the greedy-NMS option (use_fast_nms=False): one NMS launch per batch
    pred = preds[torch.float32]
    greedy = dataclasses.replace(cfg, use_fast_nms=False)
    with torch.inference_mode():
        raw = {k: v.float() for k, v in pred.model(yolact_preprocess(
            torch.from_numpy(images).to(dev), cfg.img_size)).items()}
        kernels.reset_launch_counts()
        got = YM.detect(raw, pred.priors, greedy, pred.model.maskiou_net)
        greedy_counts = kernels.launch_counts()
        with kernels.force_plain():
            want = YM.detect(raw, pred.priors, greedy, pred.model.maskiou_net)
    if greedy_counts["nms"] != 1:
        raise AssertionError(f"greedy-NMS detect launched {greedy_counts}")
    err_greedy = compare_yolact(got, want)
    log(f"[10 yolact] YolactPredictor, yolact_plus_resnet50 at "
        f"{cfg.img_size}x{cfg.img_size} "
        f"(background logit +{shift:.2f}): {per_forward['dcn_sample']} "
        f"dcn_sample launches per forward; " + "; ".join(lines)
        + "; kernels vs plain, f32 B=8, TF32 off: detections equal, max err "
        + ", ".join(f"{n} {e:.3g}" for n, e in err.items())
        + "; detect with use_fast_nms=False (1 NMS launch), kernel vs plain "
        f"NMS: detections {got['valid'].sum(1).tolist()} equal, max err "
        + ", ".join(f"{n} {e:.3g}" for n, e in err_greedy.items()))
    return {"preds": preds, "images": images, "counts": per_forward}


def time_mask_paste(masks, kept: np.ndarray, h: int, w: int) -> tuple:
    """The paste of ``masks[kept]`` to h x w: (kernel ms through the
    wrapper, plain ms, bound ms, what bounds it, F.interpolate + gt on the
    gathered masks, the kernel's launch alone)."""
    dev, (n, s) = masks.device, (len(kept), masks.shape[1])
    k, p = time_pair(lambda: paste_masks(masks, kept, h, w))
    gathered = masks[torch.from_numpy(kept).to(dev)].contiguous()
    lib = cuda_time_ms(lambda: F.interpolate(
        gathered[:, None], size=(h, w), mode="bilinear",
        align_corners=False)[:, 0] > 0.5)
    slots = torch.from_numpy(kept).to(dev)
    out = torch.empty((n, h, w), dtype=torch.uint8, device=dev)
    alone = cuda_time_ms(lambda: kernels.library().tpuseg_mask_paste_f32(
        masks.data_ptr(), *masks.stride(), slots.data_ptr(), n, s, h, w,
        out.data_ptr(), kernels.stream_ptr(dev)))
    # a byte written a pixel and the kept masks read once; a pixel's two
    # row samples weighed (FMA, multiply) and compared
    return (k, p) + bound(n * h * w + n * s * s * 4,
                          MASK_PASTE_OPS_PER_PIXEL * n * h * w) + (lib, alone)


def paste_flips(got, masks, kept: np.ndarray, h: int, w: int,
                want=None) -> tuple:
    """Pixels where ``got`` (uint8 [n, h, w]) differs from the plain paste
    of ``masks[kept]`` (on the masks' device, or ``want``): (count, the
    largest distance of their plain value from 0.5); a flip more than
    1e-5 from it raises."""
    idx = torch.from_numpy(kept).to(masks.device)
    values = F.interpolate(masks[idx][:, None].float(), size=(h, w),
                           mode="bilinear", align_corners=False)[:, 0]
    if want is None:
        want = (values > 0.5).to(torch.uint8)
    flips = torch.as_tensor(got).to(masks.device) != torch.as_tensor(
        want).to(masks.device)
    dist = float((values[flips] - 0.5).abs().max()) if bool(
        flips.any()) else 0.0
    if dist >= 1e-5:
        raise AssertionError(f"mask paste: {int(flips.sum())} pixels "
                             f"differ, one {dist:.3g} from 0.5")
    return int(flips.sum()), dist


def phase_mask_paste(dev, yolact: dict, card: str) -> dict:
    """YOLACT's mask paste on the card as the stream runs it: phase 10's
    f32 YOLACT++ predictor's predict_images over 640x480 frames, one
    forward each (its counters and launches), its masks against the host
    paste of the same detections, and the kernel against its plain
    version at the detector's layout and the stream's shape (n = 100 of
    S = 138 to 480x640), with its time beside its bound."""
    pred = yolact["preds"][torch.float32]
    h, w = STREAM_HW
    rng = np.random.default_rng(SEED + 10)
    frames = [textured_image(rng, h, w) for _ in range(MASK_PASTE_FRAMES)]
    pred.predict_images(frames[:1])  # the warm-up (cuDNN's choices)
    torch.cuda.synchronize()
    timer.reset()
    kernels.reset_launch_counts()
    with profile(activities=[ProfilerActivity.CPU]):
        res = pred.predict_images(frames)
        torch.cuda.synchronize()
    counts, c = kernels.launch_counts(), timer.counters()
    timer.reset()
    n_masks = [len(r["scores"]) for r in res]
    want = {"nms": 0, "roi_align": 0, "roi_align_bwd": 0,
            "dcn_sample": sum(DCN_PER_FORWARD) * len(frames),
            "dcn_sample_bwd": 0, "mask_paste": sum(n > 0 for n in n_masks),
            "canvas": 0}
    if (counts != want or not want["mask_paste"]
            or c.get("predictor.masks_pasted_on_device")
            != c["predictor.masks"] or c["predictor.masks"] != sum(n_masks)
            or any(r["masks"].shape != (n, h, w)
                   or r["masks"].dtype != np.uint8
                   for r, n in zip(res, n_masks))):
        raise AssertionError(f"predict_images of {len(frames)} frames: "
                             f"{n_masks} masks, launched {counts} (want "
                             f"{want}), counters {dict(c)}")
    # the same detections pasted on the card and on the host
    det = pred.run_batch(frames[0][None])
    on_card = {k: v[0] if k == "masks" else v[0].cpu().numpy()
               for k, v in det.items()}
    on_host = {k: v[0].cpu().numpy() for k, v in det.items()}
    got = pred.postprocess_image(on_card, h, w)
    host = pred.postprocess_image(on_host, h, w)
    for k in ("boxes", "scores", "classes", "mask_scores"):
        if not np.array_equal(got[k], host[k]):
            raise AssertionError(f"postprocess_image on the card: {k} "
                                 "differ from the host's")
    kept = np.flatnonzero(on_host["valid"] & (on_host["scores"] > 0))
    vs_host = paste_flips(got["masks"], det["masks"][0].cpu(), kept, h, w,
                          host["masks"])
    # the kernel against its plain version on the card, every slot of the
    # detector's [K, S, S] view of an [S, S, K] array: the stream's shape
    masks = det["masks"][0]
    every = np.arange(masks.shape[0])
    k_out = paste_masks(masks, every, h, w)
    with kernels.force_plain():
        p_out = paste_masks(masks, every, h, w)
    vs_plain = paste_flips(k_out, masks, every, h, w, p_out)
    t = time_mask_paste(masks, every, h, w)
    label = (f"mask_paste float32 n={len(every)} S={masks.shape[1]} "
             f"{h}x{w}")
    log(f"[10 paste] predict_images of {len(frames)} {w}x{h} frames, "
        f"{n_masks} masks: {counts['mask_paste']} mask_paste launches, "
        f"predictor.masks_pasted_on_device "
        f"{c['predictor.masks_pasted_on_device']} of predictor.masks "
        f"{c['predictor.masks']}, download "
        f"{c['predictor.download_bytes']} bytes; the card's masks against "
        f"the host's: {vs_host[0]} pixels differ (within {vs_host[1]:.3g} "
        f"of 0.5); {label}, detector layout, against the plain paste on "
        f"the card: {vs_plain[0]} pixels differ (within {vs_plain[1]:.3g} "
        f"of 0.5); kernel {t[0]:.4f} ms (the launch alone {t[5]:.4f} ms), "
        f"plain {t[1]:.4f} ms, bound {t[2]:.4g} ms by {t[3]}, "
        f"F.interpolate + gt {t[4]:.4f} ms [{card}]")
    return {"counts": want, "flips": {"host": vs_host, "plain": vs_plain},
            "times": {label: t}, "label": label}


# ---------------------------------------------------------------------------
# phase 11: YOLACT++ training
# ---------------------------------------------------------------------------


def yolact_step_grads(model, images, targets, priors, draws, loss_cfg) -> tuple:
    """Losses and parameter gradients of one YOLACT training forward +
    backward on the given mask-subset draws."""
    model.zero_grad(set_to_none=True)
    preds, sem = model.forward_train(images)
    losses = YLOSS.total_loss(preds, sem, targets, priors, draws, loss_cfg,
                              maskiou_net=model.maskiou_net)
    losses["total"].backward()
    grads = {n: p.grad.detach().clone() for n, p in model.named_parameters()
             if p.grad is not None}
    model.zero_grad(set_to_none=True)
    return {k: float(v.detach()) for k, v in losses.items()}, grads


def phase_yolact_train(dev, tmp: Path) -> dict:
    """yolact_plus_resnet50 at 550 through yolact_train_loop.train, B = 8
    (train-mode BatchNorm), f32 with TF32 convolutions, synthetic
    upstream-keyed weights with non-zero DCN offsets (TRAIN_OFFSET_SCALE)."""
    name = "yolact_plus_resnet50"
    cfg = yolact_model_config(name)
    loss_cfg = yolact_loss_config(name)
    model = YM.build_model(cfg)
    model.load_state_dict(synthetic_yolact_state_dict(
        model, SEED + 11, offset_scale=TRAIN_OFFSET_SCALE), strict=True)
    data = SyntheticYolactDataset(SEED + 11)
    before = {k: v.clone() for k, v in model.state_dict().items()}

    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    model, it, history = YTL.train(
        data, cfg, batch_size=YOLACT_BATCH, max_steps=YOLACT_TRAIN_STEPS,
        save_every=YOLACT_TRAIN_STEPS, save_folder=str(tmp), cfg_name=name,
        log_every=1, loss_cfg=loss_cfg, model=model, device=dev)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = kernels.launch_counts()
    want = {k: YOLACT_TRAIN_STEPS * v for k, v in YOLACT_PER_STEP.items()}
    if it != YOLACT_TRAIN_STEPS or counts != want:
        raise AssertionError(f"{it} YOLACT iterations launched {counts}; want "
                             f"{YOLACT_TRAIN_STEPS} launching {want}")
    keys = ("B", "C", "M", "S", "I", "total")
    bad = [h for h in history
           if tuple(h) != keys or not all(np.isfinite(v) for v in h.values())]
    if bad or len(history) != YOLACT_TRAIN_STEPS:
        raise AssertionError(f"YOLACT losses not finite or incomplete: {bad}")
    after = model.state_dict()
    after = {k: v.cpu() for k, v in after.items()}
    still = [n for n, _ in model.named_parameters()
             if torch.equal(after[n], before[n])]
    stats = [k for k in after if k.endswith(("running_mean", "running_var"))]
    stale = [k for k in stats if torch.equal(after[k], before[k])]
    if still or stale or model.freeze_bn:
        raise AssertionError(f"parameters that did not move: {still}; "
                             f"running statistics not updated: {stale}")
    path = ckpt_path(str(tmp), name, it // (len(data.image_ids)
                                            // YOLACT_BATCH), it)
    fresh = YM.build_model(cfg)
    fresh.load_state_dict(torch.load(path, weights_only=True), strict=True)
    n_params = sum(1 for _ in model.parameters())
    log(f"[11 yolact_train] train() {it} iterations at B = {YOLACT_BATCH}, "
        f"{cfg.img_size}x{cfg.img_size}, f32 with TF32 convolutions, "
        f"train-mode BatchNorm, in {seconds:.1f} s: launches {counts} "
        f"({YOLACT_PER_STEP['dcn_sample']} + "
        f"{YOLACT_PER_STEP['dcn_sample_bwd']} per step); losses "
        + "; ".join(", ".join(f"{k} {v:.4g}" for k, v in h.items())
                    for h in history)
        + f"; all {n_params} parameters moved, {len(stats)} running "
        f"statistics updated; {Path(path).name} loads with strict=True")

    # one step on one batch through the kernels and the plain versions,
    # with the same draws; TF32 off and deterministic cuDNN, so that only
    # the kernels differ: with frozen BatchNorm (train() below a batch of
    # 6) at phase 9's tolerance, and in train mode against the spread of
    # the kernel path between two runs
    rng = np.random.default_rng(SEED + 12)
    images, targets = YTL.batch_to_device(
        *next(YTL.batch_iterator(data, cfg, rng, YOLACT_BATCH)), dev)
    priors = torch.from_numpy(YM.make_priors_np(cfg)).to(dev)
    draws = torch.rand((YOLACT_BATCH, priors.shape[0]), device=dev,
                       generator=torch.Generator(device=dev).manual_seed(
                           SEED + 13))
    batch = (images, targets, priors, draws, loss_cfg)
    with exact_convs():
        model.freeze_bn = True
        model.train()
        kernels.reset_launch_counts()
        got = yolact_step_grads(model, *batch)
        path_counts = kernels.launch_counts()
        with kernels.force_plain():
            want = yolact_step_grads(model, *batch)
        model.freeze_bn = False
        model.train()
        runs = [yolact_step_grads(model, *batch) for _ in range(2)]
        with kernels.force_plain():
            runs += [yolact_step_grads(model, *batch) for _ in range(2)]
        torch.cuda.synchronize()
    if path_counts != YOLACT_PER_STEP:
        raise AssertionError(f"YOLACT kernel-path step launched {path_counts}")
    # atol 1e-5 max|g|, not phase 9's 1e-6: an offset conv's gradient sums,
    # over the 38 088 positions of a B = 8 layer2 map, coordinate gradients
    # that are themselves sums over 128-512 channels, which the backward
    # kernel's warps take in another order than the plain torch.sum
    # (measured on an H100: layer2 block 2's offset conv missed 1e-6 max|g|
    # by 1.9e-8)
    log(f"[11 yolact_train] one step, frozen BatchNorm, kernels vs plain "
        f"(cudnn.allow_tf32 False, cudnn.deterministic True, matmul "
        f"precision {torch.get_float32_matmul_precision()}): "
        f"{compare_steps(got, want, atol=1e-5, split='conv_offset_mask')}")
    log(f"[11 yolact_train] one step, train-mode BatchNorm: "
        f"{compare_train_mode(*runs)}")
    return {"model": model, "data": data, "cfg": cfg, "loss_cfg": loss_cfg,
            "batch": (images, targets), "priors": priors, "draws": draws,
            "counts": counts}


def rel_l2(a: dict, b: dict) -> dict:
    """Per gradient, ||a - b|| / ||b|| (0 where b is 0 and a too)."""
    out = {}
    for name, w in b.items():
        norm = float(w.norm())
        diff = float((a[name] - w).norm())
        out[name] = diff / norm if norm else (0.0 if diff == 0 else np.inf)
    return out


def compare_train_mode(k1: tuple, k2: tuple, p1: tuple, p2: tuple,
                       floor: float = 1e-3, cap: float = 1e-2,
                       what: str = "train-mode", cancelled=(),
                       loss_rtol: float = 1e-6,
                       names: tuple = ("kernels", "plain"),
                       wide: tuple = ("", 0.0)) -> str:
    """Kernels and plain, two runs each, with train-mode BatchNorm: losses
    equal to rtol 1e-6 (the forward is the same); per gradient, the
    relative L2 error between the kernel and the plain path within ten
    times the spread of either path between its own two runs, but no less
    than ``floor`` and no more than ``cap``. Train-mode BatchNorm's backward
    subtracts, per channel, the mean of the gradient and of its product
    with the normalised input; that difference of nearly equal sums
    magnifies the rounding of the atomic adds, whose order changes from run
    to run in both backward versions. A kernel that dropped or misplaced a
    term would be off by O(1). Left out by rule: the gradients that are
    zero to rounding on the plain path (max|g| below 1e-6 of the largest:
    the bias of a conv in front of a train-mode BatchNorm, which its batch
    mean cancels); the kernel path's must be too. In bf16 that rounding
    leaves more than 1e-6 of the largest: ``cancelled`` names such biases,
    whose gradient is zero in exact arithmetic, and the kernel path's must
    be rounding residue of the same size (its norm at most twice the plain
    runs'). ``loss_rtol``, ``names`` (the two paths' names in the
    messages) and ``wide`` (a name's substring and the limit of the
    gradients whose names hold it) serve two paths whose forwards round
    apart (phase 18)."""
    (l1, g1), (l2, g2), (lp, gp), (_, gp2) = k1, k2, p1, p2
    kn, pn = names
    for k, w in lp.items():
        for got in (l1, l2):
            if not abs(got[k] - w) <= loss_rtol * abs(w):
                raise AssertionError(f"{what} loss {k}: {kn} "
                                     f"{got[k]!r}, {pn} {w!r}")
    if sorted(g1) != sorted(gp):
        raise AssertionError("the two paths give gradients to other parameters")
    top = max(float(w.abs().max()) for w in gp.values())
    zero = [n for n, w in gp.items() if float(w.abs().max()) <= 1e-6 * top]
    loud = [n for n in zero if float(g1[n].abs().max()) > 1e-6 * top]
    if loud:
        raise AssertionError(f"{what} gradients zero to rounding on the "
                             f"plain path but not on the kernel path: {loud}")
    noise = [n for n in cancelled if n not in zero]
    big = [n for n in noise if float(g1[n].norm()) > 2 * max(
        float(gp[n].norm()), float(gp2[n].norm()))]
    if big:
        raise AssertionError(f"{what} gradients that cancel to rounding "
                             f"residue on the plain path but are larger on "
                             f"the kernel path: {big}")
    live = {n: w for n, w in gp.items() if n not in zero and n not in noise}
    kp = rel_l2(g1, live)
    kk = rel_l2(g1, {n: g2[n] for n in live})
    pp = rel_l2(gp2, live)
    wide_names = [n for n in kp if wide[0] and wide[0] in n]
    limit = {n: wide[1] if n in wide_names
             else min(max(floor, 10 * max(kk[n], pp[n])), cap) for n in kp}
    bad = sorted(((kp[n] / limit[n], n) for n in kp if kp[n] > limit[n]),
                 reverse=True)
    if bad:
        raise AssertionError(f"{what}: {len(bad)} gradients past the limit: "
                             + "; ".join(
            f"{n} {kn} vs {pn} {kp[n]:.3g}, {kn} {kk[n]:.3g}, {pn} "
            f"{pp[n]:.3g}" for _, n in bad[:3]))
    worst = max(kp, key=kp.get)

    def med(d):
        return float(np.median(list(d.values())))

    residue_note = (f"; {len(noise)} cancelled to rounding residue of the "
                    f"same size on both paths" if cancelled else "")
    if wide_names:
        w_top = max(wide_names, key=kp.get)
        rest = [kp[n] for n in kp if n not in wide_names]
        residue_note += (f"; the {len(wide_names)} {wide[0]} gradients "
                         f"(limit {wide[1]:g}): largest {kp[w_top]:.3g} "
                         f"({w_top}); the rest's largest "
                         f"{max(rest):.3g}")
    lerr = max(abs(got[k] - w) / abs(w) for k, w in lp.items()
               for got in (l1, l2) if w)
    return (f"losses equal to rtol {loss_rtol:g} in both {kn} runs (largest "
            f"{lerr:.3g}); {len(zero)} "
            f"gradients zero to rounding on both paths (max|g| <= 1e-6 of "
            f"{top:.4g}){residue_note}; relative L2 error of the other "
            f"{len(live)}, {kn} "
            f"vs {pn}: median {med(kp):.3g}, largest {kp[worst]:.3g} "
            f"({worst}, limit {limit[worst]:.3g}); {kn} vs {kn}: median "
            f"{med(kk):.3g}, largest {max(kk.values()):.3g}; {pn} vs {pn}: "
            f"median {med(pp):.3g}, largest {max(pp.values()):.3g}")


# ---------------------------------------------------------------------------
# phase 12: timing
# ---------------------------------------------------------------------------


def time_pair(fn, iters=20) -> tuple:
    """(kernel ms, plain ms), measured plain, kernel, kernel, plain."""
    def plain():
        with kernels.force_plain():
            return fn()
    p1 = cuda_time_ms(plain, iters)
    k1 = cuda_time_ms(fn, iters)
    k2 = cuda_time_ms(fn, iters)
    p2 = cuda_time_ms(plain, iters)
    return (k1 + k2) / 2, (p1 + p2) / 2


def bound(nbytes: float, ops: float) -> tuple:
    """(least ms, what bounds it): bytes over the memory rate against f32
    operations over the f32 rate, the larger of the two."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nms_pairs(boxes, scores, valid, classes, thr: float) -> int:
    """IoU tests that greedy NMS needs on these inputs: each kept box
    against every lower-scored box still alive at its turn (of its own
    class, for the class-aware NMS), over the batch."""
    total = 0
    for i in range(boxes.shape[0]):
        order = torch.sort(scores[i], descending=True, stable=True).indices
        b = boxes[i][order].double().cpu().numpy()
        alive = valid[i][order].cpu().numpy().copy()
        cls = (classes[i][order].cpu().numpy() if classes is not None
               else np.zeros(len(b), np.int64))
        area = (b[:, 2] - b[:, 0] + 1) * (b[:, 3] - b[:, 1] + 1)
        for j in range(len(b)):
            if not alive[j]:
                continue
            rest = np.nonzero(alive[j + 1:] & (cls[j + 1:] == cls[j]))[0] + j + 1
            total += rest.size
            iw = (np.minimum(b[j, 2], b[rest, 2]) - np.maximum(b[j, 0], b[rest, 0])
                  + 1).clip(0)
            ih = (np.minimum(b[j, 3], b[rest, 3]) - np.maximum(b[j, 1], b[rest, 1])
                  + 1).clip(0)
            inter = iw * ih
            alive[rest[inter / (area[j] + area[rest] - inter) > thr]] = False
    return total


def nms_bound(boxes, scores, valid, classes, thr) -> tuple:
    n = boxes.numel() // 4
    nbytes = n * (16 + 4 + 1 + 1) + (0 if classes is None else n * 8)
    return bound(nbytes, NMS_OPS_PER_PAIR * nms_pairs(boxes, scores, valid,
                                                      classes, thr))


def pyramid_bytes(itemsize: int) -> int:
    return 2 * 256 * sum(h * w for h, w in LEVEL_HW) * itemsize


def touched_cells(boxes, bidx, levels, p: int) -> int:
    """Distinct (image, level, y, x) cells that the forward's bilinear
    samples give a non-zero weight on these rois: the feature cells the
    function needs."""
    lat, _, _ = sampling._pyramid_lattice(LEVEL_HW, boxes.float(), bidx,
                                          levels, p, 2, STRIDES)
    idx4, w4 = sampling._corners(lat, slice(None))
    return int(torch.unique(idx4[w4 != 0]).numel())


def roi_bound(n: int, p: int, feat_bytes: int, itemsize: int) -> tuple:
    """RoIAlign forward or backward: ``feat_bytes`` of features read (the
    forward) or of their gradient written (the backward), the rois (f32
    boxes, int32 image and level) and [N, 256, P, P] in ``itemsize``;
    4 S*S samples' arithmetic per pooled value."""
    nbytes = feat_bytes + n * (16 + 4 + 4) + n * 256 * p * p * itemsize
    return bound(nbytes, n * 256 * p * p * 4 * ROI_OPS_PER_SAMPLE)


def roi_fwd_bound(case, p: int, itemsize: int) -> tuple:
    """K2 reads only the cells its samples weigh, 256 channels each."""
    _, boxes, bidx, levels = case
    cells = touched_cells(boxes, bidx, levels, p)
    return roi_bound(boxes.shape[0], p, cells * 256 * itemsize, itemsize)


def roi_bwd_bound(n: int, p: int, itemsize: int) -> tuple:
    """K3 writes the gradient of every cell of P2-P5, touched or not."""
    return roi_bound(n, p, pyramid_bytes(itemsize), itemsize)


def bwd_merge_counts(boxes, bidx, levels, p: int, s: int = 2, c: int = 256,
                     level_hw=LEVEL_HW, strides=STRIDES) -> dict:
    """What the RoIAlign backward kernel adds into the global buffers on
    these rois, counted from the forward's geometry with C = ``c`` in float4
    vectors: ``corner_adds``, the direct design's vector reductions (each
    valid sample's four corners); ``flushes``, the merging design's (each
    cell that a roi's valid samples touch, once per vector, where they
    touch at most BWD_MAX_COLS columns, else its corners; a vector of
    zeros is skipped on the card, so these are at most); and
    ``direct_share``, the share of rois (and so of blocks) that add
    directly."""
    lat, _, _ = sampling._pyramid_lattice(level_hw, boxes.float(), bidx,
                                          levels, p, s, strides)

    def axis(t, extent):
        """-> valid samples, distinct touched cells of each roi."""
        e = extent[:, None]
        valid = (t >= -1.0) & (t <= e)
        lo = torch.floor(torch.minimum(t.clamp(min=0.0), e - 1))
        hi = torch.minimum(lo + 1, e - 1)
        cells = torch.cat([lo, hi], 1).masked_fill(
            ~torch.cat([valid, valid], 1), -1.0).sort(1).values
        distinct = (((cells[:, 1:] != cells[:, :-1]) & (cells[:, 1:] >= 0))
                    .sum(1) + (cells[:, 0] >= 0))
        return valid.sum(1), distinct

    vy, ty = axis(lat.ys, lat.h)
    vx, tx = axis(lat.xs, lat.w)
    vectors = c // 4
    corners = 4 * vy * vx * vectors
    fits = tx <= BWD_MAX_COLS
    flushes = torch.where(fits, ty * tx * vectors, corners)
    return {"corner_adds": int(corners.sum()), "flushes": int(flushes.sum()),
            "direct_share": float((~fits).float().mean())}


@contextlib.contextmanager
def recording_calls(module, name: str):
    """Every call of ``module.name`` while the block runs: (args, kwargs,
    result). The callers look the function up at call time."""
    calls, orig = [], getattr(module, name)

    def run(*args, **kwargs):
        out = orig(*args, **kwargs)
        calls.append((args, kwargs, out))
        return out

    setattr(module, name, run)
    try:
        yield calls
    finally:
        setattr(module, name, orig)


def kernel_args(module, name: str, fn) -> tuple:
    """The arguments with which ``fn()`` first calls ``module.name`` (a
    kernel wrapper that the dispatch imports at call time): to time the
    launch alone, without the torch work around it."""
    with recording_calls(module, name) as calls:
        fn()
    return calls[0][0]


def phase_timing(dev, pred, train: dict, card: str) -> dict:
    from tpuseg_torch.kernels import nms as nms_kernel
    from tpuseg_torch.kernels import roi_align as roi_kernel

    times = {}
    with torch.inference_mode():
        for label, boxes, scores, valid, classes, thr in nms_cases(dev):
            if label.startswith("dup"):
                continue
            iters = 20 if boxes.shape[1] <= 2048 else 5
            def nms():
                return run_nms(boxes, scores, valid, classes, thr)

            k, p = time_pair(nms, iters)
            args = kernel_args(nms_kernel, "nms_keep", nms)
            alone = cuda_time_ms(lambda: nms_kernel.nms_keep(*args), iters)
            times[f"nms B=2 {label}"] = (k, p) + nms_bound(
                boxes, scores, valid, classes, thr) + (None, alone)
        # the forward's shapes, then the training step's
        for n, pp in ((2000, 7), (200, 14)) + BWD_SHAPES:
            for dt in (torch.float32, torch.bfloat16):
                case = roi_case(dev, n, dt)

                def roi():
                    return run_roi(case, pp)

                k, p = time_pair(roi, iters=10)
                args = kernel_args(roi_kernel, "multilevel_roi_align", roi)
                alone = cuda_time_ms(
                    lambda: roi_kernel.multilevel_roi_align(*args), 10)
                size = torch.tensor([], dtype=dt).element_size()
                times[f"roi_align {str(dt)[6:]} N={n} P={pp}"] = (
                    (k, p) + roi_fwd_bound(case, pp, size) + (None, alone))
        for n, pp in BWD_SHAPES:
            for dt in (torch.float32, torch.bfloat16):
                case = bwd_case(dev, n, pp, dt)

                def bwd():
                    return run_bwd(case, pp, dt)

                k, p = time_pair(bwd, iters=10)
                args = kernel_args(roi_kernel, "multilevel_roi_align_backward",
                                   bwd)
                alone = cuda_time_ms(
                    lambda: roi_kernel.multilevel_roi_align_backward(*args),
                    10)
                size = torch.tensor([], dtype=dt).element_size()
                name = f"roi_align_bwd {str(dt)[6:]} N={n} P={pp}"
                times[name] = ((k, p) + roi_bwd_bound(n, pp, size)
                               + (None, alone))
                # the launch alone with every roi adding directly (the
                # first design): whether merging in shared memory pays
                times[name + " direct"] = cuda_time_ms(
                    lambda: roi_kernel.multilevel_roi_align_backward(
                        *args, False), 10)
                # the wrapper's zero-filled f32 buffer alone, in both
                times[name + " zero-fill"] = cuda_time_ms(
                    lambda: torch.zeros(pyramid_bytes(4) // 4, device=dev),
                    10)
                if dt == torch.float32:
                    times[name + " merge"] = bwd_merge_counts(*case[1:4], pp)
        landscape, _ = synthetic_images(SEED)
        for b in (1, 2):
            images, image_hw = canvas_batch(pred, landscape[:b])
            k, p = time_pair(
                lambda: M.forward_inference(pred.model, images, image_hw),
                iters=5)
            times[f"forward B={b} 800x1344"] = (k, p)
    for name, t in times.items():
        if name.endswith(" direct"):
            log(f"[12 timing] {name[:-7]}, direct adds only: kernel "
                f"{t:.4f} ms, the launch alone; merging "
                f"{times[name[:-7]][5]:.4f} ms [{card}]")
        elif name.endswith(" zero-fill"):
            log(f"[12 timing] {name[:-10]}, the zero-filled f32 buffer "
                f"alone: kernel {t:.4f} ms [{card}]")
        elif name.endswith(" merge"):
            log(f"[12 merge] {name[:-6]}: {t['flushes']} vector reductions "
                f"merged against {t['corner_adds']} direct "
                f"({t['flushes'] / t['corner_adds']:.3f}); "
                f"{100 * t['direct_share']:.1f} % of the rois add directly")
        elif name.startswith("forward"):
            b = int(name.split("B=")[1][0])
            log(f"[12 timing] {name}: kernels {1e3 * b / t[0]:.2f} img/s "
                f"({t[0]:.3f} ms), plain {1e3 * b / t[1]:.2f} img/s "
                f"({t[1]:.3f} ms) [{card}]")
        else:
            alone = (f" (the kernel launch alone {t[5]:.4f} ms)"
                     if len(t) > 5 else "")
            log(f"[12 timing] {name}: kernel {t[0]:.4f} ms{alone}, plain "
                f"{t[1]:.4f} ms, bound {t[2]:.4g} ms by {t[3]} [{card}]")

    times["train step B=2 800x1344"] = time_train_step(
        train["model"], train["batch"], "[12 timing] train step", card)
    return times


def time_train_step(model, batch, label: str, card: str,
                    compute_dtype=None) -> tuple:
    """The training step (forward, backward, SGD) at B = 2 with TF32
    convolutions as do_train runs them, in ``compute_dtype``'s mixed
    precision if one is given: kernels, plain once, kernels -> (kernels
    ms, plain ms)."""
    opt = make_optimizer(model, 0.0025)
    gen = torch.Generator(device=batch[0].device).manual_seed(SEED)

    def step():
        TL.train_step(model, opt, 0.0025 / 3, *batch, gen, compute_dtype)

    k1 = cuda_time_ms(step, iters=5, warmup=2)
    with kernels.force_plain():
        p = cuda_time_ms(step, iters=1, warmup=0)
    k2 = cuda_time_ms(step, iters=5, warmup=0)
    k = (k1 + k2) / 2
    log(f"{label} B=2 {CANVAS[0]}x{CANVAS[1]}: kernels {k:.3f} ms "
        f"({1e3 / k:.3f} it/s; two runs of 5: {k1:.3f}, {k2:.3f}), plain "
        f"{p:.3f} ms ({1e3 / p:.3f} it/s, one step) [{card}]")
    return k, p


def dcn_touched_cells(sy, sx, h: int, w: int) -> int:
    """Distinct (image, y, x) cells that the samples give a non-zero
    bilinear weight: the feature cells the function needs."""
    b = sy.shape[0]
    y0, x0 = torch.floor(sy), torch.floor(sx)
    ly, lx = sy - y0, sx - x0
    base = (torch.arange(b, device=sy.device) * (h * w))[:, None]
    cells = []
    for yc, wy in ((y0, 1.0 - ly), (y0 + 1, ly)):
        for xc, wx in ((x0, 1.0 - lx), (x0 + 1, lx)):
            ok = ((yc >= 0) & (yc <= h - 1) & (xc >= 0) & (xc <= w - 1)
                  & (wy * wx != 0))
            cells.append(base.expand_as(yc)[ok] + (yc * w + xc)[ok].long())
    return int(torch.unique(torch.cat(cells)).numel())


def dcn_bound(feats, sy, sx) -> tuple:
    """The touched cells' C channels read, sy/sx/m read, [B, S, C] written;
    DCN_OPS_PER_VALUE f32 operations per output value."""
    b, c, h, w = feats.shape
    s, item = sy.shape[1], feats.element_size()
    nbytes = (dcn_touched_cells(sy, sx, h, w) * c * item + b * s * 3 * 4
              + b * s * c * item)
    return bound(nbytes, DCN_OPS_PER_VALUE * b * s * c)


def time_yolact(dev, yolact: dict, card: str) -> dict:
    """dcn_sample against its plain version, its bound and grid_sample at
    each DCN geometry (B = 8, f32 and bf16); the YOLACT++ forward and
    run_batch (preprocess, forward, detect) at B = 1 and 8, f32 and bf16,
    kernels against plain."""
    times = {}
    with torch.inference_mode():
        for h, w, c, st in DCN_SHAPES + (DCN_RAGGED,):
            for dt in (torch.float32, torch.bfloat16):
                feats, sy, sx, m = dcn_case(dev, h, w, c, st, dt)
                k, p = time_pair(
                    lambda: sampling.sample_points(feats, sy, sx, m),
                    iters=10)
                lib = cuda_time_ms(
                    lambda: grid_sample_points(feats, sy, sx, m), iters=10)
                name = (f"dcn_sample {str(dt)[6:]} B={DCN_BATCH} "
                        f"{h}x{w}x{c} s{st}")
                times[name] = (k, p) + dcn_bound(feats, sy, sx) + (lib,)
                log(f"[12 timing] {name}: kernel {k:.4f} ms, plain {p:.4f} "
                    f"ms, bound {times[name][2]:.4g} ms by "
                    f"{times[name][3]}, grid_sample {lib:.4f} ms [{card}]")
        images = torch.from_numpy(yolact["images"]).to(dev)
        for dt, pred in yolact["preds"].items():
            for b in (1, 8):
                x = yolact_preprocess(images[:b], pred.cfg.img_size).to(dt)
                for label, fn in (("forward", lambda: pred.model(x)),
                                  ("run_batch", lambda: pred.run_batch(
                                      images[:b]))):
                    k, p = time_pair(fn, iters=5)
                    name = f"yolact {label} {str(dt)[6:]} B={b}"
                    times[name] = (k, p)
                    log(f"[12 timing] YOLACT++ {label} {str(dt)[6:]} B={b} "
                        f"{images.shape[1]}x{images.shape[2]}: kernels "
                        f"{1e3 * b / k:.2f} img/s ({k:.3f} "
                        f"ms), plain {1e3 * b / p:.2f} img/s ({p:.3f} ms) "
                        f"[{card}]")
    return times


def grid_sample_backward(feats, sy, sx, m, grad):
    """The sampler's backward as PyTorch's: grid_sample's backward
    (align_corners=True, zeros) for the features and the grid, through the
    modulation's product; a closure to time (the graph is kept)."""
    f = feats.detach().requires_grad_()
    h, w = feats.shape[2:]
    grid = torch.stack([2.0 * sx / (w - 1) - 1.0, 2.0 * sy / (h - 1) - 1.0],
                       -1)[:, :, None, :].requires_grad_()
    mm = m.detach().requires_grad_()
    out = F.grid_sample(f, grid.to(feats.dtype), mode="bilinear",
                        padding_mode="zeros", align_corners=True)
    out = out[..., 0].transpose(1, 2) * mm[..., None].to(feats.dtype)
    return lambda: torch.autograd.grad(out, (f, grid, mm), grad,
                                       retain_graph=True)


def dcn_bwd_bound(feats, sy, sx) -> tuple:
    """The [B, S, C] gradient, the touched cells' C channels and sy/sx/m
    read; d feats [B, C, H, W] (every cell) and d sy/d sx/d m written;
    DCN_BWD_OPS_PER_VALUE f32 operations per sample and channel."""
    b, c, h, w = feats.shape
    s, item = sy.shape[1], feats.element_size()
    nbytes = (b * s * c * item + dcn_touched_cells(sy, sx, h, w) * c * item
              + b * s * 3 * 4 + b * h * w * c * item + b * s * 3 * 4)
    return bound(nbytes, DCN_BWD_OPS_PER_VALUE * b * s * c)


def time_yolact_train(dev, yt: dict, card: str) -> dict:
    """dcn_sample_bwd against its plain version, its bound and
    grid_sample's backward at each DCN geometry (B = 8, f32 and bf16); the
    host's time to build one B = 8 batch; the YOLACT++ training step at
    B = 8 (forward, backward, SGD; TF32 convolutions as train() runs it),
    kernels against plain."""
    from tpuseg_torch.kernels import dcn as dcn_kernel

    times = {}
    for h, w, c, st in DCN_SHAPES:
        for dt in (torch.float32, torch.bfloat16):
            feats, sy, sx, m = dcn_case(dev, h, w, c, st, dt)
            grad = dcn_grad(dev, feats, sy)

            def bwd():
                return run_dcn_bwd(grad, feats, sy, sx, m)

            k, p = time_pair(bwd, iters=10)
            args = kernel_args(dcn_kernel, "sample_points_backward", bwd)
            alone = cuda_time_ms(
                lambda: dcn_kernel.sample_points_backward(*args), 10)
            lib = cuda_time_ms(grid_sample_backward(feats, sy, sx, m, grad),
                               iters=10)
            name = (f"dcn_sample_bwd {str(dt)[6:]} B={DCN_BATCH} "
                    f"{h}x{w}x{c} s{st}")
            times[name] = ((k, p) + dcn_bwd_bound(feats, sy, sx)
                           + (lib, alone))
            log(f"[12 timing] {name}: kernel {k:.4f} ms (the kernel launch "
                f"alone {alone:.4f} ms), plain {p:.4f} ms, bound "
                f"{times[name][2]:.4g} ms by {times[name][3]}, grid_sample "
                f"backward {lib:.4f} ms [{card}]")
            if (h, w, c, st) == (69, 69, 128, 1):
                # the launch alone with d feats only (the scattered adds
                # and the gradient's reads) and with the coordinates only
                # (the gradient's and the corners' reads, no adds): which
                # of the two sets the pace
                split = {}
                for part, flags in (("d feats only", (True, False)),
                                    ("coordinates only", (False, True))):
                    split[part] = cuda_time_ms(
                        lambda: dcn_kernel.sample_points_backward(
                            *args[:5], *flags), 10)
                    log(f"[12 timing] {name}, {part}: kernel "
                        f"{split[part]:.4f} ms, the launch alone; both "
                        f"{alone:.4f} ms [{card}]")
                times[name + " split"] = split
    cfg, data = yt["cfg"], yt["data"]
    batches = YTL.batch_iterator(data, cfg, np.random.default_rng(SEED + 14),
                                 YOLACT_BATCH)
    t0 = time.perf_counter()
    for _ in range(3):
        YTL.batch_to_device(*next(batches), dev)
    torch.cuda.synchronize()
    host = (time.perf_counter() - t0) / 3 * 1e3
    times[f"yolact host batch B={YOLACT_BATCH}"] = (host,)
    log(f"[12 timing] YOLACT++ host batch (augment + targets + upload) "
        f"B={YOLACT_BATCH}: {host:.1f} ms on the host clock, mean of 3")
    model = yt["model"]
    opt = make_yolact_optimizer(model)
    lr = yolact_lr_schedule()(0)
    images, targets = yt["batch"]

    def step():
        YTL.train_step(model, opt, lr, images, targets, yt["priors"],
                       yt["draws"], yt["loss_cfg"])

    k1 = cuda_time_ms(step, iters=5, warmup=2)
    with kernels.force_plain():
        p = cuda_time_ms(step, iters=2, warmup=1)
    k2 = cuda_time_ms(step, iters=5, warmup=0)
    k = (k1 + k2) / 2
    times[f"yolact train step B={YOLACT_BATCH}"] = (k, p)
    log(f"[12 timing] YOLACT++ train step B={YOLACT_BATCH} "
        f"{cfg.img_size}x{cfg.img_size}: kernels {k:.3f} ms "
        f"({1e3 * YOLACT_BATCH / k:.2f} img/s; two runs of 5: {k1:.3f}, "
        f"{k2:.3f}), plain {p:.3f} ms ({1e3 * YOLACT_BATCH / p:.2f} img/s, "
        f"mean of 2) [{card}]")
    return times


# ---------------------------------------------------------------------------
# phase 13: the COCO data path
# ---------------------------------------------------------------------------

COCO_IMAGES = 16  # alternately landscape 640x480 and portrait 480x640
COCO_OBJECTS = 10  # polygon objects an image, plus one crowd region
COCO_BATCH = 2  # evaluate_coco's batch (each orientation bucket fills)
CLI_TRAIN_STEPS = 5  # the first interval is warm-up; s/it is the median


def write_coco_dataset(root: Path, seed: int) -> tuple:
    """A COCO dataset on disk: COCO_IMAGES PNG images of textured_image
    with COCO_OBJECTS elliptic polygon objects painted in, and an instances
    json with those polygons (category ids drawn from COCO's 91-id space)
    and one uncompressed-RLE crowd rectangle an image -> (image dir, json
    path, {image id: the written RGB pixels})."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    img_dir = root / "images"
    img_dir.mkdir(parents=True)
    images, anns, pixels = [], [], {}
    t = np.linspace(0, 2 * np.pi, 16, endpoint=False)
    for i in range(1, COCO_IMAGES + 1):
        h, w = (480, 640) if i % 2 else (640, 480)
        img = textured_image(rng, h, w)
        for _ in range(COCO_OBJECTS):
            bw, bh = rng.uniform(0.05, 0.4, 2) * [w, h]
            x, y = rng.uniform(0, 1, 2) * ([w, h] - np.asarray([bw, bh]))
            poly = np.stack([x + bw / 2 * (1 + np.cos(t)),
                             y + bh / 2 * (1 + np.sin(t))], 1).round(2)
            m = rle.decode(rle.poly_to_rle(poly.reshape(-1), h, w)) > 0
            img[m] = rng.integers(0, 256, 3)
            lo, hi = poly.min(0), poly.max(0)
            anns.append({"id": len(anns) + 1, "image_id": i,
                         "category_id": int(rng.choice(COCO_CATEGORY_IDS)),
                         "bbox": [float(lo[0]), float(lo[1]),
                                  float(hi[0] - lo[0]), float(hi[1] - lo[1])],
                         "area": float(m.sum()), "iscrowd": 0,
                         "segmentation": [poly.reshape(-1).tolist()]})
        cw, ch = (int(v) for v in rng.integers(40, 120, 2))
        cx, cy = int(rng.integers(0, w - cw)), int(rng.integers(0, h - ch))
        crowd = np.zeros((h, w), np.uint8)
        crowd[cy:cy + ch, cx:cx + cw] = 1
        anns.append({"id": len(anns) + 1, "image_id": i,
                     "category_id": int(rng.choice(COCO_CATEGORY_IDS)),
                     "bbox": [float(cx), float(cy), float(cw), float(ch)],
                     "area": float(cw * ch), "iscrowd": 1, "segmentation": {
                         "size": [h, w],
                         "counts": rle.encode_counts(crowd).tolist()}})
        Image.fromarray(img).save(img_dir / f"{i:012d}.png")
        images.append({"id": i, "height": h, "width": w,
                       "file_name": f"{i:012d}.png"})
        pixels[i] = img
    ann = root / "instances.json"
    ann.write_text(json.dumps({
        "images": images, "annotations": anns,
        "categories": [{"id": c, "name": f"c{c}"}
                       for c in COCO_CATEGORY_IDS]}))
    return str(img_dir), str(ann), pixels


@contextlib.contextmanager
def quiet():
    """The engines' and CLIs' console tables into a buffer, kept out of the
    smoke's output."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        yield buf


@contextlib.contextmanager
def clocked(owner, names: tuple):
    """Wrap ``owner``'s methods ``names`` to add their seconds to the
    yielded list's one element."""
    acc = [0.0]
    orig = {n: getattr(owner, n) for n in names}

    def wrap(fn):
        def run(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                acc[0] += time.perf_counter() - t0
        return run

    for n in names:
        setattr(owner, n, wrap(orig[n]))
    try:
        yield acc
    finally:
        for n in names:
            setattr(owner, n, orig[n])


@contextlib.contextmanager
def step_starts(module):
    """The host clock at the start of each ``module.train_step`` call: one
    iteration, host included, is the interval between two."""
    starts = []
    orig = module.train_step

    def timed(*args, **kwargs):
        starts.append(time.perf_counter())
        return orig(*args, **kwargs)

    module.train_step = timed
    try:
        yield starts
    finally:
        module.train_step = orig


class RecordingPredictor:
    """A Mask R-CNN predictor's calls passed through, its detections kept."""

    def __init__(self, pred: MaskRCNNPredictor):
        self.pred, self.results = pred, []

    def run_on_bgr_image(self, img):
        return self.run_on_bgr_images([img])[0]

    def run_on_bgr_images(self, imgs):
        out = self.pred.run_on_bgr_images(imgs)
        self.results += out
        return out


def require_same_detections(got: list, want: list, what: str) -> None:
    """Two runs' per-image detections must be equal bit for bit; raises
    with the largest difference of each field otherwise."""
    if [len(r["scores"]) for r in got] != [len(r["scores"]) for r in want]:
        raise AssertionError(f"{what}: kernels vs plain give other "
                             "per-image detection counts")
    err = {k: max((float(np.abs(g[k].astype(np.float64) - w[k]).max())
                   for g, w in zip(got, want) if len(g[k])), default=0.0)
           for k in ("boxes", "scores", "classes", "masks")}
    if any(err.values()):
        raise AssertionError(
            f"{what}: kernels vs plain detections differ, largest " + ", ".join(
                f"{k} {v:.3g}" for k, v in err.items()))


def shares(parts: dict, wall: float) -> str:
    """'name x.xx s' for each part, then the rest of ``wall``."""
    rest = wall - sum(parts.values())
    return ", ".join(f"{k} {v:.2f} s" for k, v in parts.items()) + (
        f", the rest {rest:.2f} s")


def agree(got: dict, want: dict, n_got: int, n_want: int, what: str) -> str:
    """Two runs' metrics (name -> number or array): equal, or every one
    within 1e-3 with equal detection counts; raises otherwise."""
    if got.keys() != want.keys() or n_got != n_want:
        raise AssertionError(f"{what}: kernels vs plain give {n_got} vs "
                             f"{n_want} detections")
    diff = max(float(np.max(np.abs(np.asarray(got[k], np.float64)
                                   - np.asarray(want[k], np.float64))))
               for k in want)
    if diff > 1e-3:
        raise AssertionError(f"{what}: kernels vs plain differ by {diff:.3g}")
    return ("equal" if diff == 0 else f"within {diff:.3g}") + (
        f", {n_got} detections on both paths")


def phase_coco_data(dev, tmp: Path, card: str) -> dict:
    """The reader (every target, masks included; the ground truth scored
    against itself), the decode at the images' own size, and the
    prefetcher's uploads."""
    img_dir, ann, pixels = write_coco_dataset(tmp / "coco", SEED + 20)
    ds = CocoDetectionDataset(img_dir, ann)
    t0 = time.perf_counter()
    targets = {i: ds.load_target(i) for i in ds.image_ids}
    reader_ms = (time.perf_counter() - t0) * 1e3 / len(targets)
    for i, t in targets.items():
        h, w = pixels[i].shape[:2]
        if (t["masks"].shape != (COCO_OBJECTS + 1, h, w)
                or int(t["iscrowd"].sum()) != 1 or not (
                    t["masks"].sum((1, 2)) > 0).all()):
            raise AssertionError(f"image {i}: targets {t['masks'].shape}")
    gt_ap = {}
    for iou_type in ("bbox", "segm"):
        res = [{"image_id": a["image_id"], "category_id": a["category_id"],
                "score": 1.0, **({"bbox": a["bbox"]} if iou_type == "bbox"
                                 else {"segmentation": ds.coco.annToRLE(a)})}
               for a in ds.coco.dataset["annotations"] if not a["iscrowd"]]
        E = COCOeval(ds.coco, ds.coco.loadRes(res), iou_type)
        with quiet():
            E.evaluate()
            E.accumulate()
            E.summarize()
        if E.stats[0] != 1.0 or E.stats[1] != 1.0:
            raise AssertionError(f"gt against itself, {iou_type}: "
                                 f"{E.stats}")
        gt_ap[iou_type] = float(E.stats[0])
    log(f"[13 coco] reader: {len(targets)} images, "
        f"{sum(len(t['classes']) for t in targets.values())} targets with "
        f"masks (a crowd each); the ground truth against itself, crowds left "
        f"out: bbox AP {gt_ap['bbox']}, segm AP {gt_ap['segm']}")

    loader = NativeImageLoader()
    for hw in ((480, 640), (640, 480)):
        ids = [i for i in ds.image_ids if pixels[i].shape[:2] == hw]
        out, got_hw = loader.load_batch([ds.image_path(i) for i in ids], *hw)
        if not all(np.array_equal(out[j], pixels[i])
                   for j, i in enumerate(ids)) or (got_hw != hw).any():
            raise AssertionError(f"decode at {hw}: pixels differ")
    paths = [ds.image_path(i) for i in ds.image_ids[:YOLACT_BATCH]]
    loader.load_batch(paths, 550, 550)
    t0 = time.perf_counter()
    for _ in range(3):
        loader.load_batch(paths, 550, 550)
    decode_ms = (time.perf_counter() - t0) / 3 * 1e3
    decoder = "native (libjpeg/libpng)" if loader.is_native else (
        "PIL (the native loader does not build here)")
    log(f"[13 coco] decode through {decoder}: all {len(ds)} images at "
        f"their own size equal the written PNG pixels")

    cfg = yolact_model_config("yolact_plus_resnet50")
    batches = YTL.batch_iterator(ds, cfg, np.random.default_rng(SEED + 21),
                                 YOLACT_BATCH)
    host = [next(batches) for _ in range(len(ds) // YOLACT_BATCH)]
    n = 0
    for i, (images, tgts) in enumerate(DevicePrefetcher(
            lambda i: host[i], len(host), device=dev)):
        pairs = [(images, host[i][0])] + [(tgts[k], host[i][1][k])
                                          for k in host[i][1]]
        for got, want in pairs:
            if got.device != dev or not torch.equal(
                    got.cpu(), torch.from_numpy(want)):
                raise AssertionError(f"prefetched batch {i} differs")
            n += 1
    log(f"[13 coco] DevicePrefetcher: {len(host)} YOLACT++ B = "
        f"{YOLACT_BATCH} batches ({n} tensors) on {dev}, equal to the host's "
        "bit for bit")
    log(f"[13 timing] reader load_target: {reader_ms:.2f} ms per image "
        f"(640x480, {COCO_OBJECTS} polygons and a crowd, masks included) "
        f"[{card}]")
    log(f"[13 timing] decode B={YOLACT_BATCH} to 550x550 through "
        f"{decoder}: {decode_ms:.1f} ms per batch, mean of 3 [{card}]")
    return {"ds": ds, "img_dir": img_dir, "ann": ann, "pixels": pixels,
            "times": {"reader ms per image": reader_ms,
                      "decode ms per batch": decode_ms}}


def phase_coco_maskrcnn(dev, data: dict, tmp: Path, card: str) -> dict:
    """evaluate_coco of MaskRCNNPredictor at 800/1333 over the dataset,
    through the kernels and the plain versions (exact_convs): stats equal.
    Then a run with the default convolutions, timed."""
    cfg = M.MaskRCNNConfig()
    ckpt = tmp / "e2e_mask_rcnn_R_50_FPN_synthetic.pth"
    torch.save({"model": synthetic_state_dict(M.build_model(cfg), SEED)}, ckpt)
    pred = MaskRCNNPredictor(cfg, weights=str(ckpt), device=dev)
    ds = data["ds"]
    runs = {}
    with exact_convs():
        for path, ctx in (("kernels", contextlib.nullcontext),
                          ("plain", kernels.force_plain)):
            recording = RecordingPredictor(pred)
            kernels.reset_launch_counts()
            with ctx(), quiet():
                stats = ME.evaluate_coco(recording, ds, batch_size=COCO_BATCH,
                                         progress=False)
            torch.cuda.synchronize()
            runs[path] = (stats, recording.results, kernels.launch_counts())
    (stats, dets, counts), (pstats, pdets, pcounts) = (runs["kernels"],
                                                       runs["plain"])
    forwards = len(ds) // COCO_BATCH
    want = {"nms": 6 * forwards, "roi_align": 2 * forwards,
            "roi_align_bwd": 0, "dcn_sample": 0, "dcn_sample_bwd": 0,
            "mask_paste": 0, "canvas": forwards}
    if counts != want or any(pcounts.values()):
        raise AssertionError(f"evaluate_coco launched {counts} (plain "
                             f"{pcounts}); want {want}")
    if stats.keys() != {"bbox", "segm"} or not all(
            s.shape == (12,) and np.isfinite(s).all()
            for s in stats.values()):
        raise AssertionError(f"evaluate_coco stats {stats}")
    verdict = agree(stats, pstats, *(sum(len(r["scores"]) for r in d)
                                     for d in (dets, pdets)), "evaluate_coco")
    require_same_detections(dets, pdets, "evaluate_coco")
    with clocked(COCOeval, ("evaluate", "accumulate", "summarize")) as ev, \
            clocked(COCO, ("loadRes",)) as lr, \
            clocked(MaskRCNNPredictor, ("run_on_bgr_images",)) as fwd, \
            clocked(rle, ("encode",)) as enc, \
            clocked(CocoDetectionDataset, ("load_image",)) as load, quiet():
        t0 = time.perf_counter()
        ME.evaluate_coco(pred, ds, batch_size=COCO_BATCH, progress=False)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    split = shares({"decode": load[0], "predictor (preprocess, forward, "
                    "paste, copy back)": fwd[0], "RLE encode": enc[0],
                    "COCOeval": ev[0] + lr[0]}, wall)
    log(f"[13 coco] evaluate_coco, MaskRCNNPredictor R-50-FPN at "
        f"{pred.min_image_size}/{pred.max_image_size}, "
        f"B = {COCO_BATCH} by orientation, {len(ds)} images, kernels vs "
        f"plain (TF32 off, deterministic cuDNN): bbox and segm stats "
        f"{verdict}; the detections (boxes, scores, classes, masks) equal bit "
        f"for bit; launches {counts} (6 NMS + 2 "
        f"RoIAlign per forward); "
        f"bbox AP {stats['bbox'][0]:.4f}, segm AP {stats['segm'][0]:.4f}")
    log(f"[13 timing] evaluate_coco {len(ds)} images 640x480 at "
        f"{pred.min_image_size}/{pred.max_image_size}, B={COCO_BATCH}, "
        f"kernels, TF32 convs: {len(ds) / wall:.2f} img/s "
        f"end to end ({wall:.2f} s): {split} (COCOeval: loadRes, evaluate, "
        f"accumulate, summarize; bbox and segm) [{card}]")
    return {"ckpt": str(ckpt), "counts": counts,
            "times": {"evaluate_coco img/s": len(ds) / wall,
                      "cocoeval s": ev[0] + lr[0]}}


def phase_coco_yolact(dev, data: dict, tmp: Path, card: str) -> dict:
    """evaluate_dataset of YolactPredictor (yolact_plus_resnet50 at 550,
    f32, B = 8) over the dataset with the COCO json dumps, through the
    kernels and the plain versions (exact_convs): maps and jsons equal.
    Then eval.py's mAP mode with the default convolutions, timed."""
    name = "yolact_plus_resnet50"
    cfg = yolact_model_config(name)
    model = YM.build_model(cfg)
    model.load_state_dict(synthetic_yolact_state_dict(model, SEED),
                          strict=True)
    model = model.to(dev)
    ds = data["ds"]
    images = np.stack([resize_bilinear_u8(data["pixels"][i], cfg.img_size,
                                          cfg.img_size)
                       for i in ds.image_ids])
    shift = calibrate_yolact_gate(
        model, yolact_preprocess(torch.from_numpy(images).to(dev),
                                 cfg.img_size), want=(10, 500), margin=0.0)
    ckpt = tmp / f"{name}_synthetic.pth"
    torch.save({k: v.cpu() for k, v in model.state_dict().items()}, ckpt)
    del model
    pred = YolactPredictor(cfg, weights=str(ckpt), batch_size=YOLACT_BATCH,
                           device=dev)
    runs = {}
    with exact_convs():
        for path, ctx in (("kernels", contextlib.nullcontext),
                          ("plain", kernels.force_plain)):
            prefix = tmp / f"{path}" / "yolact"
            kernels.reset_launch_counts()
            with ctx(), quiet():
                maps = YE.evaluate_dataset(pred, ds, progress=False,
                                           output_coco_json=str(prefix))
            torch.cuda.synchronize()
            dumps = {kind: Path(f"{prefix}_{kind}.json").read_text()
                     for kind in ("bbox", "mask")}
            runs[path] = (maps, dumps, kernels.launch_counts())
    (maps, dumps, counts), (pmaps, pdumps, pcounts) = (runs["kernels"],
                                                       runs["plain"])
    forwards = -(-len(ds) // YOLACT_BATCH)
    want = {"nms": 0, "roi_align": 0, "roi_align_bwd": 0,
            "dcn_sample": sum(DCN_PER_FORWARD) * forwards,
            "dcn_sample_bwd": 0,
            "mask_paste": 0, "canvas": 0}
    if counts != want or any(pcounts.values()):
        raise AssertionError(f"evaluate_dataset launched {counts} (plain "
                             f"{pcounts}); want {want}")
    n, pn = (len(json.loads(d["bbox"])) for d in (dumps, pdumps))
    flat = {f"{t} {k}": v for t in maps for k, v in maps[t].items()}
    pflat = {f"{t} {k}": v for t in pmaps for k, v in pmaps[t].items()}
    verdict = agree(flat, pflat, n, pn, "evaluate_dataset")
    for kind in dumps:
        if dumps[kind] != pdumps[kind]:  # boxes, RLEs, classes and scores
            raise AssertionError(f"evaluate_dataset: the {kind} json dumps "
                                 "of kernels and plain differ")
    if not np.isfinite(list(flat.values())).all() or n == 0:
        raise AssertionError(f"evaluate_dataset: maps {maps}, {n} detections")
    with clocked(YolactPredictor, ("postprocess_image",)) as post, \
            clocked(yolact_map, ("prep_metrics",)) as prep, \
            clocked(CocoDetectionDataset, ("load_target",)) as tgt, quiet():
        t0 = time.perf_counter()
        YE.evaluate_dataset(pred, ds, progress=False)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    split = shares({"postprocess_image (masks upsampled on the host)":
                    post[0], "load_target": tgt[0],
                    "prep_metrics": prep[0]}, wall)
    log(f"[13 coco] evaluate_dataset, YolactPredictor {name} at "
        f"{cfg.img_size} f32, B = {YOLACT_BATCH} (background logit "
        f"+{shift:.2f}), {len(ds)} images, kernels vs plain (TF32 off, "
        f"deterministic cuDNN): all_maps {verdict}; the two COCO jsons "
        f"equal byte for byte; launches {counts} ({sum(DCN_PER_FORWARD)} DCN "
        f"samplings per forward); box mAP {maps['box']['all']:.4f}, mask "
        f"mAP {maps['mask']['all']:.4f}")
    log(f"[13 timing] evaluate_dataset {len(ds)} images 640x480, {name} "
        f"{cfg.img_size} f32 B={YOLACT_BATCH}, TF32 convs (decode, forward, "
        f"postprocess, mAP): {len(ds) / wall:.2f} img/s end to end "
        f"({wall:.2f} s): {split} (forward, copy back, the decode's wait, "
        f"calc_map) [{card}]")
    return {"ckpt": str(ckpt), "counts": counts,
            "times": {"evaluate_dataset img/s": len(ds) / wall}}


def phase_clis(dev, data: dict, mrcnn: dict, yolact: dict, tmp: Path,
               card: str) -> dict:
    """The four CLIs through their main(), on the card (their default),
    over the dataset on disk and the checkpoints: test_net and yolact_eval
    on 8 images, train_net and yolact_train for CLI_TRAIN_STEPS steps.
    Launches counted for each; the training CLIs' losses finite; s/it,
    host included, is the median interval between two steps' starts after
    the first (the first holds the first step's warm-up; all are
    printed)."""
    from tpuseg_torch.tools import test_net, train_net, yolact_eval, yolact_train

    img_dir, ann = data["img_dir"], data["ann"]
    yaml = str(Path(__file__).resolve().parent / "configs"
               / "e2e_mask_rcnn_R_50_FPN_1x.yaml")
    # training starts from stable weights: phase 9's and phase 11's schemes
    cfg = M.MaskRCNNConfig()
    sd = synthetic_state_dict(M.build_model(cfg), SEED + 7)
    sd["backbone.body.stem.bn1.running_var"] *= PIXEL_VAR
    mrcnn_train = tmp / "e2e_mask_rcnn_R_50_FPN_train_init.pth"
    torch.save({"model": sd}, mrcnn_train)
    ycfg = yolact_model_config("yolact_plus_resnet50")
    model = YM.build_model(ycfg)
    yolact_train_init = tmp / "yolact_plus_resnet50_0_0.pth"
    torch.save(synthetic_yolact_state_dict(model, SEED + 11,
                                           offset_scale=TRAIN_OFFSET_SCALE),
               yolact_train_init)
    del model

    def run(main, argv, module=None):
        kernels.reset_launch_counts()
        with quiet() as out, (step_starts(module) if module
                              else contextlib.nullcontext([])) as starts:
            t0 = time.perf_counter()
            result = main(argv)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        return result, kernels.launch_counts(), wall, starts, out.getvalue()

    clis, runs = {}, {}
    argv = ["--config-file", yaml, "--images", img_dir, "--annotations", ann,
            "--max_images", "8", "--batch_size", "4", "MODEL.WEIGHT",
            mrcnn["ckpt"]]
    stats, counts, wall, _, _ = run(test_net.main, argv)
    runs["test_net"] = (argv, stats)
    want = {"nms": 12, "roi_align": 4, "roi_align_bwd": 0, "dcn_sample": 0,
            "dcn_sample_bwd": 0,
            "mask_paste": 0, "canvas": 2}
    if counts != want or not all(np.isfinite(s).all() and s.shape == (12,)
                                 for s in stats.values()):
        raise AssertionError(f"test_net launched {counts}, want {want}; "
                             f"stats {stats}")
    clis["test_net"] = counts
    log(f"[13 cli] test_net --config-file {Path(yaml).name} --max_images 8 "
        f"--batch_size 4: launches {counts} (2 forwards), bbox AP "
        f"{stats['bbox'][0]:.4f}, segm AP {stats['segm'][0]:.4f}, "
        f"{wall:.1f} s")

    lines = []
    for name, main, argv, module, per_step in (
            ("train_net", train_net.main, [
                "--config-file", yaml, "--max_steps", str(CLI_TRAIN_STEPS),
                "SOLVER.IMS_PER_BATCH", "2", "SOLVER.BASE_LR", "0.0025",
                "SOLVER.CHECKPOINT_PERIOD", str(CLI_TRAIN_STEPS),
                "DATASETS.IMAGES", img_dir,
                "DATASETS.ANNOTATIONS", ann, "OUTPUT_DIR",
                str(tmp / "train_net"), "MODEL.WEIGHT", str(mrcnn_train)],
             TL, PER_STEP),
            ("yolact_train", yolact_train.main, [
                "--config", "yolact_plus_resnet50_config", "--train_images",
                img_dir, "--train_info", ann, "--batch_size",
                str(YOLACT_BATCH), "--max_steps", str(CLI_TRAIN_STEPS),
                "--resume", str(yolact_train_init), "--save_folder",
                str(tmp / "yolact_train"), "--save_interval",
                str(CLI_TRAIN_STEPS)],
             YTL, YOLACT_PER_STEP)):
        history, counts, wall, starts, out = run(main, argv, module)
        runs[name] = (argv, history)
        want = {k: CLI_TRAIN_STEPS * v for k, v in per_step.items()}
        if counts != want or len(history) != CLI_TRAIN_STEPS or not all(
                np.isfinite(v) for h in history for v in h.values()):
            raise AssertionError(f"{name} launched {counts}, want {want}; "
                                 f"losses {history}")
        clis[name] = counts
        gaps = np.diff(starts)
        lines.append((name, float(np.median(gaps[1:])), gaps))
        log(f"[13 cli] {name} {CLI_TRAIN_STEPS} steps: launches {counts}; total loss "
            f"{[round(h['total'], 4) for h in history]}; {wall:.1f} s in "
            f"main(); {out.strip().splitlines()[-1]}")

    argv = ["--trained_model", yolact["ckpt"], "--valid_images", img_dir,
            "--valid_info", ann, "--max_images", "8", "--batch_size",
            str(YOLACT_BATCH)]
    maps, counts, wall, _, _ = run(yolact_eval.main, argv)
    runs["yolact_eval"] = (argv, maps)
    want = {"nms": 0, "roi_align": 0, "roi_align_bwd": 0,
            "dcn_sample": sum(DCN_PER_FORWARD), "dcn_sample_bwd": 0,
            "mask_paste": 0, "canvas": 0}
    if counts != want or not np.isfinite(maps["mask"]["all"]):
        raise AssertionError(f"yolact_eval launched {counts}, want {want}; "
                             f"maps {maps}")
    clis["yolact_eval"] = counts
    log(f"[13 cli] yolact_eval --trained_model {Path(yolact['ckpt']).name} "
        f"(config from the file name) --max_images 8: launches {counts}; box "
        f"mAP {maps['box']['all']:.4f}, mask mAP {maps['mask']['all']:.4f}, "
        f"{wall:.1f} s")
    times = {}
    for name, s_it, gaps in lines:
        times[f"{name} s/it"] = s_it
        log(f"[13 timing] {name} CLI: {s_it:.3f} s/it, host included (the "
            f"median of the {len(gaps) - 1} intervals between steps' starts "
            f"after the first, which holds the first step's warm-up: step, "
            f"loss read, next batch built and uploaded; all intervals "
            f"{[round(float(g), 3) for g in gaps]}) [{card}]")
    return {"counts": clis, "times": times, "runs": runs}


# ---------------------------------------------------------------------------
# phase 14: the rest of the detectron family
# ---------------------------------------------------------------------------

FAMILY = {"c4": "e2e_mask_rcnn_R_50_C4_1x.yaml",
          "faster_rcnn": "e2e_faster_rcnn_R_50_FPN_1x.yaml",
          "retinanet": "retinanet_R_50_FPN_1x.yaml"}
FAMILY_CLI_STEPS = 3
# RetinaNet's class logits: at least this share of each level's (anchor,
# class) pairs passes the 0.05 gate, so every level fills its top 1000 and
# the final NMS sees thousands of candidates (the prior-prob bias alone
# passes none)
RETINA_PASS = 0.05
LOGIT_GATE = float(np.log(0.05 / 0.95))  # the logit of score 0.05
# class-box candidates an image into C4's final NMS (at most one a proposal
# once the class scores are peaked)
C4_MIN_CANDIDATES = 300


def per(counts: dict, times: int = 1) -> dict:
    """A launch count of every kernel: ``times`` x ``counts`` (0 if not
    named)."""
    return {k: times * counts.get(k, 0) for k in kernels.LAUNCHES}


def expected_launches(cfg) -> tuple:
    """The kernel launches of one predictor batch (its canvas and forward)
    and of one training step of a detectron model, as its code makes them
    (the phases confirm them): the batch's canvas, then FPN 6 NMS (5 RPN
    levels, the final NMS) and a RoIAlign per pooler, its backward in
    training; C4 its RPN's NMS and the final one (the pooler has no
    kernel); RetinaNet its final NMS, nothing in training (the training
    batch's canvas is the host's)."""
    poolers = 1 + getattr(cfg, "mask_on", False)
    fwd, step = {
        "fpn": ({"nms": 6, "roi_align": poolers},
                {"nms": 5, "roi_align": poolers, "roi_align_bwd": poolers}),
        "c4": ({"nms": 2}, {"nms": 1}),
        "retinanet": ({"nms": 1}, {}),
    }[ME.variant_of(cfg)]
    return per({**fwd, "canvas": 1}), per(step)


def family_node(name: str, weight: str = ""):
    """The model's yaml as the CLIs read it, with MODEL.WEIGHT ``weight``."""
    from tpuseg_torch.engine.config import ConfigNode

    node = ConfigNode({"MODEL": {"WEIGHT": ""},
                       "INPUT": {"MIN_SIZE_TEST": 800}})
    node.merge_from_file(str(Path(__file__).resolve().parent / "configs"
                             / FAMILY.get(name, name)))
    node.merge_from_list(["MODEL.WEIGHT", weight])
    return node


def with_shared_res5(sd: dict) -> dict:
    """A C4 state dict as upstream saves it with SHARE_BOX_FEATURE_EXTRACTOR:
    res5 under the mask head too."""
    box = "roi_heads.box.feature_extractor."
    mask = "roi_heads.mask.feature_extractor."
    return {**sd, **{mask + k[len(box):]: v.clone() for k, v in sd.items()
                     if k.startswith(box)}}


def calibrate_family(name: str, model, images, image_hw) -> str:
    """Class scores that give the final NMS real work: C4's cls_score
    weights scaled up until each image sends C4_MIN_CANDIDATES class-box
    candidates to it; RetinaNet's class-logit bias set so that RETINA_PASS
    of the (anchor, class) pairs of the level with the fewest high logits
    pass the 0.05 gate."""
    mod = ME.model_module(model.cfg)
    with torch.inference_mode():
        feats = model.backbone(images)
        if name == "retinanet":
            head = model.rpn.head
            head.cls_logits.bias.zero_()
            logits, _ = head(feats)
            q = min(float(lg.reshape(-1).float().kthvalue(
                int((1 - RETINA_PASS) * lg.numel())).values)
                for lg in logits)
            head.cls_logits.bias.fill_(LOGIT_GATE - q)
            n = mod.forward_heads(model, feats, image_hw, CANVAS)[
                "candidate_valid"].sum(1)
            return (f"class-logit bias {LOGIT_GATE - q:.4g}: "
                    f"{n.tolist()} valid NMS inputs an image")
        w = model.roi_heads.box.predictor.cls_score.weight
        base = w.clone()
        least = min(C4_MIN_CANDIDATES, model.cfg.rpn_post_nms_top_n)
        for m in (1, 2, 4, 8, 16, 32, 64, 128, 256, 512):
            w.copy_(base * m)
            n = mod.forward_heads(model, feats, image_hw, CANVAS)[
                "candidate_valid"].sum(1)
            if int(n.min()) >= least:
                return (f"cls_score weights x {m}: {n.tolist()} class-box "
                        "candidates an image")
    raise AssertionError(f"{name}: no cls_score scale gives {least} "
                         f"candidates ({n.tolist()})")


@contextlib.contextmanager
def recording_nms():
    """Each outermost call of the NMS entry points (nms_mask_batch,
    batched_nms_mask, batched_nms_mask_batch) while the block runs: (name,
    args, kwargs, keep). The models look them up in ops.nms at call time
    and pass ``valid`` by keyword."""
    names = ("nms_mask_batch", "batched_nms_mask", "batched_nms_mask_batch")
    orig = {n: getattr(nms_ops, n) for n in names}
    calls, depth = [], [0]

    def wrap(name):
        def run(*args, **kwargs):
            depth[0] += 1
            try:
                keep = orig[name](*args, **kwargs)
            finally:
                depth[0] -= 1
            if depth[0] == 0:
                calls.append((name, args, kwargs, keep))
            return keep
        return run

    for n in names:
        setattr(nms_ops, n, wrap(n))
    try:
        yield calls
    finally:
        for n in names:
            setattr(nms_ops, n, orig[n])


def nms_call_label(name: str, args: tuple, kwargs: dict) -> str:
    thr = args[2] if name == "nms_mask_batch" else args[3]
    b, n = args[1].shape
    return f"{name} B={b} N={n} thr={thr}"


def check_nms_calls(calls: list) -> str:
    """Each recorded call against the plain version on its own inputs: the
    keep masks equal bit for bit. -> 'label: kept/valid, ...' for each
    call shape, in the order of first call."""
    kept = {}
    for name, args, kwargs, keep in calls:
        with kernels.force_plain():
            want = getattr(nms_ops, name)(*args, **kwargs)
        label = nms_call_label(name, args, kwargs)
        if not torch.equal(keep, want):
            raise AssertionError(f"{label}: {int((keep != want).sum())} keep "
                                 "bits differ from the plain version")
        kept.setdefault(label, []).append(
            f"{int(keep.sum())}/{int(kwargs['valid'].sum())}")
    return "; ".join(f"{k}: {', '.join(v)}" for k, v in kept.items())


def family_state_dict(name: str, cfg, dev, train: bool) -> tuple:
    """Phase 14's synthetic upstream-keyed weights of a FAMILY model ->
    (state dict, how they were set). For inference, calibrated on the
    landscape images (calibrate_family; RetinaNet's class logits first
    given N(0, 1/fan) weights, so that the head's features spread them);
    for training, the stem's FrozenBN variance matched to the pixels (as
    phase 9) and RetinaNet's head at upstream's init: weights N(0, 0.01^2),
    biases 0, the class logits' bias at the prior (with the scheme's 3e-4
    class-logit weights, P6's and P7's gradients are too small to move
    their biases in f32)."""
    model = ME.build_model(cfg)
    sd = synthetic_state_dict(model, SEED + (27 if train else 21))
    if train:
        sd["backbone.body.stem.bn1.running_var"] *= PIXEL_VAR
        if name == "retinanet":
            g = torch.Generator().manual_seed(SEED + 31)
            for k, v in sd.items():
                if k.startswith("rpn.head."):
                    v.copy_(torch.randn(v.shape, generator=g) * 0.01
                            if k.endswith("weight") else torch.zeros_like(v))
            sd["rpn.head.cls_logits.bias"].fill_(RN.prior_bias(cfg))
        return sd, "training init"
    if name == "retinanet":
        w = sd["rpn.head.cls_logits.weight"]
        sd["rpn.head.cls_logits.weight"] = torch.from_numpy((
            np.random.default_rng(SEED + 23).standard_normal(w.shape)
            * np.prod(w.shape[1:]) ** -0.5).astype(np.float32))
    model.load_state_dict(sd, strict=True)
    model = model.to(dev)
    landscape, _ = synthetic_images(SEED)
    images, image_hw = canvas_batch(SimpleNamespace(device=dev), landscape)
    calib = calibrate_family(name, model, images, image_hw)
    return {k: v.cpu() for k, v in model.state_dict().items()}, calib


def family_inference(name: str, dev, tmp: Path) -> dict:
    """build_predictor_from_cfg on the yaml with synthetic upstream-keyed
    weights (C4's with the duplicate res5): launches per forward at B = 1
    and 2, sane detections, every NMS call of the path equal to its plain
    version, the heads through kernels vs plain on one feature map."""
    _, cfg = ME.model_config_from_node(family_node(name))
    mod = ME.model_module(cfg)
    sd, calib = family_state_dict(name, cfg, dev, train=False)
    landscape, _ = synthetic_images(SEED)
    if name == "c4":
        sd = with_shared_res5(sd)
    ckpt = tmp / f"synthetic_{FAMILY[name][:-5]}.pth"
    torch.save({"model": sd}, ckpt)
    pred = ME.build_predictor_from_cfg(family_node(name, str(ckpt)),
                                       device=dev)

    counts, dets = {}, []
    with recording_nms() as calls:
        for b in (1, 2):
            kernels.reset_launch_counts()
            res = pred.run_on_bgr_images(landscape[:b])
            torch.cuda.synchronize()
            counts[b] = kernels.launch_counts()
            dets += [check_result(r, *img.shape[:2], masks=name == "c4")
                     for r, img in zip(res, landscape)]
    want = expected_launches(cfg)[0]
    if counts[1] != want or counts[2] != want:
        raise AssertionError(f"{name}: launches {counts} per forward at "
                             f"B = 1 and 2; want {want}")
    if min(dets) == 0:
        raise AssertionError(f"{name}: no detections: {dets}")
    log(f"[14 {name}] build_predictor_from_cfg({FAMILY[name]}), "
        f"{calib}; launches {want} per forward at B = 1 and 2; detections "
        f"{dets}; its NMS calls (kept/valid) equal the plain version bit for "
        f"bit: {check_nms_calls(calls)}")

    images, image_hw = canvas_batch(pred, landscape)
    with exact_convs(), torch.inference_mode():
        feats = pred.model.backbone(images)
        got = mod.forward_heads(pred.model, feats, image_hw, CANVAS)
        with kernels.force_plain():
            ref = mod.forward_heads(pred.model, feats, image_hw, CANVAS)
        torch.cuda.synchronize()
    log(f"[14 {name}] heads kernels vs plain (TF32 off): "
        f"{compare_heads(got, ref)}; valid final-NMS inputs "
        f"{got['candidate_valid'].sum(1).tolist()} of "
        f"{got['candidate_valid'].shape[1]}")
    return {"pred": pred, "ckpt": str(ckpt), "counts": counts[2],
            "calls": calls}


def family_train(name: str, dev, tmp: Path) -> dict:
    """do_train for TRAIN_STEPS iterations at B = 2 on the 800x1344
    canvas: launches per step, finite losses, the
    frozen stages still and the rest moved, the checkpoint loads; every NMS
    call of the path equal to its plain version; one step kernels vs plain
    (TF32 off) as phase 9."""
    _, cfg = ME.model_config_from_node(family_node(name))
    model = ME.build_model(cfg)
    sd, _ = family_state_dict(name, cfg, dev, train=True)
    model.load_state_dict(sd, strict=True)
    init = tmp / f"{name}_train_init.pth"
    torch.save({"model": sd}, init)
    data = SyntheticDataset(SEED + 7)
    model = model.to(dev)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    kernels.reset_launch_counts()
    with recording_nms() as calls, quiet():
        model, it, history = TL.do_train(
            data, cfg, model=model, max_steps=TRAIN_STEPS, ims_per_batch=2,
            checkpoint_period=TRAIN_STEPS, log_every=TRAIN_STEPS,
            output_dir=str(tmp / name), device=dev)
        torch.cuda.synchronize()
    counts = kernels.launch_counts()
    step_want = expected_launches(cfg)[1]
    want = {k: TRAIN_STEPS * v for k, v in step_want.items()}
    if it != TRAIN_STEPS or counts != want:
        raise AssertionError(f"{name}: {it} iterations launched {counts}; "
                             f"want {want}")
    if not all(np.isfinite(v) for h in history for v in h.values()):
        raise AssertionError(f"{name}: losses not finite: {history}")
    frozen, trainable = check_moved(model, before, name)
    fresh = ME.build_model(cfg)
    fresh.load_state_dict(torch.load(
        tmp / name / f"model_{TRAIN_STEPS:07d}.pth",
        weights_only=True)["model"], strict=True)
    log(f"[14 {name}] do_train {it} iterations at B = 2 on "
        f"{CANVAS[0]}x{CANVAS[1]}: "
        f"launches {counts} ({step_want} per step); total loss "
        f"{[round(h['total'], 4) for h in history]} "
        f"({', '.join(k for k in history[0] if k != 'total')}); "
        f"{len(frozen)} frozen tensors still, {len(trainable)} trainable "
        f"moved; the checkpoint loads strict; NMS calls (kept/valid) equal "
        f"to the plain version: {check_nms_calls(calls) or 'none'}")

    rng = np.random.default_rng(SEED + 8)
    batch = TL.batch_to_device([TL.build_train_example(data, i, rng=rng)
                                for i in data.image_ids[:2]], dev)
    with exact_convs():
        kernels.reset_launch_counts()
        got = step_grads(model, *batch, seed=SEED + 9)
        path_counts = kernels.launch_counts()
        with kernels.force_plain():
            ref = step_grads(model, *batch, seed=SEED + 9)
        torch.cuda.synchronize()
    if path_counts != step_want:
        raise AssertionError(f"{name}: kernel-path step launched "
                             f"{path_counts}")
    log(f"[14 {name}] one step, kernels vs plain (TF32 off): "
        f"{compare_steps(got, ref)}")
    return {"model": model, "batch": batch, "counts": counts, "init": init,
            "calls": calls}


def time_nms_call(call, what: str, card: str, iters: int = 10,
                  tag: str = "14 timing") -> tuple:
    """A recorded NMS call timed against its plain version and its bound,
    the kernel launch alone too -> (its label, the (ms, plain, bound, by,
    None, alone) of phase 12's NMS rows)."""
    from tpuseg_torch.kernels import nms as nms_kernel

    name, args, kwargs, _ = call
    fn_real = getattr(nms_ops, name)

    def fn():
        return fn_real(*args, **kwargs)

    with torch.inference_mode():
        k, p = time_pair(fn, iters)
        kargs = kernel_args(nms_kernel, "nms_keep", fn)
        alone = cuda_time_ms(lambda: nms_kernel.nms_keep(*kargs), iters)
    if name == "nms_mask_batch":
        boxes, scores, thr = args[:3]
        classes = None
    else:
        boxes, scores, classes, thr = args[:4]
    valid = kwargs["valid"]
    t = (k, p) + nms_bound(boxes, scores, valid, classes, thr) + (None, alone)
    label = f"{what}: {nms_call_label(name, args, kwargs)}"
    log(f"[{tag}] nms {label} ({int(valid.sum())} valid): kernel "
        f"{k:.4f} ms (the kernel launch alone {alone:.4f} ms), plain "
        f"{p:.4f} ms, bound {t[2]:.4g} ms by {t[3]} [{card}]")
    return label, t


def time_family(name: str, inf: dict, tr: dict, card: str) -> dict:
    """Forward img/s at B = 1 and 2 and the training step at B = 2, kernels
    and plain, as phase 12."""
    pred = inf["pred"]
    mod = ME.model_module(pred.cfg)
    landscape, _ = synthetic_images(SEED)
    times = {}
    with torch.inference_mode():
        for b in (1, 2):
            images, image_hw = canvas_batch(pred, landscape[:b])
            k, p = time_pair(lambda: mod.forward_inference(
                pred.model, images, image_hw), iters=5)
            times[f"{name} forward B={b}"] = (k, p)
            log(f"[14 timing] {name} forward B={b} {CANVAS[0]}x{CANVAS[1]}: "
                f"kernels "
                f"{1e3 * b / k:.2f} img/s ({k:.3f} ms), plain "
                f"{1e3 * b / p:.2f} img/s ({p:.3f} ms) [{card}]")
    times[f"{name} train step B=2"] = time_train_step(
        tr["model"], tr["batch"], f"[14 timing] {name} train step", card)
    return times


def time_c4_pooler(tr: dict, card: str) -> dict:
    """The C4 pooler (the adaptive RoIAlign in its separable form, plain
    torch, no kernel: no bound) on the training model's C4 map at B = 2:
    forward at the training sample (512 rois an image) and the inference
    proposals (1000), and forward + backward at the training sample."""
    model, (images, image_hw, _) = tr["model"], tr["batch"]
    cfg = model.cfg
    g = torch.Generator().manual_seed(SEED + 29)
    with torch.no_grad():
        c4 = model.backbone(images)
    times = {}
    for r in (512, 1000):
        boxes = random_boxes(g, (2, r), images.device)
        with torch.no_grad():
            times[f"c4 pooler forward R={r}"] = cuda_time_ms(
                lambda: C4.pooled_rois(cfg, c4, boxes), iters=5)
    boxes = random_boxes(g, (2, 512), images.device)
    feats = c4.detach().requires_grad_()
    grad = torch.randn(1024, c4.shape[1], 14, 14, device=images.device)

    def fwd_bwd():
        C4.pooled_rois(cfg, feats, boxes).backward(grad)
        feats.grad = None

    times["c4 pooler forward+backward R=512"] = cuda_time_ms(fwd_bwd, iters=5)
    fwd = times["c4 pooler forward R=512"]
    both = times["c4 pooler forward+backward R=512"]
    log(f"[14 timing] C4 pooler (adaptive RoIAlign 14x14 on "
        f"{tuple(c4.shape)}, separable form, f32, no kernel): forward "
        f"{fwd:.3f} ms at 2 x 512 rois, "
        f"{times['c4 pooler forward R=1000']:.3f} ms at 2 x 1000; forward + "
        f"backward {both:.3f} ms at 2 x 512 (backward {both - fwd:.3f} ms) "
        f"[{card}]")
    return times


def phase_family(dev, tmp: Path, card: str) -> dict:
    """Phase 14: C4, Faster R-CNN FPN and RetinaNet, inference and
    training, then their timings and K1's at the new shapes."""
    out = {"counts": {}, "times": {}, "ckpts": {}, "inits": {}, "nms": {}}

    def first(calls, name, b=2):
        return next(c for c in calls if c[0] == name and c[1][1].shape[0] == b)

    for name in FAMILY:
        inf = family_inference(name, dev, tmp)
        tr = family_train(name, dev, tmp)
        out["counts"][f"{name}_inference"] = inf["counts"]
        out["counts"][f"{name}_training"] = tr["counts"]
        out["ckpts"][name], out["inits"][name] = inf["ckpt"], str(tr["init"])
        out["times"].update(time_family(name, inf, tr, card))
        if name == "c4":  # the RPN's NMS of the B = 2 forward, and in training
            label, t = time_nms_call(first(inf["calls"], "nms_mask_batch"),
                                     "C4 inference RPN", card)
            out["nms"][label] = t
            label, t = time_nms_call(first(tr["calls"], "nms_mask_batch"),
                                     "C4 training RPN", card, iters=5)
            out["nms"][label] = t
            out["times"].update(time_c4_pooler(tr, card))
        if name == "retinanet":
            label, t = time_nms_call(
                first(inf["calls"], "batched_nms_mask_batch"),
                "RetinaNet class-aware", card)
            out["nms"][label] = t
        del inf, tr
        torch.cuda.empty_cache()
    phase_all_yamls(dev)
    return out


def compact(counts: dict) -> str:
    """'2 nms + 1 roi_align' for the kernels launched."""
    return " + ".join(f"{n} {k}" for k, n in counts.items() if n) or "none"


def phase_all_yamls(dev) -> None:
    """Every yaml of configs/ through build_predictor_from_cfg (random
    weights from the predictor's seed) and do_train on the 800x1344
    canvas: one B = 1 forward and one B = 2 training step each, with its
    model's launches, sane detections and finite losses."""
    landscape, _ = synthetic_images(SEED)
    data = SyntheticDataset(SEED + 7, n_images=2)
    lines = []
    for path in sorted((Path(__file__).resolve().parent / "configs")
                       .glob("*.yaml")):
        node = family_node(path.name)
        variant, cfg = ME.model_config_from_node(node)
        fwd_want, step_want = expected_launches(cfg)
        pred = ME.build_predictor_from_cfg(node, device=dev)
        kernels.reset_launch_counts()
        res = pred.run_on_bgr_image(landscape[0])
        torch.cuda.synchronize()
        fwd = kernels.launch_counts()
        n = check_result(res, *landscape[0].shape[:2],
                         masks=getattr(cfg, "mask_on", False))
        kernels.reset_launch_counts()
        with quiet():
            _, it, history = TL.do_train(
                data, cfg, model=pred.model, max_steps=1, ims_per_batch=2,
                checkpoint_period=2, log_every=2, device=dev)
            torch.cuda.synchronize()
        step = kernels.launch_counts()
        if fwd != fwd_want or step != step_want or it != 1 or not all(
                np.isfinite(v) for v in history[0].values()):
            raise AssertionError(
                f"{path.name}: launches {fwd} a forward and {step} a step "
                f"(want {fwd_want}, {step_want}); losses {history}")
        lines.append(f"{path.name} ({variant}, R-{cfg.depth}"
                     f"{'' if getattr(cfg, 'mask_on', False) else ', boxes'}"
                     f"): {n} dets, {compact(fwd)} / {compact(step)}, loss "
                     f"{history[0]['total']:.4g}")
        del pred
    torch.cuda.empty_cache()
    log(f"[14 yamls] every yaml, random weights (a forward at B = 1 / a "
        f"do_train step at B = 2, {CANVAS[0]}x{CANVAS[1]}; detections, "
        f"launches, total loss): {'; '.join(lines)}")


def phase_family_clis(dev, data: dict, family: dict, tmp: Path,
                      card: str) -> dict:
    """test_net and train_net (FAMILY_CLI_STEPS steps) through main() with
    the C4 and RetinaNet yamls over phase 13's dataset on disk: launches,
    finite stats and losses."""
    from tpuseg_torch.tools import test_net, train_net

    counts = {}
    for name in ("c4", "retinanet"):
        yaml = str(Path(__file__).resolve().parent / "configs"
                   / FAMILY[name])
        fwd_want, step_want = expected_launches(
            ME.model_config_from_node(family_node(name))[1])
        kernels.reset_launch_counts()
        with quiet():
            t0 = time.perf_counter()
            stats = test_net.main([
                "--config-file", yaml, "--images", data["img_dir"],
                "--annotations", data["ann"], "--max_images", "8",
                "--batch_size", "4", "MODEL.WEIGHT", family["ckpts"][name]])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        got = kernels.launch_counts()
        # a landscape and a portrait batch
        want = {k: 2 * v for k, v in fwd_want.items()}
        kinds = {"bbox", "segm"} if name == "c4" else {"bbox"}
        if got != want or stats.keys() != kinds or not all(
                np.isfinite(s).all() for s in stats.values()):
            raise AssertionError(f"test_net {name}: launched {got}, want "
                                 f"{want}; stats {stats}")
        counts[f"cli_{name}_test_net"] = got
        log(f"[14 cli] test_net --config-file {FAMILY[name]} "
            f"--max_images 8 --batch_size 4: launches {got} (2 forwards), "
            + ", ".join(f"{k} AP {v[0]:.4f}" for k, v in stats.items())
            + f", {wall:.1f} s [{card}]")
        kernels.reset_launch_counts()
        with quiet():
            t0 = time.perf_counter()
            history = train_net.main([
                "--config-file", yaml, "--max_steps", str(FAMILY_CLI_STEPS),
                "SOLVER.IMS_PER_BATCH", "2", "SOLVER.BASE_LR", "0.0025",
                "SOLVER.CHECKPOINT_PERIOD", str(FAMILY_CLI_STEPS),
                "DATASETS.IMAGES", data["img_dir"], "DATASETS.ANNOTATIONS",
                data["ann"], "OUTPUT_DIR", str(tmp / f"train_net_{name}"),
                "MODEL.WEIGHT", family["inits"][name]])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        got = kernels.launch_counts()
        want = {k: FAMILY_CLI_STEPS * v for k, v in step_want.items()}
        if got != want or len(history) != FAMILY_CLI_STEPS or not all(
                np.isfinite(v) for h in history for v in h.values()):
            raise AssertionError(f"train_net {name}: launched {got}, want "
                                 f"{want}; losses {history}")
        counts[f"cli_{name}_train_net"] = got
        log(f"[14 cli] train_net --config-file {FAMILY[name]} "
            f"--max_steps {FAMILY_CLI_STEPS}: launches {got}; total loss "
            f"{[round(h['total'], 4) for h in history]}; {wall:.1f} s "
            f"[{card}]")
    return counts


# ---------------------------------------------------------------------------
# phase 15: Pose2Seg
# ---------------------------------------------------------------------------

# the inference images (h, w) and their people: one chunk, and more than
# max_people (two chunks over one backbone pass)
P2S_IMAGES = (((480, 640), 6), ((640, 480), 20))
P2S_BATCH = 4  # canvases a training step
P2S_TRAIN_STEPS = 3
# a training step: AffineAlign's and the ground-truth warp's samplings,
# AffineAlign's gradient (d feats only: theta is data)
P2S_PER_STEP = {"nms": 0, "roi_align": 0, "roi_align_bwd": 0,
                "dcn_sample": 2, "dcn_sample_bwd": 1,
                "mask_paste": 0, "canvas": 0}
P2S_DATASET_IMAGES = 8  # alternately landscape and portrait
P2S_DATASET_HW = (480, 640)
# the backward with d feats only, per sample and channel: 4 corner weights
# times the gradient, 4 adds into d feats
DCN_BWD_FEATS_OPS_PER_VALUE = 8
COCO_KEYPOINT_NAMES = (
    "nose", "left_eye", "right_eye", "left_ear", "right_ear",
    "left_shoulder", "right_shoulder", "left_elbow", "right_elbow",
    "left_wrist", "right_wrist", "left_hip", "right_hip", "left_knee",
    "right_knee", "left_ankle", "right_ankle")


def template_people(rng: np.random.Generator, n: int, h: int, w: int,
                    jitter: float = 0.01) -> np.ndarray:
    """n people's COCO keypoints [n, 17, 3] inside an h x w image, all
    visible: a pose template (Pose2Seg's, in turn) plus N(0, jitter) noise
    in its unit frame, under a random similarity transform (its side 25-60
    % of the image's shorter one, rotated within 0.3 rad), so that every
    person's pose solves."""
    tpl = P2S.templates()
    out = np.zeros((n, 17, 3))
    for i in range(n):
        size = rng.uniform(0.25, 0.6) * min(h, w)
        ang = rng.uniform(-0.3, 0.3)
        rot = np.array([[np.cos(ang), -np.sin(ang)],
                        [np.sin(ang), np.cos(ang)]])
        pts = (tpl[i % len(tpl)] + rng.normal(0, jitter, (17, 2))
               - 0.5) @ rot.T * size
        lo, hi = pts.min(0), pts.max(0)
        out[i, :, :2] = pts + rng.uniform(-lo, [w, h] - hi)
        out[i, :, 2] = 2
    return out


def person_polygon(kp: np.ndarray, h: int, w: int) -> np.ndarray:
    """A 16-point ellipse around a person's keypoints (their box widened by
    a fifth), inside the image -> [16, 2] (x, y)."""
    t = np.linspace(0, 2 * np.pi, 16, endpoint=False)
    lo, hi = kp[:, :2].min(0), kp[:, :2].max(0)
    c, r = (lo + hi) / 2, (hi - lo) * 0.6 + 2
    poly = np.stack([c[0] + r[0] * np.cos(t), c[1] + r[1] * np.sin(t)], 1)
    return np.clip(poly, 0, [w - 1, h - 1]).round(2)


def write_keypoint_dataset(root: Path, seed: int) -> tuple:
    """A COCO person-keypoints dataset on disk: P2S_DATASET_IMAGES PNG
    images of textured_image, each with 2-5 people (template_people)
    painted in as the ellipses around their keypoints; per person its 17
    keypoints and the ellipse as its polygon; per image one crowd region
    (uncompressed RLE, no keypoints) and one person with a single visible
    keypoint, which the evaluation and the training skip -> (image dir,
    json path)."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    img_dir = root / "images"
    img_dir.mkdir(parents=True)
    images, anns = [], []

    def add(i, kp, segm, area, bbox, crowd=0):
        anns.append({"id": len(anns) + 1, "image_id": i, "category_id": 1,
                     "bbox": bbox, "area": area, "iscrowd": crowd,
                     "segmentation": segm, "num_keypoints":
                     int((kp[:, 2] > 0).sum()) if kp is not None else 0,
                     **({"keypoints": kp.reshape(-1).tolist()}
                        if kp is not None else {})})

    for i in range(1, P2S_DATASET_IMAGES + 1):
        h, w = P2S_DATASET_HW if i % 2 else P2S_DATASET_HW[::-1]
        img = textured_image(rng, h, w)
        kps = template_people(rng, int(rng.integers(2, 6)), h, w)
        for kp in kps:
            poly = person_polygon(kp, h, w)
            m = rle.decode(rle.poly_to_rle(poly.reshape(-1), h, w)) > 0
            img[m] = (0.5 * img[m] + 0.5 * rng.integers(0, 256, 3)).astype(
                np.uint8)
            lo, hi = poly.min(0), poly.max(0)
            add(i, kp.round(2), [poly.reshape(-1).tolist()], float(m.sum()),
                [float(lo[0]), float(lo[1]), float(hi[0] - lo[0]),
                 float(hi[1] - lo[1])])
        lone = template_people(rng, 1, h, w)[0]
        lone[1:, 2] = 0
        poly = person_polygon(lone[:1], h, w)
        add(i, lone.round(2), [poly.reshape(-1).tolist()], 1.0,
            [float(lone[0, 0]), float(lone[0, 1]), 1.0, 1.0])
        crowd = np.zeros((h, w), np.uint8)
        crowd[10:60, 10:90] = 1
        add(i, None, {"size": [h, w],
                      "counts": rle.encode_counts(crowd).tolist()},
            4000.0, [10.0, 10.0, 80.0, 50.0], crowd=1)
        Image.fromarray(img).save(img_dir / f"{i:012d}.png")
        images.append({"id": i, "height": h, "width": w,
                       "file_name": f"{i:012d}.png"})
    ann = root / "person_keypoints.json"
    ann.write_text(json.dumps({
        "images": images, "annotations": anns,
        "categories": [{"id": 1, "name": "person",
                        "keypoints": list(COCO_KEYPOINT_NAMES),
                        "skeleton": [[a + 1, b + 1]
                                     for a, b in P2S.COCO_SKELETON]}]}))
    return str(img_dir), str(ann)


def synthetic_pose2seg_state_dict(cfg, seed: int) -> dict:
    """Upstream-keyed Pose2Seg weights from a numpy seed: conv weights
    N(0, 1/fan_in), biases N(0, 0.05^2), BatchNorm weights U(0.5, 1.5),
    biases N(0, 0.05^2), running means N(0, 0.1^2), running variances
    U(0.5, 1.5)."""
    with torch.device("meta"):
        shapes = {k: tuple(t.shape)
                  for k, t in P2S.Pose2Seg(cfg).state_dict().items()}
    rng = np.random.default_rng(seed)
    sd = {}
    for k, shape in shapes.items():
        if k.endswith("num_batches_tracked"):
            sd[k] = torch.tensor(0)
            continue
        if len(shape) == 4:
            a = rng.standard_normal(shape) / np.sqrt(np.prod(shape[1:]))
        elif k.endswith("running_var"):
            a = rng.uniform(0.5, 1.5, shape)
        elif k.endswith("running_mean"):
            a = rng.standard_normal(shape) * 0.1
        elif k.endswith("weight"):
            a = rng.uniform(0.5, 1.5, shape)
        else:
            a = rng.standard_normal(shape) * 0.05
        sd[k] = torch.from_numpy(a.astype(np.float32))
    return sd


def calibrate_pose2seg(sd: dict, cfg, img: np.ndarray, kp: np.ndarray,
                       dev) -> float:
    """Shift the classifier's two biases so that the median foreground
    margin (logit 1 - logit 0) over the valid people's aligned crops of
    one image is 0: random weights otherwise leave every mask empty or
    full. -> the margin removed."""
    pred = P2SE.Pose2SegPredictor(cfg, state_dict=sd, device=dev)
    x, inp = p2s_canvas(pred, img, kp)
    with torch.inference_mode():
        logits = pred.model.heads(pred.model.backbone(x), inp["theta"],
                                  inp["skel"])
    n = int(inp["person_valid"].sum())
    margin = float((logits[0, :n, ..., 1] - logits[0, :n, ..., 0]).median())
    sd["segnet.conv2.bias"] += torch.tensor([margin / 2, -margin / 2])
    return margin


def p2s_canvas(pred, img: np.ndarray, kp: np.ndarray) -> tuple:
    """run_on_image's inputs of one image on the card: the canvas [1, 3,
    S, S] in the model's dtype, and its first max_people people's heads
    inputs."""
    cfg = pred.cfg
    h, w = img.shape[:2]
    s = cfg.input_size
    scale = s / max(h, w)
    canvas = P2SE.canvas_image(img, s, int(round(h * scale)),
                               int(round(w * scale)))
    x = torch.from_numpy(canvas).permute(2, 0, 1)[None].to(pred.device,
                                                           pred.dtype)
    inp = P2S.person_inputs(kp, cfg, scale)
    return x, {k: torch.from_numpy(v).to(pred.device) for k, v in inp.items()}


def check_p2s_masks(out: dict, n: int, h: int, w: int, what: str) -> str:
    """Every person valid, masks [n, h, w] uint8 in {0, 1}, each with
    foreground and less than half the image."""
    m, valid = out["masks"], out["valid"]
    if (m.shape != (n, h, w) or m.dtype != np.uint8 or m.max() > 1
            or not valid.all()):
        raise AssertionError(f"{what}: masks {m.shape} {m.dtype}, valid "
                             f"{valid.sum()} of {n}")
    share = m.reshape(n, -1).mean(1)
    if not ((share > 0) & (share < 0.5)).all():
        raise AssertionError(f"{what}: mask shares of the image {share}")
    return f"{share.min():.3f}-{share.max():.3f}"


def compare_p2s_step(k1: tuple, k2: tuple, *plain: tuple) -> str:
    """Pose2Seg's train-mode step, kernels (two runs) vs plain (``plain``:
    three runs): losses rtol 1e-6, and every gradient of the first kernel
    run within phase 9's elementwise gate of the first plain run: rtol
    1e-4 and atol 1e-6 max|g|, but where the plain runs themselves differ
    by more, in this run, the atol is ten times their largest elementwise
    difference (the first run against each other one). The whole model
    trains in train mode: every gradient carries the rounding of the
    atomic adds in AffineAlign's backward (K4c's; index_add_'s on the
    plain path), whose order changes from run to run, and train-mode
    BatchNorm's backward, a difference of nearly equal per-channel sums,
    magnifies it. The gradients whose atol was raised are named, with
    their count per top-level module."""
    (l1, g1), (l2, g2), (lp, gp) = k1, k2, plain[0]
    for k, w in lp.items():
        for got in (l1, l2):
            if not abs(got[k] - w) <= 1e-6 * abs(w):
                raise AssertionError(f"train-mode loss {k}: kernels "
                                     f"{got[k]!r}, plain {w!r}")
    if sorted(g1) != sorted(gp):
        raise AssertionError("the two paths give gradients to other parameters")
    raised, bad, kp, kk, pp, strict, margin = {}, [], {}, {}, {}, [], {}
    for n, w in gp.items():
        scale = float(w.abs().max())
        spread = max(float((g[n] - w).abs().max()) for _, g in plain[1:])
        atol = max(1e-6 * scale, 10 * spread)
        err = (g1[n] - w).abs()
        if atol > 1e-6 * scale:
            raised[n] = atol / scale
            margin[n] = float(err.max()) / spread
        if bool((err > 1e-4 * w.abs() + 1e-6 * scale).any()):
            strict.append(n)
        excess = float((err - (1e-4 * w.abs() + atol)).max())
        if excess > 0:
            bad.append((excess / scale, n, float(err.max()) / scale,
                        atol / scale))
        if scale:
            kp[n] = float(err.max()) / scale
            kk[n] = float((g2[n] - g1[n]).abs().max()) / scale
            pp[n] = spread / scale
    if bad:
        raise AssertionError(
            "train-mode gradients past rtol 1e-4 / atol (excess, largest "
            "error and atol, all of max|g|): " + "; ".join(
                f"{n} {e:.3g} {m:.3g} {a:.3g}"
                for e, n, m, a in sorted(bad)[::-1][:3]))
    worst = max(kp, key=kp.get)
    top = {}
    for n in gp:
        group = top.setdefault(n.split(".")[0], [0, 0])
        group[0] += n in raised
        group[1] += 1
    most = max(margin, key=margin.get) if margin else None
    return (f"losses equal to rtol 1e-6 in both kernel runs; {len(gp)} "
            f"gradients within rtol 1e-4 / atol 1e-6 max|g| of the plain "
            f"run, or ten times the plain runs' own spread where that is "
            f"larger: largest error {kp[worst]:.3g} of max|g| ({worst}); "
            f"largest spread kernels vs kernels {max(kk.values()):.3g}, plain "
            f"vs plain {max(pp.values()):.3g}; {len(strict)} past the gate "
            f"alone; atol raised for {len(raised)} ("
            + ", ".join(f"{g} {r} of {t}" for g, (r, t) in top.items())
            + (f"), up to {max(raised.values()):.3g} of max|g|, the largest "
               f"error {margin[most]:.3g} times the plain spread ({most}): "
               + ", ".join(sorted(raised)) if raised else ")"))


def p2s_step_grads(trainer, batch: dict, gt_aligned) -> tuple:
    """The loss and parameter gradients of one training forward + backward
    (train-mode BatchNorm; no update)."""
    model = trainer.model
    model.zero_grad(set_to_none=True)
    loss = trainer.loss(batch["images"], batch["theta"], batch["valid"],
                        gt_aligned, batch["skel"])
    loss.backward()
    grads = {n: p.grad.detach().clone() for n, p in model.named_parameters()
             if p.grad is not None}
    model.zero_grad(set_to_none=False)
    return {"loss": float(loss.detach())}, grads


def grid_sample_feats_backward(feats, sy, sx, grad):
    """AffineAlign's backward as PyTorch's: grid_sample's backward for the
    features alone (align_corners=True, zeros); a closure to time."""
    f = feats.detach().requires_grad_()
    h, w = feats.shape[2:]
    grid = torch.stack([2.0 * sx / (w - 1) - 1.0, 2.0 * sy / (h - 1) - 1.0],
                       -1)[:, :, None, :].to(feats.dtype)
    out = F.grid_sample(f, grid, mode="bilinear", padding_mode="zeros",
                        align_corners=True)[..., 0].transpose(1, 2)
    return lambda: torch.autograd.grad(out, f, grad, retain_graph=True)


def dcn_feats_bwd_bound(feats, sy) -> tuple:
    """The backward with d feats only: the [B, S, C] gradient and sy/sx
    read, the f32 d feats accumulator [B, H, W, C] written."""
    b, c, h, w = feats.shape
    s = sy.shape[1]
    nbytes = (b * s * c * feats.element_size() + b * s * 2 * 4
              + b * h * w * c * 4)
    return bound(nbytes, DCN_BWD_FEATS_OPS_PER_VALUE * b * s * c)


def p2s_kernels(args: tuple, warp_args: tuple, bwd_args: tuple) -> str:
    """The kernels at Pose2Seg's own inputs (the arguments the path gave
    the wrappers): K4 at AffineAlign's [1, 256, 128, 128] and S = 16 x 64 x
    64, f32 and bf16 equal to the plain version bit for bit, bf16 also
    within 2^-8 |ref| + 1e-3 of the plain version in f32, grid_sample
    within 1e-4 max|ref|; K4 at the warp's C = 1 equal bit for bit; K4c
    with d feats only at the training step's B = 4 against its plain
    version (phase 7's tolerances), f32 and bf16."""
    with torch.inference_mode():
        feats, sy, sx, _ = args
        got = sampling.sample_points(feats, sy, sx)
        want = sampling.sample_points_plain(feats, sy, sx)
        if not torch.equal(got, want):
            raise AssertionError(
                "AffineAlign's K4 differs from the plain version by "
                f"{float((got - want).abs().max())}")
        fb = feats.bfloat16()
        got_bf = sampling.sample_points(fb, sy, sx)
        if not torch.equal(got_bf, sampling.sample_points_plain(fb, sy, sx)):
            raise AssertionError("AffineAlign's K4 in bf16 differs from the "
                                 "plain version")
        ref = sampling.sample_points_plain(fb.float(), sy, sx)
        err_bf = (got_bf.float() - ref).abs()
        excess = float((err_bf - (2.0 ** -8 * ref.abs() + 1e-3)).max())
        if excess > 0:
            raise AssertionError("AffineAlign's K4 bf16: past 2^-8|ref| + "
                                 f"1e-3 by {excess}")
        ones = torch.ones_like(sy)
        lib_err = float((grid_sample_points(feats, sy, sx, ones) - want).abs()
                        .max())
        if lib_err > 1e-4 * float(want.abs().max()):
            raise AssertionError("AffineAlign: grid_sample differs by "
                                 f"{lib_err}")
        gt, wy, wx, _ = warp_args
        if not torch.equal(sampling.sample_points(gt, wy, wx),
                           sampling.sample_points_plain(gt, wy, wx)):
            raise AssertionError("the ground-truth warp's K4 (C = 1) differs "
                                 "from the plain version")
        grad, bfeats, by, bx = bwd_args[:4]
        errs = []
        for dt in (torch.float32, torch.bfloat16):
            df = sampling.sample_points_backward(
                grad.to(dt), bfeats.to(dt), by, bx, None, True, False)
            with kernels.force_plain():
                want_df = sampling.sample_points_backward(
                    grad.float(), bfeats.float(), by, bx, None, True, False)
            if df[1:] != (None, None, None):
                raise AssertionError("K4c with d feats only returned "
                                     "coordinate gradients")
            errs.append(dcn_bwd_error(df[:1], want_df[:1], dt,
                                      f"AffineAlign's K4c {str(dt)[6:]}"))
        torch.cuda.synchronize()
        outside = float((want[..., 0] == 0).float().mean())
        return (f"K4 {tuple(feats.shape)} S={sy.shape[1]} f32 and bf16 "
                "equal to the plain version, bf16 vs the f32 plain max err "
                f"{float(err_bf.max()):.3g}, grid_sample {lib_err:.3g}, "
                f"{100 * outside:.1f} % of samples wholly outside; K4 C = 1 "
                f"{tuple(gt.shape)} S={wy.shape[1]} equal; K4c d feats only "
                f"{tuple(bfeats.shape)} S={by.shape[1]} max err f32 "
                f"{errs[0]:.3g}, bf16 {errs[1]:.3g}")


def p2s_batch(ds, cfg, dev) -> dict:
    """The first P2S_BATCH training canvases of the dataset (train_example,
    as the training CLI builds them) on the card."""
    from tpuseg_torch.tools.pose2seg_train import train_example

    exs = [ex for ex in (train_example(ds, iid, cfg) for iid in ds.image_ids)
           if ex is not None and ex["valid"].any()][:P2S_BATCH]
    return {k: torch.from_numpy(np.concatenate([ex[k] for ex in exs])).to(dev)
            for k in exs[0]}


def phase_pose2seg(dev, tmp: Path, card: str) -> dict:
    """Phase 15: Pose2Seg at full width (R-50 with the dilated C5, the 512
    canvas, P2 128x128x256, max_people 16, 10 seg units, cat_skeleton),
    weights from a numpy seed loaded through the last.pkl loader:
    inference, the kernels at its inputs, training, the two CLIs and the
    timings."""
    from tpuseg_torch.kernels import dcn as dcn_kernel
    from tpuseg_torch.tools import pose2seg_test, pose2seg_train

    cfg = P2S.Pose2SegConfig()
    rng = np.random.default_rng(SEED + 31)
    cases = [(textured_image(rng, h, w), template_people(rng, n, h, w))
             for (h, w), n in P2S_IMAGES]
    sd = synthetic_pose2seg_state_dict(cfg, SEED + 30)
    margin = calibrate_pose2seg(sd, cfg, *cases[0], dev)
    ckpt = tmp / "last.pkl"
    torch.save(sd, ckpt)
    out = {"counts": {}, "times": {}, "shapes": {}}

    # inference through the predictor, f32 and bf16: one K4 launch a chunk
    # of max_people, one backbone pass an image
    preds, masks = {}, {}
    for dt in (torch.float32, torch.bfloat16):
        pred = P2SE.Pose2SegPredictor(weights=str(ckpt), dtype=dt, device=dev)
        if not pred.cfg.cat_skeleton or pred.cfg.seg_units != cfg.seg_units:
            raise AssertionError(f"the loader gave {pred.cfg}")
        preds[dt], lines = pred, []
        for img, kp in cases:
            h, w = img.shape[:2]
            passes = []
            body = pred.model.backbone.forward
            pred.model.backbone.forward = (
                lambda x, body=body: passes.append(1) or body(x))
            kernels.reset_launch_counts()
            res = pred.run_on_image(img, kp)
            torch.cuda.synchronize()
            got = kernels.launch_counts()
            del pred.model.backbone.forward
            chunks = -(-len(kp) // cfg.max_people)
            want = {**{k: 0 for k in got}, "dcn_sample": chunks}
            if got != want or len(passes) != 1:
                raise AssertionError(f"Pose2Seg {len(kp)} people launched "
                                     f"{got}, want {want}; {len(passes)} "
                                     "backbone passes, want 1")
            shares_ = check_p2s_masks(res, len(kp), h, w,
                                      f"Pose2Seg {str(dt)[6:]} {h}x{w}")
            masks[dt, h] = res["masks"]
            path = f"pose2seg_inference_{str(dt)[6:]}_{len(kp)}_people"
            out["counts"][path] = got
            lines.append(f"{h}x{w} with {len(kp)} people: {chunks} chunk(s), "
                         f"launches {compact(got)}, 1 backbone pass, every "
                         f"person valid, mask shares of the image {shares_}")
        log(f"[15 pose2seg] Pose2SegPredictor {str(dt)[6:]} (weights "
            f"through load_pose2seg_weights, the classifier's median margin "
            f"{margin:.4g} removed): " + "; ".join(lines))
    agree_bf = {f"{img.shape[0]}x{img.shape[1]}": round(float(
        (masks[torch.float32, img.shape[0]]
         == masks[torch.bfloat16, img.shape[0]]).mean()), 5)
        for img, _ in cases}
    log(f"[15 pose2seg] bf16 masks equal to f32's on a share "
        f"{agree_bf} of the pixels (no limit: bf16 moves the 0.5 threshold)")

    # the heads on one shared P2 map: kernels vs plain
    pred = preds[torch.float32]
    img, kp = cases[1]
    x, inp = p2s_canvas(pred, img, kp)
    heads = (inp["theta"], inp["inv_theta"], inp["person_valid"], inp["skel"])
    with torch.inference_mode(), exact_convs():
        feats = pred.model.backbone(x)
        got = pred.model.forward_from_features(feats, *heads)
        with kernels.force_plain():
            want = pred.model.forward_from_features(feats, *heads)
        args = kernel_args(dcn_kernel, "sample_points",
                           lambda: pred.model.heads(feats, inp["theta"],
                                                    inp["skel"]))
    diffs = {}
    for k in ("aligned_logits", "masks"):
        d = float((got[k] - want[k]).abs().max())
        if d > 1e-5 * float(want[k].abs().max()):
            raise AssertionError(f"Pose2Seg heads {k}: kernels vs plain "
                                 f"differ by {d}")
        diffs[k] = d
    log(f"[15 pose2seg] heads on one P2 map {tuple(feats.shape)}, 16 people, "
        f"kernels vs plain (TF32 off, deterministic cuDNN): aligned logits "
        f"max diff {diffs['aligned_logits']:.3g}, masks "
        f"{diffs['masks']:.3g} (limit 1e-5 max|ref|)")

    # training: P2S_TRAIN_STEPS Pose2SegTrainer steps at B = 4 with the
    # ground-truth warp
    img_dir, ann = write_keypoint_dataset(tmp / "keypoints", SEED + 32)
    ds = CocoDetectionDataset(img_dir, ann, label_map=None)
    batch = p2s_batch(ds, cfg, dev)
    sd, _ = load_pose2seg_weights(str(ckpt), cfg)
    model = P2S.build_model(cfg)
    model.load_state_dict(sd, strict=True)
    model = model.to(dev)
    trainer = P2SL.Pose2SegTrainer(model)
    before = {k: v.clone() for k, v in model.state_dict().items()}

    def warp():
        return (P2SL.warp_gt_to_aligned(batch["gt_masks"], batch["theta"],
                                        cfg.align_size) > 0.5).float()

    def step():
        return trainer.train_step(batch["images"], batch["theta"],
                                  batch["valid"], warp(), skel=batch["skel"])

    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    losses = [float(step()) for _ in range(P2S_TRAIN_STEPS)]
    seconds = time.perf_counter() - t0
    counts = kernels.launch_counts()
    want = {k: P2S_TRAIN_STEPS * v for k, v in P2S_PER_STEP.items()}
    if counts != want or not all(np.isfinite(losses)):
        raise AssertionError(f"Pose2Seg training launched {counts}, want "
                             f"{want}; losses {losses}")
    out["counts"]["pose2seg_training"] = counts
    after = model.state_dict()
    still = [n for n, _ in model.named_parameters()
             if torch.equal(after[n], before[n])]
    stats = [k for k in after if k.endswith(("running_mean", "running_var"))]
    stale = [k for k in stats if torch.equal(after[k], before[k])]
    if still or stale:
        raise AssertionError(f"parameters that did not move: {still}; "
                             f"running statistics not updated: {stale}")
    n_valid = int(batch["valid"].sum())
    log(f"[15 pose2seg] Pose2SegTrainer {P2S_TRAIN_STEPS} steps at B = "
        f"{P2S_BATCH} ({n_valid} people) with the ground-truth warp, f32 "
        f"with TF32 convolutions, train-mode BatchNorm, in {seconds:.1f} s: "
        f"launches {compact(counts)} ({compact(P2S_PER_STEP)} per step); "
        f"losses {[round(v, 5) for v in losses]}; all "
        f"{len(list(model.parameters()))} parameters moved, {len(stats)} "
        "running statistics updated")
    gt_aligned = warp()
    warp_args = kernel_args(dcn_kernel, "sample_points", warp)
    bwd_args = kernel_args(dcn_kernel, "sample_points_backward",
                           lambda: p2s_step_grads(trainer, batch, gt_aligned))
    log(f"[15 pose2seg] the kernels at Pose2Seg's inputs: "
        f"{p2s_kernels(args, warp_args, bwd_args)}")
    # one step on one batch, kernels (two runs) vs plain (three runs), TF32
    # off and deterministic cuDNN: phase 9's gate, its atol raised where
    # the plain runs' own spread is larger (compare_p2s_step)
    with exact_convs():
        kernels.reset_launch_counts()
        runs = [p2s_step_grads(trainer, batch, gt_aligned)]
        path_counts = kernels.launch_counts()
        runs.append(p2s_step_grads(trainer, batch, gt_aligned))
        with kernels.force_plain():
            runs += [p2s_step_grads(trainer, batch, gt_aligned)
                     for _ in range(3)]
        torch.cuda.synchronize()
    if path_counts != {**P2S_PER_STEP, "dcn_sample": 1}:
        raise AssertionError(f"Pose2Seg kernel-path step launched "
                             f"{path_counts}")
    log(f"[15 pose2seg] one step, kernels vs plain (cudnn.allow_tf32 False, "
        f"cudnn.deterministic True), train-mode BatchNorm: "
        f"{compare_p2s_step(*runs)}")

    # the two CLIs on the card, over the keypoint dataset
    def run(main, argv):
        kernels.reset_launch_counts()
        with quiet() as buf, step_starts(P2SL.Pose2SegTrainer) as starts:
            t0 = time.perf_counter()
            result = main(argv)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        return result, kernels.launch_counts(), wall, starts, buf.getvalue()

    evals, found = {}, []
    orig = P2SE.Pose2SegPredictor.run_on_image

    def counted(self, *a):
        res = orig(self, *a)
        found[-1] += int(res["valid"].sum())
        return res

    P2SE.Pose2SegPredictor.run_on_image = counted
    try:
        for plain in (False, True):
            found.append(0)
            with exact_convs(), (kernels.force_plain() if plain
                                 else contextlib.nullcontext()):
                evals[plain] = run(pose2seg_test.main, [
                    "--weights", str(ckpt), "--coco", "--coco_images",
                    img_dir, "--coco_ann", ann])
    finally:
        P2SE.Pose2SegPredictor.run_on_image = orig
    stats, counts, wall, _, _ = evals[False]
    people = sum(len(P2SE.image_keypoints(ds, i)) for i in ds.image_ids)
    want = {**{k: 0 for k in counts}, "dcn_sample": P2S_DATASET_IMAGES}
    if counts != want or found[0] != people:
        raise AssertionError(f"pose2seg_test launched {counts}, want {want}; "
                             f"{found[0]} of {people} people valid")
    same = agree(stats, evals[True][0], found[0], found[1],
                 "pose2seg_test")
    out["counts"]["cli_pose2seg_test"] = counts
    out["times"]["pose2seg_test s/img"] = wall / P2S_DATASET_IMAGES
    log(f"[15 cli] pose2seg_test --coco over {P2S_DATASET_IMAGES} images "
        f"({people} people; the crowds and one-keypoint people skipped): "
        f"launches {compact(counts)}, segm AP {stats['cocoVal'][0]:.4f}; "
        f"kernels vs plain (TF32 off, deterministic cuDNN) {same}; "
        f"{wall:.1f} s")
    save = tmp / "pose2seg_last.pth"
    losses, counts, wall, starts, _ = run(pose2seg_train.main, [
        "--images", img_dir, "--annotations", ann, "--steps",
        str(CLI_TRAIN_STEPS), "--save", str(save)])
    want = {k: CLI_TRAIN_STEPS * v for k, v in P2S_PER_STEP.items()}
    if (counts != want or len(losses) != CLI_TRAIN_STEPS
            or not all(np.isfinite(losses))):
        raise AssertionError(f"pose2seg_train launched {counts}, want {want}; "
                             f"losses {losses}")
    back = P2SE.Pose2SegPredictor(weights=str(save), device=dev)
    out["counts"]["cli_pose2seg_train"] = counts
    gaps = np.diff(starts)
    out["times"]["pose2seg_train s/it"] = float(np.median(gaps[1:]))
    log(f"[15 cli] pose2seg_train --steps {CLI_TRAIN_STEPS}: launches "
        f"{compact(counts)}; losses {[round(v, 5) for v in losses]}; "
        f"{wall:.1f} s in main(); {save.name} loads through "
        f"load_pose2seg_weights (seg_units {back.cfg.seg_units}); "
        f"{out['times']['pose2seg_train s/it']:.3f} s/it, host included "
        f"(the median interval between steps' starts after the first; all "
        f"{[round(float(g), 3) for g in gaps]}) [{card}]")
    del back

    out["times"].update(time_pose2seg(preds, cases, trainer, step, args,
                                      warp_args, bwd_args, card))
    out["shapes"] = {k: v for k, v in out["times"].items()
                     if k.startswith(("dcn_sample ", "dcn_sample_bwd "))}
    return out


def time_pose2seg(preds, cases, trainer, step, args, warp_args, bwd_args,
                  card: str) -> dict:
    """K4 and K4c at Pose2Seg's shapes against their plain versions, their
    bounds and grid_sample (and its backward), f32 and bf16; the forward
    at B = 1 (16 people) through both paths, f32 and bf16, and
    run_on_image on the host clock; the training step at B = 4."""
    from tpuseg_torch.kernels import dcn as dcn_kernel

    times = {}
    feats, sy, sx, _ = args
    gt, wy, wx, _ = warp_args
    with torch.inference_mode():
        for label, f, y, x, dts in (
                ("AffineAlign", feats, sy, sx,
                 (torch.float32, torch.bfloat16)),
                ("ground-truth warp", gt, wy, wx, (torch.float32,))):
            for dt in dts:
                fd = f.to(dt)
                k, p = time_pair(lambda: sampling.sample_points(fd, y, x),
                                 iters=10)
                alone = cuda_time_ms(
                    lambda: dcn_kernel.sample_points(fd, y, x), 10)
                ones = torch.ones_like(y)
                lib = cuda_time_ms(
                    lambda: grid_sample_points(fd, y, x, ones), iters=10)
                b, c, h, w = fd.shape
                nbytes = (dcn_touched_cells(y, x, h, w) * c * fd.element_size()
                          + b * y.shape[1] * 2 * 4
                          + b * y.shape[1] * c * fd.element_size())
                name = (f"dcn_sample {str(dt)[6:]} Pose2Seg {label} B={b} "
                        f"{h}x{w}x{c} S={y.shape[1]}")
                times[name] = ((k, p) + bound(nbytes, DCN_OPS_PER_VALUE * b
                                              * y.shape[1] * c)
                               + (lib, alone))
                log(f"[15 timing] {name}: kernel {k:.4f} ms (the launch "
                    f"alone {alone:.4f}), plain {p:.4f} ms, bound "
                    f"{times[name][2]:.4g} ms by {times[name][3]}, "
                    f"grid_sample {lib:.4f} ms [{card}]")
    grad, bfeats, by, bx = bwd_args[:4]
    for dt in (torch.float32, torch.bfloat16):
        g, f = grad.to(dt), bfeats.to(dt)

        def bwd():
            return sampling.sample_points_backward(g, f, by, bx, None, True,
                                                   False)

        k, p = time_pair(bwd, iters=10)
        alone = cuda_time_ms(lambda: dcn_kernel.sample_points_backward(
            g, f, by, bx, None, True, False), 10)
        lib = cuda_time_ms(grid_sample_feats_backward(f, by, bx, g), iters=10)
        b, c, h, w = f.shape
        name = (f"dcn_sample_bwd {str(dt)[6:]} Pose2Seg d feats only B={b} "
                f"{h}x{w}x{c} S={by.shape[1]}")
        times[name] = (k, p) + dcn_feats_bwd_bound(f, by) + (lib, alone)
        log(f"[15 timing] {name}: kernel {k:.4f} ms (the launch alone "
            f"{alone:.4f}), plain {p:.4f} ms, bound {times[name][2]:.4g} ms "
            f"by {times[name][3]}, grid_sample backward {lib:.4f} ms "
            f"[{card}]")
    for dt, pred in preds.items():
        img, kp = cases[1]
        x, inp = p2s_canvas(pred, img, kp)
        heads = (inp["theta"], inp["inv_theta"], inp["person_valid"],
                 inp["skel"])
        with torch.inference_mode():
            k, p = time_pair(lambda: pred.model(x, *heads), iters=5)
        name = f"pose2seg forward {str(dt)[6:]} B=1"
        times[name] = (k, p)
        log(f"[15 timing] Pose2Seg forward {str(dt)[6:]} B=1, "
            f"{pred.cfg.max_people} people, {pred.cfg.input_size} canvas: "
            f"kernels {1e3 / k:.2f} img/s ({k:.3f} ms), plain {1e3 / p:.2f} "
            f"img/s ({p:.3f} ms) [{card}]")
        for img, kp in cases:
            pred.run_on_image(img, kp)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(3):
                pred.run_on_image(img, kp)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) / 3 * 1e3
            name = f"pose2seg run_on_image {str(dt)[6:]} {len(kp)} people"
            times[name] = (wall,)
            log(f"[15 timing] Pose2Seg run_on_image {str(dt)[6:]} "
                f"{img.shape[0]}x{img.shape[1]}, {len(kp)} people: {wall:.1f} "
                f"ms on the host clock, mean of 3 (host included: template "
                f"choice and skeleton features on the host) [{card}]")
    k1 = cuda_time_ms(step, iters=5, warmup=2)
    with kernels.force_plain():
        p = cuda_time_ms(step, iters=2, warmup=1)
    k2 = cuda_time_ms(step, iters=5, warmup=0)
    k = (k1 + k2) / 2
    times[f"pose2seg train step B={P2S_BATCH}"] = (k, p)
    log(f"[15 timing] Pose2Seg train step B={P2S_BATCH} (the ground-truth "
        f"warp, forward, backward, SGD; TF32 convolutions): kernels "
        f"{k:.3f} ms ({1e3 * P2S_BATCH / k:.2f} img/s; two runs of 5: "
        f"{k1:.3f}, {k2:.3f}), plain {p:.3f} ms (mean of 2) [{card}]")
    return times


# ---------------------------------------------------------------------------
# phase 16: YOLOv3 (DarkNet-53) and ViT-B/16
# ---------------------------------------------------------------------------

YOLO_BATCH = 8
YOLO_TRAIN_STEPS = 3
# the inference images (h, w), ragged on one canvas
YOLO_IMAGES = ((480, 640), (640, 480), (500, 500), (375, 500), (427, 640),
               (640, 427), (333, 500), (480, 360))
YOLO_CLI_EVAL_IMAGES = 8
VIT_CONFIG = "vit_b16_config"
VIT_BATCH = 32
VIT_TRAIN_STEPS = 3
# a ViT step's learning rate: the smoke's three steps and the CLI's first
# five are past no warm-up
VIT_LR = 3e-2


def write_darknet_weights(path: Path, cfg, seed: int) -> None:
    """A yolov3.weights file for ``cfg``'s model from a numpy seed, in
    darknet's cfg order (``YoloV3.layers``): BatchNorm shifts and running
    means N(0, 0.05^2), scales and running variances U(0.7, 1.3), conv
    weights N(0, 1/fan_in); the heads' output convs N(0, 3e-3^2) with
    biases N(0, 0.02^2), so that box sizes stay near their anchors and the
    scores spread (tests/test_cross_parity_yolov3.py's recipe)."""
    rng = np.random.default_rng(seed)
    with torch.device("meta"):
        model = Y3.YoloV3(cfg)
    with open(path, "wb") as f:
        f.write(np.asarray([0, 2, 0], np.int32).tobytes())
        f.write(np.asarray([0], np.int64).tobytes())
        for layer, has_bn in model.layers():
            w = layer.conv.weight if has_bn else layer.weight
            shape, cout = tuple(w.shape), w.shape[0]
            if has_bn:
                parts = [rng.normal(0, 0.05, cout), rng.uniform(0.7, 1.3, cout),
                         rng.normal(0, 0.05, cout), rng.uniform(0.7, 1.3, cout),
                         rng.standard_normal(shape) / np.sqrt(w[0].numel())]
            else:
                parts = [rng.normal(0, 0.02, cout),
                         rng.standard_normal(shape) * 3e-3]
            for p in parts:
                f.write(p.astype(np.float32).tobytes())


def yolo_canvas(imgs: list) -> tuple:
    """uint8 RGB images -> (the batch zero-padded to one canvas, its
    largest height and width rounded up to 32, and each (h, w))."""
    h = -(-max(i.shape[0] for i in imgs) // 32) * 32
    w = -(-max(i.shape[1] for i in imgs) // 32) * 32
    batch = np.zeros((len(imgs), h, w, 3), np.uint8)
    for j, img in enumerate(imgs):
        batch[j, :img.shape[0], :img.shape[1]] = img
    return batch, np.asarray([i.shape[:2] for i in imgs], np.int32)


def check_yolo(dets: dict, b: int, cfg) -> list:
    """Sane padded detections of b images -> each image's count."""
    valid = dets["valid"]
    assert valid.shape == (b, cfg.max_det), valid.shape
    counts = [int(v.sum()) for v in valid]
    if not all(counts):
        raise AssertionError(f"an image without detections: {counts}")
    boxes, scores = dets["boxes"][valid], dets["scores"][valid]
    classes = dets["classes"][valid]
    if not (np.isfinite(boxes).all() and (boxes[:, 2:] > boxes[:, :2]).all()
            and ((scores > cfg.conf_thresh) & (scores <= 1)).all()
            and ((classes >= 0) & (classes < cfg.num_classes)).all()):
        raise AssertionError(
            f"YOLOv3 detections out of range: boxes {boxes.min(0)} to "
            f"{boxes.max(0)}, scores {scores.min()} to {scores.max()}, "
            f"classes {classes.min()} to {classes.max()}")
    return counts


def moved(model, before: dict) -> tuple:
    """(parameters that did not move, running statistics not updated)."""
    after = model.state_dict()
    still = [n for n, _ in model.named_parameters()
             if torch.equal(after[n], before[n])]
    stale = [k for k in after if k.endswith(("running_mean", "running_var"))
             and torch.equal(after[k], before[k])]
    return still, stale


def run_cli(main, argv, cls=None) -> tuple:
    """A CLI's main(argv) on the card -> (its result, its launches, wall
    seconds, the start of each cls.train_step call, its stdout)."""
    kernels.reset_launch_counts()
    with quiet() as buf, (step_starts(cls) if cls else
                          contextlib.nullcontext([])) as starts:
        t0 = time.perf_counter()
        result = main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return result, kernels.launch_counts(), wall, starts, buf.getvalue()


def phase_yolo(dev, tmp: Path, card: str) -> dict:
    """Phase 16, YOLOv3-416 at full width (DarkNet-53, 80 classes), weights
    from a numpy seed through the darknet reader: inference in f32 and
    bf16 at B = 1 and 8 (one K1 a batch, each call equal to the plain
    version bit for bit), kernels vs plain and card vs CPU, the COCO
    evaluation through both paths, training, the three CLIs, timings."""
    from tpuseg_torch.tools import yolo_detect, yolo_eval, yolo_train

    cfg = Y3.YoloV3Config()
    weights = tmp / "yolov3.weights"
    write_darknet_weights(weights, cfg, SEED + 40)
    rng = np.random.default_rng(SEED + 41)
    imgs = [textured_image(rng, h, w) for h, w in YOLO_IMAGES]
    out = {"counts": {}, "times": {}, "nms": {}}
    preds, calls = {}, {}
    for dt in (torch.float32, torch.bfloat16):
        pred = YOE.YoloPredictor(cfg, weights=str(weights),
                                 batch_size=YOLO_BATCH, dtype=dt, device=dev)
        preds[dt], lines = pred, []
        for b in (1, YOLO_BATCH):
            batch, hw = yolo_canvas(imgs[:b])
            kernels.reset_launch_counts()
            with recording_nms() as rec:
                dets = pred.run_batch(batch, hw)
            torch.cuda.synchronize()
            got = kernels.launch_counts()
            if got != {**{k: 0 for k in got}, "nms": 1} or len(rec) != 1:
                raise AssertionError(f"YOLOv3 {dt} B={b} launched {got} in "
                                     f"{len(rec)} NMS calls, want one K1")
            counts = check_yolo(dets, b, cfg)
            same = check_nms_calls(rec)
            calls[dt, b] = rec[0]
            out["counts"][f"yolov3_inference_{str(dt)[6:]}_B{b}"] = got
            lines.append(f"B = {b} on {batch.shape[1]}x{batch.shape[2]}: "
                         f"launches {compact(got)}, K1 equal to plain bit "
                         f"for bit ({same}), detections {counts}")
        log(f"[16 yolov3] YoloPredictor {str(dt)[6:]} (yolov3.weights through "
            f"the darknet reader): " + "; ".join(lines))

    # kernels vs plain on one batch, and the card against the CPU, TF32 off
    pred = preds[torch.float32]
    batch, hw = yolo_canvas(imgs)
    x8 = torch.from_numpy(batch).to(dev)
    hw8 = torch.from_numpy(hw).to(dev)
    with torch.inference_mode(), exact_convs():
        got = pred.detect(x8, hw8)
        with kernels.force_plain():
            want = pred.detect(x8, hw8)
        heads = compare_heads(got, want)
        x = YOE.letterbox_preprocess(x8[:2], hw8[:2], size=cfg.input_size)
        card_maps = [o.cpu() for o in pred.model(x)]
    log(f"[16 yolov3] B = {YOLO_BATCH}, kernels vs plain (cudnn.allow_tf32 "
        f"False, deterministic cuDNN): {heads}")
    cpu = YOE.build_yolo(cfg, None, str(weights)).eval()
    with torch.inference_mode():
        cpu_maps = cpu(x.cpu())
    errs = []
    for g, w in zip(card_maps, cpu_maps):
        err = float((g - w).abs().max()) / float(w.abs().max())
        if err > 1e-4:
            raise AssertionError(f"YOLOv3 head map {tuple(w.shape)}: card vs "
                                 f"CPU {err:.3g} of max|ref|")
        errs.append(f"{err:.3g}")
    del cpu
    log(f"[16 yolov3] raw head maps at B = 2, the card (TF32 off) against "
        f"the same model on the CPU: largest error {', '.join(errs)} of "
        f"max|ref| (limit 1e-4)")

    # COCO evaluation over phase 13's dataset, kernels vs plain
    img_dir, ann, _ = write_coco_dataset(tmp / "coco", SEED + 20)
    ds = CocoDetectionDataset(img_dir, ann)
    evals, found = {}, []
    orig = YOE.YoloPredictor.run_batch

    def counted(self, *a):
        res = orig(self, *a)
        found[-1] += int(res["valid"].sum())
        return res

    YOE.YoloPredictor.run_batch = counted
    try:
        for plain in (False, True):
            found.append(0)
            kernels.reset_launch_counts()
            with quiet(), exact_convs(), (kernels.force_plain() if plain
                                          else contextlib.nullcontext()):
                t0 = time.perf_counter()
                stats = YOE.evaluate_coco_boxes(pred, ds, progress=False)
                wall = time.perf_counter() - t0
            evals[plain] = ({"stats": stats}, kernels.launch_counts(), wall)
    finally:
        YOE.YoloPredictor.run_batch = orig
    (stats, counts, wall), plain_stats = evals[False], evals[True][0]
    batches = -(-len(ds) // YOLO_BATCH)
    if counts != {**{k: 0 for k in counts}, "nms": batches}:
        raise AssertionError(f"evaluate_coco_boxes launched {counts}")
    same = agree(stats, plain_stats, found[0], found[1],
                 "evaluate_coco_boxes")
    out["counts"]["yolov3_evaluate_coco_boxes"] = counts
    out["times"]["yolov3 evaluate_coco_boxes img/s"] = (len(ds) / wall,)
    log(f"[16 yolov3] evaluate_coco_boxes over {len(ds)} images at B = "
        f"{YOLO_BATCH}: launches {compact(counts)}, bbox AP "
        f"{stats['stats'][0]:.4f}; kernels vs plain (TF32 off, "
        f"deterministic cuDNN) {same}; {len(ds) / wall:.2f} img/s [{card}]")

    # training: YOLO_TRAIN_STEPS steps at B = 8 on the 832 canvas
    tds = CocoDetectionDataset(img_dir, ann, include_crowd=False)
    trainer = YOE.YoloTrainer(cfg, weights=str(weights), device=dev)
    host = yolo_train.train_batch(tds, tds.image_ids[:YOLO_BATCH],
                                  cfg.input_size)
    tb = [torch.from_numpy(a).to(dev) for a in host]
    before = {k: v.clone() for k, v in trainer.model.state_dict().items()}
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    # past the 1000-step burn-in: the step at the base lr, 1e-3
    losses = [trainer.train_step(*tb, YOE.BURN_IN + i)
              for i in range(YOLO_TRAIN_STEPS)]
    totals = [float(v["total"]) for v in losses]
    seconds = time.perf_counter() - t0
    counts = kernels.launch_counts()
    still, stale = moved(trainer.model, before)
    if any(counts.values()) or not np.isfinite(totals).all() or still or stale:
        raise AssertionError(f"YOLOv3 training launched {counts}; losses "
                             f"{totals}; still {still[:5]}; stale {stale[:5]}")
    out["counts"]["yolov3_training"] = counts
    log(f"[16 yolov3] YoloTrainer {YOLO_TRAIN_STEPS} steps at B = "
        f"{YOLO_BATCH} on the {tb[0].shape[1]}x{tb[0].shape[2]} canvas "
        f"({int((tb[3] >= 0).sum())} ground truths), f32 with TF32 "
        f"convolutions, train-mode BatchNorm, in {seconds:.1f} s: launches "
        f"{compact(counts)}; total losses {[round(v, 4) for v in totals]} "
        f"(last: " + ", ".join(f"{k} {float(v):.4f}" for k, v in
                                losses[-1].items()) + f"); all "
        f"{len(list(trainer.model.parameters()))} parameters moved, "
        f"{2 * sum(isinstance(m, torch.nn.BatchNorm2d) for m in trainer.model.modules())}"
        " running statistics updated")

    # the three CLIs on the card
    img0 = str(Path(img_dir) / "000000000001.png")
    res, counts, wall, _, text = run_cli(yolo_detect.main, [
        "--image", img0, "--weights", str(weights), "--conf_thres", "0.1",
        "--out", str(tmp / "yolo_detect.png")])
    if counts != {**{k: 0 for k in counts}, "nms": 1} or not len(
            res["scores"]) or not (tmp / "yolo_detect.png").exists():
        raise AssertionError(f"yolo_detect launched {counts}: {text[-300:]}")
    out["counts"]["cli_yolo_detect"] = counts
    log(f"[16 cli] yolo_detect --conf_thres 0.1 on a 640x480 image: "
        f"launches {compact(counts)}, {len(res['scores'])} detections, "
        f"drawn; {wall:.1f} s in main()")
    res, counts, wall, _, _ = run_cli(yolo_eval.main, [
        "--weights", str(weights), "--images", img_dir, "--annotations",
        ann, "--max_images", str(YOLO_CLI_EVAL_IMAGES)])
    want = -(-YOLO_CLI_EVAL_IMAGES // YOLO_BATCH)
    if counts != {**{k: 0 for k in counts}, "nms": want} or len(res) != 12:
        raise AssertionError(f"yolo_eval launched {counts}")
    out["counts"]["cli_yolo_eval"] = counts
    out["times"]["yolo_eval s/img"] = (wall / YOLO_CLI_EVAL_IMAGES,)
    log(f"[16 cli] yolo_eval --max_images {YOLO_CLI_EVAL_IMAGES}: launches "
        f"{compact(counts)}, bbox AP {res[0]:.4f}; {wall:.1f} s in main() "
        f"[{card}]")
    save = tmp / "yolov3.npz"
    losses, counts, wall, starts, _ = run_cli(yolo_train.main, [
        "--images", img_dir, "--annotations", ann, "--steps",
        str(CLI_TRAIN_STEPS), "--save", str(save)], YOE.YoloTrainer)
    if (any(counts.values()) or len(losses) != CLI_TRAIN_STEPS
            or not np.isfinite(losses).all()):
        raise AssertionError(f"yolo_train launched {counts}; losses {losses}")
    # read back strictly (no check of its detections: five train-mode steps
    # move the synthetic running statistics off what the layers produce)
    back = YOE.YoloPredictor(weights=str(save), device=dev)
    if back.run_batch(*yolo_canvas(imgs[:1]))["valid"].shape != (1,
                                                                cfg.max_det):
        raise AssertionError(f"{save.name} read back gives other shapes")
    gaps = np.diff(starts)
    out["counts"]["cli_yolo_train"] = counts
    out["times"]["yolo_train s/it"] = (float(np.median(gaps[1:])),)
    log(f"[16 cli] yolo_train --steps {CLI_TRAIN_STEPS} (B = 8, the 832 "
        f"canvas): launches {compact(counts)}; losses "
        f"{[round(v, 4) for v in losses]}; {save.name} read back by "
        f"YoloPredictor; {out['times']['yolo_train s/it'][0]:.3f} s/it, host "
        f"included (the median interval between steps' starts after the "
        f"first; all {[round(float(g), 3) for g in gaps]}) [{card}]")
    del back
    out["times"].update(time_yolo(preds, imgs, trainer, tb, card))
    label, t = time_nms_call(calls[torch.float32, YOLO_BATCH], "YOLOv3", card,
                             tag="16 timing")
    out["nms"][label] = t
    return out


def time_yolo(preds: dict, imgs: list, trainer, tb: list, card: str) -> dict:
    """The predictor's device pipeline (letterbox, DarkNet-53, decode,
    top-k, K1) at B = 1 and 8 in f32 and bf16 through both paths, its
    run_batch on the host clock (uploads and downloads included), and the
    training step at B = 8."""
    times = {}
    for dt, pred in preds.items():
        for b in (1, YOLO_BATCH):
            batch, hw = yolo_canvas(imgs[:b])
            x = torch.from_numpy(batch).to(pred.device)
            h = torch.from_numpy(hw).to(pred.device)
            with torch.inference_mode():
                k, p = time_pair(lambda: pred.detect(x, h), iters=5)
            pred.run_batch(batch, hw)
            t0 = time.perf_counter()
            for _ in range(3):
                pred.run_batch(batch, hw)
            wall = (time.perf_counter() - t0) / 3 * 1e3
            name = f"yolov3 forward {str(dt)[6:]} B={b}"
            times[name] = (k, p)
            times[f"yolov3 run_batch {str(dt)[6:]} B={b}"] = (wall,)
            log(f"[16 timing] YOLOv3-416 {str(dt)[6:]} B={b} (letterbox from "
                f"{batch.shape[1]}x{batch.shape[2]}, DarkNet-53, decode, "
                f"top-k, K1): kernels {1e3 * b / k:.2f} img/s ({k:.3f} ms), "
                f"plain {1e3 * b / p:.2f} img/s ({p:.3f} ms); run_batch "
                f"{1e3 * b / wall:.2f} img/s ({wall:.1f} ms on the host "
                f"clock, mean of 3) [{card}]")
    step = lambda: trainer.train_step(*tb, YOE.BURN_IN)  # noqa: E731
    ms = cuda_time_ms(step, iters=5, warmup=2)
    times[f"yolov3 train step B={YOLO_BATCH}"] = (ms,)
    log(f"[16 timing] YOLOv3 train step B={YOLO_BATCH} on the "
        f"{tb[0].shape[1]}x{tb[0].shape[2]} canvas (letterbox, forward, "
        f"loss, backward, SGD; TF32 convolutions; no kernel of the port): "
        f"{ms:.3f} ms ({1e3 * YOLO_BATCH / ms:.2f} img/s), mean of 5 "
        f"[{card}]")
    return times


def synthetic_vit_state_dict(cfg, seed: int) -> dict:
    """jeonsworld-keyed ViT weights from a numpy seed: conv and linear
    weights N(0, 1/fan_in), the class token and position embeddings
    N(0, 0.02^2), LayerNorm scales U(0.5, 1.5), biases and shifts
    N(0, 0.02^2)."""
    with torch.device("meta"):
        shapes = {k: tuple(t.shape)
                  for k, t in VIT.VisionTransformer(cfg).state_dict().items()}
    rng = np.random.default_rng(seed)
    sd = {}
    for k, shape in shapes.items():
        if len(shape) in (2, 4):
            a = rng.standard_normal(shape) / np.sqrt(np.prod(shape[1:]))
        elif k.endswith("norm.weight"):
            a = rng.uniform(0.5, 1.5, shape)
        else:
            a = rng.normal(0, 0.02, shape)
        sd[k] = torch.from_numpy(a.astype(np.float32))
    return sd


def google_vit_npz(sd: dict, cfg) -> dict:
    """A jeonsworld-keyed state_dict in google-research's vision_transformer
    npz layout (per-head query/key/value kernels [D, H, hd], out's
    [H, hd, D], [in, out] kernels, the patch kernel HWIO)."""
    d, h = cfg.hidden_size, cfg.num_heads
    g = {k: v.numpy() for k, v in sd.items()}
    pe = "transformer.embeddings."
    out = {"embedding/kernel": g[pe + "patch_embeddings.weight"].transpose(
               2, 3, 1, 0),
           "embedding/bias": g[pe + "patch_embeddings.bias"],
           "cls": g[pe + "cls_token"],
           "Transformer/posembed_input/pos_embedding":
               g[pe + "position_embeddings"],
           "Transformer/encoder_norm/scale":
               g["transformer.encoder.encoder_norm.weight"],
           "Transformer/encoder_norm/bias":
               g["transformer.encoder.encoder_norm.bias"],
           "head/kernel": g["head.weight"].T, "head/bias": g["head.bias"]}
    for i in range(cfg.num_layers):
        src = f"transformer.encoder.layer.{i}."
        dst = f"Transformer/encoderblock_{i}/"
        for s, t in (("attention_norm", "LayerNorm_0"),
                     ("ffn_norm", "LayerNorm_2")):
            out[f"{dst}{t}/scale"] = g[f"{src}{s}.weight"]
            out[f"{dst}{t}/bias"] = g[f"{src}{s}.bias"]
        mha = dst + "MultiHeadDotProductAttention_1/"
        for name in ("query", "key", "value"):
            out[f"{mha}{name}/kernel"] = g[f"{src}attn.{name}.weight"].T \
                .reshape(d, h, d // h)
            out[f"{mha}{name}/bias"] = g[f"{src}attn.{name}.bias"].reshape(
                h, d // h)
        out[f"{mha}out/kernel"] = g[f"{src}attn.out.weight"].T.reshape(
            h, d // h, d)
        out[f"{mha}out/bias"] = g[f"{src}attn.out.bias"]
        for j, fc in enumerate(("fc1", "fc2")):
            out[f"{dst}MlpBlock_3/Dense_{j}/kernel"] = g[
                f"{src}ffn.{fc}.weight"].T
            out[f"{dst}MlpBlock_3/Dense_{j}/bias"] = g[f"{src}ffn.{fc}.bias"]
    return out


def vit_images(rng: np.random.Generator, b: int, size: int) -> torch.Tensor:
    return torch.from_numpy(rng.integers(0, 256, (b, size, size, 3)).astype(
        np.uint8))


def phase_vit(dev, tmp: Path, card: str) -> dict:
    """Phase 16, ViT-B/16 at full width, weights from a numpy seed written
    as a jeonsworld .pth and a google-research .npz: the classifier and
    forwards at B = 1 and 32 (no kernel launched), card vs CPU, training,
    the two CLIs, timings."""
    from tpuseg_torch.tools import vit_infer, vit_train
    from tpuseg_torch.weights.from_jax import vit_state_dict_from_jax
    from tpuseg_torch.weights.npz_io import load_params_npz

    vcfg = VC.config_to_vit(get_config(VIT_CONFIG))
    sd = synthetic_vit_state_dict(vcfg, SEED + 50)
    pth, npz = tmp / "vit.pth", tmp / "vit.npz"
    torch.save(sd, pth)
    np.savez(npz, **google_vit_npz(sd, vcfg))
    for path in (pth, npz):
        got = VC.load_vit_weights(str(path), vcfg)
        if got.keys() != sd.keys() or not all(
                torch.equal(got[k], v) for k, v in sd.items()):
            raise AssertionError(f"{path.name}: load_vit_weights differs")
    out = {"counts": {}, "times": {}}
    rng = np.random.default_rng(SEED + 51)
    clf = VC.ViTClassifier(VIT_CONFIG, str(npz), device=dev)
    img = textured_image(rng, 375, 500)
    kernels.reset_launch_counts()
    ids, probs = clf.run_on_image(img)
    forwards = {}
    with torch.inference_mode():
        for b in (1, VIT_BATCH):
            forwards[b] = clf.forward(vit_images(rng, b, vcfg.image_size).to(
                dev))
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    if (any(counts.values()) or not np.isfinite(probs).all()
            or not np.all(np.diff(probs) <= 0)
            or not all(torch.isfinite(v).all() for v in forwards.values())):
        raise AssertionError(f"ViT inference launched {counts}; top-5 {ids} "
                             f"{probs}")
    out["counts"]["vit_inference"] = counts
    log(f"[16 vit] load_vit_weights reads the .pth and the google .npz to "
        f"the same tensors; ViTClassifier.run_on_image on a 375x500 image: "
        f"top-5 {ids.tolist()} at {[round(float(p), 4) for p in probs]}; "
        f"forwards at B = 1 and {VIT_BATCH}: logits "
        f"{tuple(forwards[VIT_BATCH].shape)}, finite; launches "
        f"{compact(counts)}")
    x = VIT_PRE(vit_images(rng, 2, vcfg.image_size), size=vcfg.image_size)
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.inference_mode(), exact_convs():
            card_logits = clf.model(x.to(dev)).cpu()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    cpu = VC.build_vit(vcfg, state_dict=sd).eval()
    with torch.inference_mode():
        want = cpu(x)
    del cpu
    err = float((card_logits - want).abs().max()) / float(want.abs().max())
    if err > 1e-4:
        raise AssertionError(f"ViT logits: card vs CPU {err:.3g} of max|ref|")
    log(f"[16 vit] logits at B = 2, the card (TF32 off) against the same "
        f"model on the CPU: largest error {err:.3g} of max|ref| (limit 1e-4)")

    trainer = VT.ViTTrainer(vcfg, lr_fn=lambda it: VIT_LR, state_dict=sd,
                            device=dev)
    images = VIT_PRE(vit_images(rng, VIT_BATCH, vcfg.image_size).to(dev),
                     size=vcfg.image_size)
    labels = torch.from_numpy(rng.integers(0, vcfg.num_classes, VIT_BATCH))
    before = {k: v.clone() for k, v in trainer.model.state_dict().items()}
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    metrics = [trainer.train_step(images, labels, i)
               for i in range(VIT_TRAIN_STEPS)]
    seconds = time.perf_counter() - t0
    counts = kernels.launch_counts()
    losses = [float(m["loss"]) for m in metrics]
    still, _ = moved(trainer.model, before)
    if any(counts.values()) or not np.isfinite(losses).all() or still:
        raise AssertionError(f"ViT training launched {counts}; losses "
                             f"{losses}; still {still[:5]}")
    out["counts"]["vit_training"] = counts
    log(f"[16 vit] ViTTrainer {VIT_TRAIN_STEPS} steps at B = {VIT_BATCH}, "
        f"lr {VIT_LR}, in {seconds:.1f} s: launches {compact(counts)}; "
        f"losses {[round(v, 4) for v in losses]}; all "
        f"{len(list(trainer.model.parameters()))} parameters moved")

    img_path = tmp / "vit_image.png"
    from PIL import Image

    Image.fromarray(img).save(img_path)
    (ids2, _), counts, wall, _, _ = run_cli(vit_infer.main, [
        "--image", str(img_path), "--weights", str(pth)])
    if any(counts.values()) or list(ids2) != list(ids):
        raise AssertionError(f"vit_infer launched {counts}, top-5 {ids2}")
    out["counts"]["cli_vit_infer"] = counts
    log(f"[16 cli] vit_infer with the .pth: launches {compact(counts)}, the "
        f"classifier's top-5; {wall:.1f} s in main()")
    save = tmp / "vit_finetuned.npz"
    metrics, counts, wall, starts, _ = run_cli(vit_train.main, [
        "--steps", str(CLI_TRAIN_STEPS), "--save", str(save)], VT.ViTTrainer)
    losses = [m["loss"] for m in metrics]
    if any(counts.values()) or not np.isfinite(losses).all():
        raise AssertionError(f"vit_train launched {counts}; losses {losses}")
    VC.build_vit(vcfg, vit_state_dict_from_jax(load_params_npz(str(save))))
    gaps = np.diff(starts)
    out["counts"]["cli_vit_train"] = counts
    out["times"]["vit_train s/it"] = (float(np.median(gaps[1:])),)
    log(f"[16 cli] vit_train --steps {CLI_TRAIN_STEPS} (synthetic, B = "
        f"{VIT_BATCH}): launches {compact(counts)}; losses "
        f"{[round(v, 4) for v in losses]}; {save.name} read back strictly; "
        f"{out['times']['vit_train s/it'][0]:.3f} s/it, host included (all "
        f"{[round(float(g), 3) for g in gaps]}) [{card}]")

    for b in (1, VIT_BATCH):
        xb = VIT_PRE(vit_images(rng, b, vcfg.image_size).to(dev),
                     size=vcfg.image_size)
        with torch.inference_mode():
            ms = cuda_time_ms(lambda: clf.model(xb), iters=10)
        out["times"][f"vit forward B={b}"] = (ms,)
        log(f"[16 timing] ViT-B/16 forward f32 B={b} (TF32 convolutions, f32 "
            f"matmuls, no kernel of the port): {1e3 * b / ms:.2f} img/s "
            f"({ms:.3f} ms), mean of 10 [{card}]")
    ms = cuda_time_ms(lambda: trainer.train_step(images, labels, 0), iters=5,
                      warmup=2)
    out["times"][f"vit train step B={VIT_BATCH}"] = (ms,)
    log(f"[16 timing] ViT-B/16 train step B={VIT_BATCH} (forward, backward, "
        f"SGD): {ms:.3f} ms ({1e3 * VIT_BATCH / ms:.2f} img/s), mean of 5 "
        f"[{card}]")
    return out


# ---------------------------------------------------------------------------
# phase 17: bf16 mixed precision, YOLACT-550 DarkNet53-FPN, the npz writers
# ---------------------------------------------------------------------------

BF16 = torch.bfloat16
# the detectron models of the bf16 inference: Mask R-CNN R-50-FPN and phase
# 14's three, each from its yaml
BF16_FAMILY = {"maskrcnn": "e2e_mask_rcnn_R_50_FPN_1x.yaml", **FAMILY}
# the bf16 steps, kernels vs plain, per gradient in relative L2: ten times
# the larger spread of either path between its own two runs, at least one
# bf16 rounding (the backward kernels' f32 sums agree with the plain
# versions' to f32 rounding, and each is rounded to bf16 once: where the
# two round apart, an element differs by 2^-8 of itself), at most the cap
BF16_STEP_FLOOR = 2.0 ** -8
BF16_STEP_CAP = 1e-2
BF16_TRAIN_MODE_CAP = 1e-1  # YOLACT++'s train-mode BatchNorm magnifies it


def check_roi_calls(calls: list) -> str:
    """Each recorded multilevel_roi_align call against the plain version on
    its own inputs: equal bit for bit -> its shapes, in call order."""
    labels = []
    for args, kwargs, out in calls:
        with kernels.force_plain():
            want = sampling.multilevel_roi_align(*args, **kwargs)
        label = (f"{str(out.dtype)[6:]} N={out.shape[0]} "
                 f"P={out.shape[-1]}")
        if not torch.equal(out, want):
            raise AssertionError(f"RoIAlign {label}: differs from the plain "
                                 f"version by {float((out - want).abs().max())}")
        labels.append(label)
    return ", ".join(labels)


def box_agreement(got: list, want: list) -> str:
    """bf16 detections against f32 ones, per image: how many match one of
    the same class at IoU >= 0.5 (greedy, best first) and the largest box
    coordinate difference of a match (information, not a gate)."""
    out = []
    for g, w in zip(got, want):
        used, matched, worst = set(), 0, 0.0
        wb = w["boxes"]
        w_area = (wb[:, 2] - wb[:, 0] + 1) * (wb[:, 3] - wb[:, 1] + 1)
        for i in np.argsort(-g["scores"], kind="stable"):
            b = g["boxes"][i]
            ix = (np.minimum(b[2], wb[:, 2]) - np.maximum(b[0], wb[:, 0])
                  + 1).clip(0)
            iy = (np.minimum(b[3], wb[:, 3]) - np.maximum(b[1], wb[:, 1])
                  + 1).clip(0)
            area = (b[2] - b[0] + 1) * (b[3] - b[1] + 1)
            iou = ix * iy / (area + w_area - ix * iy)
            iou[(w["classes"] != g["classes"][i])
                | np.isin(np.arange(len(iou)), list(used))] = 0
            j = int(np.argmax(iou)) if len(iou) else -1
            if j >= 0 and iou[j] >= 0.5:
                used.add(j)
                matched += 1
                worst = max(worst, float(np.abs(w["boxes"][j] - b).max()))
        out.append(f"{matched}/{len(g['scores'])} of {len(w['scores'])} "
                   f"(box err {worst:.3g} px)")
    return "; ".join(out)


def npz_reads_back(path: Path, read, state_dict: dict) -> int:
    """An npz of a JAX tree read back through the port's reader and
    ``read`` (a *_state_dict_from_jax): every tensor of ``state_dict`` equal
    (BatchNorm's step counters, which the JAX tree has not, aside) -> the
    arrays in the file."""
    back = read(load_params_npz(str(path)))
    want = {k: v.detach().cpu().float() for k, v in state_dict.items()
            if not k.endswith("num_batches_tracked")}
    got = {k: v for k, v in back.items()
           if not k.endswith("num_batches_tracked")}
    if got.keys() != want.keys() or not all(torch.equal(got[k], v)
                                            for k, v in want.items()):
        raise AssertionError(f"{path.name}: the npz does not read back to "
                             "the state_dict")
    with np.load(path) as f:
        return len(f.files)


def npz_round_trip(path: Path, tree: dict, read, state_dict: dict) -> int:
    """``tree`` written by the port's save_params_npz, then
    :func:`npz_reads_back`."""
    save_params_npz(str(path), tree)
    return npz_reads_back(path, read, state_dict)


def bf16_family_inference(name: str, dev, tmp: Path, card: str) -> dict:
    """build_predictor_from_cfg(dtype=bf16) on the yaml with phase 14's
    calibrated synthetic weights: launches per forward at B = 1 and 2, sane
    detections in f32, every K1 and K2 call of the path equal to its plain
    version on its inputs, the heads on one bf16 pyramid through the
    kernels and the plain versions detection for detection; the agreement
    with the f32 predictor (information); the model's JAX tree through the
    npz writer; the bf16 forward timed beside the f32 one."""
    from tpuseg_torch.kernels import roi_align as roi_kernel

    yaml = BF16_FAMILY[name]
    _, cfg = ME.model_config_from_node(family_node(yaml))
    mod = ME.model_module(cfg)
    sd, calib = family_state_dict(name, cfg, dev, train=False)
    ckpt = tmp / f"bf16_{yaml[:-5]}.pth"
    torch.save({"model": sd}, ckpt)
    preds = {dt: ME.build_predictor_from_cfg(
        family_node(yaml, str(ckpt)), device=dev, dtype=dt)
        for dt in (torch.float32, BF16)}
    pred = preds[BF16]
    masks = getattr(cfg, "mask_on", False)
    landscape, _ = synthetic_images(SEED)
    want = expected_launches(cfg)[0]
    counts, dets = {}, []
    with recording_nms() as nms_calls, \
            recording_calls(sampling, "multilevel_roi_align") as roi_calls:
        for b in (1, 2):  # the B = 2 results stay in ``res``
            kernels.reset_launch_counts()
            res = pred.run_on_bgr_images(landscape[:b])
            torch.cuda.synchronize()
            counts[b] = kernels.launch_counts()
            dets += [check_result(r, *img.shape[:2], masks=masks)
                     for r, img in zip(res, landscape)]
    if counts[1] != want or counts[2] != want:
        raise AssertionError(f"bf16 {name}: launches {counts} per forward at "
                             f"B = 1 and 2; want {want}")
    if min(dets) == 0:
        raise AssertionError(f"bf16 {name}: no detections: {dets}")
    images, image_hw = canvas_batch(pred, landscape)
    with torch.inference_mode():
        out = pred.forward(images, image_hw)
    wrong = [k for k, v in out.items()
             if v.is_floating_point() and v.dtype != torch.float32]
    if wrong:
        raise AssertionError(f"bf16 {name}: outputs not f32: {wrong}")
    if any(p.dtype != BF16 for p in pred.model.parameters()):
        raise AssertionError(f"bf16 {name}: the model is not bf16")
    with exact_convs(), torch.inference_mode():
        feats = pred.model.backbone(images.to(BF16))
        with recording_calls(roi_kernel, "multilevel_roi_align") as k2:
            got = mod.forward_heads(pred.model, feats, image_hw, CANVAS)
        with kernels.force_plain():
            ref = mod.forward_heads(pred.model, feats, image_hw, CANVAS)
        torch.cuda.synchronize()
    agreement = box_agreement(res, preds[torch.float32].run_on_bgr_images(
        landscape))
    model32 = preds[torch.float32].model
    read = {"c4": FJ.c4_state_dict_from_jax,
            "retinanet": FJ.retinanet_state_dict_from_jax}.get(
        ME.variant_of(cfg), lambda t: FJ.state_dict_from_jax(t, cfg))
    n_npz = npz_round_trip(tmp / f"{name}.npz", TL.jax_tree(model32), read,
                           model32.state_dict())
    log(f"[17 bf16 {name}] build_predictor_from_cfg({yaml}, dtype=bf16), "
        f"{calib}: launches {want} per forward at B = 1 and 2; detections "
        f"{dets}, outputs f32; its NMS calls (kept/valid) equal the plain "
        f"version bit for bit: {check_nms_calls(nms_calls)}; its RoIAlign "
        f"calls equal bit for bit: {check_roi_calls(roi_calls) or 'none'}; "
        f"heads on one bf16 pyramid, kernels vs plain (TF32 off): "
        f"{compare_heads(got, ref)}; against the f32 predictor (not a "
        f"gate): matched {agreement}; npz writer: {n_npz} arrays read back "
        f"equal")

    times = {}
    with torch.inference_mode():
        for b in (1, 2):
            x, hw = images[:b], image_hw[:b]
            k, p = time_pair(lambda: pred.forward(x, hw), iters=5)
            f32 = cuda_time_ms(lambda: preds[torch.float32].forward(x, hw),
                               iters=5)
            times[f"bf16 {name} forward B={b}"] = (k, p, f32)
            log(f"[17 timing] {name} forward bf16 B={b} "
                f"{CANVAS[0]}x{CANVAS[1]}: kernels {1e3 * b / k:.2f} img/s "
                f"({k:.3f} ms), plain {1e3 * b / p:.2f} img/s ({p:.3f} ms); "
                f"f32 kernels {1e3 * b / f32:.2f} img/s ({f32:.3f} ms) "
                f"[{card}]")
    return {"counts": counts[2], "times": times,
            "k2": [(a, "forward") for a, _, _ in k2]}


def bf16_step_grads(model, fn, *args) -> tuple:
    """Losses and parameter gradients of ``fn(model, *args)`` (a training
    forward) on the bf16 cast of the model, and its backward."""
    model.zero_grad(set_to_none=True)
    losses = call_in_dtype(model, BF16, fn, *args)
    losses["total"].backward()
    grads = {n: p.grad.detach().clone() for n, p in model.named_parameters()
             if p.grad is not None}
    model.zero_grad(set_to_none=True)
    return {k: float(v.detach()) for k, v in losses.items()}, grads


def check_f32_masters(model, what: str) -> None:
    bad = [n for n, t in [*model.named_parameters(), *model.named_buffers()]
           if t.is_floating_point() and t.dtype != torch.float32]
    if bad:
        raise AssertionError(f"{what}: master tensors not f32: {bad[:3]}")


def bf16_maskrcnn_train(dev, tmp: Path, card: str) -> dict:
    """do_train(compute_dtype=bf16) of Mask R-CNN R-50-FPN for TRAIN_STEPS
    iterations at B = 2 on the 800x1344 canvas (phase 9's weights and
    data): launches per step (K2 and K3 in bf16), finite losses, the
    masters f32, the frozen stages still and the rest moved, the
    checkpoint's .pth and .npz read back; one step through the kernels
    and the plain versions (two runs each) by relative L2 per gradient
    (BF16_STEP_FLOOR, BF16_STEP_CAP); the bf16 step timed beside the f32
    one."""
    from tpuseg_torch.kernels import roi_align as roi_kernel

    cfg = M.MaskRCNNConfig()
    model = M.build_model(cfg)
    sd = synthetic_state_dict(model, SEED + 7)
    sd["backbone.body.stem.bn1.running_var"] *= PIXEL_VAR
    model.load_state_dict(sd, strict=True)
    data = SyntheticDataset(SEED + 7)
    model = model.to(dev)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    out_dir = tmp / "bf16_maskrcnn"
    kernels.reset_launch_counts()
    with quiet():
        model, it, history = TL.do_train(
            data, cfg, model=model, max_steps=TRAIN_STEPS, ims_per_batch=2,
            checkpoint_period=TRAIN_STEPS, log_every=TRAIN_STEPS,
            output_dir=str(out_dir), device=dev, compute_dtype=BF16)
        torch.cuda.synchronize()
    counts = kernels.launch_counts()
    want = {k: TRAIN_STEPS * v for k, v in PER_STEP.items()}
    if it != TRAIN_STEPS or counts != want:
        raise AssertionError(f"bf16 Mask R-CNN: {it} iterations launched "
                             f"{counts}; want {want}")
    if not all(np.isfinite(v) for h in history for v in h.values()):
        raise AssertionError(f"bf16 Mask R-CNN: losses not finite: {history}")
    check_f32_masters(model, "bf16 Mask R-CNN")
    frozen, trainable = check_moved(model, before, "bf16 Mask R-CNN")
    ckpt = out_dir / f"model_{TRAIN_STEPS:07d}"
    M.build_model(cfg).load_state_dict(torch.load(
        f"{ckpt}.pth", weights_only=True)["model"], strict=True)
    n_npz = npz_round_trip(Path(f"{ckpt}.npz"), TL.jax_tree(model),
                           lambda t: FJ.state_dict_from_jax(t, cfg),
                           model.state_dict())
    log(f"[17 bf16 train] do_train(compute_dtype=bf16) {it} iterations at "
        f"B = 2 on {CANVAS[0]}x{CANVAS[1]}: launches {counts} ({PER_STEP} "
        f"per step); total loss {[round(h['total'], 4) for h in history]}; "
        f"masters f32; {len(frozen)} frozen tensors still, {len(trainable)} "
        f"trainable moved; model_{TRAIN_STEPS:07d}.pth loads strict, its "
        f".npz ({n_npz} arrays) reads back equal")

    rng = np.random.default_rng(SEED + 8)
    batch = TL.batch_to_device([TL.build_train_example(data, i, rng=rng)
                                for i in data.image_ids[:2]], dev)
    images, image_hw, targets = batch

    def grads():
        gen = torch.Generator(device=dev).manual_seed(SEED + 9)
        return bf16_step_grads(model, TL.train_losses, images.to(BF16),
                               image_hw, targets, gen)

    with exact_convs():
        kernels.reset_launch_counts()
        with recording_calls(roi_kernel, "multilevel_roi_align") as k2, \
                recording_calls(roi_kernel,
                                "multilevel_roi_align_backward") as k3:
            runs = [grads()]
        path_counts = kernels.launch_counts()
        runs.append(grads())
        with kernels.force_plain():
            runs += [grads() for _ in range(2)]
        torch.cuda.synchronize()
    if path_counts != PER_STEP:
        raise AssertionError(f"bf16 Mask R-CNN kernel-path step launched "
                             f"{path_counts}")
    log(f"[17 bf16 train] one bf16 step, kernels vs plain (TF32 off, "
        f"deterministic cuDNN; relative L2 within ten times either path's "
        f"own spread, at least {BF16_STEP_FLOOR:g}, at most "
        f"{BF16_STEP_CAP:g}): " + compare_train_mode(
            *runs, floor=BF16_STEP_FLOOR, cap=BF16_STEP_CAP, what="bf16"))
    times = {}
    for dt in (None, BF16):
        label = "bf16" if dt else "f32"
        times[f"maskrcnn train step {label} B=2"] = time_train_step(
            model, batch, f"[17 timing] Mask R-CNN train step {label}", card,
            compute_dtype=dt)
    return {"counts": counts, "times": times,
            "k2": [(a, "training") for a, _, _ in k2],
            "k3": [a for a, _, _ in k3]}


def bf16_yolact_train(dev, tmp: Path, card: str) -> dict:
    """yolact_train_loop.train(compute_dtype=bf16) of YOLACT++-550 R-50 at
    B = 8 (train-mode BatchNorm; phase 11's weights and data): 13 K4 + 13
    K4c launches per step in bf16, finite losses, the masters f32, every
    parameter moved, every f32 running statistic updated, the npz
    checkpoint read back; one step, kernels vs plain (two runs each), by
    relative L2 per gradient within ten times either path's own spread
    between its runs, bounded by BF16_STEP_FLOOR and BF16_TRAIN_MODE_CAP;
    the bf16 step timed beside the f32 one."""
    from tpuseg_torch.kernels import dcn as dcn_kernel

    name = "yolact_plus_resnet50"
    cfg, loss_cfg = yolact_model_config(name), yolact_loss_config(name)
    model = YM.build_model(cfg)
    model.load_state_dict(synthetic_yolact_state_dict(
        model, SEED + 11, offset_scale=TRAIN_OFFSET_SCALE), strict=True)
    data = SyntheticYolactDataset(SEED + 11)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    kernels.reset_launch_counts()
    with quiet():
        model, it, history = YTL.train(
            data, cfg, batch_size=YOLACT_BATCH,
            max_steps=YOLACT_TRAIN_STEPS, save_every=YOLACT_TRAIN_STEPS,
            save_folder=str(tmp / "bf16_yolact"), cfg_name=name,
            log_every=YOLACT_TRAIN_STEPS, loss_cfg=loss_cfg, model=model,
            device=dev, save_format="npz", compute_dtype=BF16)
        torch.cuda.synchronize()
    counts = kernels.launch_counts()
    want = {k: YOLACT_TRAIN_STEPS * v for k, v in YOLACT_PER_STEP.items()}
    if it != YOLACT_TRAIN_STEPS or counts != want:
        raise AssertionError(f"bf16 YOLACT++: {it} iterations launched "
                             f"{counts}; want {want}")
    if not all(np.isfinite(v) for h in history for v in h.values()):
        raise AssertionError(f"bf16 YOLACT++: losses not finite: {history}")
    check_f32_masters(model, "bf16 YOLACT++")
    after = {k: v.cpu() for k, v in model.state_dict().items()}
    still = [n for n, _ in model.named_parameters()
             if torch.equal(after[n], before[n])]
    stats = [k for k in after if k.endswith(("running_mean", "running_var"))]
    stale = [k for k in stats if torch.equal(after[k], before[k])]
    if still or stale or model.freeze_bn:
        raise AssertionError(f"bf16 YOLACT++: parameters that did not move: "
                             f"{still}; running statistics not updated: "
                             f"{stale}")
    path = Path(ckpt_path(str(tmp / "bf16_yolact"), name,
                          it // (len(data.image_ids) // YOLACT_BATCH), it,
                          "npz"))
    n_npz = npz_reads_back(
        path, lambda t: FJ.yolact_state_dict_from_jax(t, cfg), after)
    n_params = sum(1 for _ in model.parameters())
    log(f"[17 bf16 yolact_train] train(compute_dtype=bf16) {it} iterations "
        f"at B = {YOLACT_BATCH}, {cfg.img_size}x{cfg.img_size}, train-mode "
        f"BatchNorm: launches {counts}; losses "
        + "; ".join(", ".join(f"{k} {v:.4g}" for k, v in h.items())
                    for h in history)
        + f"; masters f32, all {n_params} parameters moved, {len(stats)} "
        f"f32 running statistics updated; "
        f"{path.name} ({n_npz} arrays) reads back equal")

    rng = np.random.default_rng(SEED + 12)
    images, targets = YTL.batch_to_device(
        *next(YTL.batch_iterator(data, cfg, rng, YOLACT_BATCH)), dev)
    priors = torch.from_numpy(YM.make_priors_np(cfg)).to(dev)
    draws = torch.rand((YOLACT_BATCH, priors.shape[0]), device=dev,
                       generator=torch.Generator(device=dev).manual_seed(
                           SEED + 13))

    def grads():
        return bf16_step_grads(model, YTL.train_losses, images.to(BF16),
                               targets, priors, draws, loss_cfg, BF16)

    # the DCNs' biases: each DCN feeds a train-mode BatchNorm, whose batch
    # mean cancels a per-channel bias (the backbone's other convs have none)
    dcn_biases = [n for n, _ in model.named_parameters()
                  if n.startswith("backbone.") and n.endswith("conv2.bias")]

    with exact_convs():
        kernels.reset_launch_counts()
        with recording_calls(dcn_kernel, "sample_points") as k4, \
                recording_calls(dcn_kernel, "sample_points_backward") as k4c:
            runs = [grads()]
        path_counts = kernels.launch_counts()
        runs.append(grads())
        with kernels.force_plain():
            runs += [grads() for _ in range(2)]
        torch.cuda.synchronize()
    if path_counts != YOLACT_PER_STEP:
        raise AssertionError(f"bf16 YOLACT++ kernel-path step launched "
                             f"{path_counts}")
    log(f"[17 bf16 yolact_train] one bf16 step, train-mode BatchNorm, "
        f"kernels vs plain (TF32 off, deterministic cuDNN; relative L2 "
        f"within ten times either path's own spread, at least "
        f"{BF16_STEP_FLOOR:g}, at most {BF16_TRAIN_MODE_CAP:g}): "
        + compare_train_mode(*runs, floor=BF16_STEP_FLOOR,
                             cap=BF16_TRAIN_MODE_CAP, what="bf16 train-mode",
                             cancelled=dcn_biases))
    times = {}
    for dt in (None, BF16):
        opt = make_yolact_optimizer(model)
        lr = yolact_lr_schedule()(0)

        def step():
            YTL.train_step(model, opt, lr, images, targets, priors, draws,
                           loss_cfg, dt)

        k1 = cuda_time_ms(step, iters=5, warmup=2)
        with kernels.force_plain():
            p = cuda_time_ms(step, iters=2, warmup=1)
        k2 = cuda_time_ms(step, iters=5, warmup=0)
        k = (k1 + k2) / 2
        label = "bf16" if dt else "f32"
        times[f"yolact train step {label} B={YOLACT_BATCH}"] = (k, p)
        log(f"[17 timing] YOLACT++ train step {label} B={YOLACT_BATCH} "
            f"{cfg.img_size}x{cfg.img_size}: kernels {k:.3f} ms "
            f"({1e3 * YOLACT_BATCH / k:.2f} img/s; two runs of 5: "
            f"{k1:.3f}, {k2:.3f}), plain {p:.3f} ms [{card}]")
    return {"counts": counts, "times": times,
            "k4": [a for a, _, _ in k4],
            "k4c": [a for a, _, _ in k4c]}


def darknet_yolact(dev, tmp: Path, card: str) -> dict:
    """YOLACT-550 DarkNet53-FPN through YolactPredictor, f32 and bf16, B =
    1 and 8, on synthetic upstream-keyed weights (no launch: no DCN, and
    Fast-NMS is torch); the raw predictions on the card against the same
    model on the CPU (TF32 off, 1e-4 of max|ref|); one bf16 yolact_train
    step of the preset through its CLI on a COCO dataset on disk, its npz
    checkpoint read back; the forward and run_batch timed."""
    from tpuseg_torch.tools import yolact_train

    name = "yolact_darknet53"
    cfg = yolact_model_config(name)
    model = YM.build_model(cfg)
    model.load_state_dict(synthetic_yolact_state_dict(model, SEED + 41),
                          strict=True)
    images = yolact_images(SEED + 41, 8, cfg.img_size)
    x = yolact_preprocess(torch.from_numpy(images).to(dev), cfg.img_size)
    model = model.to(dev)
    shift = calibrate_yolact_gate(model, x, want=(10, 500), margin=0.0)
    sd = {k: v.cpu() for k, v in model.state_dict().items()}
    del model
    preds = {dt: YolactPredictor(cfg, state_dict=sd, batch_size=8, dtype=dt,
                                 device=dev)
             for dt in (torch.float32, BF16)}
    lines, none = [], per({})
    for dt, pred in preds.items():
        for b in (1, 8):
            kernels.reset_launch_counts()
            det = pred.run_batch(images[:b])
            torch.cuda.synchronize()
            if kernels.launch_counts() != none:
                raise AssertionError(f"DarkNet YOLACT {dt} B={b} launched "
                                     f"{kernels.launch_counts()}")
            lines.append(f"{str(dt)[6:]} B={b}: detections "
                         f"{check_yolact(pred, det, b)}")
    with exact_convs(), torch.inference_mode():
        card_preds = {k: v.float().cpu()
                      for k, v in preds[torch.float32].model(x[:1]).items()}
        bf16_preds = {k: v.float().cpu()
                      for k, v in preds[BF16].model(x[:1].to(BF16)).items()}
    cpu = YM.build_model(cfg)
    cpu.load_state_dict(sd, strict=True)
    with torch.inference_mode():
        ref = cpu(x[:1].cpu())
    del cpu
    errs, bf16_errs = {}, {}
    for k, w in ref.items():
        scale = float(w.abs().max())
        errs[k] = float((card_preds[k] - w).abs().max()) / scale
        bf16_errs[k] = float((bf16_preds[k] - w).abs().max()) / scale
        if not errs[k] <= 1e-4:
            raise AssertionError(f"DarkNet YOLACT {k}: card vs CPU "
                                 f"{errs[k]:.3g} of max|ref|")
    img_dir, ann, _ = write_coco_dataset(tmp / "coco", SEED + 20)
    save = tmp / "darknet_ckpt"
    history, launched, wall, _, _ = run_cli(yolact_train.main, [
        "--config", f"{name}_config", "--train_images", img_dir,
        "--train_info", ann, "--batch_size", str(YOLACT_BATCH),
        "--max_steps", "1", "--save_interval", "1", "--save_folder",
        str(save), "--save_format", "npz", "--compute_dtype", "bfloat16",
        "--device", "cuda"])
    if len(history) != 1 or not all(np.isfinite(v)
                                    for v in history[0].values()):
        raise AssertionError(f"yolact_train DarkNet bf16: {history}")
    if launched != none:
        raise AssertionError(f"yolact_train DarkNet launched {launched}")
    written = list(save.glob(f"{name}_*_1.npz"))
    fresh = YM.build_model(cfg)
    fresh.load_state_dict(FJ.yolact_state_dict_from_jax(
        load_params_npz(str(written[0])), cfg), strict=True)
    log(f"[17 darknet] YolactPredictor, {name} at {cfg.img_size}x"
        f"{cfg.img_size} (background logit +{shift:.2f}): no launch; "
        + "; ".join(lines)
        + "; raw predictions, card vs CPU, f32 B=1 (TF32 off): "
        + ", ".join(f"{k} {v:.3g}" for k, v in errs.items())
        + " of max|ref|; bf16 vs the CPU's f32 (not a gate): "
        + ", ".join(f"{k} {v:.3g}" for k, v in bf16_errs.items())
        + f"; yolact_train --config {name}_config --compute_dtype bfloat16 "
        f"B={YOLACT_BATCH}: losses "
        + ", ".join(f"{k} {v:.4g}" for k, v in history[0].items())
        + f" in {wall:.1f} s, {written[0].name} loads strict")
    times = {}
    with torch.inference_mode():
        raw = torch.from_numpy(images).to(dev)
        for dt, pred in preds.items():
            for b in (1, 8):
                xb = x[:b].to(dt)
                for label, fn in (("forward", lambda: pred.model(xb)),
                                  ("run_batch",
                                   lambda: pred.run_batch(raw[:b]))):
                    t = cuda_time_ms(fn, iters=5)
                    times[f"darknet yolact {label} {str(dt)[6:]} B={b}"] = (t,)
                    log(f"[17 timing] YOLACT DarkNet-53 {label} "
                        f"{str(dt)[6:]} B={b} {cfg.img_size}x{cfg.img_size}: "
                        f"{1e3 * b / t:.2f} img/s ({t:.3f} ms) [{card}]")
    return {"counts": {"darknet_yolact_inference": none,
                       "cli_yolact_train_darknet_bf16": launched},
            "times": times}


def bf16_kernel_shapes(k2: list, k3: list, k4: list, k4c: list,
                       card: str) -> dict:
    """The bf16 kernels at the bf16 paths' own inputs (the arguments the
    paths gave the wrappers), one per distinct shape: K2 and K4 equal to
    their plain versions bit for bit, K3 and K4c within phase 5's and 7's
    bf16 tolerances of the plain version in f32; timed against the plain
    version and the launch alone, with the bound and the library call ->
    {kernel: {label: (ms, plain, bound, by, library, alone)}}."""
    from tpuseg_torch.kernels import dcn as dcn_kernel
    from tpuseg_torch.kernels import roi_align as roi_kernel

    out = {"roi_align": {}, "roi_align_bwd": {}, "dcn_sample": {},
           "dcn_sample_bwd": {}}
    # the forward kernels on inference tensors; the backward ones outside
    # inference mode, where grid_sample's backward can build its graph
    with torch.inference_mode():
        for args, path in k2:
            feats, boxes, bidx, levels, p = args[:5]
            label = (f"bf16 N={boxes.shape[0]} P={p}: Mask R-CNN FPN "
                     f"{path}")
            if not torch.equal(roi_kernel.multilevel_roi_align(*args),
                               sampling.multilevel_roi_align_plain(*args)):
                raise AssertionError(f"roi_align {label}: not equal")
            k, pl = time_pair(lambda: sampling.multilevel_roi_align(*args),
                              iters=10)
            alone = cuda_time_ms(lambda: roi_kernel.multilevel_roi_align(
                *args), 10)
            out["roi_align"][label] = (k, pl) + roi_fwd_bound(
                (None, boxes, bidx, levels), p, 2) + (None, alone)
        seen = set()  # one call per distinct shape
        for args in k4:
            feats, sy, sx, m = args
            key = (tuple(feats.shape), sy.shape[1])
            if key in seen:
                continue
            seen.add(key)
            b, c, h, w = feats.shape
            label = (f"bf16 B={b} {h}x{w}x{c} S={sy.shape[1]}: YOLACT++ "
                     "training")
            if not torch.equal(dcn_kernel.sample_points(*args),
                               sampling.sample_points_plain(*args)):
                raise AssertionError(f"dcn_sample {label}: not equal")
            k, pl = time_pair(lambda: sampling.sample_points(*args), iters=10)
            alone = cuda_time_ms(lambda: dcn_kernel.sample_points(*args), 10)
            lib = cuda_time_ms(lambda: grid_sample_points(*args), iters=10)
            out["dcn_sample"][label] = ((k, pl) + dcn_bound(feats, sy, sx)
                                        + (lib, alone))
    for args in k3:
        grad, boxes, bidx, levels, shapes, dt, p = args[:7]
        label = f"bf16 N={boxes.shape[0]} P={p}: Mask R-CNN FPN training"
        with torch.no_grad():
            want = sampling.multilevel_roi_align_backward_plain(
                grad.float(), boxes, bidx, levels, shapes, torch.float32,
                *args[6:])
            bwd_error(roi_kernel.multilevel_roi_align_backward(*args), want,
                      BF16, f"roi_align_bwd {label}")
        k, pl = time_pair(lambda: sampling.multilevel_roi_align_backward(
            *args), iters=10)
        alone = cuda_time_ms(
            lambda: roi_kernel.multilevel_roi_align_backward(*args), 10)
        out["roi_align_bwd"][label] = (k, pl) + roi_bwd_bound(
            boxes.shape[0], p, 2) + (None, alone)
    seen = set()
    for args in k4c:
        grad, feats, sy, sx, m = args[:5]
        key = (tuple(feats.shape), sy.shape[1])
        if key in seen:
            continue
        seen.add(key)
        b, c, h, w = feats.shape
        label = (f"bf16 B={b} {h}x{w}x{c} S={sy.shape[1]}: YOLACT++ "
                 "training")
        with torch.no_grad():
            want = sampling.sample_points_backward_plain(
                grad.float(), feats.float(), sy, sx, m, *args[5:])
            dcn_bwd_error(dcn_kernel.sample_points_backward(*args), want,
                          BF16, f"dcn_sample_bwd {label}")
        k, pl = time_pair(lambda: sampling.sample_points_backward(*args),
                          iters=10)
        alone = cuda_time_ms(
            lambda: dcn_kernel.sample_points_backward(*args), 10)
        lib = cuda_time_ms(grid_sample_backward(feats, sy, sx, m, grad),
                           iters=10)
        out["dcn_sample_bwd"][label] = ((k, pl)
                                        + dcn_bwd_bound(feats, sy, sx)
                                        + (lib, alone))
    for kname, shapes in out.items():
        for label, t in shapes.items():
            lib = "none" if t[4] is None else f"{t[4]:.4f} ms"
            log(f"[17 timing] {kname} {label}: kernel {t[0]:.4f} ms (the "
                f"kernel launch alone {t[5]:.4f} ms), plain {t[1]:.4f} ms, "
                f"bound {t[2]:.4g} ms by {t[3]}, library {lib} [{card}]")
    return out


def pose2seg_npz(tmp: Path) -> str:
    """Pose2Seg's JAX tree through save_pose2seg_checkpoint (an .npz path)
    and back through load_pose2seg_weights."""
    cfg = P2S.Pose2SegConfig()
    model = P2S.build_model(cfg)
    model.load_state_dict(synthetic_pose2seg_state_dict(cfg, SEED + 42),
                          strict=True)
    path = tmp / "pose2seg_last.npz"
    P2SE.save_pose2seg_checkpoint(str(path), model)
    back, _ = load_pose2seg_weights(str(path), cfg)
    if not all(torch.equal(back[k], v) for k, v in model.state_dict().items()
               if not k.endswith("num_batches_tracked")):
        raise AssertionError("Pose2Seg npz does not read back")
    with np.load(path) as f:
        return f"{len(f.files)} arrays"


def phase_bf16(dev, tmp: Path, card: str) -> dict:
    t0 = time.perf_counter()
    counts, times, k2 = {}, {}, []
    for name in BF16_FAMILY:
        res = bf16_family_inference(name, dev, tmp, card)
        counts[f"bf16_{name}_inference"] = res["counts"]
        times.update(res["times"])
        if name == "maskrcnn":
            k2 += res["k2"]
        torch.cuda.empty_cache()
    train = bf16_maskrcnn_train(dev, tmp, card)
    counts["bf16_maskrcnn_training"] = train["counts"]
    times.update(train["times"])
    torch.cuda.empty_cache()
    yolact = bf16_yolact_train(dev, tmp, card)
    counts["bf16_yolact_training"] = yolact["counts"]
    times.update(yolact["times"])
    torch.cuda.empty_cache()
    darknet = darknet_yolact(dev, tmp, card)
    counts.update(darknet["counts"])
    times.update(darknet["times"])
    log(f"[17 npz] Pose2Seg through save_pose2seg_checkpoint(.npz) and "
        f"load_pose2seg_weights: {pose2seg_npz(tmp)} read back equal")
    shapes = bf16_kernel_shapes(k2 + train["k2"], train["k3"], yolact["k4"],
                                yolact["k4c"], card)
    log(f"[17 total] phase 17 in {time.perf_counter() - t0:.1f} s")
    return {"counts": counts, "times": times, "shapes": shapes}


# ---------------------------------------------------------------------------
# phase 18: multi-GPU on one card
# ---------------------------------------------------------------------------

MULTI_YOLACT_BATCH = 12  # the global batch of the two gloo ranks: 2 x 6
MULTI_TIMED_STEPS = 5
RANK_TIMEOUT = 300
CLI_DDP_STEPS = 3


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn_ranks(job: str, world: int, backend: str, tmp: Path,
                inputs: dict) -> list:
    """``python3 chip_smoke.py --rank job backend dir`` ``world`` times on
    a free localhost port, every rank on cuda:0 (NCCL takes one rank a
    card; gloo runs two on one) -> each rank's output. A rank that fails
    or outlives RANK_TIMEOUT raises with its output; every rank is
    stopped."""
    torch.save(inputs, tmp / f"{job}.in.pt")
    port = free_port()
    procs = []
    for rank in range(world):
        env = {**os.environ, "RANK": str(rank), "WORLD_SIZE": str(world),
               "LOCAL_RANK": "0", "MASTER_ADDR": "127.0.0.1",
               "MASTER_PORT": str(port)}
        procs.append(subprocess.Popen(
            [sys.executable, str(Path(__file__).resolve()), "--rank", job,
             backend, str(tmp)], env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    try:
        logs = [p.communicate(timeout=RANK_TIMEOUT)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for rank, (p, out) in enumerate(zip(procs, logs)):
        if p.returncode != 0:
            raise AssertionError(f"rank {rank} of {job} exited "
                                 f"{p.returncode}:\n{out[-6000:]}")
    return [torch.load(tmp / f"{job}.{r}.pt", weights_only=False)
            for r in range(world)]


def rank_main(job: str, backend: str, tmp: str) -> int:
    """One rank of phase 18 (``--rank``): join the group the environment
    names, run ``job`` on cuda:0, save its output."""
    import torch.distributed as dist

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    dist.init_process_group(
        backend, init_method=f"tcp://127.0.0.1:{os.environ['MASTER_PORT']}",
        rank=rank, world_size=world)
    try:
        kernels.library()
        inp = torch.load(Path(tmp) / f"{job}.in.pt", weights_only=False)
        out = RANK_JOBS[job](inp, dev, rank, world)
        torch.save(out, Path(tmp) / f"{job}.{rank}.pt")
    finally:
        dist.destroy_process_group()
    return 0


def yolact_train_model(sd: dict, cfg, dev):
    model = YM.build_model(cfg)
    model.load_state_dict(sd, strict=True)
    return model.to(dev).train()


def maskrcnn_train_model(sd: dict, dev):
    model = M.build_model(M.MaskRCNNConfig())
    model.load_state_dict(sd, strict=True)
    return model.to(dev).train()


def bound_grads(bound, model, *args, **kwargs) -> tuple:
    """Losses and gradients of one forward and backward of ``bound`` (a
    ``Bound`` or DDP over one); the losses as the global batch's."""
    model.zero_grad(set_to_none=True)
    losses = bound(*args, **kwargs)
    losses["total"].backward()
    losses = PDDP.mean_over_ranks({k: v.detach() for k, v in losses.items()})
    grads = {n: p.grad.detach().clone() for n, p in model.named_parameters()
             if p.grad is not None}
    model.zero_grad(set_to_none=True)
    return {k: float(v) for k, v in losses.items()}, grads


def timed_steps(fn, n: int = MULTI_TIMED_STEPS) -> float:
    """ms per call of ``fn`` (a training step) on the host clock, after two
    warm-ups, synchronised."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / n


def ddp1_job(inp: dict, dev, rank: int, world: int) -> dict:
    """(b) NCCL at world size 1: phase 11's YOLACT++ step (B = 8) and
    phase 9's Mask R-CNN step (B = 2), plain (twice) and through DDP, TF32
    off and deterministic cuDNN; then both timed, plain and DDP in turns."""
    out = {}
    ycfg, loss_cfg = inp["yolact_cfg"], inp["yolact_loss_cfg"]
    model = yolact_train_model(inp["yolact_sd"], ycfg, dev)
    images = inp["yolact_images"].to(dev)
    targets = {k: v.to(dev) for k, v in inp["yolact_targets"].items()}
    priors = torch.from_numpy(YM.make_priors_np(ycfg)).to(dev)
    draws = inp["yolact_draws"].to(dev)
    plain = Bound(model, YTL.train_losses)
    wrapped = PDDP.wrap(Bound(model, YTL.train_losses), dev)
    args = (images, targets, priors, draws, loss_cfg)
    with exact_convs():
        kernels.reset_launch_counts()
        runs = [bound_grads(plain, model, *args) for _ in range(2)]
        runs += [bound_grads(wrapped, model, *args) for _ in range(2)]
        out["yolact_counts"] = kernels.launch_counts()
    out["yolact"] = ddp_vs_plain(*runs)
    opt = make_yolact_optimizer(model)
    times = {}
    for name in ("plain", "ddp", "ddp", "plain"):
        times.setdefault(name, []).append(timed_steps(
            lambda: YTL.train_step(model, opt, 0.0, *args[:4], loss_cfg, None,
                                   wrapped if name == "ddp" else None)))
    out["yolact_ms"] = times
    del model, wrapped, plain, opt, runs
    torch.cuda.empty_cache()

    model = maskrcnn_train_model(inp["mrcnn_sd"], dev)
    images, image_hw, targets = (t.to(dev) if torch.is_tensor(t) else
                                 {k: v.to(dev) for k, v in t.items()}
                                 for t in inp["mrcnn_batch"])
    plain = Bound(model, TL.train_losses)
    wrapped = PDDP.wrap(Bound(model, TL.train_losses), dev)

    def gen():
        return torch.Generator(device=dev).manual_seed(SEED + 9)

    with exact_convs():
        kernels.reset_launch_counts()
        runs = [bound_grads(plain, model, images, image_hw, targets, gen())
                for _ in range(2)]
        runs.append(bound_grads(wrapped, model, images, image_hw, targets,
                                gen()))
        out["mrcnn_counts"] = kernels.launch_counts()
    out["mrcnn"] = ddp_vs_plain(*runs)
    opt = make_optimizer(model, 0.0)

    def step(bound):
        opt.zero_grad(set_to_none=True)
        bound(images, image_hw, targets, gen())["total"].backward()
        opt.step()

    times = {}
    for name in ("plain", "ddp", "ddp", "plain"):
        times.setdefault(name, []).append(timed_steps(
            lambda: step(wrapped if name == "ddp" else plain)))
    out["mrcnn_ms"] = times
    return out


def ddp_vs_plain(p1: tuple, p2: tuple, d: tuple, d2: tuple = None) -> dict:
    """DDP's step against the plain step: the losses bit for bit (the
    forward is deterministic); a gradient that two plain runs give bit for
    bit, bit for bit; the others (downstream of K3's, K4c's and
    index_add_'s atomics, whose order changes from run to run) within
    phase 9's gate, rtol 1e-4 / atol 1e-6 max|g|, the atol raised to ten
    times the two plain runs' largest difference where that is larger
    (phase 15's), or, given a second DDP run ``d2`` (train-mode
    BatchNorm, which magnifies the atomics' rounding past any elementwise
    gate: measured 10.6 times the plain runs' difference on one YOLACT++
    gradient), within phase 11's train-mode gate."""
    (l1, g1), (l2, g2), (ld, gd) = p1, p2, d
    bad, exact, rest, worst = [], 0, 0, 0.0
    gate = None
    if d2 is not None:
        try:
            gate = compare_train_mode(d, d2, p1, p2, what="DDP against plain",
                                      names=("DDP", "plain"))
        except AssertionError as e:
            bad.append(str(e))
    if not ld == l1 == l2:
        bad.append(f"losses: DDP {ld}, plain {l1}, {l2}")
    if sorted(gd) != sorted(g1):
        bad.append("other parameters have gradients")
    reproducible = [n for n, w in g1.items() if torch.equal(g2[n], w)]
    for n, w in g1.items():
        if n not in gd:
            continue
        if torch.equal(gd[n], w):
            exact += 1
            continue
        if n in reproducible:
            bad.append(f"{n}: the plain step gives it bit for bit, DDP not")
            continue
        rest += 1
        if gate is not None:
            continue
        scale = float(w.abs().max())
        atol = max(1e-6 * scale, 10 * float((g2[n] - w).abs().max()))
        excess = float(((gd[n] - w).abs() - 1e-4 * w.abs()).max())
        worst = max(worst, excess / atol)
        if excess > atol:
            bad.append(f"{n}: {excess / scale:.3g} of max|g| past rtol "
                       f"1e-4, atol {atol / scale:.3g}")
    return {"bad": bad, "exact": exact, "rest": rest, "worst": worst,
            "reproducible": len(reproducible), "n": len(g1),
            "losses": ld, "gate": gate}


def gloo2_job(inp: dict, dev, rank: int, world: int) -> dict:
    """(c) two gloo ranks on cuda:0: YOLACT++ at a global B = 12 (6 a
    rank, train-mode BatchNorm synchronised; two runs) and Mask R-CNN at a
    global B = 2 (1 a rank), each rank its rows of the global batch and of
    the draws for the global batch, TF32 off and deterministic cuDNN;
    rank 0 returns the gradients, rank 1 their per-tensor sums; both
    their launches and step times."""
    out = {}
    ycfg, loss_cfg = inp["yolact_cfg"], inp["yolact_loss_cfg"]
    b = MULTI_YOLACT_BATCH // world
    rows = slice(rank * b, (rank + 1) * b)
    model = yolact_train_model(inp["yolact_sd"], ycfg, dev)
    convert_sync_bn(model)
    wrapped = PDDP.wrap(Bound(model, YTL.train_losses), dev)
    priors = torch.from_numpy(YM.make_priors_np(ycfg)).to(dev)
    args = (inp["yolact_images"][rows].to(dev),
            {k: v[rows].to(dev) for k, v in inp["yolact_targets"].items()},
            priors, inp["yolact_draws"][rows].to(dev), loss_cfg)
    with exact_convs():
        kernels.reset_launch_counts()
        runs = [bound_grads(wrapped, model, *args) for _ in range(2)]
        out["yolact_counts"] = kernels.launch_counts()
    out["yolact_stats"] = {k: v.cpu() for k, v in model.state_dict().items()
                           if k.endswith(("running_mean", "running_var"))}
    out["yolact_runs"] = [(losses, {n: g.cpu() for n, g in grads.items()}
                           if rank == 0 else None) for losses, grads in runs]
    out["yolact_sums"] = [grad_sums(grads) for _, grads in runs]
    del runs
    opt = make_yolact_optimizer(model)
    out["yolact_ms"] = timed_steps(lambda: YTL.train_step(
        model, opt, 0.0, *args[:4], loss_cfg, None, wrapped))
    del model, wrapped, opt
    torch.cuda.empty_cache()

    model = maskrcnn_train_model(inp["mrcnn_sd"], dev)
    wrapped = PDDP.wrap(Bound(model, TL.train_losses), dev)
    images, image_hw, targets = inp["mrcnn_batch"]
    margs = (images[rank:rank + 1].to(dev), image_hw[rank:rank + 1].to(dev),
             {k: v[rank:rank + 1].to(dev) for k, v in targets.items()})

    def gen():
        return torch.Generator(device=dev).manual_seed(SEED + 9)

    with exact_convs():
        kernels.reset_launch_counts()
        losses, grads = bound_grads(wrapped, model, *margs, gen())
        out["mrcnn_counts"] = kernels.launch_counts()
    out["mrcnn"] = (losses, {n: g.cpu() for n, g in grads.items()}
                    if rank == 0 else None)
    out["mrcnn_sums"] = grad_sums(grads)
    opt = make_optimizer(model, 0.0)

    def step():
        opt.zero_grad(set_to_none=True)
        wrapped(*margs, gen())["total"].backward()
        opt.step()

    out["mrcnn_ms"] = timed_steps(step)
    return out


def grad_sums(grads: dict) -> dict:
    """Each gradient's sum in f64, on its device: two ranks' DDP
    gradients are the same tensors bit for bit."""
    return {n: float(g.double().sum()) for n, g in grads.items()}


RANK_JOBS = {"ddp1": ddp1_job, "gloo2": gloo2_job}


def cli_rank_main(out_path: str, argv: list) -> int:
    """``yolact_train``'s main() under torchrun (``--cli-rank``), its
    per-step losses saved to ``out_path`` by rank 0."""
    from tpuseg_torch.tools import yolact_train

    history = yolact_train.main(argv)
    if int(os.environ.get("RANK", "0")) == 0:
        torch.save(history, out_path)
    return 0


def same_results(got: list, want: list, what: str) -> str:
    """Final detections of the predictors, image for image: counts and
    classes equal, boxes atol 1e-3, scores rtol 1e-5, the pasted masks
    equal (phase 8's tolerances on the padded outputs)."""
    err = {"boxes": 0.0, "scores": 0.0}
    for i, (a, b) in enumerate(zip(got, want)):
        if len(a["scores"]) != len(b["scores"]) or not np.array_equal(
                a["classes"], b["classes"]):
            raise AssertionError(f"{what} image {i}: detections differ")
        np.testing.assert_allclose(a["boxes"], b["boxes"], atol=1e-3, rtol=0)
        np.testing.assert_allclose(a["scores"], b["scores"], atol=0,
                                   rtol=1e-5)
        if not np.array_equal(a["masks"], b["masks"]):
            raise AssertionError(f"{what} image {i}: masks differ")
        for k in err:
            if len(a[k]):
                err[k] = max(err[k], float(np.abs(a[k] - b[k]).max()))
    return (f"{[len(r['scores']) for r in got]} detections equal, max err "
            f"boxes {err['boxes']:.3g} scores {err['scores']:.3g}")


def multi_replicas(dev) -> dict:
    """(a) In-process replicas on cuda:0 twice: YolactPredictor at B = 8
    and MaskRCNNPredictor at B = 2 and B = 1 (padded to 2), each against
    ``devices=None`` on the same shards (cuDNN then sees the same batch
    sizes), TF32 off and deterministic cuDNN; the replicas' launches."""
    cfg = yolact_model_config("yolact_plus_resnet50")
    model = YM.build_model(cfg)
    model.load_state_dict(synthetic_yolact_state_dict(model, SEED),
                          strict=True)
    images = yolact_images(SEED, 8, cfg.img_size)
    model = model.to(dev)
    calibrate_yolact_gate(model, yolact_preprocess(
        torch.from_numpy(images).to(dev), cfg.img_size), want=(10, 500))
    sd = {k: v.cpu() for k, v in model.state_dict().items()}
    del model
    one = YolactPredictor(cfg, state_dict=sd, batch_size=8, device=dev)
    two = YolactPredictor(cfg, state_dict=sd, batch_size=8, device=dev,
                          devices=[dev, dev])
    counts = {}
    with exact_convs():
        kernels.reset_launch_counts()
        got = two.run_batch(images)
        torch.cuda.synchronize()
        counts["multi_replicas_yolact"] = kernels.launch_counts()
        halves = [one.run_batch(images[:4]), one.run_batch(images[4:])]
        want = {k: torch.cat([h[k] for h in halves]) for k in halves[0]}
    if counts["multi_replicas_yolact"] != per(
            {"dcn_sample": sum(DCN_PER_FORWARD)}, 2):
        raise AssertionError(f"two YOLACT++ replicas launched "
                             f"{counts['multi_replicas_yolact']}")
    check_yolact(two, got, 8)
    err = compare_yolact(got, want)
    log(f"[18 multi-GPU] (a) YolactPredictor(devices=[cuda:0, cuda:0]) at "
        f"B = 8 (two replicas, one thread each) against devices=None on its "
        f"4-image shards: detections {got['valid'].sum(1).tolist()} equal, "
        f"max err " + ", ".join(f"{n} {e:.3g}" for n, e in err.items())
        + f"; launches {compact(counts['multi_replicas_yolact'])} "
        f"({sum(DCN_PER_FORWARD)} K4 a replica)")
    del one, two, got, want, halves
    torch.cuda.empty_cache()

    mcfg = M.MaskRCNNConfig()
    msd = synthetic_state_dict(M.build_model(mcfg), SEED)
    landscape, _ = synthetic_images(SEED)

    def predictor(devices=None):
        model = M.build_model(mcfg)
        model.load_state_dict(msd, strict=True)
        return MaskRCNNPredictor(model=model, device=dev, devices=devices)

    one, two = predictor(), predictor([dev, dev])
    lines = []
    for b in (2, 1):
        imgs, path = landscape[:b], f"multi_replicas_maskrcnn_b{b}"
        with exact_convs():
            kernels.reset_launch_counts()
            got = two.run_on_bgr_images(imgs)
            torch.cuda.synchronize()
            counts[path] = kernels.launch_counts()
            want = [one.run_on_bgr_image(img) for img in imgs]
        # one canvas a batch (built on the first device), then each replica
        if counts[path] != per({"nms": 12, "roi_align": 4, "canvas": 1}):
            raise AssertionError(f"two Mask R-CNN replicas at B = {b} "
                                 f"launched {counts[path]}")
        for r, img in zip(got, imgs):
            check_result(r, *img.shape[:2])
        lines.append(f"B = {b}{' (padded to 2)' if b == 1 else ''}: "
                     f"{same_results(got, want, f'Mask R-CNN B = {b}')}, "
                     f"launches {compact(counts[path])}")
    log("[18 multi-GPU] (a) MaskRCNNPredictor(devices=[cuda:0, cuda:0]) "
        "against devices=None image by image: " + "; ".join(lines)
        + " (a canvas, then 6 K1 + 2 K2 a replica)")
    return counts


def multi_inputs(dev) -> tuple:
    """Phase 11's and phase 9's weights and batches for the ranks, on the
    CPU: YOLACT++ at B = 8 (the world-size-1 step) and at B = 12 (the two
    ranks'), with their draws; Mask R-CNN at B = 2."""
    name = "yolact_plus_resnet50"
    cfg, loss_cfg = yolact_model_config(name), yolact_loss_config(name)
    ysd = synthetic_yolact_state_dict(YM.build_model(cfg), SEED + 11,
                                      offset_scale=TRAIN_OFFSET_SCALE)
    n = YM.make_priors_np(cfg).shape[0]
    batches = {}
    for b in (YOLACT_BATCH, MULTI_YOLACT_BATCH):
        data = SyntheticYolactDataset(SEED + 11, n_images=b)
        images, targets = YTL.batch_to_device(*next(YTL.batch_iterator(
            data, cfg, np.random.default_rng(SEED + 12), b)), "cpu")
        draws = torch.rand((b, n), device=dev, generator=torch.Generator(
            device=dev).manual_seed(SEED + 13)).cpu()
        batches[b] = {"yolact_images": images, "yolact_targets": targets,
                      "yolact_draws": draws}
    msd = synthetic_state_dict(M.build_model(M.MaskRCNNConfig()), SEED + 7)
    msd["backbone.body.stem.bn1.running_var"] *= PIXEL_VAR
    data = SyntheticDataset(SEED + 7)
    rng = np.random.default_rng(SEED + 8)
    mbatch = TL.batch_to_device([TL.build_train_example(data, i, rng=rng)
                                 for i in data.image_ids[:2]], "cpu")
    common = {"yolact_cfg": cfg, "yolact_loss_cfg": loss_cfg,
              "yolact_sd": ysd, "mrcnn_sd": msd, "mrcnn_batch": mbatch}
    return ({**common, **batches[YOLACT_BATCH]},
            {**common, **batches[MULTI_YOLACT_BATCH]})


def multi_ddp1(dev, tmp: Path, inputs: dict, card: str) -> dict:
    """(b) DDP over NCCL at world size 1 in a rank of its own."""
    out = spawn_ranks("ddp1", 1, "nccl", tmp, inputs)[0]
    counts = {"multi_ddp1_yolact": out["yolact_counts"],
              "multi_ddp1_maskrcnn": out["mrcnn_counts"]}
    if counts["multi_ddp1_yolact"] != per(YOLACT_PER_STEP, 4) or counts[
            "multi_ddp1_maskrcnn"] != per(PER_STEP, 3):
        raise AssertionError(f"world-size-1 steps launched {counts}")
    times, lines = {}, []
    for key, what in (("yolact", f"YOLACT++ B = {YOLACT_BATCH}"),
                      ("mrcnn", "Mask R-CNN B = 2")):
        r = out[key]
        if r["bad"]:
            raise AssertionError(f"DDP at world size 1, {what}: "
                                 f"{len(r['bad'])} failures: {r['bad'][:3]}")
        ms = out[f"{key}_ms"]
        plain, ddp_ms = (float(np.mean(ms[k])) for k in ("plain", "ddp"))
        times[f"ddp world size 1 {what} plain step"] = plain
        times[f"ddp world size 1 {what} DDP step"] = ddp_ms
        rest = (f"phase 11's train-mode gate, two runs each: {r['gate']}"
                 if r["gate"] else
                 f"within rtol 1e-4 and the larger of 1e-6 max|g| and ten "
                 f"times the plain runs' difference (the largest excess "
                 f"{r['worst']:.3g} of that atol)")
        lines.append(
            f"{what}: losses equal bit for bit "
            f"({', '.join(f'{k} {v:.6g}' for k, v in r['losses'].items())}); "
            f"{r['exact']} of {r['n']} gradients equal bit for bit (two "
            f"plain runs agree bit for bit on {r['reproducible']}: the "
            f"others lie downstream of the backward's atomics), the other "
            f"{r['rest']}: {rest}; "
            f"ms per step (TF32 on, SGD, host clock, {MULTI_TIMED_STEPS} "
            f"after 2 warm-ups; plain, DDP, DDP, plain): plain "
            f"{ms['plain']}, DDP {ms['ddp']}, DDP overhead "
            f"{ddp_ms - plain:+.2f} ms per step")
    log(f"[18 multi-GPU] (b) DDP over NCCL at world size 1 (one rank "
        f"spawned on a free port; TF32 off, deterministic cuDNN for the "
        f"comparison): " + "; ".join(lines) + f" [{card}]")
    return {"counts": counts, "times": times}


def multi_gloo2(dev, tmp: Path, inputs: dict, card: str) -> dict:
    """(c) two gloo ranks on cuda:0 against one process."""
    outs = spawn_ranks("gloo2", 2, "gloo", tmp, inputs)
    counts = {"multi_ranks_yolact": per({}), "multi_ranks_maskrcnn": per({})}
    for o in outs:
        for path, key in (("multi_ranks_yolact", "yolact_counts"),
                          ("multi_ranks_maskrcnn", "mrcnn_counts")):
            counts[path] = {k: counts[path][k] + o[key][k] for k in o[key]}
    if counts["multi_ranks_yolact"] != per(YOLACT_PER_STEP, 4) or counts[
            "multi_ranks_maskrcnn"] != per(PER_STEP, 2):
        raise AssertionError(f"the two ranks launched {counts}")
    r0, r1 = outs
    if r0["yolact_sums"] != r1["yolact_sums"] or (
            r0["mrcnn_sums"] != r1["mrcnn_sums"]):
        raise AssertionError("the two ranks hold other gradients")

    # the one process: YOLACT++ at B = 12 (twice), TF32 off
    cfg, loss_cfg = inputs["yolact_cfg"], inputs["yolact_loss_cfg"]
    model = yolact_train_model(inputs["yolact_sd"], cfg, dev)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    args = (inputs["yolact_images"].to(dev),
            {k: v.to(dev) for k, v in inputs["yolact_targets"].items()},
            torch.from_numpy(YM.make_priors_np(cfg)).to(dev),
            inputs["yolact_draws"].to(dev), loss_cfg)
    with exact_convs():
        ref = [yolact_step_grads(model, *args) for _ in range(2)]
        torch.cuda.synchronize()
    # the ranks' BatchNorm statistics (a parallel combination of per-rank
    # means and sums of squares) round apart from cuDNN's over the whole
    # batch, so the forwards are not bit-equal: measured on the card, B,
    # C, M and S within 1e-6, FastMaskIoUNet's I (masks thresholded at 0.5
    # into an IoU) 1.4e-5; the losses are held at 1e-4. Phase 11's
    # gradient gate (ten times either path's spread, 1e-3 to 1e-2) assumes
    # one forward on both paths: here each path reproduces itself to 2e-6
    # relative L2 but 196 of 246 gradients lie over 1e-3 from the other
    # path (measured on the card): train-mode BatchNorm's backward
    # magnifies the statistics' rounding, as it does f32 against f64 on
    # the CPU (median 5.9e-3, largest 3.1e-2:
    # tests/test_torch_yolact_train_bn.py, which holds 5e-2). So every
    # gradient is held at 5e-2 relative L2, the DCN offset convs' at 1e-1:
    # they sum the sampler's coordinate gradient, which jumps where a
    # sample crosses into the next cell, and the rounding moves a few
    # samples across (measured: layer 3's 0.038-0.047).
    gate = compare_train_mode(*[(l, {n: g.to(dev) for n, g in gr.items()})
                                for l, gr in r0["yolact_runs"]], *ref,
                              floor=5e-2, cap=5e-2,
                              what="two ranks against one process",
                              loss_rtol=1e-4,
                              names=("ranks", "one process"),
                              wide=("conv_offset_mask", 1e-1))
    stats = {k: v for k, v in model.state_dict().items()
             if k.endswith(("running_mean", "running_var"))}
    stale = [k for k in stats if torch.equal(stats[k], before[k])]
    for o in outs:
        stale += [k for k in stats if torch.equal(o["yolact_stats"][k],
                                                  before[k].cpu())]
        err = max(float(((o["yolact_stats"][k].to(dev) - v).abs()
                         / v.abs().clamp(min=1e-3)).max())
                  for k, v in stats.items())
        if stale or err > 1e-3:
            raise AssertionError(f"running statistics: {stale[:3]} not "
                                 f"updated, or {err:.3g} from one process's")
    del model, ref, before
    torch.cuda.empty_cache()

    # Mask R-CNN: one process runs the two 1-image halves, one thread each
    # with the global normalisers (a ThreadGroup), TF32 off
    model = maskrcnn_train_model(inputs["mrcnn_sd"], dev)
    images, image_hw, targets = inputs["mrcnn_batch"]

    def half(r):
        gen = torch.Generator(device=dev).manual_seed(SEED + 9)
        losses = TL.train_losses(
            model, images[r:r + 1].to(dev), image_hw[r:r + 1].to(dev),
            {k: v[r:r + 1].to(dev) for k, v in targets.items()}, gen)
        losses["total"].backward()
        return PDDP.mean_over_ranks({k: v.detach() for k, v in losses.items()})

    model.zero_grad(set_to_none=True)
    with exact_convs():
        kernels.reset_launch_counts()
        losses = ThreadGroup(2).run(half)[0]
        torch.cuda.synchronize()
        ref_counts = kernels.launch_counts()
    want = ({k: float(v) for k, v in losses.items()},
            {n: p.grad.detach() / 2 for n, p in model.named_parameters()
             if p.grad is not None})
    if ref_counts != per(PER_STEP, 2):
        raise AssertionError(f"the one-process halves launched {ref_counts}")
    mgate = compare_steps((r0["mrcnn"][0], {n: g.to(dev) for n, g in
                                            r0["mrcnn"][1].items()}), want)
    log(f"[18 multi-GPU] (c) two gloo ranks on cuda:0 (each rank its rows "
        f"of the global batch and of its draws; TF32 off, deterministic "
        f"cuDNN), gradients equal on both ranks: YOLACT++ at a global B = "
        f"{MULTI_YOLACT_BATCH} as 2 x {MULTI_YOLACT_BATCH // 2} with "
        f"train-mode BatchNorm synchronised, two runs, against one process "
        f"at B = {MULTI_YOLACT_BATCH}, two runs: {gate}; running statistics "
        f"updated, within 1e-3 of one process's; launches of both ranks "
        f"{compact(counts['multi_ranks_yolact'])}")
    log(f"[18 multi-GPU] (c) Mask R-CNN at a global B = 2 as 2 x 1 against "
        f"one process running the two 1-image halves with the global "
        f"normalisers (a ThreadGroup): {mgate}; launches of both ranks "
        f"{compact(counts['multi_ranks_maskrcnn'])}")
    times = {}
    for what, key in ((f"YOLACT++ B = {MULTI_YOLACT_BATCH // 2} a rank",
                       "yolact_ms"), ("Mask R-CNN B = 1 a rank", "mrcnn_ms")):
        ms = [o[key] for o in outs]
        times[f"two ranks on one card {what}"] = float(np.mean(ms))
        log(f"[18 timing] two ranks on one card (not a multi-GPU speed), "
            f"{what}: {ms[0]:.2f} and {ms[1]:.2f} ms per DDP step (TF32 "
            f"on, SGD, host clock, {MULTI_TIMED_STEPS} after 2 warm-ups, "
            f"the two ranks at once) [{card}]")
    return {"counts": counts, "times": times}


def multi_clis(dev, tmp: Path, coco: dict, card: str,
               refused: subprocess.Popen) -> dict:
    """(d) yolact_train under torch.distributed.run against phase 13's
    run; yolact_eval --devices all and test_net --devices 1 against phase
    13's; ``refused``: test_net asking for more GPUs than there are."""
    from tpuseg_torch.tools import test_net, yolact_eval, yolact_train

    runs = coco["runs"]
    argv, history = runs["yolact_train"]
    argv = [a for a in argv]
    argv[argv.index("--max_steps") + 1] = str(CLI_DDP_STEPS)
    argv[argv.index("--save_folder") + 1] = str(tmp / "yolact_train_ddp")
    out_path = tmp / "yolact_train_ddp.pt"
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node", "1", str(Path(__file__).resolve()),
         "--cli-rank", str(out_path), "--dist_backend", "nccl", *argv],
        capture_output=True, text=True, timeout=RANK_TIMEOUT)
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"yolact_train under torch.distributed.run "
                             f"exited {proc.returncode}:\n"
                             f"{(proc.stdout + proc.stderr)[-6000:]}")
    got = torch.load(out_path, weights_only=False)
    if len(got) != CLI_DDP_STEPS:
        raise AssertionError(f"torchrun's yolact_train ran {len(got)} steps")
    # the same CLI again without torchrun: how far two runs of one path
    # lie apart after the first update
    plain_argv = [*argv]
    plain_argv[plain_argv.index("--save_folder") + 1] = str(
        tmp / "yolact_train_plain")
    with quiet():
        plain = yolact_train.main(plain_argv)
        torch.cuda.synchronize()

    def rel(run):
        return [max(abs(g[k] - w[k]) / abs(w[k]) for k in w)
                for g, w in zip(run, history)]

    rel_ddp, rel_plain = rel(got), rel(plain)
    # the first step is the same batch, draws and forward: bit for bit.
    # Later steps carry the first update, whose gradients the backward's
    # atomics (K4c, cuDNN's wgrad) round apart from run to run, and
    # train-mode BatchNorm and yolact's lr on synthetic weights magnify
    # that (measured on the card at step 3: FastMaskIoUNet's I 6.6e-2, M
    # 2.9e-2 from phase 13's run; the plain run's own difference beside
    # it): held at 2e-1
    if got[0] != history[0] or plain[0] != history[0] or max(
            rel_ddp + rel_plain) > 2e-1 or not all(
            np.isfinite(v) for h in got for v in h.values()):
        raise AssertionError(f"torchrun's losses {got}, the plain CLI's "
                             f"{plain}, against phase 13's "
                             f"{history[:CLI_DDP_STEPS]}")
    log(f"[18 multi-GPU] (d) yolact_train under torch.distributed.run "
        f"--standalone --nproc_per_node 1 --dist_backend nccl (DDP at world "
        f"size 1), {CLI_DDP_STEPS} steps over phase 13's dataset in "
        f"{wall:.1f} s: the first step's losses equal phase 13's bit for "
        f"bit (total {got[0]['total']!r}); the largest relative difference "
        f"of a loss from phase 13's, per step: torchrun "
        f"{[float(f'{r:.3g}') for r in rel_ddp]}, the CLI again without "
        f"torchrun {[float(f'{r:.3g}') for r in rel_plain]} (the backward's "
        f"atomics, run to run)")

    lines = []
    for name, main, flag in (("yolact_eval", yolact_eval.main, "all"),
                             ("test_net", test_net.main, "1")):
        argv, want = runs[name]
        kernels.reset_launch_counts()
        with quiet():
            got = main([*argv, "--devices", flag])
            torch.cuda.synchronize()
        if name == "yolact_eval":
            diff = max(abs(got[t][k] - want[t][k]) for t in want
                       for k in want[t])
        else:
            diff = max(float(np.abs(got[t] - want[t]).max()) for t in want)
        if diff > 1e-9:
            raise AssertionError(f"{name} --devices {flag}: {got} against "
                                 f"phase 13's {want}")
        lines.append(f"{name} --devices {flag}: phase 13's "
                     f"{'maps' if name == 'yolact_eval' else 'stats'} "
                     f"(largest difference {diff:.3g}), launches "
                     f"{compact(kernels.launch_counts())}")
    out = refused.communicate(timeout=RANK_TIMEOUT)[0]
    want_msg = "refusing to silently under-provision"
    if refused.returncode == 0 or want_msg not in out:
        raise AssertionError(f"test_net asking for more GPUs than visible "
                             f"exited {refused.returncode}:\n{out[-3000:]}")
    msg = next(ln for ln in out.splitlines() if want_msg in ln)
    log("[18 multi-GPU] (d) " + "; ".join(lines)
        + f"; test_net --devices {torch.cuda.device_count() + 1} on "
        f"{torch.cuda.device_count()} visible GPU(s) exits "
        f"{refused.returncode}: {msg.strip()}")
    return {"times": {"torchrun yolact_train s": wall}}


def rank_dcn_shapes(dev, card: str) -> dict:
    """K4 and K4c at a gloo rank's YOLACT++ batch (B = 6) on the 69x69x128
    s1 geometry (layer2 blocks 1-3), f32: each against its plain version,
    its bound and grid_sample (or its backward); the launch alone."""
    from tpuseg_torch.kernels import dcn as dcn_kernel

    b = MULTI_YOLACT_BATCH // 2
    feats, sy, sx, m = (t[:b] for t in dcn_case(dev, 69, 69, 128, 1))
    grad = dcn_grad(dev, feats, sy)
    shapes = {}
    for kind, fn, entry, lib_fn, bound_fn in (
            ("dcn_sample", lambda: sampling.sample_points(feats, sy, sx, m),
             "sample_points", lambda: grid_sample_points(feats, sy, sx, m),
             dcn_bound),
            ("dcn_sample_bwd", lambda: run_dcn_bwd(grad, feats, sy, sx, m),
             "sample_points_backward",
             grid_sample_backward(feats, sy, sx, m, grad), dcn_bwd_bound)):
        with (torch.inference_mode() if kind == "dcn_sample"
              else contextlib.nullcontext()):
            k, p = time_pair(fn, iters=10)
            args = kernel_args(dcn_kernel, entry, fn)
            alone = cuda_time_ms(lambda: getattr(dcn_kernel, entry)(*args),
                                 10)
            lib = cuda_time_ms(lib_fn, iters=10)
        name = f"{kind} float32 B={b} 69x69x128 s1 (a phase-18 rank)"
        t = (k, p) + bound_fn(feats, sy, sx) + (lib, alone)
        shapes[kind] = {name: t}
        library = ("grid_sample" if kind == "dcn_sample"
                   else "grid_sample backward")
        log(f"[18 timing] {name}: kernel {k:.4f} ms (the launch alone "
            f"{alone:.4f} ms), plain {p:.4f} ms, bound {t[2]:.4g} ms by "
            f"{t[3]}, {library} {lib:.4f} ms [{card}]")
    return shapes


def phase_multi_gpu(dev, tmp: Path, coco: dict, card: str) -> dict:
    """Phase 18: the multi-GPU layer on one card."""
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    refused = subprocess.Popen(
        [sys.executable, "-m", "tpuseg_torch.tools.test_net", "--devices",
         str(torch.cuda.device_count() + 1)],
        cwd=Path(__file__).resolve().parent, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    try:
        counts = multi_replicas(dev)
        torch.cuda.empty_cache()
        inputs1, inputs2 = multi_inputs(dev)
        t_host = {}
        data = SyntheticYolactDataset(SEED + 11, n_images=MULTI_YOLACT_BATCH)
        cfg = inputs1["yolact_cfg"]
        for b in (MULTI_YOLACT_BATCH // 2, MULTI_YOLACT_BATCH):
            batches = YTL.batch_iterator(data, cfg, np.random.default_rng(0),
                                         b)
            s = time.perf_counter()
            for _ in range(2):
                next(batches)
            t_host[b] = (time.perf_counter() - s) * 1e3 / 2
        shapes = rank_dcn_shapes(dev, card)
        parts = {"(a) and the inputs": time.perf_counter() - t0}
        b1 = multi_ddp1(dev, tmp, inputs1, card)
        parts["(b)"] = time.perf_counter() - t0 - sum(parts.values())
        b2 = multi_gloo2(dev, tmp, inputs2, card)
        parts["(c)"] = time.perf_counter() - t0 - sum(parts.values())
        d = multi_clis(dev, tmp, coco, card, refused)
        parts["(d)"] = time.perf_counter() - t0 - sum(parts.values())
    finally:
        if refused.poll() is None:
            refused.kill()
            refused.wait()
    counts.update(b1["counts"])
    counts.update(b2["counts"])
    times = {**b1["times"], **b2["times"], **d["times"],
             **{f"host batch B={b}": t for b, t in t_host.items()}}
    half = MULTI_YOLACT_BATCH // 2
    log(f"[18 timing] the host's YOLACT++ batch (SSD augmentation, "
        f"targets), which every rank builds for the global batch before "
        f"keeping its rows: B = {half} {t_host[half]:.1f} ms, B = "
        f"{MULTI_YOLACT_BATCH} {t_host[MULTI_YOLACT_BATCH]:.1f} ms (mean of "
        f"2, host clock) [{card}]")
    log(f"[18 total] phase 18 in {time.perf_counter() - t0:.1f} s: "
        + ", ".join(f"{k} {v:.1f} s" for k, v in parts.items()))
    return {"counts": counts, "times": times, "shapes": shapes}


# ---------------------------------------------------------------------------
# Phase 19: the parity gate (tpuseg_torch/tools/parity_gate.py)
# ---------------------------------------------------------------------------

GATE_NAMES = [f["name"] for f in PG.FAMILIES]
GATE_MAX_IMAGES = 16  # phase 13's COCO dataset; the keypoint one has 8
GATE_SMOKE_PEOPLE = 4  # max_people of the gate's smoke Pose2Seg config
GATE_SECONDS = 300  # a gate subprocess's time limit


@contextlib.contextmanager
def gate_runs():
    """The gate's runners wrapped while the block runs: for each family,
    the kernels' launch counts set to 0 just before it and read just after,
    its seconds on the host clock (the runner's, and its evaluation
    call's) and what its evaluation scored (``scored``: the results of
    each loadRes call; YOLACT's, each image's postprocess_image)."""
    runs, orig = {}, dict(PG.RUNNERS)
    with clocked(YE, ("evaluate_dataset",)) as e1, \
            clocked(ME, ("evaluate_coco",)) as e2, \
            clocked(YOE, ("evaluate_coco_boxes",)) as e3, \
            clocked(P2SE, ("evaluate_pose2seg",)) as e4, \
            recording_calls(COCO, "loadRes") as res_calls, \
            recording_calls(YolactPredictor, "postprocess_image") as post:
        def evaluating():
            return e1[0] + e2[0] + e3[0] + e4[0]

        def wrap(name, fn):
            def run(*args, **kwargs):
                res_calls.clear()
                post.clear()
                ev = evaluating()
                kernels.reset_launch_counts()
                t0 = time.perf_counter()
                try:
                    return fn(*args, **kwargs)
                finally:
                    torch.cuda.synchronize()
                    scored = ([out for _, _, out in post] if post else
                              [a[1] for a, _, _ in res_calls])
                    runs[name] = {
                        "launches": kernels.launch_counts(),
                        "s": time.perf_counter() - t0,
                        "eval_s": evaluating() - ev, "scored": scored,
                        "detections": sum(len(r["scores"]) if post else
                                          len(r) for r in scored)}
            return run

        PG.RUNNERS.update({n: wrap(n, f) for n, f in orig.items()})
        try:
            yield runs
        finally:
            PG.RUNNERS.update(orig)


def require_same_results(got: list, want: list, what: str) -> None:
    """Two runs' loadRes results, call by call and detection by detection:
    equal bit for bit (image, category, box, score and mask RLE)."""
    if [len(r) for r in got] != [len(r) for r in want]:
        raise AssertionError(f"{what}: kernels vs plain give other "
                             "per-call detection counts")
    for g, w in zip((d for r in got for d in r), (d for r in want for d in r)):
        if g != w:
            raise AssertionError(f"{what}: kernels vs plain differ: {g} vs "
                                 f"{w}")


def require_same_calls(nms_calls: list, roi_calls: list,
                       dcn_calls: list) -> str:
    """Each recorded K1, K2 and K4 call against its plain version on its
    own inputs, equal bit for bit -> how many of each."""
    check_nms_calls(nms_calls)
    check_roi_calls(roi_calls)
    for args, _, out in dcn_calls:
        want = sampling.sample_points_plain(*args)
        if not torch.equal(out, want):
            raise AssertionError(
                f"dcn_sample {tuple(args[0].shape)} S={args[1].shape[1]}: "
                "differs from the plain version by "
                f"{float((out - want).abs().max())}")
    return (f"{len(nms_calls)} NMS calls (keep masks), {len(roi_calls)} "
            f"RoIAlign calls and {len(dcn_calls)} DCN sampling calls equal "
            "to the plain versions on their own inputs, bit for bit")


def gate_images(flags: dict, name: str) -> tuple:
    """(dataset, image ids) that the gate evaluates for a family."""
    images, ann = flags["--coco_images"], flags["--coco_ann"]
    if name == "pose2seg" and "--ochuman_val" in flags:
        images, ann = flags["--ochuman_images"], flags["--ochuman_val"]
    ds = CocoDetectionDataset(images, ann, label_map=None)
    return ds, ds.image_ids[:int(flags["--max_images"])]


def gate_expected(flags: dict, name: str, max_people: int) -> dict:
    """A family's kernel launches over the images the gate gives it, as
    its code makes them: a canvas and a forward an image (evaluate_coco at
    batch 1) of 6 K1 + 2 K2 (Mask R-CNN FPN), 2 K1 (C4) or 1 K1
    (RetinaNet); one K1 a
    YOLOv3 batch of 2; one K4 a chunk of ``max_people`` people of a
    Pose2Seg image; none for YOLACT R-50 (no DCN; Fast-NMS is torch)."""
    ds, ids = gate_images(flags, name)
    n = len(ids)
    if name == "pose2seg":
        return per({"dcn_sample": sum(
            -(-len(P2SE.image_keypoints(ds, i)) // max_people)
            for i in ids)})
    return per({"mask_rcnn_r50_fpn": {"nms": 6 * n, "roi_align": 2 * n,
                                      "canvas": n},
                "mask_rcnn_r50_c4": {"nms": 2 * n, "canvas": n},
                "retinanet_r50": {"nms": n, "canvas": n},
                "yolov3_608": {"nms": -(-n // 2)}}.get(name, {}))


def check_gate(rows: list, runs: dict, text: str, flags: dict,
               max_people: int, what: str) -> None:
    """All six families measured, no FAILED row, and each family's
    launches as gate_expected has them."""
    if [r[0] for r in rows] != GATE_NAMES or any(r[1] is None
                                                 for r in rows):
        raise AssertionError(f"{what}: rows {[(r[0], r[3]) for r in rows]}")
    if PG.failed(rows) or "FAILED" in text:
        raise AssertionError(f"{what}: a family failed\n{text}")
    for name in GATE_NAMES:
        want = gate_expected(flags, name, max_people)
        if runs[name]["launches"] != want:
            raise AssertionError(f"{what} {name}: launched "
                                 f"{runs[name]['launches']}, want {want}")


def gate_row(name: str, measured: dict, run: dict) -> str:
    return (f"{name} " + " ".join(f"{k} {v:.4f}" for k, v in measured.items())
            + f", {run['detections']} detections, launches "
            f"{compact(run['launches'])}")


def table_row(text: str, name: str) -> list:
    """The gate's table lines of a family."""
    return [ln for ln in text.splitlines() if ln.startswith(f"{name:<22}")]


def measured_in(text: str, name: str) -> bool:
    """A family's table lines name a metric (its row was measured)."""
    rows = table_row(text, name)
    return bool(rows) and all(ln[22:29].strip() not in ("", "-")
                              for ln in rows)


def write_gate_weights(root: Path, data: dict, kp_case: tuple, dev) -> dict:
    """The six checkpoints of the gate under upstream's file names and in
    upstream's formats, from numpy seeds: maskrcnn-benchmark's
    ``{"model": ...}`` files (the FPN's as phase 13's; C4's, with its
    duplicate res5, and RetinaNet's calibrated as phase 14's), dbolya's
    YOLACT R-50 state dict (its background logit shifted as phase 13's),
    darknet's yolov3.weights (phase 16's recipe) and Pose2Seg's last.pkl
    (calibrated as phase 15's on ``kp_case``) -> how each was
    calibrated."""
    root.mkdir(parents=True)
    path = {f["name"]: root / f["weight"] for f in PG.FAMILIES}
    how = {}
    torch.save({"model": synthetic_state_dict(
        M.build_model(M.MaskRCNNConfig()), SEED)}, path["mask_rcnn_r50_fpn"])
    for name, variant in (("mask_rcnn_r50_c4", "c4"),
                          ("retinanet_r50", "retinanet")):
        sd, how[name] = family_state_dict(variant, ME.VARIANTS[variant][1](),
                                          dev, train=False)
        torch.save({"model": with_shared_res5(sd) if variant == "c4"
                    else sd}, path[name])
    cfg = yolact_model_config("yolact_resnet50_config")
    model = YM.build_model(cfg)
    model.load_state_dict(synthetic_yolact_state_dict(model, SEED + 50),
                          strict=True)
    model = model.to(dev)
    images = np.stack([resize_bilinear_u8(data["pixels"][i], cfg.img_size,
                                          cfg.img_size)
                       for i in data["ds"].image_ids])
    shift = calibrate_yolact_gate(
        model, yolact_preprocess(torch.from_numpy(images).to(dev),
                                 cfg.img_size), want=(10, 500), margin=0.0)
    how["yolact_r50_550"] = f"background logit +{shift:.2f}"
    torch.save({k: v.cpu() for k, v in model.state_dict().items()},
               path["yolact_r50_550"])
    del model
    write_darknet_weights(path["yolov3_608"], Y3.YoloV3Config(input_size=608),
                          SEED + 40)
    p2s_cfg = P2S.Pose2SegConfig()
    sd = synthetic_pose2seg_state_dict(p2s_cfg, SEED + 30)
    margin = calibrate_pose2seg(sd, p2s_cfg, *kp_case, dev)
    how["pose2seg"] = f"classifier margin {margin:.4g} removed"
    torch.save(sd, path["pose2seg"])
    torch.cuda.empty_cache()
    return how


def gate_process(argv: list, inject: str | None = None) -> tuple:
    """``python -m tpuseg_torch.tools.parity_gate ARGV`` in a subprocess
    (with ``inject``, YOLOv3's evaluation first made to raise that error)
    -> (exit status, its output)."""
    code = ["import runpy, sys"]
    if inject:
        code += ["from tpuseg_torch.engine import yolo_engine",
                 "def boom(*a, **k):",
                 f"    raise RuntimeError({inject!r})",
                 "yolo_engine.evaluate_coco_boxes = boom"]
    code += [f"sys.argv = ['parity_gate'] + {argv!r}",
             "runpy.run_module('tpuseg_torch.tools.parity_gate', "
             "run_name='__main__')"]
    proc = subprocess.run([sys.executable, "-c", "\n".join(code)],
                          cwd=Path(__file__).resolve().parent,
                          capture_output=True, text=True,
                          timeout=GATE_SECONDS)
    return proc.returncode, proc.stdout + proc.stderr


def phase_gate(dev, data: dict, tmp: Path, card: str) -> dict:
    """Phase 19: the parity gate as a user runs it, ``--device cuda``: its
    smoke mode through the kernels and the plain versions; its real mode
    at the published sizes over phase 13's dataset and a keypoint dataset,
    on six synthetic checkpoints in upstream's formats; a missing weight
    file; a family that raises."""
    from tpuseg_torch.kernels import dcn as dcn_kernel

    t0 = time.perf_counter()
    device = dev.type
    out = {"counts": {}, "times": {}}

    # (a) smoke mode, kernels vs plain (TF32 off, deterministic cuDNN)
    images, ann = PG.write_smoke_dataset(str(tmp / "smoke"))
    smoke_flags = {"--coco_images": images, "--coco_ann": ann,
                   "--max_images": "2"}
    smoke = {}
    with exact_convs():
        for path, ctx in (("kernels", contextlib.nullcontext),
                          ("plain", kernels.force_plain)):
            with ctx(), gate_runs() as runs, quiet() as buf:
                rows = PG.main(["--smoke", "--device", device])
            smoke[path] = (rows, runs, buf.getvalue())
    (rows, runs, text), (prows, pruns, ptext) = (smoke["kernels"],
                                                 smoke["plain"])
    check_gate(rows, runs, text, smoke_flags, GATE_SMOKE_PEOPLE, "smoke")
    if PG.failed(prows) or any(any(r["launches"].values())
                               for r in pruns.values()):
        raise AssertionError(f"smoke, plain: {ptext}")
    lines = []
    for (name, got, *_), (_, want, *_) in zip(rows, prows):
        what = f"gate smoke {name}"
        same = agree(got, want, runs[name]["detections"],
                     pruns[name]["detections"], what)
        if name == "yolact_r50_550":
            require_same_detections(runs[name]["scored"],
                                    pruns[name]["scored"], what)
        else:
            require_same_results(runs[name]["scored"], pruns[name]["scored"],
                                 what)
        out["counts"][f"gate_smoke_{name}"] = runs[name]["launches"]
        lines.append(f"{gate_row(name, got, runs[name])}; plain {same}")
    log(f"[19 gate] --smoke --device {device}: six rows measured, none "
        "FAILED (exit status 0); kernels vs plain (TF32 off, deterministic "
        "cuDNN), each family's scored detections (loadRes's results; "
        "YOLACT's postprocess_image) equal bit for bit, the rows "
        "degenerate (random weights saturate the heads: 0 AP and capped "
        "counts but for Pose2Seg's): " + "; ".join(lines))

    # (b) real mode at the published sizes on synthetic checkpoints
    rng = np.random.default_rng(SEED + 31)
    kp_case = (textured_image(rng, 480, 640),
               template_people(rng, 6, 480, 640))
    t_w = time.perf_counter()
    how = write_gate_weights(tmp / "weights", data, kp_case, dev)
    t_w = time.perf_counter() - t_w
    kp_images, kp_ann = write_keypoint_dataset(tmp / "keypoints", SEED + 32)
    flags = {"--weights_dir": str(tmp / "weights"),
             "--coco_images": data["img_dir"], "--coco_ann": data["ann"],
             "--ochuman_images": kp_images, "--ochuman_val": kp_ann,
             "--max_images": str(GATE_MAX_IMAGES), "--device": device}
    argv = [a for kv in flags.items() for a in kv]
    with gate_runs() as runs, quiet() as buf, \
            recording_nms() as k1, \
            recording_calls(sampling, "multilevel_roi_align") as k2, \
            recording_calls(dcn_kernel, "sample_points") as k4:
        t_real = time.perf_counter()
        rows = PG.main(argv)
        t_real = time.perf_counter() - t_real
    text = buf.getvalue()
    check_gate(rows, runs, text, flags, P2S.Pose2SegConfig().max_people,
               "real mode")
    with torch.inference_mode():
        same = require_same_calls(k1, k2, k4)
    del k1, k2, k4
    verdict = [ln for ln in text.splitlines()
               if ln.startswith("worst |delta|")]
    if len(verdict) != 1 or not any(f"-> {v} (" in verdict[0]
                                    for v in ("PASS", "ATTENTION")):
        raise AssertionError(f"real mode: verdict {verdict}\n{text}")
    lines, timing = [], []
    for name, got, *_ in rows:
        r = runs[name]
        n = len(gate_images(flags, name)[1])
        out["counts"][f"gate_{name}"] = r["launches"]
        out["times"][f"gate {name} s"] = r["s"]
        out["times"][f"gate {name} evaluation img/s"] = n / r["eval_s"]
        lines.append(gate_row(name, got, r)
                     + (f" ({how[name]})" if name in how else ""))
        timing.append(f"{name} {r['s']:.2f} s, its evaluation "
                      f"{r['eval_s']:.2f} s = {n / r['eval_s']:.2f} img/s "
                      f"({n} images)")
    log(f"[19 gate] real mode --device {device} at the published sizes "
        "(YOLACT 550, the detectron family 800/1333, YOLOv3 608, Pose2Seg "
        f"512), --max_images {GATE_MAX_IMAGES}, over phase 13's COCO dataset "
        "and an 8-image keypoint dataset as --ochuman_*, on six synthetic "
        f"upstream-format checkpoints (written in {t_w:.1f} s): every row "
        "measured, no FAILED row, launches as predicted, " + same + "; "
        + "; ".join(lines) + f"; verdict line: {verdict[0]}")
    log(f"[19 timing] the gate's real mode, host clock, per family (its "
        "runner: the predictor built from its checkpoint on the card, the "
        "evaluation with COCOeval or YOLACT's mAP): " + "; ".join(timing)
        + f"; the whole run {t_real:.2f} s [{card}]")

    # (c) a missing weight file: its row SKIP, the others measured, exit 0
    missing = tmp / "weights" / "yolov3.weights"
    missing.rename(tmp / "yolov3.weights")
    only = "mask_rcnn_r50_fpn,yolov3_608,pose2seg"
    rc, text = gate_process(argv + ["--only", only])
    skip = table_row(text, "yolov3_608")
    if (rc != 0 or skip != [f"{'yolov3_608':<22}{'-':<7}{'-':>9}{'-':>9}"
                            f"{'-':>8}  SKIP (no weights)"]
            or not all(measured_in(text, n)
                       for n in ("mask_rcnn_r50_fpn", "pose2seg"))
            or "FAIL" in text):
        raise AssertionError(f"a missing yolov3.weights: exit {rc}\n{text}")
    # a family that raises: its row FAILED, the verdict FAIL, exit 1
    rc2, text2 = gate_process(["--smoke", "--device", device, "--only",
                               "yolov3_608,pose2seg"], "injected fault")
    if (rc2 != 1 or not any("FAILED: injected fault" in ln
                            for ln in table_row(text2, "yolov3_608"))
            or not measured_in(text2, "pose2seg")
            or "FAIL: yolov3_608 raised" not in text2 or "PASS" in text2):
        raise AssertionError(f"a raising family: exit {rc2}\n{text2}")
    log(f"[19 gate] faults, each in a subprocess: without yolov3.weights "
        f"(--only {only}) its row is SKIP (no weights), the other two "
        f"measured, exit status {rc}; YOLOv3's evaluation made to raise "
        f"(--smoke --only yolov3_608,pose2seg): its row 'FAILED: injected "
        f"fault', Pose2Seg's measured, 'FAIL: yolov3_608 raised', no PASS, "
        f"exit status {rc2}")
    log(f"[19 total] phase 19 in {time.perf_counter() - t0:.1f} s")
    return out


# ---------------------------------------------------------------------------
# phase 20: ViTDet-B Mask R-CNN
# ---------------------------------------------------------------------------

VITDET_FRAMES = 3  # 640x480 frames, one request each
# class-box candidates a frame into the final NMS (which keeps 100) that
# the class layer's scale is raised to
VITDET_MIN_CANDIDATES = 50
VITDET_PER_FRAME = {"nms": 6, "roi_align": 2, "canvas": 1}
# the canvas kernel's checked and timed shapes: (name, frame (h, w), sizes,
# RGB mean/std else BGR mean): a 640x480 frame onto ViTDet's 1024 canvas
# and onto the FPN's 800/1333 one, and a 1920x1080 frame (a downscale) onto
# the FPN's
CANVAS_TIMED = (("vitdet 1024", (480, 640), 1024, 1024, True),
                ("fpn 800/1333", (480, 640), 800, 1333, False),
                ("fpn 800/1333", (1080, 1920), 800, 1333, False))


def vitdet_weights(model) -> None:
    """build_model's random weights, but the relative-position tables
    N(0, 1/64) and the LayerNorm scales U(0.7, 1.3): upstream zero-inits
    the tables, and a zero table or a unit scale would hide a mis-indexed
    table or a missing norm."""
    g = torch.Generator().manual_seed(SEED + 41)
    with torch.no_grad():
        for name, t in model.named_parameters():
            if ".rel_pos_" in name:
                t.copy_(torch.randn(t.shape, generator=g) * t.shape[1] ** -0.5)
            elif name.endswith(".weight") and t.ndim == 1:
                t.copy_(0.7 + 0.6 * torch.rand(t.shape, generator=g))


def calibrate_vitdet(pred: MaskRCNNPredictor, frames: list) -> str:
    """The class layer's weights scaled by the least power of 2 at which
    every frame sends VITDET_MIN_CANDIDATES class-box candidates past 0.05
    to the final NMS (at N(0, 1/fan) each of the 81 scores is near 1/81)."""
    canv, hws = [], []
    for img in frames:
        c, hw, _ = preprocess_image_bgr(img, pred.min_image_size,
                                        pred.max_image_size, pred.rgb_norm)
        canv.append(c)
        hws.append(hw)
    images = torch.from_numpy(np.stack(canv).transpose(0, 3, 1, 2).copy())
    images = images.to(pred.device)
    image_hw = torch.tensor(hws, dtype=torch.int64, device=pred.device)
    model = pred.model
    w = model.roi_heads.box.predictor.cls_score.weight
    with torch.inference_mode():
        base = w.clone()
        feats = model.backbone(images)
        for e in range(12):
            w.copy_(base * 2 ** e)
            n = M.forward_heads(model, feats, image_hw,
                                tuple(images.shape[-2:]))[
                "candidate_valid"].sum(1)
            if int(n.min()) >= VITDET_MIN_CANDIDATES:
                return (f"cls_score weights x {2 ** e}: {n.tolist()} "
                        "class-box candidates a frame")
    raise AssertionError(f"no cls_score scale gives {VITDET_MIN_CANDIDATES} "
                         f"candidates a frame ({n.tolist()})")


def canvas_bits_differing(call, pred: MaskRCNNPredictor) -> int:
    """Values of a recorded ``CV.build_canvas`` call's canvases whose bits
    differ from ``preprocess_image_bgr``'s for the same frames at the
    predictor's sizes."""
    (imgs, sizes, canvas_hw, *_), _, (got, _) = call
    differ = 0
    for img, (th, tw), canvas in zip(imgs, sizes, got.cpu()):
        want, hw, _ = preprocess_image_bgr(img, pred.min_image_size,
                                           pred.max_image_size, pred.rgb_norm)
        if hw != (th, tw) or want.shape[:2] != tuple(canvas_hw):
            raise AssertionError(f"canvas sizes {(th, tw)} on {canvas_hw}; "
                                 f"the host's {hw} on {want.shape[:2]}")
        differ += int((canvas.permute(1, 2, 0).contiguous().view(torch.int32)
                       != torch.from_numpy(want).view(torch.int32)).sum())
    return differ


def time_canvas(img: np.ndarray, lo: int, hi: int, rgb_norm, dev) -> tuple:
    """The canvas of one frame at sizes ``lo``/``hi``, normalised by
    ``rgb_norm`` or BGR less maskrcnn-benchmark's mean: the kernel's canvas
    and the plain version's on the card must equal ``preprocess_image_bgr``'s
    bit for bit. -> (kernel ms through the wrapper, plain ms, bound ms, what
    bounds it, F.interpolate's antialiased bilinear resize of the f32
    frame, the launch alone, values whose bits differ)."""
    (th, tw), chw = ME.canvas_geometry(*img.shape[:2], lo, hi)
    mean, std = rgb_norm or (ME.DETECTRON_PIXEL_MEAN_BGR, None)
    rgb = std is not None
    host, hw, _ = ME.preprocess_image_bgr(img, lo, hi, rgb_norm)
    want = torch.from_numpy(host).permute(2, 0, 1).contiguous().view(
        torch.int32)
    differ = {}
    for path, ctx in (("kernel", contextlib.nullcontext),
                      ("plain", kernels.force_plain)):
        with ctx():
            got, _ = CV.build_canvas([img], [(th, tw)], chw, mean, std, 0, dev)
        bits = got[0].cpu().contiguous().view(torch.int32)
        differ[path] = int((bits != want).sum())
        if hw != (th, tw) or not torch.equal(bits, want):
            raise AssertionError(
                f"canvas of a {img.shape[1]}x{img.shape[0]} frame at "
                f"{lo}/{hi}: the {path} path's size {(th, tw)}, the host's "
                f"{hw}; {differ[path]} values differ from the host's")
    k, p = time_pair(lambda: CV.build_canvas([img], [(th, tw)], chw, mean,
                                             std, 0, dev))
    x = torch.from_numpy(np.ascontiguousarray(img)).to(dev).permute(
        2, 0, 1)[None].float()
    lib = cuda_time_ms(lambda: F.interpolate(
        x, size=(th, tw), mode="bilinear", align_corners=False,
        antialias=True))
    buf = CV._pack([img], [(th, tw)], 0).to(dev)
    out = torch.empty((1, 3, *chw), device=dev)
    norm = [ctypes.c_float(v) for v in (*mean, *(std or (1.0,) * 3))]
    alone = cuda_time_ms(lambda: kernels.library().tpuseg_canvas_f32(
        buf.data_ptr(), 1, *chw, *norm, int(rgb), out.data_ptr(),
        kernels.stream_ptr(dev)))
    # the canvas written once and the frame read once; a subtraction (and
    # a division) a channel of each resized pixel
    return (k, p) + bound(3 * chw[0] * chw[1] * 4 + img.nbytes,
                          3 * (1 + rgb) * th * tw) + (
        lib, alone, sum(differ.values()))


def phase_vitdet(dev, card: str) -> dict:
    """Phase 20: MaskRCNNPredictor(cfg=ViTDetConfig()) at its published
    sizes, one 640x480 frame a run_on_bgr_image: the launches of each
    frame, each frame's canvas from the kernel equal bit for bit to the
    host's ``preprocess_image_bgr``, sane detections and masks, every K1
    and K2 call of the frames equal bit for bit to its plain version on
    its own inputs; at ``CANVAS_TIMED`` the kernel's and the plain
    version's canvases equal the host's bit for bit; then a frame on the
    host clock, the peak memory and the canvas kernel's times at
    ``CANVAS_TIMED`` (information)."""
    from tpuseg_torch.models.vitdet import ViTDetConfig

    t0 = time.perf_counter()
    pred = MaskRCNNPredictor(cfg=ViTDetConfig(), device=dev)
    if pred.variant != "vitdet" or pred.min_image_size != 1024:
        raise AssertionError(f"ViTDetConfig gave variant {pred.variant}, "
                             f"test size {pred.min_image_size}")
    vitdet_weights(pred.model)
    rng = np.random.default_rng(SEED + 43)
    frames = [textured_image(rng, *STREAM_HW) for _ in range(VITDET_FRAMES)]
    calib = calibrate_vitdet(pred, frames)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    counts, dets = [], []
    with recording_nms() as nms_calls, \
            recording_calls(sampling, "multilevel_roi_align") as roi_calls, \
            recording_calls(CV, "build_canvas") as canvas_calls:
        for img in frames:
            kernels.reset_launch_counts()
            res = pred.run_on_bgr_image(img)
            torch.cuda.synchronize()
            counts.append(kernels.launch_counts())
            dets.append(check_result(res, *img.shape[:2]))
    peak = torch.cuda.max_memory_allocated(dev)
    differ = [canvas_bits_differing(call, pred) for call in canvas_calls]
    if len(differ) != VITDET_FRAMES or any(differ):
        raise AssertionError(f"ViTDet: the kernel's canvases differ from "
                             f"the host's in {differ} values")
    want = per(VITDET_PER_FRAME)
    if any(c != want for c in counts):
        raise AssertionError(f"ViTDet: launches {counts} per frame; want "
                             f"{want}")
    if min(dets) == 0:
        raise AssertionError(f"ViTDet: no detections: {dets}")
    log(f"[20 vitdet] MaskRCNNPredictor(cfg=ViTDetConfig()) "
        f"{pred.min_image_size}x{pred.max_image_size} canvas, {calib}: "
        f"launches {compact(want)} on each of {VITDET_FRAMES} "
        f"{STREAM_HW[1]}x{STREAM_HW[0]} frames; each frame's canvas from "
        f"the kernel equals preprocess_image_bgr's bit for bit ({differ} "
        f"values differ); detections {dets}; its NMS "
        f"calls (kept/valid) equal the plain version bit for bit: "
        f"{check_nms_calls(nms_calls)}; its RoIAlign calls equal bit for "
        f"bit: {check_roi_calls(roi_calls)}")
    ms = []
    for img in frames:
        t = time.perf_counter()
        pred.run_on_bgr_image(img)
        ms.append(1e3 * (time.perf_counter() - t))
    rng = np.random.default_rng(20)
    times = {f"canvas {name} {w}x{h}": time_canvas(
        frames[0] if (h, w) == frames[0].shape[:2]
        else rng.integers(0, 256, (h, w, 3), dtype=np.uint8),
        lo, hi, pred.rgb_norm if rgb else None, dev)
        for name, (h, w), lo, hi, rgb in CANVAS_TIMED}
    log(f"[20 vitdet] a frame {np.median(ms):.2f} ms on the host clock "
        f"(median of {len(ms)}); peak memory {peak / 1e9:.2f} GB; "
        + "; ".join(f"{label}: kernel and plain canvases equal the "
                    f"host's bit for bit ({t[6]} values differ), kernel "
                    f"{t[0]:.4f} ms (the launch alone {t[5]:.4f} ms), plain "
                    f"{t[1]:.4f} ms, bound {t[2]:.4g} ms by {t[3]}, "
                    f"F.interpolate {t[4]:.4f} ms"
                    for label, t in times.items())
        + f"; phase 20 in {time.perf_counter() - t0:.1f} s [{card}]")
    return {"counts": per(VITDET_PER_FRAME, VITDET_FRAMES), "times": times,
            "label": next(iter(times)),
            "differ": sum(differ) + sum(t[6] for t in times.values())}


def kernel_entry(name, source, replaces, launches: dict, err, t) -> dict:
    entry = {"name": name, "route": "cuda", "source": source,
             "replaces": replaces, "launches": sum(launches.values()),
             "launches_by_path": launches, "max_abs_err": err, "ms": t[0],
             "plain_ms": t[1], "bound_ms": t[2], "bound_by": t[3],
             # no PyTorch call computes NMS or multi-level RoIAlign (or its
             # gradient) without torchvision, which is not a dependency;
             # grid_sample computes DCN sampling, its backward the sampler's
             "library_ms": t[4] if len(t) > 4 else None}
    if len(t) > 5:  # the launch alone, without the dispatch around it
        entry["kernel_alone_ms"] = t[5]
    return entry


def shape_entry(t) -> dict:
    """A kernel's numbers at one more shape: (ms, plain, bound, by, library,
    launch alone)."""
    return {"ms": t[0], "plain_ms": t[1], "bound_ms": t[2], "bound_by": t[3],
            "library_ms": t[4], "kernel_alone_ms": t[5]}


def ptxas_summary(log_text: str) -> list:
    """'kernel<template args>: N registers, spills S/L bytes' for each
    kernel that ``nvcc -Xptxas -v`` compiled (the names demangled by hand:
    f is f32, 13__nv_bfloat16 bf16, Li4E the integer 4)."""
    out, name = [], None
    for ln in log_text.splitlines():
        if "Compiling entry function" in ln:
            mangled = ln.split("'")[1]
            base = re.search(r"([a-z_]+_kernel)", mangled).group(1)
            targs = re.search(base + r"I(.*?)EEv", mangled)
            kinds = re.findall(r"13__nv_bfloat16|Li\d+E|f", targs.group(1)
                               ) if targs else []
            parts = ["bf16" if k[0] == "1" else "f32" if k == "f" else k[2:-1]
                     for k in kinds]
            name = base + (f"<{','.join(parts)}>" if parts else "")
            spills = "spills not reported"
        elif "spill stores" in ln and name:
            st, ld = re.findall(r"(\d+) bytes spill", ln)
            spills = f"spills {st}/{ld} bytes"
        elif "registers" in ln and name:
            regs = re.search(r"Used (\d+) registers", ln).group(1)
            out.append(f"{name}: {regs} registers, {spills}")
            name = None
    return out


def main() -> int:
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: this smoke test needs a GPU")
    start = time.perf_counter()
    dev = torch.device("cuda", 0)
    card = nvidia_smi()
    log(f"[1 card] {card}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, {torch.cuda.device_count()} device(s); "
        f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}, "
        f"matmul precision {torch.get_float32_matmul_precision()}")

    t0 = time.perf_counter()
    lib_path = kernels.build()
    kernels.library()
    ptxas = ptxas_summary((lib_path.parent / "build.log").read_text())
    log(f"[2 build] {lib_path.relative_to(Path(__file__).resolve().parent)} "
        f"in {time.perf_counter() - t0:.1f} s; ptxas: {'; '.join(ptxas)}")

    nms_res = phase_nms(dev)
    roi_res = phase_roi_align(dev)
    bwd_res = phase_roi_align_bwd(dev)
    dcn_res = phase_dcn(dev)
    dcn_bwd_res = phase_dcn_bwd(dev)
    with tempfile.TemporaryDirectory() as tmp:
        pred, infer_counts = phase_slice(dev, Path(tmp))
        train = phase_train(dev, Path(tmp))
        yolact = phase_yolact(dev)
        paste = phase_mask_paste(dev, yolact, card)
        yolact_train = phase_yolact_train(dev, Path(tmp))
    train_counts, yolact_counts = train["counts"], yolact["counts"]
    yolact_train_counts = yolact_train["counts"]
    times = phase_timing(dev, pred, train, card)
    times.update(time_yolact(dev, yolact, card))
    times.update(paste["times"])
    times.update(time_yolact_train(dev, yolact_train, card))
    del pred, train, yolact, yolact_train
    torch.cuda.empty_cache()
    # phase 13's dataset and checkpoints stay for phase 18's CLIs and
    # phase 19's gate
    coco_tmp = tempfile.TemporaryDirectory()
    with tempfile.TemporaryDirectory() as family_tmp:
        tmp = coco_tmp.name
        family = phase_family(dev, Path(family_tmp), card)
        times.update(family["times"])
        data = phase_coco_data(dev, Path(tmp), card)
        coco_mrcnn = phase_coco_maskrcnn(dev, data, Path(tmp), card)
        coco_yolact = phase_coco_yolact(dev, data, Path(tmp), card)
        clis = phase_clis(dev, data, coco_mrcnn, coco_yolact, Path(tmp),
                          card)
        family["counts"].update(phase_family_clis(dev, data, family,
                                                  Path(tmp), card))
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        pose2seg = phase_pose2seg(dev, Path(tmp), card)
    times.update(pose2seg["times"])
    torch.cuda.empty_cache()
    t16 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        yolo = phase_yolo(dev, Path(tmp), card)
        torch.cuda.empty_cache()
        vit = phase_vit(dev, Path(tmp), card)
    times.update(yolo["times"])
    times.update(vit["times"])
    log(f"[16 total] phase 16 in {time.perf_counter() - t16:.1f} s")
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        bf16 = phase_bf16(dev, Path(tmp), card)
    times.update(bf16["times"])
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        multi = phase_multi_gpu(dev, Path(tmp), clis, card)
    times.update(multi["times"])
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        gate = phase_gate(dev, data, Path(tmp), card)
    coco_tmp.cleanup()
    times.update(gate["times"])
    torch.cuda.empty_cache()
    vitdet = phase_vitdet(dev, card)

    def launches(name):
        """Per path: the Mask R-CNN forward, three Mask R-CNN training
        steps, one YOLACT++ forward, predict_images over phase 10's four
        640x480 frames, three YOLACT++ training steps; phase
        13's: evaluate_coco over 16 images, evaluate_dataset over 16, and
        each CLI's run; phase 14's: one B = 2 forward and three training
        steps of C4, Faster R-CNN FPN and RetinaNet, and their CLIs'
        runs; phase 15's: Pose2Seg's run_on_image of each image in f32 and
        bf16, three training steps and its CLIs' runs; phase 16's: YOLOv3's
        run_batch at B = 1 and 8 in f32 and bf16, evaluate_coco_boxes over
        16 images, three training steps and its CLIs' runs, ViT-B/16's
        classifier and forwards, three training steps and its CLIs' runs;
        phase 17's: one bf16 B = 2 forward of each detectron model, three
        bf16 training steps of Mask R-CNN and of YOLACT++, the DarkNet
        YOLACT forward and its bf16 training CLI; phase 18's: two YOLACT++
        replicas at B = 8 and two Mask R-CNN replicas at B = 2 and 1, the
        world-size-1 rank's steps (YOLACT++ two plain and two DDP, Mask
        R-CNN two plain and one DDP), and
        the two gloo ranks' YOLACT++ steps (two each) and Mask R-CNN steps
        (one each) together; phase 19's: each family of the parity gate in
        its smoke mode and in its real mode; phase 20's: ViTDet's
        run_on_bgr_image over its frames."""
        return {"inference": infer_counts[name],
                "training": train_counts[name],
                "yolact_inference": yolact_counts[name],
                "yolact_predict_images": paste["counts"][name],
                "yolact_training": yolact_train_counts[name],
                "coco_evaluate_coco": coco_mrcnn["counts"][name],
                "coco_evaluate_dataset": coco_yolact["counts"][name],
                **{f"cli_{c}": n[name] for c, n in clis["counts"].items()},
                **{path: n[name] for path, n in family["counts"].items()},
                **{path: n[name] for path, n in pose2seg["counts"].items()},
                **{path: n[name] for path, n in yolo["counts"].items()},
                **{path: n[name] for path, n in vit["counts"].items()},
                **{path: n[name] for path, n in bf16["counts"].items()},
                **{path: n[name] for path, n in multi["counts"].items()},
                **{path: n[name] for path, n in gate["counts"].items()},
                "vitdet_run_on_bgr_image": vitdet["counts"][name]}

    def pose2seg_shapes(prefix: str) -> dict:
        return {label: shape_entry(t)
                for label, t in pose2seg["shapes"].items()
                if label.startswith(prefix + " ")}

    def bf16_shapes(name: str) -> dict:
        return {f"{name} {label}": shape_entry(t)
                for label, t in bf16["shapes"][name].items()}

    log(f"[total] {time.perf_counter() - start:.1f} s from the start of "
        "main to the end of phase 20 (the kernels' build included)")
    k3 = "roi_align_bwd float32 N=1024 P=7"
    k4c = f"dcn_sample_bwd float32 B={DCN_BATCH} 69x69x128 s1"
    log(json.dumps({"kernels": [
        {**kernel_entry("nms", "tpuseg_torch/csrc/nms.cu",
                        "tpuseg/ops/pallas/nms_pl.py:138", launches("nms"),
                        nms_res["max_abs_err"],
                        times["nms B=2 class-aware N=2048"]),
         # the same kernel at the detectron family's shapes (phase 14) and
         # YOLOv3's class-aware NMS (phase 16), on the inputs the models
         # gave it; each equal to the plain version
         "shapes": {label: shape_entry(t)
                    for label, t in {**family["nms"],
                                     **yolo["nms"]}.items()}},
        # K2, K3, K4 and K4c also at the bf16 paths' shapes (phase 17),
        # and K4 and K4c at Pose2Seg's (phase 15), on the inputs the paths
        # gave them
        {**kernel_entry("roi_align", "tpuseg_torch/csrc/roi_align.cu",
                        "tpuseg/ops/pallas/roi_align_pl.py:576",
                        launches("roi_align"), roi_res["max_abs_err"],
                        times["roi_align float32 N=2000 P=7"]),
         "shapes": bf16_shapes("roi_align")},
        {**kernel_entry("roi_align_bwd",
                        "tpuseg_torch/csrc/roi_align_bwd.cu",
                        "tpuseg/ops/pallas/roi_align_pl.py:390",
                        launches("roi_align_bwd"), bwd_res["max_abs_err"],
                        times[k3]),
         "kernel_alone_direct_ms": times[k3 + " direct"],
         "shapes": bf16_shapes("roi_align_bwd")},
        {**kernel_entry("dcn_sample", "tpuseg_torch/csrc/dcn_sample.cu",
                        ["tpuseg/ops/pallas/dcn_pl.py:60",
                         "tpuseg/ops/pallas/dcn_pl.py:212"],
                        launches("dcn_sample"), dcn_res["max_abs_err"],
                        times[f"dcn_sample float32 B={DCN_BATCH} "
                              "69x69x128 s1"]),
         "shapes": {**pose2seg_shapes("dcn_sample"),
                    **bf16_shapes("dcn_sample"),
                    **{k: shape_entry(t) for k, t in
                       multi["shapes"]["dcn_sample"].items()}}},
        {**kernel_entry("dcn_sample_bwd",
                        "tpuseg_torch/csrc/dcn_sample_bwd.cu",
                        "tpuseg/ops/pallas/dcn_pl.py:311",
                        launches("dcn_sample_bwd"),
                        dcn_bwd_res["max_abs_err"], times[k4c]),
         "kernel_alone_split_ms": times[k4c + " split"],
         "shapes": {**pose2seg_shapes("dcn_sample_bwd"),
                    **bf16_shapes("dcn_sample_bwd"),
                    **{k: shape_entry(t) for k, t in
                       multi["shapes"]["dcn_sample_bwd"].items()}}},
        # at the stream's shape on the detector's layout; its error the
        # pixels that differ from the plain paste on the card (each within
        # 1e-5 of 0.5) and from the host's
        {**kernel_entry("mask_paste", "tpuseg_torch/csrc/mask_paste.cu",
                        "none: the JAX engine pastes on the host "
                        "(tpuseg/engine/yolact_engine.py postprocess_image)",
                        launches("mask_paste"), paste["flips"]["plain"][0],
                        times[paste["label"]]),
         "pixels_differing_from_host": paste["flips"]["host"][0]},
        # a 640x480 frame onto ViTDet's canvas and onto the FPN's, a
        # 1920x1080 one onto the FPN's; its error the values whose bits
        # differ from the host's canvas, over these and phase 20's frames
        {**kernel_entry("canvas", "tpuseg_torch/csrc/canvas.cu",
                        "none: the JAX engine builds the canvas on the host "
                        "(tpuseg/engine/maskrcnn_engine.py "
                        "preprocess_image_bgr)",
                        launches("canvas"), vitdet["differ"],
                        vitdet["times"][vitdet["label"]]),
         "shapes": {label: shape_entry(t)
                    for label, t in vitdet["times"].items()}},
    ]}))
    log(nvidia_smi())
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--rank"]:  # a rank of phase 18
        sys.exit(rank_main(*sys.argv[2:5]))
    if sys.argv[1:2] == ["--cli-rank"]:  # yolact_train under torchrun
        sys.exit(cli_rank_main(sys.argv[2], sys.argv[3:]))
    sys.exit(main())
