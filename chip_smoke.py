#!/usr/bin/env python3
"""GPU smoke run of the PyTorch/CUDA port (yolo_tpu_torch) on one card.

    python3 chip_smoke.py

Needs one CUDA device and nvcc (the kernels are built from
yolo_tpu_torch/csrc/ into build/yolo_tpu_torch/). Phases, each printing
JSON lines; any failed check raises and the script exits non-zero:

  1. device   nvidia-smi name and power limit, torch and CUDA versions
  2. build    compile the CUDA kernels from the checkout; count the
              wgmma instructions (HGMMA, IGMMA for int8) of each kernel
              in the library (cuobjdump --dump-sass): every bf16 conv
              kernel (BF16_WGMMA_KERNELS) and every s8 wgmma conv kernel
              (S8_WGMMA_KERNELS) must have some; the registers, stack and
              local memory that ptxas gave the fp32 conv, s8 conv (stem,
              wgmma, mma, dp4a, split-K reduction), int8 maxpool and NMS
              kernels (cuobjdump --dump-resource-usage): none may spill
              (stack and local memory 0)
  3. kernel   CUDA greedy-NMS suppress vs its plain PyTorch version on
              crowded scenes at the served shapes: identical keep masks
  4. serve    YOLOv2-COCO 416 (full width, seeded random weights written
              as a darknet .weights file) through yolo_tpu_torch.load and
              DetectionServer: HTTP responses equal direct detector calls,
              the kernel's launch counter rose, bf16 agrees with the fp32
              plain path at box level
  5. times    CUDA events: suppress vs plain per call over a run of
              back-to-back calls, on the crowded rows and on the seeded
              detector's own suppress inputs at batch 1 and 32 (captured
              from one forward; identical keep masks); end-to-end
              detector latency (median of synchronized calls) at batch
              1/32/128 (raw 480x640 uint8 in, bf16)
  6. conv     CUDA fused conv + bias + leaky/linear vs its plain version
              at each distinct shape of YOLOv2-COCO 416's 16 eligible
              convs, bf16 and fp32, batch 8 and batch 1 (the split-K
              plans); two calls on the same inputs give the same bytes
  7. entry    CUDA fused conv1 + bias + leaky + maxpool vs its plain
              version at 416x416 -> 208x208x32, bf16 and fp32
  8. routes   the same seeded YOLOv2-COCO 416 through
              detect_raw(conv_impl="cuda") and make_detector(cfg,
              entry="fused"), bf16 and fp32: 16 conv launches and 1
              entry launch per forward (and the NMS kernel's 1);
              box-level agreement with the fp32 plain path
  9. times    each kernel vs its plain version, the one PyTorch call
              that computes the same function where there is one
              (library_ms: F.conv2d with bias, cuDNN) and the card's bound
              for the same work (bound_ms), per conv shape at batch 1 and
              32 and summed over the 16 convs; both routes end to end
              beside the default route at batch 1/32/128 in bf16, and the
              default and conv_impl="cuda" routes in fp32 at batch 1/32

  10. train   YOLOv2-VOC 416 (full width and depth) fine-tuned from a
              seeded darknet19 backbone partial file (load_partial, the
              tail random_params(scale=0.03)) on seeded synthetic VOC
              scenes (data/synthetic.py: PNG + VOC XML), yolov2-voc.cfg's
              [net] schedule and augmentation: (a) one fp32 step on the
              card equals the same step on the CPU made to take the
              card's discrete choices (HeldChoices), its convs in
              float64 (float64_products): loss parts to a relative 1e-4,
              every trained tensor's update within STEP_BOUND and every
              rolling BN statistic's within STAT_BOUND, relative L2; the
              same step with TF32 on exceeds both bounds; (b) 20
              steps through train_batches -> DevicePrefetcher at batch
              64, fp32 and bf16, every loss part finite, step times from
              CUDA events in the loop and alone (ALONE_STEPS more on the
              last batch); (c) one step at grad_accum=8; (d) Adam
              overfits 8 fixed scenes: the loss and its coord and class
              parts fall below OVERFIT_FRACTION of their first values
  11. eval    quick_map on held-out scenes from the overfit state; the
              card's collect_detections and the CPU's on the held-out
              scenes, from the overfit state and from its snapshot after
              EARLY_STEPS (which keeps >= MIN_EVAL_BOXES detections
              there), agree at box level (every detection scoring >=
              conf + MARGIN has a same-class partner at VOC IoU >=
              MATCH_IOU, both ways) and in mAP to a relative MAP_REL;
              the NMS kernel ran on the eval path, and holds against its
              plain version on the eval grid (B*20, 5, 128) at conf
              0.005 that the path gave it; eval img/s; the overfit
              model's mAP on its own scenes above the untrained model's

  12. yolo    the yolov3/v4 family: yolov3, yolov3-spp, yolov3-tiny,
              yolov4 and yolov4-tiny at their published widths and sizes
              (416 / 608), seeded (synthetic_detector_params: residual
              branches scaled, [yolo] heads calibrated on a probe frame)
              and written as darknet .weights files, loaded by size
              through yolo_tpu_torch.load: detect_raw on raw 480x640
              frames in bf16 and fp32, on the default route and on
              conv_impl="cuda": the conv kernel's launches a forward equal
              YOLO_KERNEL_CONVS (yolov4's mish convs stay off it), one NMS
              launch, box-level agreement with the fp32 plain path (VOC
              +1 pixel IoU: a box in the letterbox's band unletterboxes
              to a line on the frame's edge), entry="fused" raises; a
              DetectionServer for YOLO_SERVED answers as direct calls;
              each conv shape the five have and YOLOv2-COCO does not,
              at batch 1 and 32 in bf16 and fp32, kernel against plain
              (phase 6's bounds) and timed as phase 9; end-to-end latency
              of yolov3 (batch 1/32/128) and yolov4 (1/32) on both routes
  13. train   20-class heads (each variant's layer builder, VOC names)
              on seeded synthetic VOC scenes, mosaic off, from seeded
              darknet partial files (darknet53.conv.74,
              yolov4.conv.137, yolov4-tiny.conv.29): (a) one fp32 step
              of yolov3 (mse, 416) and of yolov4 (ciou, mish, SPP, 608)
              at full width, card against CPU on a micro-batch of
              CHECK_BATCH images with the card's choices held (leaky
              sides, the SPP pools' maxima, the loss's ignore gates) and
              phase 10's bounds (yolov4's update bound 2x, its fp32
              floor: YOLO_STEP_BOUND), which TF32 on fails; (b) TRAIN_STEPS
              steps of yolov4 at the cfg's batch 64, subdivisions 8, fp32
              and bf16; (c) an Adam overfit of yolov4-tiny on
              YOLO_OVERFIT_SCENES scenes, scored by quick_map, card and
              CPU held at box level as in phase 11

  14. images  real image files through the port's own host decoder
              (yolo_tpu_torch/native/: JPEG, PNG, BMP, PNM, TIFF, WebP,
              GIF, Sun raster, PFM and HDR, built by the host C compiler
              in phase 2): (a) no OpenCV
              loaded; (b) the fixtures of tests/data/torch_jpeg/ decode to
              the sha256 of cv2's output recorded beside them, and the
              fixtures of the kinds beyond one baseline scan (progressive,
              multi-scan, arithmetic, CMYK, YCCK, interlaced and gamma
              PNG) go through `detect --images` (YOLOv2-COCO 416, one file
              a batch, --conf FIXTURE_CONF) and POST /detect; the BMP,
              PNM, TIFF, WebP, GIF, Sun raster, PFM and HDR fixtures of an
              RGB image and the damaged and overflowing JPEGs through
              `predict --image` and POST /detect, the BMPs also through
              `detect --images --output-dir`, a TIFF and a WebP also on
              conv_impl="cuda": every file yields boxes, one NMS launch a
              file, the lines equal detect_raw on the decoded arrays and
              the answers direct calls; `predict --output` of a 480x640
              frame as TIFF and WebP reads back as draw_detections of its
              boxes, as GIF has encode_gif's bytes of them, that frame
              saved as PAM, Sun raster, PFM and HDR alike, the GIF
              writer's bytes of a seeded gradient frame hash as cv2's;
              (c) decode rates of a 480x640
              4:2:0 q90 JPEG, of the 480x640 progressive fixture, of a
              24-bit BMP of the frame (the port's writer) and of the
              480x640 LZW TIFF, q80 and lossless WebP, GIF and HDR
              fixtures, ms an image on one thread and img/s on
              IMAGE_THREADS threads, the TIFF, lossless WebP and GIF
              writers' ms a frame on one thread (8
              threads at least twice one for the JPEGs, where the host
              has 4 cores), the host letterbox of the
              frame to 416 on one thread, and a 480x640 Paeth PNG's
              unfilter in C against the Python version; (d) yolov3 @416,
              COCO-80, seeded weights (as phase 12), on COCO_SCENES
              COCO-format JPEG scenes (data/synthetic.py
              write_coco_scenes): load_coco -> build_ground_truth ->
              collect_detections on the card (NMS kernel; again with
              conv_impl="cuda", the two routes matched at phase 12's
              rate) -> evaluate_coco's 12 cells; on
              COCO_CPU_SCENES of them card and CPU agree at box level
              (phase 11's rule, both ways) and in every cell to a
              relative COCO_REL, against the scenes' ground truth (the
              seeded detector finds none of their objects: every cell
              0) and against pseudo ground truth made from the CPU's
              detections (pseudo_ground_truth: cells in (0, 1));
              the NMS kernel holds against its plain
              version on the COCO eval grid and is timed there; JPEG
              files -> inference_batches -> DevicePrefetcher ->
              make_detector_preprocessed at batch COCO_BATCH in bf16 on
              both routes, beside the same frames fed from the card's
              memory and the host pipeline alone; (e) HTTP_BODIES JPEG
              bodies to a yolov3 DetectionServer answer as direct calls
              on the frames decode_image_bytes gives

  15. cfg     darknet .cfg files through yolo_tpu_torch.load(weights,
              cfg=..., names=...): (a) cfg_to_string of YOLOv2-COCO,
              yolov3, yolov4 and yolov4-tiny at their published sizes,
              loaded on the seeded .weights of phases 4 and 12: the
              config is get_variant's and the detections equal the
              built-in variant's (torch.equal), bf16 and fp32, on both
              routes; (b) yolov4's topology with yolov4-csp-swish.cfg's
              head conventions (swish, logistic head convs, new_coords,
              scale_x_y 2) at [net] 640x384 and (c) yolov3 with
              [Gaussian_yolo] heads (COCO-80, 267-filter head convs),
              seeded: both routes in bf16 and fp32 (the conv kernel's
              launches a forward equal the gate's count, one NMS launch,
              phase 12's box-level rule against the fp32 plain path),
              entry="fused" refused, a DetectionServer answering as
              direct calls; (d) every other option (grouped, depthwise
              and dilated convs, weighted shortcuts, sam, an SE block,
              relu, ramp) in one net at 416, card against CPU: logits
              within CFG_LOGIT_REL, boxes at box level; (e) 20-class (b)
              and (c), TrainConfig from train_config_from_cfg: one fp32
              step card against CPU as phase 13 (a), then CFG_TRAIN_STEPS
              bf16 steps at batch CFG_TRAIN_BATCH; (f) their end-to-end
              latency at batch 1 and 32, and (b)'s rectangular conv
              shapes held against plain and timed as phase 12 (c)

  16. cli     the command line (yolo_tpu_torch.cli.main in this process,
              the kernels' counts set to 0 before each command and read
              after it): (a) predict of YOLOv2-COCO and yolov3 416 on the
              seeded .weights of phases 4 and 12 and a phase-14 JPEG, bf16
              and fp32: the printed lines equal a direct load() call's,
              one NMS launch each, --output writes a PNG and a JPEG the
              port's decoder reads back at the source's size; the wall
              time of `python -m yolo_tpu_torch.cli predict` in a new
              process; (b) detect --images over phase 14's JPEG set at
              batch COCO_BATCH on the card's letterbox and with
              --host-preprocess: one NMS launch a batch, the first
              batch's lines equal direct calls, img/s of the command and
              without its load of the weights; --output-dir and
              --save-labels over CLI_OUTPUT_IMAGES of them both ways;
              (c) eval --coco-json in fp32 prints phase 14's cells and
              saves its detections; recall runs on the set; (d) train of
              YOLOv2-VOC 416 from the seeded darknet19 partial file on
              CLI_TRAIN_SCENES synthetic JPEG scenes (batch 64,
              subdivisions 8, bf16): CLI_TRAIN_STEPS steps with a
              checkpoint each, --resume from step CLI_RESUME_STEP for one
              epoch, from the first as the JAX command's loader: update,
              statistics and momentum within phase 10's STEP_BOUND /
              STAT_BOUND of one library step from the checkpoint;
              export to .weights, and load() of it detects as load() of
              the checkpoint; (e) `python -m yolo_tpu_torch.cli serve` in
              a subprocess: its answers to JPEG bodies equal direct calls,
              its GET /stats reports the NMS launches, added to the
              kernels line's count; no module of jax, yolo_tpu or cv2 is
              loaded

  17. tree    YOLO9000 and the darknet classifiers: (a) darknet's
              yolo9000.cfg (darknet-19 at 544, a 1x1 head of 3 * (5 +
              9418) filters, [region] tree= and map=) written as .cfg
              text beside a generated 9418-node tree (data/synthetic.py,
              the 9k tree's shape) and an 80-leaf map, seeded weights
              (yolo9000_params) loaded by load(cfg=...): batch 1 and 32 in
              bf16, default route and conv_impl="cuda", traversal and map
              mode: the kernels' launches a forward, the fused tree head
              against the fp32 plain path (reference decode + exact
              per-class NMS) at box level, img/s and peak GiB, and the
              NMS kernel against plain on the tree head's grid; its 13
              kernel convs' six shapes at 544, batch 1 and 32, bf16 and
              fp32, against plain (phase 6's bounds) and timed; (b) the
              exact per-class eval at 9418 classes, batch TREE_EVAL_BATCH:
              the (B * 9418, 5, 128) grid in one launch, kernel against
              the row-chunked plain version, timed; the kernel path in
              class chunks gives the same detections; collect_detections
              card against CPU on TREE_EVAL_SCENES of phase 14's JPEGs at
              box level and in each COCO cell against pseudo ground truth
              (phase 14's rule); (c) one fp32 step with the tree region
              loss, card against CPU as phase 10 (a); (d) darknet19-448
              at 448 and darknet53 at 256 (1000 classes, seeded He
              weights): fp32 probabilities card against CPU within
              CLS_PROB_ERR, the same top-5, bf16 img/s at batch 1 and 64;
              a darknet9000-style tree classifier's hierarchy_path card
              against CPU and `classify --hierarchy`; CLS_TRAIN_STEPS
              classifier steps through classifier_train_batches from
              seeded JPEG class folders, card against CPU (choices held,
              phase 10's bounds); `classify` and POST /classify equal to
              direct calls
 18. yolov1   darknet's cfg/yolov1.cfg at 448, full width (YOLOV1_CFG:
              24 convs, [local], [dropout], a spatial [connected],
              [detection]), seeded weights written as .weights and read
              by load(cfg=...): (a) bf16 and fp32 on the default route
              and conv_impl="cuda" (20 kernel convs, one NMS launch a
              forward) against the fp32 plain path at box level, HTTP
              answers equal direct calls, head="fused" and entry="fused"
              raise, img/s and peak GiB at batch 1 and 32; (b) its 11
              kernel conv shapes (56/28/14/7 px) at batch 1 and 32, bf16
              and fp32, against plain (phase 6's bounds) and timed; (c)
              the NMS kernel against plain on the (32, 5, 256) grid a
              forward hands it, timed; (d) one fp32 detection-loss step
              card against CPU (choices held, V1_STEP_BOUND), the
              [dropout] masks equal on both sides; (e) `predict --cfg`
              prints load()'s detections
 19. int8     int8 post-training quantization (models/quantize.py) of
              YOLOv2-COCO 416 on phase 4's seeded weights, calibrated by
              prepare_int8 on INT8_CALIB seeded frames (host letterbox),
              chained, served in bf16 (the CLI's --precision int8): (a)
              the s8 kernel (csrc/conv_s8_bias_act.cu) against its plain
              block on the same card tensors at every conv shape of the
              net (conv 0 on the stem body, also with STEM_POOLS fused,
              against the plain block then the plain pool) and
              INT8_EXTRA_SHAPES (grouped, dilated), batch 1 and 32, int8
              codes and bf16 in, int8, bf16 and fp32 out; the int8
              maxpool kernel (csrc/maxpool_s8.cu) against the running
              maximum at the net's pool inputs, 2x2/2, 2x2/1 and 3x3/1:
              the same bytes; (b) a served forward makes INT8_CONVS s8
              launches (conv 0 with pool 1 fused), INT8_POOLS int8-pool
              launches and one NMS launch, no bf16 conv or entry kernel
              launch, no plain block or plain int8 pool on the card; (c)
              tests/test_quantize.py's gates against the fp32
              plain path (score deviation < INT8_GATE_DEV, top-50
              overlap > INT8_GATE_OVERLAP) on the batch calibrated on,
              as the JAX tests take them, and the box-level match share
              both ways, printed; (d) card against CPU on the same int8
              params at batch 2: every layer's output equal (return_all,
              nothing fused), int8 codes at each chained boundary, and
              the logits on the fused route equal; (e) `predict
              --precision int8` prints a direct call's detections, and
              an int8 server (serve's _serve_net + DetectionServer)
              answers a JPEG and an .npy body as direct calls; (f) int8
              img/s at batch 1/32/128 beside the bf16 default route and
              conv_impl="cuda"; per s8 call of a forward at batch 1 and
              32, kernel, plain, bound and library ms (torch._int_mm on
              the im2col'd GEMM operands, the GEMM alone; conv 0's bound
              counts its pooled output), summed over the 23 convs for
              the kernels line; per int8 pool of the forward, kernel,
              plain and byte-bound ms, summed; (g) yolov4 @608 int8 at
              batch 32 (phase 12's weights): 110 s8 launches (72 mish
              epilogues; conv 0 on the stem body, unpooled), every s8
              call of a forward against the plain block on its own
              inputs (leaky and linear the same bytes, mish within 1
              code and 1 bf16 ulp), the top-50 overlap gate; its score
              deviation is printed beside the JAX package's own on the
              same inputs (V4_JAX_SCORE_DEV)
 20. video    video input and the cv2-free resamplers (data/video.py,
              native/resample.c): (a) a seeded VIDEO_FRAMES-frame 640x480
              MJPG AVI of moving rectangles written by the port's writer
              (data/synthetic.py write_video; the card has no OpenCV),
              its video_info, and the native reader's decode frames/s;
              (b) `detect --video --stride VIDEO_STRIDE --batch
              VIDEO_BATCH --save-video` on phase 4's seeded YOLOv2-COCO
              weights in bf16 and int8 (calibrated on the stream's first
              8 sampled frames): one line a sampled frame, each equal to
              detect_raw on the frames the reader decodes with a net
              loaded (and calibrated) as the command does; one NMS
              launch a batch, and for int8 INT8_CONVS s8 and INT8_POOLS
              int8-pool launches a batch, no plain block on the card;
              the annotated copy read back by the port's reader (frames,
              size, fps / stride), the bf16 one written in OpenDML parts
              of VIDEO_PART_SIZE bytes (three or more RIFFs, every frame
              read back); frames/s of the command and of its
              stream loop alone; (c) `train` of yolov4-tiny 416 with VOC
              heads from a seeded partial file, its cfg carrying
              yolov4-tiny.cfg's HSV keys, plain and with mosaic=1,
              --mixup and blur=1: every loss finite, and train_batches'
              host batches/s of each mode beside the plain one; (d)
              `train --imagefolder` of darknet19 at 224 with angle=7
              aspect=.75 min_crop=224 max_crop=448: the command reports
              the geometry crop, every loss finite
 21. parallel data parallelism, the grain loader and the host letterbox
              in C, on phase 4's seeded YOLOv2-COCO and phase 10's
              YOLOv2-VOC: (a) make_dp_detector over make_mesh() (this
              card) and over two replicas on it (DP_REPLICAS) at batch
              DP_BATCH, bf16 and fp32, default route and conv_impl="cuda":
              one NMS launch and ROUTE_CONVS conv launches (on that
              route) a shard, fp32 detections equal make_detector's on
              each shard's frames within rtol 1e-4 / atol 1e-5, and
              both precisions agree at box level with make_detector on
              the whole batch; img/s of both meshes beside
              make_detector's; (b) a DetectionServer
              on the two-replica mesh answers DP_HTTP concurrent requests
              as direct calls, /stats' buckets multiples of 2; (c) one
              fp32 YOLOv2-VOC step (TF32 off) at batch DP_TRAIN_BATCH and
              grad_accum DP_ACCUM on the two-replica mesh, and through an
              NCCL group of one (maybe_init_distributed), against
              make_train_step's: loss to a relative 1e-5, the largest
              update error (relative L2) within DP_NOISE_FACTOR of the
              single step's own on reordered rows, the rolling
              statistics within STAT_BOUND, the share of elements
              within rtol 1e-4 / atol 1e-6 printed; (d) `train --loader grain
              --loader-workers GRAIN_WORKERS`, stopped at step 2 and
              --resume'd: steps 3-4 log the uninterrupted run's losses
              and a loader restored from step_2.grain gives its batches;
              grain batches/s beside train_batches'; (e) ms a 480x640
              frame letterboxed to 416 on the host, letterbox_batch (C)
              against the torch letterbox, on 1 and 8 threads

Phase 10's training scenes are PNGs whose rows cycle through all five
filters (Paeth and Average included), and its held-out scenes are JPEGs.

Tolerances of phases 6-7, kernel vs plain on the same inputs:
  * fp32: 1e-5 of the output's scale (max |plain|). Both sides form
    true fp32 products (the plain versions turn TF32 off) and sum them
    in other orders.
  * bf16 output: 1 bf16 ulp of the output, plus the fp32 bound above.
    Both sides form the same fp32 sums up to that bound and round once;
    where an output lies near zero its own ulp is finer than the sums'
    noise, hence the added fp32 bound.

A kernel's time is the device time per call: CUDA events around a run
of back-to-back calls that the host queues while the stream is held busy
(torch.cuda._sleep), so that at batch 1 the host's launch rate does not
set it; the median of TIME_REPEATS such runs. bound_ms is the larger of the
bytes the function must move (each input read once, each output written
once) at 3.35 TB/s and its operations at the card's peak for their type
(989 TFLOP/s bf16 tensor, 67 TFLOP/s fp32), computed from this run's
inputs.

Phase 16's comparisons with direct calls are exact (the same code on
the same inputs); its resumed training state is held within phase 10's
bounds, as cuDNN's backward is not promised to be bit-reproducible (it
read 0.0 on an H100).

Then the kernels line, the nvidia-smi line and, last, the device line
{"ok": true, "device": {...}}; the line before the kernels line gives the
script's total seconds. Exits non-zero without printing a result
when CUDA is not available.
"""

import argparse
import collections
import concurrent.futures as cf
import contextlib
import dataclasses
import hashlib
import http.client
import io
import itertools
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import zlib

import numpy as np
import torch
import torch.nn.functional as F

import yolo_tpu_torch
from yolo_tpu_torch.configs import VOC_NAMES, get_variant
from yolo_tpu_torch.configs.darknet_cfg import cfg_to_string, config_from_cfg
from yolo_tpu_torch.configs.specs import (AvgPool, Connected, Conv, Local,
                                          MaxPool, ModelConfig, Route, Sam,
                                          ScaleChannels, Shortcut,
                                          SoftmaxHead, YoloHead,
                                          layer_strides, weighted_specs)
from yolo_tpu_torch.configs.tree import parse_tree
from yolo_tpu_torch.configs.variants import LAYER_BUILDERS
from yolo_tpu_torch.data.augment import AugmentConfig
from yolo_tpu_torch.data.coco import load_coco
from yolo_tpu_torch.data.pipeline import (DevicePrefetcher, _host_resize,
                                          _Pool, get_decoder,
                                          inference_batches, train_batches)
from yolo_tpu_torch.data.png import (SIGNATURE, encode_png, unfilter,
                                     unfilter_plain)
from yolo_tpu_torch.data.imagefolder import (classifier_train_batches,
                                             list_imagefolder)
from yolo_tpu_torch.data.synthetic import (coco_scene, encode_jpeg,
                                           gradient_frame, scene,
                                           write_coco_scenes, write_map,
                                           write_tree, write_voc_scenes)
from yolo_tpu_torch.data.targets import encode_batch_for
from yolo_tpu_torch.eval.coco_map import evaluate_coco
from yolo_tpu_torch.eval.runner import (build_ground_truth,
                                        collect_detections, quick_map)
from yolo_tpu_torch.eval.voc_map import _iou_xyxy_voc, evaluate
from yolo_tpu_torch.io import darknet_weights as dw
from yolo_tpu_torch.models import graph
from yolo_tpu_torch.models.classify import (classifier_preprocess,
                                            hierarchy_path, make_classifier)
from yolo_tpu_torch.models.graph import Darknet, fold_params
from yolo_tpu_torch.models.predict import (detect_raw, make_detector,
                                           make_detector_preprocessed)
from yolo_tpu_torch.native import build as native_build
from yolo_tpu_torch.native.preproc import (decode_image, decode_image_bytes,
                                           decode_jpeg, letterbox_batch)
from yolo_tpu_torch.ops import conv, entry, precision
from yolo_tpu_torch.ops.cuda import build, conv_kernel, entry_kernel, nms_kernel
from yolo_tpu_torch.ops import nms as nms_mod
from yolo_tpu_torch.ops.letterbox import letterbox
from yolo_tpu_torch.ops.nms import _geom, _suppress_torch, _suppress_torch_rows
from yolo_tpu_torch.parallel.sharding import (make_dp_detector,
                                              make_dp_train_step, make_mesh,
                                              maybe_init_distributed,
                                              replicate, shard_batch)
from yolo_tpu_torch.serve import DetectionServer, detections_to_json
from yolo_tpu_torch.data.gif import PALETTE, encode_gif
from yolo_tpu_torch.data.jp2 import encode_jp2
from yolo_tpu_torch.data.tiff import encode_tiff
from yolo_tpu_torch.data.webp import encode_webp
from yolo_tpu_torch.utils.viz import save_image
from yolo_tpu_torch.train.loop import (TrainConfig, ema_params_of,
                                       train_config_from_cfg,
                                       init_state, make_train_step,
                                       state_to_tree)
from yolo_tpu_torch.train import loss as loss_mod
from yolo_tpu_torch.train.loss import region_loss_config, yolo_loss_config

STARTED = time.perf_counter()
REPO = os.path.dirname(os.path.abspath(__file__))
SEED = 0
VARIANT = "coco"          # YOLOv2-COCO, 416x416, 80 classes, 5 anchors
SRC_HW = (480, 640)
CONF = 0.3                # suppress test threshold (phase 3)
IOU = 0.45
# (G, K) suppression grids of the served path: the fused head at conf
# >= 0.3 hands the kernel G = batch rows of K = 128 (K = 256 below 0.3,
# and for nms_batch's global top-K); exact per-class NMS is G = B * 80
KERNEL_SHAPES = [(1, 128), (1, 256), (32, 128), (32, 256), (32 * 80, 128)]
TIMED_SHAPE = (32, 128)   # the kernels line's ms / plain_ms
E2E_BATCHES = (1, 32, 128)
# box-level agreement of two detectors: a detection clearly above the
# confidence threshold (by MARGIN) must have a same-class partner with
# IoU >= MATCH_IOU in the other run, for at least MIN_MATCH of them
MARGIN = 0.05
MATCH_IOU = 0.5
MIN_MATCH = 0.9
CONV_BATCHES = (8, 1)     # phase 6 checks; batch 1 takes split-K plans
TIMED_BATCH = 32          # phase 9: the kernels line's batch
# phase 5 the detector's own suppress inputs, phase 9 per-shape conv
# times and fp32 routes
TIMED_BATCHES = (1, TIMED_BATCH)
# a kernel time is the median of this many timed runs, so that one
# transient on the card does not set it
TIME_REPEATS = 3
ROUTE_CONVS = 16         # YOLOv2-COCO convs with CIN, CO % 128 == 0
# the card's peaks (NVIDIA's H100 SXM data sheet, dense, 700 W)
PEAK_BYTES_S = 3.35e12
PEAK_FLOP_S = {torch.bfloat16: 989e12, torch.float32: 67e12,
               torch.int8: 1979e12}
NMS_PAIR_FLOP = 13        # one IoU and its test (nms_suppress.cu)

# phases 10-11: fine-tuning YOLOv2-VOC 416 and its VOC mAP
TRAIN_VARIANT = "voc"     # yolov2-voc.cfg: 20 classes, 5 anchors
# synthetic VOC scenes: source sizes of VOC images, train and held out
SCENE_HW = ((375, 500), (500, 333), (480, 640))
TRAIN_SCENES, HELD_OUT_SCENES = 64, 32
BACKBONE_LAYERS = 23      # darknet19_448.conv.23: layers 0-22, 18 convs
# yolov2-voc.cfg [net]: batch 64, subdivisions 8, the steps policy
TRAIN_BATCH, SUBDIVISIONS = 64, 8
NET_SCHEDULE = dict(learning_rate=0.001, momentum=0.9, weight_decay=0.0005,
                    burn_in_steps=1000, lr_decay_steps=(40000, 60000),
                    lr_decay_scales=(0.1, 0.1))
NET_AUGMENT = AugmentConfig(jitter=0.3, hue=0.1, saturation=1.5,
                            exposure=1.5, flip=True)
# per precision, through the prefetcher (the loop is host-bound: 20
# steps of yolov4 at batch 64 took ~120 s of the script)
TRAIN_STEPS = 4
ALONE_STEPS = 3           # then timed on the last batch, no pipeline
PIPELINE_WORKERS = 8      # the card machine's cores
CHECK_BATCH = 2           # (a): the card's step against the CPU's
# (a), per tensor ||update - CPU update|| / ||CPU update||, the largest
# over the trained tensors (kernel, gamma, beta, bias) and over the
# rolling statistics. The CPU's step takes the card's discrete choices:
# on its own, a leaky pre-activation within rounding of zero or a
# max-pool near-tie (the scenes' flat rectangles) goes the other way,
# and one such flip moves the update of every conv below it by ~1e-3.
# Its convs run in float64: the CPU's fp32 weight gradient of conv 0
# (3 channels summed over 2x416x416 positions) lies 2.2e-3 from float64,
# cuDNN's 3.3e-5 (tools/port_perf.py stepcheck on an H100 machine).
# On an H100 the largest errors read 8.5e-5 (update) and 8.7e-6
# (statistics), and with TF32 on 1.6e-2 and 2.6e-3
STEP_BOUND, STAT_BOUND = 5e-4, 1e-4
# (d) and phase 11: quick_map folds the rolling BN statistics, which at
# momentum 0.99 trail the batch statistics by ~100 steps; after 60 steps
# the overfit model scored 0.0 mAP on its own scenes (on an H100), so
# the overfit runs 300
OVERFIT_SCENES, OVERFIT_STEPS = 8, 300
# (d): the last loss, and its coord and class parts (the noobj part
# dominates the first loss), below OVERFIT_FRACTION of their first
# values (on an H100: 0.006-0.021 after 60 steps, below 3e-4 after 300)
OVERFIT_FRACTION = 0.1
EVAL_CONF = 0.005         # the PR-curve threshold of collect_detections
EVAL_BATCH = 16           # quick_map's batch
# phase 11, card against CPU: the overfit state keeps few detections on
# held-out scenes (9-27 >= 0.055 on an H100), so the comparison also
# runs from the overfit's snapshot after EARLY_STEPS (1394-1803 there),
# and needs MIN_EVAL_BOXES of them; mAP to a relative MAP_REL
EARLY_STEPS, MIN_EVAL_BOXES, MAP_REL = 60, 500, 1e-3

# phases 12-13: the yolov3/v4 family at published widths and sizes
YOLO_VARIANTS = ("yolov3", "yolov3-spp", "yolov3-tiny", "yolov4",
                 "yolov4-tiny")
# kernel convs a forward of each (leaky or linear, CIN and CO multiples
# of 128; yolov4's 72 mish convs stay on cuDNN)
YOLO_KERNEL_CONVS = {"yolov3": 60, "yolov3-spp": 61, "yolov3-tiny": 7,
                     "yolov4": 33, "yolov4-tiny": 11}
YOLO_IMAGES = 4           # raw 480x640 frames of a route check
YOLO_SERVED = "yolov4"    # the variant DetectionServer serves
YOLO_E2E = {"yolov3": E2E_BATCHES, "yolov4": TIMED_BATCHES}
YOLO_SHAPE_CALLS = 10     # calls a timed run of one conv shape
# phase 13: the [net] keys of yolov3.cfg and yolov4.cfg; the VOC scenes
# train each variant's own layer builder with a 20-class head
YOLO_NETS = {
    "yolov3": (16, dict(learning_rate=0.001, momentum=0.9,
                        weight_decay=0.0005, burn_in_steps=1000,
                        lr_decay_steps=(400000, 450000),
                        lr_decay_scales=(0.1, 0.1))),
    "yolov4": (8, dict(learning_rate=0.0013, momentum=0.949,
                       weight_decay=0.0005, burn_in_steps=1000,
                       lr_decay_steps=(400000, 450000),
                       lr_decay_scales=(0.1, 0.1))),
}                         # (subdivisions, schedule); batch 64 both
# the darknet partial files their fine-tunes start from: (layers, name,
# convs)
YOLO_PARTIALS = {"yolov3": (74, "darknet53.conv.74", 52),
                 "yolov4": (137, "yolov4.conv.137", 92),
                 "yolov4-tiny": (29, "yolov4-tiny.conv.29", 17)}
YOLO_OVERFIT_SCENES = 24  # "a few dozen"
# the loss and its class part fall below OVERFIT_FRACTION of their first
# values as in phase 10 (on an H100: 6.5e-4 and 2.3e-4 after 600
# steps); the ciou box term (x0.07) does not: it levels off at 0.16-0.23
# of its first from step 300 on (1 - CIoU of boxes already at ~0.9
# IoU; Adam and cuDNN's training make it vary between runs), and is
# held below YOLO_OVERFIT_COORD of it
YOLO_OVERFIT_STEPS, YOLO_OVERFIT_COORD = 600, 0.3
# (a)'s update bound for yolov4, 2x phase 10's: fp32 arithmetic alone
# puts its step ~6e-4 from a float64 step (the card's, with cuDNN or
# without; the CPU's, convs in float64, 3.2e-4), in the early convs'
# updates, which the noobj term's uniform push at 22743 anchors an
# image reaches through 100 BN layers that cancel it (tools/port_perf.py
# step64 on an H100); TF32 on reads ~0.8. yolov3 keeps STEP_BOUND.
YOLO_STEP_BOUND = {"yolov3": STEP_BOUND, "yolov4": 1e-3}
YOLO_AUGMENT = AugmentConfig(jitter=0.3, hue=0.1, saturation=1.5,
                             exposure=1.5, flip=True)
YOLO_TIMED = "yolov4"     # TRAIN_STEPS steps at the cfg's batch, 608
YOLO_OVERFIT = "yolov4-tiny"

# phase 14: real images through the port's host decoder, and yolov3's
# COCO mAP@[.5:.95] on COCO-format JPEG scenes
FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests",
                        "data", "torch_jpeg")
# the fixtures of the decoder's buffered path, by name prefix, and the
# 480x640 progressive frame of phase 14 (c) (tools/jpeg_fixtures.py)
NEW_KIND_FIXTURES = ("prog_", "multiscan_", "arith_", "cmyk_", "ycck_",
                     "adam7_", "srgb_")
PROGRESSIVE_FRAME = "prog_420_q85_480x640.jpg"
# the other formats' fixtures (and the damaged and overflowing JPEGs),
# by name prefix, and their 480x640 frames of phase 14 (c)
FORMAT_FIXTURES = ("bmp_", "pgm_", "ppm_", "tiff_", "webp_", "damaged_",
                   "overflow_", "gif_", "sunras_", "pfm_", "hdr_")
TIFF_FRAME = "frame_lzw_pred_480x640.tif"
WEBP_FRAME = "frame_webp_q80_480x640.webp"
WEBP_LOSSLESS_FRAME = "frame_webp_lossless_480x640.webp"
GIF_FRAME = "frame_gif_480x640.gif"
HDR_FRAME = "frame_hdr_480x640.hdr"
# JPEG 2000 (data/jp2.py, native/j2k*.c): the six fixtures of phase 14
# (b)'s predict --image and POST /detect (9/7, 5/3, a raw J2K codestream,
# odd tiles, RGBA, 16-bit gray) and the 480x640 frames of phase 14 (c);
# every JP2 fixture is held to its hash by phase_fixtures
JP2_DETECT_FIXTURES = ("jp2_97_mct1_40x56.jp2", "jp2_53_mct1_40x56.jp2",
                       "j2k_raw_codestream_45x67.j2k",
                       "jp2_tiles_odd_97_45x67.jp2", "jp2_mode_rgba_40x56.jp2",
                       "jp2_mode_i16_40x56.jp2")
JP2_FRAME = "frame_jp2_97_480x640.jp2"
JP2_LOSSLESS_FRAME = "frame_jp2_53_480x640.jp2"
# save_image's TIFF, JPEG 2000, WebP and GIF writers through predict
# --output from a 480x640 fixture frame, its PAM, Sun raster, PFM, HDR,
# .apng (PNG) and .pic (HDR) writers from the last annotated frame. The
# JP2 file is lossy at OpenJPEG's rate 4: the TIFF frame fits whole
# (137,208 bytes) with the few boxes of JP2_CONF, not with FIXTURE_CONF's
# 100 labels. The GIF file is always lossy (a fixed 3-3-2 palette)
PREDICT_FORMATS = (".tif", ".jp2", ".webp", ".gif")
JP2_CONF = 0.5
SAVED_FORMATS = (".pam", ".ras", ".pfm", ".hdr", ".apng", ".pic")
# the JPEG 2000 writer's cut path and the GIF writer, each pinned by the
# hash of cv2.imwrite's file of a seeded noisy gradient
# (tests/test_torch_jp2_write.py, tests/test_torch_gif_write.py)
WRITTEN_HASHES = "written_hashes.json"
FIXTURE_CONF = 0.005      # a score threshold at which every fixture has boxes
IMAGE_THREADS = (1, 8)
IMAGE_DECODES = 32        # decodes a timed thread-pool run
COCO_VARIANT = "yolov3"   # 416, COCO-80
COCO_SCENES = 96          # 3 batches of COCO_BATCH
# source sizes, cycled: mostly 480x640, as COCO's most common size
COCO_SIZES = ((480, 640),) * 5 + ((640, 480), (427, 640), (375, 500))
COCO_BATCH = 32
COCO_CPU_SCENES = 8       # card against CPU
COCO_REL = 1e-3           # each of the 12 cells, card against CPU
# the seeded detector finds none of the scenes' objects, so card and CPU
# are also scored against ground truth made from the CPU's detections
PSEUDO_GT, PSEUDO_JITTER = 20, 0.15
HTTP_BODIES = 8

# phase 21: data parallelism (parallel/sharding.py), the grain loader
# and the host letterbox in C
DP_BATCH = 32             # (a) raw frames a call, split over the mesh
DP_REPLICAS = ("cuda:0", "cuda:0")   # two replicas on the one card
DP_TIMED = 10             # (a) timed calls of each detector
DP_HTTP = 8               # (b) concurrent requests
DP_TRAIN_BATCH, DP_ACCUM = 16, 2     # (c) one step, rows 8 a shard
# (c): a DP step's largest update error against the single step, at
# most this many times the single step's own on reordered rows (on the
# CPU, tiny-voc at 160: 1.3e-2 against 1.0e-2, a gamma and a beta)
DP_NOISE_FACTOR = 4.0
GRAIN_SCENES, GRAIN_BATCH = 32, 16   # (d) two steps an epoch, 2 epochs
GRAIN_WORKERS = 2         # (d) --loader-workers
LETTERBOX_FRAMES = 32     # (e) frames of the 8-thread timing

# phase 16: the command line (python -m yolo_tpu_torch.cli) on the card
CLI_PREDICT = {"coco": "yolov2-coco-seed.weights",
               "yolov3": "yolov3-seed.weights"}
CLI_OUTPUT_IMAGES = 64    # detect --output-dir / --save-labels subset
# train: YOLOv2-VOC 416 from the seeded darknet19 partial file, at
# yolov2-voc.cfg's batch 64 and subdivisions 8, one step an epoch;
# --resume from step_2 redoes the third step
CLI_TRAIN_SCENES, CLI_TRAIN_STEPS, CLI_RESUME_STEP = 64, 3, 2
CLI_SERVE_BODIES = 4
SERVE_START_S = 300       # the serve subprocess's time to listen

# phase 15: darknet .cfg files through yolo_tpu_torch.load(cfg=...)
CFG_ROUND_TRIP = ("coco", "yolov3", "yolov4", "yolov4-tiny")   # (a)
CFG_SCALED_HW = (384, 640)    # (b): [net] height=384 width=640
CFG_IMAGES = 4                # raw 480x640 frames of a route check
CFG_TRAIN_STEPS, CFG_TRAIN_BATCH = 3, 8   # (e): bf16 steps
# (d), card against CPU in fp32: each head's logits within this share
# of its scale (the executor tolerance of tests/test_torch_custom.py)
CFG_LOGIT_REL = 1e-4
# (e)'s update bound: (c) keeps phase 13 (a)'s yolov3 bound; (b) twice
# yolov4's: fp32 alone puts its step 7.6e-4 (the card) and 6.4e-4 (the
# CPU, convs in float64) from a float64 step, in conv 0's gamma and beta
# (tools/port_perf.py step64 --heads csp-swish on an H100), so the two
# differ by up to ~1e-3 (9.6e-4 read); TF32 on reads ~1.2
CFG_STEP_BOUND = {"yolov4": 2e-3, "yolov3": STEP_BOUND}
# the [net] training keys of yolov4.cfg and yolov3.cfg, written into
# (b)'s and (c)'s cfg files and read back by train_config_from_cfg
CFG_NET_KEYS = {
    "yolov4": "batch=64\nsubdivisions=8\nmomentum=0.949\ndecay=0.0005\n"
              "learning_rate=0.0013\nburn_in=1000\nmax_batches=500500\n"
              "policy=steps\nsteps=400000,450000\nscales=.1,.1\n",
    "yolov3": "batch=64\nsubdivisions=16\nmomentum=0.9\ndecay=0.0005\n"
              "learning_rate=0.001\nburn_in=1000\nmax_batches=500200\n"
              "policy=steps\nsteps=400000,450000\nscales=.1,.1\n"}

# phase 17: YOLO9000 (darknet's cfg/yolo9000.cfg at 544) on a generated
# 9418-node tree (data/synthetic.py, the 9k tree's shape) with an 80-leaf
# map, and the darknet classifiers
TREE_NODES, TREE_MAP_LEAVES = 9418, 80
YOLO9000_SIZE = 544
YOLO9000_ANCHORS = "0.77871, 1.14074, 3.00525, 4.31277, 9.22725, 9.61974"
# seeded weights (yolo9000_params): the head's objectness and class
# logits standardized on a probe frame, objectness gain and shift, class
# gain, and anchor a's class logits on the root path of the map's leaf a
# raised by TREE_PATH_BOOST
TREE_OBJ_GAIN, TREE_OBJ_SHIFT = 2.0, -4.0
TREE_CLASS_GAIN, TREE_PATH_BOOST = 2.0, 5.0
TREE_BATCHES = (1, 32)
TREE_CONF = 0.3           # traversal mode: a box scores its objectness
TREE_MAP_CONF = 0.05      # map mode: conf * a mapped leaf's path product
TREE_TIMED_REPS = 5
TREE_EVAL_BATCH = 8       # (b): the (8 * 9418, 5, 128) eval grid
TREE_PLAIN_CALLS = 2      # its plain version's calls a timed run
TREE_CHUNK_CLASSES = 2048   # (b): classes a chunk of the kernel path
TREE_EVAL_SCENES = 4      # (b): card against CPU, phase 14's JPEGs
TREE_CHECK_BATCH = 2      # (c): the card's step against the CPU's
CLASSIFIERS = {"darknet19-448": 448, "darknet53": 256}   # (d)
CLS_BATCHES = (1, 64)
CLS_IMAGES = 4            # card against CPU
# fp32 probabilities card against CPU, of the largest probability
CLS_PROB_ERR = 1e-5
# (d) training: darknet-19 with a CLS_TRAIN_CLASSES-way head on JPEG
# class folders of CLS_TRAIN_PER scenes each
CLS_TRAIN_CLASSES, CLS_TRAIN_PER = 6, 4
CLS_TRAIN_SIZE, CLS_TRAIN_BATCH, CLS_TRAIN_STEPS = 128, 8, 3

# phase 18: yolov1, darknet's cfg/yolov1.cfg at 448 (full width: 24
# convs, [local] 3x3 256, [dropout] .5, [connected] 1715, [detection]
# 7x7x3, 20 classes), its [net] as the cfg's test section sets it, with
# seeded weights (io/darknet_weights.py::synthetic_detector_params)
YOLOV1_CFG = "\n".join(
    ["[net]", "batch=1", "subdivisions=1", "width=448", "height=448",
     "channels=3", "momentum=0.9", "decay=0.0005", "saturation=1.5",
     "exposure=1.5", "hue=.1", "learning_rate=0.0005", "policy=steps",
     "steps=200,400,600,20000,30000", "scales=2.5,2,2,.1,.1",
     "max_batches=40000", ""]
    + [f"[convolutional]\nbatch_normalize=1\nfilters={f}\nsize={k}\n"
       f"stride={s}\npad=1\nactivation=leaky\n" if f else
       "[maxpool]\nsize=2\nstride=2\n"
       for f, k, s in [(64, 7, 2), (0, 0, 0), (192, 3, 1), (0, 0, 0),
                       (128, 1, 1), (256, 3, 1), (256, 1, 1), (512, 3, 1),
                       (0, 0, 0)] + [(256, 1, 1), (512, 3, 1)] * 4
       + [(512, 1, 1), (1024, 3, 1), (0, 0, 0)]
       + [(512, 1, 1), (1024, 3, 1)] * 2
       + [(1024, 3, 1), (1024, 3, 2), (1024, 3, 1), (1024, 3, 1)]]
    + ["[local]\nsize=3\nstride=1\npad=1\nfilters=256\n"
       "activation=leaky\n",
       "[dropout]\nprobability=.5\n",
       "[connected]\noutput=1715\nactivation=linear\n",
       "[detection]\nclasses=20\ncoords=4\nrescore=1\nside=7\nnum=3\n"
       "softmax=0\nsqrt=1\njitter=.2\nobject_scale=1\n"
       "noobject_scale=.5\nclass_scale=1\ncoord_scale=5\n"])
V1_PARAMS = 197_000_000   # about: [local] alone holds 115.6 M
V1_CONF = 0.2             # darknet's detection threshold for yolov1
V1_BATCHES = (1, 32)
V1_TIMED_REPS = 5
# the convs the conv kernel takes: 20, in 11 shapes at 56/28/14/7 px
V1_KERNEL_CONVS, V1_KERNEL_SHAPES = 20, 11
V1_STEP_BATCH = 2         # (d): the card's step against the CPU's
# (d)'s update bound, as phase 15's yolov4 bound: fp32 arithmetic alone
# puts each side's step ~1e-3 from a float64 step, in the deep convs'
# gammas (the card's 1.10e-3 with cuDNN or without, the CPU's, convs and
# dense products in float64, 7.9e-4: tools/port_perf.py step64 --variant
# yolov1 on an H100), so the two differ by up to ~2e-3; TF32 on reads
# ~4e-2
V1_STEP_BOUND = 2e-3


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def bound_ms(flop: float, nbytes: float, dtype) -> tuple:
    """(least ms, "operations" or "bytes"): the larger of the operations
    at the card's peak for dtype and the bytes at its memory rate."""
    t_ops = flop / PEAK_FLOP_S[dtype] * 1e3
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def cuobjdump(lib: str, what: str) -> str:
    """cuobjdump's `what` dump of the built library."""
    tool = os.path.join(os.path.dirname(build.nvcc_path()), "cuobjdump")
    return subprocess.run([tool, what, lib], capture_output=True, text=True,
                          check=True, timeout=300).stdout


def hgmma_counts(lib: str) -> dict:
    """{kernel: wgmma instructions (SASS HGMMA, or IGMMA for int8)} of
    every kernel in the built library, from cuobjdump --dump-sass
    (template arguments kept, e.g. conv_bf16_kernel<128,256,4>)."""
    counts, name = {}, None
    for line in cuobjdump(lib, "--dump-sass").splitlines():
        if "Function :" in line:
            name = _kernel_name(line.split("Function :")[1].strip())
            counts.setdefault(name, 0)
        elif name is not None and ("HGMMA" in line or "IGMMA" in line):
            counts[name] += 1
    return counts


def resource_usage(lib: str) -> dict:
    """{kernel: {"registers", "stack", "local"}} of every kernel in the
    built library, as ptxas allotted them (cuobjdump
    --dump-resource-usage; kernel names as hgmma_counts gives them). A
    register spill takes stack or local memory: no spill leaves both 0."""
    usage, name = {}, None
    for line in cuobjdump(lib, "--dump-resource-usage").splitlines():
        func = re.match(r"\s*Function\s+(\S+?):?\s*$", line)
        regs = re.search(r"\bREG:(\d+)", line)
        if func:
            name = _kernel_name(func.group(1))
        elif name is not None and regs:
            usage[name] = {
                "registers": int(regs.group(1)),
                "stack": int(re.search(r"\bSTACK:(\d+)", line).group(1)),
                "local": int(re.search(r"\bLOCAL:(\d+)", line).group(1))}
            name = None
    return usage


def _kernel_name(mangled: str) -> str:
    """conv_bf16_kernel<128,256,4> from its Itanium-mangled name: the
    identifier ending in _kernel whose length prefix matches it, then its
    integer template arguments."""
    end = mangled.find("_kernel") + len("_kernel")
    if end < len("_kernel"):
        return mangled
    for start in range(end - 1, 0, -1):
        if mangled[start].isalpha() and \
                mangled[:start].endswith(str(end - start)):
            break
    else:
        return mangled
    # the template arguments in order: integers (Li<n>E) and the types
    # int8 (a), float (f) and bf16 (13__nv_bfloat16)
    rest = mangled[end:]
    if not rest.startswith("I"):
        return mangled[start:end]
    args, i = [], 1
    for tok in re.finditer(r"Li(\d+)E|a|f|13__nv_bfloat16|E", rest[1:]):
        if tok.start() != i - 1 or tok.group(0) == "E":
            break
        args.append(tok.group(1) or {"a": "int8", "f": "float"}.get(
            tok.group(0), "bf16"))
        i = tok.end() + 1
    return (f"{mangled[start:end]}<{','.join(args)}>" if args
            else mangled[start:end])


def crowded_rows(rng, g, k, per_class):
    """(G, K) candidate rows where many boxes overlap
    (tests/test_nms_impls.py::_scene geometry), scores sorted desc. Mixed
    classes per row for the fused head; one class per row for the exact
    per-class grid."""
    boxes = np.stack([rng.uniform(0.1, 0.9, (g, k)),
                      rng.uniform(0.1, 0.9, (g, k)),
                      rng.uniform(0.05, 0.3, (g, k)),
                      rng.uniform(0.05, 0.3, (g, k))], -1).astype(np.float32)
    scores = -np.sort(-rng.uniform(0, 1, (g, k)), axis=1).astype(np.float32)
    if per_class:
        classes = np.repeat(rng.integers(0, 80, (g, 1)), k, axis=1)
    else:
        classes = rng.integers(0, 5, (g, k))
    dev = torch.device("cuda")
    return (_geom(torch.from_numpy(boxes).to(dev)).contiguous(),
            torch.from_numpy(scores).to(dev),
            torch.from_numpy(classes.astype(np.float32)).to(dev))


def cuda_ms_per_call(fn, calls: int, warmup: int = 2) -> float:
    """Device time per call: CUDA events around a run of back-to-back
    calls, divided by their number; the median of TIME_REPEATS such
    runs. Before each run
    the stream is held busy for 1.5x the host time of the calls
    (torch.cuda._sleep, ~2 GHz cycles, at most 0.1 s), so that the host
    has queued them before the first one runs and the events time the
    device, not the host."""
    for _ in range(warmup - 1):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    host_s = time.perf_counter() - t0
    runs = []
    for _ in range(TIME_REPEATS):
        torch.cuda.synchronize()
        torch.cuda._sleep(int(min(1.5 * host_s * calls, 0.1) * 2e9))
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        torch.cuda.synchronize()
        runs.append(start.elapsed_time(end) / calls)
    return statistics.median(runs)


def cuda_median_ms(fn, reps: int, warmup: int = 2) -> float:
    """Median of per-call CUDA-event times, each call synchronized: the
    latency a lone caller sees."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def seeded_coco_weights(cfg, path: str) -> None:
    """Seeded random YOLOv2-COCO weights as a darknet .weights file: He
    scaled, box channels x0.1, objectness bias -2, so that boxes keep
    their anchors' size and most cells hold no object, as in a trained
    detector (io.darknet_weights.synthetic_detector_params; PERF.md
    reports the sweep of these two settings)."""
    dw.save(path, cfg.layers, dw.synthetic_detector_params(cfg, SEED))


def post_body(port: int, body: bytes, ctype: str) -> list:
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
    try:
        conn.request("POST", "/detect", body=body,
                     headers={"Content-Type": ctype})
        resp = conn.getresponse()
        answer = json.loads(resp.read())
    finally:
        conn.close()
    check(resp.status == 200, f"/detect returned {resp.status}: {answer}")
    return answer["detections"]


def post_npy(port: int, image) -> list:
    buf = io.BytesIO()
    np.save(buf, image)
    return post_body(port, buf.getvalue(), "application/x-npy")


def _iou(a, b) -> float:
    iw = max(0.0, min(a[2], b[2]) - max(a[0], b[0]))
    ih = max(0.0, min(a[3], b[3]) - max(a[1], b[1]))
    inter = iw * ih
    union = ((a[2] - a[0]) * (a[3] - a[1]) + (b[2] - b[0]) * (b[3] - b[1])
             - inter)
    return inter / union if union > 0 else 0.0


def _iou_voc(a, b) -> float:
    """The VOC devkit's +1 pixel IoU: a box clipped to a line on the
    frame's edge (a [yolo] box in the letterbox's band) matches
    itself."""
    iw = max(0.0, min(a[2], b[2]) - max(a[0], b[0]) + 1)
    ih = max(0.0, min(a[3], b[3]) - max(a[1], b[1]) + 1)
    union = ((a[2] - a[0] + 1) * (a[3] - a[1] + 1)
             + (b[2] - b[0] + 1) * (b[3] - b[1] + 1) - iw * ih)
    return iw * ih / union


def match_rate(ref: list, other: list, conf: float, iou=_iou) -> tuple:
    """(matched, total) over ref's detections scoring >= conf + MARGIN:
    matched when other holds a same-class box with IoU >= MATCH_IOU."""
    sure = [d for d in ref if d["score"] >= conf + MARGIN]
    hit = sum(any(o["class"] == d["class"]
                  and iou(o["box_xyxy"], d["box_xyxy"]) >= MATCH_IOU
                  for o in other) for d in sure)
    return hit, len(sure)


def check_agree(a: list, b: list, conf: float, what: str,
                iou=_iou) -> dict:
    """Box-level agreement both ways over per-image result lists."""
    stats = {}
    for name, (x, y) in (("a_in_b", (a, b)), ("b_in_a", (b, a))):
        hit = tot = 0
        for xi, yi in zip(x, y):
            h, t = match_rate(xi, yi, conf, iou)
            hit, tot = hit + h, tot + t
        check(tot > 0, f"{what}: no detection above conf + margin")
        stats[name] = hit / tot
        check(hit / tot >= MIN_MATCH, f"{what}: {name} match rate "
              f"{hit}/{tot} < {MIN_MATCH}")
    return stats


def phase_kernel(rng) -> float:
    worst = 0.0
    for g, k in KERNEL_SHAPES:
        geom, scores, classes = crowded_rows(rng, g, k, per_class=g > 32)
        got = nms_kernel.suppress(geom, scores, classes,
                                  conf_threshold=CONF, iou_threshold=IOU)
        torch.cuda.synchronize()
        want = _suppress_torch(geom, scores, classes, CONF, IOU)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        worst = max(worst, err)
        n_above = int((scores >= CONF).sum())
        n_kept = int(want.sum())
        emit({"phase": "kernel", "shape": [g, 5, k], "identical":
              bool(torch.equal(got, want)), "max_abs_err": err,
              "kept": n_kept, "above_conf": n_above})
        check(torch.equal(got, want), f"suppress keep mask differs from "
              f"the plain version at (G, K) = ({g}, {k})")
        check(0 < n_kept < n_above, f"({g}, {k}) scene suppresses nothing")
    return worst


def phase_serve(weights_path: str) -> tuple:
    model = yolo_tpu_torch.load(weights_path, VARIANT, device="cuda")
    model32 = yolo_tpu_torch.load(weights_path, VARIANT, device="cuda",
                                  precision="fp32")
    cfg = model.cfg
    check(cfg.input_hw == (416, 416) and cfg.num_classes == 80
          and cfg.num_anchors == 5, f"unexpected config {cfg.name}")
    names = cfg.detection_names()
    rng = np.random.default_rng(SEED + 1)
    images = rng.integers(0, 256, (6, *SRC_HW, 3), dtype=np.uint8)

    server = DetectionServer(cfg, model.params, port=0, max_batch=32)
    server.start()
    try:
        nms_kernel.launches = 0
        sequential = [post_npy(server.port, images[i]) for i in range(3)]
        burst = [None] * len(images)

        def one(i):
            burst[i] = post_npy(server.port, images[i])

        threads = [threading.Thread(target=one, args=(i,))
                   for i in range(len(images))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        launches = nms_kernel.launches
        stats = dict(server.stats)
    finally:
        server.stop()
    check(all(not t.is_alive() for t in threads), "a burst request hung")
    check(all(b is not None for b in burst), "a burst request failed")
    check(launches > 0, "the served path never launched the NMS kernel")
    check(stats["errors"] == 0, f"server errors: {stats}")

    # direct calls of the same detector on the same images
    direct = [detections_to_json(model(images[i:i + 1]), names)[0]
              for i in range(len(images))]
    for i, resp in enumerate(sequential):
        check(resp == direct[i], f"response {i} differs from the direct "
              f"detector call")
    conf = cfg.conf_threshold
    burst_agree = check_agree(direct, burst, conf, "burst vs direct")

    out = model(images)
    for key, shape in (("boxes", (6, 100, 4)), ("scores", (6, 100)),
                       ("classes", (6, 100)), ("valid", (6, 100))):
        check(tuple(out[key].shape) == shape, f"{key} shape "
              f"{tuple(out[key].shape)}")
    check(bool(torch.isfinite(out["boxes"]).all())
          and bool(torch.isfinite(out["scores"]).all()),
          "non-finite detections")
    # fp32 through the plain path: full decode + exact per-class NMS in
    # plain PyTorch, fp32 convs without TF32
    plain = make_detector(cfg, head="reference", nms_impl="torch")
    ref = detections_to_json(plain(model32.params,
                                   torch.from_numpy(images).cuda()), names)
    precision_agree = check_agree(ref, direct, conf, "bf16 vs fp32 plain")
    emit({"phase": "serve", "model": cfg.name,
          "input_hw": list(cfg.input_hw), "requests": stats["requests"],
          "batches": stats["batches"],
          "max_batch_seen": stats["max_batch_seen"],
          "kernel_launches": launches,
          "responses_equal_direct": True,
          "detections_per_image": [len(d) for d in direct],
          "burst_vs_direct": burst_agree,
          "bf16_vs_fp32_plain": precision_agree,
          "agreement_rule": {"margin": MARGIN, "iou": MATCH_IOU,
                             "min_match": MIN_MATCH}})
    return launches, model, model32, images, ref


def captured_suppress_inputs(model, images) -> tuple:
    """(geom, scores, classes, conf, iou) that one forward of the
    detector hands the NMS kernel, copied as the kernel got them."""
    got = []
    kernel = nms_kernel.suppress

    def capture(geom, scores, classes, *, conf_threshold, iou_threshold):
        got.append((geom.clone(), scores.clone(), classes.clone(),
                    conf_threshold, iou_threshold))
        return kernel(geom, scores, classes, conf_threshold=conf_threshold,
                      iou_threshold=iou_threshold)

    nms_kernel.suppress = capture
    try:
        model(images)
    finally:
        nms_kernel.suppress = kernel
    check(len(got) == 1, f"one forward made {len(got)} suppress calls")
    return got[0]


def time_suppress(what, geom, scores, classes, conf, iou, card,
                  plain=_suppress_torch, plain_calls: int = 5, **extra):
    """Kernel and plain time of one suppress call, beside its bound;
    the keep masks must be identical. plain: the plain version
    (_suppress_torch_rows for a grid whose pairwise tensor is chunked)."""
    g, _, k = geom.shape
    got = nms_kernel.suppress(geom, scores, classes, conf_threshold=conf,
                              iou_threshold=iou)
    check(torch.equal(got, plain(geom, scores, classes, conf, iou)),
          f"suppress keep mask differs from the plain version on {what}")
    ms = cuda_ms_per_call(lambda: nms_kernel.suppress(
        geom, scores, classes, conf_threshold=conf, iou_threshold=iou),
        calls=200)
    plain_ms = cuda_ms_per_call(lambda: plain(
        geom, scores, classes, conf, iou), calls=plain_calls)
    # what this run's data needs: every score read and every keep
    # written, the geometry and class of the candidates above conf
    # only, and the IoUs of their pairs
    above = (scores >= conf).sum(dim=1).double()
    flop = NMS_PAIR_FLOP * float((above * (above - 1) / 2).sum())
    moved = (nbytes(scores) + 4 * g * k
             + float(above.sum()) * (geom.shape[1] + 1) * 4)
    bound, bound_by = bound_ms(flop, moved, torch.float32)
    emit({"phase": "times", "what": what, "shape": [g, 5, k], **extra,
          "above_conf": int((scores >= conf).sum()),
          "kept": int(got.sum()), "kernel_ms": ms, "plain_ms": plain_ms,
          "library_ms": None, "bound_ms": bound, "bound_by": bound_by,
          "card": card})
    return ms, plain_ms, bound, bound_by


def phase_times(rng, model, card: str) -> dict:
    timed = {}
    for g, k in KERNEL_SHAPES:
        geom, scores, classes = crowded_rows(rng, g, k, per_class=g > 32)
        timed[(g, k)] = time_suppress("suppress", geom, scores, classes,
                                      CONF, IOU, card)
    for b in TIMED_BATCHES:
        images = torch.from_numpy(np.random.default_rng(b).integers(
            0, 256, (b, *SRC_HW, 3), dtype=np.uint8)).cuda()
        time_suppress("suppress_detector_inputs",
                      *captured_suppress_inputs(model, images), card,
                      batch=b)
    for b in E2E_BATCHES:
        images = torch.from_numpy(np.random.default_rng(b).integers(
            0, 256, (b, *SRC_HW, 3), dtype=np.uint8)).cuda()
        ms = cuda_median_ms(lambda: model(images), reps=10)
        emit({"phase": "times", "what": "detector_e2e_bf16", "batch": b,
              "src_hw": list(SRC_HW), "ms": ms, "img_per_s": b * 1000 / ms,
              "card": card})
    return timed


def kernel_conv_shapes(cfg) -> dict:
    """{(h, w, cin, co, ks): count} of the convs the fused conv kernel
    takes, from the layer list at the config's (net_h, net_w), by the
    JAX package's gate: leaky or linear, groups 1, dilation 1
    (graph.py::conv_block) and ops.conv.eligible (stride 1, 1x1 or 3x3,
    CIN and CO multiples of 128)."""
    strides = layer_strides(cfg.layers)
    cins = iter(dw._conv_in_channels(cfg.layers, cfg.in_channels))
    shapes = {}
    for idx, layer in enumerate(cfg.layers):
        if isinstance(layer, (Connected, Local)) or (
                isinstance(layer, Shortcut) and layer.weights_type != "none"):
            next(cins)
        if not isinstance(layer, Conv):
            continue
        cin = next(cins)
        hwio = np.broadcast_to(np.float32(0), (layer.size, layer.size,
                                               cin, layer.filters))
        if (layer.act in ("leaky", "linear") and layer.groups == 1
                and layer.dilation == 1
                and conv.eligible(hwio, layer.stride)):
            s = strides[idx - 1] if idx else 1
            key = (cfg.input_h // s, cfg.input_w // s, cin, layer.filters,
                   layer.size)
            shapes[key] = shapes.get(key, 0) + 1
    return shapes


def eligible_conv_shapes(cfg) -> dict:
    """{(hw, cin, co, ks): count} of kernel_conv_shapes on a square
    net."""
    check(cfg.input_h == cfg.input_w, f"{cfg.name} is rectangular")
    return {(h, cin, co, ks): n
            for (h, _, cin, co, ks), n in kernel_conv_shapes(cfg).items()}


def bf16_ulp(x: torch.Tensor) -> torch.Tensor:
    """bf16 ulp (7 stored mantissa bits) at the magnitude of x."""
    return torch.exp2(torch.floor(torch.log2(x.abs().clamp_min(1e-30))) - 7)


def kernel_err(got: torch.Tensor, want: torch.Tensor, what: str) -> float:
    """Checks got against want with the tolerances of the module
    docstring; returns max |got - want|."""
    check(got.dtype == want.dtype and got.shape == want.shape,
          f"{what}: {got.dtype} {tuple(got.shape)} vs {want.dtype} "
          f"{tuple(want.shape)}")
    g, w = got.float(), want.float()
    check(bool(torch.isfinite(g).all()), f"{what}: non-finite output")
    err = (g - w).abs()
    bound = 1e-5 * w.abs().max()
    if got.dtype == torch.bfloat16:
        bound = bound + bf16_ulp(torch.maximum(g.abs(), w.abs()))
    check(bool((err <= bound).all()), f"{what}: max |kernel - plain| "
          f"{float(err.max())} beyond the tolerance")
    return float(err.max())


def conv_inputs(gen, b, hw, cin, co, ks, dtype) -> tuple:
    """Seeded activations (B, CIN, H, W) and He-scaled kernels, both
    channels_last in dtype, and an fp32 bias, on the card. hw: H = W,
    or (H, W)."""
    h, w = hw if isinstance(hw, tuple) else (hw, hw)
    x = torch.randn(b, cin, h, w, generator=gen, device="cuda")
    k = torch.randn(co, cin, ks, ks, generator=gen, device="cuda") \
        * (2.0 / (ks * ks * cin)) ** 0.5
    bias = torch.randn(co, generator=gen, device="cuda") * 0.5
    return (x.to(dtype).contiguous(memory_format=torch.channels_last),
            k.to(dtype).contiguous(memory_format=torch.channels_last), bias)


def entry_inputs(gen, images) -> tuple:
    """The entry kernel's padded fp32 image (from the route's letterbox)
    and He-scaled conv1 weights, on the card."""
    xpad = entry.letterbox_padded(images, 416, interp_dtype=torch.float32)
    k = torch.randn(32, 3, 3, 3, generator=gen, device="cuda") \
        * (2.0 / 27) ** 0.5
    bias = torch.randn(32, generator=gen, device="cuda") * 0.1
    return xpad, k, bias


DTYPES = ((torch.bfloat16, "bf16"), (torch.float32, "fp32"))


def phase_conv(gen, shapes) -> float:
    worst = 0.0
    for b in CONV_BATCHES:
        for hw, cin, co, ks in sorted(shapes):
            for dtype, name in DTYPES:
                x, k, bias = conv_inputs(gen, b, hw, cin, co, ks, dtype)
                got = conv_kernel.fused_conv_bias_act(x, k, bias,
                                                      act="leaky")
                again = conv_kernel.fused_conv_bias_act(x, k, bias,
                                                        act="leaky")
                torch.cuda.synchronize()
                want = conv.fused_conv_bias_act(x, k, bias, act="leaky")
                what = f"conv {b}x{hw}^2 {cin}->{co} {ks}x{ks} {name}"
                err = kernel_err(got, want, what)
                bits = torch.int16 if dtype == torch.bfloat16 else torch.int32
                same = torch.equal(got.view(bits), again.view(bits))
                check(same, f"{what}: two calls on the same inputs differ")
                worst = max(worst, err)
                emit({"phase": "conv", "batch": b, "hw": hw, "cin": cin,
                      "co": co, "ks": ks, "dtype": name,
                      "plan": list(conv_kernel.plan(
                          b, hw, hw, cin, co, ks,
                          bf16=dtype == torch.bfloat16)[:3]),
                      "max_abs_err": err, "deterministic": same,
                      "out_scale": float(want.float().abs().max())})
    return worst


def phase_entry(gen, images) -> float:
    worst = 0.0
    xpad, k, bias = entry_inputs(gen, images)
    for dtype, name in DTYPES:
        got = entry_kernel.fused_entry(xpad, k, bias, out_dtype=dtype)
        torch.cuda.synchronize()
        want = entry.fused_entry(xpad, k, bias, out_dtype=dtype)
        check(tuple(got.shape) == (len(images), 32, 208, 208),
              f"entry output {tuple(got.shape)}")
        err = kernel_err(got, want, f"entry 416 {name}")
        worst = max(worst, err)
        emit({"phase": "entry", "batch": len(images), "in_hw": [416, 416],
              "out": [32, 208, 208], "dtype": name, "max_abs_err": err,
              "out_scale": float(want.float().abs().max())})
    return worst


def phase_routes(model, model32, images, ref) -> dict:
    """Both kernel routes on the seeded YOLOv2-COCO 416, each count set
    to 0 just before the route runs and read just after."""
    cfg = model.cfg
    names = cfg.detection_names()
    conf = cfg.conf_threshold
    counts = {"conv": 0, "entry": 0}
    routes = (("conv_impl=cuda", lambda net: detect_raw(
                   cfg, net, images, conv_impl="cuda"), (ROUTE_CONVS, 0)),
              ("entry=fused", lambda net: make_detector(
                   cfg, entry="fused")(net, images), (0, 1)))
    for net, precision in ((model.params, "bf16"), (model32.params, "fp32")):
        for route, run, (n_conv, n_entry) in routes:
            conv_kernel.launches = entry_kernel.launches = 0
            nms_kernel.launches = 0
            out = run(net)
            torch.cuda.synchronize()
            got = (conv_kernel.launches, entry_kernel.launches)
            check(got == (n_conv, n_entry), f"{route} {precision}: "
                  f"(conv, entry) launches {got}, want {(n_conv, n_entry)} "
                  f"for one forward")
            check(nms_kernel.launches == 1, f"{route} {precision}: "
                  f"{nms_kernel.launches} NMS launches, want 1")
            counts["conv"] += got[0]
            counts["entry"] += got[1]
            check(tuple(out["boxes"].shape) == (len(images), 100, 4)
                  and bool(torch.isfinite(out["boxes"]).all())
                  and bool(torch.isfinite(out["scores"]).all()),
                  f"{route} {precision}: bad detections")
            dets = detections_to_json(out, names)
            agree = check_agree(ref, dets, conf,
                                f"{route} {precision} vs fp32 plain")
            emit({"phase": "routes", "route": route, "precision": precision,
                  "conv_launches": got[0], "entry_launches": got[1],
                  "nms_launches": nms_kernel.launches,
                  "detections_per_image": [len(d) for d in dets],
                  "vs_fp32_plain": agree})
    return counts


def conv_library_call(x, k, bias):
    """The one PyTorch call closest to the conv kernel's function: cuDNN's
    conv with bias (no leaky) on the same channels_last tensors, bf16 on
    the tensor cores, fp32 with TF32 off. A yardstick: the port never
    calls it."""
    with precision.exact_for(x.dtype):
        return F.conv2d(x, k, bias.to(x.dtype), padding=k.shape[-1] // 2)


def phase_kernel_times(gen, shapes, images, card) -> dict:
    """Per-call device time of each kernel, its plain version and the
    library call, beside the bound. The conv sums over YOLOv2-COCO's 16
    eligible convs (bf16, batch 32) and the bf16 entry at batch 32 go to
    the kernels line."""
    sums, bound_kinds = {}, {}
    for b in TIMED_BATCHES:
        for (hw, cin, co, ks), n in sorted(shapes.items()):
            for dtype, name in DTYPES:
                x, k, bias = conv_inputs(gen, b, hw, cin, co, ks, dtype)
                out = conv_library_call(x, k, bias)
                ms = cuda_ms_per_call(lambda: conv_kernel.fused_conv_bias_act(
                    x, k, bias, act="leaky"), calls=20)
                plain_ms = cuda_ms_per_call(lambda: conv.fused_conv_bias_act(
                    x, k, bias, act="leaky"), calls=20)
                library_ms = cuda_ms_per_call(
                    lambda: conv_library_call(x, k, bias), calls=20)
                flop = 2 * b * hw * hw * ks * ks * cin * co
                bound, bound_by = bound_ms(flop, nbytes(x, k, bias, out),
                                           dtype)
                emit({"phase": "times", "what": "conv", "batch": b,
                      "hw": hw, "cin": cin, "co": co, "ks": ks,
                      "dtype": name, "layers": n,
                      "plan": list(conv_kernel.plan(
                          b, hw, hw, cin, co, ks,
                          bf16=dtype == torch.bfloat16)[:3]),
                      "kernel_ms": ms, "plain_ms": plain_ms,
                      "library_ms": library_ms, "bound_ms": bound,
                      "bound_by": bound_by,
                      "kernel_tflops": flop / ms / 1e9,
                      "library_tflops": flop / library_ms / 1e9,
                      "share_of_bound": bound / ms, "card": card})
                total = sums.setdefault((b, name), [0.0] * 4)
                for i, t in enumerate((ms, plain_ms, library_ms, bound)):
                    total[i] += n * t
                by = bound_kinds.setdefault((b, name), {})
                by[bound_by] = by.get(bound_by, 0.0) + n * bound
    for (b, name), (ms, plain_ms, library_ms, bound) in sorted(sums.items()):
        # what bounds most of the summed bound
        by = max(bound_kinds[(b, name)].items(), key=lambda kv: kv[1])[0]
        emit({"phase": "times", "what": f"conv_16_layers_{name}",
              "batch": b, "kernel_ms": ms, "plain_ms": plain_ms,
              "library_ms": library_ms, "bound_ms": bound, "bound_by": by,
              "share_of_bound": bound / ms, "card": card})
    xpad, k, bias = entry_inputs(gen, images)
    entry_times = {}
    for dtype, name in DTYPES:
        out = entry_kernel.fused_entry(xpad, k, bias, out_dtype=dtype)
        ms = cuda_ms_per_call(lambda: entry_kernel.fused_entry(
            xpad, k, bias, out_dtype=dtype), calls=20)
        plain_ms = cuda_ms_per_call(lambda: entry.fused_entry(
            xpad, k, bias, out_dtype=dtype), calls=20)
        # 3x3x3 MACs per conv1 output; the pool and the epilogue are
        # comparisons and adds of a lower order
        flop = 2 * 27 * out.shape[0] * 32 * (2 * out.shape[2]) \
            * (2 * out.shape[3])
        bound, bound_by = bound_ms(flop, nbytes(xpad, k, bias, out),
                                   torch.float32)
        entry_times[name] = (ms, plain_ms, bound, bound_by)
        emit({"phase": "times", "what": "entry", "batch": len(images),
              "dtype": name, "kernel_ms": ms, "plain_ms": plain_ms,
              "library_ms": None, "bound_ms": bound, "bound_by": bound_by,
              "card": card})
    kinds = bound_kinds[(TIMED_BATCH, "bf16")]
    return {"conv": (*sums[(TIMED_BATCH, "bf16")],
                     max(kinds.items(), key=lambda kv: kv[1])[0]),
            "conv_fp32": sums[(TIMED_BATCH, "fp32")],
            "entry": entry_times["bf16"]}


def phase_route_times(model, model32, card) -> None:
    """End-to-end latency of the two kernel routes beside the default
    route (median of synchronized calls), raw 480x640 uint8 on the card:
    bf16 at E2E_BATCHES; fp32, the default and the conv kernel's route,
    at TIMED_BATCHES."""
    cfg = model.cfg
    fused = make_detector(cfg, entry="fused")
    bf16 = (("default", lambda im: model(im)),
            ("conv_impl=cuda", lambda im: detect_raw(
                cfg, model.params, im, conv_impl="cuda")),
            ("entry=fused", lambda im: fused(model.params, im)))
    fp32 = (("default", lambda im: model32(im)),
            ("conv_impl=cuda", lambda im: detect_raw(
                cfg, model32.params, im, conv_impl="cuda")))
    for name, routes, batches in (("bf16", bf16, E2E_BATCHES),
                                  ("fp32", fp32, TIMED_BATCHES)):
        for b in batches:
            images = torch.from_numpy(np.random.default_rng(b).integers(
                0, 256, (b, *SRC_HW, 3), dtype=np.uint8)).cuda()
            for route, fn in routes:
                ms = cuda_median_ms(lambda: fn(images), reps=10)
                emit({"phase": "times", "what": f"route_e2e_{name}",
                      "route": route, "batch": b, "src_hw": list(SRC_HW),
                      "ms": ms, "img_per_s": b * 1000 / ms, "card": card})


def write_backbone(cfg, root: str, cutoff: int = BACKBONE_LAYERS,
                   name: str = "darknet19_448.conv.23") -> str:
    """The seeded backbone partial file (synthetic_detector_params'
    He-scaled trunk, the first ``cutoff`` layers) -> its path."""
    n_backbone = len(weighted_specs(cfg.layers[:cutoff]))
    path = os.path.join(root, name)
    dw.save(path, cfg.layers[:cutoff],
            dw.synthetic_detector_params(cfg, SEED)[:n_backbone])
    return path


def fine_tune_init(cfg, root: str, cutoff: int = BACKBONE_LAYERS,
                   name: str = "darknet19_448.conv.23",
                   n_convs: int = 18) -> list:
    """The fine-tuning start (the JAX package's train command): a seeded
    backbone (synthetic_detector_params' He-scaled trunk) written as the
    darknet partial file ``name`` of the first ``cutoff`` layers, read
    back with load_partial (``n_convs`` convs), and the tail from
    random_params(scale=0.03)."""
    n_backbone = len(weighted_specs(cfg.layers[:cutoff]))
    path = write_backbone(cfg, root, cutoff, name)
    params, header, n = dw.load_partial(path, cfg.layers)
    check(n == n_backbone == n_convs, f"load_partial read {n} convs from "
          f"{name}, want {n_convs}")
    fresh = dw.random_params(cfg.layers, np.random.default_rng(SEED + 2),
                             scale=0.03, input_channels=cfg.in_channels)
    return params + fresh[n:]


def host_batches(cfg, pairs, batch, seed, epochs=1, **kw):
    """train_batches over ``epochs`` passes of pairs, one generator,
    targets encoded for cfg's head kind."""
    rng = np.random.default_rng(seed)
    return itertools.chain.from_iterable(
        train_batches(pairs, class_names=cfg.class_names,
                      anchors=cfg.anchors, num_classes=cfg.num_classes,
                      net_size=cfg.input_hw, batch_size=batch, rng=rng,
                      workers=PIPELINE_WORKERS, model_cfg=cfg, **kw)
        for _ in range(epochs))


def finite_metrics(metrics, what: str) -> dict:
    out = {k: float(v) for k, v in metrics.items()}
    check(all(np.isfinite(v) for v in out.values()),
          f"{what}: non-finite loss parts {out}")
    return out


def update_err(before, after, ref, keys) -> tuple:
    """(largest, conv and name) of ||update - reference update|| /
    ||reference update|| over the tensors named keys of every conv, the
    updates taken from before (float64 L2 norms)."""
    errs = []
    for i, (p0, pa, pb) in enumerate(zip(before, after, ref, strict=True)):
        for key in sorted(keys & p0.keys()):
            da = pa[key].astype(np.float64) - p0[key]
            db = pb[key].astype(np.float64) - p0[key]
            errs.append((float(np.linalg.norm(da - db)
                               / max(np.linalg.norm(db), 1e-30)),
                         f"{i}.{key}"))
    return max(errs)


class HeldChoices:
    """The discrete choices of DarknetTrain's forward and the [yolo]
    loss: each leaky unit's side of zero, each max-pool window's argmax
    (2x2/2 and the stride-1 SPP pools, over darknet's -inf padding) and
    each anchor's ignore gate (best IoU < ignore_thresh). Under record()
    a step runs as usual and its choices are kept; under replay()
    another step takes the kept choices, moved to its device, whatever
    its own values say, and counts where its own would differ (flips).
    Two steps that take the same choices differ by fp32 rounding alone.
    Swaps F.leaky_relu, graph.maxpool_nchw and loss._ignore_gate while
    active."""

    def __init__(self):
        self.signs, self.argmax, self.gates = [], [], []
        self.flips = {"leaky": 0, "pool": 0, "ignore": 0}

    @contextlib.contextmanager
    def _swapped(self, leaky, pool, gate):
        saved = F.leaky_relu, graph.maxpool_nchw, loss_mod._ignore_gate
        F.leaky_relu, graph.maxpool_nchw, loss_mod._ignore_gate = \
            leaky, pool, gate
        try:
            yield
        finally:
            F.leaky_relu, graph.maxpool_nchw, loss_mod._ignore_gate = saved

    @staticmethod
    def _padded(x, size):
        """x with ops/pool.py's darknet padding: size - 1 rows and
        columns of -inf, (size - 1) // 2 of them before."""
        pad = size - 1
        lead = pad // 2
        return F.pad(x, (lead, pad - lead, lead, pad - lead),
                     value=float("-inf"))

    def record(self):
        leaky_relu, gate_of = F.leaky_relu, loss_mod._ignore_gate

        def leaky(x, slope):
            self.signs.append((x > 0).detach())
            return leaky_relu(x, slope)

        def pool(x, size, stride):
            y, idx = F.max_pool2d_with_indices(self._padded(x, size), size,
                                               stride)
            self.argmax.append(idx)
            return y

        def gate(best_iou, thresh):
            g = gate_of(best_iou, thresh)
            self.gates.append(g.detach())
            return g
        return self._swapped(leaky, pool, gate)

    def replay(self):
        signs, argmax = iter(self.signs), iter(self.argmax)
        gates, gate_of = iter(self.gates), loss_mod._ignore_gate

        def leaky(x, slope):
            held = next(signs).to(x.device)
            self.flips["leaky"] += int(((x > 0) != held).sum())
            return torch.where(held, x, x * slope)

        def pool(x, size, stride):
            held = next(argmax).to(x.device)
            xp = self._padded(x, size)
            self.flips["pool"] += int((F.max_pool2d_with_indices(
                xp.detach(), size, stride)[1] != held).sum())
            return xp.flatten(2).gather(2, held.flatten(2)).view(held.shape)

        def gate(best_iou, thresh):
            held = next(gates).to(best_iou.device)
            self.flips["ignore"] += int(
                (gate_of(best_iou, thresh) != held).sum())
            return held
        return self._swapped(leaky, pool, gate)


@contextlib.contextmanager
def float64_products():
    """Every F.conv2d, and the [local] and [connected] products
    (torch.bmm, torch.matmul), in float64, each output (and through
    autograd its gradients) rounded to the caller's dtype once: a
    reference whose convs and dense products are exact to that
    rounding."""
    saved = F.conv2d, torch.bmm, torch.matmul

    def in_float64(fn):
        def call(x, w, *args, **kw):
            return fn(x.double(), w.double(), *args, **kw).to(x.dtype)
        return call
    F.conv2d, torch.bmm, torch.matmul = map(in_float64, saved)
    try:
        yield
    finally:
        F.conv2d, torch.bmm, torch.matmul = saved


@contextlib.contextmanager
def tf32_on():
    """fp32 convs in TF32, as cuDNN runs them by default: the port's
    precision.exact_for turns TF32 off, and here it does nothing."""
    saved = precision.no_tf32, torch.backends.cudnn.allow_tf32
    precision.no_tf32 = contextlib.nullcontext
    torch.backends.cudnn.allow_tf32 = True
    try:
        yield
    finally:
        precision.no_tf32, torch.backends.cudnn.allow_tf32 = saved


def card_vs_cpu_step(cfg, tcfg, params, host, phase: str,
                     own_choices: bool = True,
                     step_bound: float = STEP_BOUND) -> dict:
    """One fp32 step on the card against the same step on the CPU, on
    one host batch, past the burn-in ramp so that the update is the
    cfg's lr. The CPU's step (float64 convs) replays the card's
    choices; with own_choices, its step on its own choices shows what
    the flips alone move; and the card's step with TF32 on, against the
    CPU's step on that step's choices, must fail the bounds."""
    def step_on(dev, name):
        state = init_state(cfg, params, tcfg, device=dev)
        state.step = tcfg.burn_in_steps
        batch = {k: torch.from_numpy(v).to(dev) for k, v in host.items()}
        m = finite_metrics(make_train_step(cfg, tcfg)(state, batch),
                           f"step on {name}")
        return state.net.to_numpy(), m

    exact, loose = HeldChoices(), HeldChoices()
    with exact.record():
        gpu, m_gpu = step_on("cuda", "cuda")
    with tf32_on(), loose.record():
        gpu_tf32, _ = step_on("cuda", "cuda, TF32 on")
    cpu_own = None
    with float64_products():
        with exact.replay():
            cpu, m_cpu = step_on("cpu", "cpu")
        with loose.replay():
            cpu_tf32, _ = step_on("cpu", "cpu, TF32 choices")
        if own_choices:
            cpu_own, _ = step_on("cpu", "cpu, own choices")
    loss_rel = max(abs(m_gpu[k] - m_cpu[k]) / max(abs(m_cpu[k]), 1e-30)
                   for k in m_cpu)
    trained, stats = {"kernel", "gamma", "beta", "bias"}, {"mean", "var"}
    err = update_err(params, gpu, cpu, trained)
    stat_err = update_err(params, gpu, cpu, stats)
    tf32_err = update_err(params, gpu_tf32, cpu_tf32, trained)
    tf32_stat_err = update_err(params, gpu_tf32, cpu_tf32, stats)
    out = {"phase": phase, "check": "card_vs_cpu_step", "model": cfg.name,
           "input_hw": list(cfg.input_hw), "batch": len(host["images"]),
           "loss_parts_cuda": m_gpu, "loss_parts_cpu": m_cpu,
           "loss_max_rel_err": loss_rel, "update_rel_err": err,
           "bn_stat_update_rel_err": stat_err, "card_flips": exact.flips,
           "tf32_update_rel_err": tf32_err,
           "tf32_bn_stat_update_rel_err": tf32_stat_err,
           "tf32_flips": loose.flips,
           "bounds": {"loss": 1e-4, "update": step_bound,
                      "bn_stat_update": STAT_BOUND}}
    if cpu_own is not None:
        out["cpu_own_choices_update_rel_err"] = update_err(
            params, cpu_own, cpu, trained)
    emit(out)
    what = f"{cfg.name} card vs CPU"
    check(loss_rel <= 1e-4, f"{what} loss parts differ by {loss_rel}")
    check(err[0] <= step_bound, f"{what} updates differ by {err}")
    check(stat_err[0] <= STAT_BOUND, f"{what} BN statistic updates "
          f"differ by {stat_err}")
    check(tf32_err[0] > step_bound and tf32_stat_err[0] > STAT_BOUND,
          f"{what}: the bounds do not catch a step in TF32: {tf32_err}, "
          f"{tf32_stat_err}")
    return out


def timed_steps(cfg, tcfg, params, pairs, batch, steps, card, phase: str,
                augment_cfg, **emit_kw):
    """``steps`` steps a precision, fp32 then bf16, through
    train_batches -> DevicePrefetcher at ``batch``; each step's time
    from CUDA events in the loop and, on the last batch, ALONE_STEPS
    more without the pipeline. Returns the last batch."""
    last = None
    for name, dtype in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
        state = init_state(cfg, params, tcfg)
        step = make_train_step(cfg, tcfg, compute_dtype=dtype)
        epochs = -(-steps * batch // len(pairs))
        events, metrics = [], []
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with DevicePrefetcher(host_batches(cfg, pairs, batch, SEED + 3,
                                           epochs=epochs,
                                           augment_cfg=augment_cfg),
                              depth=2) as staged:
            for last in itertools.islice(staged, steps):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                metrics.append(step(state, last))
                end.record()
                events.append((start, end))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        check(len(metrics) == steps and state.step == steps,
              f"{cfg.name} {name}: {len(metrics)} steps ran")
        parts = [finite_metrics(m, f"{cfg.name} {name} step {i}")
                 for i, m in enumerate(metrics)]
        in_loop = [s.elapsed_time(e) for s, e in events]
        # the step alone, on the last batch: inside the loop the pipeline's
        # threads hold the interpreter lock between the step's launches,
        # and the events time those gaps too
        alone = []
        for _ in range(ALONE_STEPS):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            step(state, last)
            end.record()
            alone.append((start, end))
        torch.cuda.synchronize()
        ms = statistics.median(s.elapsed_time(e) for s, e in alone)
        emit({"phase": phase, "check": "steps", "model": cfg.name,
              "input_hw": list(cfg.input_hw), "precision": name,
              "batch": batch, "grad_accum": tcfg.grad_accum, "steps": steps,
              "first_loss": parts[0], "last_loss": parts[-1],
              "step_ms": ms, "img_per_s": batch * 1000 / ms,
              "in_loop_step_ms_median": statistics.median(in_loop),
              "in_loop_step_ms_min": min(in_loop),
              "in_loop_step_ms_max": max(in_loop),
              "loop_img_per_s": steps * batch / wall,
              "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
              "card": card, **emit_kw})
        del state
    return last


def phase_train(cfg, tcfg, params, pairs, card) -> tuple:
    """Phase 10; returns (Adam-overfit train state, its scenes, its
    params after EARLY_STEPS)."""
    # (a) one fp32 step, card against CPU, on the same batch of 2
    host = next(host_batches(cfg, pairs[:CHECK_BATCH], CHECK_BATCH, SEED,
                             shuffle=False, augment_cfg=NET_AUGMENT))
    card_vs_cpu_step(cfg, tcfg, params, host, "train")

    # (b) TRAIN_STEPS steps a precision through the prefetcher; (c) one
    # step at the cfg's subdivisions on the last batch
    last = timed_steps(cfg, tcfg, params, pairs, TRAIN_BATCH, TRAIN_STEPS,
                       card, "train", NET_AUGMENT)
    tcfg8 = dataclasses.replace(tcfg, grad_accum=SUBDIVISIONS)
    state = init_state(cfg, params, tcfg8)
    m = finite_metrics(make_train_step(cfg, tcfg8)(state, last),
                       "grad_accum step")
    emit({"phase": "train", "check": "grad_accum", "grad_accum":
          SUBDIVISIONS, "batch": TRAIN_BATCH, "loss": m})
    del state, last

    # (d) Adam overfits a few fixed scenes, no augmentation, no burn-in
    scenes = pairs[:OVERFIT_SCENES]
    with DevicePrefetcher(host_batches(cfg, scenes, OVERFIT_SCENES, SEED,
                                       shuffle=False)) as staged:
        batch = next(iter(staged))
    ocfg = TrainConfig(optimizer="adam", learning_rate=1e-3,
                       weight_decay=0.0005, loss=tcfg.loss)
    state = init_state(cfg, params, ocfg)
    step = make_train_step(cfg, ocfg)
    losses = []
    for i in range(OVERFIT_STEPS):
        losses.append(finite_metrics(step(state, batch), f"overfit step {i}"))
        if i + 1 == EARLY_STEPS:
            early = ema_params_of(state)
    first, last = losses[0], losses[-1]
    emit({"phase": "train", "check": "overfit", "scenes": OVERFIT_SCENES,
          "steps": OVERFIT_STEPS, "first_loss": first, "last_loss": last,
          "ratio": {k: last[k] / first[k] for k in first},
          "fraction": OVERFIT_FRACTION,
          "loss_every_50": [m["loss"] for m in losses[::50]]})
    check(all(last[k] < OVERFIT_FRACTION * first[k]
              for k in ("loss", "coord", "class")),
          f"overfit loss {first} -> {last}")
    return state, scenes, early


def agreement(a: dict, b: dict, conf: float) -> tuple:
    """(matched, total) over a's detections scoring >= conf + MARGIN:
    matched when b's same image holds a same-class box with IoU >=
    MATCH_IOU, the VOC devkit's +1 pixel IoU, under which a box clipped
    to a line on the image's edge still matches itself."""
    hit = tot = 0
    for img_id, dets in a.items():
        boxes = np.array([o for _, _, *o in b[img_id]],
                         np.float64).reshape(-1, 4)
        classes = np.array([c for c, *_ in b[img_id]])
        for cls, score, *box in dets:
            if score < conf + MARGIN:
                continue
            same = boxes[classes == cls]
            tot += 1
            hit += bool(len(same) and (_iou_xyxy_voc(
                np.asarray(box, np.float64), same) >= MATCH_IOU).any())
    return hit, tot


def card_vs_cpu_eval(cfg, folded, samples, gt, what: str,
                     min_boxes: int) -> dict:
    """collect_detections on the card and on the CPU from the same
    folded params: every detection scoring >= EVAL_CONF + MARGIN matched
    both ways, at least min_boxes of them, and mAP to a relative
    MAP_REL."""
    dets = {dev: collect_detections(cfg, folded, samples, batch=EVAL_BATCH,
                                    eval_conf=EVAL_CONF, device=dev)
            for dev in ("cuda", "cpu")}
    maps = {dev: evaluate(d, gt, cfg.num_classes)["map"]
            for dev, d in dets.items()}
    out = {"map_cuda": maps["cuda"], "map_cpu": maps["cpu"]}
    for name, (x, y) in (("cuda_in_cpu", ("cuda", "cpu")),
                         ("cpu_in_cuda", ("cpu", "cuda"))):
        hit, tot = agreement(dets[x], dets[y], EVAL_CONF)
        out[name] = [hit, tot]
        check(tot >= min_boxes and hit == tot, f"eval {what} {name}: "
              f"{hit}/{tot} detections >= {EVAL_CONF + MARGIN} matched, "
              f"want all of at least {min_boxes}")
    check(abs(maps["cuda"] - maps["cpu"]) <= MAP_REL * abs(maps["cpu"]),
          f"eval {what}: mAP card {maps['cuda']} vs CPU {maps['cpu']}")
    return out


def phase_eval(cfg, state, params, early, held_out, scenes, card) -> tuple:
    """Phase 11; returns (NMS launches on the eval path, eval-grid
    suppress times)."""
    trained = ema_params_of(state)
    folded = fold_params(cfg.layers, trained, cfg.bn_eps)
    gt, _ = build_ground_truth(held_out, cfg.class_names)
    collect_detections(cfg, folded, held_out[:EVAL_BATCH], batch=EVAL_BATCH)
    torch.cuda.synchronize()   # warm: cuDNN's algorithm choice

    nms_kernel.launches = 0
    t0 = time.perf_counter()
    map_quick = quick_map(cfg, trained, held_out, batch=EVAL_BATCH,
                          eval_conf=EVAL_CONF)
    wall = time.perf_counter() - t0
    launches = nms_kernel.launches
    n_batches = -(-len(held_out) // EVAL_BATCH)
    check(launches == n_batches, f"the eval path launched the NMS kernel "
          f"{launches} times for {n_batches} batches")

    # the suppress inputs the eval path hands the kernel, captured
    got = []
    kernel = nms_kernel.suppress

    def capture(geom, scores, classes, *, conf_threshold, iou_threshold):
        got.append((geom.clone(), scores.clone(), classes.clone(),
                    conf_threshold, iou_threshold))
        return kernel(geom, scores, classes, conf_threshold=conf_threshold,
                      iou_threshold=iou_threshold)

    nms_kernel.suppress = capture
    try:
        t0 = time.perf_counter()
        collect_detections(cfg, folded, held_out, batch=EVAL_BATCH,
                           eval_conf=EVAL_CONF)
        collect_s = time.perf_counter() - t0
    finally:
        nms_kernel.suppress = kernel
    overfit = card_vs_cpu_eval(cfg, folded, held_out, gt, "overfit", 1)
    check(abs(map_quick - overfit["map_cuda"]) <= 1e-6, f"quick_map "
          f"{map_quick} vs collect_detections + evaluate {overfit}")
    at_early = card_vs_cpu_eval(cfg, fold_params(cfg.layers, early,
                                                 cfg.bn_eps),
                                held_out, gt, f"after {EARLY_STEPS} steps",
                                MIN_EVAL_BOXES)
    own = quick_map(cfg, trained, scenes, batch=EVAL_BATCH)
    untrained = quick_map(cfg, params, scenes, batch=EVAL_BATCH)
    emit({"phase": "eval", "model": cfg.name, "held_out": len(held_out),
          "batch": EVAL_BATCH, "eval_conf": EVAL_CONF,
          "card_vs_cpu": {"overfit": overfit, f"after_{EARLY_STEPS}_steps":
                          at_early},
          "nms_launches": launches,
          "eval_img_per_s": len(held_out) / wall,
          "collect_img_per_s": len(held_out) / collect_s,
          "map_overfit_own_scenes": own, "map_untrained_own_scenes":
          untrained, "card": card})
    check(own > untrained, f"the overfit model's mAP on its own scenes "
          f"{own} is no better than the untrained model's {untrained}")

    geom, scores, classes, conf, iou = got[0]
    check(tuple(geom.shape) == (EVAL_BATCH * cfg.num_classes, 5, 128)
          and conf == EVAL_CONF, f"eval grid {tuple(geom.shape)} at conf "
          f"{conf}")
    timed = time_suppress("suppress_eval_grid", geom, scores, classes, conf,
                          iou, card, batch=EVAL_BATCH)
    return launches, timed


def phase_fine_tune(card) -> tuple:
    """Phases 10-11 on YOLOv2-VOC 416 over a seeded synthetic VOC set in
    a temp dir; returns (NMS launches on the eval path, eval-grid
    suppress times)."""
    cfg = get_variant(TRAIN_VARIANT)
    check(cfg.input_hw == (416, 416) and cfg.num_classes == 20
          and cfg.num_anchors == 5 and len(weighted_specs(cfg.layers)) == 23,
          f"unexpected config {cfg.name}")
    tcfg = TrainConfig(**NET_SCHEDULE, loss=region_loss_config(cfg))
    rng = np.random.default_rng(SEED + 4)
    palette = rng.integers(0, 256, (len(VOC_NAMES), 3), dtype=np.uint8)
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        roots = [os.path.join(tmp, d) for d in ("train", "held_out")]
        for d in roots:
            os.mkdir(d)
        # training PNGs in all five row filters, held-out JPEGs (4:2:0)
        pairs, held_out = (
            write_voc_scenes(d, [SCENE_HW[i % len(SCENE_HW)]
                                 for i in range(n)], rng, palette=palette,
                             **kw)
            for d, n, kw in zip(roots, (TRAIN_SCENES, HELD_OUT_SCENES),
                                ({"filters": (0, 1, 2, 3, 4)},
                                 {"jpeg_quality": 90})))
        params = fine_tune_init(cfg, tmp)
        t1 = time.perf_counter()
        state, scenes, early = phase_train(cfg, tcfg, params, pairs, card)
        t2 = time.perf_counter()
        launches, timed = phase_eval(cfg, state, params, early, held_out,
                                     scenes, card)
        emit({"phase": "fine_tune", "data_seconds": t1 - t0,
              "train_seconds": t2 - t1,
              "eval_seconds": time.perf_counter() - t2})
    return launches, timed


def voc_variant(variant: str):
    """A variant's own layer builder with a 20-class head (3 * (5 + 20)
    filters a [yolo] head) and the VOC names, as a VOC fine-tune cfg of
    that model sets them."""
    cfg = get_variant(variant)
    return dataclasses.replace(cfg, name=f"{cfg.name[:-5]}-voc",
                               layers=LAYER_BUILDERS[variant](3 * 25),
                               class_names=VOC_NAMES)


def frames(seed: int, b: int) -> torch.Tensor:
    """Seeded raw 480x640 uint8 frames on the card."""
    return torch.from_numpy(np.random.default_rng(seed).integers(
        0, 256, (b, *SRC_HW, 3), dtype=np.uint8)).cuda()


def check_routes(cfg, model, model32, images, n_kernel: int,
                 launches: dict) -> list:
    """detect_raw of cfg on the card in bf16 and fp32, on the default
    route and on conv_impl="cuda": each forward launches the conv kernel
    0 and n_kernel times and the NMS kernel once (counts set to 0 just
    before and read just after, added to launches), gives finite
    fixed-shape detections, and agrees with the fp32 plain path (full
    decode + exact per-class NMS in plain PyTorch, convs without TF32)
    at box level by phase 12's rule. Returns the rows to emit."""
    names, conf = cfg.detection_names(), cfg.conf_threshold
    plain = make_detector(cfg, head="reference", nms_impl="torch")
    ref = detections_to_json(plain(model32.params, images), names)
    rows = []
    for net, precision in ((model.params, "bf16"), (model32.params, "fp32")):
        for route, kw, n_conv in (("default", {}, 0),
                                  ("conv_impl=cuda", {"conv_impl": "cuda"},
                                   n_kernel)):
            conv_kernel.launches = nms_kernel.launches = 0
            out = detect_raw(cfg, net, images, **kw)
            torch.cuda.synchronize()
            got = (conv_kernel.launches, nms_kernel.launches)
            what = f"{cfg.name} {route} {precision}"
            check(got == (n_conv, 1), f"{what}: (conv, NMS) launches "
                  f"{got}, want {(n_conv, 1)} for one forward")
            launches["conv"] += got[0]
            launches["nms"] += got[1]
            check(tuple(out["boxes"].shape) == (len(images), 100, 4)
                  and bool(torch.isfinite(out["boxes"]).all())
                  and bool(torch.isfinite(out["scores"]).all()),
                  f"{what}: bad detections")
            dets = detections_to_json(out, names)
            rows.append({"route": route, "precision": precision,
                         "conv_launches": got[0], "nms_launches": got[1],
                         "detections_per_image": [len(d) for d in dets],
                         "vs_fp32_plain": check_agree(
                             ref, dets, conf, f"{what} vs fp32 plain",
                             iou=_iou_voc)})
    rows.append({"route": "plain", "precision": "fp32",
                 "detections_per_image": [len(d) for d in ref]})
    return rows


def entry_fused_raises(cfg, model, images) -> bool:
    """entry="fused" refuses cfg with ValueError, as the JAX package's
    fused branch does."""
    try:
        detect_raw(cfg, model.params, images, entry="fused")
    except ValueError:
        return True
    return False


def check_http(model, images, launches: dict, phase: str) -> None:
    """A DetectionServer for model answers each frame, posted as an
    application/x-npy body, as a direct call on that frame does; its NMS
    launches are added to launches."""
    cfg, names = model.cfg, model.cfg.detection_names()
    served = images.cpu().numpy()
    server = DetectionServer(cfg, model.params, port=0, max_batch=32)
    server.start()
    try:
        nms_kernel.launches = 0
        responses = [post_npy(server.port, img) for img in served]
        launches["nms"] += nms_kernel.launches
        stats = dict(server.stats)
    finally:
        server.stop()
    direct = [detections_to_json(model(served[i:i + 1]), names)[0]
              for i in range(len(served))]
    check(stats["errors"] == 0, f"server errors: {stats}")
    for i, resp in enumerate(responses):
        check(resp == direct[i], f"{cfg.name}: response {i} differs from "
              f"the direct detector call")
    emit({"phase": phase, "check": "http", "model": cfg.name,
          "requests": stats["requests"], "responses_equal_direct": True,
          "detections_per_image": [len(d) for d in direct]})


def phase_yolo_serve(tmp: str, card: str) -> dict:
    """Phase 12 (a): the five variants, seeded and written as darknet
    .weights files, loaded by size through yolo_tpu_torch.load at their
    published sizes, on both routes in bf16 and fp32; (b) a
    DetectionServer for YOLO_SERVED. Returns the kernel launches and the
    loaded models of the end-to-end timings."""
    launches = {"conv": 0, "nms": 0}
    images = frames(SEED + 12, YOLO_IMAGES)
    kept = {}
    for variant in YOLO_VARIANTS:
        cfg = get_variant(variant)
        path = os.path.join(tmp, f"{variant}-seed.weights")
        t0 = time.perf_counter()
        dw.save(path, cfg.layers, dw.synthetic_detector_params(cfg, SEED))
        seed_s = time.perf_counter() - t0
        model = yolo_tpu_torch.load(path, device="cuda")
        model32 = yolo_tpu_torch.load(path, device="cuda", precision="fp32")
        check(model.cfg == cfg, f"load inferred {model.cfg.name} from "
              f"{variant}'s file")
        rows = check_routes(cfg, model, model32, images,
                            YOLO_KERNEL_CONVS[variant], launches)
        fused_raises = entry_fused_raises(cfg, model, images)
        check(fused_raises, f"{cfg.name}: entry='fused' did not raise")
        emit({"phase": "yolo_serve", "model": cfg.name,
              "input_hw": list(cfg.input_hw),
              "weights_bytes": os.path.getsize(path),
              "seed_weights_s": seed_s, "routes": rows,
              "entry_fused_raises": fused_raises,
              "agreement_rule": {"margin": MARGIN, "voc_iou": MATCH_IOU,
                                 "min_match": MIN_MATCH}})
        if variant in YOLO_E2E or variant == YOLO_SERVED:
            kept[variant] = model
        del model32
    check_http(kept[YOLO_SERVED], images, launches, "yolo_serve")
    return launches, kept


def phase_yolo_conv(gen, card) -> tuple:
    """Phase 12 (c): each conv shape of the five variants that
    YOLOv2-COCO 416 does not have, at batch 1 and TIMED_BATCH in bf16
    and fp32: the kernel against its plain version with phase 6's
    bounds (two calls give the same bytes), and timed as phase 9 times a
    shape. Returns (worst |kernel - plain|, shapes)."""
    per_variant = {v: eligible_conv_shapes(get_variant(v))
                   for v in YOLO_VARIANTS}
    for v, shapes in per_variant.items():
        check(sum(shapes.values()) == YOLO_KERNEL_CONVS[v],
              f"{v}: {sum(shapes.values())} kernel convs")
    coco = eligible_conv_shapes(get_variant(VARIANT))
    new = sorted(set().union(*per_variant.values()) - set(coco))
    worst = 0.0
    for b in TIMED_BATCHES:
        for hw, cin, co, ks in new:
            for dtype, name in DTYPES:
                err, row = conv_shape_row(gen, b, (hw, hw), cin, co, ks,
                                          dtype, card)
                worst = max(worst, err)
                emit({"phase": "yolo_conv", **row,
                      "layers": {v: s[(hw, cin, co, ks)]
                                 for v, s in per_variant.items()
                                 if (hw, cin, co, ks) in s}})
    return worst, new


def conv_shape_row(gen, b, hw, cin, co, ks, dtype, card) -> tuple:
    """One conv shape at batch b: the kernel against its plain version
    with phase 6's bounds (two calls give the same bytes), then timed as
    phase 9 times a shape, beside the library call and the bound.
    hw: (H, W). Returns (|kernel - plain|, the row to emit)."""
    h, w = hw
    name = "bf16" if dtype == torch.bfloat16 else "fp32"
    x, k, bias = conv_inputs(gen, b, hw, cin, co, ks, dtype)
    got = conv_kernel.fused_conv_bias_act(x, k, bias, act="leaky")
    again = conv_kernel.fused_conv_bias_act(x, k, bias, act="leaky")
    torch.cuda.synchronize()
    want = conv.fused_conv_bias_act(x, k, bias, act="leaky")
    what = f"conv {b}x{h}x{w} {cin}->{co} {ks}x{ks} {name}"
    err = kernel_err(got, want, what)
    bits = torch.int16 if dtype == torch.bfloat16 else torch.int32
    check(torch.equal(got.view(bits), again.view(bits)),
          f"{what}: two calls on the same inputs differ")
    out = conv_library_call(x, k, bias)
    ms = cuda_ms_per_call(lambda: conv_kernel.fused_conv_bias_act(
        x, k, bias, act="leaky"), calls=YOLO_SHAPE_CALLS)
    plain_ms = cuda_ms_per_call(lambda: conv.fused_conv_bias_act(
        x, k, bias, act="leaky"), calls=YOLO_SHAPE_CALLS)
    library_ms = cuda_ms_per_call(lambda: conv_library_call(x, k, bias),
                                  calls=YOLO_SHAPE_CALLS)
    flop = 2 * b * h * w * ks * ks * cin * co
    bound, bound_by = bound_ms(flop, nbytes(x, k, bias, out), dtype)
    return err, {"batch": b, "hw": h if h == w else [h, w], "cin": cin,
                 "co": co, "ks": ks, "dtype": name,
                 "plan": list(conv_kernel.plan(
                     b, h, w, cin, co, ks,
                     bf16=dtype == torch.bfloat16)[:3]),
                 "max_abs_err": err,
                 "out_scale": float(want.float().abs().max()),
                 "kernel_ms": ms, "plain_ms": plain_ms,
                 "library_ms": library_ms, "bound_ms": bound,
                 "bound_by": bound_by, "share_of_bound": bound / ms,
                 "card": card}


def phase_yolo_times(kept, card) -> None:
    """Phase 12 (d): end-to-end latency (median of synchronized calls)
    of the YOLO_E2E variants on both routes, bf16, raw 480x640 frames."""
    for variant, batches in YOLO_E2E.items():
        model = kept[variant]
        cfg = model.cfg
        for b in batches:
            images = frames(b, b)
            for route, fn in (("default", lambda im: model(im)),
                              ("conv_impl=cuda", lambda im: detect_raw(
                                  cfg, model.params, im, conv_impl="cuda"))):
                ms = cuda_median_ms(lambda: fn(images), reps=5)
                emit({"phase": "times", "what": "yolo_e2e_bf16",
                      "model": cfg.name, "input_hw": list(cfg.input_hw),
                      "route": route, "batch": b, "src_hw": list(SRC_HW),
                      "ms": ms, "img_per_s": b * 1000 / ms, "card": card})


def phase_yolo_train(card) -> int:
    """Phase 13 on seeded synthetic VOC scenes, mosaic off (yolov4.cfg
    sets mosaic=1: ROADMAP A9f); returns the NMS launches of its eval.
    (a) one fp32 step of yolov3 (mse, 416) and of yolov4 (ciou, mish,
    SPP, 608) at full width from seeded weights, card against CPU, on a
    micro-batch of CHECK_BATCH images (the CPU's float64 step at 608 is
    what it costs), every discrete choice of the card's step held
    (leaky sides, the SPP pools' maxima, the yolo loss's ignore gates),
    with phase 10's bounds (yolov4's update bound YOLO_STEP_BOUND),
    which the same step with TF32 on fails;
    (b) TRAIN_STEPS steps of YOLO_TIMED at the cfg's batch 64 and
    subdivisions 8, fp32 and bf16; (c) an Adam overfit of YOLO_OVERFIT
    scored by quick_map, card and CPU held at box level as phase 11."""
    rng = np.random.default_rng(SEED + 13)
    palette = rng.integers(0, 256, (len(VOC_NAMES), 3), dtype=np.uint8)
    with tempfile.TemporaryDirectory() as tmp:
        roots = [os.path.join(tmp, d) for d in ("train", "held_out")]
        for d in roots:
            os.mkdir(d)
        pairs, held_out = (
            write_voc_scenes(d, [SCENE_HW[i % len(SCENE_HW)]
                                 for i in range(n)], rng, palette=palette)
            for d, n in zip(roots, (TRAIN_SCENES, HELD_OUT_SCENES)))
        for variant, (subdivisions, schedule) in YOLO_NETS.items():
            cfg = voc_variant(variant)
            tcfg = TrainConfig(**schedule, grad_accum=subdivisions,
                               yolo_loss=yolo_loss_config(cfg))
            params = fine_tune_init(cfg, tmp, *YOLO_PARTIALS[variant])
            host = next(host_batches(cfg, pairs[:CHECK_BATCH], CHECK_BATCH,
                                     SEED, shuffle=False,
                                     augment_cfg=YOLO_AUGMENT))
            card_vs_cpu_step(cfg, dataclasses.replace(tcfg, grad_accum=1),
                             params, host, "yolo_train", own_choices=False,
                             step_bound=YOLO_STEP_BOUND[variant])
            if variant == YOLO_TIMED:
                timed_steps(cfg, tcfg, params, pairs, TRAIN_BATCH,
                            TRAIN_STEPS, card, "yolo_train", YOLO_AUGMENT)
            del params
        cfg = voc_variant(YOLO_OVERFIT)
        params = fine_tune_init(cfg, tmp, *YOLO_PARTIALS[YOLO_OVERFIT])
        return yolo_overfit(cfg, params, pairs, held_out, card)


def yolo_overfit(cfg, params, pairs, held_out, card) -> int:
    """Phase 13 (c); returns the NMS launches of its quick_map."""
    scenes = pairs[:YOLO_OVERFIT_SCENES]
    with DevicePrefetcher(host_batches(cfg, scenes, YOLO_OVERFIT_SCENES,
                                       SEED, shuffle=False)) as staged:
        batch = next(iter(staged))
    ocfg = TrainConfig(optimizer="adam", learning_rate=1e-3,
                       weight_decay=0.0005, yolo_loss=yolo_loss_config(cfg))
    state = init_state(cfg, params, ocfg)
    step = make_train_step(cfg, ocfg)
    losses = []
    for i in range(YOLO_OVERFIT_STEPS):
        losses.append(finite_metrics(step(state, batch), f"overfit step {i}"))
        if i + 1 == EARLY_STEPS:
            early = ema_params_of(state)
    first, last = losses[0], losses[-1]
    emit({"phase": "yolo_train", "check": "overfit_loss", "model": cfg.name,
          "steps": YOLO_OVERFIT_STEPS, "first_loss": first,
          "last_loss": last, "ratio": {k: last[k] / first[k] for k in first},
          "loss_every_50": [m["loss"] for m in losses[::50]],
          "coord_every_50": [m["coord"] for m in losses[::50]]})
    check(all(last[k] < OVERFIT_FRACTION * first[k]
              for k in ("loss", "class"))
          and last["coord"] < YOLO_OVERFIT_COORD * first["coord"],
          f"{cfg.name} overfit loss {first} -> {last}")
    trained = ema_params_of(state)
    gt, _ = build_ground_truth(held_out, cfg.class_names)
    nms_kernel.launches = 0
    map_quick = quick_map(cfg, trained, held_out, batch=EVAL_BATCH)
    launches = nms_kernel.launches
    check(launches == -(-len(held_out) // EVAL_BATCH),
          f"{cfg.name}: quick_map launched the NMS kernel {launches} times")
    overfit = card_vs_cpu_eval(cfg, fold_params(cfg.layers, trained,
                                                cfg.bn_eps),
                               held_out, gt, f"{cfg.name} overfit", 1)
    check(abs(map_quick - overfit["map_cuda"]) <= 1e-6,
          f"quick_map {map_quick} vs {overfit}")
    at_early = card_vs_cpu_eval(cfg, fold_params(cfg.layers, early,
                                                 cfg.bn_eps), held_out, gt,
                                f"{cfg.name} after {EARLY_STEPS} steps", 1)
    own = quick_map(cfg, trained, scenes, batch=EVAL_BATCH)
    untrained = quick_map(cfg, params, scenes, batch=EVAL_BATCH)
    emit({"phase": "yolo_train", "check": "overfit", "model": cfg.name,
          "input_hw": list(cfg.input_hw), "scenes": YOLO_OVERFIT_SCENES,
          "steps": YOLO_OVERFIT_STEPS,
          "card_vs_cpu": {"overfit": overfit,
                          f"after_{EARLY_STEPS}_steps": at_early},
          "nms_launches": launches, "map_overfit_own_scenes": own,
          "map_untrained_own_scenes": untrained, "card": card})
    check(own > untrained, f"{cfg.name}: the overfit model's mAP on its "
          f"own scenes {own} is no better than the untrained model's "
          f"{untrained}")
    return launches


def phase_fixtures() -> int:
    """Phase 14 (b): every fixture decodes to the sha256 and shape of
    cv2's output recorded beside it, at 3 and 1 channels."""
    with open(os.path.join(FIXTURES, "hashes.json")) as f:
        recorded = json.load(f)
    for name, want in sorted(recorded["files"].items()):
        for key, channels in (("rgb", 3), ("gray", 1)):
            if want[key] is None:     # cv2 gives no image of these channels
                try:
                    decode_image(os.path.join(FIXTURES, name), channels)
                except ValueError:
                    continue
                check(False, f"fixture {name} ({key}): decoded where cv2 "
                      f"gives no image")
            img = decode_image(os.path.join(FIXTURES, name), channels)
            digest = hashlib.sha256(img.tobytes()).hexdigest()
            check(list(img.shape) == want[key]["shape"]
                  and digest == want[key]["sha256"],
                  f"fixture {name} ({key}): {img.shape} {digest}, want "
                  f"{want[key]}")
    emit({"phase": "images", "check": "fixtures",
          "files": len(recorded["files"]), "hashes_equal": True,
          "recorded_from": recorded["decoder"]})
    return len(recorded["files"])


def phase_fixture_detect(weights: str, card: str) -> int:
    """Phase 14 (b): the new kinds' fixtures through `detect --images` on
    the default route and through POST /detect; returns the NMS
    launches of both runs."""
    from yolo_tpu_torch.cli.detect_cmds import _det_json

    names = sorted(n for n in os.listdir(FIXTURES)
                   if n.startswith(NEW_KIND_FIXTURES))
    check(len(names) >= 10, f"new-kind fixtures {names}")
    with tempfile.TemporaryDirectory() as tmp:
        for n in names:
            os.symlink(os.path.join(FIXTURES, n), os.path.join(tmp, n))
        out, _, wall, nms = cli_run(["detect", "--model", VARIANT,
                                     "--weights", weights, "--images", tmp,
                                     "--batch", "1", "--conf",
                                     str(FIXTURE_CONF)])
    recs = cli_lines(out)
    check([os.path.basename(r["image"]) for r in recs] == names
          and nms == len(names), f"detect --images over the fixtures: "
          f"{len(recs)} lines, {nms} NMS launches, want {len(names)}")
    cfg = dataclasses.replace(get_variant(VARIANT),
                              conf_threshold=FIXTURE_CONF)
    net = Darknet(cfg.layers, fold_params(
        cfg.layers, dw.load(weights, cfg.layers)[0], cfg.bn_eps),
        device="cuda", dtype=torch.bfloat16)
    labels = cfg.detection_names()
    boxes = {}
    for r, name in zip(recs, names):
        frame = decode_image(os.path.join(FIXTURES, name))
        with torch.no_grad():
            o = detect_raw(cfg, net, torch.from_numpy(frame[None]).cuda())
        o = {k: v[0].cpu().numpy() for k, v in o.items()}
        keep = np.nonzero(o["valid"])[0]
        direct = _det_json(labels, o["classes"], o["scores"],
                           o["boxes"][keep].astype(np.float64), keep)
        check(r["detections"] == direct, f"detect --images {name}: the "
              f"lines differ from detect_raw on the decoded array")
        check(len(direct) > 0, f"{name}: no boxes at conf {FIXTURE_CONF}")
        boxes[name] = len(direct)
    model = yolo_tpu_torch.load(weights, VARIANT, device="cuda",
                                conf_threshold=FIXTURE_CONF)
    server = DetectionServer(model.cfg, model.params, port=0,
                             conf_threshold=FIXTURE_CONF)
    server.start()
    try:
        served = 0
        for name in names:
            with open(os.path.join(FIXTURES, name), "rb") as f:
                body = f.read()
            ctype = "image/png" if name.endswith(".png") else "image/jpeg"
            nms_kernel.launches = 0
            answer = post_body(server.port, body, ctype)
            served += nms_kernel.launches     # the direct call's apart
            direct = detections_to_json(
                model(decode_image_bytes(body)[None]), labels)[0]
            check(answer == direct and answer, f"POST /detect {name}: "
                  f"the answer differs from a direct call")
    finally:
        server.stop()
    check(served == len(names), f"POST /detect: {served} NMS launches for "
          f"{len(names)} bodies")
    emit({"phase": "images", "check": "new_kinds_to_boxes",
          "files": len(names), "boxes": boxes, "conf": FIXTURE_CONF,
          "detect_nms_launches": nms, "served_nms_launches": served,
          "detect_seconds": wall, "lines_equal_detect_raw": True,
          "answers_equal_direct": True, "card": card})
    return nms + served


def rgb_fixtures(prefixes) -> list:
    """The fixtures of these name prefixes that cv2 reads at 3 channels
    (a gray PFM's "rgb" hash is null: no RGB image in cv2 or the port)."""
    with open(os.path.join(FIXTURES, "hashes.json")) as f:
        files = json.load(f)["files"]
    return sorted(n for n, h in files.items()
                  if n.startswith(prefixes) and h["rgb"] is not None)


def phase_format_detect(weights: str, card: str) -> dict:
    """Phase 14 (b): every BMP, PNM, TIFF, WebP, GIF, Sun raster, PFM and
    HDR fixture of an RGB image, the damaged and overflowing JPEGs and six
    JPEG 2000 files (JP2_DETECT_FIXTURES) through `predict --image` and
    POST /detect, the BMPs also through
    `detect --images --output-dir`: one NMS launch a file, the lines
    equal detect_raw on the decoded array; a TIFF and a WebP also on
    conv_impl="cuda". Returns {kernel: launches}."""
    from yolo_tpu_torch.cli.detect_cmds import _det_json

    names = rgb_fixtures(FORMAT_FIXTURES) + list(JP2_DETECT_FIXTURES)
    check(len(names) >= 34, f"format fixtures {names}")
    cfg = dataclasses.replace(get_variant(VARIANT),
                              conf_threshold=FIXTURE_CONF)
    net = Darknet(cfg.layers, fold_params(
        cfg.layers, dw.load(weights, cfg.layers)[0], cfg.bn_eps),
        device="cuda", dtype=torch.bfloat16)
    labels = cfg.detection_names()
    launches = {"nms": 0, "conv": 0}

    def direct(name, **kw):
        frame = decode_image(os.path.join(FIXTURES, name))
        with torch.no_grad():
            o = detect_raw(cfg, net, torch.from_numpy(frame[None]).cuda(),
                           **kw)
        o = {k: v[0].cpu().numpy() for k, v in o.items()}
        keep = np.nonzero(o["valid"])[0]
        return _det_json(labels, o["classes"], o["scores"],
                         o["boxes"][keep].astype(np.float64), keep)

    boxes, seconds = {}, {}
    for name in names:
        out, _, wall, nms = cli_run(["predict", "--model", VARIANT,
                                     "--weights", weights, "--image",
                                     os.path.join(FIXTURES, name), "--conf",
                                     str(FIXTURE_CONF)])
        want = direct(name)
        check(cli_lines(out) == want and want, f"predict --image {name}: "
              f"the lines differ from detect_raw on the decoded array")
        check(nms == 1, f"predict --image {name}: {nms} NMS launches")
        launches["nms"] += nms
        boxes[name], seconds[name] = len(want), wall
    bmps = [n for n in names if n.endswith(".bmp")]
    with tempfile.TemporaryDirectory() as tmp, \
            tempfile.TemporaryDirectory() as written:
        for n in bmps:
            os.symlink(os.path.join(FIXTURES, n), os.path.join(tmp, n))
        out, _, _, nms = cli_run(["detect", "--model", VARIANT, "--weights",
                                  weights, "--images", tmp, "--batch", "1",
                                  "--conf", str(FIXTURE_CONF),
                                  "--output-dir", written])
        check(sorted(os.listdir(written)) == bmps and all(
            decode_image(os.path.join(written, n)).shape ==
            decode_image(os.path.join(FIXTURES, n)).shape for n in bmps),
            f"detect --output-dir wrote {sorted(os.listdir(written))}")
    recs = cli_lines(out)
    check([os.path.basename(r["image"]) for r in recs] == bmps
          and nms == len(bmps) and all(r["detections"] == direct(n)
                                       for r, n in zip(recs, bmps)),
          f"detect --images over the BMPs: {len(recs)} lines, {nms} NMS "
          f"launches, want {len(bmps)} equal to detect_raw")
    launches["nms"] += nms
    cuda_route = {}
    for name in ("tiff_lzw_pred_31x45.tif", "webp_lossless_37x53.webp"):
        nms_kernel.launches = conv_kernel.launches = 0
        got = direct(name, conv_impl="cuda")
        check(got and (nms_kernel.launches, conv_kernel.launches)
              == (1, ROUTE_CONVS), f"{name} on conv_impl=cuda: {len(got)} "
              f"boxes, (NMS, conv) launches ({nms_kernel.launches}, "
              f"{conv_kernel.launches})")
        launches["nms"] += nms_kernel.launches
        launches["conv"] += conv_kernel.launches
        cuda_route[name] = len(got)
    model = yolo_tpu_torch.load(weights, VARIANT, device="cuda",
                                conf_threshold=FIXTURE_CONF)
    server = DetectionServer(model.cfg, model.params, port=0,
                             conf_threshold=FIXTURE_CONF)
    server.start()
    try:
        served = 0
        for name in names:
            with open(os.path.join(FIXTURES, name), "rb") as f:
                body = f.read()
            nms_kernel.launches = 0
            answer = post_body(server.port, body, "application/octet-stream")
            served += nms_kernel.launches     # the direct call's apart
            want = detections_to_json(
                model(decode_image_bytes(body)[None]), labels)[0]
            check(answer == want and answer, f"POST /detect {name}: the "
                  f"answer differs from a direct call")
    finally:
        server.stop()
    check(served == len(names), f"POST /detect: {served} NMS launches for "
          f"{len(names)} bodies")
    launches["nms"] += served
    written = predict_outputs(weights, cfg, net, labels)
    launches["nms"] += len(PREDICT_FORMATS)
    emit({"phase": "images", "check": "formats_to_boxes",
          "files": len(names), "boxes": boxes, "conf": FIXTURE_CONF,
          "predict_seconds": seconds, "bmps_through_detect": len(bmps),
          "conv_route_boxes": cuda_route, "served_nms_launches": served,
          "written_formats": written,
          "launches": launches, "lines_equal_detect_raw": True,
          "answers_equal_direct": True, "card": card})
    return launches


def read_written(path: str, shape) -> np.ndarray:
    """A file save_image wrote, read back by the port; a PAM (cv2's has no
    TUPLTYPE, which the port's reader refuses) by its B, G, R samples."""
    if not path.endswith(".pam"):
        return decode_image(path)
    with open(path, "rb") as f:
        body = f.read().split(b"ENDHDR\n", 1)[1]
    return np.frombuffer(body, np.uint8).reshape(shape)[..., ::-1]


def pinned_frame(fmt: str) -> tuple:
    """A writer's pinned frame and its record (the bytes and sha256 of
    cv2.imwrite's file of it): "jp2", the JPEG 2000 writer's cut frame,
    or "gif"."""
    with open(os.path.join(FIXTURES, WRITTEN_HASHES)) as f:
        pin = json.load(f)[fmt]
    return gradient_frame(*pin["shape"], pin["noise"], pin["seed"]), pin


def check_pinned(fmt: str, encode) -> int:
    """encode's bytes of fmt's pinned frame have cv2's hash; returns
    their length."""
    frame, pin = pinned_frame(fmt)
    data = encode(frame)
    digest = hashlib.sha256(data).hexdigest()
    check(digest == pin["sha256"] and len(data) == pin["bytes"],
          f"the pinned {fmt} frame: {len(data)} bytes, sha256 {digest}; "
          f"cv2 wrote {pin['bytes']}, {pin['sha256']}")
    return len(data)


def gif_read_back(path: str, frame: np.ndarray) -> bool:
    """A GIF save_image wrote of frame: its bytes are encode_gif's, and
    the port reads it back to palette colours, not to the frame itself
    (the palette is 3-3-2), each channel on average within half a level's
    step of the frame's (the diffusion's noise; near-white areas carry
    their error on without bound, as cv2's do, so no pixel bound)."""
    with open(path, "rb") as f:
        data = f.read()
    got = decode_image(path)
    return (data == encode_gif(frame) and got.shape == frame.shape
            and np.isin(got.reshape(-1, 3).view("V3"),
                        PALETTE.view("V3")).all()
            and (np.abs(got.astype(int) - frame).mean((0, 1))
                 < [18, 18, 42.5]).all()
            and not np.array_equal(got, frame))


def predict_outputs(weights: str, cfg, net, labels) -> dict:
    """Phase 14 (b): `predict --image <480x640 frame> --output Y` for Y of
    PREDICT_FORMATS (the TIFF fixture frame for .tif and .jp2, the
    lossless WebP one for .webp): one NMS launch each, and Y, read back
    by the port, equals draw_detections of the boxes make_detector gives
    that frame on the same net (the command's path; .jp2 at JP2_CONF,
    where the annotated frame fits whole, and its bytes encode_jp2's of
    that frame; .gif, lossy, has encode_gif's bytes of that frame and
    reads back to its palette colours: gif_read_back); the last
    annotated frame saved as each of SAVED_FORMATS reads back alike (HDR
    and .pic within 2 levels: its RGBE keeps value / 255); the JPEG 2000
    writer's cut frame and the GIF writer's gradient frame have the
    hashes of cv2's files. Returns {format: bytes written}."""
    from yolo_tpu_torch.utils.viz import draw_detections

    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        for ext in PREDICT_FORMATS:
            src = os.path.join(FIXTURES, WEBP_LOSSLESS_FRAME
                               if ext == ".webp" else TIFF_FRAME)
            dst = os.path.join(tmp, "annotated" + ext)
            conf = JP2_CONF if ext == ".jp2" else FIXTURE_CONF
            text, _, _, nms = cli_run(["predict", "--model", VARIANT,
                                       "--weights", weights, "--image", src,
                                       "--conf", str(conf), "--output", dst])
            frame = decode_image(src)
            with torch.no_grad():
                o = make_detector(cfg, conf_threshold=conf)(
                    net, torch.from_numpy(frame[None]).cuda())
            o = {k: v[0].cpu().numpy() for k, v in o.items()}
            want = draw_detections(frame, o["boxes"], o["scores"],
                                   o["classes"], labels, o["valid"])
            check(nms == 1 and len(cli_lines(text)) == int(o["valid"].sum())
                  and (gif_read_back(dst, want) if ext == ".gif" else
                       np.array_equal(decode_image(dst), want)),
                  f"predict --output {ext}: {nms} NMS launches; the file "
                  f"is not draw_detections of the frame's boxes")
            if ext == ".jp2":
                with open(dst, "rb") as f:
                    check(f.read() == encode_jp2(want), "predict --output "
                          ".jp2: not save_image's bytes of that frame")
                out["jp2_boxes"] = int(o["valid"].sum())
            out[ext] = os.path.getsize(dst)
        for ext in SAVED_FORMATS:
            dst = os.path.join(tmp, "annotated" + ext)
            save_image(dst, want)
            diff = np.abs(read_written(dst, want.shape).astype(int) -
                          want.astype(int)).max()
            check(diff <= (2 if ext in (".hdr", ".pic") else 0),
                  f"save_image {ext}: read back {diff} levels from the "
                  f"annotated frame")
            out[ext] = os.path.getsize(dst)
    out["jp2_cut_pinned"] = check_pinned("jp2", encode_jp2)
    out["gif_pinned"] = check_pinned("gif", encode_gif)
    return out


def host_ms(fn, reps: int = 20) -> float:
    """Median ms of fn on a pipeline worker thread (one torch thread)."""
    def timed():
        fn()
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(times)

    with _Pool(1) as pool:
        return pool.submit(timed).result()


def decode_rates(path: str) -> tuple:
    """(ms an image on one pipeline thread, {threads: img/s}) of
    decode_image on one file."""
    one = host_ms(lambda: decode_image(path))
    rates = {}
    for n in IMAGE_THREADS:
        with cf.ThreadPoolExecutor(n) as pool:
            list(pool.map(decode_image, [path] * n))
            t0 = time.perf_counter()
            list(pool.map(decode_image, [path] * IMAGE_DECODES))
            rates[n] = IMAGE_DECODES / (time.perf_counter() - t0)
    return one, rates


def phase_decode_rates(card: str) -> dict:
    """Phase 14 (c): a 480x640 4:2:0 q90 JPEG and the 480x640
    progressive fixture decoded on one thread and on thread pools,
    beside the host letterbox of a frame to 416; a 24-bit BMP of the
    same frame (the port's own writer), the LZW TIFF, q80 WebP, GIF,
    HDR and JPEG 2000 (9/7 and 5/3) fixtures and a lossless WebP
    likewise; the TIFF, lossless WebP and GIF writers' ms a frame on one
    thread, and the JPEG 2000 writer's on a frame that fits whole (the
    TIFF fixture's) and on one its rate allocation cuts (the pinned
    noisy gradient); a 480x640 Paeth PNG's unfilter in C and in
    Python."""
    img, _ = coco_scene(np.random.default_rng(SEED + 14), *SRC_HW)
    cores = os.cpu_count()
    progressive = os.path.join(FIXTURES, PROGRESSIVE_FRAME)
    check(decode_image(progressive).shape == (*SRC_HW, 3),
          f"{PROGRESSIVE_FRAME} is not a 480x640 frame")
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "scene.jpg")
        with open(path, "wb") as f:
            f.write(encode_jpeg(img, 90, "420"))
        one, rates = decode_rates(path)
        prog_one, prog_rates = decode_rates(progressive)
        formats = {}
        bmp = os.path.join(tmp, "scene.bmp")
        save_image(bmp, img)
        check(np.array_equal(decode_image(bmp), img),
              "the 24-bit BMP does not read back")
        for what, fpath in (("bmp24", bmp),
                            ("tiff_lzw", os.path.join(FIXTURES, TIFF_FRAME)),
                            ("webp_q80", os.path.join(FIXTURES, WEBP_FRAME)),
                            ("webp_lossless", os.path.join(
                                FIXTURES, WEBP_LOSSLESS_FRAME)),
                            ("gif", os.path.join(FIXTURES, GIF_FRAME)),
                            ("hdr_rle", os.path.join(FIXTURES, HDR_FRAME)),
                            ("jp2_97", os.path.join(FIXTURES, JP2_FRAME)),
                            ("jp2_53_lossless", os.path.join(
                                FIXTURES, JP2_LOSSLESS_FRAME))):
            check(decode_image(fpath).shape == (*SRC_HW, 3),
                  f"{what}: not a 480x640 frame")
            f_one, f_rates = decode_rates(fpath)
            formats[what] = {"ms_one_thread": f_one,
                             "img_per_s": {str(n): r
                                           for n, r in f_rates.items()}}
        letterbox_ms = host_ms(lambda: _host_resize(img, (416, 416),
                                                    "letterbox"))
        encode = {}
        for what, fn in (("tiff_lzw", encode_tiff),
                         ("webp_lossless", encode_webp)):
            data = fn(img)
            check(np.array_equal(decode_image_bytes(data), img),
                  f"the {what} writer's frame does not read back")
            encode[what] = {"ms_one_thread": host_ms(lambda: fn(img), 5),
                            "bytes": len(data)}
        data = encode_gif(img)
        check(decode_image_bytes(data).shape == img.shape,
              "the GIF writer's frame does not read back")
        encode["gif"] = {"ms_one_thread": host_ms(lambda: encode_gif(img), 5),
                         "bytes": len(data)}
        whole = decode_image(os.path.join(FIXTURES, TIFF_FRAME))
        for what, frame in (("jp2_fits_whole", whole),
                            ("jp2_cut", pinned_frame("jp2")[0])):
            data = encode_jp2(frame)
            lossless = np.array_equal(decode_image_bytes(data), frame)
            check(lossless == (what == "jp2_fits_whole"),
                  f"{what}: the JPEG 2000 file reads back "
                  f"{'exactly' if lossless else 'cut'}")
            encode[what] = {"ms_one_thread":
                            host_ms(lambda: encode_jp2(frame), 5),
                            "bytes": len(data)}
        png = encode_png(img, filters=(4,))
    raw = zlib.decompress(b"".join(
        png[i + 8:i + 8 + int.from_bytes(png[i:i + 4], "big")]
        for i in range(len(SIGNATURE), len(png) - 12)
        if png[i + 4:i + 8] == b"IDAT"))
    h, stride = SRC_HW[0], SRC_HW[1] * 3
    t0 = time.perf_counter()
    c_rows = unfilter(raw, h, stride, 3)
    c_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    py_rows = unfilter_plain(raw, h, stride, 3)
    py_ms = (time.perf_counter() - t0) * 1e3
    check(np.array_equal(c_rows, py_rows) and np.array_equal(
        c_rows.reshape(*SRC_HW, 3), img), "the Paeth PNG's rows differ")
    out = {"jpeg_ms_one_thread": one,
           "host_letterbox_416_ms_one_thread": letterbox_ms,
           "jpeg_img_per_s": {str(n): r for n, r in rates.items()},
           "progressive_jpeg": PROGRESSIVE_FRAME,
           "progressive_ms_one_thread": prog_one,
           "progressive_img_per_s": {str(n): r
                                     for n, r in prog_rates.items()},
           "formats": formats, "encode": encode,
           "host_cores": cores, "paeth_png_unfilter_c_ms": c_ms,
           "paeth_png_unfilter_python_ms": py_ms}
    emit({"phase": "images", "check": "decode_rates", "src_hw":
          list(SRC_HW), "jpeg": "4:2:0 q90", **out, "card": card})
    if cores >= 4:
        for what, r in (("baseline", rates), ("progressive", prog_rates),
                        *((k, {int(n): v for n, v in
                               formats[k]["img_per_s"].items()})
                          for k in ("jp2_97", "jp2_53_lossless"))):
            check(r[8] >= 2 * r[1], f"8 {what} decode threads reach "
                  f"{r[8]:.1f} img/s against {r[1]:.1f} on one: the "
                  f"decoder holds the interpreter lock")
    return out


def coco_cells(dets, gt, cfg) -> dict:
    cells = evaluate_coco(dets, gt, cfg.num_classes)
    return {k: v for k, v in cells.items() if k != "ap"}


def check_cells(a: dict, b: dict, what: str) -> None:
    bad = {k: (a[k], b[k]) for k in a
           if abs(a[k] - b[k]) > COCO_REL * abs(b[k])}
    check(not bad, f"{what}: COCO cells differ beyond a relative "
          f"{COCO_REL}: {bad}")


def pseudo_ground_truth(dets: dict, seed: int) -> dict:
    """Ground truth made from one run's detections, so that two runs'
    COCO cells can be compared where the seeded detector finds none of
    the scenes' objects (every cell 0): each image's PSEUDO_GT highest
    detections, corners moved by up to PSEUDO_JITTER of the box's side
    (IoUs across COCO's thresholds), a tenth marked crowd, areas at
    0.5-1 of the box's (all three area ranges)."""
    rng = np.random.default_rng(seed)
    gt = {}
    for img_id, d in sorted(dets.items()):
        top = sorted(d, key=lambda x: -x[1])[:PSEUDO_GT]
        boxes = np.array([b for _, _, *b in top], np.float64).reshape(-1, 4)
        side = np.tile(boxes[:, 2:] - boxes[:, :2], 2)
        boxes = boxes + rng.uniform(-PSEUDO_JITTER, PSEUDO_JITTER,
                                    boxes.shape) * side
        boxes[:, 2:] = np.maximum(boxes[:, 2:], boxes[:, :2] + 1)
        gt[img_id] = {
            "boxes": boxes, "classes": np.array([c for c, *_ in top]),
            "difficult": (rng.uniform(size=len(top)) < 0.1).astype(int),
            "areas": np.prod(boxes[:, 2:] - boxes[:, :2], -1)
            * rng.uniform(0.5, 1.0, len(top))}
    return gt


def check_both_ways(a: dict, b: dict, what: str) -> dict:
    """Phase 11's rule: every detection scoring >= EVAL_CONF + MARGIN of
    each run has a same-class partner in the other (VOC IoU >=
    MATCH_IOU)."""
    out = {}
    for name, (x, y) in (("a_in_b", (a, b)), ("b_in_a", (b, a))):
        hit, tot = agreement(x, y, EVAL_CONF)
        out[name] = [hit, tot]
        check(tot > 0 and hit == tot, f"{what} {name}: {hit}/{tot} "
              f"detections >= {EVAL_CONF + MARGIN} matched")
    return out


def files_to_boxes(cfg, net, paths, route: str, card: str) -> tuple:
    """Phase 14 (d): JPEG files -> inference_batches -> DevicePrefetcher
    -> make_detector_preprocessed at COCO_BATCH, beside the same frames
    fed from the card's memory and the host pipeline alone. Returns the
    (NMS, conv) kernel launches of the pass from files."""
    det = make_detector_preprocessed(cfg, conv_impl=route)

    def host():
        return inference_batches(paths, COCO_BATCH, net_size=cfg.input_hw,
                                 workers=PIPELINE_WORKERS)

    t0 = time.perf_counter()
    host_batches_ = list(host())
    host_s = time.perf_counter() - t0
    frames_ = [torch.from_numpy(b["images"]).cuda() for b in host_batches_]
    det(net, frames_[0])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for x in frames_:
        out = det(net, x)
    torch.cuda.synchronize()
    memory_s = time.perf_counter() - t0
    check(bool(torch.isfinite(out["boxes"]).all()), f"{route}: bad boxes")
    nms_kernel.launches = conv_kernel.launches = 0
    t0 = time.perf_counter()
    n = 0
    with DevicePrefetcher(host(), depth=2) as staged:
        for b in staged:
            out = det(net, b["images"])
            n += len(b["paths"])
    torch.cuda.synchronize()
    files_s = time.perf_counter() - t0
    launches = (nms_kernel.launches, conv_kernel.launches)
    check(n == len(paths), f"{route}: {n} of {len(paths)} files detected")
    emit({"phase": "images", "check": "files_to_boxes", "model": cfg.name,
          "route": f"conv_impl={route}", "precision": "bf16",
          "batch": COCO_BATCH, "images": n,
          "files_img_per_s": n / files_s,
          "memory_img_per_s": n / memory_s,
          "host_pipeline_img_per_s": n / host_s,
          "pipeline_workers": PIPELINE_WORKERS,
          "host_cores": os.cpu_count(), "card": card})
    return launches


def phase_coco(card: str, root: str) -> tuple:
    """Phase 14 (d)-(e): yolov3 @416 on COCO-format JPEG scenes written
    under root (phase 16 reads them again), scored by evaluate_coco;
    returns ({kernel: launches}, COCO eval-grid suppress times, the
    grid's shape, {"json", "paths", "cells", "detections"} of the
    conv_impl="torch" fp32 eval)."""
    cfg = get_variant(COCO_VARIANT)
    check(cfg.input_hw == (416, 416) and cfg.num_classes == 80,
          f"unexpected config {cfg.name}")
    params = dw.synthetic_detector_params(cfg, SEED)
    folded = fold_params(cfg.layers, params, cfg.bn_eps)
    n_batches = -(-COCO_SCENES // COCO_BATCH)
    launches = {"nms": 0, "conv": 0}
    os.makedirs(root)
    with contextlib.nullcontext(root) as tmp:
        t0 = time.perf_counter()
        sizes = [COCO_SIZES[i % len(COCO_SIZES)] for i in range(COCO_SCENES)]
        json_path = write_coco_scenes(tmp, sizes, SEED + 14)
        write_s = time.perf_counter() - t0
        samples = load_coco(json_path, cfg.class_names, tmp)
        gt, _ = build_ground_truth(samples, cfg.class_names)
        check(len(samples) == COCO_SCENES
              and all("areas" in g for g in gt.values()),
              "load_coco -> build_ground_truth lost images or areas")
        collect_detections(cfg, folded, samples[:COCO_BATCH],
                           batch=COCO_BATCH)
        torch.cuda.synchronize()   # warm: cuDNN's algorithm choice

        got = []
        kernel = nms_kernel.suppress

        def capture(geom, scores, classes, *, conf_threshold,
                    iou_threshold):
            if not got:
                got.append((geom.clone(), scores.clone(), classes.clone(),
                            conf_threshold, iou_threshold))
            return kernel(geom, scores, classes,
                          conf_threshold=conf_threshold,
                          iou_threshold=iou_threshold)

        routes = {}
        for route in ("torch", "cuda"):
            nms_kernel.launches = conv_kernel.launches = 0
            nms_kernel.suppress = capture
            try:
                t0 = time.perf_counter()
                dets = collect_detections(cfg, folded, samples,
                                          batch=COCO_BATCH, conv_impl=route)
                wall = time.perf_counter() - t0
            finally:
                nms_kernel.suppress = kernel
            want_conv = YOLO_KERNEL_CONVS[COCO_VARIANT] * n_batches \
                if route == "cuda" else 0
            check((nms_kernel.launches, conv_kernel.launches)
                  == (n_batches, want_conv),
                  f"COCO eval conv_impl={route}: (NMS, conv) launches "
                  f"{(nms_kernel.launches, conv_kernel.launches)}, want "
                  f"{(n_batches, want_conv)}")
            launches["nms"] += nms_kernel.launches
            launches["conv"] += conv_kernel.launches
            routes[route] = (dets, coco_cells(dets, gt, cfg), wall)
        dets, cells, wall = routes["torch"]
        n_dets = sum(len(d) for d in dets.values())
        check(n_dets > 0 and all(np.isfinite(v) for v in cells.values()),
              f"COCO eval: {n_dets} detections, cells {cells}")
        # the two routes over every scene: the rate of phases 8 and 12
        routes_agree = {}
        for name, (x, y) in (("cuda_in_torch", ("cuda", "torch")),
                             ("torch_in_cuda", ("torch", "cuda"))):
            hit, tot = agreement(routes[x][0], routes[y][0], EVAL_CONF)
            routes_agree[name] = [hit, tot]
            check(tot > 0 and hit >= MIN_MATCH * tot, f"COCO eval routes "
                  f"{name}: {hit}/{tot} detections matched")

        sub = samples[:COCO_CPU_SCENES]
        gt8, _ = build_ground_truth(sub, cfg.class_names)
        nms_kernel.launches = 0
        on = {dev: collect_detections(cfg, folded, sub,
                                      batch=COCO_CPU_SCENES, device=dev)
              for dev in ("cuda", "cpu")}
        launches["nms"] += nms_kernel.launches
        cpu_agree = check_both_ways(on["cuda"], on["cpu"],
                                    "COCO eval card vs CPU")
        cells8 = {dev: coco_cells(d, gt8, cfg) for dev, d in on.items()}
        check_cells(cells8["cuda"], cells8["cpu"], "COCO eval card vs CPU")
        pseudo = pseudo_ground_truth(on["cpu"], SEED + 14)
        cells_pseudo = {dev: coco_cells(d, pseudo, cfg)
                        for dev, d in on.items()}
        check(all(0 < cells_pseudo["cpu"][k] < 1
                  for k in ("map", "map50", "map75", "ar1", "ar")),
              f"pseudo ground truth cells {cells_pseudo['cpu']}")
        check_cells(cells_pseudo["cuda"], cells_pseudo["cpu"],
                    "COCO eval card vs CPU, pseudo ground truth")
        emit({"phase": "images", "check": "coco_eval", "model": cfg.name,
              "input_hw": list(cfg.input_hw), "scenes": COCO_SCENES,
              "batch": COCO_BATCH, "eval_conf": EVAL_CONF,
              "write_scenes_s": write_s, "detections": n_dets,
              "cells": cells, "eval_img_per_s": COCO_SCENES / wall,
              "conv_impl_cuda": {"cells": routes["cuda"][1],
                                 "eval_img_per_s":
                                 COCO_SCENES / routes["cuda"][2],
                                 "agreement": routes_agree},
              "card_vs_cpu": {"scenes": COCO_CPU_SCENES,
                              "agreement": cpu_agree, "cells": cells8,
                              "cells_pseudo_ground_truth": cells_pseudo},
              "decoder": get_decoder(), "card": card})

        geom, scores, classes, conf, iou = got[0]
        grid = list(geom.shape)
        check(grid[0] == COCO_BATCH * cfg.num_classes and conf == EVAL_CONF,
              f"COCO eval grid {grid} at conf {conf}")
        timed = time_suppress("suppress_coco_eval_grid", geom, scores,
                              classes, conf, iou, card, batch=COCO_BATCH)

        paths = [p for p, _ in samples]
        net = Darknet(cfg.layers, folded, device="cuda",
                      dtype=torch.bfloat16)
        for route in ("torch", "cuda"):
            got_nms, got_conv = files_to_boxes(cfg, net, paths, route, card)
            want_conv = YOLO_KERNEL_CONVS[COCO_VARIANT] * n_batches \
                if route == "cuda" else 0
            check((got_nms, got_conv) == (n_batches, want_conv),
                  f"files -> boxes conv_impl={route}: (NMS, conv) launches "
                  f"{(got_nms, got_conv)}, want {(n_batches, want_conv)}")
            launches["nms"] += got_nms
            launches["conv"] += got_conv
        del net

        weights = os.path.join(tmp, f"{COCO_VARIANT}-seed.weights")
        dw.save(weights, cfg.layers, params)
        model = yolo_tpu_torch.load(weights, device="cuda")
        bodies = []
        for p in paths[:HTTP_BODIES]:
            with open(p, "rb") as f:
                bodies.append(f.read())
        server = DetectionServer(cfg, model.params, port=0, max_batch=32)
        server.start()
        try:
            nms_kernel.launches = 0
            answers = [post_body(server.port, b, "image/jpeg")
                       for b in bodies]
            launches["nms"] += nms_kernel.launches
            stats = dict(server.stats)
        finally:
            server.stop()
        check(stats["errors"] == 0, f"server errors: {stats}")
        names = cfg.detection_names()
        for i, body in enumerate(bodies):
            direct = detections_to_json(
                model(decode_image_bytes(body)[None]), names)[0]
            check(answers[i] == direct, f"JPEG body {i}: the answer differs "
                  f"from the direct call on its decoded frame")
        emit({"phase": "images", "check": "http_jpeg", "model": cfg.name,
              "requests": stats["requests"], "responses_equal_direct": True,
              "detections_per_image": [len(a) for a in answers]})
    return launches, timed, grid, {"json": json_path, "paths": paths,
                                   "cells": cells, "detections": n_dets}


def csp_swish_heads(base: str, hw) -> ModelConfig:
    """Phase 15 (b): base's topology with the head conventions of
    AlexeyAB's yolov4-csp-swish.cfg: swish where base has mish, a
    logistic conv before each [yolo], new_coords=1 and scale_x_y=2.0 on
    each head, at [net] (height, width) hw."""
    cfg = get_variant(base)
    head_convs = {i - 1 for i, l in enumerate(cfg.layers)
                  if isinstance(l, YoloHead)}
    layers = []
    for i, l in enumerate(cfg.layers):
        if isinstance(l, Conv) and l.act == "mish":
            l = dataclasses.replace(l, act="swish")
        if i in head_convs:
            l = dataclasses.replace(l, act="logistic")
        if isinstance(l, YoloHead):
            l = dataclasses.replace(l, new_coords=True, scale_xy=2.0)
        layers.append(l)
    return dataclasses.replace(
        cfg, name=f"{base}-topology-csp-swish-heads",
        layers=tuple(layers)).with_input_hw(*hw)


def gaussian_heads(base: str) -> ModelConfig:
    """Phase 15 (c): base with [Gaussian_yolo] heads, 9+C channels an
    anchor (yolov3 COCO-80: 3 * (9 + 80) = 267 filters a head conv)."""
    cfg = get_variant(base)
    return dataclasses.replace(cfg, name=f"gaussian-{base}",
                               layers=with_head_kind(cfg, gaussian=True))


def with_head_kind(cfg, *, gaussian=None, classes=None) -> tuple:
    """cfg's layers with each [yolo] head (and its conv's filters) made
    Gaussian or classic, and sized for ``classes`` classes (default
    cfg's)."""
    c = cfg.num_classes if classes is None else classes
    layers = list(cfg.layers)
    for i, l in enumerate(layers):
        if isinstance(l, YoloHead):
            ga = l.gaussian if gaussian is None else gaussian
            layers[i] = dataclasses.replace(l, gaussian=ga)
            layers[i - 1] = dataclasses.replace(
                layers[i - 1], filters=len(l.mask) * ((9 if ga else 5) + c))
    return tuple(layers)


def voc_heads(cfg) -> ModelConfig:
    """cfg with 20-class heads and the VOC names, for phase 15 (e)."""
    return dataclasses.replace(cfg, name=f"{cfg.name}-voc",
                               layers=with_head_kind(cfg, classes=20),
                               class_names=VOC_NAMES)


def every_option() -> ModelConfig:
    """Phase 15 (d): every remaining option of a custom .cfg in one net
    at 416 of reduced depth, COCO-80 heads at strides 32 and 16: grouped
    and depthwise convs, a dilated conv (CIN = CO = 128, leaky: the gate
    keeps it off the conv kernel), weighted shortcuts (per_feature/relu,
    per_channel/softmax), [sam], an SE block ([avgpool] -> 1x1 convs ->
    [scale_channels]), relu and ramp; convs 12, 13 and 19 take the conv
    kernel's route."""
    yolo = get_variant("yolov3")
    layers = (
        Conv(32), MaxPool(2, 2), Conv(64, stride=2),              # 0-2 /4
        Conv(64, groups=2, act="relu"),                           # 3
        Conv(64, groups=64, act="ramp"),                          # 4
        Shortcut(-3, weights_type="per_feature", weights_norm="relu"),
        Conv(128, stride=2),                                      # 6 /8
        Conv(128, dilation=2),                                    # 7
        Shortcut(-2, weights_type="per_channel", weights_norm="softmax"),
        Conv(128, 1, act="logistic"), Sam(-2),                    # 9-10
        Conv(256, stride=2),                                      # 11 /16
        Conv(128, 1), Conv(256),                                  # 12-13
        AvgPool(), Conv(32, 1, act="relu"),                       # 14-15
        Conv(256, 1, act="logistic"), ScaleChannels(-4),          # 16-17
        Conv(512, stride=2), Conv(256, 1),                        # 18-19 /32
        Conv(3 * 85, 1, bn=False, act="linear"),
        YoloHead((6, 7, 8)),                                      # 20-21
        Route((17,)), Conv(3 * 85, 1, bn=False, act="linear"),
        YoloHead((3, 4, 5)))                                      # 22-24 /16
    return ModelConfig(name="every-option-416", layers=layers,
                       anchors=yolo.anchors, class_names=yolo.class_names,
                       input_size=416)


def write_cfg(root: str, cfg, net_keys: str = "") -> tuple:
    """cfg_to_string(cfg), with net_keys added to its [net] section, and
    cfg's names as darknet .cfg / .names files under root -> (cfg path,
    names path)."""
    path = os.path.join(root, f"{cfg.name}.cfg")
    text = cfg_to_string(cfg)
    with open(path, "w") as f:
        f.write(text.replace("[net]\n", "[net]\n" + net_keys, 1))
    names = os.path.join(root, f"{cfg.name}.names")
    with open(names, "w") as f:
        f.write("\n".join(cfg.class_names) + "\n")
    return path, names


def same_config(parsed, cfg) -> bool:
    """The parsed config is cfg's, up to its name and, where the loss is
    mse, iou_normalizer: cfg_to_string omits iou_normalizer=1 and the
    parser defaults it to 0.75, as the JAX package's do; the mse loss
    never reads it (ROADMAP C5)."""
    parsed = dataclasses.replace(parsed, name=cfg.name)
    if cfg.iou_loss == "mse":
        parsed = dataclasses.replace(parsed,
                                     iou_normalizer=cfg.iou_normalizer)
    return parsed == cfg


def phase_cfg_round_trip(root: str, seeded: dict) -> dict:
    """Phase 15 (a): cfg_to_string of each CFG_ROUND_TRIP variant at its
    published size, written to a file and loaded by
    yolo_tpu_torch.load(weights, cfg=..., names=...) on the seeded
    .weights of phases 4 and 12: the config is get_variant's, and on raw
    frames its detections equal the built-in variant's (torch.equal),
    bf16 and fp32, on the default route and on conv_impl="cuda". Returns
    the kernel launches."""
    launches = {"conv": 0, "nms": 0}
    images = frames(SEED + 15, CFG_IMAGES)
    for variant in CFG_ROUND_TRIP:
        cfg = get_variant(variant)
        path, names = write_cfg(root, cfg)
        rows = []
        for precision in ("bf16", "fp32"):
            built = yolo_tpu_torch.load(seeded[variant], variant,
                                        device="cuda", precision=precision)
            parsed = yolo_tpu_torch.load(seeded[variant], cfg=path,
                                         names=names, device="cuda",
                                         precision=precision)
            check(same_config(parsed.cfg, cfg), f"{path} parses to "
                  f"{parsed.cfg}, not {cfg}")
            for route in ("torch", "cuda"):
                conv_kernel.launches = nms_kernel.launches = 0
                want = detect_raw(cfg, built.params, images, conv_impl=route)
                got = detect_raw(parsed.cfg, parsed.params, images,
                                 conv_impl=route)
                torch.cuda.synchronize()
                launches["conv"] += conv_kernel.launches
                launches["nms"] += nms_kernel.launches
                equal = all(torch.equal(got[k], want[k]) for k in want)
                check(equal, f"{variant} {precision} conv_impl={route}: "
                      f"load(cfg=...) detections differ from the "
                      f"built-in variant's")
                rows.append({"precision": precision, "conv_impl": route,
                             "equal": equal, "conv_launches":
                             conv_kernel.launches,
                             "detections": int(got["valid"].sum())})
            del built, parsed
        emit({"phase": "cfg", "part": "a_round_trip", "model": cfg.name,
              "input_hw": list(cfg.input_hw), "cfg_bytes":
              os.path.getsize(path), "config_equal": True, "rows": rows})
    return launches


def phase_cfg_serve(root: str, cfg, launches: dict):
    """Phase 15 (b) / (c): cfg, seeded and written as .cfg / .names /
    .weights files, through yolo_tpu_torch.load(cfg=...): the routes
    (check_routes: the conv kernel's launches a forward equal
    kernel_conv_shapes' count, the swish and logistic convs off it),
    entry="fused" refused, a DetectionServer answering as direct calls.
    Returns the bf16 model."""
    path, names = write_cfg(root, cfg)
    wpath = os.path.join(root, f"{cfg.name}.weights")
    t0 = time.perf_counter()
    dw.save(wpath, cfg.layers, dw.synthetic_detector_params(cfg, SEED))
    seed_s = time.perf_counter() - t0
    model = yolo_tpu_torch.load(wpath, cfg=path, names=names, device="cuda")
    model32 = yolo_tpu_torch.load(wpath, cfg=path, names=names,
                                  device="cuda", precision="fp32")
    check(same_config(model.cfg, cfg), f"{path} parses to {model.cfg}")
    n_kernel = sum(kernel_conv_shapes(cfg).values())
    images = frames(SEED + 15, CFG_IMAGES)
    rows = check_routes(model.cfg, model, model32, images, n_kernel,
                        launches)
    fused_raises = entry_fused_raises(model.cfg, model, images)
    check(fused_raises, f"{cfg.name}: entry='fused' did not raise")
    heads = cfg.yolo_heads
    emit({"phase": "cfg", "part": "serve", "model": cfg.name,
          "input_hw": list(cfg.input_hw), "weights_bytes":
          os.path.getsize(wpath), "seed_weights_s": seed_s,
          "new_coords": [h.new_coords for h in heads],
          "gaussian": [h.gaussian for h in heads],
          "scale_x_y": [h.scale_xy for h in heads],
          "kernel_convs": n_kernel,
          "acts": sorted({l.act for l in cfg.layers if isinstance(l, Conv)}),
          "routes": rows, "entry_fused_raises": fused_raises,
          "agreement_rule": {"margin": MARGIN, "voc_iou": MATCH_IOU,
                             "min_match": MIN_MATCH}})
    check_http(model, images, launches, "cfg")
    return model


def phase_cfg_options(root: str, launches: dict) -> None:
    """Phase 15 (d): every_option() through load(cfg=...) in fp32 on the
    card and on the CPU, on the same frames: each head's logits within
    CFG_LOGIT_REL of its scale, detections agreeing at box level both
    ways (phase 12's rule); conv_impl="cuda" launches the kernel for the
    gate's convs only and agrees with the default route likewise."""
    cfg = every_option()
    path, names_path = write_cfg(root, cfg)
    wpath = os.path.join(root, f"{cfg.name}.weights")
    dw.save(wpath, cfg.layers, dw.synthetic_detector_params(cfg, SEED))
    card = yolo_tpu_torch.load(wpath, cfg=path, names=names_path, device="cuda",
                               precision="fp32")
    host = yolo_tpu_torch.load(wpath, cfg=path, names=names_path, device="cpu",
                               precision="fp32")
    check(same_config(card.cfg, cfg), f"{path} parses to {card.cfg}")
    images = frames(SEED + 16, CFG_IMAGES)
    x = torch.from_numpy(np.random.default_rng(SEED + 16).uniform(
        0, 1, (2, *cfg.input_hw, 3)).astype(np.float32))
    errs = []
    for got, want in zip(card.params(x.cuda()), host.params(x),
                         strict=True):
        err = float((got.cpu() - want).abs().max())
        scale = float(want.abs().max())
        errs.append(err / scale)
        check(err <= CFG_LOGIT_REL * scale, f"{cfg.name}: head logits "
              f"card vs CPU {err} beyond {CFG_LOGIT_REL} of {scale}")
    conv_kernel.launches = nms_kernel.launches = 0
    on_card = detect_raw(card.cfg, card.params, images)
    torch.cuda.synchronize()
    nms = nms_kernel.launches
    on_cpu = detect_raw(host.cfg, host.params, images.cpu())
    n_kernel = sum(kernel_conv_shapes(cfg).values())
    conv_kernel.launches = nms_kernel.launches = 0
    routed = detect_raw(card.cfg, card.params, images, conv_impl="cuda")
    torch.cuda.synchronize()
    n_conv, nms = conv_kernel.launches, nms + nms_kernel.launches
    check(n_conv == n_kernel == 3 and nms == 2, f"{cfg.name}: (conv, NMS) "
          f"launches {(n_conv, nms)}, want ({n_kernel}, 2)")
    launches["conv"] += n_conv
    launches["nms"] += nms
    names = cfg.detection_names()
    ref = detections_to_json(on_cpu, names)
    agree = {route: check_agree(ref, detections_to_json(out, names),
                                cfg.conf_threshold, f"{cfg.name} {route} "
                                f"vs CPU", iou=_iou_voc)
             for route, out in (("default", on_card),
                                ("conv_impl=cuda", routed))}
    emit({"phase": "cfg", "part": "d_options", "model": cfg.name,
          "input_hw": list(cfg.input_hw),
          "layers": sorted({type(l).__name__ for l in cfg.layers}),
          "acts": sorted({l.act for l in cfg.layers if isinstance(l, Conv)}),
          "logits_rel_err": errs, "logits_bound": CFG_LOGIT_REL,
          "kernel_convs": n_conv, "vs_cpu": agree,
          "detections_per_image": [len(d) for d in ref]})


def phase_cfg_train(root: str, card: str) -> None:
    """Phase 15 (e): (b) and (c) with 20-class heads on seeded synthetic
    VOC scenes, their TrainConfig from train_config_from_cfg on cfg
    files that carry yolov4.cfg's / yolov3.cfg's [net] keys: one fp32
    step, card against CPU, on a micro-batch of CHECK_BATCH seeded VOC
    scenes as phase 13 (a)'s, with the card's choices held and phase
    13 (a)'s bounds (card_vs_cpu_step, whose TF32 step must fail them;
    (b)'s update bound is CFG_STEP_BOUND, its fp32 floor); then
    CFG_TRAIN_STEPS bf16 steps at batch CFG_TRAIN_BATCH, every loss
    part finite."""
    rng = np.random.default_rng(SEED + 15)
    palette = rng.integers(0, 256, (len(VOC_NAMES), 3), dtype=np.uint8)
    scenes = os.path.join(root, "scenes")
    os.mkdir(scenes)
    pairs = write_voc_scenes(scenes, [SCENE_HW[i % len(SCENE_HW)]
                                      for i in range(CFG_TRAIN_BATCH)],
                             rng, palette=palette)
    for base, cfg in (("yolov4", voc_heads(csp_swish_heads(
            "yolov4", CFG_SCALED_HW))), ("yolov3", voc_heads(
                gaussian_heads("yolov3")))):
        path, _ = write_cfg(root, cfg, CFG_NET_KEYS[base])
        tcfg = train_config_from_cfg(path, cfg)
        subdivisions, schedule = YOLO_NETS[base]
        check(tcfg == TrainConfig(**schedule, grad_accum=subdivisions,
                                  ema_start_step=tcfg.ema_start_step,
                                  yolo_loss=yolo_loss_config(cfg),
                                  loss=region_loss_config(cfg)),
              f"{path}: train_config_from_cfg gave {tcfg}")
        tcfg = dataclasses.replace(tcfg, grad_accum=1)
        params = fine_tune_init(cfg, root, *YOLO_PARTIALS[base])
        host = next(host_batches(cfg, pairs[:CHECK_BATCH], CHECK_BATCH, SEED,
                                 shuffle=False, augment_cfg=YOLO_AUGMENT))
        card_vs_cpu_step(cfg, tcfg, params, host, "cfg", own_choices=False,
                         step_bound=CFG_STEP_BOUND[base])
        state = init_state(cfg, params, tcfg)
        step = make_train_step(cfg, tcfg, compute_dtype=torch.bfloat16)
        losses = []
        with DevicePrefetcher(host_batches(
                cfg, pairs, CFG_TRAIN_BATCH, SEED + 5, epochs=CFG_TRAIN_STEPS,
                augment_cfg=YOLO_AUGMENT), depth=2) as staged:
            for i, batch in enumerate(itertools.islice(staged,
                                                       CFG_TRAIN_STEPS)):
                losses.append(finite_metrics(step(state, batch),
                                             f"{cfg.name} bf16 step {i}"))
        check(len(losses) == CFG_TRAIN_STEPS, f"{cfg.name}: "
              f"{len(losses)} bf16 steps ran")
        emit({"phase": "cfg", "part": "e_train", "model": cfg.name,
              "input_hw": list(cfg.input_hw), "precision": "bf16",
              "batch": CFG_TRAIN_BATCH, "losses": losses, "card": card})
        del state, params


def phase_cfg_times(gen, models: dict, card: str) -> tuple:
    """Phase 15 (f): end-to-end latency (median of synchronized calls)
    of (b) and (c) at TIMED_BATCHES in bf16 on both routes; each conv
    shape of (b)'s rectangular grids at batch 1 and TIMED_BATCH, bf16
    and fp32, kernel against plain and timed (conv_shape_row), and the
    sums over (b)'s kernel convs at TIMED_BATCH. Returns (worst
    |kernel - plain|, the number of shapes, the bf16 sums)."""
    for model in models.values():
        cfg = model.cfg
        for b in TIMED_BATCHES:
            images = frames(b, b)
            for route, kw in (("default", {}),
                              ("conv_impl=cuda", {"conv_impl": "cuda"})):
                ms = cuda_median_ms(lambda: detect_raw(
                    cfg, model.params, images, **kw), reps=5)
                emit({"phase": "times", "what": "cfg_e2e_bf16",
                      "model": cfg.name, "input_hw": list(cfg.input_hw),
                      "route": route, "batch": b, "src_hw": list(SRC_HW),
                      "ms": ms, "img_per_s": b * 1000 / ms, "card": card})
    shapes = kernel_conv_shapes(models["b"].cfg)
    worst, sums = 0.0, {}
    for b in TIMED_BATCHES:
        for (h, w, cin, co, ks), n in sorted(shapes.items()):
            for dtype, name in DTYPES:
                err, row = conv_shape_row(gen, b, (h, w), cin, co, ks, dtype,
                                          card)
                worst = max(worst, err)
                emit({"phase": "cfg", "part": "f_conv", "layers": n, **row})
                total = sums.setdefault((b, name), [0.0] * 4)
                for i, key in enumerate(("kernel_ms", "plain_ms",
                                         "library_ms", "bound_ms")):
                    total[i] += n * row[key]
    for (b, name), (ms, plain_ms, library_ms, bound) in sorted(sums.items()):
        emit({"phase": "times", "what": f"conv_rect_layers_{name}",
              "model": models["b"].cfg.name, "batch": b,
              "layers": sum(shapes.values()), "kernel_ms": ms,
              "plain_ms": plain_ms, "library_ms": library_ms,
              "bound_ms": bound, "share_of_bound": bound / ms, "card": card})
    return worst, len(shapes), sums[(TIMED_BATCH, "bf16")]


def phase_cfg(gen, seeded: dict, card: str) -> dict:
    """Phase 15: darknet .cfg files on the card; returns the kernel
    launches and the conv kernel's worst |kernel - plain| and shapes."""
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as root:
        launches = phase_cfg_round_trip(root, seeded)
        models = {"b": phase_cfg_serve(root, csp_swish_heads(
                      "yolov4", CFG_SCALED_HW), launches),
                  "c": phase_cfg_serve(root, gaussian_heads("yolov3"),
                                       launches)}
        phase_cfg_options(root, launches)
        t1 = time.perf_counter()
        phase_cfg_train(root, card)
        t2 = time.perf_counter()
    worst, n_shapes, rect = phase_cfg_times(gen, models, card)
    emit({"phase": "cfg", "seconds": time.perf_counter() - t0,
          "train_seconds": t2 - t1, "launches": launches})
    return {"launches": launches, "worst": worst, "shapes": n_shapes,
            "rect_bf16": rect}


def cli_run(argv) -> tuple:
    """yolo_tpu_torch.cli.main(argv) in this process, the kernels'
    counts set to 0 just before -> (stdout, stderr, wall seconds, NMS
    launches). A command that exits with an error fails the run."""
    from yolo_tpu_torch import cli

    nms_kernel.launches = conv_kernel.launches = entry_kernel.launches = 0
    out, err = io.StringIO(), io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        cli.main(list(argv))
    torch.cuda.synchronize()
    return (out.getvalue(), err.getvalue(), time.perf_counter() - t0,
            nms_kernel.launches)


def cli_lines(text: str) -> list:
    return [json.loads(l) for l in text.strip().splitlines() if l]


def cli_detections(out: dict, names) -> list:
    """The lines `predict` prints for the first image of a detector
    output (cli/detect_cmds.py's rounding)."""
    from yolo_tpu_torch.cli.detect_cmds import _det_json

    o = {k: v[0].cpu().numpy() for k, v in out.items()}
    keep = np.nonzero(o["valid"])[0]
    return _det_json(names, o["classes"], o["scores"], o["boxes"][keep],
                     keep)


def cli_subprocess(argv, timeout: float) -> tuple:
    """python -m yolo_tpu_torch.cli argv in a new process -> (stdout,
    wall seconds from the start to its exit)."""
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "yolo_tpu_torch.cli",
                           *argv], capture_output=True, text=True,
                          timeout=timeout, cwd=REPO,
                          env=dict(os.environ, PYTHONPATH=REPO))
    check(proc.returncode == 0, f"python -m yolo_tpu_torch.cli {argv[0]} "
          f"exited {proc.returncode}: {proc.stderr[-2000:]}")
    return proc.stdout, time.perf_counter() - t0


def cli_predict(seeded: str, image: str, card: str, launches: dict) -> None:
    """(a) predict of YOLOv2-COCO and yolov3 416 on a phase-14 JPEG, bf16
    and fp32: the printed detections equal a direct load() call's, the
    annotated PNG and JPEG decode at the source's size; the wall time
    of a new process, bf16."""
    frame = decode_image(image)
    for variant, fname in CLI_PREDICT.items():
        weights = os.path.join(seeded, fname)
        for precision, ext in (("bf16", "png"), ("fp32", "jpg")):
            out_img = os.path.join(seeded, f"predict-{variant}.{ext}")
            argv = ["predict", "--model", variant, "--weights", weights,
                    "--image", image, "--precision", precision]
            out, _, wall, n = cli_run(argv + ["--output", out_img])
            model = yolo_tpu_torch.load(weights, variant, device="cuda",
                                        precision=precision)
            direct = cli_detections(model(frame[None]), model.cfg.class_names)
            got = cli_lines(out)
            check(got == direct and len(got) > 0, f"predict {variant} "
                  f"{precision}: {len(got)} printed detections differ from "
                  f"the direct call's {len(direct)}")
            check(n == 1, f"predict {variant} {precision}: {n} NMS launches")
            check(decode_image(out_img).shape == frame.shape,
                  f"predict --output {out_img} does not decode at "
                  f"{frame.shape}")
            launches["nms"] += n
            row = {"phase": "cli", "command": "predict", "model": variant,
                   "precision": precision, "detections": len(got),
                   "nms_launches": n, "seconds_in_process": wall,
                   "output": ext, "equal_direct": True, "card": card}
            if precision == "bf16":
                out, row["seconds_process"] = cli_subprocess(argv, 300)
                check(cli_lines(out) == direct, f"predict {variant} in a "
                      f"new process differs from the direct call")
            emit(row)


def detect_batches(n: int, batch: int) -> int:
    """Batches inference_batches makes of phase 14's n scenes without
    host preprocessing: each source size (COCO_SIZES, cycled) its own
    bucket."""
    sizes = collections.Counter(COCO_SIZES[i % len(COCO_SIZES)]
                                for i in range(n))
    return sum(-(-k // batch) for k in sizes.values())


def cli_first_batch(model, recs: list, host: bool) -> list:
    """What the detector gives the first COCO_BATCH images `detect`
    printed, called directly: on the raw frames (one source size, the
    card's letterbox) or through the host letterbox
    (inference_batches -> make_detector_preprocessed, un-letterboxed in
    float64 as the command does), in the command's rounding."""
    from yolo_tpu_torch.cli.detect_cmds import _det_json
    from yolo_tpu_torch.ops.letterbox import unletterbox_boxes_xyxy

    cfg, paths = model.cfg, [r["image"] for r in recs[:COCO_BATCH]]
    names = cfg.detection_names()
    if not host:
        frames_u8 = np.stack([decode_image(p) for p in paths])
        out = {k: v.cpu().numpy() for k, v in model(frames_u8).items()}
        shapes = [frames_u8.shape[1:3]] * len(paths)
    else:
        batch = next(iter(inference_batches(paths, COCO_BATCH,
                                            net_size=cfg.input_hw)))
        out = make_detector_preprocessed(cfg)(
            model.params, torch.from_numpy(batch["images"]).cuda())
        out = {k: v.cpu().numpy() for k, v in out.items()}
        shapes = batch["shapes"]
    got = []
    for bi, (src_h, src_w) in enumerate(shapes):
        keep = np.nonzero(out["valid"][bi])[0]
        boxes = out["boxes"][bi][keep].astype(np.float64)
        if host:
            boxes = unletterbox_boxes_xyxy(
                torch.from_numpy(boxes), src_h=src_h, src_w=src_w,
                net_size=cfg.input_hw).numpy()
        got.append(_det_json(names, out["classes"][bi], out["scores"][bi],
                             boxes, keep))
    return got


def cli_detect(seeded: str, coco: dict, card: str, launches: dict) -> None:
    """(b) detect --images over phase 14's JPEG set at batch COCO_BATCH,
    on the card's letterbox and --host-preprocess: the first batch's
    lines equal direct calls, one NMS launch a batch, img/s of the
    command (and without its load of the weights); then --output-dir
    and --save-labels over CLI_OUTPUT_IMAGES of them both ways."""
    weights = os.path.join(seeded, CLI_PREDICT[COCO_VARIANT])
    image_dir = os.path.dirname(coco["paths"][0])
    n = len(coco["paths"])
    t0 = time.perf_counter()
    model = yolo_tpu_torch.load(weights, COCO_VARIANT, device="cuda")
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    for mode, extra, batches in (
            ("device", [], detect_batches(n, COCO_BATCH)),
            ("host", ["--host-preprocess"], -(-n // COCO_BATCH))):
        out, _, wall, nms = cli_run(["detect", "--model", COCO_VARIANT,
                                     "--weights", weights, "--images",
                                     image_dir, "--batch", str(COCO_BATCH),
                                     *extra])
        recs = cli_lines(out)
        check(len(recs) == n and nms == batches, f"detect {mode}: {len(recs)}"
              f" images, {nms} NMS launches, want {n} and {batches}")
        direct = cli_first_batch(model, recs, mode == "host")
        check([r["detections"] for r in recs[:COCO_BATCH]] == direct,
              f"detect {mode}: the first batch's lines differ from the "
              f"direct calls")
        launches["nms"] += nms
        emit({"phase": "cli", "command": "detect", "mode": mode,
              "model": COCO_VARIANT, "images": n, "batch": COCO_BATCH,
              "img_per_s": n / wall, "seconds": wall,
              "load_seconds": load_s,
              "img_per_s_after_load": n / max(wall - load_s, 1e-9),
              "nms_launches": nms, "first_batch_equal_direct": True,
              "detections": sum(len(r["detections"]) for r in recs),
              "card": card})
    sub = os.path.join(seeded, "detect_subset")
    os.makedirs(sub)
    for p in coco["paths"][:CLI_OUTPUT_IMAGES]:
        os.symlink(p, os.path.join(sub, os.path.basename(p)))
    for mode, extra in (("device", []), ("host", ["--host-preprocess"])):
        ann = os.path.join(seeded, f"annotated-{mode}")
        out, _, wall, nms = cli_run(["detect", "--model", COCO_VARIANT,
                                     "--weights", weights, "--images", sub,
                                     "--batch", str(COCO_BATCH),
                                     "--output-dir", ann, "--save-labels",
                                     *extra])
        launches["nms"] += nms
        recs = cli_lines(out)
        written = sorted(os.listdir(ann))
        check(len(recs) == CLI_OUTPUT_IMAGES and nms > 0
              and written == sorted(os.path.basename(p) for p in
                                    coco["paths"][:CLI_OUTPUT_IMAGES]),
              f"detect --output-dir {mode}: {len(recs)} lines, "
              f"{len(written)} files, {nms} NMS launches")
        for r in recs:
            name = os.path.basename(r["image"])
            src = decode_image(r["image"])
            check(decode_image(os.path.join(ann, name)).shape == src.shape,
                  f"annotated {name} does not decode at {src.shape}")
            label = os.path.splitext(r["image"])[0] + ".txt"
            with open(label) as f:
                rows = [l for l in f.read().splitlines() if l]
            check(len(rows) == len(r["detections"]), f"--save-labels "
                  f"{label}: {len(rows)} lines for {len(r['detections'])} "
                  f"detections")
            os.remove(label)
        emit({"phase": "cli", "command": "detect", "mode": mode,
              "outputs": ["--output-dir", "--save-labels"],
              "images": CLI_OUTPUT_IMAGES, "seconds": wall,
              "nms_launches": nms, "annotated_jpegs_decode": True})


def cli_eval(seeded: str, coco: dict, card: str, launches: dict) -> None:
    """(c) eval --coco-json of phase 14's set in fp32 prints phase 14's
    cells and saves its detections; recall runs on the set."""
    weights = os.path.join(seeded, CLI_PREDICT[COCO_VARIANT])
    saved = os.path.join(seeded, "detections.json")
    out, _, wall, nms = cli_run(["eval", "--model", COCO_VARIANT,
                                 "--weights", weights, "--coco-json",
                                 coco["json"], "--metric", "coco",
                                 "--precision", "fp32", "--batch",
                                 str(COCO_BATCH), "--save-detections",
                                 saved])
    got = cli_lines(out)[-1]
    want = {k: round(v, 4) for k, v in coco["cells"].items()
            if k in got}
    batches = -(-len(coco["paths"]) // COCO_BATCH)
    with open(saved) as f:
        n_saved = len(json.load(f))
    check(all(got[k] == want[k] for k in want) and len(want) >= 12,
          f"eval --coco-json cells {got} differ from phase 14's {want}")
    check(n_saved == coco["detections"] and nms == batches,
          f"eval: {n_saved} saved detections and {nms} NMS launches, want "
          f"{coco['detections']} and {batches}")
    launches["nms"] += nms
    emit({"phase": "cli", "command": "eval", "model": COCO_VARIANT,
          "metric": "coco", "cells": {k: got[k] for k in want},
          "equal_phase_14": True, "saved_detections": n_saved,
          "img_per_s": len(coco["paths"]) / wall, "seconds": wall,
          "nms_launches": nms, "card": card})
    out, err, wall, nms = cli_run(["recall", "--model", COCO_VARIANT,
                                   "--weights", weights, "--coco-json",
                                   coco["json"], "--batch",
                                   str(COCO_BATCH)])
    res = cli_lines(out)[-1]
    lines = [l for l in err.splitlines() if "RPs/Img" in l]
    check(res["images"] == len(coco["paths"]) == len(lines)
          and res["total"] > 0 and 0 <= res["recall"] <= 1,
          f"recall: {res}, {len(lines)} per-image lines")
    emit({"phase": "cli", "command": "recall", "model": COCO_VARIANT,
          "result": res, "seconds": wall, "nms_launches": nms,
          "card": card})


def write_voc_root(root: str, n: int, seed: int) -> list:
    """n seeded synthetic JPEG scenes in a VOC tree (JPEGImages,
    Annotations, ImageSets/Main/train.txt) under root -> the pairs."""
    for d in ("JPEGImages", "Annotations", "ImageSets/Main"):
        os.makedirs(os.path.join(root, d))
    pairs = write_voc_scenes(
        os.path.join(root, "JPEGImages"),
        [SCENE_HW[i % len(SCENE_HW)] for i in range(n)],
        np.random.default_rng(seed), jpeg_quality=90)
    out = []
    for image, xml in pairs:
        moved = os.path.join(root, "Annotations", os.path.basename(xml))
        os.rename(xml, moved)
        out.append((image, moved))
    with open(os.path.join(root, "ImageSets/Main/train.txt"), "w") as f:
        f.write("\n".join(os.path.splitext(os.path.basename(p))[0]
                          for p, _ in pairs) + "\n")
    return out


def cli_train(seeded: str, card: str) -> None:
    """(d) train YOLOv2-VOC 416 from the seeded partial file through the
    command line: CLI_TRAIN_STEPS bf16 steps (one a 64-scene epoch) with
    a checkpoint each, then --resume from step CLI_RESUME_STEP with
    --epochs 1: as the JAX command's threads loader, the resumed run
    trains the data again from the first epoch, so it ends at step
    CLI_RESUME_STEP + 1 in the state of one library step (state_from_tree
    of the checkpoint, make_train_step on the first batch of a fresh
    generator of the run's seed) within phase 10's bounds (cuDNN's
    backward is not bit-reproducible); export to .weights, and load() of
    that file serves."""
    cfg = get_variant(TRAIN_VARIANT)
    root = os.path.join(seeded, "voc")
    t0 = time.perf_counter()
    write_voc_root(root, CLI_TRAIN_SCENES, SEED + 16)
    backbone = write_backbone(cfg, seeded)
    data_s = time.perf_counter() - t0

    def argv(epochs: int) -> list:
        return ["train", "--model", TRAIN_VARIANT, "--weights", backbone,
                "--voc-root", root, "--split", "train", "--batch",
                str(TRAIN_BATCH), "--grad-accum", str(SUBDIVISIONS), "--lr",
                "0.001", "--burn-in", "1000", "--epochs", str(epochs),
                "--no-augment", "--checkpoint-every", "1"]
    full, resumed = (os.path.join(seeded, d) for d in ("ck", "ck_resumed"))
    log = os.path.join(seeded, "train.jsonl")
    _, err, wall, _ = cli_run(argv(CLI_TRAIN_STEPS) + [
        "--checkpoint-dir", full, "--log-file", log])
    check(sorted(os.listdir(full)) == ["final"] + [
        f"step_{i}" for i in range(1, CLI_TRAIN_STEPS + 1)],
        f"train checkpoints {sorted(os.listdir(full))}")
    with open(log) as f:
        rates = [r["img_s"] for r in map(json.loads, f)]
    start = os.path.join(full, f"step_{CLI_RESUME_STEP}")
    _, err_r, wall_r, _ = cli_run(argv(1) + ["--checkpoint-dir", resumed,
                                             "--resume", start])
    check(f"at step {CLI_RESUME_STEP}" in err_r, "train --resume did not "
          "report its step")
    from yolo_tpu_torch.io import checkpoint as ckpt
    from yolo_tpu_torch.data.voc import list_split
    from yolo_tpu_torch.train.loop import state_from_tree

    before, b = (ckpt.restore(p) for p in (
        start, os.path.join(resumed, "final")))
    check(b["step"] == CLI_RESUME_STEP + 1
          and b["seen"] == (CLI_RESUME_STEP + 1) * TRAIN_BATCH,
          f"resumed at step {b['step']} seen {b['seen']}, want "
          f"{CLI_RESUME_STEP + 1} {(CLI_RESUME_STEP + 1) * TRAIN_BATCH}")
    # the library's step: the command's TrainConfig (--lr, --burn-in,
    # --grad-accum, no [net] keys) on the first batch of --seed 0
    tcfg = TrainConfig(learning_rate=0.001, burn_in_steps=1000,
                       grad_accum=SUBDIVISIONS, loss=region_loss_config(cfg),
                       yolo_loss=yolo_loss_config(cfg))
    state = state_from_tree(before, cfg, tcfg, device="cuda")
    host = next(host_batches(cfg, list_split(root, "train"), TRAIN_BATCH, 0))
    make_train_step(cfg, tcfg, compute_dtype=torch.bfloat16)(
        state, {k: torch.from_numpy(v).cuda() for k, v in host.items()})
    a = state_to_tree(state)

    def numpy(tree):
        return [{k: v.numpy() for k, v in p.items()} for p in tree["params"]]

    p0, pa, pb = numpy(before), numpy(a), numpy(b)
    upd = update_err(p0, pb, pa, {"kernel", "gamma", "beta", "bias"})
    stat = update_err(p0, pb, pa, {"mean", "var"})
    mom = max(float(np.linalg.norm(x[k].numpy() - y[k].numpy())
                    / max(np.linalg.norm(y[k].numpy()), 1e-30))
              for x, y in zip(b["opt_state"]["momentum_buffer"],
                              a["opt_state"]["momentum_buffer"]) for k in y)
    check(upd[0] <= STEP_BOUND and stat[0] <= STAT_BOUND
          and mom <= STEP_BOUND, f"resumed vs the library's step: update "
          f"{upd}, statistics {stat}, momentum {mom}")
    exported = os.path.join(seeded, "yolov2-voc-trained.weights")
    cli_run(["export", "--model", TRAIN_VARIANT, "--checkpoint",
             os.path.join(full, "final"), "--output", exported])
    frame = frames(SEED + 16, 1)
    served = yolo_tpu_torch.load(exported, device="cuda")
    from_dir = yolo_tpu_torch.load(os.path.join(full, "final"),
                                   device="cuda")
    x, y = served(frame), from_dir(frame)
    check(served.cfg.name == cfg.name and all(torch.equal(x[k], y[k])
                                              for k in x)
          and bool(torch.isfinite(x["boxes"]).all()),
          "load() of the exported .weights differs from load() of the "
          "checkpoint")
    emit({"phase": "cli", "command": "train", "model": cfg.name,
          "batch": TRAIN_BATCH, "grad_accum": SUBDIVISIONS,
          "precision": "bf16", "steps": CLI_TRAIN_STEPS,
          "img_per_s_logged": rates, "seconds": wall,
          "resume_seconds": wall_r, "data_seconds": data_s,
          "resume_from": CLI_RESUME_STEP, "resumed_vs_library_step": {
              "update": upd, "statistics": stat, "momentum": mom,
              "bounds": [STEP_BOUND, STAT_BOUND]},
          "export_serves": True, "card": card})


def cli_serve(seeded: str, coco: dict, card: str, launches: dict) -> None:
    """(e) `python -m yolo_tpu_torch.cli serve` in a subprocess: its
    answers to JPEG bodies equal direct calls; its /stats reports the
    NMS launches of the served requests."""
    weights = os.path.join(seeded, CLI_PREDICT[COCO_VARIANT])
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "yolo_tpu_torch.cli", "serve", "--model",
         COCO_VARIANT, "--weights", weights, "--port", "0",
         "--max-batch", "8"], stdout=subprocess.DEVNULL,
        stderr=subprocess.PIPE, text=True, cwd=REPO,
        env=dict(os.environ, PYTHONPATH=REPO))
    lines, listening = [], threading.Event()

    def read_stderr():   # drains the pipe; sets listening at the port
        for line in proc.stderr:
            lines.append(line)
            if re.search(r"serving .* on http://[\d.]+:\d+", line):
                listening.set()

    reader = threading.Thread(target=read_stderr, daemon=True)
    reader.start()
    try:
        listening.wait(SERVE_START_S)
        check(listening.is_set(), f"serve did not start within "
              f"{SERVE_START_S} s: {''.join(lines)[-2000:]}")
        port = int(re.search(r"serving .* on http://[\d.]+:(\d+)",
                             "".join(lines)).group(1))
        start_s = time.perf_counter() - t0
        bodies = []
        for p in coco["paths"][:CLI_SERVE_BODIES]:
            with open(p, "rb") as f:
                bodies.append(f.read())
        answers = [post_body(port, b, "image/jpeg") for b in bodies]
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
        conn.request("GET", "/stats")
        stats = json.loads(conn.getresponse().read())
        conn.close()
    finally:
        proc.terminate()
        try:
            proc.wait(timeout=60)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
        reader.join(timeout=60)
    model = yolo_tpu_torch.load(weights, COCO_VARIANT, device="cuda")
    names = model.cfg.detection_names()
    for i, body in enumerate(bodies):
        direct = detections_to_json(model(decode_image_bytes(body)[None]),
                                    names)[0]
        check(answers[i] == direct, f"serve subprocess: body {i}'s answer "
              f"differs from the direct call")
    nms = stats["kernel_launches"]["nms"]
    check(stats["errors"] == 0 and nms >= 1, f"serve /stats {stats}")
    launches["nms"] += nms
    emit({"phase": "cli", "command": "serve", "model": COCO_VARIANT,
          "requests": stats["requests"], "batches": stats["batches"],
          "responses_equal_direct": True, "nms_launches": nms,
          "seconds_to_listen": start_s, "card": card})


def phase_cli(seeded: str, coco: dict, card: str) -> dict:
    """Phase 16: the port's command line on the card -> {kernel:
    launches} of its commands."""
    launches = {"nms": 0}
    t0 = time.perf_counter()
    cli_predict(seeded, coco["paths"][0], card, launches)
    cli_detect(seeded, coco, card, launches)
    cli_eval(seeded, coco, card, launches)
    cli_train(seeded, card)
    cli_serve(seeded, coco, card, launches)
    foreign = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "yolo_tpu", "cv2",
                                            "grain"))
    check(not foreign, f"the command line loaded {foreign}")
    emit({"phase": "cli", "seconds": time.perf_counter() - t0,
          "nms_launches": launches["nms"], "card": card})
    return launches


def yolo9000_text(tree_file: str, map_file: str) -> str:
    """Darknet's cfg/yolo9000.cfg: darknet-19's 18 convs at [net] 544,
    one 1x1 conv of 3 * (5 + 9418) filters, a [region] of 3 anchors with
    tree= and map=."""
    conv = ("[convolutional]\nbatch_normalize=1\nfilters={}\nsize={}\n"
            "stride=1\npad=1\nactivation=leaky\n")
    pool = "[maxpool]\nsize=2\nstride=2\n"
    trunk = "".join(pool if s == "p" else conv.format(*s) for s in (
        (32, 3), "p", (64, 3), "p", (128, 3), (64, 1), (128, 3), "p",
        (256, 3), (128, 1), (256, 3), "p", (512, 3), (256, 1), (512, 3),
        (256, 1), (512, 3), "p", (1024, 3), (512, 1), (1024, 3), (512, 1),
        (1024, 3)))
    return (f"[net]\nbatch=1\nsubdivisions=1\nwidth={YOLO9000_SIZE}\n"
            f"height={YOLO9000_SIZE}\nchannels=3\nmomentum=0.9\n"
            "decay=0.0005\nlearning_rate=0.001\nmax_batches=500200\n"
            "policy=steps\nsteps=400000,450000\nscales=.1,.1\nhue=.1\n"
            "saturation=.75\nexposure=.75\n" + trunk
            + f"[convolutional]\nfilters={3 * (5 + TREE_NODES)}\nsize=1\n"
            "stride=1\npad=1\nactivation=linear\n"
            f"[region]\nanchors = {YOLO9000_ANCHORS}\nbias_match=1\n"
            f"classes={TREE_NODES}\nnum=3\nsoftmax=1\njitter=.2\n"
            "rescore=1\nobject_scale=5\nnoobject_scale=1\nclass_scale=1\n"
            f"coord_scale=1\nthresh=.6\nabsolute=1\nrandom=1\n"
            f"tree={tree_file}\nmap={map_file}\n")


def yolo9000_params(cfg, device="cuda") -> list:
    """Seeded YOLO9000 weights: synthetic_detector_params (He, box
    channels x0.1), then the head conv's objectness and class channels
    made affine in z, their zero-mean unit-spread value on a seeded
    letterboxed noise probe: objectness TREE_OBJ_GAIN * z + TREE_OBJ_SHIFT
    (a few percent of the boxes above 0.5), class logits
    TREE_CLASS_GAIN * z, and for anchor a TREE_PATH_BOOST more on the
    root path of the map's leaf a, so that traversals descend from box
    to box different paths and three mapped leaves reach high path
    products (with the He logits alone one channel's mean sets every
    box's class, and every deep node's path product is near 0)."""
    params = dw.synthetic_detector_params(cfg, SEED)
    a, c = cfg.num_anchors, cfg.num_classes
    net = Darknet(cfg.layers, fold_params(cfg.layers, params, cfg.bn_eps),
                  device=device)
    probe = torch.from_numpy(np.random.default_rng(SEED + 177).integers(
        0, 256, (1, *SRC_HW, 3), dtype=np.uint8)).to(device)
    v = (net(letterbox(probe, cfg.input_hw, dtype=torch.float32))
         .reshape(-1, a, 5 + c).double().cpu().numpy()
         - params[-1]["bias"].reshape(a, 5 + c))
    del net
    mean, std = v.mean(axis=0)[:, 4:], v.std(axis=0)[:, 4:]
    gain = np.full((a, 1 + c), TREE_CLASS_GAIN)
    gain[:, 0] = TREE_OBJ_GAIN
    shift = np.zeros((a, 1 + c))
    shift[:, 0] = TREE_OBJ_SHIFT
    for i, leaf in enumerate(cfg.tree_map[:a]):
        shift[i, [1 + n for n in cfg.tree.path(leaf)]] += TREE_PATH_BOOST
    k = params[-1]["kernel"].reshape(-1, a, 5 + c)
    k[..., 4:] = (k[..., 4:] * (gain / std)).astype(np.float32)
    b = params[-1]["bias"].reshape(a, 5 + c)
    b[:, 4:] = (-mean / std * gain + shift).astype(np.float32)
    return params


def tree_agree(ref: list, got: list, conf: float, what: str,
               need: bool) -> dict:
    """Phase 12's box-level rule both ways, where a side with no
    detection above conf + MARGIN needs the other to have none; need:
    the reference must have one (else the rule would test nothing)."""
    out = {}
    for name, (x, y) in (("a_in_b", (ref, got)), ("b_in_a", (got, ref))):
        hit = tot = 0
        for xi, yi in zip(x, y):
            h, t = match_rate(xi, yi, conf, _iou_voc)
            hit, tot = hit + h, tot + t
        out[name] = [hit, tot]
        check(tot == 0 or hit / tot >= MIN_MATCH, f"{what}: {name} match "
              f"rate {hit}/{tot} < {MIN_MATCH}")
    check((out["a_in_b"][1] == 0) == (out["b_in_a"][1] == 0),
          f"{what}: detections above conf + margin on one side only {out}")
    check(not need or out["a_in_b"][1] > 0,
          f"{what}: the reference has no detection above conf + margin")
    return out


def phase_tree_serve(root: str, card: str) -> tuple:
    """Phase 17 (a): YOLO9000 at 544, written as .cfg text with the
    generated 9418-node tree and an 80-leaf map beside it, seeded weights
    loaded by load(cfg=...): batch 1 and 32, bf16, on the default route
    and conv_impl="cuda", in traversal and map mode, against the fp32
    plain path (reference decode + exact per-class NMS in plain PyTorch)
    at box level; img/s and peak GiB; the NMS kernel's keep mask against
    plain on the fused tree head's grid. Returns (launches, the models,
    the cfg's path)."""
    tree = parse_tree(write_tree(os.path.join(root, "9k.tree"), TREE_NODES,
                                 seed=SEED))
    write_map(os.path.join(root, "coco9k.map"), tree, TREE_MAP_LEAVES,
              seed=SEED)
    cfg_path = os.path.join(root, "yolo9000.cfg")
    with open(cfg_path, "w") as f:
        f.write(yolo9000_text("9k.tree", "coco9k.map"))
    weights = os.path.join(root, "yolo9000-seed.weights")
    t0 = time.perf_counter()
    cfg = config_from_cfg(cfg_path)
    dw.save(weights, cfg.layers, yolo9000_params(cfg))
    seed_s = time.perf_counter() - t0
    model = yolo_tpu_torch.load(weights, cfg=cfg_path, device="cuda")
    model32 = yolo_tpu_torch.load(weights, cfg=cfg_path, device="cuda",
                                  precision="fp32")
    check(model.cfg == cfg and cfg.tree.n_nodes == TREE_NODES
          and len(cfg.tree_map) == TREE_MAP_LEAVES
          and cfg.grid_hw == (17, 17) and cfg.num_anchors == 3,
          f"YOLO9000 cfg: {cfg.name} {cfg.grid_hw}")
    shapes = eligible_conv_shapes(cfg)
    n_kernel = sum(shapes.values())
    emit({"phase": "tree", "part": "a_model", "tree_nodes": tree.n_nodes,
          "tree_groups": tree.n_groups, "tree_depth": tree.max_depth,
          "map_leaves": len(cfg.tree_map), "layers": len(cfg.layers),
          "head_filters": cfg.layers[-1].filters,
          "weights_bytes": os.path.getsize(weights), "seed_s": seed_s,
          "kernel_convs": n_kernel,
          "kernel_conv_shapes": [list(s) for s in shapes]})
    launches = {"conv": 0, "nms": 0}
    grids = {}
    for b in TREE_BATCHES:
        images = frames(SEED + 17 + b, b)
        for mode, conf in (("traversal", TREE_CONF), ("map", TREE_MAP_CONF)):
            kw = dict(conf_threshold=conf, use_tree_map=mode == "map")
            ref = detections_to_json(detect_raw(
                cfg, model32.params, images, head="reference",
                nms_impl="torch", **kw), cfg.detection_names(mode == "map"))
            for route, rkw, n_conv in (("default", {}, 0),
                                       ("conv_impl=cuda",
                                        {"conv_impl": "cuda"}, n_kernel)):
                conv_kernel.launches = nms_kernel.launches = 0
                out = detect_raw(cfg, model.params, images, **kw, **rkw)
                torch.cuda.synchronize()
                got = (conv_kernel.launches, nms_kernel.launches)
                what = f"YOLO9000 {mode} {route} batch {b}"
                check(got == (n_conv, 1), f"{what}: (conv, NMS) launches "
                      f"{got}, want {(n_conv, 1)}")
                launches["conv"] += got[0]
                launches["nms"] += got[1]
                check(bool(torch.isfinite(out["boxes"]).all()),
                      f"{what}: non-finite boxes")
                dets = detections_to_json(out, cfg.detection_names(
                    mode == "map"))
                agree = tree_agree(ref, dets, conf, what,
                                   need=b == max(TREE_BATCHES))
                torch.cuda.reset_peak_memory_stats()
                ms = cuda_median_ms(lambda: detect_raw(
                    cfg, model.params, images, **kw, **rkw),
                    reps=TREE_TIMED_REPS)
                emit({"phase": "tree", "part": "a_serve", "batch": b,
                      "mode": mode, "route": route, "conf": conf,
                      "conv_launches": got[0], "nms_launches": got[1],
                      "detections_per_image_mean": float(np.mean(
                          [len(d) for d in dets])),
                      "classes_seen": len({d["class"] for i in dets
                                           for d in i}),
                      "vs_fp32_plain": agree, "ms": ms,
                      "img_per_s": b * 1000 / ms,
                      "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
                      "card": card})
            if b == max(TREE_BATCHES):
                grids[mode] = time_suppress(
                    f"suppress_tree_head_{mode}", *captured_suppress_inputs(
                        lambda x: detect_raw(cfg, model.params, x, **kw),
                        images), card, batch=b)
    return launches, model, model32, cfg_path, grids


def conv_shape_rows(gen, shapes: dict, card, phase: str) -> tuple:
    """A model's eligible conv shapes ({(hw, cin, co, ks): count}; phase
    17 (a): YOLO9000's at 544, 17/34/68-px grids; phase 18 (b): yolov1's
    at 448, 56/28/14/7-px grids) at batch 1 and TIMED_BATCH in bf16 and
    fp32: the kernel against its plain version with phase 6's bounds,
    timed as phase 12 (c) times a shape. Returns (worst |kernel -
    plain|, [kernel, plain, library, bound] ms of all the model's
    kernel convs at TIMED_BATCH in bf16)."""
    worst, sums = 0.0, np.zeros(4)
    for b in TIMED_BATCHES:
        for (hw, cin, co, ks), n in sorted(shapes.items()):
            for dtype, _ in DTYPES:
                err, row = conv_shape_row(gen, b, (hw, hw), cin, co, ks,
                                          dtype, card)
                worst = max(worst, err)
                emit({"phase": phase, "part": "conv", "convs": n, **row})
                if b == TIMED_BATCH and dtype == torch.bfloat16:
                    sums += n * np.array([row["kernel_ms"],
                                          row["plain_ms"],
                                          row["library_ms"],
                                          row["bound_ms"]])
    return worst, [float(v) for v in sums]


def phase_tree_eval(model32, card) -> tuple:
    """Phase 17 (b): the exact per-class eval at 9418 classes, batch
    TREE_EVAL_BATCH (the reference head of collect_detections at
    EVAL_CONF, fp32, on letterboxed noise frames): the suppress grid it
    hands the NMS kernel, (B * 9418, 5, 128) in one launch, kernel
    against the row-chunked plain version (identical keep masks) and
    timed; under a budget that splits the classes into chunks of
    TREE_CHUNK_CLASSES the kernel path gives the same detections.
    Returns (the grid's times, its shape, NMS launches)."""
    cfg = model32.cfg
    det = make_detector_preprocessed(cfg, conf_threshold=EVAL_CONF,
                                     head="reference", nms_impl="cuda")
    x = letterbox(frames(SEED + 170, TREE_EVAL_BATCH), cfg.input_hw,
                  dtype=torch.float32)
    nms_kernel.launches = 0
    geom, scores, classes, conf, iou = captured_suppress_inputs(
        lambda v: det(model32.params, v), x)
    whole = det(model32.params, x)
    torch.cuda.synchronize()
    launches = nms_kernel.launches
    check(launches == 2, f"two 9k eval forwards: {launches} NMS launches")
    shape = list(geom.shape)
    check(shape == [TREE_EVAL_BATCH * TREE_NODES, 5, 128],
          f"9k eval grid {shape}")
    grid = time_suppress("eval_grid_9k", geom, scores, classes, conf, iou,
                         card, plain=_suppress_torch_rows,
                         plain_calls=TREE_PLAIN_CALLS)
    # the kernel path in class chunks: the same detections
    saved = nms_mod._CHUNK_ELEMS
    nms_mod._CHUNK_ELEMS = 5 * 128 * TREE_EVAL_BATCH * TREE_CHUNK_CLASSES
    try:
        nms_kernel.launches = 0
        chunked = det(model32.params, x)
        torch.cuda.synchronize()
        n_chunks = nms_kernel.launches
    finally:
        nms_mod._CHUNK_ELEMS = saved
    check(n_chunks == -(-TREE_NODES // TREE_CHUNK_CLASSES)
          and all(torch.equal(whole[k], chunked[k]) for k in whole),
          f"class-chunked kernel path ({n_chunks} launches) differs")
    emit({"phase": "tree", "part": "b_chunks", "grid": shape,
          "class_chunks": n_chunks, "equal_whole_grid": True})
    return grid, shape, launches + n_chunks


def tree_eval_card_vs_cpu(cfg, weights, coco_paths, card) -> int:
    """Phase 17 (b), card against CPU: collect_detections of YOLO9000
    (traversal mode, fp32, EVAL_CONF) over TREE_EVAL_SCENES JPEG scenes;
    box level both ways (phase 11's rule) and the 12 COCO cells within
    COCO_REL against pseudo ground truth made from the CPU's detections.
    Returns the NMS launches."""
    params, _ = dw.load(weights, cfg.layers)
    folded = fold_params(cfg.layers, params, cfg.bn_eps)
    samples = [(p, None) for p in coco_paths[:TREE_EVAL_SCENES]]
    nms_kernel.launches = 0
    t0 = time.perf_counter()
    card_dets = collect_detections(cfg, folded, samples,
                                   batch=TREE_EVAL_SCENES,
                                   eval_conf=EVAL_CONF, device="cuda")
    torch.cuda.synchronize()
    card_s, n = time.perf_counter() - t0, nms_kernel.launches
    t0 = time.perf_counter()
    cpu_dets = collect_detections(cfg, folded, samples,
                                  batch=TREE_EVAL_SCENES,
                                  eval_conf=EVAL_CONF, device="cpu")
    cpu_s = time.perf_counter() - t0
    check(n == 1, f"9k eval: {n} NMS launches for one batch")
    ways = check_both_ways(card_dets, cpu_dets, "YOLO9000 9k eval")
    gt = pseudo_ground_truth(cpu_dets, SEED + 17)
    cells_card = coco_cells(card_dets, gt, cfg)
    cells_cpu = coco_cells(cpu_dets, gt, cfg)
    check(0 < cells_cpu["map"] < 1, f"pseudo-GT mAP {cells_cpu['map']}")
    check_cells(cells_card, cells_cpu, "YOLO9000 9k eval")
    emit({"phase": "tree", "part": "b_eval", "scenes": len(samples),
          "detections": sum(len(d) for d in card_dets.values()),
          "both_ways": ways, "cells_card": cells_card,
          "cells_cpu": cells_cpu, "card_s": card_s, "cpu_s": cpu_s,
          "nms_launches": n, "card": card})
    return n


def tree_train_step(cfg, cfg_path: str, weights: str) -> dict:
    """Phase 17 (c): one fp32 step of YOLO9000 with the tree region loss
    on TREE_CHECK_BATCH noise frames with GT boxes labelled with random
    tree nodes, card against CPU as phase 10 (a) (choices held, the
    CPU's convs in float64, STEP_BOUND / STAT_BOUND, TF32 on must
    fail)."""
    params, _ = dw.load(weights, cfg.layers)
    rng = np.random.default_rng(SEED + 171)
    boxes, classes = [], []
    for _ in range(TREE_CHECK_BATCH):
        n = 4
        boxes.append(np.concatenate([rng.uniform(0.2, 0.8, (n, 2)),
                                     rng.uniform(0.05, 0.4, (n, 2))],
                                    -1).astype(np.float32))
        classes.append(rng.integers(0, TREE_NODES, n).astype(np.int32))
    host = encode_batch_for(cfg, boxes, classes)
    host["images"] = rng.uniform(0, 1, (TREE_CHECK_BATCH, *cfg.input_hw,
                                        3)).astype(np.float32)
    tcfg = train_config_from_cfg(cfg_path, cfg)
    return card_vs_cpu_step(cfg, tcfg, params, host, "tree",
                            own_choices=False)


def top5_agree(p_card: np.ndarray, p_cpu: np.ndarray, tol: float) -> bool:
    """Each image's top-5 classes equal card against CPU, where the
    CPU's 5th and 6th probabilities are apart by more than tol (a
    closer pair may swap)."""
    for a, b in zip(p_card, p_cpu):
        order = np.argsort(-b)
        if set(np.argsort(-a)[:5]) != set(order[:5]) and \
                b[order[4]] - b[order[5]] > tol:
            return False
    return True


def classifier_frames(seed: int, n: int) -> np.ndarray:
    """Seeded 480x640 frames with smooth structure (phase 10's scenes'
    ramps and rectangles), as uint8 on the host."""
    rng = np.random.default_rng(seed)
    return np.stack([scene(rng, *SRC_HW)[0] for _ in range(n)])


def phase_classifiers(root: str, card: str) -> dict:
    """Phase 17 (d): darknet19-448 at 448 and darknet53 at 256 (1000
    classes, seeded He weights written as .weights files, loaded by
    size): fp32 probabilities card against CPU within CLS_PROB_ERR and
    their top-5 alike; img/s at batch 1 and 64 in bf16. Returns the
    rows of the kernels-free classifier path for PERF.md."""
    out = {}
    for name, size in CLASSIFIERS.items():
        cfg = get_variant(name)
        check(cfg.input_size == size and cfg.num_classes == 1000,
              f"{name}: {cfg.input_size}, {cfg.num_classes}")
        path = os.path.join(root, f"{name}-seed.weights")
        dw.save(path, cfg.layers, dw.synthetic_detector_params(cfg, SEED))
        clf = yolo_tpu_torch.load(path, device="cuda", precision="fp32")
        check(clf.cfg.layers == cfg.layers, f"load took {clf.cfg.name} for "
              f"{name}'s file")
        cpu = yolo_tpu_torch.load(path, name, device="cpu",
                                  precision="fp32")
        xs = np.stack([classifier_preprocess(f, size)
                       for f in classifier_frames(SEED + 172, CLS_IMAGES)])
        run = make_classifier(cfg)
        p_card = run(clf.params, xs).cpu().numpy()
        p_cpu = run(cpu.params, xs).numpy()
        err = float(np.abs(p_card - p_cpu).max())
        scale = float(p_cpu.max())
        check(err <= CLS_PROB_ERR * scale, f"{name}: card vs CPU "
              f"probabilities {err} > {CLS_PROB_ERR} of {scale}")
        check(top5_agree(p_card, p_cpu, 2 * err), f"{name}: top-5 differ")
        bf16 = yolo_tpu_torch.load(path, name, device="cuda")
        times = {}
        for b in CLS_BATCHES:
            x = torch.from_numpy(np.resize(xs, (b, size, size, 3))).cuda()
            ms = cuda_median_ms(lambda: bf16.params(x), reps=10)
            times[b] = b * 1000 / ms
        top1_bf16 = bf16.params(torch.from_numpy(xs).cuda()).argmax(-1)
        emit({"phase": "classifiers", "model": name, "input": size,
              "weights_bytes": os.path.getsize(path),
              "fp32_card_vs_cpu_max_abs_err": err, "prob_scale": scale,
              "top5_equal": True, "bf16_top1_equal_fp32": int(
                  (top1_bf16.cpu().numpy() == p_cpu.argmax(-1)).sum()),
              "images": CLS_IMAGES,
              "img_per_s_bf16": {str(b): v for b, v in times.items()},
              "card": card})
        out[name] = (times, err)
        del clf, cpu, bf16
    return out


def tree_classifier_path(root: str) -> None:
    """Phase 17 (d): a darknet9000-style classifier (darknet-19 with a
    9418-way 1x1 head and [softmax] tree= on the generated tree, at
    256), written as .cfg text and loaded by load(cfg=...):
    hierarchy_path of each image the same nodes card and CPU, the
    conditionals within CLS_PROB_ERR; `classify --hierarchy` prints the
    card's path."""
    tree = parse_tree(os.path.join(root, "9k.tree"))
    base = get_variant("darknet19")
    cfg = dataclasses.replace(
        base, name="darknet9000", class_names=tree.names, tree=tree,
        tree_file="9k.tree", layers=base.layers[:-3] + (
            Conv(TREE_NODES, size=1, bn=False, act="linear"), AvgPool(),
            SoftmaxHead(tree=tree)))
    cfg_path = os.path.join(root, "darknet9000.cfg")
    with open(cfg_path, "w") as f:
        f.write(cfg_to_string(cfg))
    weights = os.path.join(root, "darknet9000-seed.weights")
    dw.save(weights, cfg.layers, dw.synthetic_detector_params(cfg, SEED))
    card_clf = yolo_tpu_torch.load(weights, cfg=cfg_path, device="cuda",
                                   precision="fp32")
    cpu_clf = yolo_tpu_torch.load(weights, cfg=cfg_path, device="cpu",
                                  precision="fp32")
    check(card_clf.cfg.softmax_tree == tree, "darknet9000's tree")
    xs = np.stack([classifier_preprocess(f, 256) for f in
                   classifier_frames(SEED + 173, CLS_IMAGES)])
    run = make_classifier(cfg)
    c_card = run(card_clf.params, xs).cpu().numpy()
    c_cpu = run(cpu_clf.params, xs).numpy()
    err = float(np.abs(c_card - c_cpu).max())
    check(err <= CLS_PROB_ERR, f"darknet9000 conditionals differ by {err}")
    paths = []
    for a, b in zip(c_card, c_cpu):
        pa, pb = hierarchy_path(a, tree), hierarchy_path(b, tree)
        check([n for n, _, _ in pa] == [n for n, _, _ in pb],
              "darknet9000: hierarchy paths differ card against CPU")
        paths.append(len(pa))
    image = os.path.join(root, "classify.jpg")
    with open(image, "wb") as f:
        f.write(encode_jpeg(classifier_frames(SEED + 174, 1)[0], 90))
    out, _, _, _ = cli_run(["classify", "--cfg", cfg_path, "--weights",
                            weights, "--image", image, "--hierarchy",
                            "--precision", "fp32"])
    x = classifier_preprocess(decode_image(image), 256)
    want = [{"node": n, "conditional": round(c, 6), "prob": round(p, 6)}
            for n, c, p in hierarchy_path(
                run(card_clf.params, x[None]).cpu().numpy()[0], tree)]
    check(cli_lines(out) == want, "classify --hierarchy differs from the "
          "direct hierarchy_path")
    emit({"phase": "classifiers", "model": "darknet9000",
          "tree_nodes": tree.n_nodes, "card_vs_cpu_max_abs_err": err,
          "path_lengths": paths, "classify_hierarchy_equal_direct": True})


def jpeg_class_folder(root: str) -> list:
    """CLS_TRAIN_CLASSES class folders of CLS_TRAIN_PER seeded JPEG
    scenes each, tinted by class -> list_imagefolder's samples."""
    rng = np.random.default_rng(SEED + 175)
    names = tuple(f"class{i}" for i in range(CLS_TRAIN_CLASSES))
    for ci, name in enumerate(names):
        os.makedirs(os.path.join(root, name))
        for j in range(CLS_TRAIN_PER):
            img = scene(rng, 96, 128)[0].astype(np.int32)
            img[..., ci % 3] += 40 * (1 + ci // 3)
            with open(os.path.join(root, name, f"{j}.jpg"), "wb") as f:
                f.write(encode_jpeg(np.clip(img, 0, 255).astype(np.uint8),
                                    90))
    return list_imagefolder(root, names), names


def classifier_train(root: str, card: str) -> dict:
    """Phase 17 (d): CLS_TRAIN_STEPS fp32 steps of darknet-19 with a
    CLS_TRAIN_CLASSES-way head at CLS_TRAIN_SIZE through
    classifier_train_batches (flip, HSV) from seeded JPEG class folders,
    card against CPU: the card's leaky sides and max-pool choices
    replayed on the CPU (HeldChoices), the CPU's convs in float64; each
    step's CE within 1e-4 (relative), the updates after the steps within
    STEP_BOUND and the rolling statistics within STAT_BOUND (phase 10's
    bounds)."""
    samples, names = jpeg_class_folder(os.path.join(root, "imagefolder"))
    base = get_variant("darknet19", input_size=CLS_TRAIN_SIZE)
    cfg = dataclasses.replace(base, name="darknet19-folder",
                              class_names=names, layers=base.layers[:-3] + (
                                  Conv(CLS_TRAIN_CLASSES, size=1, bn=False,
                                       act="linear"), AvgPool(),
                                  SoftmaxHead()))
    params = dw.synthetic_detector_params(cfg, SEED)
    tcfg = TrainConfig(learning_rate=0.01, momentum=0.9,
                       weight_decay=0.0005)
    batches = list(itertools.islice(classifier_train_batches(
        samples, CLS_TRAIN_BATCH, CLS_TRAIN_SIZE, epochs=2, seed=SEED,
        augment_cfg=AugmentConfig(hue=0.1, saturation=1.5, exposure=1.5)),
        CLS_TRAIN_STEPS))
    held = HeldChoices()

    def steps_on(dev):
        state = init_state(cfg, params, tcfg, device=dev)
        step = make_train_step(cfg, tcfg)
        ces = [finite_metrics(step(state, {k: torch.from_numpy(v).to(dev)
                                           for k, v in b.items()}),
                              f"classifier step on {dev}")["ce"]
               for b in batches]
        return state.net.to_numpy(), ces

    with held.record():
        gpu, ce_gpu = steps_on("cuda")
    with float64_products(), held.replay():
        cpu, ce_cpu = steps_on("cpu")
    ce_rel = max(abs(a - b) / abs(b) for a, b in zip(ce_gpu, ce_cpu))
    err = update_err(params, gpu, cpu, {"kernel", "gamma", "beta", "bias"})
    stat_err = update_err(params, gpu, cpu, {"mean", "var"})
    emit({"phase": "classifiers", "check": "train_steps_card_vs_cpu",
          "model": cfg.name, "input": CLS_TRAIN_SIZE,
          "batch": CLS_TRAIN_BATCH, "steps": CLS_TRAIN_STEPS,
          "images": len(samples), "ce_cuda": ce_gpu, "ce_cpu": ce_cpu,
          "ce_max_rel_err": ce_rel, "update_rel_err": err,
          "bn_stat_update_rel_err": stat_err, "card_flips": held.flips,
          "bounds": {"ce": 1e-4, "update": STEP_BOUND,
                     "bn_stat_update": STAT_BOUND}, "card": card})
    check(ce_rel <= 1e-4, f"classifier CE card vs CPU {ce_rel}")
    check(err[0] <= STEP_BOUND, f"classifier updates differ by {err}")
    check(stat_err[0] <= STAT_BOUND, f"classifier statistics differ by "
          f"{stat_err}")
    return {"update": err[0], "stat": stat_err[0]}


def post_classify(port: int, body: bytes, ctype: str) -> list:
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
    try:
        conn.request("POST", "/classify", body=body,
                     headers={"Content-Type": ctype})
        resp = conn.getresponse()
        answer = json.loads(resp.read())
    finally:
        conn.close()
    check(resp.status == 200, f"/classify returned {resp.status}: {answer}")
    return answer["classes"]


def classify_commands(root: str, card: str) -> None:
    """Phase 17 (d): `classify --image` and POST /classify (JPEG bodies,
    one at a time) of darknet53 in bf16 answer as direct Classifier
    calls on the same frames."""
    path = os.path.join(root, "darknet53-seed.weights")
    clf = yolo_tpu_torch.load(path, "darknet53", device="cuda")
    bodies = [encode_jpeg(f, 90) for f in classifier_frames(SEED + 176, 3)]
    images = []
    for i, body in enumerate(bodies):
        images.append(os.path.join(root, f"cls{i}.jpg"))
        with open(images[-1], "wb") as f:
            f.write(body)
    direct = [[{"class": n, "prob": round(p, 6)} for n, p in clf([
        decode_image(p)])[0]] for p in images]
    out, _, wall, _ = cli_run(["classify", "--model", "darknet53",
                               "--weights", path, "--image", images[0]])
    check(cli_lines(out) == direct[0], "classify lines differ from the "
          "direct call")
    server = DetectionServer(clf.cfg, clf.params, port=0, max_batch=4)
    server.start()
    try:
        answers = [post_classify(server.port, b, "image/jpeg")
                   for b in bodies]
        stats = dict(server.stats)
    finally:
        server.stop()
    check(stats["errors"] == 0 and answers == direct,
          f"/classify answers differ from direct calls ({stats})")
    emit({"phase": "classifiers", "check": "classify_and_http",
          "model": "darknet53", "classify_equal_direct": True,
          "classify_seconds": wall, "http_requests": stats["requests"],
          "http_equal_direct": True, "card": card})


def phase_tree(root: str, coco_paths: list, gen, card: str) -> dict:
    """Phase 17: YOLO9000 and the darknet classifiers -> the kernels
    line's parts."""
    os.makedirs(root)
    t0 = time.perf_counter()
    launches, model, model32, cfg_path, grids = phase_tree_serve(root, card)
    conv_shapes = eligible_conv_shapes(model.cfg)
    conv_worst, conv_sums = conv_shape_rows(gen, conv_shapes, card, "tree")
    grid, shape, n = phase_tree_eval(model32, card)
    launches["nms"] += n
    weights = os.path.join(root, "yolo9000-seed.weights")
    cfg = model.cfg
    del model, model32
    launches["nms"] += tree_eval_card_vs_cpu(cfg, weights, coco_paths, card)
    t1 = time.perf_counter()
    step = tree_train_step(cfg, cfg_path, weights)
    t2 = time.perf_counter()
    cls = phase_classifiers(root, card)
    tree_classifier_path(root)
    cls_train = classifier_train(root, card)
    classify_commands(root, card)
    foreign = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "yolo_tpu", "cv2",
                                            "grain"))
    check(not foreign, f"phase 17 loaded {foreign}")
    emit({"phase": "tree", "seconds": time.perf_counter() - t0,
          "serve_eval_seconds": t1 - t0, "train_step_seconds": t2 - t1,
          "classifier_seconds": time.perf_counter() - t2,
          "nms_launches": launches["nms"],
          "conv_launches": launches["conv"], "card": card})
    return {"launches": launches, "grid": grid, "shape": shape,
            "head_grids": grids, "step": step, "classifiers": cls,
            "classifier_train": cls_train, "conv_worst": conv_worst,
            "conv_ms": conv_sums, "convs": sum(conv_shapes.values())}


def yolov1_serve(root: str, card: str) -> tuple:
    """Phase 18 (a): yolov1 at 448, its .cfg text and seeded .weights on
    disk, through load(cfg=...) in bf16 and fp32: detect_raw on the
    default route and on conv_impl="cuda" (V1_KERNEL_CONVS conv and one
    NMS launch a forward) against the fp32 plain path at box level
    (phase 12's rule); a DetectionServer answers as direct calls do;
    head="fused" and entry="fused" raise as the JAX package's do; img/s
    at V1_BATCHES and peak GiB. Returns (cfg path, weights path,
    the bf16 model, launches, its eligible conv shapes, the frames)."""
    cfg_path = os.path.join(root, "yolov1.cfg")
    with open(cfg_path, "w") as f:
        f.write(YOLOV1_CFG)
    weights = os.path.join(root, "yolov1-seed.weights")
    t0 = time.perf_counter()
    cfg = dataclasses.replace(config_from_cfg(cfg_path),
                              conf_threshold=V1_CONF)
    params = dw.synthetic_detector_params(cfg, SEED)
    dw.save(weights, cfg.layers, params)
    seed_s = time.perf_counter() - t0
    n_params = sum(int(v.size) for p in params for k, v in p.items()
                   if k not in ("mean", "var"))
    del params
    model, model32 = [yolo_tpu_torch.load(weights, cfg=cfg_path,
                                          device="cuda", precision=prec,
                                          conf_threshold=V1_CONF)
                      for prec in ("bf16", "fp32")]
    model.cfg = model32.cfg = cfg
    head = cfg.detection_head
    shapes = eligible_conv_shapes(cfg)
    n_kernel = sum(shapes.values())
    check(cfg.head_kind == "detection" and cfg.input_hw == (448, 448)
          and (head.side, head.num, head.classes) == (7, 3, 20)
          and abs(n_params - V1_PARAMS) < 0.01 * V1_PARAMS
          and (n_kernel, len(shapes)) == (V1_KERNEL_CONVS,
                                          V1_KERNEL_SHAPES),
          f"yolov1: {n_params} params, kernel convs {shapes}")
    emit({"phase": "yolov1", "part": "a_model", "layers": len(cfg.layers),
          "params": n_params, "weights_bytes": os.path.getsize(weights),
          "seed_s": seed_s, "kernel_convs": n_kernel,
          "kernel_conv_shapes": [list(s) for s in shapes]})
    launches = {"conv": 0, "nms": 0}
    images = frames(SEED + 18, max(V1_BATCHES))
    for row in check_routes(cfg, model, model32, images, n_kernel,
                            launches):
        emit({"phase": "yolov1", "part": "a_routes", **row})
    check_http(model, images[:4], launches, "yolov1")
    try:
        detect_raw(cfg, model.params, images[:1], head="fused")
        fused_head_raises = False
    except ValueError:
        fused_head_raises = True
    check(fused_head_raises and entry_fused_raises(cfg, model, images[:1]),
          "yolov1: head='fused' and entry='fused' must raise ValueError, "
          "as the JAX package's do")
    for b in V1_BATCHES:
        for route, kw in (("default", {}), ("conv_impl=cuda",
                                            {"conv_impl": "cuda"})):
            torch.cuda.reset_peak_memory_stats()
            ms = cuda_median_ms(lambda: detect_raw(
                cfg, model.params, images[:b], **kw), reps=V1_TIMED_REPS)
            emit({"phase": "yolov1", "part": "a_times", "batch": b,
                  "route": route, "precision": "bf16", "ms": ms,
                  "img_per_s": b * 1000 / ms,
                  "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
                  "card": card})
    return cfg_path, weights, model, launches, shapes, images


def yolov1_step_inputs(cfg, cfg_path: str) -> tuple:
    """Phase 18 (d)'s micro-batch: V1_STEP_BATCH noise frames with 5 GT
    boxes each, encoded for the [detection] loss, and the TrainConfig of
    the cfg's [net] (train_config_from_cfg). -> (host batch, tcfg)."""
    rng = np.random.default_rng(SEED + 181)
    boxes, classes = [], []
    for _ in range(V1_STEP_BATCH):
        n = 5
        boxes.append(np.concatenate([rng.uniform(0.1, 0.9, (n, 2)),
                                     rng.uniform(0.05, 0.5, (n, 2))],
                                    -1).astype(np.float32))
        classes.append(rng.integers(0, cfg.num_classes, n).astype(np.int32))
    host = encode_batch_for(cfg, boxes, classes)
    host["images"] = rng.uniform(0, 1, (V1_STEP_BATCH, *cfg.input_hw,
                                        3)).astype(np.float32)
    return host, train_config_from_cfg(cfg_path, cfg)


def yolov1_train_step(cfg, cfg_path: str, weights: str) -> dict:
    """Phase 18 (d): one fp32 step of yolov1 with detection_loss on
    yolov1_step_inputs, card against CPU as phase 10 (a) (choices held,
    the CPU's convs and dense products in float64, V1_STEP_BOUND /
    STAT_BOUND, TF32 on must fail). The [dropout] masks (utils/prng.py,
    drawn on the host from the step's key) are captured: equal in all
    four steps, card and CPU."""
    from yolo_tpu_torch.utils import prng

    params, _ = dw.load(weights, cfg.layers)
    host, tcfg = yolov1_step_inputs(cfg, cfg_path)
    masks, bernoulli = [], prng.bernoulli

    def capture(*args, **kw):
        masks.append(bernoulli(*args, **kw))
        return masks[-1]

    prng.bernoulli = capture
    try:
        out = card_vs_cpu_step(cfg, tcfg, params, host, "yolov1",
                               own_choices=False, step_bound=V1_STEP_BOUND)
    finally:
        prng.bernoulli = bernoulli
    check(len(masks) == 4 and all(np.array_equal(m, masks[0])
                                  for m in masks)
          and 0.45 < float(masks[0].mean()) < 0.55,
          f"yolov1 dropout masks: {len(masks)} drawn, not all equal")
    emit({"phase": "yolov1", "part": "d_dropout_masks", "steps": len(masks),
          "equal": True, "shape": list(masks[0].shape),
          "kept_share": float(masks[0].mean())})
    return out


def yolov1_predict(root: str, cfg_path: str, weights: str, model,
                   card: str) -> int:
    """Phase 18 (e): `predict --cfg` of one PNG frame through the
    command line prints the lines of load()'s detector on the frame.
    Returns the NMS launches."""
    img = os.path.join(root, "frame.png")
    frame = np.random.default_rng(SEED + 182).integers(
        0, 256, (*SRC_HW, 3), dtype=np.uint8)
    with open(img, "wb") as f:
        f.write(encode_png(frame))
    out, _, wall, n = cli_run(["predict", "--cfg", cfg_path, "--weights",
                               weights, "--image", img, "--conf",
                               str(V1_CONF)])
    direct = cli_detections(model(frame[None]), model.cfg.class_names)
    got = cli_lines(out)
    check(got == direct and len(got) > 0 and n == 1,
          f"yolov1 predict: {len(got)} printed detections, {n} NMS "
          f"launches; the direct call's {len(direct)}")
    emit({"phase": "yolov1", "part": "e_predict", "detections": len(got),
          "equal_direct": True, "nms_launches": n, "seconds": wall,
          "card": card})
    return n


def phase_yolov1(root: str, gen, card: str) -> dict:
    """Phase 18: yolov1 -> the kernels line's parts. (a) serving; (b)
    its conv shapes, kernel against plain and timed; (c) the NMS kernel
    against plain on the (32, 5, 256) grid a forward hands it, timed;
    (d) the card-vs-CPU train step; (e) predict through the CLI."""
    os.makedirs(root)
    t0 = time.perf_counter()
    cfg_path, weights, model, launches, shapes, images = yolov1_serve(
        root, card)
    cfg = model.cfg
    conv_worst, conv_sums = conv_shape_rows(gen, shapes, card, "yolov1")
    geom, scores, classes, conf, iou = captured_suppress_inputs(
        lambda x: detect_raw(cfg, model.params, x), images)
    check(list(geom.shape) == [max(V1_BATCHES), 5, 256],
          f"yolov1 suppress grid {list(geom.shape)}")
    grid = time_suppress("suppress_yolov1", geom, scores, classes, conf,
                         iou, card, batch=max(V1_BATCHES))
    t1 = time.perf_counter()
    step = yolov1_train_step(cfg, cfg_path, weights)
    t2 = time.perf_counter()
    launches["nms"] += yolov1_predict(root, cfg_path, weights, model, card)
    emit({"phase": "yolov1", "seconds": time.perf_counter() - t0,
          "serve_conv_nms_seconds": t1 - t0, "train_step_seconds": t2 - t1,
          "nms_launches": launches["nms"],
          "conv_launches": launches["conv"], "card": card})
    return {"launches": launches, "grid": grid, "shape": list(geom.shape),
            "step": step, "conv_worst": conv_worst, "conv_ms": conv_sums,
            "convs": sum(shapes.values())}


# phase 19: int8 post-training quantization (models/quantize.py) of
# YOLOv2-COCO 416 on phase 4's seeded weights, chained, served in bf16 as
# the CLI's --precision int8
INT8_CALIB = 8            # seeded frames prepare_int8 calibrates on
INT8_CONVS = 23           # s8 launches a forward: every conv
# phase 2: wgmma instantiations of the bf16 conv kernel and of the s8
# kernel (BN 64 and 128 on 128-, 64- and 32-byte activation boxes)
BF16_WGMMA_KERNELS = 4
S8_WGMMA_KERNELS = 6
# int8-pool launches a forward: pools 3, 7 and 11 (pool 1 runs in conv
# 0's stem launch; pool 17 pools bf16, since conv 16 feeds route 25)
INT8_POOLS = 3
# (a)'s pools fused into the stem body at conv 0's shape
STEM_POOLS = ((2, 2), (2, 1), (3, 1))
# tests/test_quantize.py's gates against the fp32 plain path: the largest
# |score_fp32 - score_int8| and the top-50 overlap of the two
INT8_GATE_DEV = 0.3
INT8_GATE_OVERLAP = 0.6
INT8_GATE_BATCH = 2       # the JAX tests' batch for the two gates
INT8_CHECK_BATCHES = (1, 32)
INT8_E2E_BATCHES = (1, 32, 128)
INT8_CPU_BATCH = 2        # (d), card against CPU
# shapes no YOLOv2-COCO conv has: grouped (mma body), grouped narrow
# (dp4a), dilated; (h, w, cin, co, ks, stride, groups, dilation, act)
INT8_EXTRA_SHAPES = ((26, 26, 512, 512, 3, 1, 4, 1, "leaky"),
                     (26, 26, 96, 96, 3, 1, 6, 1, "leaky"),
                     (52, 52, 128, 128, 3, 1, 1, 2, "leaky"))
V4_INT8_BATCH = 32        # (g): yolov4 @608, mish in the epilogue
V4_INT8_CONVS = 110
# (g)'s score deviation is printed, not gated at INT8_GATE_DEV: on these
# seeded weights the JAX package's own int8 (yolo_tpu.models.quantize on
# the CPU, the same frames and calibration: tools/int8_gates.py yolov4)
# deviates by 0.4850 on the gate batch; the top-50 overlap gate holds
# (JAX: 0.80)
V4_JAX_SCORE_DEV = 0.4850


def int8_calibrated(cfg, weights: str, device="cuda") -> tuple:
    """prepare_int8 of a seeded .weights file on INT8_CALIB seeded raw
    frames letterboxed on the host (the CLI's calibration input) ->
    (int8 numpy params, folded numpy params, seconds, the calibration
    batch on the card)."""
    from yolo_tpu_torch.models import quantize

    params, _ = dw.load(weights, cfg.layers)
    raw = np.random.default_rng(SEED + 19).integers(
        0, 256, (INT8_CALIB, *SRC_HW, 3), dtype=np.uint8)
    calib = np.stack([_host_resize(f, cfg.input_hw, "letterbox")
                      for f in raw])
    t0 = time.perf_counter()
    q = quantize.prepare_int8(cfg, params, calib, device=device)
    torch.cuda.synchronize()
    return (q, fold_params(cfg.layers, params, cfg.bn_eps),
            time.perf_counter() - t0, torch.from_numpy(calib).cuda())


def s8_inputs(gen, b, shape) -> tuple:
    """Seeded int8 codes, bf16 activations, an int8 kernel, fp32 scale
    and bias for one conv shape, on the card."""
    h, w, cin, co, ks, _, groups, _, _ = shape
    xq = torch.randint(-127, 128, (b, cin, h, w), generator=gen,
                       device="cuda", dtype=torch.int8)
    xf = (torch.randn(b, cin, h, w, generator=gen, device="cuda") * 2
          ).to(torch.bfloat16)
    kq = torch.randint(-127, 128, (co, cin // groups, ks, ks), generator=gen,
                       device="cuda", dtype=torch.int8)
    scale = torch.rand(co, generator=gen, device="cuda") * 1e-4 + 1e-6
    bias = torch.randn(co, generator=gen, device="cuda")
    cl = torch.channels_last
    return (xq.contiguous(memory_format=cl), xf.contiguous(memory_format=cl),
            kq.contiguous(memory_format=cl), scale, bias)


def phase_int8_kernel(gen, shapes) -> float:
    """(a) the s8 kernel against its plain version on the same card
    tensors at every conv shape of YOLOv2-COCO (conv 0 on the stem body)
    and INT8_EXTRA_SHAPES, batch 1 and 32: int8 codes and bf16 inputs;
    int8, bf16 and fp32 outputs (at batch 32 one of each); conv 0 also
    with STEM_POOLS fused against the plain block and the plain pool;
    and the int8 maxpool kernel against the running maximum at the
    net's 2x2/2 pool shapes. Leaky and linear: the same bytes. Returns
    the largest |kernel - plain|."""
    from yolo_tpu_torch.ops import conv_s8
    from yolo_tpu_torch.ops import pool as pool_ops
    from yolo_tpu_torch.ops.cuda import conv_s8_kernel, pool_kernel

    worst = 0.0

    def same(got, want, what, **row):
        nonlocal worst
        check(got.dtype == want.dtype and got.shape == want.shape
              and got.is_contiguous(memory_format=torch.channels_last),
              f"{what}: {got.dtype} {tuple(got.shape)}")
        err = float((got.float() - want.float()).abs().max())
        check(torch.equal(got, want), f"{what}: max |kernel - plain| "
              f"{err}, not the same bytes")
        worst = max(worst, err)
        emit({"phase": "int8_kernel", **row, "identical": True})

    for b in INT8_CHECK_BATCHES:
        for shape in sorted(shapes) + list(INT8_EXTRA_SHAPES):
            h, w, cin, co, ks, stride, groups, dil, act = shape
            xq, xf, kq, scale, bias = s8_inputs(gen, b, shape)
            combos = [(x, o, d) for x in (xq, xf)
                      for o, d in ((0.05, None), (None, torch.bfloat16),
                                   (None, torch.float32))]
            if b > 1:
                combos = [combos[3], combos[1], combos[2]]
            stem = conv_s8_kernel.stem_takes(cin // groups, co // groups,
                                             groups, stride=stride,
                                             dilation=dil, ks=ks)
            pools = (None, *STEM_POOLS) if stem else (None,)
            for x, out_scale, dt in combos:
                for pool in pools:
                    kw = dict(x_inv=40.0, out_scale=out_scale, act=act,
                              stride=stride, groups=groups, dilation=dil,
                              out_dtype=dt or torch.float32)
                    got = conv_s8_kernel.conv_s8_bias_act(
                        x, kq, scale, bias, pool=pool, **kw)
                    torch.cuda.synchronize()
                    want = conv_s8.conv_s8_bias_act(x, kq, scale, bias,
                                                    **kw)
                    if pool is not None:
                        want = (pool_ops.maxpool_s8_plain(want, *pool)
                                if want.dtype == torch.int8 else
                                pool_ops.maxpool_nchw(want, *pool))
                    ho, wo = conv_s8.out_hw(h, w, ks, stride, dil)
                    same(got, want,
                         f"s8 conv {b}x{h}x{w} {cin}->{co} {ks}x{ks}/"
                         f"{stride} g{groups} d{dil} pool {pool} "
                         f"{x.dtype}->{got.dtype}",
                         batch=b, shape=list(shape), pool=pool,
                         **{"in": str(x.dtype), "out": str(got.dtype)},
                         plan=list(conv_s8_kernel.plan(
                             b * ho * wo, cin // groups, co // groups,
                             groups, stride=stride, dilation=dil, ks=ks)))
        for c, hw in ((64, 208), (128, 104), (256, 52), (512, 26), (20, 13)):
            x = torch.randint(-128, 128, (b, c, hw, hw), generator=gen,
                              device="cuda", dtype=torch.int8).contiguous(
                                  memory_format=torch.channels_last)
            for size, stride in ((2, 2), (2, 1), (3, 1)):
                before = pool_kernel.launches
                got = pool_ops.maxpool_nchw(x, size, stride)
                torch.cuda.synchronize()
                check(pool_kernel.launches == before + 1,
                      "an int8 pool on the card did not launch the kernel")
                same(got, pool_ops.maxpool_s8_plain(x, size, stride),
                     f"int8 maxpool {b}x{c}x{hw}x{hw} {size}/{stride}",
                     batch=b, pool_in=[c, hw, hw], pool=[size, stride])
    return worst


def captured_s8_calls(net, x, pools=None) -> list:
    """The s8 wrapper's calls in one forward of net on x: (args, kwargs),
    tensors cloned as the wrapper got them; the int8 pool wrapper's
    calls go to `pools` ((x, size, stride)) when it is given."""
    from yolo_tpu_torch.ops.cuda import conv_s8_kernel, pool_kernel

    got = []
    kernel, pool = conv_s8_kernel.conv_s8_bias_act, pool_kernel.maxpool_s8

    def capture(x, kq, scale, bias, **kw):
        got.append(((x.clone(), kq, scale, bias), dict(kw)))
        return kernel(x, kq, scale, bias, **kw)

    def capture_pool(x, size, stride):
        if pools is not None:
            pools.append((x.clone(), size, stride))
        return pool(x, size, stride)

    conv_s8_kernel.conv_s8_bias_act = capture
    pool_kernel.maxpool_s8 = capture_pool
    try:
        net(x)
    finally:
        conv_s8_kernel.conv_s8_bias_act = kernel
        pool_kernel.maxpool_s8 = pool
    return got


def plain_s8(args, kw):
    """The plain block on an s8 wrapper call's arguments, then the plain
    pool of a fused one (the running maximum for int8 codes)."""
    from yolo_tpu_torch.ops import conv_s8
    from yolo_tpu_torch.ops import pool as pool_ops

    pool = kw.get("pool")
    y = conv_s8.conv_s8_bias_act(*args, **{k: v for k, v in kw.items()
                                          if k != "pool"})
    if pool is None:
        return y
    return (pool_ops.maxpool_s8_plain(y, *pool) if y.dtype == torch.int8
            else pool_ops.maxpool_nchw(y, *pool))


def int8_gemm_operands(x, kq, stride, dilation) -> tuple:
    """The conv's GEMM operands for torch._int_mm: the im2col'd int8
    activations (M, K) and the kernel as (K, N), K-major, K and N padded
    with zeros to multiples of 8 (_int_mm's rule). Groups 1 only."""
    ks = kq.shape[-1]
    cols = F.unfold(x.float(), ks, dilation=dilation,
                    padding=(ks // 2) * dilation, stride=stride)
    a = cols.transpose(1, 2).reshape(-1, cols.shape[1])
    k, n = a.shape[1], kq.shape[0]
    k8, n8 = -(-k // 8) * 8, -(-n // 8) * 8
    a = F.pad(a, (0, k8 - k)).to(torch.int8).contiguous()
    w = F.pad(kq.float().reshape(n, k), (0, k8 - k, 0, n8 - n)).to(
        torch.int8).contiguous()
    return a, w.t()


def phase_int8_times(cfg, net, card: str) -> dict:
    """(f) per s8 call of a forward at batch 1 and 32 (the inputs the
    forward gave it, distinct shapes timed once; conv 0's call with pool
    1 fused): kernel, plain and library ms beside the bound, and the
    sums over the 23 convs; per int8 pool of the forward the pool
    kernel beside its plain version and its byte bound, and the sums.
    library_ms: torch._int_mm on the conv's GEMM operands (im2col'd for
    3x3), the GEMM alone; the port never calls it. The int8 pool has no
    library call (no int8 max_pool2d on the card)."""
    from yolo_tpu_torch.ops import conv_s8
    from yolo_tpu_torch.ops import pool as pool_ops
    from yolo_tpu_torch.ops.cuda import conv_s8_kernel

    sums, pool_sums = {}, {}
    for b in TIMED_BATCHES:
        x = letterbox(frames(SEED + 190 + b, b), cfg.input_hw,
                      dtype=torch.bfloat16)
        pools = []
        calls = captured_s8_calls(net, x, pools)
        check(len(calls) == INT8_CONVS and len(pools) == INT8_POOLS,
              f"{len(calls)} s8 calls and {len(pools)} int8 pools a "
              f"forward")
        seen = {}
        for args, kw in calls:
            key = (tuple(args[0].shape), args[0].dtype, tuple(args[1].shape),
                   kw["stride"], kw["groups"], kw["dilation"], kw["act"],
                   kw["out_scale"] is None, kw.get("pool"))
            seen.setdefault(key, [args, kw, 0])[2] += 1
        total = [0.0] * 4
        kinds = {}
        for key, (args, kw, n) in seen.items():
            xin, kq, scale, bias = args
            out = conv_s8_kernel.conv_s8_bias_act(*args, **kw)
            ms = cuda_ms_per_call(
                lambda: conv_s8_kernel.conv_s8_bias_act(*args, **kw),
                calls=20)
            plain_ms = cuda_ms_per_call(lambda: plain_s8(args, kw), calls=3)
            library_ms = None
            if kw["groups"] == 1:
                a, w = int8_gemm_operands(
                    xin if xin.dtype == torch.int8 else
                    conv_s8.quantize_input(xin, kw["x_inv"]), kq,
                    kw["stride"], kw["dilation"])
                library_ms = cuda_ms_per_call(lambda: torch._int_mm(a, w),
                                              calls=20)
            # the conv's output pixels (before a fused pool)
            ho, wo = conv_s8.out_hw(xin.shape[2], xin.shape[3],
                                    kq.shape[-1], kw["stride"],
                                    kw["dilation"])
            m = xin.shape[0] * ho * wo
            flop = 2 * m * out.shape[1] * kq[0].numel()
            bound, bound_by = bound_ms(flop, nbytes(xin, kq, scale, bias,
                                                    out), torch.int8)
            emit({"phase": "times", "what": "conv_s8", "batch": b,
                  "in_shape": list(xin.shape), "in": str(xin.dtype),
                  "kernel_shape": list(kq.shape), "stride": kw["stride"],
                  "act": kw["act"], "out": str(out.dtype),
                  "pool": kw.get("pool"), "layers": n,
                  "plan": list(conv_s8_kernel.plan(
                      m, kq.shape[1], kq.shape[0] // kw["groups"],
                      kw["groups"], stride=kw["stride"],
                      dilation=kw["dilation"], ks=kq.shape[-1])),
                  "kernel_ms": ms, "plain_ms": plain_ms,
                  "library_ms": library_ms, "library": "torch._int_mm on "
                  "the im2col'd GEMM operands, GEMM only",
                  "bound_ms": bound, "bound_by": bound_by,
                  "kernel_tops": flop / ms / 1e9,
                  "share_of_bound": bound / ms, "card": card})
            for i, t in enumerate((ms, plain_ms, library_ms or 0.0, bound)):
                total[i] += n * t
            kinds[bound_by] = kinds.get(bound_by, 0.0) + n * bound
        by = max(kinds.items(), key=lambda kv: kv[1])[0]
        sums[b] = (*total, by)
        emit({"phase": "times", "what": "conv_s8_23_layers", "batch": b,
              "kernel_ms": total[0], "plain_ms": total[1],
              "library_ms": total[2], "bound_ms": total[3], "bound_by": by,
              "share_of_bound": total[3] / total[0], "card": card})
        ptot = [0.0] * 3
        for xin, size, stride in pools:
            out = pool_ops.maxpool_nchw(xin, size, stride)
            ms = cuda_ms_per_call(
                lambda: pool_ops.maxpool_nchw(xin, size, stride), calls=20)
            plain_ms = cuda_ms_per_call(
                lambda: pool_ops.maxpool_s8_plain(xin, size, stride),
                calls=20)
            bound = bound_ms(0, nbytes(xin, out), torch.int8)[0]
            emit({"phase": "times", "what": "maxpool_s8", "batch": b,
                  "in_shape": list(xin.shape), "size": size,
                  "stride": stride, "kernel_ms": ms, "plain_ms": plain_ms,
                  "bound_ms": bound, "bound_by": "bytes",
                  "share_of_bound": bound / ms, "card": card})
            for i, t in enumerate((ms, plain_ms, bound)):
                ptot[i] += t
        pool_sums[b] = tuple(ptot)
        emit({"phase": "times", "what": "maxpool_s8_pools", "batch": b,
              "pools": len(pools), "kernel_ms": ptot[0],
              "plain_ms": ptot[1], "bound_ms": ptot[2], "bound_by": "bytes",
              "share_of_bound": ptot[2] / ptot[0], "card": card})
    return sums, pool_sums


def int8_gates(s32, s8) -> tuple:
    """tests/test_quantize.py's two numbers: the largest score deviation
    and the top-50 overlap, over the whole batch."""
    s32, s8 = s32.float().cpu().numpy(), s8.float().cpu().numpy()
    dev = float(np.abs(s32 - s8).max())
    top32 = np.argsort(-s32.ravel())[:50]
    top8 = np.argsort(-s8.ravel())[:50]
    return dev, len(set(top32) & set(top8)) / 50


def int8_launch_counts(fn) -> dict:
    """fn() with every kernel's count (and the plain s8 block's count on
    the card) set to 0 just before -> the counts just after."""
    from yolo_tpu_torch.ops import conv_s8
    from yolo_tpu_torch.ops import pool as pool_ops
    from yolo_tpu_torch.ops.cuda import conv_s8_kernel, pool_kernel

    nms_kernel.launches = conv_kernel.launches = entry_kernel.launches = 0
    conv_s8_kernel.launches = conv_s8.cuda_calls = 0
    pool_kernel.launches = pool_ops.cuda_calls = 0
    out = fn()
    torch.cuda.synchronize()
    return out, {"conv_s8": conv_s8_kernel.launches,
                 "maxpool_s8": pool_kernel.launches,
                 "nms": nms_kernel.launches, "conv": conv_kernel.launches,
                 "entry": entry_kernel.launches,
                 "plain_s8_on_card": conv_s8.cuda_calls,
                 "plain_pool_on_card": pool_ops.cuda_calls}


def int8_cli(seeded: str, cfg, weights: str, card: str) -> dict:
    """(e) `predict --precision int8` through the CLI in this process,
    calibrated on its image as the command is: its lines equal a direct
    call of a net calibrated the same way; and the net `serve --precision
    int8 --calibration-image` builds, behind DetectionServer: the HTTP
    answers to a JPEG body and an .npy body equal direct calls. Returns
    the launches of both."""
    from yolo_tpu_torch.cli.tools_cmds import _serve_net
    from yolo_tpu_torch.models import quantize

    raw = np.random.default_rng(SEED + 191).integers(
        0, 256, (*SRC_HW, 3), dtype=np.uint8)
    image = os.path.join(seeded, "int8.jpg")
    with open(image, "wb") as f:
        f.write(encode_jpeg(raw, 90))
    frame = decode_image(image)
    argv = ["predict", "--model", VARIANT, "--weights", weights, "--image",
            image, "--precision", "int8"]
    (out, _, wall, _), counts = int8_launch_counts(lambda: cli_run(argv))
    params, _ = dw.load(weights, cfg.layers)
    q = quantize.prepare_int8(cfg, params, _host_resize(
        frame, cfg.input_hw, "letterbox")[None])
    net = Darknet(cfg.layers, q, device="cuda", dtype=torch.bfloat16)
    names = cfg.detection_names()
    direct = cli_detections(make_detector(cfg)(net, torch.from_numpy(
        frame[None]).cuda()), names)
    got = cli_lines(out)
    check(got == direct, f"predict --precision int8: {len(got)} printed "
          f"detections differ from the direct call's {len(direct)}")
    check(counts["conv_s8"] == INT8_CONVS and counts["nms"] == 1
          and counts["maxpool_s8"] == INT8_POOLS
          and counts["plain_s8_on_card"] == 0
          and counts["plain_pool_on_card"] == 0,
          f"predict --precision int8 launches {counts}")
    args = argparse.Namespace(precision="int8", calibration_image=image,
                              device="cuda", weights=weights,
                              resize="letterbox")
    served = _serve_net(args, cfg, classifier=False)
    server = DetectionServer(cfg, served, port=0, max_batch=8)
    server.start()
    try:
        with open(image, "rb") as f:
            body = f.read()

        def ask():
            return (post_body(server.port, body, "image/jpeg"),
                    post_npy(server.port, frame))

        (jpeg_answer, npy_answer), served_counts = int8_launch_counts(ask)
    finally:
        server.stop()
    direct = detections_to_json(make_detector(cfg)(served, torch.from_numpy(
        frame[None]).cuda()), names)[0]
    check(jpeg_answer == direct and npy_answer == direct,
          "serve --precision int8: an HTTP answer differs from the direct "
          "call")
    check(served_counts["conv_s8"] == 2 * INT8_CONVS
          and served_counts["maxpool_s8"] == 2 * INT8_POOLS
          and served_counts["plain_s8_on_card"] == 0
          and served_counts["plain_pool_on_card"] == 0,
          f"served int8 launches {served_counts}")
    emit({"phase": "int8_cli", "command": "predict", "detections": len(got),
          "equal_direct": True, "seconds_in_process": wall,
          "launches": counts, "card": card})
    emit({"phase": "int8_cli", "command": "serve", "bodies": ["jpeg", "npy"],
          "responses_equal_direct": True, "launches": served_counts,
          "card": card})
    return {k: counts[k] + served_counts[k]
            for k in ("conv_s8", "maxpool_s8", "nms")}


def int8_yolov4(seeded: str, card: str) -> dict:
    """(g) yolov4 @608 (phase 12's seeded weights), int8 chained, bf16,
    batch V4_INT8_BATCH: V4_INT8_CONVS s8 launches and one NMS launch a
    forward; every s8 call of the forward (72 with mish in the epilogue)
    against the plain block on its own inputs; against the fp32 plain
    path, the top-50 overlap gate, and the score deviation beside the
    JAX package's own on the same inputs (V4_JAX_SCORE_DEV)."""
    from yolo_tpu_torch.ops.cuda import conv_s8_kernel
    from yolo_tpu_torch.ops.decode import decode_yolo

    cfg = get_variant("yolov4")
    weights = os.path.join(seeded, "yolov4-seed.weights")
    q, folded, calib_s, calib = int8_calibrated(cfg, weights)
    net = Darknet(cfg.layers, q, device="cuda", dtype=torch.bfloat16)
    images = frames(SEED + 194, V4_INT8_BATCH)
    _, counts = int8_launch_counts(lambda: make_detector(cfg)(net, images))
    check(counts["conv_s8"] == V4_INT8_CONVS and counts["nms"] == 1
          and counts["conv"] == 0 and counts["plain_s8_on_card"] == 0
          and counts["plain_pool_on_card"] == 0,
          f"yolov4 int8 forward launches {counts}")
    x = letterbox(images, cfg.input_hw, dtype=torch.bfloat16)
    blocks = {}
    for args, kw in captured_s8_calls(net, x[:INT8_GATE_BATCH]):
        check(kw.get("pool") is None, "yolov4 fused a pool")
        got = conv_s8_kernel.conv_s8_bias_act(*args, **kw)
        want = plain_s8(args, kw)
        gap = float((got.float() - want.float()).abs().max())
        if got.dtype == torch.int8:
            ok = gap <= 1
        elif kw["act"] in ("leaky", "linear"):
            ok = torch.equal(got, want)
        else:
            ok = bool(((got.float() - want.float()).abs() <= bf16_ulp(
                torch.maximum(got.float().abs(), want.float().abs()))).all())
        check(ok, f"yolov4 s8 call {kw['act']} {tuple(args[1].shape)}: "
              f"kernel and plain {gap} apart")
        key = (kw["act"], str(got.dtype))
        row = blocks.setdefault(key, {"calls": 0, "identical": 0,
                                      "max_gap": 0.0})
        row["calls"] += 1
        row["identical"] += int(torch.equal(got, want))
        row["max_gap"] = max(row["max_gap"], gap)
    net32 = Darknet(cfg.layers, folded, device="cuda", dtype=torch.float32)
    heads = cfg.yolo_heads
    kw = dict(scales=[h.scale_xy for h in heads],
              new_coords=[h.new_coords for h in heads],
              gaussian=[h.gaussian for h in heads])
    masks = [h.mask for h in heads]

    def gates(x01):
        _, s32 = decode_yolo(net32(x01.float()), cfg.anchors, masks,
                             cfg.num_classes, cfg.input_hw, **kw)
        _, s8 = decode_yolo(net(x01.to(torch.bfloat16)), cfg.anchors, masks,
                            cfg.num_classes, cfg.input_hw, **kw)
        return int8_gates(s32, s8)

    # the JAX tests' protocol: the gates on the batch calibrated on
    dev, overlap = gates(calib[:INT8_GATE_BATCH])
    dev_all, overlap_all = gates(x)
    emit({"phase": "int8_yolov4", "batch": V4_INT8_BATCH,
          "calibrate_seconds": calib_s, "launches": counts,
          "kernel_vs_plain_by_act": {f"{a} -> {d}": r for (a, d), r
                                     in sorted(blocks.items())},
          "gate_batch": INT8_GATE_BATCH, "score_dev": dev,
          "jax_score_dev_same_inputs": V4_JAX_SCORE_DEV,
          "top50_overlap": overlap, "score_dev_unseen_batch": dev_all,
          "top50_overlap_unseen_batch": overlap_all,
          "gates": {"top50_overlap": INT8_GATE_OVERLAP}, "card": card})
    check(overlap > INT8_GATE_OVERLAP, f"yolov4 int8 against fp32: "
          f"top-50 overlap {overlap}")
    return {"launches": counts, "dev": dev, "overlap": overlap}


def phase_int8(seeded: str, model, model32, images, ref, gen,
               card: str) -> dict:
    """Phase 19: int8 PTQ of YOLOv2-COCO 416 on phase 4's seeded weights
    -> the kernels line's parts."""
    from yolo_tpu_torch.models import quantize
    from yolo_tpu_torch.ops.decode import decode

    t0 = time.perf_counter()
    cfg = model.cfg
    weights = os.path.join(seeded, "yolov2-coco-seed.weights")
    q, _, calib_s, calib = int8_calibrated(cfg, weights)
    chained = sum("out_scale" in p for p in q)
    net = Darknet(cfg.layers, q, device="cuda", dtype=torch.bfloat16)
    shapes = quantize.conv_shapes(cfg)
    check(sum(shapes.values()) == INT8_CONVS, f"int8 conv shapes {shapes}")
    worst = phase_int8_kernel(gen, shapes)
    t1 = time.perf_counter()

    # (b) the served forward: one s8 launch a conv, one NMS launch
    det = make_detector(cfg)
    cuda_images = torch.from_numpy(images).cuda()
    out, counts = int8_launch_counts(lambda: det(net, cuda_images[:1]))
    check(counts == {"conv_s8": INT8_CONVS, "maxpool_s8": INT8_POOLS,
                     "nms": 1, "conv": 0, "entry": 0, "plain_s8_on_card": 0,
                     "plain_pool_on_card": 0},
          f"int8 forward launches {counts}")
    launches = dict(counts)

    # (c) against the fp32 plain path; the gates as the JAX tests take
    # them, on the batch calibrated on, and on phase 4's frames
    def gates(x01):
        _, s32 = decode(model32.params(x01.float()), cfg.anchors,
                        cfg.num_classes)
        _, s8 = decode(net(x01.to(torch.bfloat16)), cfg.anchors,
                       cfg.num_classes)
        return int8_gates(s32, s8)

    dev, overlap = gates(calib[:INT8_GATE_BATCH])
    x = letterbox(cuda_images, cfg.input_hw, dtype=torch.float32)
    dev_all, overlap_all = gates(x)
    names = cfg.detection_names()
    got = detections_to_json(det(net, cuda_images), names)
    share = {}
    for name, (a, b) in (("fp32_in_int8", (ref, got)),
                         ("int8_in_fp32", (got, ref))):
        hit = tot = 0
        for ai, bi in zip(a, b):
            h, t = match_rate(ai, bi, cfg.conf_threshold)
            hit, tot = hit + h, tot + t
        share[name] = hit / max(tot, 1)
    emit({"phase": "int8", "model": cfg.name, "calibration_frames":
          INT8_CALIB, "calibrate_seconds": calib_s, "chained_convs": chained,
          "launches": counts, "gate_batch": INT8_GATE_BATCH,
          "score_dev": dev, "top50_overlap": overlap,
          "score_dev_6_frames": dev_all, "top50_overlap_6_frames":
          overlap_all, "box_match_share": share,
          "gates": {"score_dev": INT8_GATE_DEV,
                    "top50_overlap": INT8_GATE_OVERLAP}, "card": card})
    check(dev < INT8_GATE_DEV and overlap > INT8_GATE_OVERLAP,
          f"int8 against fp32: score deviation {dev}, top-50 overlap "
          f"{overlap}")

    # (d) card against CPU on the same int8 params, every layer
    xb = x[:INT8_CPU_BATCH].to(torch.bfloat16).permute(0, 3, 1, 2) \
        .contiguous(memory_format=torch.channels_last)
    on_card = net.run(xb, return_all=True)
    cpu = Darknet(cfg.layers, q, device="cpu", dtype=torch.bfloat16)
    on_cpu = cpu.run(xb.cpu(), return_all=True)
    boundaries = sum(t.dtype == torch.int8 for t in on_cpu)
    check(boundaries >= chained and all(
        a.dtype == b.dtype and torch.equal(a.cpu(), b)
        for a, b in zip(on_card, on_cpu)),
        "int8 forward: card and CPU differ at some layer")
    # the fused route (conv 0 and pool 1 in one stem launch): the logits
    check(net.fused_pools == cpu.fused_pools == {0: (2, 2)},
          f"fused pools {net.fused_pools}")
    fused_card, fused_cpu = net.run(xb), cpu.run(xb.cpu())
    check(torch.equal(fused_card.cpu(), fused_cpu)
          and torch.equal(fused_cpu, on_cpu[-1].permute(0, 2, 3, 1).float()),
          "int8 forward on the fused route: card and CPU logits differ")
    emit({"phase": "int8", "what": "card_vs_cpu", "batch": INT8_CPU_BATCH,
          "layers_equal": len(on_cpu), "int8_boundaries": boundaries,
          "fused_pools": {str(k): v for k, v in net.fused_pools.items()},
          "fused_logits_equal": True, "card": card})
    t2 = time.perf_counter()

    # (e) the command line and the server
    cli = int8_cli(seeded, cfg, weights, card)
    for k in ("conv_s8", "maxpool_s8", "nms"):
        launches[k] += cli[k]
    t3 = time.perf_counter()

    # (f) img/s and the kernel's times per shape
    for b in INT8_E2E_BATCHES:
        imgs = frames(SEED + 192 + b, b)
        row = {"phase": "times", "what": "int8_e2e", "batch": b,
               "src_hw": list(SRC_HW), "card": card}
        for route, fn in (
                ("int8", lambda: det(net, imgs)),
                ("bf16", lambda: model(imgs)),
                ("bf16_conv_impl_cuda", lambda: detect_raw(
                    cfg, model.params, imgs, conv_impl="cuda"))):
            ms = cuda_median_ms(fn, reps=5)
            row[f"{route}_ms"], row[f"{route}_img_per_s"] = ms, b * 1000 / ms
        emit(row)
    sums, pool_sums = phase_int8_times(cfg, net, card)
    t4 = time.perf_counter()

    v4 = int8_yolov4(seeded, card)
    for k in ("conv_s8", "maxpool_s8", "nms"):
        launches[k] += v4["launches"][k]
    emit({"phase": "int8", "seconds": time.perf_counter() - t0,
          "kernel_check_seconds": t1 - t0, "forward_seconds": t2 - t1,
          "cli_seconds": t3 - t2, "times_seconds": t4 - t3,
          "yolov4_seconds": time.perf_counter() - t4, "card": card})
    return {"launches": launches, "worst": worst, "ms": sums,
            "pool_ms": pool_sums}


# phase 20: video input and the cv2-free resamplers
VIDEO_FRAMES, VIDEO_FPS = 48, 30.0   # a seeded 640x480 MJPG AVI (SRC_HW)
VIDEO_STRIDE, VIDEO_BATCH = 2, 8     # detect --video --stride --batch
VIDEO_PART_SIZE = 100_000            # --save-video's OpenDML part, lowered
AUG_VARIANT = "yolov4-tiny"          # 416, its VOC-head trainer
AUG_SCENES, AUG_BATCH = 48, 16       # 3 steps an epoch
# yolov4-tiny.cfg's [net] HSV keys; each mode adds its own
AUG_NET_KEYS = "saturation=1.5\nexposure=1.5\nhue=.1\n"
AUG_MODES = {"plain": ("", []), "mosaic": ("mosaic=1\n", []),
             "mixup": ("", ["--mixup"]), "blur": ("blur=1\n", [])}
AUG_HOST_EPOCHS = 2                  # host batches/s over 2 epochs
# darknet19 at 224 with the classifier geometry keys of darknet's
# imagenet cfgs (train --imagefolder)
GEOM_SIZE = 224
GEOM_NET_KEYS = "angle=7\naspect=.75\nmin_crop=224\nmax_crop=448\n"


def video_direct(cfg, net, path: str) -> list:
    """What the raw-frame detector gives the frames `detect --video
    --stride VIDEO_STRIDE` samples, read by the native reader and called
    through detect_raw on the same net and route, in the command's
    rounding."""
    from yolo_tpu_torch.cli.detect_cmds import _det_json
    from yolo_tpu_torch.data.video import video_batches

    names = cfg.detection_names()
    lines = []
    for batch in video_batches(path, VIDEO_BATCH, stride=VIDEO_STRIDE):
        with torch.no_grad():
            out = detect_raw(cfg, net, torch.from_numpy(
                batch["images"]).cuda())
        out = {k: v.cpu().numpy() for k, v in out.items()}
        for bi, idx in enumerate(batch["frames"]):
            keep = np.nonzero(out["valid"][bi])[0]
            lines.append({"frame": idx, "detections": _det_json(
                names, out["classes"][bi], out["scores"][bi],
                out["boxes"][bi][keep].astype(np.float64), keep)})
    return lines


def video_detect(seeded: str, path: str, card: str) -> dict:
    """(b) detect --video through the CLI in this process, bf16 and
    int8: one line a sampled frame, each equal to video_direct on a net
    loaded (and for int8 calibrated on the stream's first 8 sampled
    frames) as the command does; --save-video read back by the port's
    reader; the kernels' launches; detect frames/s of the command and of
    its stream loop alone (reader -> DevicePrefetcher -> detector)."""
    from yolo_tpu_torch.cli._common import _maybe_quantize
    from yolo_tpu_torch.data import video as video_mod
    from yolo_tpu_torch.data.video import AviFile, video_batches

    cfg = get_variant(VARIANT)
    weights = os.path.join(seeded, "yolov2-coco-seed.weights")
    sampled = list(range(0, VIDEO_FRAMES, VIDEO_STRIDE))
    n_batches = -(-len(sampled) // VIDEO_BATCH)
    launches = collections.Counter()
    for precision in ("bf16", "int8"):
        out_path = os.path.join(seeded, f"annotated-{precision}.avi")
        argv = ["detect", "--model", VARIANT, "--weights", weights,
                "--video", path, "--stride", str(VIDEO_STRIDE), "--batch",
                str(VIDEO_BATCH), "--precision", precision, "--save-video",
                out_path]
        part_size = video_mod.PART_SIZE
        if precision == "bf16":   # OpenDML parts of VIDEO_PART_SIZE bytes
            video_mod.PART_SIZE = VIDEO_PART_SIZE
        try:
            (out, err, wall, _), counts = int8_launch_counts(
                lambda: cli_run(argv))
        finally:
            video_mod.PART_SIZE = part_size
        lines = cli_lines(out)
        check([l["frame"] for l in lines] == sampled,
              f"detect --video {precision}: frames "
              f"{[l['frame'] for l in lines]}")
        params = fold_params(cfg.layers, dw.load(weights, cfg.layers)[0],
                             cfg.bn_eps)
        if precision == "int8":
            first = next(video_batches(path, 8, stride=VIDEO_STRIDE,
                                       max_frames=8))
            args = argparse.Namespace(precision="int8", resize="letterbox",
                                      device="cuda")
            params = _maybe_quantize(args, cfg, params,
                                     list(first["images"]))
        net = Darknet(cfg.layers, params, device="cuda",
                      dtype=torch.bfloat16)
        direct = video_direct(cfg, net, path)
        check(lines == direct, f"detect --video {precision}: the printed "
              f"lines differ from detect_raw on the decoded frames")
        want = {"nms": n_batches}
        if precision == "int8":
            want.update(conv_s8=n_batches * INT8_CONVS,
                        maxpool_s8=n_batches * INT8_POOLS,
                        plain_s8_on_card=0, plain_pool_on_card=0)
        check(all(counts[k] == v for k, v in want.items()),
              f"detect --video {precision}: launches {counts}, want {want}")
        for k in ("nms", "conv_s8", "maxpool_s8"):
            launches[k] += counts[k]
        saved = AviFile(out_path)
        check(len(saved.frames) == len(sampled)
              and (saved.height, saved.width) == SRC_HW
              and saved.fps == VIDEO_FPS / VIDEO_STRIDE,
              f"--save-video {precision}: {len(saved.frames)} frames of "
              f"{saved.width}x{saved.height} at {saved.fps} fps")
        check(f"wrote {out_path}" in err, "--save-video did not report")
        with open(out_path, "rb") as f:
            parts = f.read().count(b"RIFF")
        payloads = list(saved.payloads(range(len(saved.frames))))
        check(all(decode_jpeg(p).shape == (*SRC_HW, 3) for p in payloads)
              and (parts >= 3 if precision == "bf16" else parts == 1),
              f"--save-video {precision}: {parts} RIFF parts, "
              f"{len(payloads)} frames read back")

        def stream():
            n = 0
            with DevicePrefetcher(video_batches(
                    path, VIDEO_BATCH, stride=VIDEO_STRIDE), depth=2) as st, \
                    torch.no_grad():
                for batch in st:
                    detect_raw(cfg, net, batch["images"])["valid"].cpu()
                    n += len(batch["frames"])
            return n

        stream()
        t0 = time.perf_counter()
        n = stream()
        loop_s = time.perf_counter() - t0
        emit({"phase": "video", "command": "detect --video",
              "precision": precision, "frames": VIDEO_FRAMES,
              "sampled": len(lines), "stride": VIDEO_STRIDE,
              "batch": VIDEO_BATCH, "src_hw": list(SRC_HW),
              "lines_equal_direct": True, "launches": counts,
              "detections": sum(len(l["detections"]) for l in lines),
              "command_seconds": wall,
              "command_frames_per_s": len(lines) / wall,
              "loop_frames_per_s": n / loop_s,
              "save_video": {"frames": len(saved.frames),
                             "fps": saved.fps, "riff_parts": parts,
                             "part_size": (VIDEO_PART_SIZE
                                           if precision == "bf16" else
                                           video_mod.PART_SIZE)},
              "card": card})
    return launches


def aug_host_rate(cfg, pairs, aug_cfg) -> float:
    """Host batches/s of train_batches (decode, augment, letterbox or
    mosaic, encode) over AUG_HOST_EPOCHS epochs, after one to warm."""
    def epochs(k):
        return sum(1 for _ in host_batches(cfg, pairs, AUG_BATCH, SEED,
                                           epochs=k, augment_cfg=aug_cfg))

    epochs(1)
    t0 = time.perf_counter()
    n = epochs(AUG_HOST_EPOCHS)
    return n / (time.perf_counter() - t0)


def video_train(seeded: str, card: str) -> dict:
    """(c) `train` of yolov4-tiny 416 (VOC heads) from a seeded partial
    file on AUG_SCENES scenes, its cfg's [net] carrying AUG_NET_KEYS and
    each mode's key (mosaic=1, --mixup, blur=1) or none: every step's
    loss finite, and the host pipeline's batches/s of each mode beside
    the plain one (train_batches with the command's AugmentConfig)."""
    from yolo_tpu_torch.configs.darknet_cfg import net_training_params
    from yolo_tpu_torch.data.augment import config_from_net_params

    root = os.path.join(seeded, "aug")
    pairs = write_voc_root(os.path.join(root, "voc"), AUG_SCENES, SEED + 20)
    cfg = voc_heads(get_variant(AUG_VARIANT))
    cutoff, name, _ = YOLO_PARTIALS[AUG_VARIANT]
    partial = write_backbone(cfg, root, cutoff, name)
    rates = {}
    for mode, (keys, flags) in AUG_MODES.items():
        d = os.path.join(root, mode)
        os.makedirs(d)
        cfg_path, names = write_cfg(d, cfg, AUG_NET_KEYS + keys)
        log = os.path.join(d, "train.jsonl")
        _, err, wall, _ = cli_run([
            "train", "--cfg", cfg_path, "--names", names, "--weights",
            partial, "--voc-root", os.path.join(root, "voc"), "--split",
            "train", "--batch", str(AUG_BATCH), "--epochs", "1",
            "--precision", "bf16", "--log-every", "1", "--log-file", log,
            *flags])
        with open(log) as f:
            recs = [r for r in map(json.loads, f) if "loss" in r]
        check(len(recs) == AUG_SCENES // AUG_BATCH
              and all(np.isfinite(r["loss"]) for r in recs),
              f"train {mode}: {len(recs)} steps, losses "
              f"{[r.get('loss') for r in recs]}")
        aug_cfg = config_from_net_params(net_training_params(cfg_path),
                                         mixup="--mixup" in flags)
        check(aug_cfg.mosaic == (mode == "mosaic")
              and aug_cfg.mixup == (mode == "mixup")
              and bool(aug_cfg.blur) == (mode == "blur"),
              f"train {mode}: augmentation {aug_cfg}")
        rates[mode] = aug_host_rate(cfg, pairs, aug_cfg)
        emit({"phase": "video", "command": "train", "mode": mode,
              "model": cfg.name, "input": cfg.input_size,
              "batch": AUG_BATCH, "steps": len(recs),
              "losses": [r["loss"] for r in recs], "seconds": wall,
              "host_batches_per_s": rates[mode],
              "host_vs_plain": rates[mode] / rates["plain"],
              "card": card})
    return rates


def video_classifier(seeded: str, card: str) -> None:
    """(d) `train --imagefolder` of darknet19 at GEOM_SIZE (a
    CLS_TRAIN_CLASSES-way head, seeded weights) with GEOM_NET_KEYS: the
    geometry crop runs (the command says so) and every loss is finite."""
    root = os.path.join(seeded, "geometry")
    samples, names = jpeg_class_folder(os.path.join(root, "images"))
    base = get_variant("darknet19", input_size=GEOM_SIZE)
    cfg = dataclasses.replace(base, name="darknet19-geometry",
                              class_names=names, layers=base.layers[:-3] + (
                                  Conv(CLS_TRAIN_CLASSES, size=1, bn=False,
                                       act="linear"), AvgPool(),
                                  SoftmaxHead()))
    cfg_path, names_path = write_cfg(root, cfg, GEOM_NET_KEYS)
    weights = os.path.join(root, "darknet19-geometry.weights")
    dw.save(weights, cfg.layers, dw.synthetic_detector_params(cfg, SEED))
    log = os.path.join(root, "train.jsonl")
    batch = 8
    _, err, wall, _ = cli_run([
        "train", "--cfg", cfg_path, "--names", names_path, "--weights",
        weights, "--imagefolder", os.path.join(root, "images"), "--batch",
        str(batch), "--epochs", "1", "--log-every", "1", "--log-file", log])
    with open(log) as f:
        recs = [r for r in map(json.loads, f) if "loss" in r]
    steps = -(-len(samples) // batch)
    check("scale/rotation crops" in err, "train --imagefolder: the "
          "classifier geometry crop is not on")
    check(len(recs) == steps and all(np.isfinite(r["loss"]) for r in recs),
          f"train --imagefolder: {len(recs)} of {steps} steps, losses "
          f"{[r.get('loss') for r in recs]}")
    emit({"phase": "video", "command": "train --imagefolder",
          "model": cfg.name, "input": GEOM_SIZE, "net_keys":
          GEOM_NET_KEYS.split(), "batch": batch, "steps": len(recs),
          "losses": [r["loss"] for r in recs], "seconds": wall,
          "card": card})


def phase_video(seeded: str, card: str) -> dict:
    """Phase 20: (a) a seeded VIDEO_FRAMES-frame 640x480 MJPG AVI
    written by the port's writer (data/synthetic.py write_video); the
    native reader's decode frames/s; (b) video_detect; (c) video_train;
    (d) video_classifier. Returns the launches of (b)."""
    from yolo_tpu_torch.data.synthetic import write_video
    from yolo_tpu_torch.data.video import video_batches, video_info

    t0 = time.perf_counter()
    path = os.path.join(seeded, "scenes.avi")
    write_video(path, VIDEO_FRAMES, *SRC_HW, fps=VIDEO_FPS, seed=SEED + 20)
    info = video_info(path)
    check(info == {"fps": VIDEO_FPS, "width": SRC_HW[1],
                   "height": SRC_HW[0], "frames": VIDEO_FRAMES},
          f"video_info {info}")
    rates = []
    for _ in range(3):
        t = time.perf_counter()
        n = sum(len(b["frames"]) for b in video_batches(path, VIDEO_BATCH))
        rates.append(n / (time.perf_counter() - t))
    emit({"phase": "video", "what": "decode", "frames": VIDEO_FRAMES,
          "src_hw": list(SRC_HW), "batch": VIDEO_BATCH,
          "frames_per_s": statistics.median(rates),
          "host_cores": os.cpu_count(), "card": card})
    t1 = time.perf_counter()
    launches = video_detect(seeded, path, card)
    t2 = time.perf_counter()
    rates = video_train(seeded, card)
    t3 = time.perf_counter()
    video_classifier(seeded, card)
    emit({"phase": "video", "seconds": time.perf_counter() - t0,
          "detect_seconds": t2 - t1, "train_seconds": t3 - t2,
          "classifier_seconds": time.perf_counter() - t3,
          "host_batches_per_s": rates, "card": card})
    return launches


def dp_detect(model, model32, card: str) -> dict:
    """Phase 21 (a): make_dp_detector over make_mesh() (this card) and
    over DP_REPLICAS (two replicas on it) at DP_BATCH raw frames, bf16
    and fp32, on the default route and conv_impl="cuda": each shard
    launches the NMS kernel once and the conv kernel ROUTE_CONVS times
    (on conv_impl="cuda"), counts set to 0 just before and read just
    after; fp32 detections equal make_detector's on each shard's frames
    within tests/test_parallel.py's rtol 1e-4 / atol 1e-5 (cuDNN picks
    its conv algorithms by batch size: a batch of 16 sums otherwise than
    one of 32), and agree at phase 4's box level with make_detector's on
    the whole batch, bf16 and fp32; img/s of both meshes beside
    make_detector's."""
    cfg = model.cfg
    names, conf = cfg.detection_names(), cfg.conf_threshold
    x = frames(SEED + 21, DP_BATCH)
    meshes = {"this_card": make_mesh(), "two_replicas": make_mesh(
        devices=DP_REPLICAS)}
    check(len(meshes["this_card"]) == torch.cuda.device_count(),
          f"make_mesh() over {meshes['this_card']}")
    launches = {"nms": 0, "conv": 0}
    rows = []
    for net, precision in ((model32.params, "fp32"), (model.params, "bf16")):
        for route, kw, n_conv in (("default", {}, 0),
                                  ("conv_impl=cuda", {"conv_impl": "cuda"},
                                   ROUTE_CONVS)):
            whole = detect_raw(cfg, net, x, **kw)
            for tag, mesh in meshes.items():
                # make_detector on each shard's frames: cuDNN picks its
                # conv algorithms by batch size, so only same-shaped
                # calls compare exactly; the whole batch at box level
                rows_ = DP_BATCH // len(mesh)
                want = {k: torch.cat([
                    detect_raw(cfg, net, x[i:i + rows_], **kw)[k]
                    for i in range(0, DP_BATCH, rows_)]) for k in whole}
                fn = make_dp_detector(cfg, mesh, **kw)
                reps, shards = replicate(mesh, net), shard_batch(mesh, x)
                conv_kernel.launches = nms_kernel.launches = 0
                out = fn(reps, shards)
                torch.cuda.synchronize()
                got = (conv_kernel.launches, nms_kernel.launches)
                what = f"dp {tag} {route} {precision}"
                check(got == (n_conv * len(mesh), len(mesh)),
                      f"{what}: (conv, NMS) launches {got}, want "
                      f"{(n_conv * len(mesh), len(mesh))}")
                launches["conv"] += got[0]
                launches["nms"] += got[1]
                check(tuple(out["boxes"].shape) == (DP_BATCH, 100, 4)
                      and out["boxes"].device == torch.device("cuda", 0),
                      f"{what}: boxes {tuple(out['boxes'].shape)} on "
                      f"{out['boxes'].device}")
                row = {"mesh": tag, "devices": len(mesh), "route": route,
                       "precision": precision, "conv_launches": got[0],
                       "nms_launches": got[1]}
                if precision == "fp32":
                    err = {}
                    for key in ("boxes", "scores", "classes", "valid"):
                        a = out[key].float().cpu().numpy()
                        b = want[key].float().cpu().numpy()
                        check(np.allclose(a, b, rtol=1e-4, atol=1e-5),
                              f"{what}: {key} differs from make_detector's "
                              f"on the shards' frames by "
                              f"{np.abs(a - b).max()}")
                        err[key] = float(np.abs(a - b).max())
                    row["max_abs_diff_vs_make_detector_per_shard"] = err
                row["vs_make_detector_whole_batch"] = check_agree(
                    detections_to_json(whole, names),
                    detections_to_json(out, names), conf, what)
                rows.append(row)
    # img/s at DP_BATCH, bf16, default route
    net = model.params
    det = make_detector(cfg)
    rates = {}
    for tag, fn, args in (
            ("make_detector", det, (net, x)),
            *((f"dp_{t}", make_dp_detector(cfg, m),
               (replicate(m, net), shard_batch(m, x)))
              for t, m in meshes.items())):
        fn(*args)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(DP_TIMED):
            fn(*args)
        torch.cuda.synchronize()
        rates[tag] = DP_BATCH * DP_TIMED / (time.perf_counter() - t0)
    emit({"phase": "parallel", "check": "dp_detector", "model": cfg.name,
          "batch": DP_BATCH, "rows": rows, "img_per_s_bf16": rates,
          "card": card})
    return launches


def dp_serve(model, card: str) -> dict:
    """Phase 21 (b): DetectionServer(mesh=two replicas on this card) at
    max_batch 2 answers DP_HTTP concurrent requests: every answer equals
    a direct call (a device call is at most 2 frames, one a shard, as a
    direct call's batch of one), /stats' buckets are multiples of 2."""
    cfg = model.cfg
    names = cfg.detection_names()
    images = np.random.default_rng(SEED + 22).integers(
        0, 256, (DP_HTTP, *SRC_HW, 3), dtype=np.uint8)
    server = DetectionServer(cfg, model.params, port=0, max_batch=2,
                             mesh=make_mesh(devices=DP_REPLICAS))
    server.start()
    try:
        nms_kernel.launches = 0
        with cf.ThreadPoolExecutor(DP_HTTP) as pool:
            answers = list(pool.map(lambda im: post_npy(server.port, im),
                                    images))
        launches = nms_kernel.launches
        conn = http.client.HTTPConnection("127.0.0.1", server.port,
                                          timeout=60)
        conn.request("GET", "/stats")
        stats = json.loads(conn.getresponse().read())
        conn.close()
    finally:
        server.stop()
    direct = [detections_to_json(model(images[i:i + 1]), names)[0]
              for i in range(DP_HTTP)]
    check(answers == direct, "a --dp server's answer differs from the "
          "direct call")
    check(stats["errors"] == 0 and stats["requests"] == DP_HTTP
          and stats["buckets"] and all(int(k) % 2 == 0
                                       for k in stats["buckets"]),
          f"--dp server stats {stats}")
    check(launches == 2 * sum(stats["buckets"].values()),
          f"{launches} NMS launches for buckets {stats['buckets']}")
    emit({"phase": "parallel", "check": "serve_dp", "requests": DP_HTTP,
          "buckets": stats["buckets"], "nms_launches": launches,
          "answers_equal_direct": True,
          "detections_per_image": [len(d) for d in direct], "card": card})
    return {"nms": launches, "conv": 0}


def dp_step_close(params, a, b, noise, what: str) -> dict:
    """Phase 21 (c): state a's step against state b's, both from params.
    A step's fp32 sums in another order move the updates of the BN
    gammas and betas (small differences of large sums) by up to ~1% and
    more (relative L2): ``noise`` is that distance for the single step
    on the batch with its rows reordered (reordered_step), the loss
    unchanged. The trained tensors' largest update error must stay
    within DP_NOISE_FACTOR of it (or within STEP_BOUND), the rolling
    statistics' within STAT_BOUND; printed beside them, the share of
    elements within rtol 1e-4 / atol 1e-6 and the worst element."""
    pa, pb = a.net.to_numpy(), b.net.to_numpy()
    upd = update_err(params, pa, pb, {"kernel", "gamma", "beta", "bias"})
    stat = update_err(params, pa, pb, {"mean", "var"})
    check(upd[0] <= max(DP_NOISE_FACTOR * noise[0], STEP_BOUND)
          and stat[0] <= STAT_BOUND,
          f"{what}: update {upd} (reordered single step {noise}), "
          f"statistics {stat} against {STAT_BOUND}")
    worst, close, total = (0.0, ""), 0, 0
    for i, (p, q) in enumerate(zip(pa, pb)):
        for k in p:
            ok = np.isclose(p[k], q[k], rtol=1e-4, atol=1e-6)
            close, total = close + int(ok.sum()), total + ok.size
            worst = max(worst, (float(np.abs(p[k] - q[k]).max()),
                                f"{i}.{k}"))
    return {"update_rel_l2": upd, "statistics_rel_l2": stat,
            "share_within_rtol_1e-4_atol_1e-6": close / total,
            "max_abs_diff": worst}


def dp_train(tmp: str, card: str) -> dict:
    """Phase 21 (c): one fp32 YOLOv2-VOC step (TF32 off) at
    DP_TRAIN_BATCH with grad_accum DP_ACCUM on the two-replica mesh, and
    through an NCCL group of one joined by maybe_init_distributed
    (torchrun's variables set in this process), against
    make_train_step's on the whole batch: the loss to a relative 1e-5,
    the updates as close as the same step's on reordered rows
    (dp_step_close)."""
    import socket

    import torch.distributed as dist

    cfg = get_variant(TRAIN_VARIANT)
    tcfg = TrainConfig(learning_rate=1e-3, momentum=0.9,
                       weight_decay=5e-4, grad_accum=DP_ACCUM,
                       loss=region_loss_config(cfg))
    params = fine_tune_init(cfg, tmp)
    pairs = write_voc_root(os.path.join(tmp, "dp_voc"), DP_TRAIN_BATCH,
                           SEED + 23)
    host = next(host_batches(cfg, pairs, DP_TRAIN_BATCH, SEED + 23,
                             augment_cfg=NET_AUGMENT))
    single = init_state(cfg, params, tcfg, device="cuda")
    m1 = make_train_step(cfg, tcfg)(
        single, {k: torch.from_numpy(v).cuda() for k, v in host.items()})
    # the yardstick: the same step with the rows reordered within each
    # sub-batch (rows i::DP_ACCUM stay sub-batch i), the same loss in
    # other orders of summation
    order = np.arange(DP_TRAIN_BATCH).reshape(-1, DP_ACCUM)[::-1].reshape(-1)
    reordered = init_state(cfg, params, tcfg, device="cuda")
    m0 = make_train_step(cfg, tcfg)(
        reordered, {k: torch.from_numpy(v[order]).cuda()
                    for k, v in host.items()})
    check(abs(float(m0["loss"]) - float(m1["loss"]))
          <= 1e-5 * abs(float(m1["loss"])), "the reordered step's loss")
    noise = update_err(params, reordered.net.to_numpy(),
                       single.net.to_numpy(),
                       {"kernel", "gamma", "beta", "bias"})
    mesh = make_mesh(devices=DP_REPLICAS)
    out = {"reordered_single_step": {
        "loss": float(m0["loss"]),
        **dp_step_close(params, reordered, single, noise, "reordered")}}
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    env = {"RANK": "0", "WORLD_SIZE": "1", "MASTER_ADDR": "127.0.0.1",
           "MASTER_PORT": str(port), "LOCAL_RANK": "0"}
    for tag in ("two_replicas", "nccl_group_of_one"):
        if tag == "nccl_group_of_one":
            saved = {k: os.environ.get(k) for k in env}
            os.environ.update(env)
            check(maybe_init_distributed() and dist.get_backend() == "nccl"
                  and dist.get_world_size() == 1,
                  "maybe_init_distributed did not join an NCCL group")
        try:
            dp = init_state(cfg, params, tcfg, device="cuda")
            m2 = make_dp_train_step(cfg, tcfg, mesh)(
                dp, shard_batch(mesh, host))
        finally:
            if tag == "nccl_group_of_one":
                dist.destroy_process_group()
                for k, v in saved.items():
                    if v is None:
                        os.environ.pop(k, None)
                    else:
                        os.environ[k] = v
        loss1, loss2 = float(m1["loss"]), float(m2["loss"])
        check(abs(loss2 - loss1) <= 1e-5 * abs(loss1),
              f"{tag}: loss {loss2} against {loss1}")
        check(dp.seen == single.seen == DP_TRAIN_BATCH and dp.step == 1,
              f"{tag}: seen {dp.seen} step {dp.step}")
        out[tag] = {"loss": loss2, "single_loss": loss1,
                    **dp_step_close(params, dp, single, noise, tag)}
    emit({"phase": "parallel", "check": "dp_train_step", "model": cfg.name,
          "precision": "fp32, TF32 off", "batch": DP_TRAIN_BATCH,
          "grad_accum": DP_ACCUM, "mesh": list(DP_REPLICAS), **out,
          "card": card})


def grain_cli(tmp: str, card: str) -> None:
    """Phase 21 (d): `train --loader grain --loader-workers
    GRAIN_WORKERS` on YOLOv2-VOC 416 over GRAIN_SCENES seeded scenes,
    two epochs of two steps, a checkpoint (and its .grain position) at
    step 2: stopped there (--fail-after-step 2) and --resume'd, steps 3-4
    log the losses of the uninterrupted run (cuDNN made deterministic for
    both), and a loader restored from step_2.grain gives the batches the
    uninterrupted loader gave at pulls 3-4, byte for byte; the grain
    loader's batches/s beside train_batches' on the same scenes."""
    from yolo_tpu_torch.data.augment import config_from_net_params
    from yolo_tpu_torch.data.grain_pipeline import grain_train_batches
    from yolo_tpu_torch.data.voc import list_split

    cfg = get_variant(TRAIN_VARIANT)
    root = os.path.join(tmp, "grain_voc")
    write_voc_root(root, GRAIN_SCENES, SEED + 24)
    backbone = write_backbone(cfg, tmp)
    steps = 2 * GRAIN_SCENES // GRAIN_BATCH

    def argv(ck, log):
        return ["train", "--model", TRAIN_VARIANT, "--weights", backbone,
                "--voc-root", root, "--split", "train", "--batch",
                str(GRAIN_BATCH), "--epochs", "2", "--augment", "--loader",
                "grain", "--loader-workers", str(GRAIN_WORKERS),
                "--checkpoint-every", "2", "--log-every", "1",
                "--checkpoint-dir", ck, "--log-file", log]

    def losses(log):
        with open(log) as f:
            return {r["step"]: r["loss"] for r in map(json.loads, f)
                    if "loss" in r}

    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        full_log, res_log = (os.path.join(tmp, f) for f in ("g.jsonl",
                                                            "gr.jsonl"))
        full_ck, res_ck = (os.path.join(tmp, d) for d in ("gck", "gck_r"))
        _, _, wall, _ = cli_run(argv(full_ck, full_log))
        try:
            cli_run(argv(res_ck, os.path.join(tmp, "g0.jsonl"))
                    + ["--fail-after-step", "2"])
            check(False, "--fail-after-step 2 did not stop the run")
        except SystemExit as e:
            check("fail-after-step" in str(e), f"the stopped run: {e}")
        grain_file = os.path.join(res_ck, "step_2.grain")
        check(os.path.exists(grain_file), "no step_2.grain beside step_2")
        _, err, wall_r, _ = cli_run(argv(res_ck, res_log) + [
            "--resume", os.path.join(res_ck, "step_2")])
        check("restored grain data-iterator position" in err,
              "train --resume did not restore the grain position")
    finally:
        torch.backends.cudnn.deterministic = deterministic
    full, res = losses(full_log), losses(res_log)
    check(sorted(full) == list(range(1, steps + 1))
          and sorted(res) == [3, 4] and all(res[k] == full[k] for k in res),
          f"resumed losses {res} against {full}")

    # the batches: the command's loader, uninterrupted and restored
    pairs = list_split(root, "train")
    kw = dict(class_names=cfg.class_names, anchors=cfg.anchors,
              num_classes=cfg.num_classes, net_size=cfg.input_hw,
              batch_size=GRAIN_BATCH, seed=0, num_epochs=2,
              worker_count=GRAIN_WORKERS, model_cfg=cfg,
              augment_cfg=config_from_net_params({}, force_defaults=True))
    it = grain_train_batches(pairs, **kw)
    t0 = time.perf_counter()
    first = next(it)
    t1 = time.perf_counter()
    first_s = t1 - t0
    want = [first] + [next(it) for _ in range(steps - 1)]
    grain_rate = (steps - 1) / (time.perf_counter() - t1)
    it.close()
    again = grain_train_batches(pairs, **kw)
    with open(grain_file, "rb") as f:
        again.set_state(f.read())
    got = [next(again) for _ in range(steps - 2)]
    again.close()
    for g, w in zip(got, want[2:]):
        check(set(g) == set(w) and all(np.array_equal(g[k], w[k])
                                       for k in g),
              "a restored grain loader's batch differs")
    threads = host_batches(cfg, pairs, GRAIN_BATCH, 0, epochs=2,
                           augment_cfg=kw["augment_cfg"])
    next(threads)
    t2 = time.perf_counter()
    n = sum(1 for _ in threads)
    threads_rate = n / (time.perf_counter() - t2)
    emit({"phase": "parallel", "check": "train_loader_grain",
          "model": cfg.name, "batch": GRAIN_BATCH, "steps": steps,
          "loader_workers": GRAIN_WORKERS, "losses": full,
          "resumed_losses": res, "seconds": wall, "resume_seconds": wall_r,
          "grain_first_batch_s": first_s,
          "grain_batches_per_s": grain_rate,
          "threads_batches_per_s": threads_rate,
          "threads_workers": PIPELINE_WORKERS, "host_cores": os.cpu_count(),
          "card": card})


def letterbox_rates(card: str) -> None:
    """Phase 21 (e): ms a 480x640 frame letterboxed to 416 on the host,
    native/letterbox.c (letterbox_batch) against the torch letterbox
    that data/pipeline.py::_host_resize ran before it (ops/letterbox.py
    in fp32), on one thread and on 8 (a batch of LETTERBOX_FRAMES; the
    torch one on a pool of 8 workers); the two agree within 5e-6.
    Phase 14 (d)'s files-to-boxes ran with the C letterbox."""
    rng = np.random.default_rng(SEED + 25)
    batch = np.stack([coco_scene(rng, *SRC_HW)[0]
                      for _ in range(LETTERBOX_FRAMES)])

    def torch_lb(img):
        return letterbox(torch.from_numpy(img)[None], 416,
                         dtype=torch.float32)[0].numpy()

    c_out = letterbox_batch(batch, 416, n_threads=8)
    check(all(np.abs(c_out[i] - torch_lb(batch[i])).max() <= 5e-6
              for i in range(0, LETTERBOX_FRAMES, 8)),
          "the C letterbox is not within 5e-6 of the torch one")
    one = {"c": host_ms(lambda: letterbox_batch(batch[:1], 416,
                                                n_threads=1)),
           "torch": host_ms(lambda: torch_lb(batch[0]))}

    def torch_pool():
        with _Pool(8) as pool:
            list(pool.map(torch_lb, batch))

    runs = {"c": lambda: letterbox_batch(batch, 416, n_threads=8),
            "torch": torch_pool}
    eight = {"c": [], "torch": []}
    for tag in ("c", "torch", "c", "torch"):
        runs[tag]()
        t0 = time.perf_counter()
        runs[tag]()
        eight[tag].append((time.perf_counter() - t0) * 1e3
                          / LETTERBOX_FRAMES)
    emit({"phase": "parallel", "check": "host_letterbox",
          "src_hw": list(SRC_HW), "net": 416,
          "ms_per_frame_one_thread": one,
          "ms_per_frame_8_threads": {k: min(v) for k, v in eight.items()},
          "frames": LETTERBOX_FRAMES, "host_cores": os.cpu_count(),
          "card": card})


def phase_parallel(model, model32, card: str) -> dict:
    """Phase 21: data parallelism, the grain loader and the host
    letterbox; returns the NMS and conv kernels' launches of (a)-(b)."""
    t0 = time.perf_counter()
    launches = dp_detect(model, model32, card)
    served = dp_serve(model, card)
    launches["nms"] += served["nms"]
    with tempfile.TemporaryDirectory() as tmp:
        dp_train(tmp, card)
        grain_cli(tmp, card)
    letterbox_rates(card)
    emit({"phase": "parallel", "seconds": time.perf_counter() - t0,
          **launches, "card": card})
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this run "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 2
    # the seeded .weights files of phases 4 and 12, read again in 15
    with tempfile.TemporaryDirectory() as seeded:
        return run(seeded)


def run(seeded: str) -> int:
    card = nvidia_smi()
    emit({"phase": "device", "nvidia_smi": card, "torch": torch.__version__,
          "cuda": torch.version.cuda, "kind": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count()})

    t0 = time.perf_counter()
    native_lib, cc_s = native_build.build()
    native_build.library()
    emit({"phase": "build", "what": "host C library (native/*.c)",
          "seconds": time.perf_counter() - t0, "cc_seconds": cc_s,
          "library": os.path.relpath(native_lib, os.path.dirname(
              os.path.abspath(__file__)))})
    t0 = time.perf_counter()
    lib, compile_s = build.build()
    build.library()
    hgmma = hgmma_counts(lib)
    usage = {n: u for n, u in resource_usage(lib).items()
             if n.startswith(("conv_f32_kernel", "nms_suppress_kernel",
                              "conv_s8_", "maxpool_s8_kernel"))}
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "nvcc_seconds": compile_s,
          "library": os.path.relpath(lib, os.path.dirname(
              os.path.abspath(__file__))), "hgmma": hgmma,
          "resources": usage})
    bf16_wgmma = [n for n in hgmma if n.startswith("conv_bf16_kernel")]
    s8_wgmma = [n for n in hgmma if n.startswith("conv_s8_wgmma_kernel")]
    check(len(bf16_wgmma) == BF16_WGMMA_KERNELS
          and len(s8_wgmma) == S8_WGMMA_KERNELS
          and all(hgmma[n] > 0 for n in bf16_wgmma + s8_wgmma),
          f"the bf16 and s8 wgmma conv kernels must run on wgmma "
          f"(HGMMA / IGMMA): {hgmma}")
    check(any(n.startswith("conv_f32_kernel") for n in usage)
          and "nms_suppress_kernel" in usage
          and all(any(n.startswith(k) for n in usage)
                  for k in ("conv_s8_mma_kernel", "conv_s8_stem_kernel",
                            "conv_s8_wgmma_kernel", "maxpool_s8_kernel"))
          and all(u["registers"] > 0 and u["stack"] == 0 and u["local"] == 0
                  for u in usage.values()),
          f"the fp32 conv, NMS, s8 conv and int8 pool kernels must not "
          f"spill: {usage}")

    rng = np.random.default_rng(SEED)
    timeline, mark = {}, [STARTED]

    def lap(name: str) -> None:
        """Wall seconds since the previous lap, recorded under name."""
        now = time.perf_counter()
        timeline[name] = now - mark[0]
        mark[0] = now

    lap("start, build")
    worst = phase_kernel(rng)

    weights = os.path.join(seeded, "yolov2-coco-seed.weights")
    seeded_coco_weights(get_variant(VARIANT), weights)
    launches, model, model32, images, ref = phase_serve(weights)

    timed = phase_times(rng, model, card)

    shapes = eligible_conv_shapes(model.cfg)
    check(sum(shapes.values()) == ROUTE_CONVS and len(shapes) == 8,
          f"eligible conv shapes {shapes}")
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    conv_worst = phase_conv(gen, shapes)
    entry_images = torch.from_numpy(rng.integers(
        0, 256, (CONV_BATCHES[0], *SRC_HW, 3), dtype=np.uint8)).cuda()
    entry_worst = phase_entry(gen, entry_images)
    route_launches = phase_routes(model, model32,
                                  torch.from_numpy(images).cuda(), ref)
    timed_images = torch.from_numpy(rng.integers(
        0, 256, (TIMED_BATCH, *SRC_HW, 3), dtype=np.uint8)).cuda()
    kernel_times = phase_kernel_times(gen, shapes, timed_images, card)
    phase_route_times(model, model32, card)
    lap("1-9 kernels, serve, routes, times")

    voc_launches, eval_grid = phase_fine_tune(card)
    lap("10-11 fine-tune, eval")

    t0 = time.perf_counter()
    yolo_launches, kept = phase_yolo_serve(seeded, card)
    yolo_worst, yolo_shapes = phase_yolo_conv(gen, card)
    phase_yolo_times(kept, card)
    del kept
    t1 = time.perf_counter()
    yolo_eval_launches = phase_yolo_train(card)
    emit({"phase": "yolo", "serve_seconds": t1 - t0,
          "train_seconds": time.perf_counter() - t1})
    lap("12-13 yolo")

    t0 = time.perf_counter()
    check(get_decoder() == "native", f"decoder {get_decoder()}")
    phase_fixtures()
    fixture_launches = phase_fixture_detect(weights, card)
    format_launches = phase_format_detect(weights, card)
    phase_decode_rates(card)
    coco_launches, coco_grid, coco_shape, coco = phase_coco(
        card, os.path.join(seeded, "coco"))
    emit({"phase": "images", "seconds": time.perf_counter() - t0})
    lap("14 images")

    cfg_run = phase_cfg(gen, {
        v: os.path.join(seeded, "yolov2-coco-seed.weights" if v == VARIANT
                        else f"{v}-seed.weights") for v in CFG_ROUND_TRIP},
        card)
    lap("15 cfg")

    cli_launches = phase_cli(seeded, coco, card)
    lap("16 cli")

    tree = phase_tree(os.path.join(seeded, "tree"), coco["paths"], gen,
                      card)
    lap("17 tree")

    v1 = phase_yolov1(os.path.join(seeded, "yolov1"), gen, card)
    lap("18 yolov1")

    int8 = phase_int8(seeded, model, model32, images, ref, gen, card)
    lap("19 int8")

    video = phase_video(seeded, card)
    lap("20 video")

    dp = phase_parallel(model, model32, card)
    lap("21 parallel")

    foreign = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "yolo_tpu", "cv2",
                                            "grain"))
    check(not foreign, f"the port loaded JAX, the JAX package, OpenCV or "
          f"grain: {foreign}")
    # each kernel's launches on the main path, by the phase that drove
    # them (the timeline's names); the kernels line sums them
    by_phase = {
        "nms_suppress": {
            "1-9 kernels, serve, routes, times": launches,
            "10-11 fine-tune, eval": voc_launches,
            "12-13 yolo": yolo_launches["nms"] + yolo_eval_launches,
            "14 images": fixture_launches + format_launches["nms"]
            + coco_launches["nms"],
            "15 cfg": cfg_run["launches"]["nms"],
            "16 cli": cli_launches["nms"],
            "17 tree": tree["launches"]["nms"],
            "18 yolov1": v1["launches"]["nms"],
            "19 int8": int8["launches"]["nms"],
            "20 video": video["nms"], "21 parallel": dp["nms"]},
        "conv_bias_act": {
            "1-9 kernels, serve, routes, times": route_launches["conv"],
            "12-13 yolo": yolo_launches["conv"],
            "14 images": coco_launches["conv"] + format_launches["conv"],
            "15 cfg": cfg_run["launches"]["conv"],
            "17 tree": tree["launches"]["conv"],
            "18 yolov1": v1["launches"]["conv"], "21 parallel": dp["conv"]},
        "entry_conv_pool": {
            "1-9 kernels, serve, routes, times": route_launches["entry"]},
        "conv_s8_bias_act": {"19 int8": int8["launches"]["conv_s8"],
                             "20 video": video["conv_s8"]},
        "maxpool_s8": {"19 int8": int8["launches"]["maxpool_s8"],
                       "20 video": video["maxpool_s8"]}}
    emit({"phase": "timeline", "seconds": timeline, "launches": by_phase})
    emit({"phase": "total", "seconds": time.perf_counter() - STARTED})
    total = {k: sum(v.values()) for k, v in by_phase.items()}
    nms = timed[TIMED_SHAPE]
    conv_t = kernel_times["conv"]
    conv32 = kernel_times["conv_fp32"]
    entry_t = kernel_times["entry"]
    emit({"kernels": [
        {"name": "nms_suppress", "route": "cuda",
         "source": "yolo_tpu_torch/csrc/nms_suppress.cu",
         "replaces": "yolo_tpu/ops/pallas/nms_kernel.py:86",
         "launches": total["nms_suppress"],
         "max_abs_err": worst,
         "ms": nms[0], "plain_ms": nms[1], "bound_ms": nms[2],
         "bound_by": nms[3], "library_ms": None,
         "eval_grid": [EVAL_BATCH * 20, 5, 128], "eval_grid_ms": eval_grid[0],
         "eval_grid_plain_ms": eval_grid[1],
         "eval_grid_bound_ms": eval_grid[2],
         "eval_grid_bound_by": eval_grid[3],
         "coco_eval_grid": coco_shape, "coco_eval_grid_ms": coco_grid[0],
         "coco_eval_grid_plain_ms": coco_grid[1],
         "coco_eval_grid_bound_ms": coco_grid[2],
         "coco_eval_grid_bound_by": coco_grid[3],
         "eval_grid_9k": tree["shape"], "eval_grid_9k_ms": tree["grid"][0],
         "eval_grid_9k_plain_ms": tree["grid"][1],
         "eval_grid_9k_bound_ms": tree["grid"][2],
         "eval_grid_9k_bound_by": tree["grid"][3],
         "tree_head_grid_ms": tree["head_grids"]["traversal"][0],
         "tree_head_grid_plain_ms": tree["head_grids"]["traversal"][1],
         "tree_head_grid_bound_ms": tree["head_grids"]["traversal"][2],
         "yolov1_grid": v1["shape"], "yolov1_grid_ms": v1["grid"][0],
         "yolov1_grid_plain_ms": v1["grid"][1],
         "yolov1_grid_bound_ms": v1["grid"][2],
         "yolov1_grid_bound_by": v1["grid"][3]},
        {"name": "conv_bias_act", "route": "cuda",
         "source": "yolo_tpu_torch/csrc/conv_bias_act.cu",
         "replaces": "yolo_tpu/ops/pallas/conv_kernel.py:91",
         "launches": total["conv_bias_act"],
         "max_abs_err": max(conv_worst, yolo_worst, cfg_run["worst"],
                            tree["conv_worst"], v1["conv_worst"]),
         "ms": conv_t[0], "plain_ms": conv_t[1], "bound_ms": conv_t[3],
         "bound_by": conv_t[4], "library_ms": conv_t[2],
         "fp32_ms": conv32[0], "fp32_plain_ms": conv32[1],
         "fp32_library_ms": conv32[2], "fp32_bound_ms": conv32[3],
         "yolo_shapes": len(yolo_shapes),
         "rect_shapes": cfg_run["shapes"],
         "rect_ms": cfg_run["rect_bf16"][0],
         "rect_plain_ms": cfg_run["rect_bf16"][1],
         "rect_library_ms": cfg_run["rect_bf16"][2],
         "rect_bound_ms": cfg_run["rect_bf16"][3],
         "yolo9000_convs": tree["convs"], "yolo9000_ms": tree["conv_ms"][0],
         "yolo9000_plain_ms": tree["conv_ms"][1],
         "yolo9000_library_ms": tree["conv_ms"][2],
         "yolo9000_bound_ms": tree["conv_ms"][3],
         "yolov1_convs": v1["convs"], "yolov1_ms": v1["conv_ms"][0],
         "yolov1_plain_ms": v1["conv_ms"][1],
         "yolov1_library_ms": v1["conv_ms"][2],
         "yolov1_bound_ms": v1["conv_ms"][3]},
        {"name": "entry_conv_pool", "route": "cuda",
         "source": "yolo_tpu_torch/csrc/entry_conv_pool.cu",
         "replaces": "yolo_tpu/ops/pallas/entry_kernel.py:92",
         "launches": total["entry_conv_pool"], "max_abs_err": entry_worst,
         "ms": entry_t[0], "plain_ms": entry_t[1], "bound_ms": entry_t[2],
         "bound_by": entry_t[3], "library_ms": None},
        {"name": "conv_s8_bias_act", "route": "cuda",
         "source": "yolo_tpu_torch/csrc/conv_s8_bias_act.cu",
         "replaces": "yolo_tpu/models/quantize.py:234",
         "launches": total["conv_s8_bias_act"],
         "max_abs_err": int8["worst"],
         "ms": int8["ms"][TIMED_BATCH][0],
         "plain_ms": int8["ms"][TIMED_BATCH][1],
         "bound_ms": int8["ms"][TIMED_BATCH][3],
         "bound_by": int8["ms"][TIMED_BATCH][4],
         "library_ms": int8["ms"][TIMED_BATCH][2],
         "library": "torch._int_mm on each conv's GEMM operands (im2col'd)",
         "convs": INT8_CONVS, "batch": TIMED_BATCH,
         "batch1_ms": int8["ms"][1][0], "batch1_plain_ms": int8["ms"][1][1],
         "batch1_bound_ms": int8["ms"][1][3],
         "batch1_library_ms": int8["ms"][1][2]},
        {"name": "maxpool_s8", "route": "cuda",
         "source": "yolo_tpu_torch/csrc/maxpool_s8.cu",
         "replaces": "yolo_tpu/ops/pool.py:17",
         "launches": total["maxpool_s8"],
         "max_abs_err": int8["worst"],
         "ms": int8["pool_ms"][TIMED_BATCH][0],
         "plain_ms": int8["pool_ms"][TIMED_BATCH][1],
         "bound_ms": int8["pool_ms"][TIMED_BATCH][2],
         "bound_by": "bytes", "library_ms": None,
         "library": "none: no int8 max_pool2d on the card",
         "pools": INT8_POOLS, "batch": TIMED_BATCH,
         "batch1_ms": int8["pool_ms"][1][0],
         "batch1_plain_ms": int8["pool_ms"][1][1],
         "batch1_bound_ms": int8["pool_ms"][1][2]}]})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
