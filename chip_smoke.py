#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (heltondetection_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit, no result line) when it
fails:

1. the card's name and power limit, from nvidia-smi;
2. build every CUDA kernel of csrc/ (nms_fixpoint, nms_mask, iou_matrix),
   all nvcc processes at once;
3. hold each kernel against its plain PyTorch version on the card:
   - the NMS keep masks exactly (a bitmask: no tolerance): nms_fixpoint and
     nms_mask on random boxes at B=8 N=1024, on class-offset boxes with
     zeroed padding rows, on a 1024-deep suppression chain, on identical
     boxes (one kept per image) and on boxes that do not overlap (all
     kept); nms_fixpoint also at B=1, at B=64 (its clusters run in waves)
     and at the largest N its shared memory allows (2400 on an H100; one
     more word must raise), with its build alone holding as many bits as
     the plain suppression matrix; nms_mask also at N=2048, and the two
     kernels against each other on one input;
   - iou_matrix within 1 ulp (bit equality is expected), both of its
     stores: the float4 store (M a multiple of 4) at (1024, 8192), at a
     ragged (1000, 25200) whose zero-area rows must give exact zeros, at
     N = 1 and at the tall narrow (65536, 128); the float store at
     M % 4 = 1, 2 and 3 ((1000, 25201), (63, 130), (257, 1023)) and M = 1;
     N not a multiple of the 16-row tile in most of them;
4. the main path, a full-width YOLOv5s (80 classes, 640², bf16, random
   weights from seed 0), driven through four paths, each with the launch
   counts reset just before and read just after:
   a. serve: six frames of mixed sizes in two requests through
      make_packed_serve_step + Detector; nms_fixpoint must launch. The dets
      must be finite, inside their frames, and equal to the dets of the
      plain NMS on the same candidates; the f32 network must match its CPU
      run on a small input (TF32 off);
   b. eval: 64 seeded frames of mixed sizes, letterboxed to 640², with
      seeded ground truth, in batches of 32 through the port's Evaluator,
      on the unfused route (forward_for_eval + make_postprocess; nms_mask
      must launch) and on the packed route (step_fn=make_packed_serve_step;
      nms_fixpoint must launch). On the unfused route's candidates, the
      dets and COCO stats through the kernel must equal those of
      batched_nms on CPU copies. Gt boxes painted into raw head maps
      through the decode inverse must score AP > 0.99 through nms_mask,
      with and without a letterbox inverse. Random weights score AP near 0
      on the noise frames; the point there is the path, not the score;
   c. iou: the public op ops.boxes.iou_matrix at (1024, 25200); iou_matrix
      must launch (its production callers, FasterRCNN's two assigners,
      are driven in phase 4h);
   d. serving: the seed-0 weights are written with save_eval_variables
      beside a config file in a temporary directory. load_detector(config
      file, ckpt=dir) must give the dets of a Detector built by hand from
      the same weights and settings on phase 4a's frames.
      load_detector(..., tta=True) on 8 frames of mixed sizes must launch
      nms_fixpoint three times (one per view), its dets finite and inside
      their frames, and the fusion on the card must equal
      weighted_boxes_fusion on CPU copies of the views' dets (boxes within
      1e-3 px, scores within 1e-6, classes and valid exactly).
      BatchingDetector(batch_size=16, batch_buckets=(4, 16)) after
      warmup(): 8 client threads send 16 frames each through submit, every
      future must resolve within a timeout to exactly what
      Detector.detect_batch gives that frame at one of the two bucket
      sizes; the stats must add up, nms_fixpoint must launch once per
      batch, close() must return True. The HTTP front end answers
      /healthz (no image decoder is promised on the card's machine);
   e. train: a full-width YOLOv5s (80 classes, 640², bf16 compute over f32
      master weights, batch 16, lr 1e-3, mosaic 0.5, HSV, flip 0.5, affine,
      EMA) on in-memory datasets made from a seed (64 train and 32 val
      frames of mixed sizes, 375×500 to 1080×1920, uint8 noise with 2–8
      filled rectangles of one colour per class), no image decoder needed:
      - run_train's inner function (train_from_datasets) in a temporary
        work dir, 2 epochs × 4 steps with the launch counts reset before:
        every epoch's metrics finite, the in-loop eval after each epoch
        launching nms_fixpoint, train_state.pt and eval_variables.pt at
        step 8 and best.json written; then epochs=3 must resume at step 8
        and train exactly one more epoch (steps 9–12), and
        load_detector(config, ckpt=work dir) must give the dets of a
        Detector built from the EMA weights in train_state.pt;
      - the loss falls: 30 steps of make_train_step on one fixed batch of
        16 (augmentation off, 3 warmup steps): the mean total of the last
        5 at most LOSS_FALL_RATIO (0.5) times that of the first 5;
      - the card equals the CPU: one train step of a narrow f32 model
        (width 0.25, 128², B=2, TF32 off) on the card and on CPU copies:
        metrics within 1e-4 relative (the f32 network's logits on the card
        and the CPU differ by up to 4e-5 of their largest, phase 4a, so a
        loss term can differ by a few 1e-5); each gradient tensor within 1e-4 of
        the global gradient norm and 3e-3 of its own norm (the CPU alone,
        one thread against eight, differs by 2.3e-5 and 5.3e-4: BatchNorm's
        backward over two images sums terms that cancel); BN running
        statistics within 5e-5 (relative, at least 1 absolute);
   f. every YOLOv5 config (from PR 6):
      1. the published yolov5_s_visdrone_1280 (YOLOv5s, 10 classes,
         1280², B=16, lr 1e-3, mosaic 0.5, bf16) with train.device_aug and
         train.autoanchor on, through run_train and the VisDrone reader on
         annotation files written to a temporary directory (32 train and
         16 val frames of 1080×1920 and 765×1360, 20–60 objects of 2–60 px,
         ignored regions and "others" rows; the frames stay in memory and
         the reader's imread_rgb is replaced by a lookup by path), 2 epochs
         × 2 steps: metrics finite, the in-loop eval launching nms_fixpoint
         after each epoch over 16 string image ids with the ignore regions
         in its DetEval, the refit anchors equal to check_anchors' on the
         same labels and served by load_detector (its dets equal a
         Detector's with those anchors and differ from the default
         anchors'); device_augment_batch on one batch of 16 on the card
         equal to its CPU run on the same draws (pixels within 1e-5, boxes
         within 1e-4 px, classes and masks exactly); then the 1280² step's
         ms, idle share and peak memory with device_aug's ms inside it,
         and DeviceAugPipeline's host img/s against TrainPipeline's (1280²,
         mosaic 0.5, 8 threads);
      2. the published yolov5_s_coco_640_dropblock (DropBlock 0.5, B=16):
         one step with model.remat off and one with it on from the same
         state and DropBlock draws: the loss within 1e-5 relative, every
         gradient within 1e-4 of the global gradient norm, BatchNorm
         running statistics and counts equal; drop_block on the card equal
         to its CPU run on the same uniform draws (masks exactly, values
         within 1e-6); both steps' ms and peak memory;
      3. the fused serve step above nms_fixpoint's largest N
         (pre_nms_topk=2401, 8 frames at 640²): nms_mask must launch and
         nms_fixpoint must not, and the dets must equal the plain NMS's
         on the same candidates;
   g. FasterRCNN inference (from PR 7), each path with the counts reset
      just before and read just after:
      1. the published faster_rcnn_pafpn_decoupled_coco_832 (ResNet50,
         PAFPNv8(256), RPN, RoIAlign over P2-P5, decoupled head, 80
         classes, 832², bf16, B=8), random weights from seed 0 with the
         four predictor layers scaled on the first batch so that scores
         are distinct and unsaturated: faster_rcnn_infer must launch
         nms_mask 6 times (5 RPN levels, the final NMS) and nothing else,
         its dets finite and equal to those of the same features through
         the plain nms_mask_seq on the card; the Evaluator over 32 seeded
         frames of mixed sizes (4 batches of 8, single-label) must launch
         nms_mask 7 times a batch with stats equal to the plain route's;
         load_detector(a written config file, ckpt dir) must give a
         hand-built Detector's dets (7 launches a batch); a
         BatchingDetector (batch 8, buckets (2, 8)) under 4 clients x 8
         frames must resolve every request to the dets of detect_batch at
         one of the bucket sizes, 7 launches a batch; a narrow float32
         FasterRCNN (ResNet18, 256², B=2, TF32 off) on the card must
         equal its CPU run: pyramid and RPN logits within RCNN_F32_REL of
         their largest, dets matched one to one (class, scores within
         RCNN_SCORE_TOL, boxes within RCNN_BOX_TOL px);
      2. the published faster_rcnn_fpnp2_roipool_voc_832 (FPN, coupled
         head, RoIPool on P2 alone), one batch of 8: 6 launches, dets
         equal to the plain NMS's;
      3. nms_mask past its 16 register slots, N = 16448 and 20000 (B=2,
         the scan's words in shared memory) through the fused route:
         masks equal to nms_mask_seq's on the card; its largest N on
         this card;
      4. the eval step at B=8 by CUDA events (ms, img/s), its device-busy
         time, idle share and top 8 kernels from torch.profiler, peak
         memory, the parts (trunk, RPN head, proposals, RoIAlign with its
         device time and bytes bound, box head, final dets) and the conv
         and dense FLOPs counted from their shapes, on a {"rcnn": ...}
         line;
   h. FasterRCNN training, each path with the counts reset
      just before and read just after:
      1. the published faster_rcnn_pafpn_decoupled_coco_832 (B=16, 832²,
         bf16 over float32 weights, AdamW 2e-4, mosaic 0.5, EMA) through
         train_from_datasets on in-memory frames (32 train, 16 val, as 4e
         makes them), 2 epochs x 2 steps in a temporary work dir: every
         epoch's metrics finite, nms_mask launched 5 times a step (the
         proposals, one a level) and 7 times an eval batch of the in-loop
         eval, iou_matrix 2 x 16 times a step (both assigners, one an
         image), nms_fixpoint never; then epochs=3 must resume at step 4
         and train steps 5-6 with the same counts a step, the checkpoint
         holding the sampling generator's state; load_detector(config,
         ckpt=work dir) must give the dets of a Detector built from the
         EMA weights in train_state.pt;
      2. the loss falls: 30 steps of make_rcnn_train_step on one fixed
         batch of 16 (augmentation off, the same draws each step, the
         backbone trained whole: norm_eval off, no frozen stage, AdamW
         1e-3): the mean total of the last 5 at most LOSS_FALL_RATIO (0.5)
         times that of the first 5;
      3. the card equals the CPU: a narrow float32 FasterRCNN (ResNet18,
         256², B=2, 20 classes, TF32 off) on the same draws: the RPN
         assignment and the box head's on the same proposals exactly
         equal (box targets within 1e-5 of their largest); one train
         step each, the card's on the CPU step's proposals (an NMS over
         boxes that differ by rounding may keep another one, and the
         second stage would sample another roi; the card's own
         proposals are compared and reported apart): metrics within
         1e-4 relative, each gradient within 1e-4 of the global norm and
         3e-3 of its own, BatchNorm statistics within 5e-5;
      4. iou_matrix at the RPN assigner's shape (172887 anchors of 832² x
         128 gts) within 1 ulp of box_iou_matrix, its time beside its
         bytes bound;
      5. the train step at B=16 by CUDA events (ms, img/s), its device-
         busy time, idle share and top 8 kernels from torch.profiler, peak
         memory, its parts by CUDA events (trunk forward, proposals, the
         two assigners, the sparse RPN loss, RoIAlign forward, the box head
         and its loss, the backward, optimizer + EMA; RoIAlign's backward
         alone) and its FLOPs counted from the conv and dense shapes with
         their share of the bf16 peak, on a {"rcnn_train": ...} line;
   i. export, run_test and the eval artifacts, each path with
      the counts reset just before and read just after:
      1. export_model of yolov5_s_coco_640 (phase 4a's seed-0 weights;
         test.conf_thres 0.001, so random weights give dets) and of
         faster_rcnn_pafpn_decoupled_coco_832 (seed 0, predictors scaled)
         to .pt2 files in a temporary directory under runs/, each loaded
         with load_serving_fn and run on 3 seeded uint8 frames at B=1:
         dets bit-equal to the eager serving function's on the card,
         nms_mask launched 1 and 6 times a call and nothing else; the
         export's and the load's seconds, and ms a call by CUDA events of
         the loaded program and of the eager function, in turns, with the
         device ms and kernel launches of one call of each (profiler);
      2. run_test of both configs (the same weights written as
         checkpoints) on an in-memory frame (readers.imread_rgb swapped for
         a lookup) with out_path=None, since the rendered frame needs cv2:
         dets finite and inside the frame, nms_fixpoint launched for
         YOLOv5 (nms_mask not), nms_mask 7 times for FasterRCNN
         (faster_rcnn_infer's 6 and the single-label postprocess); then
         _save_heatmap_panels writes the panels with the port's PNG
         writer: one panel of the image's size a level (3 x 640, 5 x 832),
         the class-score panel's generate_proposals launching nms_mask 5
         times;
      3. run_eval(dump_json=..., verbose=True) of yolov5_s_coco_640 over 64
         frames whose forward is swapped for phase 4b's painted raw maps
         (the unfused route): AP > 0.99, the JSON as long as the dets and
         its category ids mapped back, the classwise table and the FLOPs
         line logged and, with no matplotlib, the rendering-unavailable
         line; the native matcher built and called; the Evaluator's img/s
         over phase 4b's 64 frames with the native matcher and with the
         numpy one in turns, three each (with its summarize, where the
         matching runs, and without), the same stats; YOLOv5s's counted GFLOPs at 640²
         within 5 % of the 16.5 Ultralytics publishes for v6.1;
      4. each kernel by CUDA events through its torch.library op and
         through its ctypes wrapper, in turns, at the kernel table's
         shapes;
   j. W8A8 int8 serving (ops/quant.py), each path with the counts reset
      just before and read just after:
      1. yolov5_s_coco_640 (phase 4a's model): calibrated on 32 seeded
         frames letterboxed to 640², the "balanced" per-layer tree and the
         flow tree; make_packed_serve_step(quant=...) at B=32 in both
         modes must launch nms_fixpoint once and give finite dets;
         int8_conv2d (torch._int_mm on an im2col) must equal
         int8_conv2d_plain (float64 conv) int32 bit for bit at every
         distinct conv shape of both steps; card against CPU, each
         quantized conv of both modes, fed the card's own input on 2
         frames, must quantize to the same int8 codes and sum to the same
         int32 on the CPU; end to end on a float32 copy of the model, the
         float step's dets must match the CPU's (2 px, 0.02, at most 5 %
         unmatched) and the int8 step's are recorded (random weights
         amplify one moved code into other dets); then ms a step int8
         (both modes) against
         bf16 by CUDA events in turns, the device ms and kernels of a
         step, calibration and tree-build s, and per distinct shape
         int8_conv2d, its _int_mm alone and the bf16 cuDNN conv by CUDA
         events and their kernels by name (profiler), beside the shape's
         bound (int8 tensor-core peak or bytes);
      2. faster_rcnn_pafpn_decoupled_coco_832 (seed 0, predictors
         scaled): quantize_rcnn on 32 frames, faster_rcnn_infer of the
         int8 copy at B=8 must launch nms_mask 6 times, its dets equal
         the plain NMS's (plain_nms()), its int8 products equal the plain
         version's; ms int8 against float in turns;
      3. the int8 entry points of both configs (the val set 32 seeded
         frames in memory, swapped in for build_dataset; no image decoder
         on the card's machine): run_eval with eval.int8 twice (the second
         call loads the cached tree: one calibration in all), then
         load_detector with test.int8 and a BatchingDetector over it (its
         dets those of detect_batch), run_test of an in-memory frame,
         export_model with test.int8, whose loaded .pt2 must give the
         eager int8 serving function's dets bit for bit and launch
         nms_mask 1 (YOLOv5) or 6 (FasterRCNN) times a call;
      4. ops/letterbox.letterbox_image on the card against the CPU
         (downscale, upscale, 1:1; uint8 within one grey level, float32
         within 1e-3) with equal letterbox parameters;
   k. the native loader and run_train's two hooks (run after phase 5, so
      that its profiler session precedes none of phase 5's):
      1. (run with phase 2's builds, before any train path asks for the
         library) g++'s version, whether <opencv2/imgproc.hpp> and
         <jpeglib.h> compile, and the build of native/loader_core.cpp
         (seconds or the compiler's error). Missing headers: the loader is
         recorded as not buildable on this machine and the run goes on
         (training and eval take the Python pipelines, and say why in the
         log); headers present and the build failing fails the run;
      2. only where it built: NativeTrainPipeline against TrainPipeline at
         640² and NativeDeviceAugPipeline against DeviceAugPipeline at
         1280² (phase 4f.1's frame sizes), host img/s over 3 batches of 16
         with 8 workers, in turns; each native batch equal bit for bit to
         the same pipeline's on a one-thread pool; then a two-step
         train_from_datasets of yolov5_s_coco_640 and of
         faster_rcnn_pafpn_decoupled_coco_832 (B=16) on the native loader
         with the in-loop eval, the launch counts reset before each and
         read after (nms_fixpoint; nms_mask and iou_matrix), and each
         run's loader-wait share;
      3. yolov5_s_coco_640 (B=16, two steps, no val set) through
         train_from_datasets three times: plain (its loader choice must
         match 4k.1's build), with HELTON_PROFILE_DIR (the trace must name
         CUDA kernels; its size and the run's time against the plain
         run's are recorded), and with HELTON_DEBUG_NANS and a NaN in the
         stem's weight, which must raise FloatingPointError naming epoch 0
         and step 0 or 1 and leave anomaly mode off;
5. times on the card: each kernel through its wrapper by CUDA events over
   back-to-back calls (host launch cost included), its device time by
   kernel name from torch.profiler, and its plain version, beside the
   kernel's bound: nms_fixpoint at B=1, 8, 32 and 64 N=1024, with its build
   timed alone (a build-only instance), so scan = whole - build; nms_mask
   at B=32 N=1024 and B=8 N=2048, its build and scan kernels read apart by
   name; iou_matrix at (1024, 25200) and (65536, 128). Then the serve step at B=32 with its
   breakdown, the unfused eval step's breakdown (CUDA events around each
   part, and the profiler's device-busy time, idle share and top kernels
   of each step), and eval images/s (host accumulate included) on both
   routes at B=32; TTA per batch of 8 and of 32 with WBF's share (CUDA
   events and the host clock), and the BatchingDetector's img/s, mean
   fill and request latency at 8 clients. Phase 4e adds the train step at
   B=16 (CUDA events: ms, img/s; forward, loss, backward and optimizer +
   EMA apart), its device-busy time, idle share and top kernels from
   torch.profiler, torch.cuda.max_memory_allocated, its FLOPs counted from
   the conv and matmul shapes by forward hooks and the share of the H100's
   dense bf16 peak (989 TFLOP/s) they reach, the host pipeline's img/s at
   640² with mosaic, the share of run_train's epochs spent waiting for the
   loader and the in-loop eval's img/s. No single PyTorch call
   computes greedy NMS or a pairwise IoU matrix (there is no torchvision),
   so library_ms is null for every kernel.

The lines before the last are the serve, eval, serving, train,
train_configs, rcnn, rcnn_train, export_test_artifacts, int8 and
native_loader lines, the
kernels line, {"kernels": [...]} (nms_fixpoint's entry counts the in-loop
evals' launches as launches_train_eval and
launches_train_eval_visdrone_1280 and run_test's as
launches_run_test_yolov5, nms_mask's the fused route's above N=2400 as
launches_fused_route_n2401, FasterRCNN's as launches_rcnn_infer,
launches_rcnn_eval and launches_rcnn_train, the exported programs' per call
and run_test's, the int8 infer's and int8 exports' as launches_int8_rcnn
and launches_int8_export, with its largest N; nms_fixpoint's the int8
serve steps' as launches_int8_serve; iou_matrix's FasterRCNN training
launches as launches_rcnn_train and its times at the assigner's shape as
rcnn_assigner; each entry's op_ms the time through its custom op and
through its wrapper; launches_native_loader_run_train the launches of
phase 4k.2's runs, null where the loader core did not build), and the
card's nvidia-smi line; the last line is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import subprocess
import sys
import time

import numpy as np

# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s and non-tensor f32 FLOP/s
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
NMS_OPS_PER_PAIR = 14   # min, max x4, sub x2, mul, add x2, sub, mul, cmp
IOU_OPS_PER_PAIR = 13   # min, max x4, sub x2, mul, add, sub, add, div
ROOT = os.path.dirname(os.path.abspath(__file__))
NO_LIBRARY = ("no single PyTorch call computes it (greedy NMS and the "
              "pairwise IoU matrix are torchvision ops, and there is no "
              "torchvision)")


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    if not out:
        raise RuntimeError("nvidia-smi reported no GPU")
    return out[0]


def sorted_boxes(rng, b, n, size=640.0):
    """(b, n, 4) random xyxy boxes, each image's rows in score order."""
    xy = rng.uniform(0, size * 0.8, (b, n, 2))
    wh = rng.uniform(4, size * 0.3, (b, n, 2))
    return np.concatenate([xy, xy + wh], -1).astype(np.float32)


def class_offset_boxes(rng, b, n, n_pad, num_classes=80):
    """Class-offset boxes as the NMS entries build them, with the last
    n_pad rows zeroed (inert padding)."""
    boxes = sorted_boxes(rng, b, n)
    cls = rng.integers(0, num_classes, (b, n, 1)).astype(np.float32)
    boxes = boxes + cls * np.float32(8192.0)
    boxes[:, n - n_pad:] = 0.0
    return boxes


def chain_boxes(n):
    """n-deep alternating chain: box i suppresses only box i+1 at 0.65."""
    i = np.arange(n, dtype=np.float32)
    return np.stack([i * 2.0, np.zeros(n), i * 2.0 + 10.0,
                     np.full(n, 10.0)], -1).astype(np.float32)[None]


def identical_boxes(b, n):
    """Every row the same box: only row 0 of each image is kept."""
    return np.tile(np.array([10.0, 20.0, 110.0, 90.0], np.float32),
                   (b, n, 1))


def disjoint_boxes(b, n):
    """Boxes on a grid, none touching another: every row is kept."""
    i = np.arange(n, dtype=np.float32)
    x, y = (i % 64) * 20.0, (i // 64) * 20.0
    one = np.stack([x, y, x + 10.0, y + 10.0], -1).astype(np.float32)
    return np.broadcast_to(one, (b, n, 4)).copy()


def cuda_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean ms of fn() over iters runs, by CUDA events after warmup."""
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def profiled_ms(fn, iters: int, names) -> dict:
    """Device ms per call of fn() of each kernel whose name holds one of
    names, from torch.profiler's key_averages() over iters calls after one
    warm-up call; None where the trace shows no such kernel."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    out = dict.fromkeys(names)
    for evt in prof.key_averages():
        for name in names:
            if name in evt.key and evt.device_time_total > 0:
                out[name] = (out[name] or 0.0) + \
                    evt.device_time_total / iters / 1e3
    return out


def device_kernels(fn, iters: int) -> list:
    """[(name, device ms per call), ...] of every kernel, copy and fill
    that fn() runs on the card, most time first, from torch.profiler over
    iters calls after one warm-up call. The GPU-side ranges of annotations
    (``Optimizer.step#AdamW.step``) span kernels listed on their own, so
    they are left out."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    rows = [(evt.key, evt.device_time_total / iters / 1e3)
            for evt in prof.key_averages()
            if str(evt.device_type).endswith("CUDA")
            and not getattr(evt, "is_user_annotation", False)
            and not evt.key.startswith(("Optimizer.", "ProfilerStep"))]
    return sorted(rows, key=lambda r: -r[1])


def device_busy_ms(fn) -> float:
    """Device ms of everything one call of fn() runs on the card, from a
    CUDA-only torch.profiler trace (no host events: cheap enough for a call
    of tens of thousands of launches)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(evt.device_time_total for evt in prof.key_averages()) / 1e3


def device_work(fn) -> tuple:
    """(device ms, kernels launched) of one call of fn(), from a CUDA-only
    torch.profiler trace."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    evts = [e for e in prof.key_averages()
            if str(e.device_type).endswith("CUDA")]
    return (sum(e.device_time_total for e in evts) / 1e3,
            sum(e.count for e in evts))


def nms_bound_ms(b: int, n: int) -> tuple:
    """Least time for the keep mask of (b, n, 4) boxes: bytes (boxes read,
    mask written) over HBM rate, pairwise tests over the f32 rate."""
    t_bytes = (b * n * 16 + b * n) / HBM_BYTES_PER_S
    t_ops = b * n * (n - 1) / 2 * NMS_OPS_PER_PAIR / F32_FLOP_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes > t_ops else "operations")


def iou_bound_ms(n: int, m: int) -> tuple:
    """Least time for the (n, m) IoU matrix: both box sets read and the f32
    matrix written over HBM rate, the pairwise ops over the f32 rate."""
    t_bytes = (4 * n * m + 16 * (n + m)) / HBM_BYTES_PER_S
    t_ops = n * m * IOU_OPS_PER_PAIR / F32_FLOP_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes > t_ops else "operations")


def max_ulp(a, b) -> int:
    """Largest distance in float32 ulps between two non-negative tensors
    (+0.0 folds -0.0 onto +0.0)."""
    import torch
    ia = (a.float() + 0.0).view(torch.int32).long()
    ib = (b.float() + 0.0).view(torch.int32).long()
    return int((ia - ib).abs().max())


def _logit(p: float) -> float:
    return float(np.log(p / (1 - p)))


def paint_raw_maps(gts_cxcywh, classes, img_size, nc):
    """Raw YOLOv5 head maps (numpy, one image) that decode to the given gt
    boxes: each box goes to the level and anchor nearest its shape,
    through the inverse of the v6.1 decode."""
    from heltondetection_tpu_torch.ops.anchors import (YOLOV5_ANCHORS,
                                                       YOLOV5_STRIDES)
    raws = [np.full((1, img_size // s, img_size // s, 3 * (5 + nc)), -12.0,
                    np.float32) for s in YOLOV5_STRIDES]
    for (cx, cy, w, h), c in zip(gts_cxcywh, classes):
        best = None
        for lvl, anchors in enumerate(YOLOV5_ANCHORS):
            for ai, (aw, ah) in enumerate(anchors):
                if w < 4 * aw and h < 4 * ah:
                    err = abs(np.log(w / aw)) + abs(np.log(h / ah))
                    if best is None or err < best[0]:
                        best = (err, lvl, ai, aw, ah)
        _, lvl, ai, aw, ah = best
        stride = YOLOV5_STRIDES[lvl]
        gx, gy = int(cx / stride), int(cy / stride)
        sig = [(cx / stride - gx + 0.5) / 2.0, (cy / stride - gy + 0.5) / 2.0,
               np.sqrt(w / aw) / 2.0, np.sqrt(h / ah) / 2.0]
        if not all(0 < s_ < 1 for s_ in sig):
            raise ValueError(f"gt {(cx, cy, w, h)} cannot be painted")
        base = ai * (5 + nc)
        raws[lvl][0, gy, gx, base:base + 5] = [_logit(s_) for s_ in sig] + [9.0]
        raws[lvl][0, gy, gx, base + 5 + int(c)] = 9.0
    return raws


def eval_batches(rng, n_frames, batch, img_size, letterbox_np):
    """Seeded frames of mixed sizes (uint8 noise), letterboxed to
    img_size², in batches for the Evaluator, and their seeded gt as
    (img_id, boxes xywh, classes) in source coordinates."""
    sizes = [(480, 640), (720, 1280), (640, 640), (375, 500), (1080, 1920),
             (640, 427), (512, 512), (300, 400)]
    batches, gts = [], []
    for start in range(0, n_frames, batch):
        imgs, ids, scales, pxs, pys, hws = [], [], [], [], [], []
        for k in range(start, min(start + batch, n_frames)):
            h, w = sizes[k % len(sizes)]
            frame = rng.integers(0, 256, (h, w, 3)).astype(np.uint8)
            n_gt = int(rng.integers(2, 9))
            wh = rng.uniform(0.03, 0.5, (n_gt, 2)) * [w, h]
            xy = rng.uniform(0, 1, (n_gt, 2)) * ([w, h] - wh)
            gts.append((k, np.concatenate([xy, wh], 1),
                        rng.integers(0, 80, n_gt)))
            lb, _, meta = letterbox_np(frame, np.zeros((0, 4), np.float32),
                                       img_size)
            imgs.append(lb)
            ids.append(k)
            scales.append(meta["scale"])
            pxs.append(meta["pad_x"])
            pys.append(meta["pad_y"])
            hws.append((h, w))
        batches.append({"image": np.stack(imgs), "img_id": ids,
                        "scale": scales, "pad_x": pxs, "pad_y": pys,
                        "orig_hw": hws})
    return batches, gts


# the gt boxes (cx, cy, w, h at 640²) and classes that phases 4b and 4i.3
# paint into raw head maps
PAINTED_GTS = [(100.0, 120.0, 60.0, 80.0), (320.0, 300.0, 200.0, 150.0),
               (500.0, 520.0, 24.0, 30.0), (200.0, 450.0, 300.0, 260.0),
               (560.0, 90.0, 90.0, 60.0), (420.0, 600.0, 12.0, 16.0)]
PAINTED_CLS = [0, 17, 42, 79, 5, 63]


SMOKE_CONFIG = """\
from heltondetection_tpu_torch.configs.base import (ExperimentConfig,
                                                    ModelConfig, TestConfig)

config = ExperimentConfig(
    name="chip_smoke",
    model=ModelConfig(family="yolov5", variant="s", num_classes=80,
                      img_size=640, dtype="bfloat16"),
    test=TestConfig(conf_thres=0.001, iou_thres=0.65))
"""


def check_dets(frame, dets, num_classes=80) -> int:
    """Dets of one frame are finite, inside it and in range; returns their
    count."""
    boxes, scores, classes = dets
    h, w = frame.shape[:2]
    if not (np.isfinite(boxes).all() and np.isfinite(scores).all()):
        raise AssertionError("non-finite dets")
    if ((boxes[:, [0, 2]] < 0).any() or (boxes[:, [0, 2]] > w).any()
            or (boxes[:, [1, 3]] < 0).any() or (boxes[:, [1, 3]] > h).any()):
        raise AssertionError("dets outside their frame")
    if ((scores <= 0) | (scores > 1)).any() or \
            ((classes < 0) | (classes >= num_classes)).any():
        raise AssertionError("scores or classes out of range")
    return len(scores)


def same_dets(a, b) -> bool:
    return all(x.shape == y.shape and np.array_equal(x, y)
               for x, y in zip(a, b))


def client_load(batcher, frames, n_clients, per_client, timeout=120.0):
    """n_clients threads, each sending per_client frames one after the
    other through submit and waiting for each answer. Returns
    ([(frame index, dets)], [latency s], wall s); a request that does not
    resolve within the timeout fails the run."""
    import threading
    results, latencies, errors = [], [], []
    lock = threading.Lock()

    def client(k):
        try:
            for j in range(per_client):
                idx = (k * per_client + j) % len(frames)
                t0 = time.perf_counter()
                dets = batcher.submit(frames[idx]).result(timeout=timeout)
                dt = time.perf_counter() - t0
                with lock:
                    results.append((idx, dets))
                    latencies.append(dt)
        except Exception as e:              # raised again by the caller
            with lock:
                errors.append(e)

    threads = [threading.Thread(target=client, args=(k,), daemon=True)
               for k in range(n_clients)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout * per_client)
    wall = time.perf_counter() - t0
    if errors:
        raise errors[0]
    if any(t.is_alive() for t in threads) or \
            len(results) != n_clients * per_client:
        raise AssertionError(f"only {len(results)} of "
                             f"{n_clients * per_client} requests resolved")
    return results, latencies, wall


BF16_FLOP_PER_S = 989e12     # H100 SXM dense bf16 tensor-core peak
LOSS_FALL_RATIO = 0.5        # last-5 mean total / first-5 mean total, at most
TRAIN_SIZES = [(375, 500), (480, 640), (720, 1280), (1080, 1920), (640, 640),
               (640, 427), (512, 512), (300, 400)]


class SynthFrames:
    """An in-memory reader (the interface of data/readers.py's): seeded
    uint8 noise frames of mixed sizes, each with 2–8 filled rectangles, one
    colour per class, as its boxes. No image decoder is needed."""

    def __init__(self, n: int, seed: int, num_classes: int = 80,
                 sizes=None):
        rng = np.random.default_rng(seed)
        sizes = sizes or TRAIN_SIZES
        self.num_classes = num_classes
        self.label_to_cat = {i: i for i in range(num_classes)}
        palette = rng.integers(0, 256, (num_classes, 3)).astype(np.uint8)
        self.frames = []
        for i in range(n):
            h, w = sizes[i % len(sizes)]
            img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
            k = int(rng.integers(2, 9))
            wh = rng.uniform(0.05, 0.45, (k, 2)) * [w, h]
            xy = rng.uniform(0, 1, (k, 2)) * ([w, h] - wh)
            boxes = np.concatenate([xy, xy + wh], 1).astype(np.float32)
            cls = rng.integers(0, num_classes, k).astype(np.int32)
            for (x1, y1, x2, y2), c in zip(boxes.astype(int), cls):
                img[y1:y2, x1:x2] = palette[c]
            self.frames.append((img, boxes, cls))

    def __len__(self):
        return len(self.frames)

    def load(self, i):
        img, boxes, cls = self.frames[i]
        return {"image": img, "boxes": boxes, "classes": cls,
                "iscrowd": np.zeros(len(cls), np.int32), "img_id": i,
                "file": f"{i}.png"}

    def gt_for_eval(self, det_eval):
        for i, (_, b, c) in enumerate(self.frames):
            det_eval.add_gt(i, np.concatenate([b[:, :2], b[:, 2:] - b[:, :2]],
                                              1), c)


class LogRecords:
    """Collects the port logger's records (the runner's epoch and eval
    stats ride on them as ``extra`` fields)."""

    def __init__(self):
        import logging
        self.records = []
        self.logger = logging.getLogger("heltondetection_tpu_torch")
        self.handler = logging.Handler()
        self.handler.emit = self.records.append
        self.logger.addHandler(self.handler)

    def field(self, name):
        return [getattr(r, name) for r in self.records if hasattr(r, name)]

    def close(self):
        self.logger.removeHandler(self.handler)


def train_flops(model, batch, loss_cfg):
    """Multiply-adds ×2 of one train step's forward, counted from shapes:
    every conv by a forward hook on its ConvBnAct (2·B·Ho·Wo·Cout·Cin/g·k²),
    the packed head's objectness matmul (2·B·HW·cin·A per level) and the
    loss's candidate GEMM (2·B·M·O·cin·A·CP per level). The backward is
    counted as twice the forward (a gradient for the input and one for the
    weight), so a step is 3× the forward."""
    import torch
    from heltondetection_tpu_torch.models.common import ConvBnAct
    from heltondetection_tpu_torch.models.yolov5 import packed_cls_width
    flops = {"conv": 0, "head": 0}

    def conv_hook(mod, inp, out):
        c = mod.conv
        k = c.kernel_size[0] * c.kernel_size[1]
        flops["conv"] += 2 * out.numel() * (c.in_channels // c.groups) * k

    def head_hook(mod, inp, outs):
        m = batch["gt_boxes"].shape[1]
        for pobj, f2, wblocks, _ in outs:
            b, hw, cin = f2.shape
            a = pobj.shape[-1]
            flops["head"] += 2 * b * hw * cin * a
            flops["head"] += 2 * b * m * 3 * cin * a * packed_cls_width(
                loss_cfg.num_classes)

    hooks = [m.register_forward_hook(conv_hook) for m in model.modules()
             if isinstance(m, ConvBnAct)]
    hooks.append(model.register_forward_hook(head_hook))
    try:
        with torch.no_grad():
            model(batch["image"].float() / 255.0)
    finally:
        for h in hooks:
            h.remove()
    fwd = flops["conv"] + flops["head"]
    return {"forward_flops": fwd, "conv_flops": flops["conv"],
            "head_flops": flops["head"], "step_flops": 3 * fwd}


TRAIN_CONFIG = dict(name="chip_train", variant="s", num_classes=80,
                    img_size=640, dtype="bfloat16", batch_size=16, lr=1e-3,
                    mosaic_p=0.5, flip_p=0.5)


def train_phase(dev, smi: str) -> dict:
    """Phase 4e: run_train end to end, the loss falling, the card against
    the CPU, and the train step's times. Returns the train JSON fields and
    the in-loop eval's nms_fixpoint launches."""
    import copy
    import tempfile
    import torch
    from heltondetection_tpu_torch.configs.base import (DataConfig,
                                                        EvalConfig,
                                                        ExperimentConfig,
                                                        ModelConfig,
                                                        TrainConfig)
    from heltondetection_tpu_torch.data.augment import TrainPipeline
    from heltondetection_tpu_torch.data.loader import TrainLoader
    from heltondetection_tpu_torch.engine.runner import (_make_detector,
                                                         build_model,
                                                         load_detector,
                                                         train_from_datasets)
    from heltondetection_tpu_torch.kernels import (launch_counts,
                                                   reset_launch_counts)
    from heltondetection_tpu_torch.models.common import init_weights
    from heltondetection_tpu_torch.models.yolov5 import YOLOv5
    from heltondetection_tpu_torch.train.schedule import make_optimizer
    from heltondetection_tpu_torch.train.trainer import (create_train_state,
                                                         make_train_step,
                                                         update_ema)
    from heltondetection_tpu_torch.train.yolo_loss import (YoloLossConfig,
                                                           yolo_loss_packed)
    from heltondetection_tpu_torch.utils import ckpt as ckpt_io

    from heltondetection_tpu_torch.models.cspdarknet import VARIANTS
    tc = TRAIN_CONFIG
    size = tc["img_size"]
    depth_m, width_m = VARIANTS[tc["variant"]]
    out = {"card": smi, "config": dict(tc)}
    t0 = time.perf_counter()
    train_ds, val_ds = SynthFrames(64, 10), SynthFrames(32, 11)
    log(f"train data: 64 + 32 frames in {time.perf_counter() - t0:.2f} s")

    # a. run_train end to end: 2 epochs x 4 steps, then resume for a third
    records = LogRecords()
    with tempfile.TemporaryDirectory() as work:
        cfg = ExperimentConfig(
            name=tc["name"], work_dir=work,
            model=ModelConfig(variant=tc["variant"],
                              num_classes=tc["num_classes"],
                              img_size=tc["img_size"], dtype=tc["dtype"]),
            train=TrainConfig(epochs=2, batch_size=tc["batch_size"],
                              lr=tc["lr"], mosaic_p=tc["mosaic_p"],
                              flip_p=tc["flip_p"], warmup_epochs=1.0,
                              eval_interval=1, ckpt_interval=1,
                              num_workers=8),
            eval=EvalConfig(batch_size=16))
        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.perf_counter()
        try:
            best = train_from_datasets(cfg, train_ds, val_ds, device=dev)
            torch.cuda.synchronize()
            wall2 = time.perf_counter() - t0
            counts2 = dict(launch_counts)
            epochs2 = records.field("epoch_stats")
            evals2 = records.field("eval_stats")
            step_dir = os.path.join(cfg.ckpt_dir, "8")
            files = sorted(os.listdir(step_dir))
            best_json = os.path.isfile(os.path.join(work, tc["name"],
                                                    "best.json"))
            records.records.clear()
            cfg.train.epochs = 3
            t0 = time.perf_counter()
            train_from_datasets(cfg, train_ds, val_ds, device=dev)
            torch.cuda.synchronize()
            wall3 = time.perf_counter() - t0
            counts3 = dict(launch_counts)
            epochs3 = records.field("epoch_stats")
            evals3 = records.field("eval_stats")
            resumed = records.field("resumed_step")
            steps_kept = sorted(int(d) for d in os.listdir(cfg.ckpt_dir))
            saved = torch.load(os.path.join(cfg.ckpt_dir, "12",
                                            "train_state.pt"),
                               map_location="cpu", weights_only=True)
            served = load_detector(cfg, ckpt=cfg.ckpt_dir, device=dev)
            by_hand_model = build_model(cfg.model, 80)
            by_hand_model.load_state_dict({**saved["model"], **saved["ema"]})
            by_hand = _make_detector(cfg, by_hand_model, 80, device=dev)
        finally:
            records.close()
    log(f"run_train, 2 epochs x 4 steps: {wall2:.1f} s; epochs "
        f"{[(e['epoch'], e['steps'], round(e['total'], 4)) for e in epochs2]}"
        f"; in-loop evals AP {[round(e['AP'], 6) for e in evals2]}; "
        f"launches {counts2}; step 8 files {files}; best.json {best_json}; "
        f"best AP {best.get('AP')}")
    log(f"resumed run (epochs=3): {wall3:.1f} s; resumed at {resumed}; "
        f"epochs {[(e['epoch'], e['steps'], e['step']) for e in epochs3]}; "
        f"steps kept {steps_kept}; launches during both runs {counts3}")
    finite = all(math.isfinite(v) for e in epochs2 + epochs3
                 for k, v in e.items() if isinstance(v, float))
    if not finite or [e["steps"] for e in epochs2] != [4, 4]:
        raise AssertionError(f"run_train epochs: {epochs2}")
    if len(evals2) != 2 or counts2["nms_fixpoint"] < 2:
        raise AssertionError("the in-loop eval did not run after each epoch "
                             "or did not launch nms_fixpoint")
    if files != ["eval_variables.pt", "train_state.pt"] or not best_json:
        raise AssertionError(f"checkpoint files {files}, best.json "
                             f"{best_json}")
    if resumed != [8] or [(e["epoch"], e["steps"], e["step"])
                          for e in epochs3] != [(2, 4, 12)] \
            or len(evals3) != 1 or steps_kept[-1] != 12 \
            or counts3["nms_fixpoint"] <= counts2["nms_fixpoint"]:
        raise AssertionError(f"resume: {resumed}, {epochs3}, {steps_kept}")
    frames = [val_ds.frames[i][0] for i in range(4)]
    got, want = served.detect_batch(frames), by_hand.detect_batch(frames)
    if not all(same_dets(g, w) for g, w in zip(got, want)):
        raise AssertionError("load_detector does not serve the run's EMA "
                             "weights")
    log(f"load_detector(work dir) == a Detector of train_state.pt's EMA "
        f"weights at step 12 ({sum(len(d[1]) for d in got)} dets on 4 "
        f"frames)")
    secs = [e["seconds"] for e in epochs2 + epochs3]
    waits = [e["loader_wait_s"] for e in epochs2 + epochs3]
    out["run_train"] = {
        "epochs_s": secs, "loader_wait_s": waits,
        "loader_wait_share": sum(waits) / sum(secs),
        "ms_per_step": 1e3 * sum(secs) / 12, "wall_s_2_epochs": wall2,
        "wall_s_resumed_epoch": wall3,
        "eval_img_per_s": [e["images_per_sec"] for e in evals2 + evals3],
        "launches_nms_fixpoint": counts3["nms_fixpoint"]}

    # b. the loss falls on one fixed batch of 16, augmentation off
    loss_cfg = YoloLossConfig(num_classes=80, img_size=size)
    pipe = TrainPipeline(train_ds, size, mosaic_p=0.0, hsv=False, flip_p=0.0,
                         max_boxes=128)
    host = [pipe.sample(i) for i in range(16)]
    batch = {k: torch.from_numpy(np.stack([s[k] for s in host])).to(dev)
             for k in host[0]}
    model = YOLOv5(80, depth_m, width_m, dtype=torch.bfloat16,
                   packed_train=True)
    init_weights(model, torch.Generator().manual_seed(0))
    model = model.to(dev, memory_format=torch.channels_last)
    state = create_train_state(model, make_optimizer(
        model, 1e-3, total_steps=30, warmup_steps=3))
    step = make_train_step(loss_cfg)
    totals = []
    for _ in range(30):
        state, m = step(state, batch)
        totals.append(m["total"])
    totals = [float(t) for t in totals]
    ratio = float(np.mean(totals[-5:]) / np.mean(totals[:5]))
    log(f"fixed batch of 16, 30 steps: total {totals[0]:.3f} → "
        f"{totals[-1]:.3f}; last-5 / first-5 mean {ratio:.4f} (must be ≤ "
        f"{LOSS_FALL_RATIO})")
    if not all(math.isfinite(t) for t in totals) or ratio > LOSS_FALL_RATIO:
        raise AssertionError(f"the loss did not fall: {totals}")
    out["loss_fall"] = {"totals": totals, "ratio": ratio,
                        "required_ratio": LOSS_FALL_RATIO}

    # c. the card equals the CPU: a narrow f32 step, TF32 off
    narrow = YOLOv5(80, 0.33, 0.25, packed_train=True)
    init_weights(narrow, torch.Generator().manual_seed(1))
    small = {k: v[:2].cpu() for k, v in batch.items()}
    small["image"] = torch.nn.functional.interpolate(
        small["image"].permute(0, 3, 1, 2).float(), size=(128, 128),
        mode="area").round().to(torch.uint8).permute(0, 2, 3, 1).contiguous()
    small["gt_boxes"] = small["gt_boxes"] * (128 / size)
    small_cfg = YoloLossConfig(num_classes=80, img_size=128)
    runs = {}
    for where in ("cpu", dev):
        m_ = copy.deepcopy(narrow).to(where)
        st = create_train_state(m_, make_optimizer(m_, 1e-3, total_steps=10,
                                                   warmup_steps=1))
        st, met = make_train_step(small_cfg)(st, {k: v.to(where)
                                                  for k, v in small.items()})
        runs[str(where)] = (m_, {k: float(v) for k, v in met.items()})
    (mc, metc), (mg, metg) = runs["cpu"], runs[str(dev)]
    metric_errs = {k: abs(metg[k] - metc[k]) / max(abs(metc[k]), 1e-12)
                   for k in metc}
    metric_err = max(metric_errs.values())
    gnorm = metc["grad_norm"]
    grad_own = max(float((pg.grad.cpu() - pc.grad).abs().max() /
                         pc.grad.norm()) for pc, pg in
                   zip(mc.parameters(), mg.parameters()))
    grad_global = max(float((pg.grad.cpu() - pc.grad).abs().max())
                      for pc, pg in zip(mc.parameters(), mg.parameters())
                      ) / gnorm
    sc, sg = mc.state_dict(), mg.state_dict()
    stat_err = max(float(((sg[k].cpu() - sc[k]).abs() /
                          sc[k].abs().clamp(min=1.0)).max())
                   for k in sc if "running" in k)
    log(f"narrow f32 step (width 0.25, 128², B=2), card vs CPU: metrics rel "
        f"{ {k: float(f'{v:.3g}') for k, v in metric_errs.items()} }; grads "
        f"max |Δ| {grad_own:.3g} of the tensor's "
        f"norm, {grad_global:.3g} of the global norm; BN running stats "
        f"{stat_err:.3g}")
    if not (metric_err <= 1e-4 and grad_global <= 1e-4
            and grad_own <= 3e-3 and stat_err <= 5e-5):
        raise AssertionError("the narrow train step on the card differs "
                             "from the CPU's")
    out["card_vs_cpu"] = {"metric_rel_err": metric_errs,
                          "grad_err_of_tensor_norm": grad_own,
                          "grad_err_of_global_norm": grad_global,
                          "bn_stat_err": stat_err}
    del runs, mc, mg

    # times: the train step at B=16, full width, bf16
    flops = train_flops(model, batch, loss_cfg)
    torch.cuda.reset_peak_memory_stats(dev)
    step_ms = cuda_ms(lambda: step(state, batch), 10, warmup=2)
    peak = torch.cuda.max_memory_allocated(dev)
    parts = {"forward": 0.0, "loss": 0.0, "backward": 0.0,
             "optimizer_ema": 0.0}
    n_parts = 5
    for _ in range(n_parts):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
        model.zero_grad(set_to_none=True)
        ev[0].record()
        outs = model(batch["image"].float() / 255.0)
        ev[1].record()
        total, _ = yolo_loss_packed(outs, batch["gt_boxes"], batch["gt_cls"],
                                    batch["gt_mask"], loss_cfg)
        ev[2].record()
        total.backward()
        ev[3].record()
        state.optimizer.step()
        update_ema(state.ema, model, state.step)
        state.step += 1
        ev[4].record()
        torch.cuda.synchronize()
        for i, k in enumerate(parts):
            parts[k] += ev[i].elapsed_time(ev[i + 1]) / n_parts
    rows = device_kernels(lambda: step(state, batch), 3)
    busy = sum(ms for _, ms in rows)
    t0 = time.perf_counter()
    loader = TrainLoader(TrainPipeline(train_ds, size, mosaic_p=1.0),
                         16, num_workers=8, device=dev)
    batches = loader.host_batches(0)
    n_img = sum(len(next(batches)["image"]) for _ in range(3))
    batches.close()
    host_ips = n_img / (time.perf_counter() - t0)
    mfu = flops["step_flops"] / (step_ms / 1e3) / BF16_FLOP_PER_S
    out["step_b16"] = {
        "ms": step_ms, "img_per_s": 16e3 / step_ms,
        "parts_ms": parts, "device_busy_ms": busy,
        "idle_share": 1.0 - busy / step_ms,
        "top_kernels": [[k[:80], ms] for k, ms in rows[:8]],
        "max_memory_allocated_bytes": peak, **flops,
        "bf16_peak_flop_per_s": BF16_FLOP_PER_S, "mfu": mfu}
    out["host_pipeline"] = {"img_per_s_640_mosaic1": host_ips,
                            "workers": 8, "images": n_img}
    log(f"train step B=16 {size}² bf16 on {smi}: {step_ms:.3f} ms, "
        f"{16e3 / step_ms:.1f} img/s | forward {parts['forward']:.3f}, loss "
        f"{parts['loss']:.3f}, backward {parts['backward']:.3f}, optimizer + "
        f"EMA {parts['optimizer_ema']:.3f} ms | device busy {busy:.3f} ms, "
        f"idle share {1.0 - busy / step_ms:.3f} | peak memory "
        f"{peak / 2**30:.2f} GiB | {flops['step_flops'] / 1e12:.3f} TFLOP "
        f"a step, {mfu:.4f} of the bf16 peak")
    log(f"host pipeline (mosaic 1.0, HSV, flip, affine; 8 threads): "
        f"{host_ips:.1f} img/s; run_train waits for the loader "
        f"{out['run_train']['loader_wait_share']:.3f} of its epochs; "
        f"in-loop eval {out['run_train']['eval_img_per_s']}")
    return out


VISDRONE_SIZES = [(1080, 1920), (765, 1360)]
CONFIGS = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "heltondetection_tpu_torch", "configs")
VISDRONE_CONFIG = os.path.join(CONFIGS, "yolov5_s_visdrone_1280.py")
DROPBLOCK_CONFIG = os.path.join(CONFIGS, "yolov5_s_coco_640_dropblock.py")


def write_visdrone(root: str, n: int, seed: int) -> dict:
    """Write a VisDrone2019-DET layout under root (images/, annotations/)
    for n seeded frames of VisDrone's sizes (1080×1920 and 765×1360): each
    annotation file holds 20–60 objects 2–40 px wide and up to 2.5 times
    as tall (at most 60 px), as VisDrone's distant people and cars are,
    with scores 1 and categories 1–10, two ignored regions (score 0,
    category 0) and one "others" row (category 11). With objects of 3 px
    and more the default anchors fit (best possible recall above 0.98 at
    1280²); the boxes under 4 px wide bring it below, so they are refit.
    The image files are empty: the card's machine promises no image
    decoder, so the frames stay in memory, returned as {path: (H, W, 3)
    uint8}, with each object painted in its category's colour on uint8
    noise."""
    rng = np.random.default_rng(seed)
    img_dir = os.path.join(root, "images")
    ann_dir = os.path.join(root, "annotations")
    os.makedirs(img_dir)
    os.makedirs(ann_dir)
    palette = rng.integers(0, 256, (12, 3)).astype(np.uint8)
    frames = {}
    for i in range(n):
        h, w = VISDRONE_SIZES[i % len(VISDRONE_SIZES)]
        img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        k = int(rng.integers(20, 61))
        bw = np.exp(rng.uniform(np.log(2.0), np.log(40.0), k))
        bh = np.minimum(bw * rng.uniform(1.0, 2.5, k), 60.0)
        x = rng.uniform(0, w - bw)
        y = rng.uniform(0, h - bh)
        cat = rng.integers(1, 11, k)
        rows = [(x[j], y[j], bw[j], bh[j], 1, cat[j]) for j in range(k)]
        for _ in range(2):                 # ignored regions
            rw, rh = rng.uniform(40, 120, 2)
            rows.append((rng.uniform(0, w - rw), rng.uniform(0, h - rh),
                         rw, rh, 0, 0))
        rows.append((rng.uniform(0, w - 30), rng.uniform(0, h - 30), 20.0,
                     25.0, 1, 11))         # "others"
        lines = []
        for rx, ry, rw, rh, score, c in rows:
            x0, y0 = int(rx), int(ry)
            x1, y1 = int(rx + rw) + 1, int(ry + rh) + 1
            img[y0:y1, x0:x1] = palette[c]
            lines.append(f"{x0},{y0},{x1 - x0},{y1 - y0},{score},{c},0,0")
        stem = f"{seed:04d}_{i:05d}"
        path = os.path.join(img_dir, stem + ".jpg")
        open(path, "wb").close()
        with open(os.path.join(ann_dir, stem + ".txt"), "w") as f:
            f.write("\n".join(lines) + "\n")
        frames[path] = img
    return frames


class RecordedDetEvals:
    """Replaces utils.cocoeval.DetEval with a subclass that keeps every
    instance the run makes, so the in-loop eval's ground truth can be read
    after the run."""

    def __init__(self):
        from heltondetection_tpu_torch.utils import cocoeval
        self.module, self.orig, self.made = cocoeval, cocoeval.DetEval, []
        made = self.made

        class Recorded(self.orig):
            def __init__(self, *a, **k):
                super().__init__(*a, **k)
                made.append(self)

        cocoeval.DetEval = Recorded

    def close(self):
        self.module.DetEval = self.orig


def visdrone_phase(dev, smi: str) -> dict:
    """Phase 4f.1: the published yolov5_s_visdrone_1280 config through
    run_train with device_aug and autoanchor on VisDrone-format files, the
    card against the CPU for device_augment_batch, and the 1280² step's
    times. Returns the JSON fields.

    The card's machine has no image decoder, so the phase replaces only
    the reader module's ``imread_rgb`` with a lookup of the in-memory
    frames by path (:func:`write_visdrone`); every annotation file is
    parsed by ``VisDroneDataset``'s own code, through ``build_dataset``."""
    import dataclasses
    import tempfile
    import torch
    from heltondetection_tpu_torch.configs.base import load_config
    from heltondetection_tpu_torch.data import readers
    from heltondetection_tpu_torch.data.augment import (DeviceAugPipeline,
                                                        TrainPipeline)
    from heltondetection_tpu_torch.data.autoanchor import check_anchors
    from heltondetection_tpu_torch.data.device_aug import (
        device_augment_batch, sample_draws)
    from heltondetection_tpu_torch.data.loader import TrainLoader
    from heltondetection_tpu_torch.engine import runner
    from heltondetection_tpu_torch.kernels import (launch_counts,
                                                   reset_launch_counts)
    from heltondetection_tpu_torch.models.common import init_weights
    from heltondetection_tpu_torch.train.schedule import make_optimizer
    from heltondetection_tpu_torch.train.trainer import (create_train_state,
                                                         make_train_step)
    from heltondetection_tpu_torch.train.yolo_loss import YoloLossConfig
    from heltondetection_tpu_torch.utils import ckpt as ckpt_io

    published = load_config(VISDRONE_CONFIG)
    out = {"card": smi, "config": os.path.basename(VISDRONE_CONFIG)}
    records = LogRecords()
    evals = RecordedDetEvals()
    read_orig = readers.imread_rgb
    late_reads = []

    def read_after_close(path):
        # every loader of the phase is closed by now: a read here comes from
        # a worker thread that outlived its loader's close()
        late_reads.append(path)
        raise FileNotFoundError(path)

    with tempfile.TemporaryDirectory() as work:
        t0 = time.perf_counter()
        frames = write_visdrone(os.path.join(work, "train"), 32, 20)
        frames.update(write_visdrone(os.path.join(work, "val"), 16, 21))
        log(f"VisDrone files: 32 + 16 frames in "
            f"{time.perf_counter() - t0:.2f} s")
        readers.imread_rgb = frames.__getitem__
        try:
            cfg = dataclasses.replace(
                published, work_dir=os.path.join(work, "runs"),
                data=dataclasses.replace(
                    published.data,
                    train_ann=os.path.join(work, "train", "annotations"),
                    train_imgs=os.path.join(work, "train", "images"),
                    val_ann=os.path.join(work, "val", "annotations"),
                    val_imgs=os.path.join(work, "val", "images")),
                model=dataclasses.replace(published.model),
                train=dataclasses.replace(
                    published.train, epochs=2, device_aug=True,
                    autoanchor=True, eval_interval=1, ckpt_interval=1,
                    num_workers=8))
            mc, tc = cfg.model, cfg.train
            torch.cuda.synchronize()
            reset_launch_counts()
            t0 = time.perf_counter()
            best = runner.run_train(cfg, device=dev)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = dict(launch_counts)
            epochs = records.field("epoch_stats")
            ev_stats = records.field("eval_stats")
            fitted = records.field("autoanchor")
            train_ds = runner.build_dataset(cfg.data, "train")
            want, st = check_anchors(train_ds, img_size=mc.img_size,
                                     anchors=None, seed=tc.seed)
            # load_detector of the run: the refit anchors, not the default
            served = runner.load_detector(cfg, ckpt=cfg.ckpt_dir,
                                          device=dev)
            net = runner.build_model(mc, 10)
            net.load_state_dict(runner._eval_state(
                ckpt_io.restore_eval_variables(cfg.ckpt_dir)))
            probe = [frames[p] for p in sorted(frames)[-2:]]
            by_hand = runner._make_detector(cfg, net, 10, device=dev)
            default = runner._make_detector(dataclasses.replace(
                cfg, model=dataclasses.replace(mc, anchors=None)), net, 10,
                device=dev)
            got = served.detect_batch(probe)
            same = all(same_dets(g, w) for g, w in
                       zip(got, by_hand.detect_batch(probe)))
            moved = not all(same_dets(g, w) for g, w in
                            zip(got, default.detect_batch(probe)))

            # one fixed batch: device_augment_batch on the card == on CPU
            pipe = DeviceAugPipeline(train_ds, mc.img_size,
                                     max_boxes=cfg.data.max_boxes,
                                     seed=tc.seed, mosaic_p=tc.mosaic_p)
            loader = TrainLoader(pipe, tc.batch_size, seed=tc.seed,
                                 num_workers=8, device=dev,
                                 keys=TrainLoader.DEVICE_AUG_KEYS)
            t0 = time.perf_counter()
            batches = loader.host_batches(0)
            host = [next(batches) for _ in range(2)]
            batches.close()
            dev_aug_ips = 2 * tc.batch_size / (time.perf_counter() - t0)
            t0 = time.perf_counter()
            plain_loader = TrainLoader(
                TrainPipeline(train_ds, mc.img_size, mosaic_p=tc.mosaic_p,
                              max_boxes=cfg.data.max_boxes, seed=tc.seed),
                tc.batch_size, seed=tc.seed, num_workers=8, device=dev)
            batches = plain_loader.host_batches(0)
            next(batches)
            batches.close()
            host_ips = tc.batch_size / (time.perf_counter() - t0)
        finally:
            readers.imread_rgb = read_after_close
            records.close()
            evals.close()
    log(f"run_train {out['config']} (1280², B=16, device_aug, autoanchor): "
        f"{wall:.1f} s; epochs "
        f"{[(e['epoch'], e['steps'], round(e['total'], 4)) for e in epochs]}"
        f"; in-loop AP {[round(e['AP'], 6) for e in ev_stats]}; launches "
        f"{counts}; autoanchor {st}")
    finite = all(math.isfinite(v) for e in epochs for v in e.values()
                 if isinstance(v, float))
    if not finite or [e["steps"] for e in epochs] != [2, 2]:
        raise AssertionError(f"run_train epochs: {epochs}")
    if len(ev_stats) != 2 or counts["nms_fixpoint"] < 4 or \
            best.get("num_images") != 16:
        raise AssertionError("the in-loop eval did not run after each epoch "
                             "over the 16 val frames through nms_fixpoint")
    gts = [d for d in evals.made if d._gts]
    ignore = sum(g[3] for d in gts for v in d._gts.values() for g in v)
    ids = {img for d in gts for img, _ in d._gts}
    if len(gts) != 1 or ignore < 16 * 3 * 10 or len(ids) != 16 or \
            not all(isinstance(i, str) for i in ids):
        raise AssertionError(f"the eval's DetEval got {ignore} ignore rows "
                             f"over ids {sorted(ids)}")
    if want is None or st["prev_bpr"] >= 0.98 or \
            mc.anchors != want or not fitted or \
            fitted[0]["anchors"] != want:
        raise AssertionError(f"autoanchor: the run's {mc.anchors} against "
                             f"check_anchors' {want} ({st})")
    if not same or not moved:
        raise AssertionError("load_detector does not serve the run with its "
                             "refit anchors")
    log(f"in-loop eval: {ignore} ignore rows reach DetEval over 16 string "
        f"ids; refit anchors == check_anchors on the same labels (BPR "
        f"{st['prev_bpr']:.4f} → {st['bpr']:.4f}); load_detector uses them "
        f"(dets differ from the default anchors')")

    # the card equals the CPU: device_augment_batch on one fixed batch with
    # the same draws (mixup on too, so its path is held as well)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in host[0].items()}
    draws = sample_draws(tc.batch_size, mc.img_size,
                         torch.Generator(dev).manual_seed(5),
                         flip_p=tc.flip_p, mixup_p=0.5)
    on_card = device_augment_batch(batch, draws, hsv=tc.hsv)
    cpu_draws = dataclasses.replace(draws, **{
        f.name: getattr(draws, f.name).cpu()
        for f in dataclasses.fields(draws)})
    on_cpu = device_augment_batch({k: v.cpu() for k, v in batch.items()},
                                  cpu_draws, hsv=tc.hsv)
    px_err = float((on_card["image"].cpu() - on_cpu["image"]).abs().max())
    box_err = float((on_card["gt_boxes"].cpu() -
                     on_cpu["gt_boxes"]).abs().max())
    exact = all(torch.equal(on_card[k].cpu(), on_cpu[k])
                for k in ("gt_cls", "gt_mask"))
    log(f"device_augment_batch B=16 1280², card vs CPU, same draws: pixels "
        f"{px_err:.3g}, boxes {box_err:.3g} px, classes and masks equal: "
        f"{exact}")
    if not (px_err <= 1e-5 and box_err <= 1e-4 and exact):
        raise AssertionError("device_augment_batch on the card differs from "
                             "the CPU")
    del on_cpu, cpu_draws

    # times: the 1280² step as run_train builds it, device_aug inside it
    model = runner.build_model(mc, 10)
    init_weights(model, torch.Generator().manual_seed(tc.seed))
    model = model.to(dev, memory_format=torch.channels_last)
    model.packed_train = True
    state = create_train_state(model, make_optimizer(
        model, tc.lr, total_steps=100, warmup_steps=10))
    step = make_train_step(YoloLossConfig(
        num_classes=10, img_size=mc.img_size, anchors=runner._cfg_anchors(
            cfg)), seed=tc.seed)
    augmented = runner._device_augment(cfg, dev)

    def train_step():
        return step(state, augmented(state.step, batch))

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    step_ms = cuda_ms(train_step, 5, warmup=2)
    peak = torch.cuda.max_memory_allocated(dev)
    aug_ms = cuda_ms(lambda: augmented(0, batch), 5, warmup=1)
    rows = device_kernels(train_step, 2)
    busy = sum(ms for _, ms in rows)
    aug_rows = device_kernels(lambda: augmented(0, batch), 2)
    aug_busy = sum(ms for _, ms in aug_rows)
    out["run_train"] = {
        "wall_s": wall, "epochs_s": [e["seconds"] for e in epochs],
        "loader_wait_s": [e["loader_wait_s"] for e in epochs],
        "eval_img_per_s": [e["images_per_sec"] for e in ev_stats],
        "launches": counts, "autoanchor": st,
        "anchors": [list(map(list, lv)) for lv in mc.anchors],
        "ignore_rows_in_det_eval": ignore}
    out["step_b16_1280"] = {
        "ms": step_ms, "img_per_s": 16e3 / step_ms, "device_busy_ms": busy,
        "idle_share": 1.0 - busy / step_ms,
        "top_kernels": [[k[:80], ms] for k, ms in rows[:8]],
        "max_memory_allocated_bytes": peak,
        "device_aug_ms": aug_ms, "device_aug_busy_ms": aug_busy}
    out["host_img_per_s_1280_mosaic05"] = {
        "DeviceAugPipeline": dev_aug_ips, "TrainPipeline": host_ips,
        "workers": 8}
    out["device_aug_card_vs_cpu"] = {"pixel_err": px_err,
                                     "box_err_px": box_err}
    log(f"train step B=16 1280² bf16 (device_aug inside) on {smi}: "
        f"{step_ms:.3f} ms, {16e3 / step_ms:.1f} img/s | device busy "
        f"{busy:.3f} ms, idle share {1.0 - busy / step_ms:.3f} | peak memory "
        f"{peak / 2**30:.2f} GiB | device_aug {aug_ms:.3f} ms (busy "
        f"{aug_busy:.3f})")
    log(f"host at 1280², mosaic 0.5, 8 threads: DeviceAugPipeline "
        f"{dev_aug_ips:.1f} img/s, TrainPipeline {host_ips:.1f} img/s")
    readers.imread_rgb = read_orig
    if late_reads:
        raise AssertionError(f"{len(late_reads)} frames were read after "
                             f"their loader was closed: {late_reads[:4]}")
    return out


def dropblock_phase(dev, smi: str) -> dict:
    """Phase 4f.2: the published yolov5_s_coco_640_dropblock config
    (DropBlock 0.5) at full width, one train step with remat off and on from
    the same state and the same DropBlock draws, DropBlock's mask on the
    card against the CPU, and both steps' times and peak memory."""
    import dataclasses
    import torch
    from heltondetection_tpu_torch.configs.base import load_config
    from heltondetection_tpu_torch.data.augment import TrainPipeline
    from heltondetection_tpu_torch.engine import runner
    from heltondetection_tpu_torch.models.common import init_weights
    from heltondetection_tpu_torch.models.dropblock import drop_block
    from heltondetection_tpu_torch.train.schedule import make_optimizer
    from heltondetection_tpu_torch.train.trainer import (create_train_state,
                                                         make_train_step)
    from heltondetection_tpu_torch.train.yolo_loss import YoloLossConfig

    cfg = load_config(DROPBLOCK_CONFIG)
    mc, tc = cfg.model, cfg.train
    size = mc.img_size
    pipe = TrainPipeline(SynthFrames(16, 12), size, mosaic_p=0.0, hsv=False,
                         flip_p=0.0, max_boxes=128)
    host = [pipe.sample(i) for i in range(tc.batch_size)]
    batch = {k: torch.from_numpy(np.stack([s[k] for s in host])).to(dev)
             for k in host[0]}
    loss_cfg = YoloLossConfig(num_classes=80, img_size=size)
    runs = {}
    for remat in (False, True):
        model = runner.build_model(dataclasses.replace(mc, remat=remat), 80)
        init_weights(model, torch.Generator().manual_seed(tc.seed))
        model = model.to(dev, memory_format=torch.channels_last)
        model.packed_train = True
        state = create_train_state(model, make_optimizer(
            model, tc.lr, total_steps=100, warmup_steps=10))
        step = make_train_step(loss_cfg, seed=tc.seed)
        _, met = step(state, batch)
        met = {k: float(v) for k, v in met.items()}
        grads = [p.grad.detach().clone() for p in model.parameters()]
        stats = {k: v.detach().clone() for k, v in model.state_dict().items()
                 if "running" in k or "num_batches" in k}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        ms = cuda_ms(lambda: step(state, batch), 5, warmup=1)
        peak = torch.cuda.max_memory_allocated(dev)
        runs[remat] = (met, grads, stats, ms, peak)
        del model, state, step
    (m0, g0, s0, ms0, pk0), (m1, g1, s1, ms1, pk1) = runs[False], runs[True]
    loss_err = abs(m1["total"] - m0["total"]) / abs(m0["total"])
    gnorm = m0["grad_norm"]
    grad_err = max(float((a - b).abs().max()) for a, b in zip(g0, g1)) / gnorm
    stats_equal = all(torch.equal(s0[k], s1[k]) for k in s0)
    log(f"{os.path.basename(DROPBLOCK_CONFIG)} B=16 640², remat on vs off, "
        f"same state and DropBlock draws: loss {loss_err:.3g} relative, "
        f"grads {grad_err:.3g} of the global norm, BN running statistics "
        f"equal: {stats_equal}")
    if not (loss_err <= 1e-5 and grad_err <= 1e-4 and stats_equal):
        raise AssertionError("the remat step differs from the plain step")
    del g0, g1

    # DropBlock on the card == on the CPU, the same uniform draws (a c3
    # feature map of the batch: 16 x 128 x 80 x 80)
    g = torch.Generator(dev).manual_seed(3)
    x = torch.randn(16, 128, 80, 80, device=dev, generator=g).to(
        memory_format=torch.channels_last)
    u = torch.rand(16, 74, 74, 128, device=dev, generator=g).permute(
        0, 3, 1, 2)
    on_card = drop_block(x, u, mc.dropblock_p).cpu()
    on_cpu = drop_block(x.cpu(), u.cpu(), mc.dropblock_p)
    mask_equal = torch.equal(on_card == 0, on_cpu == 0)
    val_err = float(((on_card - on_cpu).abs() /
                     on_cpu.abs().clamp(min=1.0)).max())
    dropped = float((on_card == 0).float().mean())
    log(f"drop_block card vs CPU (16x128x80x80, p {mc.dropblock_p}): masks "
        f"equal {mask_equal}, values {val_err:.3g}, dropped {dropped:.4f}")
    if not mask_equal or val_err > 1e-6:
        raise AssertionError("drop_block on the card differs from the CPU")
    log(f"DropBlock step B=16 640² bf16 on {smi}: remat off {ms0:.3f} ms, "
        f"{pk0 / 2**30:.2f} GiB | remat on {ms1:.3f} ms, "
        f"{pk1 / 2**30:.2f} GiB")
    return {"card": smi, "config": os.path.basename(DROPBLOCK_CONFIG),
            "remat_vs_plain": {"loss_rel_err": loss_err,
                               "grad_err_of_global_norm": grad_err,
                               "bn_stats_equal": stats_equal},
            "drop_block_card_vs_cpu": {"masks_equal": mask_equal,
                                       "value_err": val_err,
                                       "dropped_share": dropped},
            "step_b16_640": {
                "remat_off": {"ms": ms0, "max_memory_allocated_bytes": pk0},
                "remat_on": {"ms": ms1, "max_memory_allocated_bytes": pk1}}}


def c1_phase(dev, model, thr: float) -> dict:
    """Phase 4f.3: the fused serve step above nms_fixpoint's largest N
    (pre_nms_topk=2401 at 640², 8 frames) goes through nms_mask, and its
    dets equal the plain NMS's on the same candidates."""
    import torch
    from heltondetection_tpu_torch.engine.evaluator import \
        make_packed_serve_step
    from heltondetection_tpu_torch.kernels import (launch_counts,
                                                   reset_launch_counts)
    from heltondetection_tpu_torch.models.yolov5 import packed_copy
    from heltondetection_tpu_torch.ops.postprocess import (
        fused_select_decode_packed, nms_sorted_candidates)
    step = make_packed_serve_step(model, 80, conf_thres=0.001,
                                  iou_thres=thr, pre_nms_topk=2401,
                                  device=dev)
    x = torch.from_numpy(np.random.default_rng(6).integers(
        0, 256, (8, 640, 640, 3)).astype(np.uint8)).to(dev)
    step(x)                                     # warm-up, not counted
    torch.cuda.synchronize()
    reset_launch_counts()
    got = [t.cpu() for t in step(x)]
    torch.cuda.synchronize()
    counts = dict(launch_counts)
    packed = packed_copy(model).to(memory_format=torch.channels_last)
    with torch.inference_mode():
        cands = fused_select_decode_packed(packed(x.float() / 255.0), 80,
                                           topk=2401, conf_thres=0.001)
        plain = nms_sorted_candidates(*(t.cpu() for t in cands),
                                      iou_thres=thr, max_det=None)
    equal = all(torch.equal(a, b) for a, b in zip(got, plain))
    n_valid = int((cands[1] > 0).sum())
    log(f"fused serve step at pre_nms_topk=2401 (B=8, 640²): launches "
        f"{counts}; dets == plain NMS dets: {equal} ({int(plain[3].sum())} "
        f"kept of {n_valid} candidates)")
    if counts["nms_mask"] < 1 or counts["nms_fixpoint"] != 0 or not equal:
        raise AssertionError("the fused route above N=2400 did not go "
                             "through nms_mask or its dets differ")
    return {"launches": counts, "kept": int(plain[3].sum()),
            "candidates": n_valid}


RCNN_CONFIG = "configs/faster_rcnn_pafpn_decoupled_coco_832.py"
RCNN_POOL_CONFIG = "configs/faster_rcnn_fpnp2_roipool_voc_832.py"
# the config file phase 4g.1 writes: the published config, as load_detector
# reads it from disk
RCNN_SMOKE_CONFIG = """\
from heltondetection_tpu_torch.configs.faster_rcnn_pafpn_decoupled_coco_832 \\
    import config
"""
# tolerances of the narrow float32 run, card against CPU (TF32 off): the
# network's outputs within 1e-4 of their largest magnitude (float32 convs
# sum in another order on each); dets matched one to one with the same
# class, scores within 1e-4 and boxes within 0.05 px
RCNN_F32_REL = 1e-4
RCNN_LARGE_N = (16448, 20000)   # nms_mask past its 16 register slots
RCNN_SCORE_TOL = 1e-4
RCNN_BOX_TOL = 0.05


@contextlib.contextmanager
def plain_nms():
    """Inside the block, batched_nms (and so every NMS of the FasterRCNN
    path and of make_postprocess) takes its keep mask from the plain
    nms_mask_seq on the tensors' own device instead of the nms_mask
    kernel."""
    from heltondetection_tpu_torch.ops import nms as ops_nms
    kernel_route = ops_nms.nms_mask_batched
    ops_nms.nms_mask_batched = ops_nms.nms_mask_seq
    try:
        yield
    finally:
        ops_nms.nms_mask_batched = kernel_route


def rcnn_config(config: str):
    """A config of the port's configs directory (or a path)."""
    from heltondetection_tpu_torch.configs.base import load_config
    return load_config(os.path.join(ROOT, "heltondetection_tpu_torch",
                                    config))


def rcnn_model(cfg, dev, seed: int, x):
    """The config's FasterRCNN on dev, random weights from seed, with its
    four predictor layers scaled on the images x so that RPN objectness
    logits have std 2, RPN deltas 0.5, class logits 2 and box deltas 0.5:
    random weights otherwise give near-equal RPN scores (every proposal
    ties), and the scaled ones give distinct, unsaturated scores, as
    tests/test_torch_port_rcnn_infer.py does on the CPU."""
    import torch
    from heltondetection_tpu_torch.engine.runner import build_model
    from heltondetection_tpu_torch.models.common import init_weights
    model = build_model(cfg.model, cfg.model.num_classes)
    init_weights(model, torch.Generator().manual_seed(seed))
    model = model.to(dev, memory_format=torch.channels_last).eval()
    tame_rcnn(model, x)
    return model


def tame_rcnn(model, x) -> None:
    """Scale the predictors of ``model`` in place (see rcnn_model)."""
    import torch
    from heltondetection_tpu_torch.models.faster_rcnn import (
        generate_proposals, pyramid_anchors)
    cfg = model.cfg
    with torch.no_grad():
        _, obj, deltas = model(x)
        model.rpn.cls.weight.mul_(2.0 / obj.std())
        model.rpn.reg.weight.mul_(0.5 / deltas.std())
        pyr, obj, deltas = model(x)
        props = generate_proposals(obj, deltas, model.anchors(obj.device),
                                   pyramid_anchors(cfg.img_size)[1],
                                   cfg.img_size, cfg)
        scores, hd = model.run_box_head(pyr, props[0])
        model.box_head.cls.weight.mul_(2.0 / scores.std())
        model.box_head.reg.weight.mul_(0.5 / hd.std())


def match_dets(a, b, score_tol: float, box_tol: float) -> int:
    """Fixed-shape dets (boxes, scores, classes, valid) of one batch, a and
    b as numpy: the count of valid dets of a with no unused valid det of b
    of the same image and class within score_tol and box_tol (greedy, in
    a's order), plus the difference of the valid counts. 0 means the two
    sets of dets are the same within the tolerances, whatever order
    near-equal scores took."""
    misses = 0
    for i in range(a[0].shape[0]):
        va, vb = a[3][i].astype(bool), b[3][i].astype(bool)
        misses += abs(int(va.sum()) - int(vb.sum()))
        free = list(np.flatnonzero(vb))
        for j in np.flatnonzero(va):
            hit = [k for k in free if b[2][i][k] == a[2][i][j]
                   and abs(b[1][i][k] - a[1][i][j]) <= score_tol
                   and np.abs(b[0][i][k] - a[0][i][j]).max() <= box_tol]
            if hit:
                free.remove(hit[0])
            else:
                misses += 1
    return misses


def conv_dense_flops(model, fn) -> dict:
    """Multiply-adds x2 of one call of fn, counted by forward hooks from the
    shapes of every conv (2·out elements·Cin/g·k²) and dense layer
    (2·out elements·in features) of the model's backbone and neck, RPN head
    and box head; RoIAlign, the proposals and the NMS are not counted. A
    conv that its block applies functionally (a ResNet block's, a
    ConvBnAct's) is counted at the BatchNorm that follows it, whose output
    has the conv's shape."""
    import torch
    from heltondetection_tpu_torch.models.common import BatchNorm2d
    parts = {"backbone_neck": 0, "rpn": 0, "box_head": 0}

    def count(part, conv):
        def hook(mod, inp, out):
            if isinstance(conv, torch.nn.Conv2d):
                k = conv.kernel_size[0] * conv.kernel_size[1]
                parts[part] += 2 * out.numel() * (
                    conv.in_channels // conv.groups) * k
            else:
                parts[part] += 2 * out.numel() * conv.in_features
        return hook

    hooks = []
    for part, roots in (("backbone_neck", (model.backbone, model.neck)),
                        ("rpn", (model.rpn,)),
                        ("box_head", (model.box_head,))):
        for root in roots:
            mods = dict(root.named_modules())
            for name, m in mods.items():
                if isinstance(m, BatchNorm2d):
                    *scope, leaf = name.split(".")
                    conv = mods[".".join(scope + [leaf.replace("bn",
                                                               "conv")])]
                    hooks.append(m.register_forward_hook(count(part, conv)))
                elif type(m).__name__ in ("CastConv2d", "CastLinear"):
                    hooks.append(m.register_forward_hook(count(part, m)))
    try:
        with torch.inference_mode():
            fn()
    finally:
        for h in hooks:
            h.remove()
    parts["total"] = sum(parts.values())
    return parts


def rcnn_phase(dev, smi: str, letterbox_np) -> dict:
    """Phase 4g: FasterRCNN inference (see the module docstring)."""
    import tempfile
    import torch
    from heltondetection_tpu_torch.engine.evaluator import Evaluator
    from heltondetection_tpu_torch.engine.infer import Detector
    from heltondetection_tpu_torch.engine.runner import (forward_for_eval,
                                                         load_detector)
    from heltondetection_tpu_torch.engine.serve import BatchingDetector
    from heltondetection_tpu_torch.kernels import (launch_counts,
                                                   reset_launch_counts)
    from heltondetection_tpu_torch.kernels import nms as nms_kernel
    from heltondetection_tpu_torch.models.common import init_weights
    from heltondetection_tpu_torch.models.faster_rcnn import (
        STRIDES, FasterRCNN, RCNNConfig, box_dets, detect_from_features,
        faster_rcnn_infer, generate_proposals, pyramid_anchors)
    from heltondetection_tpu_torch.ops.nms import (nms_mask_fixpoint_batched,
                                                   nms_mask_seq)
    from heltondetection_tpu_torch.ops.roi_align import multilevel_roi_align
    from heltondetection_tpu_torch.utils.ckpt import save_eval_variables
    from heltondetection_tpu_torch.utils.cocoeval import DetEval
    t0 = time.perf_counter()
    out = {}
    rng = np.random.default_rng(7)
    cfg = rcnn_config(RCNN_CONFIG)
    size = cfg.model.img_size
    batches, gts = eval_batches(rng, 32, 8, size, letterbox_np)
    x = torch.from_numpy(batches[0]["image"]).to(dev)
    xf = x.float() / 255.0

    # 4g.1 the published faster_rcnn_pafpn_decoupled_coco_832, B=8
    model = rcnn_model(cfg, dev, 0, xf)
    rc = model.cfg
    with torch.inference_mode():
        faster_rcnn_infer(model, xf)                # warm-up, not counted
        torch.cuda.synchronize()
        reset_launch_counts()
        dets = faster_rcnn_infer(model, xf)
        torch.cuda.synchronize()
        infer_counts = dict(launch_counts)
        pyr, obj, deltas = model(xf)
        got = detect_from_features(model, pyr, obj, deltas)
        with plain_nms():
            want = detect_from_features(model, pyr, obj, deltas)
    equal = all(torch.equal(a, b) for a, b in zip(got, want)) and \
        all(torch.equal(a, b) for a, b in zip(got, dets))
    n_valid = int(dets[3].sum())
    finite = bool(torch.isfinite(dets[0]).all() and
                  torch.isfinite(dets[1]).all())
    log(f"FasterRCNN {cfg.name} (ResNet50, PAFPNv8, decoupled head, "
        f"{size}², bf16, B=8): faster_rcnn_infer launches {infer_counts}; {n_valid} "
        f"valid dets of {dets[3].numel()}, finite {finite}; dets == the "
        f"plain NMS's on the same features: {equal}")
    if infer_counts["nms_mask"] != 6 or infer_counts["nms_fixpoint"] or \
            infer_counts["iou_matrix"]:
        raise AssertionError("faster_rcnn_infer did not launch nms_mask "
                             "exactly 6 times (5 RPN levels and the final)")
    if not equal or not finite or n_valid == 0:
        raise AssertionError("FasterRCNN dets through nms_mask differ from "
                             "the plain NMS's, are not finite, or are none")
    out["infer"] = {"launches": infer_counts, "valid_dets": n_valid}

    # the Evaluator over 32 frames (4 batches of 8): 7 launches a batch
    fwd = forward_for_eval(model, rc.num_classes, device=dev)
    ev = Evaluator(fwd, rc.num_classes, conf_thres=cfg.eval.conf_thres,
                   iou_thres=cfg.eval.iou_thres, max_det=cfg.eval.max_det,
                   multi_label=False, device=dev)

    def score(route):
        det = DetEval(rc.num_classes)
        for k, xywh, c in gts:
            det.add_gt(k, xywh, c)
        if route == "plain":
            with plain_nms():
                return ev.run(batches, det_eval=det)
        return ev.run(batches, det_eval=det)

    reset_launch_counts()
    stats = score("kernel")
    torch.cuda.synchronize()
    eval_counts = dict(launch_counts)
    stats_plain = score("plain")
    keys = [k for k in stats if k not in ("images_per_sec",)]
    same_stats = all(stats[k] == stats_plain[k] for k in keys)
    log(f"Evaluator over 32 frames (4 batches of 8): launches {eval_counts}; "
        f"AP {stats['AP']:.4f} AP50 {stats['AP50']:.4f}, "
        f"{stats['images_per_sec']:.1f} img/s; stats == the plain route's: "
        f"{same_stats}")
    if eval_counts["nms_mask"] != 7 * len(batches) or \
            eval_counts["nms_fixpoint"]:
        raise AssertionError("the FasterRCNN eval did not launch nms_mask "
                             "7 times per batch")
    if not same_stats or stats["num_images"] != 32:
        raise AssertionError("the FasterRCNN eval stats through nms_mask "
                             "differ from the plain route's")
    out["eval"] = {"launches": eval_counts, "batches": len(batches),
                   "AP": stats["AP"], "AP50": stats["AP50"],
                   "images_per_sec": stats["images_per_sec"]}

    # load_detector from a saved checkpoint and a written config
    sizes = [(480, 640), (720, 1280), (size, size), (375, 500), (1080, 1920),
             (640, 427), (512, 512), (300, 400)]
    frames = [rng.integers(0, 256, hw + (3,)).astype(np.uint8)
              for hw in sizes]
    with tempfile.TemporaryDirectory() as tmp:
        ckpt_dir = os.path.join(tmp, "ckpt")
        save_eval_variables(ckpt_dir, model.state_dict(), 0)
        cfg_path = os.path.join(tmp, "chip_smoke_rcnn.py")
        with open(cfg_path, "w") as f:
            f.write(RCNN_SMOKE_CONFIG)
        loaded = load_detector(cfg_path, ckpt=ckpt_dir, device=dev)
    by_hand = Detector(None, rc.num_classes, size, forward_fn=fwd,
                       conf_thres=cfg.test.conf_thres,
                       iou_thres=cfg.test.iou_thres, device=dev)
    loaded.detect_batch(frames)                    # warm-up, not counted
    torch.cuda.synchronize()
    reset_launch_counts()
    got8 = loaded.detect_batch(frames)
    torch.cuda.synchronize()
    load_counts = dict(launch_counts)
    want8 = by_hand.detect_batch(frames)
    n_loaded = sum(check_dets(f, d) for f, d in zip(frames, got8))
    same_loaded = all(same_dets(g, w) for g, w in zip(got8, want8))
    log(f"load_detector(config file, ckpt dir): {n_loaded} dets over 8 "
        f"frames, launches {load_counts}; == the hand-built Detector's: "
        f"{same_loaded}")
    if load_counts["nms_mask"] != 7 or not same_loaded or n_loaded == 0:
        raise AssertionError("load_detector's FasterRCNN did not launch "
                             "nms_mask 7 times or differs from a "
                             "hand-built Detector")

    # BatchingDetector, batch 8, buckets (2, 8), 4 clients x 8 frames
    def alone_at(frame, bucket):
        x1, metas1 = loaded._letterbox([frame], size)
        o = [t[0].cpu().numpy() for t in loaded._detect(
            x1.expand(bucket, -1, -1, -1).contiguous())]
        return loaded._to_source(*o, metas1[0], frame.shape[:2])

    refs = {b: [alone_at(f, b) for f in frames] for b in (2, 8)}
    batcher = BatchingDetector(loaded, batch_size=8, batch_buckets=(2, 8))
    try:
        batcher.warmup()
        batcher.reset_stats()
        torch.cuda.synchronize()
        reset_launch_counts()
        results, latencies, wall = client_load(batcher, frames, 4, 8)
        torch.cuda.synchronize()
        batch_counts = dict(launch_counts)
        bstats = batcher.stats()
    finally:
        closed = batcher.close(timeout=60.0)
    for idx, d in results:
        check_dets(frames[idx], d)
        if not any(same_dets(d, refs[b][idx]) for b in (2, 8)):
            raise AssertionError(f"a batched FasterRCNN request's dets "
                                 f"equal neither bucket's (frame {idx})")
    log(f"BatchingDetector (FasterRCNN): 4 clients x 8 frames, all 32 "
        f"resolved to detect_batch's answers; stats {bstats}, launches "
        f"{batch_counts}, {32 / wall:.1f} img/s, close() {closed}")
    if bstats["requests"] != 32 or \
            batch_counts["nms_mask"] != 7 * bstats["batches"] or not closed:
        raise AssertionError("the FasterRCNN BatchingDetector's stats or "
                             "launches do not add up")
    out["serving"] = {"launches": batch_counts, "stats": bstats,
                      "img_per_s": 32 / wall,
                      "p50_ms": float(np.median(latencies)) * 1e3}

    # a narrow float32 FasterRCNN on the card against the CPU, TF32 off
    ncfg = RCNNConfig(num_classes=20, img_size=256, backbone="resnet18",
                      neck="pafpn_v8", head="decoupled",
                      rpn_pre_nms_topk=256, rpn_post_nms_topk=64, max_det=50)
    with torch.device("meta"):
        narrow = FasterRCNN(ncfg)
    narrow = narrow.to_empty(device="cpu").eval()
    init_weights(narrow, torch.Generator().manual_seed(1))
    xn = torch.from_numpy(rng.uniform(0, 1, (2, 256, 256, 3))
                          .astype(np.float32))
    tame_rcnn(narrow, xn)
    card = FasterRCNN(ncfg)
    card.load_state_dict(narrow.state_dict())
    card = card.to(dev).eval()
    with torch.inference_mode():
        c_pyr, c_obj, _ = narrow(xn)
        g_pyr, g_obj, _ = card(xn.to(dev))
        c_dets = [t.numpy() for t in faster_rcnn_infer(narrow, xn)]
        g_dets = [t.cpu().numpy() for t in faster_rcnn_infer(card,
                                                             xn.to(dev))]
    rel = max(float((g.cpu() - c).abs().max() / c.abs().max())
              for g, c in zip(g_pyr + [g_obj], c_pyr + [c_obj]))
    misses = match_dets(c_dets, g_dets, RCNN_SCORE_TOL, RCNN_BOX_TOL)
    log(f"narrow f32 FasterRCNN (ResNet18, 256², B=2), card vs CPU: "
        f"pyramid and RPN logits within {rel:.3g} of their largest; "
        f"{int(c_dets[3].sum())} dets, {misses} unmatched within scores "
        f"{RCNN_SCORE_TOL} and boxes {RCNN_BOX_TOL} px")
    if rel > RCNN_F32_REL or misses or not c_dets[3].any():
        raise AssertionError("the narrow f32 FasterRCNN on the card differs "
                             "from its CPU run")
    out["card_vs_cpu"] = {"max_rel": rel, "unmatched": misses,
                          "dets": int(c_dets[3].sum())}
    log(f"[phase 4g.1 done at {time.perf_counter() - t0:.1f} s of 4g]")

    # 4g.2 faster_rcnn_fpnp2_roipool_voc_832: one batch of 8
    pool_model = rcnn_model(rcnn_config(RCNN_POOL_CONFIG), dev, 2, xf)
    with torch.inference_mode():
        faster_rcnn_infer(pool_model, xf)
        torch.cuda.synchronize()
        reset_launch_counts()
        pdets = faster_rcnn_infer(pool_model, xf)
        torch.cuda.synchronize()
        pool_counts = dict(launch_counts)
        p_pyr, p_obj, p_deltas = pool_model(xf)
        with plain_nms():
            pwant = detect_from_features(pool_model, p_pyr, p_obj, p_deltas)
    pool_equal = all(torch.equal(a, b) for a, b in zip(pdets, pwant))
    log(f"FasterRCNN fpnp2_roipool_voc_832 (FPN, coupled head, RoIPool on "
        f"P2, B=8): launches {pool_counts}; {int(pdets[3].sum())} valid "
        f"dets; == the plain NMS's: {pool_equal}")
    if pool_counts["nms_mask"] != 6 or not pool_equal or \
            not pdets[3].any():
        raise AssertionError("the RoIPool FasterRCNN did not launch "
                             "nms_mask 6 times or its dets differ")
    out["roipool_p2"] = {"launches": pool_counts,
                         "valid_dets": int(pdets[3].sum())}
    del pool_model, p_pyr, p_obj, p_deltas

    # 4g.3 nms_mask past its register slots: N = 16448 and 20000
    big = {}
    for n in RCNN_LARGE_N:
        boxes = torch.from_numpy(class_offset_boxes(
            np.random.default_rng(n), 2, n, 300)).to(dev)
        thr = 0.5
        keep = nms_mask_fixpoint_batched(boxes, thr)   # the fused route
        want_keep = nms_mask_seq(boxes, thr)
        pad = (-n) % 64
        padded = torch.nn.functional.pad(boxes, (0, 0, 0, pad)).contiguous()
        ms = cuda_ms(lambda: nms_kernel.nms_mask(padded, thr), 3, warmup=1)
        same = torch.equal(keep, want_keep)
        big[n] = {"equal": same, "kept": int(keep.sum()), "ms_b2": ms,
                  "padded_n": n + pad, "bound": nms_bound_ms(2, n + pad)}
        log(f"nms_mask at N={n} (B=2, padded to {n + pad}; the scan's words "
            f"in shared memory): mask == nms_mask_seq's on the card: {same} "
            f"({int(keep.sum())} kept); {ms:.3f} ms by events")
        if not same:
            raise AssertionError(f"nms_mask at N={n} differs from the plain "
                                 f"mask")
        del boxes, keep, want_keep, padded
    torch.cuda.empty_cache()
    out["nms_mask_large_n"] = {str(k): v for k, v in big.items()}
    out["nms_mask_max_n"] = nms_kernel.nms_mask_max_n(dev)
    log(f"nms_mask's largest N on this card: {out['nms_mask_max_n']}")

    # 4g.4 times at B=8, 832²: the eval step, its parts, device busy share
    _, counts = pyramid_anchors(size)
    anchors = model.anchors(dev)
    nl = rc.roi_levels
    with torch.inference_mode():
        step_ms = cuda_ms(lambda: ev._step(x), 10)
        trunk_ms = cuda_ms(lambda: model.features(xf), 10)
        pyr = model.features(xf)
        rpn_ms = cuda_ms(lambda: model.rpn(pyr), 10)
        obj, deltas = model.rpn(pyr)
        prop_ms = cuda_ms(lambda: generate_proposals(
            obj, deltas, anchors, counts, size, rc), 10)
        props, _, pvalid = generate_proposals(obj, deltas, anchors, counts,
                                              size, rc)
        feats = [p.permute(0, 2, 3, 1) for p in pyr[:nl]]

        def roi():
            return multilevel_roi_align(feats, props, STRIDES[:nl],
                                        out_size=7, method=rc.roi_method)
        roi_ms = cuda_ms(roi, 10)
        crops = roi().reshape(-1, 7, 7, 256)
        head_ms = cuda_ms(lambda: model.box_head(crops), 10)
        scores, hd = model.run_box_head(pyr, props)
        final_ms = cuda_ms(lambda: box_dets(scores, hd, props, pvalid, rc),
                           10)
        detect_ms = cuda_ms(lambda: detect_from_features(
            model, pyr, obj, deltas), 10)
        step_rows = device_kernels(lambda: ev._step(x), 3)
        roi_rows = device_kernels(roi, 3)
        del crops
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        ev._step(x)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated(dev)
    flops = conv_dense_flops(model, lambda: ev._step(x))
    busy = sum(ms for _, ms in step_rows)
    roi_dev = sum(ms for _, ms in roi_rows)
    # RoIAlign's least bytes: the pooled levels read once, the crops
    # written once
    roi_bytes = sum(p.numel() * p.element_size() for p in pyr[:nl]) + \
        props.shape[0] * props.shape[1] * 49 * 256 * pyr[0].element_size()
    parts = {"trunk_ms": trunk_ms, "rpn_head_ms": rpn_ms,
             "proposals_ms": prop_ms, "roi_align_ms": roi_ms,
             "roi_align_device_ms": roi_dev, "box_head_ms": head_ms,
             "final_dets_ms": final_ms,
             "second_stage_ms": detect_ms}
    out["step"] = {
        "config": cfg.name, "batch": 8, "img_size": size,
        "step_ms": step_ms, "img_per_s": 8e3 / step_ms,
        "device_busy_ms": busy, "idle_share": 1.0 - busy / step_ms,
        "top_kernels": [[k[:80], ms] for k, ms in step_rows[:8]],
        "peak_memory_bytes": peak, "parts": parts, "flops": flops,
        "bf16_peak_share": flops["total"] / (step_ms * 1e-3) /
        BF16_FLOP_PER_S,
        "roi_align_bytes": roi_bytes,
        "roi_align_bytes_bound_ms": roi_bytes / HBM_BYTES_PER_S * 1e3,
        "device": smi}
    log(f"FasterRCNN eval step B=8 {size}² bf16: {step_ms:.3f} ms "
        f"({8e3 / step_ms:.1f} img/s); device busy {busy:.3f} ms, idle "
        f"share {1 - busy / step_ms:.3f}; peak memory {peak / 1e9:.2f} GB; "
        f"FLOPs {flops['total'] / 1e12:.3f} T (box head "
        f"{flops['box_head'] / 1e12:.3f} T) = "
        f"{out['step']['bf16_peak_share']:.4f} of the bf16 peak; parts "
        + ", ".join(f"{k} {v:.3f}" for k, v in parts.items()))
    log("  top kernels: " + "; ".join(f"{k[:60]} {ms:.3f} ms"
                                      for k, ms in step_rows[:8]))
    out["wall_s"] = time.perf_counter() - t0
    return out


# tolerances of phase 4h.3, the narrow float32 train step on the card
# against the CPU (TF32 off), as phase 4e's: metrics within 1e-4 relative,
# each gradient within 1e-4 of the global gradient norm and 3e-3 of its own
# norm, BatchNorm running statistics within 5e-5 (relative, at least 1
# absolute); the RPN assignment and the box head's on the same proposals
# exactly (iou_matrix is bit-equal to box_iou_matrix), box targets within
# 1e-5 of their largest
RCNN_TRAIN_BATCH = 16
RCNN_TRAIN_LR = 1e-3       # the fixed-batch loss-fall run's AdamW rate


def xyxy_batch(batch):
    """A train batch with its cxcywh gt boxes as xyxy (``gt_boxes_xyxy``),
    the form FasterRCNN's step takes."""
    import torch
    out = {k: v for k, v in batch.items() if k != "gt_boxes"}
    b = batch["gt_boxes"]
    half = b[..., 2:] * 0.5
    out["gt_boxes_xyxy"] = torch.cat([b[..., :2] - half, b[..., :2] + half],
                                     -1)
    return out


def rcnn_train_flops(model, fn) -> dict:
    """Multiply-adds x2 of one train step of ``model``, counted from the
    conv and dense shapes of one forward (``fn``, the loss) by
    ``conv_dense_flops``: the backbone and neck, the dense RPN head (run
    without gradient: forward only), the box head; the backbone's frozen
    stages (forward only) apart; the sparse RPN head's matmuls from their
    shapes. A part with gradients costs 3x its forward (the input's and the
    weights' gradients)."""
    import torch
    from heltondetection_tpu_torch.models.common import BatchNorm2d
    frozen = {"flops": 0}
    stages = model.cfg.backbone_frozen_stages
    prefixes = ("stem_",) + tuple(f"layer{i}_" for i in
                                  range(1, stages + 1)) if stages else ()
    mods = dict(model.backbone.named_modules())
    hooks = []
    for name, m in mods.items():
        if isinstance(m, BatchNorm2d) and name.startswith(prefixes):
            *scope, leaf = name.split(".")
            conv = mods[".".join(scope + [leaf.replace("bn", "conv")])]

            def hook(mod, inp, out, conv=conv):
                k = conv.kernel_size[0] * conv.kernel_size[1]
                frozen["flops"] += 2 * out.numel() * conv.in_channels * k
            hooks.append(m.register_forward_hook(hook))
    try:
        parts = conv_dense_flops(model, fn)
    finally:
        for h in hooks:
            h.remove()
    cfg = model.cfg
    sparse = 2 * RCNN_TRAIN_BATCH * cfg.rpn_batch * (9 * 256 * 256 +
                                                    256 * 15)
    trunk = parts["backbone_neck"]
    step = (3 * (trunk - frozen["flops"]) + frozen["flops"] + parts["rpn"] +
            3 * parts["box_head"] + 3 * sparse)
    return {"trunk": trunk, "trunk_frozen_stages": frozen["flops"],
            "rpn_dense": parts["rpn"], "rpn_sparse": sparse,
            "box_head": parts["box_head"],
            "forward": parts["total"] + sparse, "step": step}


def rcnn_train_phase(dev, smi: str) -> dict:
    """Phase 4h: FasterRCNN training (see the module docstring)."""
    import copy
    import dataclasses
    import tempfile
    import torch
    from heltondetection_tpu_torch.data.augment import TrainPipeline
    from heltondetection_tpu_torch.engine import runner as runner_mod
    from heltondetection_tpu_torch.engine.runner import (_make_detector,
                                                         build_model,
                                                         load_detector,
                                                         train_from_datasets)
    from heltondetection_tpu_torch.kernels import (launch_counts,
                                                   reset_launch_counts)
    from heltondetection_tpu_torch.kernels import iou as iou_kernel
    from heltondetection_tpu_torch.models import faster_rcnn as rcnn_mod
    from heltondetection_tpu_torch.models.common import init_weights
    from heltondetection_tpu_torch.models.faster_rcnn import (
        STRIDES, FasterRCNN, RCNNConfig, _rpn_loss_body, assign_box_targets,
        assign_rpn_targets, box_head_loss, draw_sampling, faster_rcnn_loss,
        generate_proposals, pyramid_anchors, rpn_logits_at)
    from heltondetection_tpu_torch.ops.boxes import box_iou_matrix
    from heltondetection_tpu_torch.ops.roi_align import multilevel_roi_align
    from heltondetection_tpu_torch.train.schedule import make_optimizer
    from heltondetection_tpu_torch.train.trainer import (create_train_state,
                                                         make_rcnn_train_step,
                                                         update_ema)
    t0 = time.perf_counter()
    out = {"card": smi}
    b = RCNN_TRAIN_BATCH
    base = rcnn_config(RCNN_CONFIG)
    size = base.model.img_size
    train_ds, val_ds = SynthFrames(2 * b, 20), SynthFrames(b, 21)
    torch.cuda.empty_cache()

    # 4h.1 the published config through train_from_datasets: 2 epochs x 2
    # steps with the in-loop eval, then a resume for a third epoch
    records = LogRecords()
    with tempfile.TemporaryDirectory() as work:
        cfg = dataclasses.replace(
            base, name="chip_rcnn_train", work_dir=work,
            train=dataclasses.replace(base.train, epochs=2, warmup_epochs=1.0,
                                      eval_interval=1, ckpt_interval=1,
                                      num_workers=8))
        out["config"] = {"name": base.name, "batch_size": cfg.train.batch_size,
                         "img_size": size, "dtype": cfg.model.dtype,
                         "lr": cfg.train.lr, "mosaic_p": cfg.train.mosaic_p,
                         "ema": cfg.train.ema,
                         "grad_accum": cfg.train.grad_accum}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        reset_launch_counts()
        t1 = time.perf_counter()
        try:
            train_from_datasets(cfg, train_ds, val_ds, device=dev)
            torch.cuda.synchronize()
            wall2 = time.perf_counter() - t1
            counts2 = dict(launch_counts)
            peak_run = torch.cuda.max_memory_allocated(dev)
            epochs2 = records.field("epoch_stats")
            evals2 = records.field("eval_stats")
            warned = any("FROM SCRATCH" in r.getMessage()
                         for r in records.records)
            files = sorted(os.listdir(os.path.join(cfg.ckpt_dir, "4")))
            records.records.clear()
            cfg.train.epochs = 3
            reset_launch_counts()
            t1 = time.perf_counter()
            train_from_datasets(cfg, train_ds, val_ds, device=dev)
            torch.cuda.synchronize()
            wall3 = time.perf_counter() - t1
            counts3 = dict(launch_counts)
            epochs3 = records.field("epoch_stats")
            evals3 = records.field("eval_stats")
            resumed = records.field("resumed_step")
            saved = torch.load(os.path.join(cfg.ckpt_dir, "6",
                                            "train_state.pt"),
                               map_location="cpu", weights_only=True)
            # the network load_detector builds, caught on its way into
            # forward_for_eval: random weights trained 6 steps score no
            # class above RCNNConfig.score_thresh, so dets alone could not
            # tell two weight sets apart
            served_nets = []
            ffe = runner_mod.forward_for_eval

            def catch(model, *a, **k):
                served_nets.append(model)
                return ffe(model, *a, **k)
            runner_mod.forward_for_eval = catch
            try:
                served = load_detector(cfg, ckpt=cfg.ckpt_dir, device=dev)
            finally:
                runner_mod.forward_for_eval = ffe
            by_hand_model = build_model(cfg.model, 80)
            by_hand_model.load_state_dict({**saved["model"], **saved["ema"]})
            by_hand = _make_detector(cfg, by_hand_model, 80, device=dev)
        finally:
            records.close()
    n_steps2 = sum(e["steps"] for e in epochs2)
    per_eval = -(-len(val_ds) // cfg.eval.batch_size)
    want2 = {"nms_mask": 5 * n_steps2 + 7 * per_eval * len(evals2),
             "iou_matrix": 2 * b * n_steps2}
    log(f"train_from_datasets {base.name} (ResNet50, PAFPNv8, decoupled "
        f"head, {size}², bf16, B={b}), 2 epochs x 2 steps: {wall2:.1f} s; "
        f"epochs {[(e['epoch'], e['steps'], round(e['total'], 4))
                  for e in epochs2]}; "
        f"in-loop evals AP {[round(e['AP'], 6) for e in evals2]}; launches "
        f"{counts2} (want {want2}); peak memory {peak_run / 1e9:.2f} GB; "
        f"step 4 files {files}; from-scratch warning {warned}")
    log(f"resumed (epochs=3): {wall3:.1f} s; resumed at {resumed}; epochs "
        f"{[(e['epoch'], e['steps'], e['step']) for e in epochs3]}; "
        f"launches {counts3}")
    keys = ("rpn_obj", "rpn_reg", "cls", "box", "total", "grad_norm")
    finite = all(math.isfinite(e[k]) for e in epochs2 + epochs3 for k in keys)
    if not finite or [e["steps"] for e in epochs2] != [2, 2]:
        raise AssertionError(f"FasterRCNN train epochs: {epochs2}")
    if len(evals2) != 2 or counts2["nms_mask"] != want2["nms_mask"] or \
            counts2["iou_matrix"] != want2["iou_matrix"] or \
            counts2["nms_fixpoint"]:
        raise AssertionError(f"FasterRCNN training launched {counts2}, not "
                             f"{want2}")
    want3 = {"nms_mask": 5 * 2 + 7 * per_eval, "iou_matrix": 2 * b * 2}
    if resumed != [4] or [(e["epoch"], e["steps"], e["step"])
                          for e in epochs3] != [(2, 2, 6)] \
            or len(evals3) != 1 or files != ["eval_variables.pt",
                                             "train_state.pt"] \
            or saved.get("rng") is None or any(counts3[k] != v
                                               for k, v in want3.items()):
        raise AssertionError(f"resume: {resumed}, {epochs3}, {files}, "
                             f"{counts3}")
    frames = [f[0] for f in val_ds.frames[:4]]
    got, want = served.detect_batch(frames), by_hand.detect_batch(frames)
    n_dets = sum(len(d[1]) for d in got)
    ema_sd = {**saved["model"], **saved["ema"]}
    net_sd = served_nets[0].state_dict() if len(served_nets) == 1 else {}
    same_weights = net_sd.keys() == ema_sd.keys() and all(
        torch.equal(v.cpu(), ema_sd[k]) for k, v in net_sd.items())
    moved = not all(torch.equal(saved["model"][k], v)
                    for k, v in saved["ema"].items())
    if not all(same_dets(g, w) for g, w in zip(got, want)) or \
            not same_weights or not moved:
        raise AssertionError("load_detector does not serve the trained "
                             "FasterRCNN's EMA weights")
    log(f"load_detector(work dir) serves train_state.pt's EMA weights at "
        f"step 6 (every tensor equal; they differ from the raw weights), "
        f"its dets == a Detector's of them ({n_dets} dets on {len(frames)} "
        f"frames)")
    secs = [e["seconds"] for e in epochs2 + epochs3]
    waits = [e["loader_wait_s"] for e in epochs2 + epochs3]
    out["run_train"] = {
        "launches": counts2, "launches_want": want2,
        "launches_resumed": counts3, "epochs_s": secs,
        "loader_wait_s": waits, "loader_wait_share": sum(waits) / sum(secs),
        "wall_s_2_epochs": wall2, "wall_s_resumed_epoch": wall3,
        "peak_memory_bytes": peak_run,
        "eval_img_per_s": [e["images_per_sec"] for e in evals2 + evals3],
        "metrics": [{k: e[k] for k in keys} for e in epochs2 + epochs3]}
    del served, by_hand, by_hand_model, saved
    torch.cuda.empty_cache()
    log(f"[phase 4h.1 done at {time.perf_counter() - t0:.1f} s of 4h]")

    # 4h.2 the loss falls: 30 steps on one fixed batch of 16, augmentation
    # off, fixed draws, the backbone trained whole
    pipe = TrainPipeline(train_ds, size, mosaic_p=0.0, hsv=False, flip_p=0.0,
                         max_boxes=cfg.data.max_boxes)
    host = [pipe.sample(i) for i in range(b)]
    batch = xyxy_batch({k: torch.from_numpy(np.stack([s[k] for s in host]))
                        .to(dev) for k in host[0]})
    n_anchors = pyramid_anchors(size)[0].shape[0]
    fall_mc = dataclasses.replace(cfg.model, backbone_norm_eval=False,
                                  backbone_frozen_stages=0)
    model = build_model(fall_mc, 80)
    n_rois = model.cfg.rpn_post_nms_topk + batch["gt_boxes_xyxy"].shape[1]
    init_weights(model, torch.Generator().manual_seed(0))
    model = model.to(dev, memory_format=torch.channels_last)
    state = create_train_state(model, make_optimizer(
        model, RCNN_TRAIN_LR, total_steps=30, warmup_steps=3))
    draws = draw_sampling(torch.Generator(dev).manual_seed(5), b, n_anchors,
                          n_rois)
    step = make_rcnn_train_step()
    totals = []
    for _ in range(30):
        state, m = step(state, batch, [draws])
        totals.append(m["total"])
    totals = [float(t) for t in totals]
    ratio = float(np.mean(totals[-5:]) / np.mean(totals[:5]))
    log(f"fixed batch of {b}, 30 steps (norm_eval off, no frozen stage, "
        f"AdamW {RCNN_TRAIN_LR}): total {totals[0]:.3f} → {totals[-1]:.3f}; "
        f"last-5 / first-5 mean {ratio:.4f} (must be ≤ {LOSS_FALL_RATIO})")
    if not all(math.isfinite(t) for t in totals) or ratio > LOSS_FALL_RATIO:
        raise AssertionError(f"the FasterRCNN loss did not fall: {totals}")
    out["loss_fall"] = {"totals": totals, "ratio": ratio,
                        "required_ratio": LOSS_FALL_RATIO,
                        "lr": RCNN_TRAIN_LR}
    del model, state
    torch.cuda.empty_cache()
    log(f"[phase 4h.2 done at {time.perf_counter() - t0:.1f} s of 4h]")

    # 4h.3 the card equals the CPU: a narrow float32 FasterRCNN, one step
    ncfg = RCNNConfig(num_classes=20, img_size=256, backbone="resnet18",
                      neck="pafpn_v8", head="decoupled",
                      rpn_pre_nms_topk=256, rpn_post_nms_topk=64)
    with torch.device("meta"):
        narrow = FasterRCNN(ncfg)
    narrow = narrow.to_empty(device="cpu")
    init_weights(narrow, torch.Generator().manual_seed(1))
    small_pipe = TrainPipeline(train_ds, 256, mosaic_p=0.0, hsv=False,
                               flip_p=0.0, max_boxes=16)
    host = [small_pipe.sample(i) for i in range(2)]
    small = xyxy_batch({k: torch.from_numpy(np.stack([s[k] for s in host]))
                        for k in host[0]})
    small["gt_cls"] = small["gt_cls"] % 20
    xs = small["image"].float() / 255.0
    tame_rcnn(narrow.eval(), xs)
    n_small = pyramid_anchors(256)[0].shape[0]
    cdraws = draw_sampling(torch.Generator().manual_seed(6), 2, n_small,
                           64 + small["gt_boxes_xyxy"].shape[1])
    gdraws = type(cdraws)(*(tuple(u.to(dev) for u in part)
                            for part in cdraws))
    # the assignments, on the same inputs: exactly equal
    with torch.no_grad():
        _, c_obj, c_deltas = narrow(xs)
        c_props, _, c_pvalid = generate_proposals(
            c_obj, c_deltas, narrow.anchors("cpu"),
            pyramid_anchors(256)[1], 256, ncfg)
    args = (small["gt_boxes_xyxy"], small["gt_mask"])
    c_rpn = assign_rpn_targets(narrow.anchors("cpu"), *args, ncfg,
                               cdraws.rpn)
    g_rpn = assign_rpn_targets(narrow.anchors("cpu").to(dev),
                               *(a.to(dev) for a in args), ncfg, gdraws.rpn)
    c_box = assign_box_targets(c_props, c_pvalid, small["gt_boxes_xyxy"],
                               small["gt_cls"], small["gt_mask"], ncfg,
                               cdraws.box)
    g_box = assign_box_targets(c_props.to(dev), c_pvalid.to(dev),
                               small["gt_boxes_xyxy"].to(dev),
                               small["gt_cls"].to(dev),
                               small["gt_mask"].to(dev), ncfg, gdraws.box)
    same_assign = all(torch.equal(c, g.cpu()) for c, g in zip(c_rpn, g_rpn)) \
        and all(torch.equal(c_box[i], g_box[i].cpu()) for i in (0, 1, 3, 4))
    reg_err = float((c_box[2] - g_box[2].cpu()).abs().max() /
                    c_box[2].abs().max())
    # one train step on each, the card's on the CPU step's proposals: an
    # NMS over boxes that differ by rounding may keep another proposal on
    # each, and then the second stage samples another roi; the proposals
    # themselves are compared apart
    proposals = {}
    own_proposals = rcnn_mod.generate_proposals

    def shared_proposals(*a, **k):
        out = own_proposals(*a, **k)
        proposals.setdefault(str(out[0].device), out)
        cpu = proposals.get("cpu")
        return tuple(t.to(out[0].device) for t in cpu) if cpu else out

    runs = {}
    rcnn_mod.generate_proposals = shared_proposals
    try:
        for where, d in (("cpu", cdraws), (str(dev), gdraws)):
            m_ = copy.deepcopy(narrow).to(where)
            st = create_train_state(m_, make_optimizer(
                m_, 1e-3, total_steps=10, warmup_steps=1))
            st, met = make_rcnn_train_step()(
                st, {k: v.to(where) for k, v in small.items()}, [d])
            runs[where] = (m_, {k: float(v) for k, v in met.items()})
    finally:
        rcnn_mod.generate_proposals = own_proposals
    pc, pg = proposals["cpu"], [t.cpu() for t in proposals[str(dev)]]
    prop_valid_equal = torch.equal(pc[2], pg[2])
    prop_px = float((pc[0] - pg[0]).abs().amax(-1)[pc[2] & pg[2]].max())
    prop_far = int(((pc[0] - pg[0]).abs().amax(-1) > 0.05).sum())
    (mc, metc), (mg, metg) = runs["cpu"], runs[str(dev)]
    metric_errs = {k: abs(metg[k] - metc[k]) / max(abs(metc[k]), 1e-12)
                   for k in metc}
    metric_err = max(metric_errs.values())
    gnorm = metc["grad_norm"]
    pairs = [(pc, pg) for pc, pg in zip(mc.parameters(), mg.parameters())
             if pc.grad is not None]
    grad_own = max(float((pg.grad.cpu() - pc.grad).abs().max() /
                         pc.grad.norm().clamp(min=1e-30)) for pc, pg in pairs)
    grad_global = max(float((pg.grad.cpu() - pc.grad).abs().max())
                      for pc, pg in pairs) / gnorm
    sc, sg = mc.state_dict(), mg.state_dict()
    stat_err = max(float(((sg[k].cpu() - sc[k]).abs() /
                          sc[k].abs().clamp(min=1.0)).max())
                   for k in sc if "running" in k)
    log(f"narrow f32 FasterRCNN train step (ResNet18, 256², B=2), card vs "
        f"CPU: assignments equal {same_assign} (box targets within "
        f"{reg_err:.3g} of their largest); the card's own proposals: valid "
        f"masks equal {prop_valid_equal}, {prop_far} of "
        f"{pc[0].shape[0] * pc[0].shape[1]} more than 0.05 px apart (the "
        f"rest within {prop_px:.3g} px); metrics rel "
        f"{ {k: float(f'{v:.3g}') for k, v in metric_errs.items()} }; grads "
        f"max |Δ| {grad_own:.3g} of the tensor's norm, {grad_global:.3g} of "
        f"the global norm; BN running stats {stat_err:.3g}")
    if not (same_assign and reg_err <= 1e-5 and metric_err <= 1e-4
            and grad_global <= 1e-4 and grad_own <= 3e-3
            and stat_err <= 5e-5):
        raise AssertionError("the narrow FasterRCNN train step on the card "
                             "differs from the CPU's")
    out["card_vs_cpu"] = {"assignments_equal": same_assign,
                          "box_target_rel_err": reg_err,
                          "own_proposals_valid_equal": prop_valid_equal,
                          "own_proposals_far": prop_far,
                          "own_proposals_px": prop_px,
                          "metric_rel_err": metric_errs,
                          "grad_err_of_tensor_norm": grad_own,
                          "grad_err_of_global_norm": grad_global,
                          "bn_stat_err": stat_err}
    del runs, mc, mg
    log(f"[phase 4h.3 done at {time.perf_counter() - t0:.1f} s of 4h]")

    # 4h.4 iou_matrix at the RPN assigner's shape: every anchor of 832²
    # against a padded gt set of 128
    anchors = torch.from_numpy(pyramid_anchors(size)[0]).to(dev)
    gts = torch.from_numpy(sorted_boxes(np.random.default_rng(8), 1, 128,
                                        size=float(size))[0]).to(dev)
    got = iou_kernel.iou_matrix(anchors, gts)
    want = box_iou_matrix(anchors, gts)
    torch.cuda.synchronize()
    ulp = max_ulp(got, want)
    n, m_ = anchors.shape[0], gts.shape[0]
    assigner = {
        "shape": [n, m_], "max_ulp": ulp,
        "max_abs_err": float((got - want).abs().max()),
        "ms": cuda_ms(lambda: iou_kernel.iou_matrix(anchors, gts), 20),
        "device_ms": profiled_ms(lambda: iou_kernel.iou_matrix(anchors, gts),
                                 10, ("iou_matrix_kernel",))[
                                     "iou_matrix_kernel"],
        "plain_ms": cuda_ms(lambda: box_iou_matrix(anchors, gts), 10),
        "bound": iou_bound_ms(n, m_)}
    log(f"iou_matrix at the RPN assigner's shape ({n}, {m_}): {ulp} ulp "
        f"from box_iou_matrix; events {assigner['ms']:.4f} ms, device "
        f"{assigner['device_ms']} ms, plain {assigner['plain_ms']:.4f} ms, "
        f"bound {assigner['bound'][0]:.5f} ms ({assigner['bound'][1]})")
    if tuple(got.shape) != (n, m_) or ulp > 1:
        raise AssertionError(f"iou_matrix is {ulp} ulp from the plain "
                             f"version at ({n}, {m_})")
    out["iou_assigner"] = assigner
    del got, want

    # 4h.5 the step's numbers at B=16 with the published knobs (the
    # backbone's stem and layer1 frozen, its BatchNorm on running stats)
    model = build_model(cfg.model, 80)
    init_weights(model, torch.Generator().manual_seed(1))
    model = model.to(dev, memory_format=torch.channels_last)
    state = create_train_state(model, make_optimizer(
        model, cfg.train.lr, total_steps=100, warmup_steps=1),
        rng=torch.Generator(dev).manual_seed(7))
    rc = model.cfg
    step = make_rcnn_train_step()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    step_ms = cuda_ms(lambda: step(state, batch), 10, warmup=2)
    peak = torch.cuda.max_memory_allocated(dev)
    rows = device_kernels(lambda: step(state, batch), 3)
    busy = sum(ms for _, ms in rows)
    _, counts = pyramid_anchors(size)
    anchors = model.anchors(dev)
    nl = rc.roi_levels
    gt, gc, gm = (batch[k] for k in ("gt_boxes_xyxy", "gt_cls", "gt_mask"))
    names = ("trunk_forward", "proposals", "assigners", "rpn_sparse_loss",
             "roi_align_forward", "box_head_and_loss", "backward",
             "optimizer_ema")
    parts = dict.fromkeys(names, 0.0)
    n_parts = 3
    for _ in range(n_parts):
        d = draw_sampling(state.rng, b, n_anchors, n_rois)
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(9)]
        model.train()
        model.zero_grad(set_to_none=True)
        ev[0].record()
        pyr = model.features(batch["image"].float() / 255.0)
        ev[1].record()
        with torch.no_grad():
            obj, deltas = model.rpn(pyr)
            props, _, pvalid = generate_proposals(obj, deltas, anchors,
                                                  counts, size, rc)
        ev[2].record()
        idx, is_fg, valid, matched = assign_rpn_targets(anchors, gt, gm, rc,
                                                        d.rpn)
        rois, labels, reg_t, bfg, bvalid = assign_box_targets(
            props, pvalid, gt, gc, gm, rc, d.box)
        ev[3].record()
        obj_k, reg_k = rpn_logits_at(model.rpn, pyr, idx, model.dtype)
        l_obj, l_reg = _rpn_loss_body(obj_k, reg_k, anchors, idx, is_fg,
                                      valid, matched, gt)
        ev[4].record()
        crops = multilevel_roi_align(
            [p.permute(0, 2, 3, 1) for p in pyr[:nl]], rois, STRIDES[:nl],
            out_size=7, method=rc.roi_method)
        ev[5].record()
        sc_, hd = model.box_head(crops.reshape(-1, *crops.shape[2:]))
        l_cls, l_box = box_head_loss(
            sc_.reshape(b, -1, sc_.shape[-1]),
            hd.reshape(b, -1, *hd.shape[1:]), labels, reg_t, bfg, bvalid)
        total = l_obj.mean() + l_reg.mean() + l_cls.mean() + l_box.mean()
        ev[6].record()
        total.backward()
        ev[7].record()
        state.optimizer.step()
        update_ema(state.ema, model, state.step)
        state.step += 1
        ev[8].record()
        torch.cuda.synchronize()
        for i, k in enumerate(names):
            parts[k] += ev[i].elapsed_time(ev[i + 1]) / n_parts
        del pyr, obj, deltas, props, crops, sc_, hd, total
    # RoIAlign's backward alone: its scatter into the pyramid's rows
    with torch.no_grad():
        pyr = model.features(batch["image"].float() / 255.0)
        obj, deltas = model.rpn(pyr)
        props = generate_proposals(obj, deltas, anchors, counts, size, rc)
        rois = assign_box_targets(props[0], props[2], gt, gc, gm, rc,
                                  draw_sampling(state.rng, b, n_anchors,
                                                n_rois).box)[0]
    feats = [p.detach().permute(0, 2, 3, 1).requires_grad_()
             for p in pyr[:nl]]

    def roi_fwd():
        return multilevel_roi_align(feats, rois, STRIDES[:nl], out_size=7,
                                    method=rc.roi_method)

    g = torch.randn_like(roi_fwd())
    roi_bwd_ms = 0.0
    for _ in range(5):
        crops = roi_fwd()
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        e0.record()
        crops.backward(g)
        e1.record()
        torch.cuda.synchronize()
        roi_bwd_ms += e0.elapsed_time(e1) / 5
    roi_rows = device_kernels(lambda: roi_fwd().backward(g), 3)
    parts["roi_align_backward_alone"] = roi_bwd_ms
    parts["roi_align_fwd_bwd_device"] = sum(ms for _, ms in roi_rows)
    del pyr, obj, deltas, props, feats, g, crops
    flops = rcnn_train_flops(model, lambda: faster_rcnn_loss(
        model, batch["image"].float() / 255.0, gt, gc, gm,
        draws=state.rng))
    mfu = flops["step"] / (step_ms * 1e-3) / BF16_FLOP_PER_S
    out["step"] = {
        "config": base.name, "batch": b, "img_size": size,
        "ms": step_ms, "img_per_s": b * 1e3 / step_ms,
        "device_busy_ms": busy, "idle_share": 1.0 - busy / step_ms,
        "top_kernels": [[k[:80], ms] for k, ms in rows[:8]],
        "max_memory_allocated_bytes": peak, "parts_ms": parts,
        "roi_align_top_kernels": [[k[:80], ms] for k, ms in roi_rows[:4]],
        "flops": flops, "bf16_peak_flop_per_s": BF16_FLOP_PER_S,
        "bf16_peak_share": mfu, "device": smi}
    log(f"FasterRCNN train step B={b} {size}² bf16 on {smi}: {step_ms:.3f} "
        f"ms, {b * 1e3 / step_ms:.1f} img/s | device busy {busy:.3f} ms, "
        f"idle share {1.0 - busy / step_ms:.3f} | peak memory "
        f"{peak / 1e9:.2f} GB | {flops['step'] / 1e12:.3f} TFLOP a step, "
        f"{mfu:.4f} of the bf16 peak | parts "
        + ", ".join(f"{k} {v:.3f}" for k, v in parts.items()))
    log("  top kernels: " + "; ".join(f"{k[:60]} {ms:.3f} ms"
                                      for k, ms in rows[:8]))
    del model, state, batch
    torch.cuda.empty_cache()
    out["wall_s"] = time.perf_counter() - t0
    return out


# phase 4i writes its programs (about 30 MB for YOLOv5s, 180 MB for the
# FasterRCNN) and panels into a temporary directory under runs/, which
# .gitignore lists, and deletes it at the end
RUNS_DIR = os.path.join(ROOT, "runs")
YOLO_CONFIG = "configs/yolov5_s_coco_640.py"
ULTRALYTICS_V61_YOLOV5S_GFLOPS = 16.5   # Ultralytics' v6.1 table, 640²


def png_size(path: str) -> tuple:
    """(width, height) of a PNG, from its IHDR chunk."""
    import struct
    with open(path, "rb") as f:
        head = f.read(24)
    if head[:8] != b"\x89PNG\r\n\x1a\n" or head[12:16] != b"IHDR":
        raise AssertionError(f"{path} is not a PNG")
    return struct.unpack(">II", head[16:24])


def export_phase(dev, smi: str, model, work: str) -> dict:
    """Phase 4i.1: export_model of yolov5_s_coco_640 (phase 4a's seed-0
    weights; test.conf_thres 0.001, so random weights give dets) and of
    faster_rcnn_pafpn_decoupled_coco_832 (seed 0, predictors scaled) into
    ``work``, each loaded with load_serving_fn and run on seeded uint8
    frames at B=1: dets equal to the eager serving function's on the card,
    nms_mask launched 1 and 6 times a call, the export's seconds and ms a
    call of the loaded program against the eager function."""
    import dataclasses
    import torch
    from heltondetection_tpu_torch.engine import export as E
    from heltondetection_tpu_torch.kernels import (launch_counts,
                                                   reset_launch_counts)
    rng = np.random.default_rng(41)
    ycfg = rcnn_config(YOLO_CONFIG)
    ycfg = dataclasses.replace(ycfg, test=dataclasses.replace(
        ycfg.test, conf_thres=0.001))
    rcfg = rcnn_config(RCNN_CONFIG)
    rs = rcfg.model.img_size
    xr = torch.from_numpy(rng.integers(0, 256, (2, rs, rs, 3))
                          .astype(np.float32) / 255.0).to(dev)
    rmodel = rcnn_model(rcfg, dev, 0, xr)
    out = {"card": smi}
    cases = (("yolov5_s_coco_640", ycfg, model, 1,
              E.yolov5_serve(80, conf_thres=ycfg.test.conf_thres,
                             iou_thres=ycfg.test.iou_thres)),
             ("faster_rcnn_pafpn_decoupled_coco_832", rcfg, rmodel, 6,
              E.faster_rcnn_serve))
    for name, cfg, net, per_call, serve in cases:
        size = cfg.model.img_size
        path = os.path.join(work, f"{name}.pt2")
        t0 = time.perf_counter()
        E.export_model(cfg, net, path, device=dev)
        export_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        fn = E.load_serving_fn(path)
        load_s = time.perf_counter() - t0
        frames = [torch.from_numpy(rng.integers(0, 256, (1, size, size, 3))
                                   .astype(np.uint8)).to(dev)
                  for _ in range(3)]
        fn(frames[0])
        torch.cuda.synchronize()
        reset_launch_counts()
        got = [fn(f) for f in frames]
        torch.cuda.synchronize()
        counts = dict(launch_counts)

        def eager(f, net=net, serve=serve):
            with torch.inference_mode():
                return serve(net, f)

        want = [eager(f) for f in frames]
        bits = all(a.dtype == b.dtype and torch.equal(a, b)
                   for g, w in zip(got, want) for a, b in zip(g, w))
        n_dets = sum(int(g[3].sum()) for g in got)
        log(f"export [{name}]: {export_s:.2f} s export, {load_s:.2f} s "
            f"load, {os.path.getsize(path) / 1e6:.1f} MB; 3 calls at B=1: "
            f"launches {counts}, {n_dets} dets, bit-equal to eager: {bits}")
        if not bits:
            raise AssertionError(f"the loaded {name} program's dets differ "
                                 f"from the eager function's")
        if counts != {"nms_fixpoint": 0, "nms_mask": per_call * 3,
                      "iou_matrix": 0}:
            raise AssertionError(f"the loaded {name} program launched "
                                 f"{counts}, not nms_mask {per_call} a call")
        if n_dets == 0 or not all(bool(torch.isfinite(g[0]).all())
                                  for g in got):
            raise AssertionError(f"the loaded {name} program gave no or "
                                 f"non-finite dets")
        loaded_ms, eager_ms = [], []
        for timed in ("loaded", "eager", "eager", "loaded"):
            f = fn if timed == "loaded" else eager
            (loaded_ms if timed == "loaded" else eager_ms).append(
                cuda_ms(lambda f=f: f(frames[0]), 10))
        busy = {"loaded": device_work(lambda: fn(frames[0])),
                "eager": device_work(lambda: eager(frames[0]))}
        log(f"export [{name}]: ms a call by CUDA events, loaded "
            f"{loaded_ms[0]:.3f} / {loaded_ms[1]:.3f}, eager "
            f"{eager_ms[0]:.3f} / {eager_ms[1]:.3f}; device ms and kernels "
            f"a call (profiler): loaded {busy['loaded']}, eager "
            f"{busy['eager']} ({smi})")
        out[name] = {"export_s": export_s, "load_s": load_s,
                     "pt2_mb": os.path.getsize(path) / 1e6,
                     "launches_per_call": counts["nms_mask"] / 3,
                     "dets": n_dets, "bit_equal": bits,
                     "loaded_ms": loaded_ms, "eager_ms": eager_ms,
                     "loaded_device_ms_kernels": busy["loaded"],
                     "eager_device_ms_kernels": busy["eager"]}
    return out, rmodel


def run_test_phase(dev, smi: str, model, rmodel, work: str) -> dict:
    """Phase 4i.2: run_test of both configs (their seed-0 weights written
    as checkpoints) on in-memory frames (readers.imread_rgb swapped for a
    lookup) with out_path=None, the rendered frame needing cv2: YOLOv5
    launches nms_fixpoint, FasterRCNN nms_mask 7 times (its Detector:
    faster_rcnn_infer's 6 and the single-label postprocess); then _save_heatmap_panels writes the panels with the
    port's PNG writer into ``work`` (FasterRCNN's class-score panel runs
    generate_proposals: 5 more nms_mask launches), one panel of the image's
    size a level."""
    import dataclasses
    import torch
    from heltondetection_tpu_torch.data import readers
    from heltondetection_tpu_torch.engine import runner
    from heltondetection_tpu_torch.kernels import (launch_counts,
                                                   reset_launch_counts)
    from heltondetection_tpu_torch.utils.ckpt import save_eval_variables
    rng = np.random.default_rng(42)
    out = {"card": smi}
    read_orig = readers.imread_rgb
    cases = (("yolov5_s_coco_640", YOLO_CONFIG, model, 3, "nms_fixpoint",
              (720, 1280)),
             ("faster_rcnn_pafpn_decoupled_coco_832", RCNN_CONFIG, rmodel, 5,
              "nms_mask", (600, 800)))
    for name, config, net, levels, kernel, hw in cases:
        cfg = rcnn_config(config)
        cfg = dataclasses.replace(
            cfg, work_dir=work, test=dataclasses.replace(
                cfg.test, conf_thres=0.001, save_heatmaps=True))
        save_eval_variables(cfg.ckpt_dir, net.state_dict(), 1)
        frame = rng.integers(0, 256, hw + (3,)).astype(np.uint8)
        source = os.path.join(work, f"{name}.jpg")
        readers.imread_rgb = {source: frame}.__getitem__
        try:
            reset_launch_counts()
            t0 = time.perf_counter()
            res = runner.run_test(cfg, source, None, device=dev)
            torch.cuda.synchronize()
            test_s = time.perf_counter() - t0
            counts = dict(launch_counts)
            stem = os.path.join(work, f"{name}_test.png")
            reset_launch_counts()
            t0 = time.perf_counter()
            runner._save_heatmap_panels(cfg, net, source, stem,
                                        device=dev)
            torch.cuda.synchronize()
            panels_s = time.perf_counter() - t0
            panel_counts = dict(launch_counts)
        finally:
            readers.imread_rgb = read_orig
        n_dets = check_dets(frame, (res["boxes"], res["scores"],
                                    res["classes"]))
        files = ["heatmaps", "objmaps"] + (["clsmaps"] if levels == 5
                                           else [])
        sizes = {k: png_size(f"{stem[:-4]}_{k}.png") for k in files}
        log(f"run_test [{name}]: {hw[1]}x{hw[0]} frame, {n_dets} dets "
            f"in {test_s:.2f} s, launches {counts}; panels in "
            f"{panels_s:.2f} s, launches {panel_counts}, sizes {sizes}")
        if counts[kernel] < 1 or (kernel == "nms_mask" and
                                  counts != {"nms_fixpoint": 0,
                                             "nms_mask": 7,
                                             "iou_matrix": 0}):
            raise AssertionError(f"run_test [{name}] launched {counts}")
        if kernel == "nms_fixpoint" and counts["nms_mask"]:
            raise AssertionError(f"run_test [{name}] launched nms_mask")
        size = cfg.model.img_size
        if any(v != (size * levels, size) for v in sizes.values()):
            raise AssertionError(f"run_test [{name}] panels {sizes}, "
                                 f"not {levels} of {size}²")
        if levels == 5 and panel_counts["nms_mask"] != 5:
            raise AssertionError(f"the class-score panel launched "
                                 f"{panel_counts}")
        out[name] = {"dets": n_dets, "launches": counts,
                     "panel_launches": panel_counts, "test_s": test_s,
                     "panels_s": panels_s,
                     "panel_sizes": {k: list(v)
                                     for k, v in sizes.items()}}
    return out


class PaintedFrames:
    """A val set of 640² frames whose gt is PAINTED_GTS: the reader that
    run_eval's EvalPipeline loads and registers gt from."""

    def __init__(self, n: int):
        self.n = n
        self.num_classes = 80
        self.class_names = None
        self.label_to_cat = {i: 1000 + i for i in range(80)}

    def __len__(self):
        return self.n

    def load(self, i: int) -> dict:
        return {"image": np.zeros((640, 640, 3), np.uint8), "img_id": i}

    def gt_for_eval(self, det_eval) -> None:
        xywh = [(cx - w / 2, cy - h / 2, w, h)
                for cx, cy, w, h in PAINTED_GTS]
        for i in range(self.n):
            det_eval.add_gt(i, xywh, PAINTED_CLS)


def artifacts_phase(dev, smi: str, model, evaluator, batches,
                    gt_eval) -> dict:
    """Phase 4i.3: run_eval(dump_json=..., verbose=True) of
    yolov5_s_coco_640 (the unfused route, its forward swapped for phase
    4b's painted raw maps) over 64 painted frames: AP > 0.99, the JSON as
    long as the dets, the classwise table, the FLOPs line and (without
    matplotlib) the rendering-unavailable line logged, the native matcher
    built and called; then the Evaluator's img/s over phase 4b's 64 frames
    with the native matcher and with the numpy one, in turns; YOLOv5s's
    GFLOPs at 640² against Ultralytics' 16.5."""
    import dataclasses
    import importlib.util
    import tempfile
    import torch
    from heltondetection_tpu_torch import native
    from heltondetection_tpu_torch.engine import runner
    from heltondetection_tpu_torch.models.yolov5 import decode_full
    from heltondetection_tpu_torch.utils.flops import model_complexity
    out = {"card": smi}
    raws = [torch.from_numpy(r).to(dev)
            for r in paint_raw_maps(PAINTED_GTS, PAINTED_CLS, 640, 80)]

    def painted_forward(net, nc, anchors=None, device=None):
        return lambda images: decode_full(
            [r.expand(images.shape[0], -1, -1, -1) for r in raws], nc)

    ds = PaintedFrames(64)
    records = LogRecords()
    fwd_orig = runner.forward_for_eval
    native.match_calls = 0
    with tempfile.TemporaryDirectory() as work:
        cfg = rcnn_config(YOLO_CONFIG)
        cfg = dataclasses.replace(cfg, work_dir=work, eval=dataclasses.replace(
            cfg.eval, fused=False, conf_thres=0.1))
        path = os.path.join(work, "dets.json")
        runner.forward_for_eval = painted_forward
        try:
            reuse = {"ds": ds}
            t0 = time.perf_counter()
            stats = runner.run_eval(cfg, model.state_dict(), model,
                                    dump_json=path, verbose=True,
                                    _reuse=reuse, device=dev)
            eval_s = time.perf_counter() - t0
            matchings = native.match_calls
        finally:
            runner.forward_for_eval = fwd_orig
            records.close()
        with open(path) as f:
            dumped = json.load(f)
    n_dets = sum(len(v) for v in reuse["det"]._dts.values())
    text = "\n".join(r.getMessage() for r in records.records)
    has_mpl = importlib.util.find_spec("matplotlib") is not None
    flops_line = [ln for ln in text.splitlines() if ln.startswith("FLOPs:")]
    built = native.get_cocoeval_lib() is not None
    log(f"run_eval(dump_json, verbose) on 64 painted frames: AP "
        f"{stats['AP']:.6f} in {eval_s:.2f} s, {len(dumped)} JSON dets of "
        f"{n_dets}; native matcher built {built}, {matchings} matchings in "
        f"C++; matplotlib {has_mpl}; {flops_line}")
    if not stats["AP"] > 0.99 or len(dumped) != n_dets or n_dets == 0:
        raise AssertionError(f"painted run_eval: AP {stats['AP']}, JSON "
                             f"{len(dumped)} of {n_dets} dets")
    if {d["category_id"] for d in dumped} - {1000 + c for c in PAINTED_CLS}:
        raise AssertionError("the JSON's category ids are not mapped back")
    wanted = ["per-class AP", "FLOPs:"] + (
        ["eval artifacts:"] if has_mpl else
        ["eval artifact rendering unavailable"])
    missing = [w for w in wanted if w not in text]
    if missing or not built or matchings == 0:
        raise AssertionError(f"run_eval's artifacts: missing {missing}, "
                             f"native built {built}, calls {matchings}")
    for ln in text.splitlines():
        if ln.startswith(("FLOPs:", "eval artifact")):
            log(f"  logged: {ln}")

    # the Evaluator over phase 4b's 64 frames: the native matcher and the
    # numpy one in turns, three times each, the same stats. Its
    # images_per_sec leaves out the final summarize, where the matching
    # runs, so the run's whole wall time is read too
    rates = {"native": [], "numpy": []}
    whole = {"native": [], "numpy": []}
    stats_by = {}
    lib = native.get_cocoeval_lib()
    for matcher in ("native", "numpy", "numpy", "native", "native",
                    "numpy"):
        native._LIB, native._TRIED = (lib, True) if matcher == "native" \
            else (None, True)
        try:
            t0 = time.perf_counter()
            s = evaluator.run(batches, det_eval=gt_eval())
            whole[matcher].append(s["num_images"] /
                                  (time.perf_counter() - t0))
        finally:
            native._LIB, native._TRIED = lib, True
        rates[matcher].append(s["images_per_sec"])
        stats_by[matcher] = {k: v for k, v in s.items()
                             if k != "images_per_sec"}
    log(f"Evaluator over 64 frames (unfused route), img/s with the summarize "
        f"(its matching): native {whole['native']}, numpy "
        f"{whole['numpy']}; its images_per_sec (the host accumulate, no "
        f"summarize): native {rates['native']}, numpy {rates['numpy']} "
        f"({smi})")
    if stats_by["native"] != stats_by["numpy"]:
        raise AssertionError("the native and numpy matchers disagree")

    comp = model_complexity(model, 640)
    diff = comp["gflops_per_image"] / ULTRALYTICS_V61_YOLOV5S_GFLOPS - 1.0
    log(f"YOLOv5s at 640²: {comp['gflops_per_image']:.3f} GFLOPs/img, "
        f"{comp['mparams']:.3f} MParams; Ultralytics v6.1 publishes "
        f"{ULTRALYTICS_V61_YOLOV5S_GFLOPS} GFLOPs: {diff * 100:+.2f} %")
    if abs(diff) > 0.05:
        raise AssertionError("YOLOv5s's counted GFLOPs are over 5 % off "
                             "Ultralytics' 16.5")
    out.update({"painted_AP": stats["AP"], "json_dets": len(dumped),
                "eval_s": eval_s, "native_built": built,
                "native_matchings": matchings,
                "matplotlib": has_mpl,
                "img_per_s_with_summarize_native": whole["native"],
                "img_per_s_with_summarize_numpy": whole["numpy"],
                "images_per_sec_native": rates["native"],
                "images_per_sec_numpy": rates["numpy"],
                "gflops_per_image_640": comp["gflops_per_image"],
                "mparams": comp["mparams"],
                "gflops_vs_ultralytics": diff})
    return out


def ops_cost_phase(dev, smi: str) -> dict:
    """Phase 4i.4: each kernel by CUDA events through its custom op
    (torch.ops.heltondetection.*) and through its wrapper, in turns (op,
    wrapper, wrapper, op), at the kernel table's shapes."""
    import torch
    from heltondetection_tpu_torch.kernels import iou as iou_kernel
    from heltondetection_tpu_torch.kernels import nms as nms_kernel
    ops = torch.ops.heltondetection
    rng = np.random.default_rng(43)
    b32 = torch.from_numpy(class_offset_boxes(rng, 32, 1024, 200)).to(dev)
    b8 = torch.from_numpy(class_offset_boxes(rng, 8, 1024, 100)).to(dev)
    a = torch.from_numpy(sorted_boxes(rng, 1, 1024)[0]).to(dev)
    m = torch.from_numpy(sorted_boxes(rng, 1, 25200)[0]).to(dev)
    cases = {
        "nms_fixpoint B=32 N=1024": (ops.nms_fixpoint, nms_kernel.nms_fixpoint,
                                     (b32, 0.65)),
        "nms_mask B=32 N=1024": (ops.nms_mask, nms_kernel.nms_mask,
                                 (b32, 0.65)),
        "nms_mask B=8 N=1024": (ops.nms_mask, nms_kernel.nms_mask,
                                (b8, 0.65)),
        "iou_matrix 1024x25200": (ops.iou_matrix, iou_kernel.iou_matrix,
                                  (a, m)),
    }
    out = {"card": smi}
    for label, (op, wrapper, args) in cases.items():
        if not torch.equal(op(*args), wrapper(*args)):
            raise AssertionError(f"{label}: the op and the wrapper differ")
        t = {"op": [], "wrapper": []}
        for which in ("op", "wrapper", "wrapper", "op"):
            fn = op if which == "op" else wrapper
            t[which].append(cuda_ms(lambda fn=fn: fn(*args), 50))
        log(f"op cost [{label}]: through the op {t['op']} ms, the wrapper "
            f"{t['wrapper']} ms ({smi})")
        out[label] = {"op_ms": t["op"], "wrapper_ms": t["wrapper"]}
    return out


# phase 4j: W8A8 int8 serving. The calibration set: 32 seeded frames
# (letterboxed to each config's size); the H100's dense int8 tensor-core
# peak (NVIDIA data sheet, SXM) bounds int8_conv2d beside HBM
INT8_OPS_PER_S = 1979e12
INT8_CALIB_FRAMES = 32
# the float32 serve step's dets on the card against the CPU's: boxes within
# 2 px and scores within 0.02, at most 5 % unmatched (the int8 step's are
# recorded with the same matching, not held)
INT8_CPU_BOX_TOL, INT8_CPU_SCORE_TOL, INT8_CPU_MISS_SHARE = 2.0, 0.02, 0.05


class Int8Convs:
    """Inside the block, every int8 product of the quantized models
    (``int8_conv2d`` through ``LayerQuant``/``FlowQuant``) records its
    int8 input, weight and geometry by distinct shape, and ``calls``
    counts the products."""

    def __init__(self):
        self.shapes, self.calls = {}, 0

    def __enter__(self):
        from heltondetection_tpu_torch.models import common
        self.orig = common.int8_conv2d

        def recording(x_q, w_q, stride=1, pad=0, groups=1):
            self.calls += 1
            key = (tuple(x_q.shape), tuple(w_q.shape), stride, pad, groups)
            if key not in self.shapes:
                self.shapes[key] = [x_q.clone(), w_q, 0]
            self.shapes[key][2] += 1
            return self.orig(x_q, w_q, stride, pad, groups)

        common.int8_conv2d = recording
        return self

    def __exit__(self, *exc):
        from heltondetection_tpu_torch.models import common
        common.int8_conv2d = self.orig


def int8_layers_card_vs_cpu(model, tree, x) -> dict:
    """Every quantized conv of ``tree`` on a packed copy of ``model`` on
    the card, run on ``x`` (uint8 frames on the card): its recorded input,
    moved to the CPU, through the same conv of a CPU copy must quantize to
    the same int8 codes, and their int8 products must give the same int32
    sums on both devices. The float parts around (the affine, SiLU) are
    held end to end elsewhere."""
    import torch
    from heltondetection_tpu_torch.models import common
    from heltondetection_tpu_torch.models.yolov5 import packed_copy
    from heltondetection_tpu_torch.ops import int8_conv
    from heltondetection_tpu_torch.ops import quant as Q
    card = Q.attach_quant(packed_copy(model).to(
        x.device, memory_format=torch.channels_last), tree)
    host = dict(Q.attach_quant(packed_copy(model).to(
        "cpu", memory_format=torch.channels_last), tree).named_modules())
    inputs = {}
    hooks = [m.register_forward_pre_hook(
        lambda m, args, n=n: inputs.__setitem__(n, (m, args[0])))
        for n, m in card.named_modules()
        if isinstance(m, (common.LayerQuant, common.FlowQuant))]
    with torch.inference_mode():
        card(x.float() / 255.0)
    for h in hooks:
        h.remove()
    codes = sums = 0
    for name, (mod, inp) in inputs.items():
        moved = (common.QT(inp.i8.cpu(), inp.scale.cpu(), inp.dtype)
                 if isinstance(inp, common.QT) else inp.cpu())
        recs = []
        for m, v in ((mod, inp), (host[name], moved)):
            with Int8Convs() as rec, torch.inference_mode():
                m(v)
            recs.append(next(iter(rec.shapes.items())))
        (key, (xq_c, wq, _)), (_, (xq_h, wq_h, _)) = recs
        codes += int((xq_c.cpu() != xq_h).sum())
        geom = key[2:]
        y_c = int8_conv.int8_conv2d(xq_c, wq, *geom).cpu()
        y_h = int8_conv.int8_conv2d(xq_h, wq_h, *geom)
        sums += int((y_c != y_h).sum())
    return {"layers": len(inputs), "code_mismatches": codes,
            "sum_mismatches": sums}


def int8_conv_bound_ms(x_shape, w_shape, stride, pad) -> tuple:
    """Least time of one int8 conv: its int8 input and weight read and its
    int32 output written over the HBM rate, its multiply-adds over the
    int8 tensor-core peak."""
    b, c, h, w = x_shape
    o, cig, k, _ = w_shape
    ho, wo = (h + 2 * pad - k) // stride + 1, (w + 2 * pad - k) // stride + 1
    t_bytes = (b * c * h * w + o * cig * k * k + 4 * b * o * ho * wo) \
        / HBM_BYTES_PER_S
    t_ops = 2 * b * ho * wo * o * cig * k * k / INT8_OPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes > t_ops else "operations")


def int8_conv_checks(dev, recorded: dict, timed: bool) -> dict:
    """int8_conv2d against int8_conv2d_plain (float64) on the card at each
    recorded shape, int32 bit-equal; with ``timed``, per shape the ms by
    CUDA events of int8_conv2d, of its GEMM alone (``int8_gemm`` on the
    im2col matrix) and of the bf16 cuDNN conv of the same shape
    (channels-last) beside the shape's bound, and over one step's worth of
    calls (each shape as often as the step runs it) the device kernels of
    the GEMMs and of the bf16 convs by name (profiler)."""
    import torch
    import torch.nn.functional as F
    from heltondetection_tpu_torch.ops import int8_conv
    out, mism = [], 0
    gemms, convs = [], []
    for (xs, ws, stride, pad, groups), (x_q, w_q, n) in recorded.items():
        got = int8_conv.int8_conv2d(x_q, w_q, stride, pad, groups)
        want = int8_conv.int8_conv2d_plain(x_q, w_q, stride, pad, groups)
        bad = int((got != want).sum())
        mism += bad
        row = {"x": list(xs), "w": list(ws), "stride": stride, "pad": pad,
               "groups": groups, "per_step": n, "mismatches": bad}
        del got, want
        if timed:
            k = ws[2]
            cols = int8_conv._columns(x_q.permute(0, 2, 3, 1), k, stride, pad)
            a = cols.reshape(-1, ws[1] * k * k).contiguous()
            wm = w_q.reshape(ws[0], -1)
            xb = x_q.to(torch.bfloat16).contiguous(
                memory_format=torch.channels_last)
            wb = w_q.to(torch.bfloat16).contiguous(
                memory_format=torch.channels_last)
            fns = {"int8_conv2d": lambda: int8_conv.int8_conv2d(
                       x_q, w_q, stride, pad, groups),
                   "int_mm": lambda a=a, wm=wm: int8_conv.int8_gemm(a, wm),
                   "bf16_conv": lambda xb=xb, wb=wb, geom=(stride, pad, 1,
                                                           groups):
                       F.conv2d(xb, wb, None, *geom)}
            for name, fn in fns.items():
                row[f"{name}_ms"] = cuda_ms(fn, 10)
            gemms += [fns["int_mm"]] * n
            convs += [fns["bf16_conv"]] * n
            row["bound_ms"], row["bound_by"] = int8_conv_bound_ms(
                xs, ws, stride, pad)
        out.append(row)
    if mism:
        raise AssertionError(f"int8_conv2d differs from its plain version "
                             f"in {mism} int32 values on the card")
    res = {"shapes": out, "mismatches": mism}
    if timed:
        for name, calls in (("int_mm", gemms), ("bf16_conv", convs)):
            res[f"{name}_kernels_per_step"] = [
                [kn[:80], ms] for kn, ms in device_kernels(
                    lambda calls=calls: [c() for c in calls], 3)]
    return res


def int8_yolo_phase(dev, smi: str, model, cfg, letterbox_np) -> dict:
    """Phase 4j.1 (see the module docstring)."""
    import torch
    from heltondetection_tpu_torch.engine.evaluator import \
        make_packed_serve_step
    from heltondetection_tpu_torch.kernels import (launch_counts,
                                                   reset_launch_counts)
    from heltondetection_tpu_torch.models.yolov5 import build_yolov5
    from heltondetection_tpu_torch.ops import quant as Q
    out = {"card": smi}
    size = cfg.model.img_size
    calib = np.stack([letterbox_np(f[0], np.zeros((0, 4), np.float32),
                                   size)[0]
                      for f in SynthFrames(INT8_CALIB_FRAMES, 51).frames])
    skip = Q.YOLO_INT8_SKIP_PRESETS[cfg.test.int8_float_tail]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    amax = Q.calibrate_amax(model, Q._batched(calib, 8))
    out["calibrate_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    trees = {"layer": Q.build_quant_tree(model, amax, skip=skip),
             "flow": Q.build_flow_tree(model, amax, skip=skip,
                                       float_out=Q.YOLO_FLOW_FLOAT_OUT)}
    out["tree_build_s"] = time.perf_counter() - t0
    kw = dict(conf_thres=0.001, iou_thres=0.65, pre_nms_topk=1024)
    model32 = build_yolov5("s", 80, device=dev,
                           generator=torch.Generator().manual_seed(0))
    steps = {"bf16": make_packed_serve_step(model, 80, device=dev, **kw)}
    for mode, tree in trees.items():
        steps[mode] = make_packed_serve_step(model, 80, device=dev,
                                             quant=tree, **kw)
    rng = np.random.default_rng(52)
    xb = torch.from_numpy(rng.integers(0, 256, (32, size, size, 3))
                          .astype(np.uint8)).to(dev)
    for mode in ("layer", "flow"):
        steps[mode](xb)                          # warm-up, not counted
        torch.cuda.synchronize()
        reset_launch_counts()
        with Int8Convs() as rec:
            dets = [t.cpu() for t in steps[mode](xb)]
        torch.cuda.synchronize()
        counts = dict(launch_counts)
        if counts["nms_fixpoint"] != 1 or not bool(
                torch.isfinite(dets[0]).all()) or int(dets[3].sum()) == 0:
            raise AssertionError(f"int8 {mode} serve step B=32: launches "
                                 f"{counts}, {int(dets[3].sum())} dets")
        checks = int8_conv_checks(dev, rec.shapes, timed=mode == "layer")
        out[mode] = {"launches": counts, "dets_b32": int(dets[3].sum()),
                     "int8_convs_per_step": rec.calls,
                     "distinct_shapes": len(rec.shapes),
                     "conv_checks": checks}
        log(f"int8 {mode} serve step B=32: launches {counts}, "
            f"{int(dets[3].sum())} dets, {rec.calls} int8 convs, "
            f"int8_conv2d == plain at {len(rec.shapes)} shapes")
        # card against CPU, layer by layer: every quantized conv of the
        # step, fed the card's own input, quantizes to the same int8 codes
        # and sums to the same int32 on the CPU
        layers = int8_layers_card_vs_cpu(model, trees[mode], xb[:2])
        # end to end on a float32 copy (TF32 off): recorded, not held. The
        # float step agrees; the int8 one does not, since a float32 ulp
        # that moves one code at the first int8 conv is amplified by these
        # random weights layer after layer (PERF.md, the int8 findings)
        e2e = {}
        for q in (None, trees[mode]):
            card_step = make_packed_serve_step(model32, 80, device=dev,
                                               quant=q, **kw)
            cpu_step = make_packed_serve_step(model32, 80, device="cpu",
                                              quant=q, **kw)
            card = [t.cpu().numpy() for t in card_step(xb[:2])]
            host = [t.numpy() for t in cpu_step(xb[:2].cpu())]
            e2e["float" if q is None else "int8"] = {
                "dets": int(card[3].sum()), "misses": match_dets(
                    card, host, INT8_CPU_SCORE_TOL, INT8_CPU_BOX_TOL)}
        out[mode]["card_vs_cpu"] = {"per_layer": layers, "end_to_end": e2e}
        log(f"int8 {mode} card vs CPU: {layers['layers']} quantized convs "
            f"on the card's inputs, {layers['code_mismatches']} int8 codes "
            f"and {layers['sum_mismatches']} int32 sums apart; end to end "
            f"(float32 copy, 2 frames, boxes {INT8_CPU_BOX_TOL} px, scores "
            f"{INT8_CPU_SCORE_TOL}): {e2e}")
        if layers["code_mismatches"] or layers["sum_mismatches"] or \
                e2e["float"]["misses"] > INT8_CPU_MISS_SHARE * max(
                    e2e["float"]["dets"], 1):
            raise AssertionError(f"int8 {mode} on the card differs from the "
                                 f"CPU")
        del card_step, cpu_step, card, host
    rows = out["layer"]["conv_checks"]["shapes"]
    out["int8_conv2d_per_step"] = {
        k: sum(r["per_step"] * r[k] for r in rows)
        for k in ("int8_conv2d_ms", "int_mm_ms", "bf16_conv_ms", "bound_ms")}
    out["int8_conv2d_per_step"]["bound_by"] = sorted(
        {r["bound_by"] for r in rows})
    for name in ("int_mm", "bf16_conv"):
        out["int8_conv2d_per_step"][f"{name}_device_ms"] = sum(
            ms for _, ms in out["layer"]["conv_checks"][
                f"{name}_kernels_per_step"])
    # ms a step at B=32, in turns
    order = ("bf16", "layer", "flow", "flow", "layer", "bf16")
    ms = {k: [] for k in steps}
    for k in order:
        ms[k].append(cuda_ms(lambda k=k: steps[k](xb), 10))
    out["step_ms_b32"] = ms
    for k in ("bf16", "layer"):
        out[f"{k}_device_b32"] = device_work(lambda k=k: steps[k](xb))
    log(f"int8 serve step B=32 {size}² ms (events, in turns): " + ", ".join(
        f"{k} {v}" for k, v in ms.items()) + f"; device ms, kernels: bf16 "
        f"{out['bf16_device_b32']}, layer {out['layer_device_b32']}; "
        f"calibration {out['calibrate_s']:.2f} s, trees "
        f"{out['tree_build_s']:.3f} s ({smi})")
    return out, trees


def int8_rcnn_phase(dev, smi: str, cfg, letterbox_np) -> dict:
    """Phase 4j.2 (see the module docstring)."""
    import torch
    from heltondetection_tpu_torch.kernels import (launch_counts,
                                                   reset_launch_counts)
    from heltondetection_tpu_torch.models.faster_rcnn import \
        faster_rcnn_infer
    from heltondetection_tpu_torch.ops import quant as Q
    out = {"card": smi}
    size = cfg.model.img_size
    calib = np.stack([letterbox_np(f[0], np.zeros((0, 4), np.float32),
                                   size)[0]
                      for f in SynthFrames(INT8_CALIB_FRAMES, 53).frames])
    rng = np.random.default_rng(54)
    x = torch.from_numpy(rng.integers(0, 256, (8, size, size, 3))
                         .astype(np.float32) / 255.0).to(dev)
    model = rcnn_model(cfg, dev, 0, x)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tree = Q.quantize_rcnn(model, calib)
    out["quantize_s"] = time.perf_counter() - t0
    qm = Q.attach_quant(model, tree)
    with torch.inference_mode():
        faster_rcnn_infer(qm, x)                  # warm-up, not counted
        torch.cuda.synchronize()
        reset_launch_counts()
        with Int8Convs() as rec:
            dets = [t.cpu() for t in faster_rcnn_infer(qm, x)]
        torch.cuda.synchronize()
        counts = dict(launch_counts)
        with plain_nms():
            plain = [t.cpu() for t in faster_rcnn_infer(qm, x)]
    same = all(torch.equal(a, b) for a, b in zip(dets, plain))
    n = int(dets[3].sum())
    log(f"int8 faster_rcnn_infer B=8 {size}²: launches {counts}, {n} dets, "
        f"{rec.calls} int8 convs at {len(rec.shapes)} shapes; dets equal "
        f"to the plain NMS's: {same}")
    if counts != {"nms_fixpoint": 0, "nms_mask": 6, "iou_matrix": 0} or \
            not same or n == 0 or not bool(torch.isfinite(dets[0]).all()):
        raise AssertionError("int8 faster_rcnn_infer: launches, dets or the "
                             "plain NMS's dets are wrong")
    checks = int8_conv_checks(dev, rec.shapes, timed=False)
    ms = {"float": [], "int8": []}

    def infer(m):
        with torch.inference_mode():
            return faster_rcnn_infer(m, x)

    for k in ("float", "int8", "int8", "float"):
        ms[k].append(cuda_ms(lambda k=k: infer(model if k == "float"
                                               else qm), 5))
    out.update({"launches": counts, "dets_b8": n, "plain_nms_equal": same,
                "int8_convs_per_step": rec.calls,
                "distinct_shapes": len(rec.shapes),
                "conv_mismatches": checks["mismatches"],
                "step_ms_b8": ms,
                "float_device_b8": device_work(lambda: infer(model)),
                "int8_device_b8": device_work(lambda: infer(qm))})
    log(f"int8 faster_rcnn_infer B=8 ms (events, in turns): {ms}; device "
        f"ms, kernels: float {out['float_device_b8']}, int8 "
        f"{out['int8_device_b8']}; quantize_rcnn {out['quantize_s']:.2f} s "
        f"({smi})")
    return out, model


class MemoryVal:
    """Inside the block, the runner's val reader (``build_dataset``) is
    ``ds``, an in-memory reader: the card's machine has no image decoder."""

    def __init__(self, ds):
        self.ds = ds

    def __enter__(self):
        from heltondetection_tpu_torch.engine import runner
        self.orig = runner.build_dataset
        runner.build_dataset = lambda dc, split="train": self.ds
        return self

    def __exit__(self, *exc):
        from heltondetection_tpu_torch.engine import runner
        runner.build_dataset = self.orig


def int8_entry_phase(dev, smi: str, model, rmodel, work: str) -> dict:
    """Phase 4j.3: the int8 entry points of both configs, the val set in
    memory (32 seeded frames), one calibration each through the cache."""
    import dataclasses
    import torch
    from heltondetection_tpu_torch.data import readers
    from heltondetection_tpu_torch.engine import export as E
    from heltondetection_tpu_torch.engine import runner
    from heltondetection_tpu_torch.engine.serve import BatchingDetector
    from heltondetection_tpu_torch.kernels import (launch_counts,
                                                   reset_launch_counts)
    from heltondetection_tpu_torch.ops import quant as Q
    from heltondetection_tpu_torch.utils.ckpt import save_eval_variables
    out = {"card": smi}
    ds = SynthFrames(INT8_CALIB_FRAMES, 55)
    rng = np.random.default_rng(56)
    cases = (("yolov5_s_coco_640", YOLO_CONFIG, model, "nms_fixpoint", 1),
             ("faster_rcnn_pafpn_decoupled_coco_832", RCNN_CONFIG, rmodel,
              "nms_mask", 6))
    calibrations = []
    calibrate = Q.calibrate_amax

    def counted(*a, **k):
        calibrations.append(1)
        return calibrate(*a, **k)

    Q.calibrate_amax = counted
    try:
        for name, config, net, kernel, per_export_call in cases:
            res = {}
            cfg = rcnn_config(config)
            cfg = dataclasses.replace(
                cfg, name=f"int8_{name}", work_dir=work,
                data=dataclasses.replace(cfg.data, val_ann="in-memory"),
                eval=dataclasses.replace(cfg.eval, int8=True, batch_size=8),
                test=dataclasses.replace(cfg.test, int8=True,
                                         conf_thres=0.001))
            save_eval_variables(cfg.ckpt_dir, net.state_dict(), 1)
            with MemoryVal(ds):
                # run_eval twice: the second call loads the cached tree
                del calibrations[:]
                for call in ("calibrated", "cached"):
                    reset_launch_counts()
                    t0 = time.perf_counter()
                    stats = runner.run_eval(cfg, net.state_dict(), net,
                                            verbose=False, device=dev)
                    torch.cuda.synchronize()
                    res[f"run_eval_{call}"] = {
                        "s": time.perf_counter() - t0,
                        "AP": stats["AP"], "launches": dict(launch_counts),
                        "calibrations": len(calibrations)}
                if calibrations != [1]:
                    raise AssertionError(f"run_eval int8 [{name}] "
                                         f"calibrated {len(calibrations)} "
                                         f"times in two calls")
                # load_detector and a BatchingDetector over it
                det = runner.load_detector(cfg, device=dev)
                frames = [rng.integers(0, 256, hw + (3,)).astype(np.uint8)
                          for hw in ((480, 640), (720, 1280), (640, 640),
                                     (375, 500))]
                reset_launch_counts()
                direct = det.detect_batch(frames)
                torch.cuda.synchronize()
                res["load_detector_launches"] = dict(launch_counts)
                with BatchingDetector(det, batch_size=4,
                                      batch_buckets=(4,)) as bd:
                    served = [bd.submit(f) for f in frames]
                    served = [f.result(timeout=120) for f in served]
                misses = sum(match_dets(
                    tuple(np.asarray(a)[None] for a in (*s, np.ones(len(
                        s[1]), bool))),
                    tuple(np.asarray(a)[None] for a in (*d, np.ones(len(
                        d[1]), bool))), 1e-3, 0.1)
                    for s, d in zip(served, direct))
                res["batching_misses"] = misses
                n_direct = sum(len(d[1]) for d in direct)
                # run_test of an in-memory frame (no image decoder here)
                source = os.path.join(work, f"{name}_int8.jpg")
                read_orig = readers.imread_rgb
                readers.imread_rgb = {source: frames[0]}.__getitem__
                try:
                    reset_launch_counts()
                    tested = runner.run_test(cfg, source, None, device=dev)
                    torch.cuda.synchronize()
                    res["run_test_launches"] = dict(launch_counts)
                finally:
                    readers.imread_rgb = read_orig
                tested_n = check_dets(frames[0], (tested["boxes"],
                                                  tested["scores"],
                                                  tested["classes"]))
                # export_model with test.int8 and its loaded program
                path = os.path.join(work, f"{name}_int8.pt2")
                t0 = time.perf_counter()
                E.export_model(cfg, net, path, device=dev)
                res["export_s"] = time.perf_counter() - t0
                fn = E.load_serving_fn(path)
                size = cfg.model.img_size
                xs = [torch.from_numpy(rng.integers(
                    0, 256, (1, size, size, 3)).astype(np.uint8)).to(dev)
                    for _ in range(2)]
                fn(xs[0])
                torch.cuda.synchronize()
                reset_launch_counts()
                got = [fn(x) for x in xs]
                torch.cuda.synchronize()
                res["export_launches_per_call"] = \
                    launch_counts["nms_mask"] / len(xs)
                qnet = Q.attach_quant(net, runner._int8_quant_tree(cfg, net))
                serve = (E.faster_rcnn_serve if kernel == "nms_mask" else
                         E.yolov5_serve(80, conf_thres=cfg.test.conf_thres,
                                        iou_thres=cfg.test.iou_thres))
                with torch.inference_mode():
                    want = [serve(qnet, x) for x in xs]
                bits = all(a.dtype == b.dtype and torch.equal(a, b)
                           for g, w in zip(got, want)
                           for a, b in zip(g, w))
                res["export_bit_equal"] = bits
                res["export_dets"] = sum(int(g[3].sum()) for g in got)
                res["calibrations"] = len(calibrations)
            log(f"int8 entry points [{name}]: run_eval {res['run_eval_calibrated']} "
                f"then {res['run_eval_cached']}; load_detector launches "
                f"{res['load_detector_launches']}, {n_direct} dets, the "
                f"BatchingDetector's {misses} misses; run_test {tested_n} "
                f"dets, launches {res['run_test_launches']}; export "
                f"{res['export_s']:.2f} s, loaded dets bit-equal to eager "
                f"int8: {bits} ({res['export_dets']} dets), nms_mask "
                f"{res['export_launches_per_call']} a call; calibrations "
                f"{len(calibrations)}")
            ok = (res["run_eval_calibrated"]["launches"][kernel] > 0
                  and res["load_detector_launches"][kernel] > 0
                  and res["run_test_launches"][kernel] > 0
                  and misses == 0 and n_direct > 0 and tested_n > 0 and bits
                  and res["export_dets"] > 0
                  and res["export_launches_per_call"] == per_export_call
                  and calibrations == [1])
            if not ok:
                raise AssertionError(f"int8 entry points [{name}] failed")
            out[name] = res
    finally:
        Q.calibrate_amax = calibrate
    return out


def letterbox_device_phase(dev) -> dict:
    """Phase 4j.4: ops/letterbox.letterbox_image on the card against the
    CPU: a downscale (1080x1920), an upscale (333x500) and the 1:1 case,
    uint8 and float32, within 1e-3 grey levels (float32; an enlargement
    takes the plain bilinear, since CUDA's antialiased kernel summed its
    taps 3.6e-3 away from the CPU's there) or one level (uint8, whose cast
    truncates a float32 value the two devices may round apart)."""
    import torch
    from heltondetection_tpu_torch.ops.letterbox import letterbox_image
    rng = np.random.default_rng(57)
    out = {}
    for hw in ((1080, 1920), (333, 500), (480, 640)):
        img = rng.integers(0, 256, hw + (3,)).astype(np.uint8)
        for dt, tol in ((torch.uint8, 1.0), (torch.float32, 1e-3)):
            t = torch.from_numpy(img).to(dt)
            host, hp = letterbox_image(t, 640, 640)
            card, cp = letterbox_image(t.to(dev), 640, 640)
            err = float((card.cpu().float() - host.float()).abs().max())
            same_p = all(float(a) == float(b) for a, b in zip(hp, cp))
            out[f"{hw[0]}x{hw[1]}_{str(dt)[6:]}"] = err
            if err > tol or not same_p:
                raise AssertionError(f"letterbox_image {hw} {dt} on the "
                                     f"card: max err {err}, params "
                                     f"equal {same_p}")
    log(f"letterbox_image card vs CPU, max abs err: {out}")
    return out


# phase 4k: the native C++ loader (native/loader_core.cpp,
# data/native_loader.py) and run_train's two environment hooks. The loader
# needs g++ with the OpenCV (core, imgproc) and libjpeg development files;
# a machine without those headers cannot build it, and the runner then
# takes the Python pipelines, which 4k records and goes on. Headers present
# and the build failing is a fault: the run fails.
LOADER_HEADERS = ("opencv2/imgproc.hpp", "jpeglib.h")
NATIVE_BATCH = 16              # B of every 4k.2 run
NATIVE_TRAIN_SIZE = 640        # NativeTrainPipeline against TrainPipeline
NATIVE_AUG_SIZE = 1280         # NativeDeviceAugPipeline against
# DeviceAugPipeline, on frames of phase 4f.1's VisDrone sizes
NATIVE_TIMED_BATCHES = 3       # batches a pipeline's img/s is taken over


def loader_probe() -> dict:
    """Phase 4k.1: g++'s version, whether each header the loader core
    includes compiles, and the core's build (seconds, or the compiler's
    error)."""
    from heltondetection_tpu_torch import native
    try:
        gxx = subprocess.run(["g++", "--version"], capture_output=True,
                             text=True, timeout=30).stdout.splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError) as e:
        gxx = f"g++ not runnable: {e}"
    headers = {}
    for header in LOADER_HEADERS:
        try:
            # <cstdio> first: jpeglib.h uses FILE and size_t undeclared
            r = subprocess.run(
                ["g++", "-x", "c++", "-fsyntax-only", *native.loader_cflags(),
                 "-"], input=f"#include <cstdio>\n#include <{header}>\n",
                capture_output=True, text=True, timeout=60)
            errors = [ln for ln in r.stderr.splitlines() if "error" in ln]
            headers[header] = ("ok" if r.returncode == 0 else
                               (errors or r.stderr.splitlines() or ["?"])[0])
        except (OSError, subprocess.SubprocessError) as e:
            headers[header] = f"g++ not runnable: {e}"
    t0 = time.perf_counter()
    lib = native.get_loader_lib()
    secs = time.perf_counter() - t0
    out = {"gxx": gxx, "headers": headers, "built": lib is not None,
           "build_s": secs, "build_error": native.loader_build_error()}
    missing = [h for h, v in headers.items() if v != "ok"]
    if lib is None and not missing:
        raise AssertionError("the OpenCV and libjpeg headers compile but "
                             "the native loader core did not build: "
                             f"{out['build_error']}")
    out["verdict"] = ("built" if lib is not None else
                      "not buildable on this machine: missing "
                      + ", ".join(f"<{h}>" for h in missing))
    log(f"native loader probe: {gxx} | headers {headers} | "
        f"{out['verdict']} ({secs:.2f} s)"
        + ("" if lib is not None else f" | {out['build_error']}"))
    return out


def pipeline_img_per_s(pipe, keys, dev) -> float:
    """Host img/s of a pipeline through TrainLoader.host_batches (8
    workers, the pool's default thread count for a native pipeline), over
    NATIVE_TIMED_BATCHES batches of NATIVE_BATCH."""
    from heltondetection_tpu_torch.data.loader import TrainLoader
    t0 = time.perf_counter()
    with TrainLoader(pipe, NATIVE_BATCH, num_workers=8, device=dev,
                     keys=keys) as loader:
        batches = loader.host_batches(0)
        n = sum(len(next(batches)[keys[0]])
                for _ in range(NATIVE_TIMED_BATCHES))
        batches.close()
    return n / (time.perf_counter() - t0)


def native_loader_phase(dev, smi: str) -> dict:
    """Phase 4k.2 (only where the loader core built): native against Python
    img/s at 640² (train) and 1280² (device_aug) in turns, the native
    batches against the same pipelines on a one-thread pool bit for bit,
    then a two-step run_train of yolov5_s_coco_640 and of
    faster_rcnn_pafpn_decoupled_coco_832 on the native loader with their
    in-loop evals, the launch counts reset before each and read after."""
    import dataclasses
    import tempfile
    import torch
    from heltondetection_tpu_torch.data import native_loader as NL
    from heltondetection_tpu_torch.data.augment import (DeviceAugPipeline,
                                                        TrainPipeline)
    from heltondetection_tpu_torch.data.loader import TrainLoader
    from heltondetection_tpu_torch.engine.runner import train_from_datasets
    from heltondetection_tpu_torch.kernels import (launch_counts,
                                                   reset_launch_counts)
    out = {"card": smi, "batch": NATIVE_BATCH}
    frames = SynthFrames(4 * NATIVE_BATCH, 10)          # phase 4e's frames
    big = SynthFrames(NATIVE_TIMED_BATCHES * NATIVE_BATCH, 12,
                      sizes=VISDRONE_SIZES)
    train_kw = dict(mosaic_p=0.5, flip_p=0.5, max_boxes=128)
    aug_kw = dict(mosaic_p=0.5, max_boxes=32)
    pairs = {
        f"train_{NATIVE_TRAIN_SIZE}": (
            lambda: TrainPipeline(frames, NATIVE_TRAIN_SIZE, **train_kw),
            lambda: NL.NativeTrainPipeline(frames, NATIVE_TRAIN_SIZE,
                                           **train_kw), TrainLoader.KEYS),
        f"device_aug_{NATIVE_AUG_SIZE}": (
            lambda: DeviceAugPipeline(big, NATIVE_AUG_SIZE, **aug_kw),
            lambda: NL.NativeDeviceAugPipeline(big, NATIVE_AUG_SIZE,
                                               **aug_kw),
            TrainLoader.DEVICE_AUG_KEYS)}
    for name, (python, native, keys) in pairs.items():
        runs = {"python": [], "native": []}
        for side in ("python", "native", "native", "python"):
            runs[side].append(pipeline_img_per_s(
                (python if side == "python" else native)(), keys, dev))
        pipe = native()
        idxs = list(range(NATIVE_BATCH))
        one, many = NL.NativePool(1), NL.NativePool()
        try:
            a = pipe.sample_batch(idxs, 0, one)
            b = pipe.sample_batch(idxs, 0, many)
        finally:
            one.close()
            many.close()
            pipe.close()
        same = all(np.array_equal(a[k], b[k]) for k in keys)
        out[name] = {"img_per_s": runs, "one_thread_equal": same}
        log(f"{name}: native {runs['native']} img/s, Python "
            f"{runs['python']} img/s (8 workers, in turns); one-thread "
            f"pool batch equal: {same}")
        if not same:
            raise AssertionError(f"{name}: native batch differs across "
                                 "thread counts")

    trains = {"yolov5_s_coco_640": (YOLO_CONFIG, SynthFrames(
                  2 * NATIVE_BATCH, 10), SynthFrames(NATIVE_BATCH, 11),
                  ("nms_fixpoint",)),
              "faster_rcnn_pafpn_decoupled_coco_832": (
                  RCNN_CONFIG, SynthFrames(2 * NATIVE_BATCH, 20),
                  SynthFrames(8, 21), ("nms_mask", "iou_matrix"))}
    for name, (config, train_ds, val_ds, kernels) in trains.items():
        base = rcnn_config(config)
        records = LogRecords()
        with tempfile.TemporaryDirectory() as work:
            cfg = dataclasses.replace(
                base, name=f"chip_native_{name}", work_dir=work,
                train=dataclasses.replace(
                    base.train, epochs=1, batch_size=NATIVE_BATCH,
                    warmup_epochs=1.0, eval_interval=1, num_workers=8))
            torch.cuda.synchronize()
            reset_launch_counts()
            t0 = time.perf_counter()
            try:
                train_from_datasets(cfg, train_ds, val_ds, device=dev)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                counts = dict(launch_counts)
            finally:
                records.close()
        [choice] = records.field("train_loader")
        [epoch] = records.field("epoch_stats")
        evals = records.field("eval_stats")
        out[f"run_train_{name}"] = {
            "wall_s": wall, "epoch_s": epoch["seconds"],
            "loader_wait_s": epoch["loader_wait_s"],
            "loader_wait_share": epoch["loader_wait_s"] / epoch["seconds"],
            "steps": epoch["steps"], "pipeline": choice["pipeline"],
            "launches": counts}
        log(f"run_train {name} on the native loader: {choice['pipeline']}, "
            f"{epoch['steps']} steps in {epoch['seconds']:.2f} s, loader "
            f"wait {epoch['loader_wait_s']:.2f} s; in-loop eval "
            f"{len(evals)}; launches {counts}")
        if not choice["native"] or epoch["steps"] != 2 or len(evals) != 1 \
                or not all(counts[k] > 0 for k in kernels) \
                or not all(math.isfinite(v) for v in epoch.values()
                           if isinstance(v, float)):
            raise AssertionError(f"run_train {name} on the native loader "
                                 "failed")
    return out


def train_hooks_phase(dev, smi: str) -> dict:
    """Phase 4k.3: HELTON_PROFILE_DIR and HELTON_DEBUG_NANS on the card, on
    yolov5_s_coco_640 (B=16, two steps, no val set): a run without either
    (its loader choice read from the log), the same run traced, whose
    trace must name CUDA kernels, and a run with a NaN in the stem's weight
    that must raise FloatingPointError naming epoch 0 and step 0 or 1,
    with autograd's anomaly mode off again after."""
    import dataclasses
    import tempfile
    import torch
    from heltondetection_tpu_torch.engine.runner import train_from_datasets
    from heltondetection_tpu_torch.models import common
    base = rcnn_config(YOLO_CONFIG)
    train_ds = SynthFrames(2 * NATIVE_BATCH, 10)
    out = {"card": smi}

    def run(work, env):
        cfg = dataclasses.replace(
            base, name="chip_hooks", work_dir=work,
            train=dataclasses.replace(base.train, epochs=1,
                                      batch_size=NATIVE_BATCH,
                                      warmup_epochs=1.0, num_workers=8))
        records = LogRecords()
        os.environ.update(env)
        t0 = time.perf_counter()
        try:
            train_from_datasets(cfg, train_ds, None, device=dev)
            torch.cuda.synchronize()
            return time.perf_counter() - t0, records
        finally:
            for k in env:
                del os.environ[k]
            records.close()

    with tempfile.TemporaryDirectory(dir=RUNS_DIR) as work:
        plain_s, records = run(os.path.join(work, "plain"), {})
        [choice] = records.field("train_loader")
        [epoch_plain] = records.field("epoch_stats")
        trace_dir = os.path.join(work, "trace")
        traced_s, records = run(os.path.join(work, "traced"),
                                {"HELTON_PROFILE_DIR": trace_dir})
        [epoch_traced] = records.field("epoch_stats")
        [name] = os.listdir(trace_dir)
        path = os.path.join(trace_dir, name)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
        kernels = [e for e in events if e.get("cat") == "kernel"]
        top = sorted({e["name"][:60] for e in kernels})[:5]
        out["profile"] = {
            "trace_bytes": os.path.getsize(path), "events": len(events),
            "kernel_events": len(kernels), "wall_s_plain": plain_s,
            "wall_s_traced": traced_s, "epoch_s_plain":
            epoch_plain["seconds"], "epoch_s_traced": epoch_traced["seconds"]}
        out["train_loader"] = choice
        log(f"HELTON_PROFILE_DIR: {name}, {os.path.getsize(path)} bytes, "
            f"{len(events)} events, {len(kernels)} CUDA kernel events (e.g. "
            f"{top}); run {traced_s:.2f} s traced against {plain_s:.2f} s "
            f"(epochs {epoch_traced['seconds']:.2f} / "
            f"{epoch_plain['seconds']:.2f} s); train loader {choice}")
        if not kernels:
            raise AssertionError("the profiler trace names no CUDA kernel")

        init = common.init_weights

        def poisoned(model, gen):
            init(model, gen)
            with torch.no_grad():
                next(model.parameters()).view(-1)[0] = float("nan")

        common.init_weights = poisoned
        try:
            run(os.path.join(work, "nan"), {"HELTON_DEBUG_NANS": "1"})
            raised = None
        except FloatingPointError as e:
            raised = str(e)
        finally:
            common.init_weights = init
    named = raised is not None and any(f"epoch 0 step {s}" in raised
                                       for s in (0, 1))
    out["debug_nans"] = {"raised": (raised or "")[:300], "named": named,
                         "anomaly_after": torch.is_anomaly_enabled()}
    log(f"HELTON_DEBUG_NANS with a NaN stem weight: {(raised or '')[:160]}"
        f" | anomaly mode after: {torch.is_anomaly_enabled()}")
    if not named or torch.is_anomaly_enabled():
        raise AssertionError("HELTON_DEBUG_NANS did not name the poisoned "
                             "step")
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, root)
    try:
        import heltondetection_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the port is not beside this script: {e}",
              file=sys.stderr)
        return 2
    from heltondetection_tpu_torch.data.letterbox import letterbox_np
    from heltondetection_tpu_torch.engine.evaluator import (
        Evaluator, make_packed_serve_step, multilabel_candidates)
    from heltondetection_tpu_torch.engine.infer import Detector
    from heltondetection_tpu_torch.engine.runner import (forward_for_eval,
                                                         load_detector)
    from heltondetection_tpu_torch.engine.serve import (BatchingDetector,
                                                        make_http_server)
    from heltondetection_tpu_torch.kernels import (KERNELS, build,
                                                   launch_counts,
                                                   reset_launch_counts)
    from heltondetection_tpu_torch.kernels import iou as iou_kernel
    from heltondetection_tpu_torch.kernels import nms as nms_kernel
    from heltondetection_tpu_torch.models.yolov5 import (build_yolov5,
                                                         decode_full,
                                                         packed_copy)
    from heltondetection_tpu_torch.ops.boxes import (box_iou_matrix,
                                                     iou_matrix)
    from heltondetection_tpu_torch.ops.nms import (batched_nms,
                                                   nms_mask_fixpoint,
                                                   nms_mask_seq,
                                                   suppression_matrix)
    from heltondetection_tpu_torch.ops.postprocess import (
        _MAX_WH, fused_select_decode_packed, nms_sorted_candidates)
    from heltondetection_tpu_torch.ops.wbf import weighted_boxes_fusion
    from heltondetection_tpu_torch.utils.ckpt import save_eval_variables
    from heltondetection_tpu_torch.utils.cocoeval import DetEval

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    t_start = time.perf_counter()

    # 1. device
    smi = nvidia_smi_line()
    log(f"device: {smi} | torch {torch.__version__} cuda "
        f"{torch.version.cuda} | {torch.cuda.get_device_name(0)}")

    # 2. build
    t0 = time.perf_counter()
    built = build.build_all(KERNELS)
    log(f"build: {len(built)} kernel(s) in "
        f"{time.perf_counter() - t0:.2f} s wall")
    for name, (lib, secs, report) in built.items():
        log(f"  {name}: {lib.name} {secs:.2f} s")
        for line in report.splitlines():
            if "registers" in line or "smem" in line or "spill" in line:
                log(f"    {line.strip()}")
    # 4k.1 with the builds: the native loader's probe and build, before any
    # train path asks for the library (it is built once per process)
    loader = loader_probe()

    # 3a. nms_fixpoint vs plain, exact
    rng = np.random.default_rng(0)
    thr = 0.65
    cases = {
        "random B=8 N=1024": sorted_boxes(rng, 8, 1024),
        "class-offset, 300 padding rows, B=8 N=1024":
            class_offset_boxes(rng, 8, 1024, 300),
        "1024-deep chain": chain_boxes(1024),
    }
    # rows kept per image where the answer is known without the plain scan
    known_kept = {"identical boxes B=2 N=1024": 1,
                  "no overlap B=2 N=1024": 1024}
    fix_rng = np.random.default_rng(3)
    n_max = nms_kernel.nms_fixpoint_max_n(dev)
    clusters = nms_kernel.nms_fixpoint_clusters(dev, 1024)
    log(f"nms_fixpoint: N up to {n_max}; {clusters} images' clusters of "
        f"four blocks run at once at N=1024 (a larger batch runs in waves)")
    fix_cases = dict(cases)
    fix_cases.update({
        "random B=1 N=1024": sorted_boxes(fix_rng, 1, 1024),
        "class-offset, 200 padding rows, B=64 N=1024 (cluster waves)":
            class_offset_boxes(fix_rng, 64, 1024, 200),
        "identical boxes B=2 N=1024": identical_boxes(2, 1024),
        "no overlap B=2 N=1024": disjoint_boxes(2, 1024),
        f"random B=4 N={n_max} (the largest N)":
            sorted_boxes(fix_rng, 4, n_max),
    })
    mismatches = 0
    max_abs_err = 0.0
    for label, boxes in fix_cases.items():
        t = torch.from_numpy(boxes).to(dev)
        got = nms_kernel.nms_fixpoint(t, thr)
        bits = nms_kernel.nms_fixpoint_build(t, thr)
        torch.cuda.synchronize()
        want = nms_mask_fixpoint(t, thr)
        want_bits = suppression_matrix(t, thr).sum((-1, -2))
        diff = int((got != want).sum())
        mismatches += diff
        max_abs_err = max(max_abs_err,
                          float((got.float() - want.float()).abs().max()))
        bits_equal = torch.equal(bits.long(), want_bits.long())
        log(f"nms_fixpoint vs plain [{label}]: {diff} of {got.numel()} "
            f"differ, {int(got.sum())} kept; build alone sets "
            f"{int(bits.sum())} bits, plain S {int(want_bits.sum())}")
        if not bits_equal:
            raise AssertionError(f"nms_fixpoint's build sets other bits "
                                 f"than the plain S [{label}]")
        if label == "1024-deep chain":
            seq = nms_mask_seq(t[0], thr)
            if not torch.equal(seq, got[0]) or int(got.sum()) != 512:
                raise AssertionError("chain: kernel disagrees with the "
                                     "sequential greedy scan")
        if label in known_kept and not bool(
                (got.sum(-1) == known_kept[label]).all()):
            raise AssertionError(f"nms_fixpoint [{label}] kept "
                                 f"{got.sum(-1).tolist()} per image")
    if mismatches:
        raise AssertionError(f"kernel keep masks differ from the plain "
                             f"version in {mismatches} places")
    try:
        nms_kernel.nms_fixpoint(torch.zeros((1, n_max + 32, 4), device=dev),
                                thr)
    except ValueError as e:
        log(f"nms_fixpoint at N={n_max + 32} raises: {e}")
    else:
        raise AssertionError(f"nms_fixpoint ran at N={n_max + 32}, past "
                             f"its shared memory")

    # 3b. nms_mask vs plain (the batched row scan), exact
    cases2 = dict(cases)
    cases2["class-offset, 500 padding rows, B=4 N=2048"] = \
        class_offset_boxes(rng, 4, 2048, 500)
    for label in known_kept:
        cases2[label] = fix_cases[label]
    mask_err = 0.0
    for label, boxes in cases2.items():
        t = torch.from_numpy(boxes).to(dev)
        got = nms_kernel.nms_mask(t, thr)
        torch.cuda.synchronize()
        want = nms_mask_seq(t, thr)
        diff = int((got != want).sum())
        mask_err = max(mask_err,
                       float((got.float() - want.float()).abs().max()))
        log(f"nms_mask vs plain [{label}]: {diff} of {got.numel()} differ, "
            f"{int(got.sum())} kept")
        if diff:
            raise AssertionError(f"nms_mask differs from the plain row scan "
                                 f"in {diff} places [{label}]")
        if label == "1024-deep chain" and int(got.sum()) != 512:
            raise AssertionError("chain: nms_mask kept "
                                 f"{int(got.sum())}, not 512")
        if label in known_kept and not bool(
                (got.sum(-1) == known_kept[label]).all()):
            raise AssertionError(f"nms_mask [{label}] kept "
                                 f"{got.sum(-1).tolist()} per image")
    t = torch.from_numpy(cases["random B=8 N=1024"]).to(dev)
    k1, k2 = nms_kernel.nms_fixpoint(t, thr), nms_kernel.nms_mask(t, thr)
    if not torch.equal(k1, k2):
        raise AssertionError("nms_mask and nms_fixpoint disagree on one "
                             "input")
    log("nms_mask == nms_fixpoint on the random B=8 N=1024 input")

    # 3c. iou_matrix vs plain, within 1 ulp, both stores
    iou_ulp, iou_err = 0, 0.0
    iou_stores = set()
    for n, m, n_zero in ((1024, 8192, 0), (1000, 25200, 37),
                         (1000, 25201, 37), (63, 130, 5), (257, 1023, 0),
                         (1, 25200, 0), (1024, 1, 0), (65536, 128, 100)):
        a = torch.from_numpy(sorted_boxes(rng, 1, n)[0]).to(dev)
        b = torch.from_numpy(sorted_boxes(rng, 1, m)[0]).to(dev)
        zero_rows = torch.arange(n_zero, device=dev) * 7
        a[zero_rows] = 0.0
        got = iou_kernel.iou_matrix(a, b)
        torch.cuda.synchronize()
        want = box_iou_matrix(a, b)
        ulp = max_ulp(got, want)
        err = float((got - want).abs().max())
        n_diff = int((got != want).sum())
        iou_ulp, iou_err = max(iou_ulp, ulp), max(iou_err, err)
        store = "float4" if m % 4 == 0 else "float"
        iou_stores.add(store)
        log(f"iou_matrix vs plain [({n}, {m}), {store} store, {n_zero} "
            f"zero-area rows]: {n_diff} of {got.numel()} differ, max {ulp} "
            f"ulp, max abs err {err:.3g}")
        if tuple(got.shape) != (n, m) or ulp > 1:
            raise AssertionError(f"iou_matrix is {ulp} ulp from the plain "
                                 f"version at ({n}, {m})")
        if n_zero and bool((got[zero_rows] != 0).any()):
            raise AssertionError("zero-area rows gave non-zero IoU")
        del got, want
    if iou_stores != {"float4", "float"}:
        raise AssertionError(f"iou_matrix stores exercised: {iou_stores}")

    log(f"[phases 1-3 done at {time.perf_counter() - t_start:.1f} s]")
    # 4a. the serve path
    t0 = time.perf_counter()
    model = build_yolov5("s", 80, dtype=torch.bfloat16, device=dev,
                         generator=torch.Generator().manual_seed(0))
    step = make_packed_serve_step(model, 80, conf_thres=0.001,
                                  iou_thres=thr, pre_nms_topk=1024,
                                  device=dev)
    detector = Detector(step, 80, 640, device=dev)
    log(f"model: YOLOv5s 80 classes bf16, built in "
        f"{time.perf_counter() - t0:.2f} s")
    frame_rng = np.random.default_rng(1)
    requests = [[(480, 640), (720, 1280), (640, 640), (375, 500)],
                [(1080, 1920), (640, 427)]]
    requests = [[frame_rng.integers(0, 256, hw + (3,)).astype(np.uint8)
                 for hw in req] for req in requests]
    detector.detect_batch(requests[0])            # warm-up, not counted
    torch.cuda.synchronize()
    reset_launch_counts()
    answers = [detector.detect_batch(req) for req in requests]
    torch.cuda.synchronize()
    counts = dict(launch_counts)
    log(f"serve path: {sum(map(len, requests))} frames in {len(requests)} "
        f"requests, launches {counts}")
    if counts["nms_fixpoint"] < 1:
        raise AssertionError("nms_fixpoint was not launched on the serve "
                             "path")
    n_dets = 0
    for req, ans in zip(requests, answers):
        for frame, dets in zip(req, ans):
            if check_dets(frame, dets) == 0:
                raise AssertionError("a frame got no dets")
            n_dets += len(dets[1])
    log(f"dets: {n_dets} over {sum(map(len, requests))} frames, finite and "
        f"inside their frames")

    # the same candidates through the kernel and through the plain NMS
    packed_model = packed_copy(model).to(memory_format=torch.channels_last)
    x = torch.from_numpy(np.stack([
        frame_rng.integers(0, 256, (640, 640, 3)).astype(np.uint8)
        for _ in range(8)])).to(dev)
    with torch.inference_mode():
        cands = fused_select_decode_packed(
            packed_model(x.float() / 255.0), 80, topk=1024,
            conf_thres=0.001)
        on_card = [t.cpu() for t in nms_sorted_candidates(
            *cands, iou_thres=thr, max_det=None)]
        plain = nms_sorted_candidates(*(t.cpu() for t in cands),
                                      iou_thres=thr, max_det=None)
        cb, cs, cc = cands
        nb = torch.where((cs > 0)[..., None],
                         cb + cc.float()[..., None] * _MAX_WH,
                         torch.zeros_like(cb))
        keep_k = nms_kernel.nms_fixpoint(nb.contiguous(), thr)
        keep_p = nms_mask_fixpoint(nb, thr)
        step_out = [t.cpu() for t in step(x)]
    for a, b in zip(on_card, plain):
        if not torch.equal(a, b):
            raise AssertionError("dets through the kernel differ from the "
                                 "plain NMS on the same candidates")
    serve_vs_plain = all(torch.equal(a, b) for a, b in zip(step_out, plain))
    cand_diff = int((keep_k != keep_p).sum())
    if cand_diff:
        raise AssertionError(f"kernel keep mask on serve candidates differs "
                             f"in {cand_diff} places")
    log(f"serve candidates B=8: dets through the kernel == plain NMS dets "
        f"({int(plain[3].sum())} kept of {int((cs > 0).sum())}); keep masks "
        f"equal; serve step == plain: {serve_vs_plain}")
    if not serve_vs_plain:
        raise AssertionError("the serve step's dets differ from the plain "
                             "NMS dets on the same frames")

    # the serve step at B=32 now, before the other paths run: phase 5 times
    # it again after them, and the two are printed side by side
    xb = torch.from_numpy(np.random.default_rng(2).integers(
        0, 256, (32, 640, 640, 3)).astype(np.uint8)).to(dev)
    step_ms_early = cuda_ms(lambda: step(xb), 10)

    # f32 network on the card vs on the CPU, small input, TF32 off
    model32 = build_yolov5("s", 80, device="cpu",
                           generator=torch.Generator().manual_seed(0))
    xs = torch.from_numpy(frame_rng.uniform(
        0, 1, (2, 128, 128, 3)).astype(np.float32))
    with torch.inference_mode():
        ref = model32(xs)
        got = model32.to(dev)(xs.to(dev))
    net_err = max(float((g.cpu() - r).abs().max()) for g, r in zip(got, ref))
    scale = max(float(r.abs().max()) for r in ref)
    log(f"f32 network card vs CPU, 2x128x128: max abs err {net_err:.3g} "
        f"(max |logit| {scale:.3g})")
    if not net_err <= 1e-3 * max(1.0, scale):
        raise AssertionError("f32 network on the card disagrees with the CPU")
    del model32, got, ref

    log(f"[phase 4a done at {time.perf_counter() - t_start:.1f} s]")
    # 4b. the eval path, both routes
    t0 = time.perf_counter()
    batches, gts = eval_batches(np.random.default_rng(2), 64, 32, 640,
                                letterbox_np)
    log(f"eval data: 64 frames letterboxed to 640² in "
        f"{time.perf_counter() - t0:.2f} s, "
        f"{sum(len(g[2]) for g in gts)} gt boxes")

    def gt_eval():
        ev = DetEval(80)
        for img_id, xywh, classes in gts:
            ev.add_gt(img_id, xywh, classes)
        return ev

    fwd = forward_for_eval(model, 80, device=dev)
    kw = dict(conf_thres=0.001, iou_thres=thr, pre_nms_topk=1024,
              max_det=300)
    routes = {
        "unfused": (Evaluator(fwd, 80, device=dev, **kw), "nms_mask"),
        "packed": (Evaluator(None, 80, device=dev, step_fn=(
            make_packed_serve_step(model, 80, device=dev, **kw))),
            "nms_fixpoint"),
    }
    eval_stats, eval_counts, eval_rates = {}, {}, {}
    for name, (ev, kernel) in routes.items():
        ev.run(batches[:1], det_eval=DetEval(80))        # warm-up
        torch.cuda.synchronize()
        reset_launch_counts()
        stats = ev.run(batches, det_eval=gt_eval())
        torch.cuda.synchronize()
        eval_counts[name] = dict(launch_counts)
        eval_stats[name] = stats
        eval_rates[name] = [stats["images_per_sec"]] + [
            ev.run(batches, det_eval=gt_eval())["images_per_sec"]
            for _ in range(2)]
        log(f"eval [{name}]: {stats['num_images']} images, "
            f"{stats['images_per_sec']:.2f} img/s (host accumulate "
            f"included; repeats {eval_rates[name][1]:.2f}, "
            f"{eval_rates[name][2]:.2f}), AP {stats['AP']:.6f} AP50 "
            f"{stats['AP50']:.6f}, launches {eval_counts[name]}")
        if eval_counts[name][kernel] < 1:
            raise AssertionError(f"{kernel} was not launched on the "
                                 f"{name} eval route")
        if stats["num_images"] != 64 or not all(
                math.isfinite(v) and -1.0 <= v <= 1.0
                for k, v in stats.items()
                if k not in ("images_per_sec", "num_images")):
            raise AssertionError(f"eval [{name}]: bad stats {stats}")

    # the host side of one eval batch of 32: staging the uint8 frames in
    # pinned memory, and the accumulate (letterbox inverse and add_det)
    meta0 = (batches[0]["img_id"], batches[0]["scale"], batches[0]["pad_x"],
             batches[0]["pad_y"], batches[0]["orig_hw"])
    t0 = time.perf_counter()
    torch.from_numpy(batches[0]["image"]).pin_memory()
    pin_ms = (time.perf_counter() - t0) * 1e3
    out0 = routes["unfused"][0]._dispatch(batches[0]["image"])
    out0[1].synchronize()
    t0 = time.perf_counter()
    n_img0 = Evaluator._accumulate(gt_eval(), out0, meta0)
    acc_ms = (time.perf_counter() - t0) * 1e3
    log(f"eval host side, one batch of {n_img0} images: pinned staging "
        f"{pin_ms:.3f} ms, accumulate {acc_ms:.3f} ms "
        f"({int(out0[0][3].sum())} dets)")

    # the unfused route's candidates through nms_mask and through the plain
    # batched_nms on CPU copies: the same dets and the same stats
    ev_k, ev_p = gt_eval(), gt_eval()
    n_kept = 0
    for batch in batches:
        meta = (batch["img_id"], batch["scale"], batch["pad_x"],
                batch["pad_y"], batch["orig_hw"])
        with torch.inference_mode():
            cand = multilabel_candidates(
                *fwd(torch.from_numpy(batch["image"]).to(dev)),
                topk=1024, conf_thres=0.001)
            nms_kw = dict(iou_thres=thr, score_thres=0.001,
                          pre_nms_topk=1024, max_det=300)
            dets_k = tuple(t.cpu() for t in batched_nms(*cand, **nms_kw))
            dets_p = batched_nms(*(t.cpu() for t in cand), **nms_kw)
        for a, b in zip(dets_k, dets_p):
            if not torch.equal(a, b):
                raise AssertionError("eval dets through nms_mask differ "
                                     "from the plain batched_nms's")
        n_kept += int(dets_k[3].sum())
        Evaluator._accumulate(ev_k, (dets_k, None), meta)
        Evaluator._accumulate(ev_p, (dets_p, None), meta)
    s_k, s_p = ev_k.summarize(), ev_p.summarize()
    if s_k != s_p:
        raise AssertionError(f"stats through nms_mask {s_k} != plain {s_p}")
    log(f"eval candidates, 64 frames: dets and stats through nms_mask == "
        f"plain batched_nms on CPU copies ({n_kept} dets, AP {s_k['AP']:.6f})")

    # painted gt at 640²: AP > 0.99 through nms_mask, with and without a
    # letterbox inverse (a 1280x1248 source at scale 0.5, pad_x 8)
    gts_lb, gt_cls = PAINTED_GTS, PAINTED_CLS
    raws = [torch.from_numpy(r).to(dev)
            for r in paint_raw_maps(gts_lb, gt_cls, 640, 80)]
    painted = Evaluator(lambda images: decode_full(raws, 80), 80,
                        conf_thres=0.1, pre_nms_topk=1024, max_det=300,
                        device=dev)
    geometry = {}
    for label, (s_, px, py, hw) in {
            "identity": (1.0, 0.0, 0.0, (640, 640)),
            "letterbox": (0.5, 8.0, 0.0, (1280, 1248))}.items():
        ev = DetEval(80)
        xywh = []
        for cx, cy, w, h in gts_lb:
            x1 = np.clip((cx - w / 2 - px) / s_, 0, hw[1])
            y1 = np.clip((cy - h / 2 - py) / s_, 0, hw[0])
            x2 = np.clip((cx + w / 2 - px) / s_, 0, hw[1])
            y2 = np.clip((cy + h / 2 - py) / s_, 0, hw[0])
            xywh.append((x1, y1, x2 - x1, y2 - y1))
        ev.add_gt("painted", xywh, gt_cls)
        reset_launch_counts()
        stats = painted.run([{
            "image": np.zeros((1, 640, 640, 3), np.uint8),
            "img_id": ["painted"], "scale": [s_], "pad_x": [px],
            "pad_y": [py], "orig_hw": [hw]}], det_eval=ev)
        geometry[label] = stats["AP"]
        log(f"painted gt at 640² [{label}]: AP {stats['AP']:.6f} AP50 "
            f"{stats['AP50']:.6f}, launches {dict(launch_counts)}")
        if launch_counts["nms_mask"] < 1 or not stats["AP"] > 0.99:
            raise AssertionError(f"painted gt [{label}]: AP {stats['AP']} "
                                 f"or no nms_mask launch")

    log(f"[phase 4b done at {time.perf_counter() - t_start:.1f} s]")
    # 4c. the iou op's path
    a_iou = torch.from_numpy(sorted_boxes(rng, 1, 1024)[0]).to(dev)
    b_iou = torch.from_numpy(sorted_boxes(rng, 1, 25200)[0]).to(dev)
    reset_launch_counts()
    iou_out = iou_matrix(a_iou, b_iou)
    torch.cuda.synchronize()
    iou_counts = dict(launch_counts)
    log(f"iou path: ops.boxes.iou_matrix (1024, 25200), launches "
        f"{iou_counts}")
    if iou_counts["iou_matrix"] < 1 or tuple(iou_out.shape) != (1024, 25200):
        raise AssertionError("iou_matrix was not launched by its op")

    log(f"[phase 4c done at {time.perf_counter() - t_start:.1f} s]")
    # 4d. the serving surface: load_detector, TTA/WBF, BatchingDetector
    import tempfile
    import threading
    import urllib.request
    with tempfile.TemporaryDirectory() as tmp:
        ckpt_dir = os.path.join(tmp, "ckpt")
        save_eval_variables(ckpt_dir, model.state_dict(), 0)
        cfg_path = os.path.join(tmp, "chip_smoke_cfg.py")
        with open(cfg_path, "w") as f:
            f.write(SMOKE_CONFIG)
        loaded = load_detector(cfg_path, ckpt=ckpt_dir)
        tta_det = load_detector(cfg_path, ckpt=ckpt_dir, tta=True)
    if loaded.device != dev or tta_det.device != dev:
        raise AssertionError(f"load_detector chose {loaded.device}")
    by_hand = Detector(make_packed_serve_step(
        model, 80, conf_thres=0.001, iou_thres=thr, max_det=300,
        multi_label=False, device=dev), 80, 640, device=dev)
    frames6 = [f for req in requests for f in req]
    loaded.detect_batch(frames6)                  # warm-up, not counted
    torch.cuda.synchronize()
    reset_launch_counts()
    got6 = loaded.detect_batch(frames6)
    torch.cuda.synchronize()
    load_counts = dict(launch_counts)
    want6 = by_hand.detect_batch(frames6)
    n_loaded = sum(check_dets(f, d) for f, d in zip(frames6, got6))
    log(f"load_detector(config file, ckpt dir): {n_loaded} dets over "
        f"{len(frames6)} frames, launches {load_counts}")
    if load_counts["nms_fixpoint"] != 1 or n_loaded == 0:
        raise AssertionError("load_detector's path did not launch "
                             "nms_fixpoint once, or found nothing")
    if not all(same_dets(g, w) for g, w in zip(got6, want6)):
        raise AssertionError("load_detector's dets differ from the "
                             "hand-built Detector's on the same weights")
    log("load_detector's dets == the hand-built Detector's, exactly")

    tta_sizes = [(480, 640), (720, 1280), (640, 640), (375, 500),
                 (1080, 1920), (640, 427), (512, 512), (300, 400)]
    frames8 = [frame_rng.integers(0, 256, hw + (3,)).astype(np.uint8)
               for hw in tta_sizes]
    tta_det.detect_batch(frames8)                 # warm-up: both sizes
    torch.cuda.synchronize()
    reset_launch_counts()
    fused8 = tta_det.detect_batch(frames8)
    torch.cuda.synchronize()
    tta_counts = dict(launch_counts)
    n_fused = sum(check_dets(f, d) for f, d in zip(frames8, fused8))
    with torch.inference_mode():
        x8, metas8 = tta_det._letterbox(frames8, 640)
        views = tta_det._view_dets(frames8, x8, metas8)
        cat = [torch.cat([v[k] for v in views], 1) for k in range(4)]
        wbf_kw = dict(n_views=3, iou_thres=tta_det.wbf_iou, max_out=300)
        on_card = [t.cpu() for t in weighted_boxes_fusion(*cat, **wbf_kw)]
        on_cpu = weighted_boxes_fusion(*(t.cpu() for t in cat), **wbf_kw)
    wbf_box_err = float((on_card[0] - on_cpu[0]).abs().max())
    wbf_score_err = float((on_card[1] - on_cpu[1]).abs().max())
    n_cand = int(cat[3].sum())
    log(f"TTA path: 8 frames, 3 views, launches {tta_counts}; {n_cand} "
        f"candidates of {cat[3].numel()} valid → {n_fused} fused dets; WBF "
        f"card vs CPU: boxes {wbf_box_err:.3g} px, scores "
        f"{wbf_score_err:.3g}, classes equal "
        f"{torch.equal(on_card[2], on_cpu[2])}, valid equal "
        f"{torch.equal(on_card[3], on_cpu[3])}")
    if tta_counts["nms_fixpoint"] != 3:
        raise AssertionError(f"TTA launched nms_fixpoint "
                             f"{tta_counts['nms_fixpoint']} times, not 3")
    if tuple(cat[0].shape) != (8, 900, 4) or n_fused == 0:
        raise AssertionError("TTA views are not (8, 900, 4), or nothing "
                             "was fused")
    if not (wbf_box_err <= 1e-3 and wbf_score_err <= 1e-6
            and torch.equal(on_card[2], on_cpu[2])
            and torch.equal(on_card[3], on_cpu[3])):
        raise AssertionError("WBF on the card differs from WBF on the CPU")
    if int(on_card[3].sum()) != n_fused:
        raise AssertionError("detect_batch's fused dets are not the "
                             "fusion of the views")

    pool = frames8 + frames6 + [frames8[0][::-1].copy(),
                                frames8[2][:, ::-1].copy()]     # 16 frames

    def alone_at(frame, bucket):
        """What detect_batch([frame] * bucket)[0] gives, the frame
        letterboxed once."""
        x1, metas1 = loaded._letterbox([frame], 640)
        out = [t[0].cpu().numpy() for t in loaded._detect(
            x1.expand(bucket, -1, -1, -1).contiguous())]
        return loaded._to_source(*out, metas1[0], frame.shape[:2])

    if not same_dets(alone_at(pool[1], 4), loaded.detect_batch(
            [pool[1]] * 4)[0]):
        raise AssertionError("alone_at is not detect_batch of copies")
    refs = {b: [alone_at(f, b) for f in pool] for b in (4, 16)}
    n_bucket_differs = sum(not same_dets(a, b)
                           for a, b in zip(refs[4], refs[16]))
    batcher = BatchingDetector(loaded, batch_size=16, batch_buckets=(4, 16))
    try:
        batcher.warmup()
        batcher.reset_stats()
        torch.cuda.synchronize()
        reset_launch_counts()
        results, latencies, load_wall = client_load(batcher, pool, 8, 16)
        torch.cuda.synchronize()
        batch_counts = dict(launch_counts)
        stats = batcher.stats()
        srv = make_http_server(batcher, host="127.0.0.1", port=0)
        th = threading.Thread(target=srv.serve_forever, daemon=True)
        th.start()
        try:
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{srv.server_address[1]}/healthz",
                    timeout=30) as r:
                healthz = json.loads(r.read())
        finally:
            srv.shutdown()
            srv.server_close()
            th.join(timeout=10)
    finally:
        closed = batcher.close(timeout=60.0)
    at_bucket = {4: 0, 16: 0}
    for idx, dets in results:
        check_dets(pool[idx], dets)
        hit = [b for b in (4, 16) if same_dets(dets, refs[b][idx])]
        if not hit:
            raise AssertionError(f"a batched request's dets equal neither "
                                 f"bucket's Detector.detect_batch (frame "
                                 f"{idx})")
        at_bucket[hit[0]] += 1
    fill = stats["requests"] / max(stats["dispatched_slots"], 1)
    lat = np.sort(np.asarray(latencies)) * 1e3
    log(f"BatchingDetector: 8 clients x 16 frames, all 128 resolved, each "
        f"equal to Detector.detect_batch at a bucket size ({at_bucket}; "
        f"{n_bucket_differs} of 16 frames differ between the buckets); "
        f"stats {stats}, launches {batch_counts}, healthz {healthz}, "
        f"close() {closed}")
    if stats["requests"] != 128 or \
            stats["dispatched_slots"] - stats["padded_slots"] != 128:
        raise AssertionError(f"BatchingDetector stats do not add up: {stats}")
    if batch_counts["nms_fixpoint"] != stats["batches"]:
        raise AssertionError("nms_fixpoint did not launch once per batch")
    if not closed or healthz.get("ok") is not True or \
            healthz.get("requests") != 128:
        raise AssertionError(f"close() {closed}, healthz {healthz}")

    log(f"[phase 4d done at {time.perf_counter() - t_start:.1f} s]")
    # 4e. training: run_train with its in-loop eval, the loss falling, the
    # card against the CPU, the train step's times
    train = train_phase(dev, smi)
    log(f"[phase 4e done at {time.perf_counter() - t_start:.1f} s]")
    # 4f. every YOLOv5 config: VisDrone at 1280² through run_train with
    # device_aug and autoanchor, DropBlock with remat off and on at 640²,
    # and the fused route above nms_fixpoint's largest N
    visdrone = visdrone_phase(dev, smi)
    log(f"[phase 4f.1 done at {time.perf_counter() - t_start:.1f} s]")
    dropblock = dropblock_phase(dev, smi)
    log(f"[phase 4f.2 done at {time.perf_counter() - t_start:.1f} s]")
    c1 = c1_phase(dev, model, thr)
    log(f"[phase 4f.3 done at {time.perf_counter() - t_start:.1f} s]")
    # 4g. FasterRCNN inference: the published pafpn_decoupled_coco_832
    # through faster_rcnn_infer, the Evaluator, load_detector and the
    # BatchingDetector, the RoIPool P2 config, nms_mask past 16384, times
    rcnn = rcnn_phase(dev, smi, letterbox_np)
    log(f"[phase 4g done at {time.perf_counter() - t_start:.1f} s]")
    # 4h. FasterRCNN training: the published pafpn_decoupled_coco_832
    # through train_from_datasets with a resume and load_detector, the loss
    # falling, card against CPU, iou_matrix at the assigner's shape, times
    rcnn_train = rcnn_train_phase(dev, smi)
    log(f"[phase 4h done at {time.perf_counter() - t_start:.1f} s]")
    # 4i. export on the card, run_test with its panels, the eval
    # artifacts with the native matcher, the custom ops' cost
    os.makedirs(RUNS_DIR, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=RUNS_DIR) as work:
        export, rmodel = export_phase(dev, smi, model, work)
        log(f"[phase 4i.1 done at {time.perf_counter() - t_start:.1f} s]")
        tested = run_test_phase(dev, smi, model, rmodel, work)
        del rmodel
    log(f"[phase 4i.2 done at {time.perf_counter() - t_start:.1f} s]")
    artifacts = artifacts_phase(dev, smi, model, routes["unfused"][0],
                                batches, gt_eval)
    log(f"[phase 4i.3 done at {time.perf_counter() - t_start:.1f} s]")
    ops_cost = ops_cost_phase(dev, smi)
    log(f"[phase 4i.4 done at {time.perf_counter() - t_start:.1f} s]")
    # 4j. W8A8 int8 serving: both configs quantized, their int8 products
    # held to the plain version, the int8 entry points, the letterbox
    int8 = {"yolov5_s_coco_640": int8_yolo_phase(
        dev, smi, model, rcnn_config(YOLO_CONFIG), letterbox_np)[0]}
    log(f"[phase 4j.1 done at {time.perf_counter() - t_start:.1f} s]")
    int8["faster_rcnn_pafpn_decoupled_coco_832"], rmodel = int8_rcnn_phase(
        dev, smi, rcnn_config(RCNN_CONFIG), letterbox_np)
    log(f"[phase 4j.2 done at {time.perf_counter() - t_start:.1f} s]")
    with tempfile.TemporaryDirectory(dir=RUNS_DIR) as work:
        int8["entry_points"] = int8_entry_phase(dev, smi, model, rmodel,
                                                work)
    del rmodel
    log(f"[phase 4j.3 done at {time.perf_counter() - t_start:.1f} s]")
    int8["letterbox_card_vs_cpu"] = letterbox_device_phase(dev)
    log(f"[phase 4j.4 done at {time.perf_counter() - t_start:.1f} s]")
    # 5. times: CUDA events over back-to-back wrapper calls (the host's
    # launch cost included), and each kernel's device time by name from
    # torch.profiler
    def show(x):
        return "not measured" if x is None else f"{x:.4f} ms"

    def minus(a, b):
        return None if a is None or b is None else a - b

    times = {}
    for b in (1, 8, 32, 64):
        boxes = torch.from_numpy(class_offset_boxes(
            np.random.default_rng(b), b, 1024, 200)).to(dev)
        dev_ms = profiled_ms(
            lambda: (nms_kernel.nms_fixpoint(boxes, thr),
                     nms_kernel.nms_fixpoint_build(boxes, thr)), 20,
            ("nms_fixpoint_kernel", "nms_fixpoint_build_kernel"))
        whole = dev_ms["nms_fixpoint_kernel"]
        build_only = dev_ms["nms_fixpoint_build_kernel"]
        t = times[b] = {
            "ms": cuda_ms(lambda: nms_kernel.nms_fixpoint(boxes, thr), 50),
            "build_ms": cuda_ms(
                lambda: nms_kernel.nms_fixpoint_build(boxes, thr), 50),
            "device_ms": whole, "build_device_ms": build_only,
            "scan_device_ms": minus(whole, build_only),
            "plain_ms": cuda_ms(lambda: nms_mask_fixpoint(boxes, thr), 5,
                                warmup=1),
            "bound": nms_bound_ms(b, 1024),
        }
        log(f"nms_fixpoint B={b} N=1024: events {t['ms']:.4f} ms (build "
            f"alone {t['build_ms']:.4f} ms) | device {show(whole)} = build "
            f"{show(build_only)} + scan {show(t['scan_device_ms'])} | plain "
            f"{t['plain_ms']:.4f} ms | bound {t['bound'][0]:.5f} ms "
            f"({t['bound'][1]})")

    mask_times = {}
    for b, n in ((32, 1024), (8, 2048), (8, 1024)):
        boxes = torch.from_numpy(class_offset_boxes(
            np.random.default_rng(n + b), b, n, n // 5)).to(dev)
        dev_ms = profiled_ms(lambda: nms_kernel.nms_mask(boxes, thr), 20,
                             ("nms_mask_build_kernel", "nms_mask_scan_kernel"))
        build_dev = dev_ms["nms_mask_build_kernel"]
        scan_dev = dev_ms["nms_mask_scan_kernel"]
        t = mask_times[(b, n)] = {
            "ms": cuda_ms(lambda: nms_kernel.nms_mask(boxes, thr), 50),
            "device_ms": None if build_dev is None or scan_dev is None
            else build_dev + scan_dev,
            "build_device_ms": build_dev, "scan_device_ms": scan_dev,
            "plain_ms": cuda_ms(lambda: nms_mask_seq(boxes, thr), 3,
                                warmup=1),
            "bound": nms_bound_ms(b, n),
        }
        log(f"nms_mask B={b} N={n}: events {t['ms']:.4f} ms | device "
            f"{show(t['device_ms'])} = build {show(build_dev)} + scan "
            f"{show(scan_dev)} | plain {t['plain_ms']:.4f} ms | bound "
            f"{t['bound'][0]:.5f} ms ({t['bound'][1]})")

    del iou_out
    iou_times = {}
    for n, m in ((1024, 25200), (65536, 128)):
        ia = torch.from_numpy(sorted_boxes(rng, 1, n)[0]).to(dev)
        ib = torch.from_numpy(sorted_boxes(rng, 1, m)[0]).to(dev)
        t = iou_times[(n, m)] = {
            "ms": cuda_ms(lambda: iou_kernel.iou_matrix(ia, ib), 20),
            "device_ms": profiled_ms(
                lambda: iou_kernel.iou_matrix(ia, ib), 10,
                ("iou_matrix_kernel",))["iou_matrix_kernel"],
            "plain_ms": cuda_ms(lambda: box_iou_matrix(ia, ib), 10),
            "bound": iou_bound_ms(n, m),
        }
        log(f"iou_matrix ({n}, {m}): events {t['ms']:.4f} ms | device "
            f"{show(t['device_ms'])} | plain {t['plain_ms']:.4f} ms | "
            f"bound {t['bound'][0]:.5f} ms ({t['bound'][1]})")
        del ia, ib
    iou_t, iou_tall = iou_times[(1024, 25200)], iou_times[(65536, 128)]

    probe = torch.zeros((8, 900), device=dev)
    launch_us = cuda_ms(lambda: probe.add_(1.0), 2000, warmup=100) * 1e3
    log(f"eager launch floor: {launch_us:.2f} us per back-to-back "
        f"elementwise launch on a (8, 900) tensor")
    with torch.inference_mode():
        step_ms = cuda_ms(lambda: step(xb), 10)
        xf = xb.float() / 255.0
        fwd_ms = cuda_ms(lambda: packed_model(xf), 10)
        outs = packed_model(xf)
        sel_ms = cuda_ms(lambda: fused_select_decode_packed(
            outs, 80, topk=1024, conf_thres=0.001), 10)
        cands32 = fused_select_decode_packed(outs, 80, topk=1024,
                                             conf_thres=0.001)
        nms_ms = cuda_ms(lambda: nms_sorted_candidates(
            *cands32, iou_thres=thr, max_det=None), 10)
        del outs, cands32
        # the unfused eval step: forward + decode_full, candidates, NMS
        ev_step_ms = cuda_ms(lambda: routes["unfused"][0]._step(xb), 5)
        fd_ms = cuda_ms(lambda: fwd(xb), 5)
        dec = fwd(xb)
        ml_ms = cuda_ms(lambda: multilabel_candidates(
            *dec, topk=1024, conf_thres=0.001), 10)
        cand = multilabel_candidates(*dec, topk=1024, conf_thres=0.001)
        bn_ms = cuda_ms(lambda: batched_nms(
            *cand, iou_thres=thr, score_thres=0.001, pre_nms_topk=1024,
            max_det=300), 10)
        del dec, cand
        serve_kernels = device_kernels(lambda: step(xb), 5)
        ev_kernels = device_kernels(
            lambda: routes["unfused"][0]._step(xb), 3)

    log(f"[phase 5 kernels and steps done at {time.perf_counter() - t_start:.1f} s]")
    # TTA per batch of 8 and of 32 (the 8 frames four times): the whole
    # detect_batch by the host clock, the three views and the fusion apart
    # by CUDA events (the rescaled view's host letterbox falls in "views")
    tta_times = {}
    for frames_b in (frames8, frames8 * 4):
        nb_ = len(frames_b)
        tta_det.detect_batch(frames_b)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(2):
            tta_det.detect_batch(frames_b)
        whole_ms = (time.perf_counter() - t0) * 1e3 / 2
        with torch.inference_mode():
            xb_, metas_ = tta_det._letterbox(frames_b, 640)
            views_ms = cuda_ms(
                lambda: tta_det._view_dets(frames_b, xb_, metas_), 2,
                warmup=1)
            views_ = tta_det._view_dets(frames_b, xb_, metas_)
            cat_ = [torch.cat([v[k] for v in views_], 1) for k in range(4)]
            wbf_ms = cuda_ms(lambda: weighted_boxes_fusion(*cat_, **wbf_kw),
                             2, warmup=1)
            wbf_dev = device_busy_ms(
                lambda: weighted_boxes_fusion(*cat_, **wbf_kw))
        tta_times[nb_] = {
            "detect_batch_ms": whole_ms, "views_ms": views_ms,
            "wbf_ms": wbf_ms, "wbf_share": wbf_ms / whole_ms,
            "wbf_device_busy_ms": wbf_dev,
            "wbf_steps": int(cat_[3].sum(-1).max()),
        }
        t = tta_times[nb_]
        log(f"TTA B={nb_} 640x640 bf16, 3 views: detect_batch "
            f"{whole_ms:.3f} ms (host clock, letterboxes included) | views "
            f"{views_ms:.3f} ms | WBF {wbf_ms:.3f} ms ({t['wbf_steps']} "
            f"steps; device busy {wbf_dev:.3f} ms of it), "
            f"{t['wbf_share']:.3f} of the whole")
        del xb_, views_, cat_
    serving = {
        "tta": {str(k): v for k, v in tta_times.items()},
        "batching": {
            "clients": 8, "requests": 128, "batch_size": 16,
            "batch_buckets": [4, 16], "img_per_s": 128 / load_wall,
            "wall_s": load_wall, "mean_fill": fill,
            "batches": stats["batches"],
            "latency_ms_p50": float(lat[len(lat) // 2]),
            "latency_ms_p99": float(lat[min(len(lat) - 1,
                                            int(len(lat) * 0.99))]),
            "latency_ms_max": float(lat[-1]),
            "answers_at_bucket": {str(k): v for k, v in at_bucket.items()},
            "frames_differing_between_buckets": n_bucket_differs,
        },
        "wbf_card_vs_cpu": {"box_err_px": wbf_box_err,
                            "score_err": wbf_score_err},
    }
    bt = serving["batching"]
    log(f"BatchingDetector, 8 closed-loop clients, mixed-size frames "
        f"letterboxed on the client threads: {bt['img_per_s']:.1f} img/s, "
        f"mean fill {fill:.3f} over {bt['batches']} batches, latency p50 "
        f"{bt['latency_ms_p50']:.2f} ms, p99 {bt['latency_ms_p99']:.2f} ms")

    log(f"[phase 5 TTA done at {time.perf_counter() - t_start:.1f} s]")
    def busy(rows, step_ms, kernel):
        """Device-busy ms, idle share, the NMS kernel's ms and the top six
        kernels of one step."""
        total = sum(ms for _, ms in rows)
        return {"device_busy_ms": total, "idle_share": 1.0 - total / step_ms,
                f"{kernel}_ms": sum(ms for k, ms in rows if kernel in k),
                "top_kernels": [[k[:80], ms] for k, ms in rows[:6]]}

    serve_dev = busy(serve_kernels, step_ms, "nms_fixpoint_kernel")
    ev_dev = busy(ev_kernels, ev_step_ms, "nms_mask")
    for label, d in (("serve", serve_dev), ("unfused eval", ev_dev)):
        log(f"{label} step B=32 on the device (profiler): busy "
            f"{d['device_busy_ms']:.3f} ms, idle share "
            f"{d['idle_share']:.3f}; top kernels: " + "; ".join(
                f"{k[:60]} {ms:.3f} ms" for k, ms in d["top_kernels"]))
    log(f"serve step B=32 640x640 bf16: {step_ms:.3f} ms/batch "
        f"({step_ms_early:.3f} ms right after phase 4a), "
        f"{32e3 / step_ms:.1f} img/s | forward {fwd_ms:.3f} ms, "
        f"select+decode {sel_ms:.3f} ms, nms_sorted_candidates "
        f"{nms_ms:.3f} ms (incl. kernel)")
    log(f"unfused eval step B=32 640x640 bf16: {ev_step_ms:.3f} ms/batch | "
        f"forward+decode_full {fd_ms:.3f} ms, multilabel_candidates "
        f"{ml_ms:.3f} ms, batched_nms {bn_ms:.3f} ms (incl. kernel)")

    t32 = times[32]
    m32, m2k = mask_times[(32, 1024)], mask_times[(8, 2048)]
    nms_keys = ("ms", "build_ms", "device_ms", "build_device_ms",
                "scan_device_ms", "plain_ms")
    # 4k.2-3. the native loader where it builds, and run_train's two hooks;
    # after phase 5, so that no profiler session of 4k.3 comes before one
    # of phase 5's
    native = {"probe": loader}
    if native["probe"]["built"]:
        native.update(native_loader_phase(dev, smi))
        log(f"[phase 4k.2 done at {time.perf_counter() - t_start:.1f} s]")
    else:
        log(f"phase 4k.2 skipped: the native loader is "
            f"{native['probe']['verdict']}")
    native["hooks"] = train_hooks_phase(dev, smi)
    if native["hooks"]["train_loader"]["native"] != native["probe"]["built"]:
        raise AssertionError("run_train's loader choice disagrees with the "
                             "loader core's build")
    log(f"[phase 4k.3 done at {time.perf_counter() - t_start:.1f} s]")
    kernels = [{
        "name": "nms_fixpoint", "route": "cuda",
        "source": "heltondetection_tpu_torch/csrc/nms_fixpoint.cu",
        "replaces": "heltondetection_tpu/ops/nms.py:219",
        "launches": counts["nms_fixpoint"],
        "launches_packed_eval": eval_counts["packed"]["nms_fixpoint"],
        "launches_load_detector": load_counts["nms_fixpoint"],
        "launches_tta": tta_counts["nms_fixpoint"],
        "launches_batching": batch_counts["nms_fixpoint"],
        "launches_train_eval": train["run_train"]["launches_nms_fixpoint"],
        "launches_train_eval_visdrone_1280":
            visdrone["run_train"]["launches"]["nms_fixpoint"],
        "launches_run_test_yolov5":
            tested["yolov5_s_coco_640"]["launches"]["nms_fixpoint"],
        "launches_int8_serve": sum(
            int8["yolov5_s_coco_640"][m]["launches"]["nms_fixpoint"]
            for m in ("layer", "flow")),
        "launches_int8_entry_points": {
            k: v for k, v in int8["entry_points"]["yolov5_s_coco_640"].items()
            if k.endswith("launches")},
        "op_ms_b32": ops_cost["nms_fixpoint B=32 N=1024"],
        "max_abs_err": max_abs_err,
        "shape": [32, 1024, 4],
        "ms": t32["ms"], "plain_ms": t32["plain_ms"],
        "bound_ms": t32["bound"][0], "bound_by": t32["bound"][1],
        "library_ms": None, "library_note": NO_LIBRARY,
        "device_ms": t32["device_ms"],
        "build_device_ms": t32["build_device_ms"],
        "scan_device_ms": t32["scan_device_ms"],
        "by_batch_n1024": {
            str(b): {**{k: t[k] for k in nms_keys if k in t},
                     "bound_ms": t["bound"][0]} for b, t in times.items()},
        "max_n": n_max, "clusters_at_once_n1024": clusters,
        "check": "exact keep masks (random, padding, 1024-deep chain, B=1, "
                 "B=64, identical, no overlap, largest N, serve "
                 "candidates); build alone sets the plain S's bits",
    }, {
        "name": "nms_mask", "route": "cuda",
        "source": "heltondetection_tpu_torch/csrc/nms_mask.cu",
        "replaces": "heltondetection_tpu/ops/nms.py:145",
        "launches": eval_counts["unfused"]["nms_mask"],
        "launches_fused_route_n2401": c1["launches"]["nms_mask"],
        "launches_rcnn_infer": rcnn["infer"]["launches"]["nms_mask"],
        "launches_rcnn_eval": rcnn["eval"]["launches"]["nms_mask"],
        "launches_rcnn_eval_per_batch":
            rcnn["eval"]["launches"]["nms_mask"] / rcnn["eval"]["batches"],
        "launches_export_yolov5_per_call":
            export["yolov5_s_coco_640"]["launches_per_call"],
        "launches_export_rcnn_per_call":
            export["faster_rcnn_pafpn_decoupled_coco_832"][
                "launches_per_call"],
        "launches_run_test_rcnn":
            tested["faster_rcnn_pafpn_decoupled_coco_832"]["launches"][
                "nms_mask"],
        "launches_rcnn_class_score_panel":
            tested["faster_rcnn_pafpn_decoupled_coco_832"][
                "panel_launches"]["nms_mask"],
        "op_ms_b32": ops_cost["nms_mask B=32 N=1024"],
        "op_ms_b8": ops_cost["nms_mask B=8 N=1024"],
        "launches_int8_rcnn": int8["faster_rcnn_pafpn_decoupled_coco_832"][
            "launches"]["nms_mask"],
        "launches_int8_export": {
            k: v["export_launches_per_call"] * 2
            for k, v in int8["entry_points"].items() if k != "card"},
        "launches_int8_rcnn_entry_points": {
            k: v for k, v in int8["entry_points"][
                "faster_rcnn_pafpn_decoupled_coco_832"].items()
            if k.endswith("launches")},
        "launches_rcnn_train": rcnn_train["run_train"]["launches"]["nms_mask"],
        "largest_n_checked": max(v["padded_n"] for v in
                                 rcnn["nms_mask_large_n"].values()),
        "max_n": rcnn["nms_mask_max_n"],
        "large_n": rcnn["nms_mask_large_n"],
        "max_abs_err": mask_err,
        "shape": [32, 1024, 4],
        "ms": m32["ms"], "plain_ms": m32["plain_ms"],
        "bound_ms": m32["bound"][0], "bound_by": m32["bound"][1],
        "library_ms": None, "library_note": NO_LIBRARY,
        "device_ms": m32["device_ms"],
        "build_device_ms": m32["build_device_ms"],
        "scan_device_ms": m32["scan_device_ms"],
        "b8_n2048": {**{k: m2k[k] for k in nms_keys if k in m2k},
                     "bound_ms": m2k["bound"][0]},
        "b8_n1024": {**{k: mask_times[(8, 1024)][k] for k in nms_keys
                        if k in mask_times[(8, 1024)]},
                     "bound_ms": mask_times[(8, 1024)]["bound"][0]},
        "check": "exact keep masks (random, padding, 1024-deep chain, "
                 "identical, no overlap, N=2048, equal to nms_fixpoint, "
                 "eval candidates, N=16448 and 20000 with the scan in "
                 "shared memory); FasterRCNN dets equal to the plain "
                 "NMS's",
    }, {
        "name": "iou_matrix", "route": "cuda",
        "source": "heltondetection_tpu_torch/csrc/iou_matrix.cu",
        "replaces": "heltondetection_tpu/ops/boxes.py:143",
        "launches": iou_counts["iou_matrix"],
        "launches_rcnn_train":
            rcnn_train["run_train"]["launches"]["iou_matrix"],
        "op_ms": ops_cost["iou_matrix 1024x25200"],
        "max_abs_err": max(iou_err,
                           rcnn_train["iou_assigner"]["max_abs_err"]),
        "max_ulp": max(iou_ulp, rcnn_train["iou_assigner"]["max_ulp"]),
        "shape": [1024, 25200],
        "ms": iou_t["ms"], "plain_ms": iou_t["plain_ms"],
        "bound_ms": iou_t["bound"][0], "bound_by": iou_t["bound"][1],
        "library_ms": None, "library_note": NO_LIBRARY,
        "device_ms": iou_t["device_ms"],
        "tall_65536x128": {
            "ms": iou_tall["ms"], "device_ms": iou_tall["device_ms"],
            "plain_ms": iou_tall["plain_ms"],
            "bound_ms": iou_tall["bound"][0],
            "bound_by": iou_tall["bound"][1]},
        "rcnn_assigner": {
            k: v for k, v in rcnn_train["iou_assigner"].items()
            if k != "bound"} | {
            "bound_ms": rcnn_train["iou_assigner"]["bound"][0],
            "bound_by": rcnn_train["iou_assigner"]["bound"][1]},
        "check": "within 1 ulp of box_iou_matrix, float4 store (1024x8192, "
                 "ragged 1000x25200 with zero-area rows, N=1, 65536x128, "
                 "the RPN assigner's 172887x128) and float store (M % 4 = "
                 "1, 2, 3 and M=1)",
    }]
    # phase 4k.2's two-step runs on the native loader (null where the
    # loader core does not build on this machine)
    for entry in kernels:
        entry["launches_native_loader_run_train"] = None if not native[
            "probe"]["built"] else sum(
                native[k]["launches"][entry["name"]] for k in native
                if k.startswith("run_train_"))
    serve = {"serve_ms_per_batch_b32": step_ms,
             "serve_ms_per_batch_b32_after_4a": step_ms_early,
             "eager_launch_floor_us": launch_us,
             "serve_img_per_s_b32": 32e3 / step_ms,
             "forward_ms_b32": fwd_ms, "select_decode_ms_b32": sel_ms,
             "nms_sorted_candidates_ms_b32": nms_ms,
             "device_b32": serve_dev}
    evals = {f"{name}_{key}": eval_stats[name][key]
             for name in routes for key in ("images_per_sec", "AP", "AP50")}
    evals.update({f"{name}_images_per_sec_runs": eval_rates[name]
                  for name in routes})
    evals.update({"host_pin_ms_b32": pin_ms, "host_accumulate_ms_b32": acc_ms,
                  "unfused_step_ms_b32": ev_step_ms,
                  "unfused_device_b32": ev_dev,
                  "unfused_forward_decode_ms_b32": fd_ms,
                  "unfused_multilabel_ms_b32": ml_ms,
                  "unfused_batched_nms_ms_b32": bn_ms,
                  "painted_AP_identity": geometry["identity"],
                  "painted_AP_letterbox": geometry["letterbox"],
                  "wall_s": time.perf_counter() - t_start})
    log(json.dumps({"serve": serve}))
    log(json.dumps({"eval": evals}))
    log(json.dumps({"serving": serving}))
    log(json.dumps({"train": train}))
    log(json.dumps({"train_configs": {"visdrone_1280": visdrone,
                                      "dropblock_640": dropblock,
                                      "fused_route_n2401": c1}}))
    log(json.dumps({"rcnn": rcnn}))
    log(json.dumps({"rcnn_train": rcnn_train}))
    log(json.dumps({"export_test_artifacts": {
        "export": export, "run_test": tested, "artifacts": artifacts,
        "ops_cost": ops_cost}}))
    log(json.dumps({"int8": int8}))
    log(json.dumps({"native_loader": native}))
    log(json.dumps({"kernels": kernels}))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
