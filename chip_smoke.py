#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``tpu_cnn_torch``) end to end on one GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --profile-out multi_profile.txt  # + profiler tables

Needs one CUDA device, ``nvcc`` (CUDA toolkit), ``g++`` (the native
oracle of the verify phase) and the repository around this file; it fails
with a non-zero exit code otherwise. Two model families run: lyr3-std
(128x128) and lyr4-wide (256x256), on four single-box main paths: each
family on the default ``mega`` backend (lyr3-std: the whole net in the
megakernel; lyr4-wide: the chained plan, the layer kernel for L0, then the
megakernel for L1-L3), lyr4-wide on ``pallas`` (every layer on the conv
kernel) and lyr3-std on ``hybrid`` (L0 on the conv kernel, L1-L2 plain);
then the bitcast probe's path, and two multi-object paths with the shipped
presence heads: lyr3-std on ``mega`` with ``--multi --instances 2`` (the
kernel's bins and twin, the instance head) and lyr4-wide on ``pallas``
with ``--multi`` (the features branch, the 256-pixel box scale); and
yolov2-tiny-voc (seeded weights) on ``pallas`` with the region head at the
offline cell's batch of 512: every layer's output of the engine bit-equal
to its plain version, in blocks of 64 frames, and the head's answers
equal to its plain version's on the engine's own sums, but where a near
tie of float32 scores lets the two orders differ. Phases, one line each,
in order; any failure raises:

  1. header   — the card (nvidia-smi name and power limit), torch, CUDA
  2. build    — nvcc builds csrc/mega_cnn.cu (on csrc/hopper.cuh's
                wgmma, mbarriers and bulk copies), csrc/conv_pool_layer.cu,
                csrc/conv_act.cu (the last two: the layer kernel of
                csrc/conv_layer.cuh, both on csrc/int8_mma.cuh like the
                megakernel), csrc/bitcast.cu and csrc/cam_head.cu (the
                single-box CAM head, on hopper.cuh's bulk copies) for
                sm_90a, in parallel
  3. kernel   — each kernel against its plain PyTorch version on the card,
                B=37. The megakernel: lyr3-std (shipped and seeded random
                weights, shifts 2/4/6 and 1/3/5, every with_feats/bins/twin
                combination), lyr3-tiny, lyr2-small, and lyr4-wide's L1-L3
                tail from a (B, 16, 128, 128) input; its persistent grid:
                lyr3-std and the tail at batch 1, lyr3-std at twice the
                SM count + 5 and the tail at the SM count + 3 (a second
                image for every CTA); then the edges of its
                tensor-core path: all-255 images on all +127 and all -128
                weights and 0/255 images on ±127/-128 weights at shifts 0
                and 31, 3 input channels, a 128-channel middle layer, 35
                then 13 output channels, a 12-wide layer (no bins there),
                a one-channel middle layer and one-layer nets on every
                input path (a one-channel image by the bulk copy or plain
                loads; a multi-channel band by words or, 3 channels 30
                wide, by bytes). The layer kernel (conv_pool_layer):
                lyr4-wide's L0 (shipped and seeded weights, shifts 3 and
                0), 16->32 at 128^2 and two small odd geometries. The conv
                kernel, unpooled and (even maps) pooled: every layer of
                lyr3-std and lyr4-wide (shipped weights on the plain
                chain's activations at the model's shift, seeded weights
                at shifts 0 and 31), the rectangles 6x10 and 7x12 and
                20->35 across the channel chunks; then its pooled output
                against conv_pool_layer on lyr4-wide's L0. Then the
                tensor-core edges of all three entries: all-255 inputs on
                all +127 and all -128 weights and 0/255 inputs on
                +127/-128 weights at shifts 0 and 31, input channels
                1/3/20/64 against output channels 5/13/35/128 at 7x12,
                6x10 and 38x38, lyr4-wide's L3 (64->128 at 32^2); past 64
                input channels (96->13 at 6x10, 128->35 at 20x20: the
                generic channel padding). Every
                layer-kernel case runs with the weights packed per call
                and packed once. Then the lyr4-wide chain against the
                numpy oracle on 4 images. Features and twin bit-equal, bins within 1e-6; the
                plain f32 and int32 versions bit-equal to each other. The
                bitcast kernel's narrow, widen and roll (shifts 3, 0, -1,
                L+2) bit-equal at (8, 256), (5, 37), (1024, 4096) and
                (4096, 4096) on full-range words, and widen(narrow(x)) == x;
                narrow and widen on views misaligned for the vector path.
                The CAM head against detect_with_pooled ("ref") on K1's
                bins and twin of both families' shipped frames and noise
                at batch 1, 37 and the offline rounds (16,384 and 4,096),
                seeded twins with saturated channels at lyr2-small's,
                lyr3-tiny's and an 8x8 CAM's geometry, an all-zero twin and
                a flat CAM: predictions and boxes equal (a box may be the
                float64 CAM's where the plain version's f32 order breaks a
                tie otherwise), probabilities within 1e-6 of the float64
                head's. yolov2-tiny-voc's layers bit-equal to their plain
                version (L0-L3 and its edges on the region route's layer
                kernel, the layer kernel's bias instantiation once; L4-L8
                and the edges on the streamed kernel, NCHW and
                channels-last maps) and its region head's counts equal to
                the plain head's, detections within 1e-5. (The cases of
                tpu_cnn_torch.apps.kernel_cases.)
  sanitize    — the sanitizer lane's card tools (python -m
                tpu_cnn_torch.apps.sanitize memcheck racecheck synccheck
                initcheck), within 180 s: a probe kernel under each tool,
                the five kernels rebuilt with -lineinfo into a temporary
                directory, phase 3's cases at B=37 under compute-sanitizer,
                each tool's line with the kernels' launches, the paths
                their launches took (as the libraries counted them), the
                reports, the seconds and (memcheck) the out-of-bounds
                canary caught; any report fails. A tool that
                compute-sanitizer refuses on the card before the probe's
                kernel runs ("Device not supported") is printed as not
                measured
  4. engine   — CUDAEngine(device="cuda", backend=...) through the bench's
                parity gate on 28 shipped test images + 4 noise images,
                per path, and set_shifts against the oracle; on a multi
                path detect_multi_batch (direct and staged) on the same 32
                images against the host twins: boxes, instances and counts
                equal, probabilities and presence scores within 1e-4, the
                same detections
  5. cli      — tpu_cnn_torch.apps.infer --mode ... over the shipped test
                images, per path; accuracy equal to the numpy oracle's; on
                a multi path each image's "Detections" lines equal the
                host twins' (names and boxes; probabilities to the printed
                0.1%)
  6. server   — tpu_cnn_torch.apps.serve --mode ... behind HTTP on
                127.0.0.1, per path: 8 raw image POSTs, each answer equal
                to the host oracle's; on a multi path the "detections" too,
                one POST with ?thresh=0.3
  probe       — tpu_cnn_torch.apps.probe_bitcast --device cuda: exit 0,
                MATCH on the r*4+b layouts of Q1 and Q2 and on Q3
  bench       — python -m tpu_cnn_torch.bench in a child (within 240 s;
                the headline bench, bench.py's measurement: the gate, then
                52 async-pipelined rounds of lyr3-std at batch 1536 over 4
                staged pools, best of 3 passes, every timed round equal to
                a synchronous call): exit 0 and exactly one stdout line,
                bench.py's four keys, no error, value > 0, printed with the
                card; the gate on the card's production path with one
                feature bit flipped must fail on the features;
                graft_entry.entry() on cuda:0, its pred and bbox equal to
                CUDAEngine(mega).detect_batch on its 8 frames
  swap        — the engine swap, per family: make_engine(model, "cpu") is
                the host oracle on the native C++ build, its features
                bit-equal to the numpy oracle on the shipped images;
                make_engine(model, "auto", "cuda") resolves to mega; infer
                --mode cpu scores what --mode mega --device cuda scores;
                infer --image X --dump-features writes the oracle's features
  server      — serve --mode cpu (the host oracle) behind HTTP: the 8 raw
                POSTs of the lyr3-std/mega server phase, each answer equal
                to that server's, and a PNG POST through decode_image equal
                to the host oracle on realtime.preprocess of its pixels
  preprocess  — ops.preprocess.preprocess_frames on the card, B=37, at
                eight camera geometries (640x480 ... 1280x720) on BGR and
                RGB, BGRX/RGBX, packed uint32/int32 words, gray and valid_w
                on a wider pitch: bit-equal to the native and numpy twins
  realtime    — tpu_cnn_torch.apps.realtime --device cuda --source
                synthetic --frames 40 --no-serve on five paths (lyr3-std
                mega on the host-head protocol, mega --fused, mega --fused
                --multi --instances 2 --track, lyr4-wide pallas --fused,
                --mode cpu): "Done. 40 frames.", and detect_frame on the
                same 40 frames equal to the host oracle (CPURefEngine and
                the host twins: classes, boxes, detections and tracks equal,
                probabilities within 1e-4); then one run with the MJPEG
                server on a free port, /stream answering a JPEG part
  eval        — tpu_cnn_torch.apps.eval_detection at its default sizes on
                the card against the same flags' --mode cpu (the host
                oracle and twins): lyr3-std mega --box ref/centroid/reg,
                --multi, --multi --instances 2 --same-class, --multi
                --real; lyr4-wide mega single-box and pallas --multi. The
                metrics dicts equal (--box reg: mean IoU within 1e-3; a
                multi metric may differ only on an image whose score lies
                within 1e-4 of its floor, each printed)
  tracking    — apps.eval_tracking on lyr3-std mega, at its defaults and
                with --instances 2 --same-class: equal to --mode cpu
  dump        — apps.dump_features --mode mega on each family's shipped
                images: the npz bit-equal to the numpy oracle
  train_bbox  — apps.train_bbox --mode mega (K1's fused bins) against
                --mode cpu: weights within 1e-2, held-out IoU within 1e-3
  train       — the trainer (train.train_cnn) and the head-fitting tools:
                train parity, lyr3-std phase 1 (2 epochs, batch 64, one
                init_params draw, the first 256 real-photo train tiles)
                on the card in f32 against the CPU: epoch losses within
                1e-3 relative, parameters within 1e-4 (or at most 0.1% of
                them off, each by under 2 lr x updates), the TF32 flags as
                before; bf16 on the card finite and falling. The README's
                real-photo recipe through the CLIs into build/ from the
                JAX trainer's seed-0 initial draw (tests/data): train_cnn
                --bin-folder train_bins --val-bin-folder val_bins --augment
                (30 epochs), dump_features --mode mega, retrain_classifier
                --optimizer adam, infer --mode mega on val_bins: the
                retrained head at least 85% held out (the GAP head's
                accuracy printed beside it). retrain_classifier --optimizer
                ref on that dump, card against CPU: weights within 1e-4,
                accuracies equal. tune_shifts --mode mega against --mode
                cpu (27 candidates): the same best, each accuracy within
                one image. calibrate_multi --mode mega against --mode cpu
                (the three --mode cpu runs in child processes beside the
                mega ones), plain, --fit-head and --fit-head --real: floors
                equal, F1s and heads within 1e-3. apps.benchmark --train
                at float32 and bfloat16 (batch 1024): exit 0
  benchmark   — apps.benchmark on the card, each run exiting 0: lyr3-std
                --modes auto,mega,pallas,hybrid,xla,cpu at batch 1536 and
                mega,pallas,hybrid over 52 batches; --multi --instances 2;
                --per-layer --modes pallas and mega; --roofline;
                --latency; --camera-pipeline packed, BGR and at pitch 656;
                --features; lyr4-wide --modes mega and --roofline
  serve_native — tpu_cnn_torch.apps.serve_native --mode mega on each
                family (build_worker: make_engine, warmed at --max-batch
                16, then the C++ front): 24 concurrent raw POSTs over
                sockets, each answer equal to serve_native --mode cpu's
                (the host oracle and head; pred and bbox exact, probs
                within 1e-4); /healthz, 400 and 413 on malformed bodies,
                503 push-back on a full queue; lyr3-std also --multi
                --instances 2, its detections equal to the live engine's
  deploy      — tpu_cnn_torch.apps.export_model --backend mega --platforms
                cuda --batch 8,1536 on each family (lyr3-std with --multi
                --instances 2): every program calls tcnn::mega_cnn (and
                tcnn::conv_pool_layer on lyr4-wide) and no other op of the
                port; a child process that imports only the loader
                (tpu_cnn_torch.deploy; no models, engine or apps module)
                detects 1,573 staged images, equal to CUDAEngine(mega)
                (pred and bbox exact, probs within 1e-4); lyr3-std's
                detections() equal to the live engine's; serve
                --deployable behind HTTP, 8 POSTs equal to the engine
  serving     — scripts/bench_serving_torch.py on lyr3-std mega: the
                Python and the native front on one warm engine, ~4 s of
                closed-loop load at 4, 16 and 64 clients each: req/s,
                p50/p99, connection errors, 503 sheds (every answer 200)
  ingest      — apps.benchmark --host-ingest: 4 producers, 10,240 frames
                at 640x480 through the native frame ring: frames/s, drops
  doctor      — apps.doctor: exit 0, the runtime line names the card
  mesh        — parallel.MeshEngine(mega) on make_mesh() (the one card)
                and on two positions of cuda:0, per family (lyr3-std at
                batch 1536, lyr4-wide at 256): run_batch bit-equal to
                CUDAEngine(mega), detect_batch and detect_multi_batch at
                instances 1 and 2 under the gate, each of the family's
                kernels launched once per position per detect;
                MeshEngine(xla) on four positions with model axis 2 (the
                plain contract, the conv kernels split by output
                channel); infer and serve --mode mesh against the host
                oracle; dryrun_mesh on four positions (the meshed mega,
                multi and instance heads against one device, pipeline
                and spatial bit-equal to the contract); MultiHostEngine
                in two gloo processes on the card (local batches 37 and
                11, then 5 and 0), each rank's rows equal to the host
                oracle
  nvcc-free   — the lyr3-std deployable in a child with PATH, CUDA_HOME
                and CUDA_PATH cleared of the toolkit (and ops._build's
                nvcc lookup refusing) and the kernel cache moved aside:
                it installs the container's sm_90a library and detects
                equal to CUDAEngine(mega)
  train mesh  — the training mesh at lyr3-std full width (128x128,
                1->16->32->64), batch 256 real-photo tiles, from the JAX
                trainer's seed-0 draw, on positions of cuda:0: one step
                per layout (dp 2, dp x tp 2x2, ZeRO-1 on 4 with its
                moments in 4 blocks, pipe 3 at microbatch 32 with and
                without remat, pipe 2x3, space 4, space 2x4) held to the
                plain step on the card (train parity's tolerance), then
                3 more steps, the loss falling; train_cnn --mesh 1
                --zero1 --checkpoint DIR for 2 epochs, then --resume
                --epochs 3 ("(sharded) at epoch 2", steps 2 and 3 kept,
                a bundle), and infer --mode mega on that bundle; two gloo
                processes on cuda:0: one global step through
                global_batches (dp, then ZeRO-1 with the moments' blocks
                split across them) bit-equal across ranks and held to
                the plain step, a ShardedCheckpointer round trip, then
                train_cnn --num-processes 2 --epochs 1 (both exit 0, the
                primary alone exports); dryrun_train on 4 positions
  verify      — tpu_cnn_torch.apps.verify --device cuda for lyr3-std
                (shipped weights) and lyr4-wide (seeded weights): all seven
                backends bit-exact and every engine head, multi boxes,
                instances and presence scores included, equal to the host
                twins; exit 0 and the verdict line
  7. times    — at batch 1536, CUDA events, median: lyr3-std's megakernel
                and its plain version, and the megakernel on lyr3-std's
                first layer alone and on its first two (K1's split by
                layer, read by difference); lyr4-wide's layer kernel, tail and
                chain and their plain versions, each with its bound (the
                card's int8 tensor-core and HBM peaks) and its share of
                it; the conv kernel on each
                lyr3-std layer and lyr4-wide's L0, unpooled and pooled,
                each with its bound, and its plain version; a
                torch.profiler list of the device kernels of the lyr3-std
                pallas pass (the conv kernel per layer, no torch pool);
                the async-pipelined engine detect FPS of each family on
                mega and of lyr3-std on pallas and hybrid; on lyr3-std/mega
                the multi detect FPS at instances 1 and 2 beside the
                single-box FPS, and a torch.profiler split of the instance
                head; the bitcast kernel and its plain version (one
                PyTorch call each, so also its library time) at
                (4096, 4096), past the L2, device time per call with the
                calls queued; the CAM head on K1's bins and twin at each
                family's offline round (16,384 and 4,096 frames), device
                time per call with the calls queued, beside the plain head
                and its HBM bound (the twin and the bins read once);
                preprocess_frames at batch 256 on 640x480 BGR
                and packed frames, with its byte bound; the realtime loop's
                EMA FPS and median engine ms (lyr3-std mega, --fused and the
                host-head protocol) and its stages timed one by one; the
                deployable's detect (each family's mega container) against
                CUDAEngine.detect_batch at buckets 8 and 1536; the train
                step of each training layout against the plain step at
                batch 256 (host clock around synchronised steps, in turns);
                lyr3-std's async-pipelined FPS at batch 1536 of
                CUDAEngine(mega) against MeshEngine(mega) on one and two
                positions (in turns; the wrapper's overhead on one card),
                and a torch.profiler list of one 2-position mesh detect
                (mega_cnn_kernel twice, no im2col); one extra, untimed
                pass of the bench's loop under torch.profiler: the
                device's busy share of its host wall and its top three
                device operations. The
                conv kernel's per-layer times are device time per call with
                50 calls queued (the one-call window, printed beside them,
                also times the launch); the benchmark's --per-layer --modes pallas
                rows must lie within 20% of them. Last, the wall time

Phases 4-6, the probe, the bench, the swap, the host server, the preprocess, the
realtime runs, the eval, tracking, dump and train_bbox runs, the six
train paths, each benchmark run, the deployment paths (serve_native,
the deployable, the serving load, the host ingest), the doctor, the
mesh paths and the training mesh paths are the main paths, once per
path: every
kernel launch
counter is set to 0 before a path's phases and read after them, and each
kernel of that path must have launched there and no other kernel
(a single-box detect with the "ref" box on mega adds the CAM head to
what mega runs, wherever an engine's warm-up or detect runs one;
lyr3-std/mega: the megakernel; lyr4-wide/mega: the megakernel and the
layer kernel; lyr4-wide/pallas and lyr3-std/hybrid: the conv kernel; the
probe: the bitcast kernel; the multi paths: the megakernel, then the conv
kernel; the bench: the megakernel and the CAM head (the child's timed
path must launch both; its launches, counted in its own process, are
added to the kernels line); the swap: what mega runs on
the family; the host server, the
preprocess and realtime --mode cpu: none; the realtime paths: mega's or
pallas's; eval, tracking, dump and train_bbox: what their mode runs on
the family, --mode cpu none; the trainer, the train parity, retrain_classifier
and benchmark --train: none; the recipe, tune_shifts and calibrate_multi:
the megakernel; each benchmark run: what its modes run; serve_native and
the deployable: what mega runs on the family (in this process: the
deployable child's launches are its own, printed and checked apart); the
serving load: the megakernel; the host ingest and the doctor: none; the
mesh paths, infer/serve --mode mesh and the dry run: what mega runs on
the family; the nvcc-free deployable: the engine it is held to; the
multi-process engine: none
here, their children's launches checked apart; the training mesh paths,
the sharded CLI run, the multi-process training and dryrun_train: none;
infer on the sharded run's bundle: the megakernel). The line before the last
is a JSON object with each
kernel's launches (summed over the paths), error, times and bound (and
the conv kernel's pooled time and bound on lyr3-std) and its sanitizer
reports per tool (null where not measured); the last line is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import contextlib
import glob
import http.client
import importlib.util
import io
import json
import math
import os
import pickle
import shutil
import socket
import statistics
import subprocess
import sys
import threading
import time
import zipfile

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

from tpu_cnn_torch import bench, bench_gate, graft_entry  # noqa: E402
from tpu_cnn_torch.apps import (benchmark, calibrate_multi, doctor, dump_features,  # noqa: E402
                                eval_detection, eval_tracking, export_model, infer,
                                probe_bitcast, realtime, retrain_classifier, serve,
                                serve_native, train_bbox, tune_shifts, verify)
from tpu_cnn_torch.apps import kernel_cases as kc  # noqa: E402
from tpu_cnn_torch.apps.common import load_model  # noqa: E402
from tpu_cnn_torch.apps.kernel_cases import (ARTIFACTS, BINS_TOL, BITCAST_SHAPES,  # noqa: E402
                                             KERNEL_BATCH, MODULES, bundle_of, check,
                                             oracle_feats, shipped_images)
from tpu_cnn_torch.apps.serve import ServiceHTTPServer, make_handler  # noqa: E402
from tpu_cnn_torch.apps.serve_native import NativeFrontEnd  # noqa: E402
from tpu_cnn_torch.deploy import DeployedDetector  # noqa: E402
from tpu_cnn_torch.engine.cpu_ref import CPURefEngine  # noqa: E402
from tpu_cnn_torch.engine.cuda import (DEFAULT_MULTI_THRESH, CUDAEngine,  # noqa: E402
                                       MultiDetectResult)
from tpu_cnn_torch.head.cam import cam_bbox_fast, cam_bbox_multi, cam_instances  # noqa: E402
from tpu_cnn_torch.head.classify import classify_np, multi_scores_np, pool_for_head  # noqa: E402
from tpu_cnn_torch.head.tracker import Tracker  # noqa: E402
from tpu_cnn_torch.models.registry import get_config  # noqa: E402
from tpu_cnn_torch.native.preprocess import preprocess_frames_native  # noqa: E402
from tpu_cnn_torch.parallel.dryrun import dryrun_mesh, dryrun_train  # noqa: E402
from tpu_cnn_torch.parallel.mesh import MeshEngine, RowShards, make_mesh  # noqa: E402
from tpu_cnn_torch.parallel.pipeline import make_pipeline_mesh  # noqa: E402
from tpu_cnn_torch.parallel.spatial import make_spatial_mesh  # noqa: E402
from tpu_cnn_torch.ops import (_build, bitcast, cam_head, conv_pool, conv_stream,  # noqa: E402
                               detect_head, int8, maxpool, mega, quant, region_head,
                               region_layer, yolo_head)
from tpu_cnn_torch.ops import preprocess as dev_preprocess  # noqa: E402
from tpu_cnn_torch.ops.luma import pack_bgrx  # noqa: E402
from tpu_cnn_torch.train import train_cnn  # noqa: E402
from tpu_cnn_torch.train.data import BinFolderDataset, RealComposites, batches  # noqa: E402
from tpu_cnn_torch.utils import artifacts as art  # noqa: E402
from tpu_cnn_torch.utils.artifacts import label_from_filename  # noqa: E402
from tpu_cnn_torch.utils.profiling import StageTimer  # noqa: E402
from tpu_cnn_torch.utils.roofline import (bound, detect_out_bytes,  # noqa: E402
                                          layers_bound, macs_per_image)

KERNELS = {  # name -> (source, the TPU kernel(s) it replaces)
    "mega_cnn": ("tpu_cnn_torch/csrc/mega_cnn.cu",
                 "tpu_cnn/ops/pallas_poly.py:687"),  # cnn_forward_polyphase_pallas
    "conv_pool_layer": ("tpu_cnn_torch/csrc/conv_pool_layer.cu",
                        # conv_pool_layer_poly, conv_pool_layer_phase
                        "tpu_cnn/ops/pallas_poly.py:957,1160"),
    "conv_act": ("tpu_cnn_torch/csrc/conv_act.cu",
                 "tpu_cnn/ops/pallas_int8.py:150"),  # _conv_mxu
    "bitcast": ("tpu_cnn_torch/csrc/bitcast.cu",
                "scripts/probe_bitcast.py:35"),  # run (narrow, widen, roll)
    # none: the JAX head (tpu_cnn/ops/detect_head.py) is XLA ops
    "cam_head": ("tpu_cnn_torch/csrc/cam_head.cu", None),
    # none: the JAX package has no region-head detector
    "conv_stream": ("tpu_cnn_torch/csrc/conv_stream.cu", None),
    "region_head": ("tpu_cnn_torch/csrc/region_head.cu", None),
    "region_layer": ("tpu_cnn_torch/csrc/region_layer.cu", None),
    "yolo_head": ("tpu_cnn_torch/csrc/yolo_head.cu", None),
    "maxpool": ("tpu_cnn_torch/csrc/maxpool.cu", None),
}
# the main paths: (family, engine backend, the shifts set_shifts tries, the
# kernels the path must launch; it must launch no other)
PATHS = [("lyr3-std", "mega", (1, 3, 5), ("mega_cnn", "cam_head")),
         ("lyr4-wide", "mega", (2, 4, 6, 8), ("mega_cnn", "conv_pool_layer", "cam_head")),
         ("lyr4-wide", "pallas", (2, 4, 6, 8), ("conv_act",)),
         ("lyr3-std", "hybrid", (1, 3, 5), ("conv_act",))]
# the multi-object paths: (family, backend, instances, kernels; the
# server's warm-up runs a single-box detect too)
MULTI_PATHS = [("lyr3-std", "mega", 2, ("mega_cnn", "cam_head")),
               ("lyr4-wide", "pallas", 1, ("conv_act",))]
# the realtime app's paths: (family, flags, kernels); each runs
# realtime.main --device cuda --source synthetic for REALTIME_FRAMES frames
# (its engine's warm-up runs a single-box detect on every path)
REALTIME_PATHS = [
    ("lyr3-std", ("--mode", "mega"), ("mega_cnn", "cam_head")),  # the host-head protocol
    ("lyr3-std", ("--mode", "mega", "--fused"), ("mega_cnn", "cam_head")),
    ("lyr3-std", ("--mode", "mega", "--fused", "--multi", "--instances", "2",
                  "--track"), ("mega_cnn", "cam_head")),
    ("lyr4-wide", ("--mode", "pallas", "--fused"), ("conv_act",)),
    ("lyr3-std", ("--mode", "cpu"), ()),  # the host oracle: no kernel
]
REALTIME_FRAMES = 40
STREAM_FRAMES = 150  # the MJPEG run's: its client connects within a frame
REALTIME_TIMED_FRAMES = 200
# the kernels `--mode auto` (mega) runs per family, and with a single-box
# detect (the "ref" box) the CAM head's too
MEGA_KERNELS = {"lyr3-std": ("mega_cnn",),
                "lyr4-wide": ("mega_cnn", "conv_pool_layer")}
MEGA_DETECT_KERNELS = {v: (*k, "cam_head") for v, k in MEGA_KERNELS.items()}
# the device preprocess's camera geometries (W, H), the JAX function's
# phase-path and dense-path points among them
PREPROCESS_GEOMETRIES = ((640, 480), (320, 240), (177, 131), (127, 127),
                         (300, 200), (720, 560), (656, 480), (1280, 720))
PREPROCESS_BATCH = 256  # the timed batch
SCORE_TOL = 1e-4  # probabilities and presence scores: 1024-term f32 dots
VERDICT = "VERDICT: DESIGN IS BIT-ACCURATE across all backends"
BENCH_BATCH = bench.BATCH  # bench.py's batch


def phase(name: str, msg: str) -> None:
    print(f"[{name}] {msg}", flush=True)


def header() -> str:
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch finds no CUDA device")
    smi = bench.card()
    print(smi, flush=True)
    check(not torch.backends.cuda.matmul.allow_tf32,
          "TF32 matmul is on; the plain version and the head need f32")
    phase("1 header", f"torch {torch.__version__} CUDA {torch.version.cuda} "
                      f"device {torch.cuda.get_device_name(0)} "
                      f"count {torch.cuda.device_count()}")
    return smi.splitlines()[0]


def build() -> None:
    """One nvcc per source, all started together."""
    with concurrent.futures.ThreadPoolExecutor(len(KERNELS)) as pool:
        built = dict(zip(KERNELS, pool.map(_build.build, KERNELS)))
    for module in MODULES.values():  # load each library, bind its entry points
        module._lib()
    for name, (_lib, log, secs) in built.items():
        ptxas = " ".join(line.split("info    : ", 1)[-1]
                         for line in log.splitlines()
                         if "registers" in line or "stack frame" in line)
        phase("2 build", f"nvcc sm_90a {KERNELS[name][0]}: {secs:.2f} s; {ptxas}")


def kernel_vs_plain(dev: torch.device) -> dict[str, float]:
    mega_err, mega_cases = kc.mega_vs_plain(dev)
    phase("3 kernel", f"mega_cnn: {mega_cases} cases (B={KERNEL_BATCH}) "
                      f"bit-equal feats/twin, bins within {BINS_TOL}; "
                      f"max_abs_err={mega_err!r}")
    plans = kc.smem_plans_vs_kernel()
    phase("3 kernel", f"mega_cnn: ops/mega.py's mega_layout equal to the "
                      f"kernel's own shared-memory plan on {plans} geometries")
    layer_err, layer_cases = kc.layer_vs_plain(dev)
    phase("3 kernel", f"conv_pool_layer: {layer_cases} cases (B={KERNEL_BATCH}; "
                      f"weights packed per call and once) bit-equal; "
                      f"max_abs_err={layer_err!r}")
    act_err, act_cases = kc.act_vs_plain(dev)
    phase("3 kernel", f"conv_act: {act_cases} cases (B={KERNEL_BATCH}; the "
                      f"unpooled and, for an even map, the pooled entry, "
                      f"weights packed per call and once) bit-equal; "
                      f"max_abs_err={act_err!r}; pooled, bit-equal to "
                      f"conv_pool_layer on lyr4-wide's L0")
    edge_act_err, edge_act, edge_layer_err, edge_layer = kc.layer_edges(dev)
    phase("3 kernel", f"layer kernel edges (all-255 x +127/-128 and 0/255 x "
                      f"+127/-128 at shifts 0 and 31; ic 1/3/20/64 x oc "
                      f"5/13/35/128 at 7x12, 6x10 and 38x38; 64->128 at 32^2): "
                      f"conv_act {edge_act} and conv_pool_layer {edge_layer} "
                      f"cases bit-equal; max_abs_err={max(edge_act_err, edge_layer_err)!r}")
    gen_act_err, gen_act, gen_layer_err, gen_layer = kc.layer_generic_channels(dev)
    phase("3 kernel", f"layer kernel past 64 input channels (96->13 at 6x10, "
                      f"128->35 at 20x20; shifts 0 and 31): conv_act {gen_act} "
                      f"and conv_pool_layer {gen_layer} cases bit-equal; "
                      f"max_abs_err={max(gen_act_err, gen_layer_err)!r}")
    act_err = max(act_err, edge_act_err, gen_act_err)
    layer_err = max(layer_err, edge_layer_err, gen_layer_err)
    kc.chain_vs_oracle(dev)
    phase("3 kernel", "lyr4-wide chain on 4 shipped images: bit-equal to the "
                      "numpy oracle and the plain chain")
    bit_err, bit_cases = kc.bitcast_vs_plain(dev)
    phase("3 kernel", f"bitcast: {bit_cases} cases (narrow, widen, "
                      f"widen(narrow), roll 3/0/-1/L+2 at {BITCAST_SHAPES}; "
                      f"narrow and widen on offset views) bit-equal; "
                      f"max_abs_err={bit_err!r}")
    cam_err, cam_cases = kc.cam_head_vs_plain(dev, offline=True)
    phase("3 kernel", f"cam_head: {cam_cases} cases (both families' shipped "
                      f"frames and noise through K1 at batch 1, {KERNEL_BATCH} "
                      f"and the offline rounds {kc.CAM_BATCHES}; seeded twins "
                      f"at (C, P) {kc.CAM_GEOMETRIES}; an all-zero twin; a "
                      f"flat CAM): predictions and boxes equal to "
                      f"detect_with_pooled's, probabilities within "
                      f"{kc.CAM_PROBS_TOL} of the float64 head's; "
                      f"max_abs_err={cam_err!r}")
    rl_err, rl_cases, rs_err, rs_cases = kc.region_layers_vs_plain(dev)
    phase("3 kernel", f"yolov2-tiny-voc's layers: L0-L3 and the edges on region_layer "
                      f"({rl_cases} cases, B={kc.YOLO_BATCH}, channels-last out; and "
                      f"conv_act's bias instantiation once), L4-L8 and the edges on "
                      f"conv_stream ({rs_cases} cases, B={KERNEL_BATCH}, NCHW and "
                      f"channels-last maps) bit-equal to region_layer_reference")
    rh_err, rh_cases = kc.region_head_vs_plain(dev)
    phase("3 kernel", f"region_head: {rh_cases} cases (seeded sums of the last "
                      f"layer, few to thousands of candidates, and none): counts equal "
                      f"to region_detect_reference's, dets within 1e-5; "
                      f"max_abs_err={rh_err!r}")
    y3l_cases, y3s_cases = kc.yolo3_layers_vs_plain(dev)
    phase("3 kernel", f"YOLOv3's modes: region_layer unpooled (the recast, a 1x1 as its "
                      f"3x3, a residual) and stride 2 ({y3l_cases} cases), conv_stream "
                      f"stride 2, residual (staged by TMA: a partial M tile, a residual "
                      f"inside a wider map, oc 128), upsample, the input and the output "
                      f"inside wider maps and the linear 255 channels ({y3s_cases} cases, "
                      f"{len(kc.YOLO3_RESIDUAL_REFUSED)} of them residuals TMA cannot "
                      f"read, refused) bit-equal to graph_layer_reference; nothing "
                      f"written outside a route's channels")
    yh_err, yh_cases = kc.yolo_head_vs_plain(dev)
    phase("3 kernel", f"yolo_head: {yh_cases} cases (seeded sums of three heads, few to "
                      f"thousands of candidates, pages of keys, none): counts equal to "
                      f"yolo_detect_reference's, every pair matched within 1e-5 but near "
                      f"ties; max_abs_err={yh_err!r}")
    y7p, y7p_err, y7l, y7s, y7h_err, y7h = kc.yolo7_kernels_vs_plain(dev)
    phase("3 kernel", f"YOLOv7's modes: maxpool_kernel ({y7p} cases: 2x2/2 and the 5/9/13 "
                      f"cascade, slices in and out) bit-equal to maxpool_reference and "
                      f"F.max_pool2d; region_layer reading and writing slices at 160 and "
                      f"80 ({y7l} cases), conv_stream's YOLOv7 shapes ({y7s} cases: a "
                      f"slice written alone, K 2,048, the linear 255 at 80) bit-equal to "
                      f"graph_layer_reference, nothing written outside a slice; yolo_head's "
                      f"scaled decode ({y7h} cases at 25,200 boxes and 300 pairs, both head "
                      f"orders) matched within 1e-5 but near ties; max_abs_err: pools "
                      f"{y7p_err!r}, head {y7h_err!r}")
    return {"mega_cnn": mega_err, "conv_pool_layer": layer_err,
            "conv_act": act_err, "bitcast": bit_err, "cam_head": cam_err,
            "conv_stream": rs_err, "region_head": rh_err, "region_layer": rl_err,
            "yolo_head": max(yh_err, y7h_err), "maxpool": float(y7p_err)}


SANITIZE_TOOLS = ("memcheck", "racecheck", "synccheck", "initcheck")
SANITIZE_BUDGET_S = 180.0  # the phase's share of the script's time


YOLO_ENGINE_BATCH = 512  # the offline cell's round
YOLO_PLAIN_BLOCK = 64  # frames a plain call: its float64 maps fit the card


def yolo_engine_path(dev: torch.device) -> None:
    """yolov2-tiny-voc (seeded weights, ``kernel_cases.yolo_model``) through
    ``CUDAEngine(backend="pallas", box_mode="region")`` at the offline
    cell's batch of 512 seeded frames: every layer's output of the
    engine's launches (``region_maps``: L0-L3 on the region route's layer
    kernel, channels-last, L4-L8 on the streamed kernel) bit-equal to ``region_layer_reference`` on the
    previous one, in blocks of 64 frames of the same batch; then
    ``detect_device``'s detections against ``region_detect_reference`` on
    the last layer's sums at 512: counts equal, every pair matched within
    1e-5 where no near tie lets the two orders differ
    (``kernel_cases.region_dets_agree``)."""
    model = kc.yolo_model(3)
    b, block = YOLO_ENGINE_BATCH, YOLO_PLAIN_BLOCK
    frames = torch.from_numpy(np.random.RandomState(3).randint(
        0, 256, (b, 3, 416, 416)).astype(np.uint8)).to(dev)
    engine = CUDAEngine(model, dev, backend="pallas", box_mode="region")
    net, cfg = engine.net, model.config
    maps = engine.region_maps(frames)
    check(len(maps) == len(cfg.specs), f"{len(maps)} maps for {len(cfg.specs)} layers")
    check(all(m.is_contiguous(memory_format=torch.channels_last) for m in maps),
          "yolov2-tiny-voc: a map not channels-last")
    for i, (spec, got) in enumerate(zip(cfg.specs, maps)):
        x = frames if i == 0 else maps[i - 1]
        for lo in range(0, b, block):
            want = conv_stream.region_layer_reference(
                x[lo:lo + block], net.kernels[i], net.biases[i], net.shifts, i, spec[4],
                i == len(cfg.specs) - 1)
            check(torch.equal(got[lo:lo + block], want),
                  f"yolov2-tiny-voc L{i} ({engine._routes[i][0]}) at B={b}, frames "
                  f"{lo}-{lo + block}: {int((got[lo:lo + block] != want).sum())} of "
                  f"{want.numel()} differ")
        del want
    _, _, dets, count = engine.detect_device(frames)
    sums = maps[-1]
    del maps
    torch.cuda.empty_cache()
    want_dets, want_count = region_head.region_detect_reference(
        sums, net.shifts, len(cfg.specs) - 1, net.anchors, cfg.num_classes, cfg.thresh,
        cfg.nms, cfg.max_det)
    moved, tied, err = kc.region_dets_agree((dets, count), (want_dets, want_count), cfg.nms)
    counts = count.cpu()
    phase("main path", f"yolov2-tiny-voc/pallas: {engine.backend}, at B={b}: L0-L8 "
                       f"(routes {[r for r, _ in engine._routes]}) bit-equal to "
                       f"region_layer_reference in blocks of {block}; counts "
                       f"{int(counts.min())}-{int(counts.max())} (mean "
                       f"{float(counts.float().mean()):.1f}) equal to "
                       f"region_detect_reference's, every pair matched within "
                       f"{err!r} but {tied} let through by a near tie; {moved} frames "
                       f"in another order")


YOLO3_BLOCK = 16  # frames a reference call: its float64 maps fit the card


def yolo3_model():
    """YOLOv3-416 with the benchmark's seeded bundle (``benchmarks/bundles/
    yolov3.py`` at the configuration's seed and shifts): the weights the
    cell ``yolov3-416.offline`` runs."""
    from benchmarks.bundles import yolov3 as maker
    from benchmarks.lib import spec
    from tpu_cnn_torch.models.region import RegionModel

    config = spec.load_json(spec.config_path("yolov3-416"))
    kernels, biases, shifts, _ = maker.calibrate(config, int(config["bundle"]["seed"]),
                                                 config["shifts"])
    return RegionModel(kernels, biases, shifts, get_config("yolov3-416"))


def yolo3_engine_path(dev: torch.device) -> None:
    """YOLOv3-416 through ``CUDAEngine(backend="pallas", box_mode="yolo")``
    at the offline cell's batch of 512 seeded frames: every launch's map
    (``region_maps``: each of the 75 convs' outputs, the 23 shortcuts'
    sums their convs' epilogues add, the 2 upsampled maps; in route slices
    where the engine writes them) bit-equal to the plain reference's
    (``reference/yolov3.py``) in blocks of ``YOLO3_BLOCK`` frames of the
    same batch; then ``detect_device``'s detections against
    ``yolo_detect_reference`` on the engine's own sums: counts equal, every
    pair matched within 1e-5 but near ties (``kernel_cases.region_dets_agree``)."""
    from tpu_cnn_torch.reference import yolov3 as ref

    model = yolo3_model()
    cfg = model.config
    b = YOLO_ENGINE_BATCH
    frames = torch.from_numpy(np.random.RandomState(3).randint(
        0, 256, (b, 3, 416, 416)).astype(np.uint8)).to(dev)
    engine = CUDAEngine(model, dev, backend="pallas", box_mode="yolo")
    maps = engine.region_maps(frames)
    check(len(maps) == len(cfg.conv_rows), f"{len(maps)} maps for {len(cfg.conv_rows)} convs")
    kernels = [torch.from_numpy(k).to(dev) for k in model.kernels]
    biases = [torch.from_numpy(k).to(dev) for k in model.biases]
    shifts = [int(s) for s in model.shifts]
    for lo in range(0, b, YOLO3_BLOCK):
        keep = {}
        ref.forward(frames[lo:lo + YOLO3_BLOCK], kernels, biases, shifts, cfg.layer_configs,
                    keep=keep)
        for r, got in maps.items():
            want = keep[r]
            part = got[lo:lo + YOLO3_BLOCK].to(torch.float64)
            check(torch.equal(part, want),
                  f"yolov3-416 row {r} {cfg.layer_configs[r]} at B={b}, frames "
                  f"{lo}-{lo + YOLO3_BLOCK}: {int((part != want).sum())} of {want.numel()} "
                  f"differ")
        del keep
    layers = [cfg.conv_rows.index(r - 1) for r in cfg.heads]
    sums = [maps[r - 1] for r in cfg.heads]
    del maps
    torch.cuda.empty_cache()
    _, _, dets, count = engine.detect_device(frames)
    want = yolo_head.yolo_detect_reference(
        [t.cpu() for t in sums], model.shifts, layers, cfg.anchors, cfg.masks,
        cfg.num_classes, cfg.img_size, cfg.thresh, cfg.nms, cfg.max_det)
    moved, tied, err = kc.region_dets_agree((dets, count), tuple(w.to(dev) for w in want),
                                            cfg.nms)
    counts = count.cpu()
    phase("main path", f"yolov3-416/pallas: {engine.backend}, at B={b}: the 75 convs "
                       f"(routes {[s.route for s in engine._plan].count('layer')} layer, "
                       f"{[s.route for s in engine._plan].count('stream')} stream), the "
                       f"23 shortcuts and 2 upsamples in their epilogues, bit-equal to "
                       f"reference/yolov3.py in blocks of {YOLO3_BLOCK}; counts "
                       f"{int(counts.min())}-{int(counts.max())} equal to "
                       f"yolo_detect_reference's on the engine's sums, every pair matched "
                       f"within {err!r} but {tied} let through by a near tie; {moved} frames "
                       f"in another order")


YOLO7_BATCH = 256  # the offline cell's round
YOLO7_BLOCK = 8  # frames a reference call at 640: its float64 maps fit the card


def yolo7_model():
    """YOLOv7-640 with the benchmark's seeded bundle (``benchmarks/bundles/
    yolov7.py`` at the configuration's seed and shifts): the weights the
    cell ``yolov7-640.offline`` runs."""
    from benchmarks.bundles import yolov7 as maker
    from benchmarks.lib import spec
    from tpu_cnn_torch.models.region import RegionModel

    config = spec.load_json(spec.config_path("yolov7-640"))
    kernels, biases, shifts, _ = maker.calibrate(config, int(config["bundle"]["seed"]),
                                                 config["shifts"])
    return RegionModel(kernels, biases, shifts, get_config("yolov7-640"))


def yolo7_engine_path(dev: torch.device, batch: int = YOLO7_BATCH) -> None:
    """YOLOv7-640 through ``CUDAEngine(backend="pallas", box_mode="yolo")``
    at the offline cell's batch of 256 seeded frames: every launch's map
    (``region_maps``: each of the 92 convs' outputs, the 2 upsampled maps,
    the 8 pools'; in a concatenation's slice where the engine writes them)
    bit-equal to the plain reference's (``reference/yolov7.py``) in blocks
    of ``YOLO7_BLOCK`` frames of the same batch, every concatenation's
    every channel written; then ``detect_device``'s detections (the scaled
    decode) against ``yolo_detect_reference`` on the engine's own sums:
    counts equal, every pair matched within 1e-5 but near ties
    (``kernel_cases.region_dets_agree``); and the counters: 8 pools and
    27 graph rows a frame."""
    from tpu_cnn_torch.reference import yolov7 as ref
    from tpu_cnn_torch.utils import profiling

    model = yolo7_model()
    cfg = model.config
    b = batch
    frames = torch.from_numpy(np.random.RandomState(3).randint(
        0, 256, (b, 3, 640, 640)).astype(np.uint8)).to(dev)
    engine = CUDAEngine(model, dev, backend="pallas", box_mode="yolo")
    routes = [s.route for s in engine._plan]
    check(routes.count("layer") + routes.count("stream") == 92 and routes.count("pool") == 6,
          f"routes {routes}")
    maps = engine.region_maps(frames)
    check(len(maps) == len(cfg.conv_rows) + len(cfg.pools),
          f"{len(maps)} maps for {len(cfg.conv_rows)} convs and {len(cfg.pools)} pools")
    kernels = [torch.from_numpy(k).to(dev) for k in model.kernels]
    biases = [torch.from_numpy(k).to(dev) for k in model.biases]
    shifts = [int(s) for s in model.shifts]
    for lo in range(0, b, YOLO7_BLOCK):
        keep = {}
        ref.forward(frames[lo:lo + YOLO7_BLOCK], kernels, biases, shifts, cfg.layer_configs,
                    keep=keep)
        for r, got in maps.items():
            want = keep[r]
            part = got[lo:lo + YOLO7_BLOCK].to(torch.float64)
            check(torch.equal(part, want),
                  f"yolov7-640 row {r} {cfg.layer_configs[r]} at B={b}, frames "
                  f"{lo}-{lo + YOLO7_BLOCK}: {int((part != want).sum())} of {want.numel()} "
                  f"differ")
        del keep
    layers = [cfg.conv_rows.index(r - 1) for r in cfg.heads]
    sums = [maps[r - 1] for r in cfg.heads]
    del maps
    torch.cuda.empty_cache()
    profiling.reset_spans()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        _, _, dets, count = engine.detect_device(frames)
    _, counters = profiling.spans()
    check(counters.get("net.pool.maps") == 8 * b and counters.get("net.graph.ops") == 27 * b,
          f"counters {counters}")
    want = yolo_head.yolo_detect_reference(
        [t.cpu() for t in sums], model.shifts, layers, cfg.anchors, cfg.masks,
        cfg.num_classes, cfg.img_size, cfg.thresh, cfg.nms, cfg.max_det, cfg.decode)
    moved, tied, err = kc.region_dets_agree((dets, count), tuple(w.to(dev) for w in want),
                                            cfg.nms)
    counts = count.cpu()
    phase("main path", f"yolov7-640/pallas: {engine.backend}, at B={b}: the 92 convs "
                       f"(routes {routes.count('layer')} layer, {routes.count('stream')} "
                       f"stream), the 8 pools in {routes.count('pool')} maxpool_kernel "
                       f"launches, 17 concatenations written in place and 2 upsamples in "
                       f"their epilogues, bit-equal to reference/yolov7.py in blocks of "
                       f"{YOLO7_BLOCK}; counts {int(counts.min())}-{int(counts.max())} "
                       f"equal to yolo_detect_reference's (scaled) on the engine's sums, "
                       f"every pair matched within {err!r} but {tied} let through by a near "
                       f"tie; {moved} frames in another order; net.pool.maps 8 a frame")


def yolo_times(dev: torch.device, card: str, rs) -> dict[str, tuple]:
    """At the offline cell's batch (512 frames): the region route's layer
    kernel on yolov2-tiny-voc's L0-L3 summed and each layer's queued device
    time, each beside its bound (bytes for L0-L1, MACs for L2-L3) and its
    plain version's time; the streamed kernel on L4-L8 summed
    (channels-last maps, as the engine hands them over), its plain version,
    their bound, and ``torch._int_mm`` on the same im2col GEMMs (s8 x s8;
    no PyTorch call takes u8 x s8 with the shift, clip and pool); each
    streamed layer's queued device time beside its bound by MACs; the
    region head on its sums, its plain version and its bound (its
    bytes); the [yolo] head (``yolo_head_times``)."""
    batch, plain_b = 512, 16
    model = kc.yolo_model(5)
    net = CUDAEngine(model, dev, backend="pallas", box_mode="region").net
    specs = model.config.specs
    first = 4
    lxs, largs, lbounds = [], [], []
    for i in range(first):
        ic, oc, s, k, pool = specs[i]
        x = torch.randint(0, 256, (batch, ic, s, s), dtype=torch.uint8, device=dev)
        lxs.append(x if i == 0 else x.contiguous(memory_format=torch.channels_last))
        largs.append((i, region_layer.pack_layer(net.kernels[i])))
        lbounds.append(bound(s * s * oc * ic * 9 * batch,
                             batch * (ic * s * s + oc * (s // 2) ** 2) + oc * ic * 9))

    def layer_kernel(j):
        (i, packed), x = largs[j], lxs[j]
        return lambda: region_layer.region_layer(x, net.kernels[i], net.biases[i],
                                                 net.shifts, i, packed=packed)

    def layer_plain(j):
        i, x = largs[j][0], lxs[j]
        return lambda: conv_stream.region_layer_reference(
            x[:plain_b], net.kernels[i], net.biases[i], net.shifts, i, 2, False)

    lk_ms, lp_ms, nk, np_ = _kernel_and_plain_ms(
        lambda: [layer_kernel(j)() for j in range(first)],
        lambda: [layer_plain(j)() for j in range(first)], 5, 2)
    lp_ms *= batch / plain_b  # the plain version on 16 frames: its f64 im2col at 512 passes 80 GB
    lb_ms = sum(b for b, _ in lbounds)
    phase("7 times", f"yolov2-tiny-voc L0-L3 at batch {batch} on {card}: region_layer "
                     f"median {lk_ms!r} ms (n={nk}); bound {lb_ms!r} ms (bytes for L0-L1, "
                     f"MACs for L2-L3), {lb_ms / lk_ms:.2%} of it; plain {lp_ms!r} ms "
                     f"({plain_b} frames, scaled; n={np_})")
    out = {"region_layer": (lk_ms, lp_ms, lb_ms, "bytes (L0-L1), MACs (L2-L3)", None)}
    layers = {}
    for j in range(first):
        ms = _queued_ms(layer_kernel(j), 20)
        p_ms = statistics.median(_event_ms(layer_plain(j), 3)) * batch / plain_b
        layers[f"L{j}"] = (ms, lbounds[j][0], lbounds[j][1], p_ms)
    phase("7 times", f"yolov2-tiny-voc per layer at batch {batch} on {card}, region_layer "
                     f"queued ms (bound, by, share; plain ms): " + ", ".join(
                         f"{name} {ms!r} ({b!r}, {by}, {b / ms:.1%}; {p!r})"
                         for name, (ms, b, by, p) in layers.items()))
    out["region_layer_layers"] = layers
    del lxs
    torch.cuda.empty_cache()
    xs, args = [], []
    for i in range(first, len(specs)):
        ic, oc, s, k, pool = specs[i]
        x = torch.randint(0, 256, (batch, ic, s, s), dtype=torch.uint8, device=dev)
        xs.append(x.contiguous(memory_format=torch.channels_last))
        args.append((i, pool, i == len(specs) - 1, conv_stream.pack_stream(net.kernels[i])))

    def kernels():
        for x, (i, pool, last, packed) in zip(xs, args):
            conv_stream.conv_stream(x, net.kernels[i], net.biases[i], net.shifts, i,
                                    pool=pool, last=last, packed=packed)

    def plain():
        for x, (i, pool, last, _) in zip(xs, args):
            conv_stream.region_layer_reference(x[:64], net.kernels[i], net.biases[i],
                                               net.shifts, i, pool, last)

    k_ms, p_ms, nk, np_ = _kernel_and_plain_ms(kernels, plain, 5, 2)
    p_ms *= batch / 64  # the plain version on 64 frames: its f64 maps at 512 pass 80 GB
    macs = sum(s * s * oc * ic * k * k for ic, oc, s, k, _ in specs[first:]) * batch
    nbytes = sum(batch * (ic * s * s + oc * (s // 2 if p == 2 else s) ** 2
                          * (4 if i == len(specs) - 1 else 1)) + oc * ic * k * k
                 for i, (ic, oc, s, k, p) in enumerate(specs) if i >= first)
    b_ms, b_by = bound(macs, nbytes)
    gemms = [(torch.randint(-128, 128, (batch * s * s, ic * k * k), dtype=torch.int8,
                            device=dev),
              torch.randint(-128, 128, (ic * k * k, -(-oc // 8) * 8), dtype=torch.int8,
                            device=dev)) for ic, oc, s, k, _ in specs[first:]]
    lib_ms = statistics.median(_event_ms(lambda: [torch._int_mm(a, b) for a, b in gemms], 5))
    phase("7 times", f"yolov2-tiny-voc L4-L8 at batch {batch} on {card}: conv_stream "
                     f"median {k_ms!r} ms (n={nk}); bound {b_ms!r} ms by {b_by}, "
                     f"{b_ms / k_ms:.2%} of it; plain {p_ms!r} ms (64 frames, scaled; "
                     f"n={np_}); torch._int_mm on the im2col GEMMs {lib_ms!r} ms")
    out["conv_stream"] = (k_ms, p_ms, b_ms, b_by, lib_ms)
    layers = {}
    for x, (i, pool, last, packed) in zip(xs, args):
        ic, oc, s, k, _ = specs[i]
        ms = _queued_ms(lambda x=x, i=i, pool=pool, last=last, packed=packed:
                        conv_stream.conv_stream(x, net.kernels[i], net.biases[i], net.shifts,
                                                i, pool=pool, last=last, packed=packed), 20)
        layers[f"L{i}"] = (ms, bound(s * s * oc * ic * k * k * batch, 0)[0])
    phase("7 times", f"yolov2-tiny-voc per layer at batch {batch} on {card}, conv_stream "
                     f"queued ms (bound by MACs, share): " + ", ".join(
                         f"{name} {ms!r} ({b!r}, {b / ms:.1%})"
                         for name, (ms, b) in layers.items()))
    out["conv_stream_layers"] = layers
    del xs, gemms
    torch.cuda.empty_cache()
    t = torch.randint(-2**15, 2**15, (batch, 13, 13, 125), dtype=torch.int32, device=dev)
    t[..., 4::25] -= 4 * 2**15  # objectness low: about 300 candidates a frame
    t = t.permute(0, 3, 1, 2)
    shifts = torch.tensor([15], dtype=torch.int32, device=dev)
    cfg = model.config
    head = (shifts, 0, net.anchors, cfg.num_classes, cfg.thresh, cfg.nms, cfg.max_det)
    h_ms, hp_ms, nh, nhp = _kernel_and_plain_ms(
        lambda: region_head.region_detect(t, *head),
        lambda: region_head.region_detect_reference(t, *head), 10, 2)
    hb_ms, hb_by = bound(0, batch * (13 * 13 * 125 * 4 + cfg.max_det * 6 * 4 + 4))
    phase("7 times", f"region_head at batch {batch} on {card}: kernel median {h_ms!r} ms "
                     f"(n={nh}); bound {hb_ms!r} ms by {hb_by}, {hb_ms / h_ms:.2%} of it; "
                     f"plain {hp_ms!r} ms (n={nhp})")
    out["region_head"] = (h_ms, hp_ms, hb_ms, hb_by, None)
    del t
    torch.cuda.empty_cache()
    out["yolo_head"] = yolo_head_times(dev, card, batch)
    out["maxpool"] = maxpool_times(dev, card)
    return out


# YOLOv7-640's pools: (channels, side, sizes, stride) of the five MP
# branches' 2x2/2 and SPPCSPC's cascade
YOLO7_POOLS = ((256, 160, (2,), 2), (512, 80, (2,), 2), (1024, 40, (2,), 2),
               (128, 80, (2,), 2), (256, 40, (2,), 2), (512, 20, (5, 9, 13), 1))


def maxpool_times(dev: torch.device, card: str) -> tuple:
    """The pooling kernel on YOLOv7-640's pools at the offline cell's batch
    (256, seeded channels-last maps): the six launches' summed median
    CUDA-event times, their plain version's (``maxpool_reference`` on the
    CPU, 8 frames, scaled), their bound by the bytes they must move (each
    map read once, every pool's map written) and the library's
    (``F.max_pool2d``, a call a pool size, on the same channels-last maps
    held in float16, which holds every u8 exactly: torch's CUDA max-pool
    takes no u8 map; the cast is not timed)."""
    import torch.nn.functional as F

    batch, plain_b = YOLO7_BATCH, 8
    maps = [torch.randint(0, 256, (batch, s, s, c), dtype=torch.uint8, device=dev)
            .permute(0, 3, 1, 2) for c, s, _, _ in YOLO7_POOLS]
    k_ms = p_ms = lib_ms = nbytes = 0.0
    for x, (c, s, sizes, stride) in zip(maps, YOLO7_POOLS):
        maxpool.maxpool(x, sizes, stride)  # warm-up
        k_ms += statistics.median(_event_ms(lambda: maxpool.maxpool(x, sizes, stride), 10))

        def library(x=x.half(), sizes=sizes, stride=stride):
            return [F.max_pool2d(x, k, stride, (k - 1) // 2) for k in sizes]

        library()  # warm-up
        lib_ms += statistics.median(_event_ms(library, 10))
        part = x[:plain_b].cpu().contiguous()
        t0 = time.perf_counter()
        maxpool.maxpool_reference(part, sizes, stride)
        p_ms += (time.perf_counter() - t0) * 1e3 * batch / plain_b
        nbytes += batch * c * s * s * (1 + len(sizes) / stride ** 2)
    b_ms, b_by = bound(0, nbytes)
    phase("7 times", f"maxpool_kernel at batch {batch} on {card} (YOLOv7-640's five 2x2/2 "
                     f"pools and SPPCSPC's cascade): kernels {k_ms!r} ms; bound {b_ms!r} ms "
                     f"by {b_by}, {b_ms / k_ms:.2%} of it; plain {p_ms!r} ms ({plain_b} "
                     f"frames, scaled); F.max_pool2d on the maps in float16 {lib_ms!r} "
                     f"ms")
    return (k_ms, p_ms, b_ms, b_by, lib_ms)


YOLO3_HEAD_SHIFT = 12  # the sums are t x 2**12


def yolo3_head_sums(dev: torch.device, batch: int, candidates: float = 1000.0,
                    pairs: float = 3.0, seed: int = 416) -> list[torch.Tensor]:
    """Three heads' int32 sums like the cell ``yolov3-416.offline``'s (13,
    26 and 52, 80 classes; channels-last, as the streamed kernel leaves
    them): t = sum / 2**12 standard normal, every objectness lowered so that
    about ``candidates`` boxes a frame pass the threshold, every class logit
    by the offset (bisected on the first 16 frames) that leaves about
    ``pairs`` pairs above it a candidate."""
    grids, classes, thresh = (13, 26, 52), 80, 0.005
    boxes = sum(3 * g * g for g in grids)
    logit = math.log(thresh / (1 - thresh))
    obj_off = logit - statistics.NormalDist().inv_cdf(1 - candidates / boxes)
    gen = torch.Generator(device=dev).manual_seed(seed)
    ts = [torch.randn((batch, g, g, 3, 5 + classes), generator=gen, device=dev)
          for g in grids]
    for t in ts:
        t[..., 4] += obj_off
    obj = torch.cat([torch.sigmoid(t[:16, ..., 4]).reshape(16, -1) for t in ts], 1)
    cls = torch.cat([t[:16, ..., 5:].reshape(16, -1, classes) for t in ts], 1)
    live = obj > thresh
    lo, hi = -20.0, 20.0
    for _ in range(40):
        mid = (lo + hi) / 2
        scores = obj[..., None] * torch.sigmoid(cls + mid)
        got = float(((scores > thresh) & live[..., None]).sum()) / max(int(live.sum()), 1)
        lo, hi = (lo, mid) if got > pairs else (mid, hi)
    for t in ts:
        t[..., 5:] += (lo + hi) / 2
    return [torch.round(t * 2.0 ** YOLO3_HEAD_SHIFT).to(torch.int32)
            .reshape(batch, g, g, -1).permute(0, 3, 1, 2) for t, g in zip(ts, grids)]


def yolo_head_times(dev: torch.device, card: str, batch: int) -> tuple:
    """The [yolo] head kernel at the offline cell's batch on
    ``yolo3_head_sums``: its median CUDA-event time, its plain version's
    (``yolo_detect_reference`` on the CPU, on 8 frames, scaled; its NMS is a
    loop a pair) and its bound by the bytes it must move
    (``benchmarks/lib/yolo3_counts.head_bound_ms``'s count: a sector of
    each box's objectness, the rest of each candidate's row, the answers)."""
    from tpu_cnn_torch.models.region import COCO_ANCHORS, COCO_MASKS

    sums = yolo3_head_sums(dev, batch)
    shifts = torch.tensor([YOLO3_HEAD_SHIFT] * 3, dtype=torch.int32, device=dev)
    args = ([0, 1, 2], COCO_ANCHORS, COCO_MASKS, 80, 416, 0.005, 0.45, 100)
    plain_b = 8
    part = [t[:plain_b].cpu() for t in sums]
    logit = math.log(0.005 / 0.995)
    cands = sum(int((t[:, 4::85].double() / 2 ** YOLO3_HEAD_SHIFT > logit).sum())
                for t in sums) / batch
    yolo_head.yolo_detect(sums, shifts, *args)  # warm-up
    torch.cuda.synchronize()
    p_ms = []
    for _ in range(2):
        t0 = time.perf_counter()
        yolo_head.yolo_detect_reference(part, shifts.cpu(), *args)
        p_ms.append((time.perf_counter() - t0) * 1e3 * batch / plain_b)
    k_ms = _event_ms(lambda: yolo_head.yolo_detect(sums, shifts, *args), 10)
    k_ms += _event_ms(lambda: yolo_head.yolo_detect(sums, shifts, *args), 10)
    h_ms, hp_ms = statistics.median(k_ms), statistics.median(p_ms)
    row = 4 * 85
    nbytes = batch * (sum(3 * t.shape[2] ** 2 for t in sums) * 32
                      + cands * (-(-row // 32) - 1) * 32 + 4 * (6 * 100 + 1))
    b_ms, b_by = bound(0, nbytes)
    phase("7 times", f"yolo_head at batch {batch} on {card} (13/26/52, 80 classes, "
                     f"{cands:.1f} candidates a frame): kernel median {h_ms!r} ms "
                     f"(n={len(k_ms)}); bound {b_ms!r} ms by {b_by}, {b_ms / h_ms:.2%} of "
                     f"it; plain {hp_ms!r} ms ({plain_b} frames, scaled; n={len(p_ms)})")
    return (h_ms, hp_ms, b_ms, b_by, None)


def sanitize_phase() -> dict[str, dict]:
    """The sanitizer lane's four card tools (``apps.sanitize``) in one
    child, within ``SANITIZE_BUDGET_S``: a probe kernel under each tool,
    the kernels rebuilt with -lineinfo, phase 3's cases under each tool,
    the memcheck canary. A tool that ran must pass (every kernel launched,
    every required path taken, 0 reports, the canary caught); one that
    compute-sanitizer refused on this card before anything ran (its own
    "Device not supported", the probe's kernel not run) is printed as not
    measured. Returns each kernel's {tool: reports}, None where not
    measured."""
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "tpu_cnn_torch.apps.sanitize",
                           *SANITIZE_TOOLS, "--json", "--timeout", str(SANITIZE_BUDGET_S)],
                          cwd=ROOT, capture_output=True, text=True,
                          timeout=SANITIZE_BUDGET_S + 120)
    results = {}
    for line in proc.stdout.splitlines():
        if line.startswith('{"sanitize"'):
            r = json.loads(line)["sanitize"]
            results[r["tool"]] = r
        elif line.startswith("[sanitize] built"):
            phase("sanitize", line.split("] ", 1)[1])
    check(set(results) == set(SANITIZE_TOOLS),
          f"the sanitizer lane reported {sorted(results)} (exit {proc.returncode}):"
          f"\n{proc.stdout[-4000:]}{proc.stderr[-4000:]}")
    out = {name: {} for name in KERNELS}
    for tool, r in results.items():
        if r["refused"]:
            phase("sanitize", f"{tool}: NOT MEASURED: {r['detail']} "
                              f"({r['seconds']:.1f} s)")
            for name in KERNELS:
                out[name][tool] = None
            continue
        check(r["ok"], f"sanitizer lane, {tool}: {r['detail']}\n{proc.stderr[-8000:]}")
        canary = "" if r["canary"] is None else ", the canary caught"
        phase("sanitize", f"{tool}: launches {r['launches']}; "
                          f"{len(r['paths'])} paths taken, the "
                          f"{len(kc.REQUIRED_PATHS)} required among them; "
                          f"{r['reports']} reports{canary}; {r['seconds']:.1f} s")
        for name in KERNELS:
            out[name][tool] = r["reports"]
    secs = time.perf_counter() - t0
    phase("sanitize", f"{len(SANITIZE_TOOLS)} tools in {secs:.1f} s "
                      f"(budget {SANITIZE_BUDGET_S:.0f} s)")
    check(secs <= SANITIZE_BUDGET_S,
          f"the sanitize phase took {secs:.1f} s, past its {SANITIZE_BUDGET_S:.0f} s")
    return out


def engine_gate(variant: str, backend: str,
                alt_shifts: tuple[int, ...]) -> None:
    art_dir = ARTIFACTS[variant]
    bundle = bundle_of(variant)
    model = load_model(art_dir, variant)
    shifts, size = tuple(int(s) for s in model.shifts), model.config.img_size
    engine = CUDAEngine(model, device="cuda", backend=backend)
    before = sum(m.launches for m in MODULES.values())
    gate = bench_gate.load_gate_images(art_dir, img_size=size)
    err = bench_gate.run_parity_gate(engine.detect_with_features, bundle, gate,
                                     shifts=shifts, img_size=size)
    check(err is None, f"{variant} engine parity gate: {err}")
    res = engine.detect_batch(gate)  # the detect path proper: no u8 store
    _, _, pred, _, _, bbox = engine.detect_with_features(gate)
    check(np.array_equal(res.pred, pred) and np.array_equal(res.bbox, bbox),
          f"{variant}: detect_batch disagrees with the gated path")
    engine.set_shifts(*alt_shifts)
    feats = engine.run_batch(gate[:4])
    want = oracle_feats(gate[:4], bundle.kernels, alt_shifts)
    check(np.array_equal(feats, want), f"{variant}: set_shifts{alt_shifts} "
                                       f"features differ")
    engine.set_shifts(*shifts)
    launches = sum(m.launches for m in MODULES.values()) - before
    check(launches > 0, f"{variant}: the engine launched no kernel")
    phase("4 engine", f"{variant} ({engine.backend}, shifts {shifts}): parity "
                      f"gate passed on {len(gate)} images; set_shifts"
                      f"{alt_shifts} checked; kernel launches={launches}")


def cli(variant: str, mode: str) -> None:
    art_dir = ARTIFACTS[variant]
    paths = shipped_images(variant)
    bundle = bundle_of(variant)
    shifts = load_model(art_dir, variant).shifts
    feats = oracle_feats([np.fromfile(p, np.uint8) for p in paths],
                         bundle.kernels, shifts)
    pred = classify_np(feats, bundle.fc_weight, bundle.fc_bias)[0]
    want = sum(int(p == label_from_filename(f)) for p, f in zip(pred, paths))
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        infer.main(["--variant", variant, "--image-dir", art_dir,
                    "--device", "cuda", "--mode", mode, "--no-save"])
    line = next(ln.strip() for ln in out.getvalue().splitlines()
                if "Accuracy:" in ln)
    check(line.startswith(f"Accuracy: {want}/{len(paths)} "),
          f"{variant} --mode {mode} CLI '{line}' != the oracle's "
          f"{want}/{len(paths)}")
    phase("5 cli", f"tpu_cnn_torch.apps.infer --variant {variant} --mode "
                   f"{mode}: {line} (numpy oracle: {want}/{len(paths)})")


@contextlib.contextmanager
def http_service(batcher, backend):
    """The batcher behind HTTP on an ephemeral loopback port; yields
    request(method, path, body) -> (status, JSON). Stops both after."""
    srv = ServiceHTTPServer(("127.0.0.1", 0), make_handler(batcher, backend))
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    port = srv.server_address[1]

    def request(method, path, body=None):
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
        try:
            conn.request(method, path, body=body)
            resp = conn.getresponse()
            return resp.status, json.loads(resp.read())
        finally:
            conn.close()

    try:
        yield request
    finally:
        srv.shutdown()
        srv.server_close()
        batcher.stop()
        th.join(timeout=10)


_SERVED: dict[tuple[str, str], list] = {}  # (family, mode) -> answers


def server(variant: str, mode: str) -> None:
    bundle = bundle_of(variant)
    model = load_model(ARTIFACTS[variant], variant)
    size = model.config.img_size
    paths = shipped_images(variant)[:8]
    batcher, backend = serve.build_service(ARTIFACTS[variant], device="cuda",
                                           max_batch=8, variant=variant,
                                           mode=mode)
    with http_service(batcher, backend) as request:
        bodies = [open(p, "rb").read() for p in paths]
        check(all(len(b) == size * size for b in bodies),
              f"{variant}: test images are not {size}x{size}")
        feats = oracle_feats([np.frombuffer(b, np.uint8) for b in bodies],
                             bundle.kernels, model.shifts)
        with concurrent.futures.ThreadPoolExecutor(8) as pool:
            answers = list(pool.map(lambda b: request("POST", "/detect", b), bodies))
        for p, f, (status, ans) in zip(paths, feats, answers):
            idx = int(classify_np(f[None], bundle.fc_weight, bundle.fc_bias)[0][0])
            box = list(cam_bbox_fast(f, idx, bundle.fc_weight, img_size=size))
            check(status == 200 and ans["pred"] == idx and ans["bbox"] == box,
                  f"{variant} {os.path.basename(p)}: server {status} {ans} != "
                  f"oracle pred {idx} bbox {box}")
        status, health = request("GET", "/healthz")
        check(status == 200 and health.get("ok") is True, f"/healthz: {health}")
        stats = batcher.snapshot()
    _SERVED[(variant, mode)] = answers
    phase("6 server", f"{variant} ({backend}): {len(paths)} POST /detect of "
                      f"{size * size} "
                      f"bytes equal to the host oracle; /healthz {health}; "
                      f"batches={stats['batches']} requests={stats['requests']}")


# ── the multi-object paths ───────────────────────────────────────────


def host_multi(feats: np.ndarray, model, instances: int) -> MultiDetectResult:
    """The host twins' multi-object result for (N, C, P) u8 features: the
    numpy classifier and presence head, cam_bbox_multi, cam_instances."""
    fcw, size = model.fc_weight, model.config.img_size
    pred, conf, probs = classify_np(feats, fcw, model.fc_bias)
    scores = (multi_scores_np(pool_for_head(feats, fcw), *model.multi_head)
              if model.multi_head is not None else None)
    boxes = np.stack([cam_bbox_multi(f, fcw, img_size=size) for f in feats])
    inst = (None, None)
    if instances > 1:
        got = [cam_instances(f, fcw, img_size=size, max_instances=instances)
               for f in feats]
        inst = (np.stack([g[0] for g in got]), np.stack([g[1] for g in got]))
    return MultiDetectResult(pred.astype(np.int32), conf, probs, boxes, *inst,
                             scores=scores)


def same_detections(got, want, tol: float) -> bool:
    """Two lists of (class, prob, box): classes and boxes equal, probs
    within ``tol``."""
    return len(got) == len(want) and all(
        gk == wk and tuple(gb) == tuple(wb) and abs(gp - wp) <= tol
        for (gk, gp, gb), (wk, wp, wb) in zip(got, want))


def multi_thresh_of(model):
    return (model.multi_thresh if model.multi_thresh is not None
            else DEFAULT_MULTI_THRESH)


def multi_engine(variant: str, backend: str, instances: int) -> None:
    art_dir = ARTIFACTS[variant]
    model = load_model(art_dir, variant)
    check(model.multi_head is not None, f"{variant}: no shipped multi_head.npz")
    engine = CUDAEngine(model, device="cuda", backend=backend)
    gate = bench_gate.load_gate_images(art_dir, img_size=model.config.img_size)
    want = host_multi(oracle_feats(gate, model.kernels, model.shifts), model,
                      instances)
    thr = multi_thresh_of(model)
    runs = {"direct": engine.detect_multi_batch(gate, instances=instances),
            "staged": engine.detect_multi_resolve(engine.detect_multi_batch_async(
                engine.stage_batch(gate), instances=instances))}
    for how, res in runs.items():
        tag = f"{variant}/{backend} --instances {instances} {how}"
        check(np.array_equal(res.pred, want.pred), f"{tag}: predictions")
        check(np.allclose(res.probs, want.probs, rtol=0, atol=SCORE_TOL),
              f"{tag}: probabilities")
        check(res.boxes.dtype == np.int32 and np.array_equal(res.boxes, want.boxes),
              f"{tag}: per-class boxes")
        check(np.allclose(res.scores, want.scores, rtol=0, atol=SCORE_TOL),
              f"{tag}: presence scores")
        if instances > 1:
            check(np.array_equal(res.inst_boxes, want.inst_boxes)
                  and np.array_equal(res.inst_counts, want.inst_counts),
                  f"{tag}: instance boxes or counts")
        else:
            check(res.inst_boxes is None, f"{tag}: instance outputs")
        got_d, want_d = res.detections(thr), want.detections(thr)
        check(all(same_detections(g, w, SCORE_TOL) for g, w in zip(got_d, want_d)),
              f"{tag}: detections differ")
    n_dets = sum(len(d) for d in want_d)
    phase("4 engine", f"{variant} ({engine.backend}) detect_multi_batch "
                      f"--instances {instances}, direct and staged, on "
                      f"{len(gate)} images: boxes"
                      f"{', instances and counts' if instances > 1 else ''} "
                      f"equal to the host twins, probabilities and presence "
                      f"scores within {SCORE_TOL}, the same {n_dets} "
                      f"detections; wire boxes u8: {engine.compact_multi}")


def multi_cli(variant: str, mode: str, instances: int) -> None:
    art_dir = ARTIFACTS[variant]
    paths = shipped_images(variant)
    model = load_model(art_dir, variant)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        infer.main(["--variant", variant, "--image-dir", art_dir, "--device",
                    "cuda", "--mode", mode, "--multi", "--instances",
                    str(instances), "--no-save"])
    got = infer.parse_detection_blocks(out.getvalue())
    feats = oracle_feats([np.fromfile(p, np.uint8) for p in paths],
                         model.kernels, model.shifts)
    thr = multi_thresh_of(model)
    dets = host_multi(feats, model, instances).detections(thr)
    # the host twins' detections in the JAX CLI's format
    # (tpu_cnn/apps/infer.py), not through the port's formatter
    header = "  Detections (prob >= " + (
        f"{thr:.0%}" if np.ndim(thr) == 0 else "per-class calibrated floors") + "):"
    want = [(header, [(model.class_names[k], 100.0 * prob,
                       f"({x1}, {y1}) -> ({x2}, {y2})")
                      for k, prob, (x1, y1, x2, y2) in d]) for d in dets]
    check(len(got) == len(want) == len(paths),
          f"{variant} --multi CLI printed {len(got)} detection blocks for "
          f"{len(paths)} images")
    for p, (gh, gd), (wh, wd) in zip(paths, got, want):
        # the printed 0.1% rounds the probability: allow one step of it
        check(gh == wh and len(gd) == len(wd) and all(
            gn == wn and gb == wb and abs(gp - wp) <= 0.1 + 1e-9
            for (gn, gp, gb), (wn, wp, wb) in zip(gd, wd)),
            f"{variant} --multi CLI on {os.path.basename(p)}: {gh} {gd} != "
            f"the host twins' {wh} {wd}")
    phase("5 cli", f"tpu_cnn_torch.apps.infer --variant {variant} --mode {mode} "
                   f"--multi --instances {instances}: the Detections lines of "
                   f"{len(paths)} images equal the host twins' "
                   f"({sum(len(d) for _, d in got)} detections)")


def multi_server(variant: str, mode: str, instances: int) -> None:
    model = load_model(ARTIFACTS[variant], variant)
    size = model.config.img_size
    paths = shipped_images(variant)[:8]
    batcher, backend = serve.build_service(ARTIFACTS[variant], device="cuda",
                                           max_batch=8, variant=variant,
                                           mode=mode, multi=True,
                                           instances=instances)
    bodies = [open(p, "rb").read() for p in paths]
    feats = oracle_feats([np.frombuffer(b, np.uint8) for b in bodies],
                         model.kernels, model.shifts)
    want = host_multi(feats, model, instances)
    want_dets = {"/detect": want.detections(multi_thresh_of(model)),
                 "/detect?thresh=0.3": want.detections(0.3)}
    urls = ["/detect?thresh=0.3"] + ["/detect"] * (len(bodies) - 1)
    with http_service(batcher, backend) as request:
        with concurrent.futures.ThreadPoolExecutor(8) as pool:
            answers = list(pool.map(lambda a: request("POST", *a),
                                    zip(urls, bodies)))
        stats = batcher.snapshot()
    for i, (p, url, (status, ans)) in enumerate(zip(paths, urls, answers)):
        idx = int(want.pred[i])
        dets = want_dets[url][i]
        got = [(d["pred"], d["conf"], d["bbox"]) for d in ans.get("detections", [])]
        check(status == 200 and ans["pred"] == idx
              and ans["bbox"] == [int(v) for v in want.boxes[i, idx]]
              and all(d["name"] == model.class_names[d["pred"]]
                      for d in ans["detections"])
              and same_detections(got, dets, SCORE_TOL),
              f"{variant} {os.path.basename(p)} {url}: server {status} {ans} "
              f"!= host pred {idx} detections {dets}")
    phase("6 server", f"{variant} ({backend}) --multi --instances {instances}: "
                      f"{len(paths)} POSTs (one with ?thresh=0.3), each "
                      f"answer's detections equal to the host twins'; "
                      f"batches={stats['batches']} requests={stats['requests']}")


def probe_path() -> None:
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = probe_bitcast.main(["--device", "cuda"])
    lines = [ln.strip() for ln in out.getvalue().splitlines()]
    want = ("layout r*4+b (word-major rows): MATCH", "layout r*4+b: MATCH",
            "Q3 packed i32 roll: MATCH")
    if rc != 0 or not all(w in lines for w in want):
        print(out.getvalue(), flush=True)
    check(rc == 0 and all(w in lines for w in want),
          f"tpu_cnn_torch.apps.probe_bitcast --device cuda: exit {rc}")
    phase("probe", f"tpu_cnn_torch.apps.probe_bitcast --device cuda: exit 0; "
                   f"{'; '.join(want)}")


def verify_cli(variant: str) -> None:
    """The port's golden-model verifier on the card: all seven backends,
    the engines' heads, exit 0 and the verdict."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = verify.main(["--device", "cuda", "--variant", variant,
                          "--image-dir", ARTIFACTS[variant]])
    text = out.getvalue()
    exact = sum("BIT-EXACT" in ln for ln in text.splitlines())
    heads = sum(": OK" in ln for ln in text.splitlines())
    multi_ok = all(
        sum(f"host twin {name:13s}: OK" in ln for ln in text.splitlines())
        == len(verify.ENGINE_BACKENDS)
        for name in ("multi boxes", "instances", "multi scores"))
    if rc != 0 or VERDICT not in text or not multi_ok:
        print(text, flush=True)
    check(rc == 0 and VERDICT in text and multi_ok,
          f"tpu_cnn_torch.apps.verify --variant {variant}: exit {rc}, "
          f"multi checks OK on every engine: {multi_ok}")
    phase("verify", f"tpu_cnn_torch.apps.verify --device cuda --variant "
                    f"{variant}: exit 0, {exact} backend pairs bit-exact, "
                    f"{heads} head checks OK (multi boxes, instances and "
                    f"multi scores on each engine); {VERDICT}")


# ── the engine swap, the host-oracle service, the device preprocess and
# the realtime app ──────────────────────────────────────────────────


def _accuracy_line(argv) -> str:
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        infer.main(argv)
    return next(ln.strip() for ln in out.getvalue().splitlines()
                if "Accuracy:" in ln)


def engine_swap(variant: str) -> None:
    """``make_engine``: "cpu" is the host oracle on the native C++ build,
    its features bit-equal to the numpy oracle on the shipped images;
    "auto" resolves to mega on the card; the infer CLI's ``--mode cpu``
    scores as ``--mode mega --device cuda``; ``--dump-features`` writes the
    oracle's features."""
    art_dir = ARTIFACTS[variant]
    model = load_model(art_dir, variant)
    paths = shipped_images(variant)
    imgs = np.stack([np.fromfile(p, np.uint8) for p in paths])
    want = oracle_feats(list(imgs), model.kernels, model.shifts)
    host = infer.make_engine(model, "cpu")
    check(isinstance(host, CPURefEngine) and host.backend == "native-c++",
          f"{variant}: make_engine(model, 'cpu') is {type(host).__name__} on "
          f"{getattr(host, 'backend', '?')}, not the native C++ oracle")
    check(np.array_equal(host.run_batch(imgs), want),
          f"{variant}: the host oracle engine's features differ from the "
          f"numpy oracle's")
    check(np.array_equal(host.run(imgs[0])[0], want[0]),
          f"{variant}: CPURefEngine.run differs from the numpy oracle")
    auto = infer.make_engine(model, "auto", "cuda")
    check(isinstance(auto, CUDAEngine) and auto.mode == "mega"
          and auto.backend.endswith("-cuda"),
          f"{variant}: --mode auto resolved to {auto.backend}")
    check(np.array_equal(auto.run_batch(imgs[:8]), want[:8]),
          f"{variant}: the auto engine's features differ from the oracle's")
    common = ["--variant", variant, "--image-dir", art_dir, "--no-save"]
    cpu_line = _accuracy_line(common + ["--mode", "cpu"])
    mega_line = _accuracy_line(common + ["--mode", "mega", "--device", "cuda"])
    cpu_acc, mega_acc = (ln.split(" (")[0] for ln in (cpu_line, mega_line))
    check(cpu_acc == mega_acc,
          f"{variant}: infer --mode cpu '{cpu_line}' != --mode mega '{mega_line}'")
    dump = os.path.join(ROOT, "build", "chip_smoke", variant)
    os.makedirs(dump, exist_ok=True)
    image = os.path.join(dump, os.path.basename(paths[0]))
    with open(paths[0], "rb") as src, open(image, "wb") as dst:
        dst.write(src.read())
    with contextlib.redirect_stdout(io.StringIO()):
        infer.main(["--variant", variant, "--image", image, "--device", "cuda",
                    "--no-save", "--dump-features"])
    dumped = np.load(os.path.splitext(image)[0] + "_features.npy")
    check(dumped.dtype == np.uint8 and np.array_equal(dumped, want[0]),
          f"{variant}: --dump-features differs from the oracle's features")
    phase("swap", f"{variant}: make_engine cpu -> CPURefEngine ({host.backend}), "
                  f"features of {len(imgs)} shipped images bit-equal to the "
                  f"numpy oracle; auto -> {auto.backend}; infer --mode cpu "
                  f"'{cpu_acc}' == --mode mega --device cuda; --dump-features "
                  f"bit-equal to the oracle")


def _host_answer(small: np.ndarray, model) -> tuple[int, np.ndarray, list]:
    """The host oracle's (pred, probs, box) for one (S, S) u8 image."""
    f = oracle_feats([small], model.kernels, model.shifts)[0]
    idx, _, probs = classify_np(f[None], model.fc_weight, model.fc_bias)
    box = cam_bbox_fast(f, int(idx[0]), model.fc_weight,
                        img_size=model.config.img_size)
    return int(idx[0]), probs[0], list(box)


def host_server(variant: str) -> None:
    """``serve --mode cpu`` (the host oracle behind the host adapter) on
    the device server phase's 8 raw POSTs, each answer equal to that
    server's; then a PNG through ``decode_image``, equal to the host
    oracle on ``realtime.preprocess`` of the same pixels."""
    from PIL import Image

    model = load_model(ARTIFACTS[variant], variant)
    paths = shipped_images(variant)[:8]
    bodies = [open(p, "rb").read() for p in paths]
    frame = realtime.SyntheticSource(640, 480).read()  # BGR
    png = io.BytesIO()
    Image.fromarray(frame[..., ::-1]).save(png, format="PNG")
    batcher, backend = serve.build_service(ARTIFACTS[variant], device="cuda",
                                           max_batch=8, variant=variant,
                                           mode="cpu")
    check(backend == "host:native-c++", f"serve --mode cpu backend {backend}")
    with http_service(batcher, backend) as request:
        with concurrent.futures.ThreadPoolExecutor(8) as pool:
            answers = list(pool.map(lambda b: request("POST", "/detect", b), bodies))
        png_status, png_ans = request("POST", "/detect", png.getvalue())
    for p, (status, ans), (d_status, d_ans) in zip(paths, answers,
                                                   _SERVED[(variant, "mega")]):
        check(status == d_status == 200 and ans["pred"] == d_ans["pred"]
              and ans["bbox"] == d_ans["bbox"] and ans["name"] == d_ans["name"]
              and np.allclose(ans["probs"], d_ans["probs"], rtol=0, atol=SCORE_TOL),
              f"{variant} {os.path.basename(p)}: serve --mode cpu {ans} != the "
              f"device server's {d_ans}")
    idx, probs, box = _host_answer(realtime.preprocess(frame, model.config.img_size),
                                   model)
    check(png_status == 200 and png_ans["pred"] == idx and png_ans["bbox"] == box
          and np.allclose(png_ans["probs"], probs, rtol=0, atol=SCORE_TOL),
          f"{variant} PNG POST: {png_status} {png_ans} != host oracle pred "
          f"{idx} box {box}")
    phase("6 server", f"{variant} serve --mode cpu ({backend}): {len(bodies)} "
                      f"raw POSTs equal to the device server's answers; a "
                      f"640x480 PNG POST equal to the host oracle on "
                      f"realtime.preprocess of its pixels")


def _preprocess_cases(rs, w: int, h: int):
    """(form, input, valid_w, channel order, the host twins' answer) for
    one geometry at B=37: BGR and RGB, 4-channel, packed words (uint32 and
    their int32 view), gray, and valid_w=w on a pitch 8 wider."""
    b = KERNEL_BATCH
    f4 = rs.randint(0, 256, (b, h, w, 4)).astype(np.uint8)
    f3 = np.ascontiguousarray(f4[..., :3])
    gray = rs.randint(0, 256, (b, h, w)).astype(np.uint8)
    bgr = preprocess_frames_native(f3, 128)
    rgb = preprocess_frames_native(f3, 128, channel_order="rgb")
    g = preprocess_frames_native(gray, 128)
    check(np.array_equal(bgr, np.stack([realtime.preprocess(f, 128) for f in f3]))
          and np.array_equal(rgb, np.stack([realtime.preprocess(f[..., ::-1], 128)
                                            for f in f3]))
          and np.array_equal(g, np.stack([realtime.preprocess(f, 128) for f in gray])),
          f"{w}x{h}: the native and numpy host twins disagree")
    words = pack_bgrx(f4)
    staged = np.full((b, h, w + 8), 0xDEADBEEF, np.uint32)
    staged[:, :, :w] = words
    return [("bgr", f3, None, "bgr", bgr), ("rgb", f3, None, "rgb", rgb),
            ("bgrx", f4, None, "bgr", bgr), ("rgbx", f4, None, "rgb", rgb),
            ("packed u32", words, None, "bgr", bgr),
            ("packed i32", words.view(np.int32), None, "rgb", rgb),
            ("gray", gray, None, "bgr", g),
            (f"packed, valid_w={w} on pitch {w + 8}", staged, w, "bgr", bgr)]


def device_preprocess(dev: torch.device) -> None:
    """``ops.preprocess.preprocess_frames`` on the card at B=37, every
    geometry and input form, bit-equal to the native twin and the numpy
    twin (``realtime.preprocess``)."""
    rs = np.random.RandomState(12)
    n = 0
    for w, h in PREPROCESS_GEOMETRIES:
        for form, x, vw, order, want in _preprocess_cases(rs, w, h):
            got = dev_preprocess.preprocess_frames(
                torch.from_numpy(x).to(dev), 128, channel_order=order, valid_w=vw)
            check(got.device.type == "cuda" and got.dtype == torch.uint8
                  and np.array_equal(got.cpu().numpy(), want),
                  f"device preprocess {w}x{h} {form} differs from the host twins")
            n += 1
    phase("preprocess", f"ops.preprocess.preprocess_frames on the card, "
                        f"B={KERNEL_BATCH}: {n} cases ({len(PREPROCESS_GEOMETRIES)} "
                        f"geometries x BGR/RGB, BGRX/RGBX, packed u32/i32, gray, "
                        f"valid_w on a wider pitch) bit-equal to the native "
                        f"and numpy twins")


def _realtime_argv(variant: str, flags, frames: int, serve_port=None) -> list:
    return ["--variant", variant, *flags, "--device", "cuda", "--source",
            "synthetic", "--frames", str(frames),
            *(["--port", str(serve_port)] if serve_port else ["--no-serve"])]


def _run_realtime(argv) -> tuple[str, dict]:
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        stats = realtime.main(argv)
    return out.getvalue(), stats


def _same_frame(got, want) -> bool:
    """Two ``realtime.Frame``s: class, name and box equal, probabilities
    within SCORE_TOL, the same detections (classes, boxes and labels
    equal, probabilities within SCORE_TOL)."""
    if (got.idx, got.name, tuple(got.bbox)) != (want.idx, want.name, tuple(want.bbox)):
        return False
    if not np.allclose(got.probs, want.probs, rtol=0, atol=SCORE_TOL):
        return False
    if (got.detections is None) != (want.detections is None):
        return False
    return got.detections is None or (
        len(got.detections) == len(want.detections) and all(
            g[0] == w[0] and tuple(g[2]) == tuple(w[2]) and g[3:] == w[3:]
            and abs(g[1] - w[1]) <= SCORE_TOL
            for g, w in zip(got.detections, want.detections)))


def _stream_part(port: int, got: list) -> None:
    """Client of the realtime app's MJPEG server: retry until it listens,
    then read one multipart JPEG from /stream into ``got``."""
    deadline = time.time() + 120
    while time.time() < deadline:
        try:
            conn = http.client.HTTPConnection("127.0.0.1", port, timeout=10)
            conn.request("GET", "/stream")
            resp = conn.getresponse()
            got.append((resp.status, resp.getheader("Content-Type"),
                        resp.fp.read(4096)))
            conn.close()
            return
        except OSError:
            time.sleep(0.02)


def realtime_path(variant: str, flags) -> None:
    """``realtime.main`` on the card for REALTIME_FRAMES synthetic frames;
    then ``detect_frame`` on those frames against the host oracle
    (``CPURefEngine`` and the host twins, with a tracker of its own where
    the path tracks)."""
    text, _ = _run_realtime(_realtime_argv(variant, flags, REALTIME_FRAMES))
    check(f"Done. {REALTIME_FRAMES} frames." in text,
          f"realtime {variant} {' '.join(flags)}: no 'Done.' line:\n{text[-2000:]}")
    engine_line = next(ln for ln in text.splitlines() if ln.startswith("Engine:"))
    model = load_model(ARTIFACTS[variant], variant)
    mode = flags[flags.index("--mode") + 1]
    multi, track = "--multi" in flags, "--track" in flags
    instances = int(flags[flags.index("--instances") + 1]) if multi else 1
    engine = infer.make_engine(model, mode, "cuda")
    host = CPURefEngine(model.kernels, model.shifts)
    fused = "--fused" in flags and hasattr(engine, "detect_batch")
    opts = dict(multi=multi, instances=instances,
                multi_thresh=multi_thresh_of(model))
    trackers = (Tracker(), Tracker()) if track else (None, None)
    src = realtime.SyntheticSource(640, 480)
    n_dets = 0
    for i in range(REALTIME_FRAMES):
        small = realtime.preprocess(src.read(), model.config.img_size)
        got = realtime.detect_frame(engine, model, small, fused=fused,
                                    tracker=trackers[0], **opts)
        want = realtime.detect_frame(host, model, small, tracker=trackers[1],
                                     **opts)
        check(_same_frame(got, want),
              f"realtime {variant} {' '.join(flags)} frame {i}: {got} != the "
              f"host oracle's {want}")
        n_dets += len(want.detections or ())
    phase("realtime", f"{variant} {' '.join(flags)} --device cuda: "
                      f"'Done. {REALTIME_FRAMES} frames.' ({engine_line}); "
                      f"detect_frame on the same {REALTIME_FRAMES} synthetic "
                      f"frames equal to the host oracle ({n_dets} detections"
                      f"{', tracked' if track else ''})")


def realtime_stream() -> None:
    """One realtime run with the MJPEG server on a free loopback port:
    /stream returns a JPEG part."""
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    got: list = []
    client = threading.Thread(target=_stream_part, args=(port, got), daemon=True)
    client.start()
    text, _ = _run_realtime(_realtime_argv("lyr3-std", ("--mode", "mega", "--fused"),
                                           STREAM_FRAMES, serve_port=port))
    client.join(timeout=30)
    check(f"Done. {STREAM_FRAMES} frames." in text and got and got[0][0] == 200
          and "multipart/x-mixed-replace" in (got[0][1] or "")
          and b"image/jpeg" in got[0][2] and b"\xff\xd8" in got[0][2],
          f"realtime MJPEG /stream on port {port}: {got[:1]!r}")
    phase("realtime", f"lyr3-std --mode mega --fused with the MJPEG server on "
                      f"127.0.0.1:{port}: /stream answered 200 with a JPEG part")


# ── the offline tools and the benchmark app ───────────────────────────

# eval_detection's paths at its default sizes: (family, mode, kernels, the
# flag sets run on that path); each result must equal the same flags' on
# --mode cpu (the host oracle and the host twins)
EVAL_PATHS = [
    ("lyr3-std", "mega", ("mega_cnn", "cam_head"),
     [("--box", "ref"), ("--box", "centroid"), ("--box", "reg"), ("--multi",),
      ("--multi", "--instances", "2", "--same-class"), ("--multi", "--real")]),
    ("lyr4-wide", "mega", ("mega_cnn", "conv_pool_layer", "cam_head"), [()]),
    ("lyr4-wide", "pallas", ("conv_act",), [("--multi",)]),
]
REG_IOU_TOL = 1e-3  # --box reg on mega: boxes floor a regression of K1's bins
TRACKING_FLAGS = [(), ("--instances", "2", "--same-class")]  # lyr3-std mega
# train_bbox --mode mega against --mode cpu: K1's bins agree with
# bin_pool_np within BINS_TOL, and the ridge solve at the chosen lambda
# (0.3) moves the weights by ~5e-4 per 1e-6 of feature noise on the CPU,
# so the weights are held within 1e-2 (|W| <= ~0.4) and the held-out IoU
# within 1e-3
BBOX_W_TOL = 1e-2
BBOX_IOU_TOL = 1e-3
# apps.benchmark runs: (flags, kernels); each must exit 0 and launch its
# kernels and no others
BENCH_RUNS = [
    # every mode once (the host oracle takes seconds a batch), then the
    # device modes' FPS on a pipeline as long as phase 7's
    (("--modes", "auto,mega,pallas,hybrid,xla,cpu", "--batch", str(BENCH_BATCH),
      "--runs", "2"), ("mega_cnn", "conv_act", "cam_head")),
    (("--modes", "mega,pallas,hybrid", "--batch", str(BENCH_BATCH), "--runs",
      "52"), ("mega_cnn", "conv_act", "cam_head")),
    (("--multi", "--instances", "2", "--runs", "5"), ("mega_cnn",)),
    (("--per-layer", "--modes", "pallas", "--batch", str(BENCH_BATCH),
      "--runs", "20"), ("conv_act",)),
    (("--per-layer", "--modes", "mega", "--batch", str(BENCH_BATCH),
      "--runs", "10"), ("mega_cnn",)),
    (("--roofline", "--batch", str(BENCH_BATCH), "--runs", "20"), ("mega_cnn",)),
    (("--latency", "--runs", "20"), ("mega_cnn", "cam_head")),
    (("--camera-pipeline", "--cam-channels", "4", "--batch", "256", "--runs",
      "10"), ("mega_cnn", "cam_head")),
    (("--camera-pipeline", "--cam-channels", "3", "--batch", "256", "--runs",
      "10"), ("mega_cnn", "cam_head")),
    (("--camera-pipeline", "--cam-pitch", "656", "--batch", "256", "--runs",
      "10"), ("mega_cnn", "cam_head")),
    (("--features", "--runs", "5"), ("mega_cnn",)),
    (("--variant", "lyr4-wide", "--modes", "mega", "--runs", "5"),
     ("mega_cnn", "conv_pool_layer", "cam_head")),
    (("--variant", "lyr4-wide", "--roofline", "--runs", "10"),
     ("mega_cnn", "conv_pool_layer")),
]
PER_LAYER_TOL = 0.2  # the benchmark's pooled conv_act rows vs phase 7's
_BENCH: dict[str, object] = {}  # the benchmark's per-layer rows, for phase 7


def _quiet(fn, argv):
    """``fn(argv)`` with its standard output captured: (result, text)."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        res = fn(list(argv))
    return res, out.getvalue()


def _multi_floor_diffs(variant: str, mode: str, flags) -> list[tuple]:
    """The multi eval's per-image outputs on the card and on the host
    oracle, for the scenes of ``eval_detection --multi`` with ``flags``:
    (image, class, card score, host score, floor, distance from the floor)
    for every (image, class) that one side detects and the other does not.
    Boxes and instances must be equal."""
    model = load_model(ARTIFACTS[variant], variant)
    same_class = "--same-class" in flags
    instances = int(flags[flags.index("--instances") + 1]) if "--instances" in flags else 1
    scenes_cls = RealComposites if "--real" in flags else None
    kw = {"same_class": True} if same_class else {}
    u8, _ = eval_detection.multi_scenes(model, 60, 123, scenes_cls, **kw)
    dev = eval_detection.multi_outputs(model, infer.make_engine(model, mode, "cuda"),
                                       u8, instances=instances)
    host = eval_detection.multi_outputs(model, infer.make_engine(model, "cpu"), u8,
                                        instances=instances)
    for a, b in zip(dev[1:], host[1:]):
        check((a is None and b is None) or np.array_equal(a, b),
              f"{variant} --multi {flags}: boxes or instances differ")
    thr = np.broadcast_to(np.asarray(multi_thresh_of(model), np.float64),
                          (dev[0].shape[1],))
    return [(i, k, float(dev[0][i, k]), float(host[0][i, k]), float(thr[k]),
             min(abs(dev[0][i, k] - thr[k]), abs(host[0][i, k] - thr[k])))
            for i, k in zip(*np.nonzero((dev[0] >= thr) != (host[0] >= thr)))]


def eval_path(variant: str, mode: str, flags) -> None:
    """``eval_detection`` at its default sizes with ``flags`` on the card
    and on --mode cpu: equal metrics (``--box reg`` on mega: mean IoU within
    REG_IOU_TOL; a multi metric may differ only on images whose score lies
    within SCORE_TOL of its floor, each printed)."""
    common = ["--variant", variant, "--artifacts", ARTIFACTS[variant], *flags]
    got, _ = _quiet(eval_detection.main, common + ["--device", "cuda", "--mode", mode])
    want, _ = _quiet(eval_detection.main, common + ["--mode", "cpu"])
    tag = f"eval_detection --variant {variant} --mode {mode} {' '.join(flags)}"
    how = "equal to --mode cpu"
    if got != want and "reg" in flags:
        close = {k for k in ("mean_iou", "iou_gain")
                 if abs(got[k] - want[k]) <= REG_IOU_TOL}
        check(close == {"mean_iou", "iou_gain"} and all(
            got[k] == want[k] for k in got if k not in close),
            f"{tag}: {got} != --mode cpu {want}")
        how = (f"equal to --mode cpu but mean IoU {got['mean_iou']!r} vs "
               f"{want['mean_iou']!r} (within {REG_IOU_TOL})")
    elif got != want and "--multi" in flags:
        diffs = _multi_floor_diffs(variant, mode, flags)
        for i, k, d, h, t, dist in diffs:
            print(f"[eval] {tag}: image {i} class {k}: card score {d!r}, host "
                  f"{h!r}, floor {t!r}, distance {dist!r}", flush=True)
        check(diffs and all(dist < SCORE_TOL for *_, dist in diffs),
              f"{tag}: {got} != --mode cpu {want}")
        how = (f"within the score tolerance of --mode cpu ({len(diffs)} "
               f"detections within {SCORE_TOL} of their floor)")
    else:
        check(got == want, f"{tag}: {got} != --mode cpu {want}")
    summary = {k: v for k, v in got.items() if k != "per_class"}
    phase("eval", f"{tag}: {how}: {summary}")


def tracking_path(flags) -> None:
    common = ["--variant", "lyr3-std", *flags]
    got, _ = _quiet(eval_tracking.main, common + ["--device", "cuda", "--mode", "mega"])
    want, _ = _quiet(eval_tracking.main, common + ["--mode", "cpu"])
    tag = f"eval_tracking --mode mega {' '.join(flags)}"
    check(got == want, f"{tag}: {got} != --mode cpu {want}")
    prod = got["static-IoU (production)"]
    phase("tracking", f"{tag}: every tracker's metrics equal to --mode cpu "
                      f"({len(got)} configs; production MOTA {prod['mota']!r}, "
                      f"recall {prod['recall']!r}, ID switches "
                      f"{prod['id_switches']})")


def dump_path(variant: str) -> None:
    """``dump_features --mode mega`` on the shipped images: the npz bit-equal
    to the numpy oracle."""
    art_dir, paths = ARTIFACTS[variant], shipped_images(variant)
    out = os.path.join(ROOT, "build", "chip_smoke", variant, "features.npz")
    os.makedirs(os.path.dirname(out), exist_ok=True)
    _quiet(dump_features.main, ["--variant", variant, "--artifacts", art_dir,
                                "--image-dir", art_dir, "--mode", "mega",
                                "--device", "cuda", "--output", out])
    feats, labels, names, shifts = art.load_feature_dump(out)
    model = load_model(art_dir, variant)
    want = oracle_feats([np.fromfile(p, np.uint8) for p in paths],
                        model.kernels, model.shifts)
    check(feats.dtype == np.uint8 and np.array_equal(feats, want)
          and names == [os.path.basename(p) for p in paths]
          and list(labels) == [label_from_filename(p) for p in paths]
          and list(shifts) == list(model.shifts),
          f"{variant} dump_features --mode mega differs from the numpy oracle")
    phase("dump", f"{variant} dump_features --mode mega --device cuda: "
                  f"{feats.shape} u8 features of {len(paths)} shipped images "
                  f"bit-equal to the numpy oracle; labels, names, shifts equal")


def train_bbox_path() -> None:
    """``train_bbox --mode mega`` (K1's fused bins) against ``--mode cpu``:
    weights within BBOX_W_TOL, held-out IoU within BBOX_IOU_TOL."""
    outs = {m: os.path.join(ROOT, "build", "chip_smoke", f"bbox_{m}")
            for m in ("mega", "cpu")}
    (w_dev, held_dev), _ = _quiet(train_bbox.main, ["--mode", "mega", "--device",
                                                    "cuda", "--output-dir",
                                                    outs["mega"]])
    (w_cpu, held_cpu), _ = _quiet(train_bbox.main, ["--mode", "cpu",
                                                    "--output-dir", outs["cpu"]])
    err = float(np.abs(w_dev - w_cpu).max())
    check(np.array_equal(np.load(os.path.join(outs["mega"], "bbox_weight.npy")),
                         w_dev), "train_bbox saved other weights than it returned")
    check(err <= BBOX_W_TOL and abs(held_dev - held_cpu) <= BBOX_IOU_TOL,
          f"train_bbox --mode mega: weights off by {err}, held-out IoU "
          f"{held_dev} vs {held_cpu}")
    phase("train_bbox", f"train_bbox --mode mega --device cuda vs --mode cpu: "
                        f"weights {w_dev.shape} within {err!r} (tolerance "
                        f"{BBOX_W_TOL}), held-out IoU {held_dev!r} vs "
                        f"{held_cpu!r} (tolerance {BBOX_IOU_TOL})")


def benchmark_run(flags) -> None:
    """``apps.benchmark`` on the card with ``flags``: it must return (exit
    0); its output is printed as it stands."""
    try:
        res, text = _quiet(benchmark.main, flags)
    except SystemExit as e:
        raise RuntimeError(f"apps.benchmark {' '.join(flags)} exited {e.code}")
    keep = [ln for ln in text.splitlines() if ln.strip() and not ln.startswith("===")]
    print("\n".join(f"[bench] {ln}" for ln in keep), flush=True)
    check("FAILED" not in text, f"apps.benchmark {' '.join(flags)}: {text}")
    if "--per-layer" in flags and "pallas" in flags:
        _BENCH["per_layer"] = res["per_layer"]
    phase("benchmark", f"apps.benchmark {' '.join(flags)} --device cuda: exit 0")


INGEST_ARGV = ["--host-ingest", "--batch", "256", "--runs", "40", "--cam-res",
               "640x480", "--ingest-threads", "4"]


def host_ingest_path(card: str) -> None:
    """``apps.benchmark --host-ingest``: 4 producer threads push 10,240 raw
    640x480 BGR frames through the native frame ring (the C++ preprocess),
    one consumer drains batches of 256. Host work only: no kernel."""
    res, text = _quiet(benchmark.main, INGEST_ARGV)
    line = next(ln.strip() for ln in text.splitlines() if "host ingest" in ln)
    check(res["host_ingest"] > 0 and res["dropped"] >= 0,
          f"apps.benchmark --host-ingest: {res}")
    phase("benchmark", f"apps.benchmark {' '.join(INGEST_ARGV)} on the host "
                       f"of {card}: exit 0; {line}; frames/s "
                       f"{res['host_ingest']!r}, dropped {res['dropped']}")


# ── the deployment path: the native front, the deployable, the load ──

NATIVE_BATCH = 16  # serve_native's --max-batch on the card
NATIVE_FRAMES = 24  # concurrent raw POSTs per serve_native run
DEPLOY_DIR = os.path.join(ROOT, "build", "chip_smoke", "deploy")
DEPLOY_BATCHES = "8,1536"  # the exported buckets
DEPLOY_IMAGES = 1536 + 37  # one full bucket, then a remainder padded to it
DEPLOY_SERVED = 8  # POSTs to serve --deployable
SERVING_ARGV = ["--duration", "4", "--conc", "4,16,64", "--mode", "mega",
                "--max-batch", "256", "--variant", "lyr3-std", "--device",
                "cuda"]


def _frames(variant: str, n: int, seed: int) -> np.ndarray:
    """The family's shipped test images, then seeded noise, n in all."""
    size = get_config(variant).img_size
    shipped = [np.fromfile(p, np.uint8).reshape(size, size)
               for p in shipped_images(variant)][:n]
    rs = np.random.RandomState(seed)
    noise = rs.randint(0, 256, (n - len(shipped), size, size)).astype(np.uint8)
    return np.concatenate([np.stack(shipped), noise])


def _post_raw(port: int, body, path="/detect", method="POST"):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        conn.request(method, path, body=body)
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read())
    finally:
        conn.close()


def _native_answers(front, detect_fn, names, thr, frames) -> list:
    """Serve ``frames`` through ``front`` as concurrent raw POSTs with one
    worker thread on ``detect_fn`` (serve_native's loop); stop both and
    return the (status, JSON) answers in frame order."""
    stop = threading.Event()

    def worker():
        while not stop.is_set():
            front.serve_once(detect_fn, names, timeout_s=0.05,
                             multi_thresh=thr)

    th = threading.Thread(target=worker, daemon=True)
    th.start()
    try:
        with concurrent.futures.ThreadPoolExecutor(len(frames)) as pool:
            answers = list(pool.map(lambda f: _post_raw(front.port, f.tobytes()),
                                    frames))
        check(front.served >= len(frames), f"served {front.served}")
    finally:
        stop.set()
        th.join(timeout=30)
        front.stop()
    return answers


def _same_answers(tag, got, want, detections: bool) -> None:
    for i, ((gs, g), (ws, w)) in enumerate(zip(got, want)):
        ok = (gs == ws == 200 and g["pred"] == w["pred"] and g["name"] == w["name"]
              and g["bbox"] == w["bbox"]
              and np.allclose(g["probs"], w["probs"], rtol=0, atol=SCORE_TOL))
        if detections:
            ok = ok and same_detections(
                [(d["pred"], d["conf"], d["bbox"]) for d in g["detections"]],
                [(d["pred"], d["conf"], d["bbox"]) for d in w["detections"]],
                SCORE_TOL)
        check(ok, f"{tag} frame {i}: {gs} {g} != {ws} {w}")


def native_pushback(variant: str, detect_fn, names) -> str:
    """A front whose worker is stalled: /healthz, 400 and 413 from the C++
    side, then 12 POSTs into a queue of 8 (4 x max_batch 2): 4 answer 503
    at once, and the 8 queued answer 200 once the worker drains them."""
    size = get_config(variant).img_size
    front = NativeFrontEnd("127.0.0.1", 0, size, max_batch=2)
    try:
        status, health = _post_raw(front.port, None, "/healthz", "GET")
        check(status == 200 and health["status"] == "ok", f"/healthz {health}")
        bad = {n: _post_raw(front.port, b"x" * n)[0]
               for n in (16, size * size + 1)}
        check(bad == {16: 400, size * size + 1: 413}, f"malformed bodies {bad}")
        body = _frames(variant, 1, 3)[0].tobytes()
        with concurrent.futures.ThreadPoolExecutor(12) as pool:
            futs = [pool.submit(_post_raw, front.port, body) for _ in range(12)]
            deadline = time.time() + 20
            while time.time() < deadline and sum(
                    f.done() and f.result()[0] == 503 for f in futs) < 4:
                time.sleep(0.05)
            for _ in range(8):
                front.serve_once(detect_fn, names, timeout_s=0.5)
            statuses = sorted(f.result()[0] for f in futs)
    finally:
        front.stop()
    check(statuses == [200] * 8 + [503] * 4, f"push-back statuses {statuses}")
    return "/healthz ok, 400 and 413 on malformed bodies, 503 x4 then 200 x8"


def native_front_path(variant: str, instances: int = 1) -> None:
    """serve_native --mode mega --device cuda (its worker through
    ``build_worker``: make_engine, warm at --max-batch, then the bound
    C++ front) over real sockets: NATIVE_FRAMES concurrent raw POSTs,
    each answer equal to serve_native --mode cpu's (the host oracle and
    the host head) on the same frames; with ``instances`` > 1 the
    --multi --instances N answers, whose detections equal the live
    engine's filtered ones (the host adapter has no instance head)."""
    model = load_model(ARTIFACTS[variant], variant)
    size = model.config.img_size
    frames = _frames(variant, NATIVE_FRAMES, 17)
    multi = instances > 1
    fn, thr, backend = serve_native.build_worker(
        model, "mega", "cuda", max_batch=NATIVE_BATCH, multi=multi,
        instances=instances)
    got = _native_answers(NativeFrontEnd("127.0.0.1", 0, size, NATIVE_BATCH),
                          fn, model.class_names, thr, frames)
    if multi:
        engine = CUDAEngine(model, device="cuda", backend="mega")
        res = engine.detect_multi_batch(frames, instances=instances)
        dets = res.detections(thr)
        want = [(200, {"pred": int(res.pred[i]),
                       "name": model.class_names[int(res.pred[i])],
                       "probs": res.probs[i].tolist(),
                       "bbox": [int(v) for v in res.boxes[i, res.pred[i]]],
                       "detections": [{"pred": k, "conf": p, "bbox": list(b)}
                                      for k, p, b in dets[i]]})
                for i in range(len(frames))]
        what = f"--multi --instances {instances}: the live engine's detections"
    else:
        cpu_fn, _, cpu_backend = serve_native.build_worker(
            model, "cpu", max_batch=NATIVE_BATCH)
        want = _native_answers(NativeFrontEnd("127.0.0.1", 0, size, NATIVE_BATCH),
                               cpu_fn, model.class_names, None, frames)
        what = f"serve_native --mode cpu ({cpu_backend})"
    _same_answers(f"{variant} serve_native", got, want, multi)
    extra = native_pushback(variant, fn, model.class_names) if not multi else ""
    n_dets = sum(len(a.get("detections", [])) for _, a in got)
    phase("serve_native", f"{variant} --mode mega ({backend}): {len(frames)} "
                          f"concurrent raw POSTs equal to {what}"
                          f"{f' ({n_dets} detections)' if multi else ''}"
                          f"{'; ' + extra if extra else ''}")


_DEPLOY_CHILD = r"""
import json, sys
import numpy as np
from tpu_cnn_torch.deploy import DeployedDetector
from tpu_cnn_torch.ops import conv_pool, mega
det = DeployedDetector.load(sys.argv[1], "cuda")
out = det.detect(np.load(sys.argv[2]))
np.savez(sys.argv[3], pred=out[0], conf=out[1], probs=out[2], bbox=out[3])
print(json.dumps({
    "launches": {"mega_cnn": mega.launches, "conv_pool_layer": conv_pool.launches},
    "loaded": sorted(m for m in sys.modules if m.startswith(
        ("tpu_cnn_torch.models", "tpu_cnn_torch.engine", "tpu_cnn_torch.apps",
         "tpu_cnn.", "jax")))}))
"""


def deploy_file(variant: str) -> str:
    return os.path.join(DEPLOY_DIR, f"{variant}.tcnnx")


def deploy_path(variant: str, ops, instances: int = 1) -> None:
    """export_model --backend mega --platforms cuda --batch 8,1536 (with
    --multi --instances N when instances > 1): every program calls the
    kernels' custom ops ``ops`` and no other; in a child process that
    imports only the loader (``tpu_cnn_torch.deploy``), detect on
    DEPLOY_IMAGES staged images, equal to CUDAEngine(mega); the multi
    program's detections() equal to the live engine's; serve --deployable
    behind HTTP equal to the engine."""
    model = load_model(ARTIFACTS[variant], variant)
    os.makedirs(DEPLOY_DIR, exist_ok=True)
    out = deploy_file(variant)
    argv = ["--variant", variant, "--output", out, "--backend", "mega",
            "--platforms", "cuda", "--batch", DEPLOY_BATCHES]
    if instances > 1:
        argv += ["--multi", "--instances", str(instances)]
    t0 = time.perf_counter()
    rc, text = _quiet(export_model.main, argv)
    t_export = time.perf_counter() - t0
    check(rc == 0, f"export_model {' '.join(argv)}: exit {rc}")
    want_ops = {f"tcnn.{op}.default" for op in ops}
    with zipfile.ZipFile(out) as z:
        names = sorted(n for n in z.namelist() if n.endswith(".pt2"))
        for name in names:
            ep = torch.export.load(io.BytesIO(z.read(name)))
            got_ops = {str(n.target) for n in ep.graph.nodes
                       if str(n.target).startswith("tcnn.")}
            check(got_ops == want_ops, f"{name} calls {got_ops}, not {want_ops}")
    n_programs = len(names)
    imgs = _frames(variant, DEPLOY_IMAGES, 23)
    staged = os.path.join(DEPLOY_DIR, f"{variant}_images.npy")
    result = os.path.join(DEPLOY_DIR, f"{variant}_detect.npz")
    np.save(staged, imgs)
    # the child runs beside this process's checks below
    t0 = time.perf_counter()
    proc = subprocess.Popen([sys.executable, "-c", _DEPLOY_CHILD, out, staged,
                             result], cwd=ROOT, env=dict(os.environ, PYTHONPATH=ROOT),
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    try:
        engine = CUDAEngine(model, device="cuda", backend="mega")
        want = engine.detect_batch(imgs)
        extra = _deployable_checks(variant, model, out, engine, imgs, instances)
        stdout, stderr = proc.communicate(timeout=600)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    t_child = time.perf_counter() - t0
    check(proc.returncode == 0, f"deployable child: exit {proc.returncode}: "
                                f"{stderr[-3000:]}")
    child = json.loads(stdout.splitlines()[-1])
    check(child["loaded"] == [], f"the child imported {child['loaded']}")
    check(all(child["launches"][op] > 0 for op in ops)
          and sum(child["launches"].values()) == len(ops) * 2,
          f"the child's launches {child['launches']}")
    got = np.load(result)
    check(np.array_equal(got["pred"], want.pred)
          and np.array_equal(got["bbox"], want.bbox)
          and np.allclose(got["probs"], want.probs, rtol=0, atol=SCORE_TOL),
          f"{variant} deployable detect != CUDAEngine(mega)")
    phase("deploy", f"{variant} export_model {' '.join(argv[4:])}: {n_programs} "
                    f"programs ({os.path.getsize(out):,} bytes, {t_export:.1f} s) "
                    f"calling {sorted(want_ops)}; a child importing only the "
                    f"loader ({t_child:.1f} s, no models/engine/apps module, "
                    f"launches {child['launches']}) detected {len(imgs)} images "
                    f"equal to CUDAEngine(mega){extra}")


def _deployable_checks(variant, model, out, engine, imgs, instances) -> str:
    """In this process: the multi program's detections() against the live
    engine's, then serve --deployable behind HTTP against the engine."""
    det = DeployedDetector.load(out, "cuda")
    extra = ""
    if instances > 1:
        thr = multi_thresh_of(model)
        got_d = det.detections(imgs[:64])
        want_d = engine.detect_multi_batch(imgs[:64], instances=instances).detections(thr)
        check(all(same_detections(g, w, SCORE_TOL) for g, w in zip(got_d, want_d)),
              f"{variant} deployable detections() != the live engine's")
        extra = (f"; detections() on 64 images equal to the live engine's "
                 f"({sum(len(d) for d in want_d)} detections)")
    batcher, backend = serve.build_service(device="cuda", max_batch=8,
                                           deployable=out, multi=instances > 1,
                                           instances=instances)
    served = imgs[:DEPLOY_SERVED]
    ref = (engine.detect_multi_batch(served, instances=instances)
           if instances > 1 else engine.detect_batch(served))
    with http_service(batcher, backend) as request:
        with concurrent.futures.ThreadPoolExecutor(DEPLOY_SERVED) as pool:
            answers = list(pool.map(lambda im: request("POST", "/detect", im.tobytes()),
                                    served))
    for i, (status, ans) in enumerate(answers):
        idx = int(ref.pred[i])
        box = ref.boxes[i, idx] if instances > 1 else ref.bbox[i]
        ok = status == 200 and ans["pred"] == idx and ans["bbox"] == [int(v) for v in box]
        if instances > 1:
            ok = ok and same_detections(
                [(d["pred"], d["conf"], d["bbox"]) for d in ans["detections"]],
                ref.detections(multi_thresh_of(model))[i], SCORE_TOL)
        check(ok, f"{variant} serve --deployable POST {i}: {status} {ans}")
    return (f"{extra}; serve --deployable ({backend}): {DEPLOY_SERVED} POSTs "
            f"equal to the engine")


def _load_script(name: str):
    path = os.path.join(ROOT, "scripts", name + ".py")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def serving_load_path(card: str) -> None:
    """scripts/bench_serving_torch.py, short: one warm CUDAEngine (lyr3-std
    mega) behind both fronts, a closed loop of ~4 s per concurrency (4,
    16, 64), the fronts in turns; every answer 200."""
    res, text = _quiet(_load_script("bench_serving_torch").main, SERVING_ARGV)
    for row in res["rows"]:
        check(row["req_s"] > 0 and row["non200"] == 0,
              f"bench_serving_torch {row}")
        phase("serving", f"{card}: lyr3-std {res['backend']} {row['front']} "
                         f"front conc {row['conc']}: {row['req_s']!r} req/s, "
                         f"p50 {row['p50_ms']!r} ms, p99 {row['p99_ms']!r} ms, "
                         f"conn errors {row['conn_errors']}, 503 sheds "
                         f"{row['shed_503']}")
    for name, st in res["stats"].items():
        phase("serving", f"{card}: {name} front /stats after the load: "
                         f"{json.dumps(st)}")


def doctor_path() -> None:
    rc, text = _quiet(doctor.main, [])
    name = torch.cuda.get_device_name(0)
    line = next((ln.strip() for ln in text.splitlines() if "runtime" in ln), "")
    if rc != 0:
        print(text, flush=True)
    check(rc == 0 and "platform=gpu" in line and name in line
          and "[ok]   device dispatch" in text,
          f"apps.doctor: exit {rc}, runtime line {line!r}")
    phase("doctor", f"tpu_cnn_torch.apps.doctor: exit 0; {line}")


# ── the bench: python -m tpu_cnn_torch.bench, its gate's negative check and
# graft_entry.entry() ──────────────────────────────────────────────────

BENCH_TIMEOUT_S = 240  # the bench child's limit
BENCH_KEYS = ["metric", "value", "unit", "vs_baseline"]  # bench.py's line


def bench_path(card: str) -> dict[str, int]:
    """``python -m tpu_cnn_torch.bench`` in a child within BENCH_TIMEOUT_S:
    exit 0 and one stdout line, a JSON object with bench.py's keys, no
    ``error`` and a positive value, printed with the card. Then the gate's
    negative check on the card (the bench's production path with one
    feature bit flipped fails the gate on its features) and
    ``graft_entry.entry()`` on the card, its pred and bbox equal to
    ``CUDAEngine(mega).detect_batch`` on its 8 frames. Returns the child's
    launches of the megakernel and the CAM head (counted in its own
    process: the timed path launches both)."""
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "tpu_cnn_torch.bench"],
                          cwd=ROOT, env=dict(os.environ, PYTHONPATH=ROOT),
                          capture_output=True, text=True, timeout=BENCH_TIMEOUT_S)
    secs = time.perf_counter() - t0
    lines = proc.stdout.splitlines()
    check(proc.returncode == 0 and len(lines) == 1,
          f"python -m tpu_cnn_torch.bench: exit {proc.returncode}, stdout "
          f"{proc.stdout[-2000:]!r}, stderr {proc.stderr[-3000:]}")
    line = json.loads(lines[0])
    check(list(line) == BENCH_KEYS and line["value"] > 0,
          f"the bench printed {lines[0]}")
    detail = json.loads(proc.stderr.strip().splitlines()[-1])
    child_launches = detail["launches"]
    check(child_launches.get("mega_cnn", 0) > 0
          and child_launches.get("cam_head", 0) > 0,
          f"the bench launched no megakernel or no CAM head: {detail}")
    phase("bench", f"{card}: python -m tpu_cnn_torch.bench ({secs:.1f} s): "
                   f"{lines[0]}")
    phase("bench", f"passes {detail['passes_fps']!r} FPS; nvcc {detail['build_s']!r} "
                   f"s; gate {detail['gate_s']!r} s; the child's launches "
                   f"{detail['launches']}")

    dev = torch.device("cuda", 0)
    art_dir = ARTIFACTS["lyr3-std"]
    model = load_model(art_dir)
    engine = CUDAEngine(model, dev, backend="mega")
    path = bench.production_path(engine)

    def flipped(gate):
        out = path(torch.from_numpy(gate).to(dev))
        out[0][0, 0, 0] ^= 1  # one flipped bit
        return out

    err = bench_gate.run_parity_gate(flipped, model,
                                     bench_gate.load_gate_images(art_dir))
    check(err is not None and "features" in err,
          f"the gate let one flipped feature bit through: {err}")
    fn, (images,) = graft_entry.entry(dev)
    pred, conf, probs, bbox = (t.cpu().numpy() for t in fn(images))
    want = engine.detect_batch(images.cpu().numpy())
    check(pred.shape == (8,) and bbox.shape == (8, 4)
          and np.array_equal(pred, want.pred) and np.array_equal(bbox, want.bbox),
          "graft_entry.entry() disagrees with CUDAEngine(mega).detect_batch")
    phase("bench", f"the gate on the card's production path with one feature "
                   f"bit flipped: {err!r}; graft_entry.entry() on {dev}: "
                   f"pred and bbox of its 8 frames equal to "
                   f"CUDAEngine(mega).detect_batch")
    return child_launches


# ── the mesh axes: MeshEngine, the CLIs, the dry run, the multi-process
# engine, and the deployable on a host without nvcc ────────────────────

MESH_BATCH = {"lyr3-std": BENCH_BATCH, "lyr4-wide": 256}
MESH_XLA_BATCH = 256  # the xla backend's plain contract on 4 positions
MULTIHOST_FEEDS = (37, 11)  # each rank's frames: uneven


def _card_positions(n: int) -> list:
    return [torch.device("cuda", 0)] * n


def _same_detect(tag: str, got, want) -> None:
    check(np.array_equal(got.pred, want.pred)
          and np.array_equal(got.bbox, want.bbox)
          and np.allclose(got.probs, want.probs, rtol=0, atol=SCORE_TOL),
          f"{tag}: detect differs from CUDAEngine(mega)")


def _same_multi(tag: str, got, want) -> None:
    same = (np.array_equal(got.pred, want.pred)
            and np.array_equal(got.boxes, want.boxes)
            and np.allclose(got.probs, want.probs, rtol=0, atol=SCORE_TOL))
    for a, b in ((got.inst_boxes, want.inst_boxes),
                 (got.inst_counts, want.inst_counts)):
        same = same and (a is None) == (b is None) and (
            a is None or np.array_equal(a, b))
    if want.scores is not None:
        same = same and np.allclose(got.scores, want.scores, rtol=0,
                                    atol=SCORE_TOL)
    check(same, f"{tag}: multi detect differs from CUDAEngine(mega)")


def mesh_engine_path(variant: str) -> None:
    """MeshEngine(mega) on make_mesh() (the one real device) and on two
    positions of cuda:0 against CUDAEngine(mega) at MESH_BATCH shipped and
    noise frames: run_batch bit-equal, detect_batch and detect_multi_batch
    (instances 1, 2) under the gate; every detect launches each of the
    family's kernels once per position."""
    model = load_model(ARTIFACTS[variant], variant)
    imgs = _frames(variant, MESH_BATCH[variant], 31)
    ref = CUDAEngine(model, device="cuda", backend="mega")
    want_f = ref.run_batch(imgs)
    want_d = ref.detect_batch(imgs)
    want_m = {i: ref.detect_multi_batch(imgs, instances=i) for i in (1, 2)}
    for mesh_ in (make_mesh(), make_mesh(devices=_card_positions(2))):
        eng = MeshEngine(model, mesh_, backend="mega")
        tag = f"{variant} {eng.backend}"
        check(np.array_equal(eng.run_batch(imgs), want_f),
              f"{tag}: features differ from CUDAEngine(mega)")
        before = {k: MODULES[k].launches for k in MEGA_KERNELS[variant]}
        got = eng.detect_batch(imgs)
        per_call = {k: MODULES[k].launches - n for k, n in before.items()}
        check(all(n == mesh_.size for n in per_call.values()),
              f"{tag}: one detect launched {per_call}, not one per position")
        _same_detect(tag, got, want_d)
        for i, want in want_m.items():
            _same_multi(f"{tag} instances {i}", eng.detect_multi_batch(
                imgs, instances=i), want)
        phase("mesh", f"{tag} batch {len(imgs)}: features bit-equal, detect "
                      f"and multi (instances 1, 2) equal to CUDAEngine(mega); "
                      f"launches per detect {per_call}")
    del ref
    torch.cuda.empty_cache()


def mesh_xla_path() -> None:
    """MeshEngine(xla) on four positions of cuda:0 with model axis 2 (the
    conv kernels split by output channel, the fc feature dimension split):
    the plain contract, equal to CUDAEngine(mega) under the gate."""
    model = load_model(ARTIFACTS["lyr3-std"], "lyr3-std")
    imgs = _frames("lyr3-std", MESH_XLA_BATCH, 37)
    ref = CUDAEngine(model, device="cuda", backend="mega")
    eng = MeshEngine(model, make_mesh(model_axis=2, devices=_card_positions(4)),
                     backend="xla")
    check(np.array_equal(eng.run_batch(imgs), ref.run_batch(imgs)),
          f"{eng.backend}: features differ from CUDAEngine(mega)")
    _same_detect(eng.backend, eng.detect_batch(imgs), ref.detect_batch(imgs))
    _same_multi(eng.backend, eng.detect_multi_batch(imgs, instances=2),
                ref.detect_multi_batch(imgs, instances=2))
    phase("mesh", f"lyr3-std {eng.backend} batch {len(imgs)}: features "
                  f"bit-equal, detect and multi (instances 2) equal to "
                  f"CUDAEngine(mega)")


def dryrun_path() -> None:
    done = dryrun_mesh(4, _card_positions(4))
    phase("mesh", "dryrun_mesh on 4 positions of cuda:0: " + "; ".join(
        f"{k} {v}" for k, v in done.items()) + ": each equal to the single "
        "device")


_MULTIHOST_CHILD = r"""
import json, sys
import numpy as np, torch
from tpu_cnn_torch.apps.common import load_model
from tpu_cnn_torch.ops import mega
from tpu_cnn_torch.parallel import multihost as mh
rank, world, port, art_dir, frames, out = sys.argv[1:7]
rank, world = int(rank), int(world)
mh.init_multihost(f"127.0.0.1:{port}", world, rank)
imgs = np.load(frames)
eng = mh.MultiHostEngine(load_model(art_dir), backend="mega",
                         devices=[torch.device("cuda", 0)])
feats = eng.run_batch(imgs)
res = eng.detect_batch(imgs)
n0 = 5 if rank == 0 else 0  # a tick where only rank 0 feeds
tick = eng.detect_batch(imgs[:n0])
everyone = mh.allgather_to_host(res.pred)
np.savez(out, feats=feats, pred=res.pred, probs=res.probs, bbox=res.bbox,
         tick_pred=tick.pred, everyone=everyone)
mh.shutdown_multihost()
print(json.dumps({"backend": eng.backend, "launches": mega.launches}))
"""


def multihost_path() -> None:
    """Two processes on the card joined over gloo, each a MultiHostEngine
    on cuda:0, on uneven local batches (MULTIHOST_FEEDS), then a tick where
    rank 1 feeds 0 frames: each rank's own rows equal to the host oracle
    (features bit-equal, predictions and boxes equal), the empty rank gets
    an empty result, and allgather_to_host gives both ranks every row.
    Each child has a time limit and is killed on failure."""
    model = load_model(ARTIFACTS["lyr3-std"], "lyr3-std")
    bundle = bundle_of("lyr3-std")
    d = os.path.join(ROOT, "build", "chip_smoke", "multihost")
    os.makedirs(d, exist_ok=True)
    imgs = _frames("lyr3-std", sum(MULTIHOST_FEEDS), 41)
    parts = np.split(imgs, np.cumsum(MULTIHOST_FEEDS)[:-1])
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs = []
    try:
        for rank, part in enumerate(parts):
            np.save(os.path.join(d, f"frames{rank}.npy"), part)
            procs.append(subprocess.Popen(
                [sys.executable, "-c", _MULTIHOST_CHILD, str(rank),
                 str(len(parts)), str(port), ARTIFACTS["lyr3-std"],
                 os.path.join(d, f"frames{rank}.npy"),
                 os.path.join(d, f"out{rank}.npz")],
                cwd=ROOT, env=dict(os.environ, PYTHONPATH=ROOT),
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
        outs = [p.communicate(timeout=300) for p in procs]
    finally:
        for p in procs:  # a wedged rank must not outlive the phase
            if p.poll() is None:
                p.kill()
                p.communicate()
    infos = []
    for rank, (p, (stdout, stderr)) in enumerate(zip(procs, outs)):
        check(p.returncode == 0, f"MultiHostEngine rank {rank}: exit "
                                 f"{p.returncode}: {stderr[-3000:]}")
        infos.append(json.loads(stdout.splitlines()[-1]))
        check(infos[-1]["launches"] > 0, f"rank {rank} launched no mega_cnn")
    for rank, part in enumerate(parts):
        got = np.load(os.path.join(d, f"out{rank}.npz"))
        feats = oracle_feats(part, bundle.kernels, model.shifts)
        idx = classify_np(feats, bundle.fc_weight, bundle.fc_bias)[0]
        boxes = np.asarray([cam_bbox_fast(f, int(i), bundle.fc_weight,
                                          img_size=128)
                            for f, i in zip(feats, idx)])
        check(np.array_equal(got["feats"], feats)
              and np.array_equal(got["pred"], idx)
              and np.array_equal(got["bbox"], boxes),
              f"MultiHostEngine rank {rank}: its rows differ from the oracle")
        check(got["tick_pred"].shape == ((5,) if rank == 0 else (0,)),
              f"rank {rank}: the uneven tick gave {got['tick_pred'].shape}")
        check(np.array_equal(got["everyone"], np.concatenate(
            [np.load(os.path.join(d, f"out{r}.npz"))["pred"]
             for r in range(len(parts))])),
              f"rank {rank}: allgather_to_host differs")
    phase("mesh", f"MultiHostEngine in 2 gloo processes on cuda:0 "
                  f"({infos[0]['backend']}): local batches "
                  f"{list(MULTIHOST_FEEDS)} and a tick of 5 and 0, each "
                  f"rank's rows equal to the host oracle; child mega_cnn "
                  f"launches {[i['launches'] for i in infos]}")


_NVCC_FREE_CHILD = r"""
import json, os, shutil, sys
import numpy as np
from tpu_cnn_torch.ops import _build

def hidden():
    raise _build.KernelBuildError("nvcc hidden")

# PATH, CUDA_HOME and CUDA_PATH are cleared; the toolkit's default path
# cannot be taken off a running machine, so the lookup refuses as well
_build._nvcc = hidden
from tpu_cnn_torch.deploy import DeployedDetector
from tpu_cnn_torch.ops import conv_pool, mega
det = DeployedDetector.load(sys.argv[1], "cuda")
out = det.detect(np.load(sys.argv[2]))
np.savez(sys.argv[3], pred=out[0], conf=out[1], probs=out[2], bbox=out[3])
print(json.dumps({
    "installed": det.installed, "nvcc": shutil.which("nvcc"),
    "cuda_home": os.environ.get("CUDA_HOME"),
    "launches": {"mega_cnn": mega.launches, "conv_pool_layer": conv_pool.launches}}))
"""


def nvcc_free_deploy_path() -> None:
    """The lyr3-std .tcnnx of the deploy path on a host without the CUDA
    toolkit: the cached kernel libraries moved aside (put back after), a
    child with PATH, CUDA_HOME and CUDA_PATH cleared of the toolkit loads
    it, installs the container's sm_90a library into the empty cache and
    detects, equal to CUDAEngine(mega)."""
    src = deploy_file("lyr3-std")
    check(os.path.exists(src), "the lyr3-std deployable was not exported")
    with zipfile.ZipFile(src) as z:
        entries = json.loads(z.read("manifest.json"))["kernel_libraries"]
    check([e["name"] for e in entries] == ["mega_cnn"]
          and all(e["arch"] == _build.ARCH for e in entries),
          f"the container lists {entries}")
    aside = os.path.join(ROOT, "build", "chip_smoke", "aside")
    os.makedirs(aside, exist_ok=True)
    moved = [p for p in glob.glob(os.path.join(_build.build_dir(), "lib*.so"))
             if not os.path.basename(p).startswith("libtcnn_host_")]
    staged = os.path.join(DEPLOY_DIR, "lyr3-std_images.npy")
    result = os.path.join(DEPLOY_DIR, "lyr3-std_nvcc_free.npz")
    env = {k: v for k, v in os.environ.items()
           if k not in ("CUDA_HOME", "CUDA_PATH")}
    env["PATH"] = os.pathsep.join(p for p in env.get("PATH", "").split(os.pathsep)
                                  if "cuda" not in p.lower())
    env["PYTHONPATH"] = ROOT
    for p in moved:
        os.replace(p, os.path.join(aside, os.path.basename(p)))
    try:
        proc = subprocess.run([sys.executable, "-c", _NVCC_FREE_CHILD, src,
                               staged, result], cwd=ROOT, env=env,
                              capture_output=True, text=True, timeout=600)
    finally:
        for p in moved:
            os.replace(os.path.join(aside, os.path.basename(p)), p)
    check(proc.returncode == 0, f"the nvcc-free child: exit {proc.returncode}: "
                                f"{proc.stderr[-3000:]}")
    child = json.loads(proc.stdout.splitlines()[-1])
    check(child["installed"] == ["mega_cnn"] and child["nvcc"] is None
          and child["cuda_home"] is None and child["launches"]["mega_cnn"] > 0,
          f"the nvcc-free child: {child}")
    imgs = np.load(staged)
    want = CUDAEngine(load_model(ARTIFACTS["lyr3-std"], "lyr3-std"),
                      device="cuda", backend="mega").detect_batch(imgs)
    got = np.load(result)
    check(np.array_equal(got["pred"], want.pred)
          and np.array_equal(got["bbox"], want.bbox)
          and np.allclose(got["probs"], want.probs, rtol=0, atol=SCORE_TOL),
          "the nvcc-free deployable's detect != CUDAEngine(mega)")
    phase("deploy", f"lyr3-std deployable with nvcc hidden ({len(moved)} "
                    f"cached kernel libraries moved aside): the child "
                    f"installed {child['installed']} from the container, "
                    f"launched {child['launches']}, and detected {len(imgs)} "
                    f"images equal to CUDAEngine(mega)")


def mesh_times(card: str, rs) -> None:
    """lyr3-std at batch 1536, async-pipelined as bench.py: CUDAEngine(mega)
    against MeshEngine(mega) on the one real device and on two positions
    of cuda:0, in turns engine, mesh 1, mesh 2, mesh 2, mesh 1, engine
    (one pass of 52 rounds each): the mesh wrapper's overhead on one card,
    not a scaling figure."""
    model = load_model(ARTIFACTS["lyr3-std"], "lyr3-std")
    engines = {"engine": CUDAEngine(model, device="cuda", backend="mega"),
               "mesh 1": MeshEngine(model, make_mesh(), backend="mega"),
               "mesh 2": MeshEngine(model, make_mesh(devices=_card_positions(2)),
                                    backend="mega")}
    pools = {k: _staged_pools(e, rs) for k, e in engines.items()}
    fps = {k: [] for k in engines}
    for k in ("engine", "mesh 1", "mesh 2", "mesh 2", "mesh 1", "engine"):
        e = engines[k]
        fps[k].append(_pipelined_fps(e.detect_batch_async, e.detect_resolve,
                                     pools[k]))
    phase("7 times", f"lyr3-std detect async-pipelined batch {BENCH_BATCH} on "
                     f"{card}: CUDAEngine(mega) {fps['engine']!r} FPS; "
                     f"MeshEngine(mega) on make_mesh() {fps['mesh 1']!r}, on 2 "
                     f"positions of cuda:0 {fps['mesh 2']!r} (one card: the "
                     f"wrapper's overhead, not scaling)")
    del engines, pools
    torch.cuda.empty_cache()


def mesh_profile(card: str, rs) -> None:
    """torch.profiler over one lyr3-std detect of MeshEngine(mega) on two
    positions of cuda:0 at batch 1536: the megakernel once per position,
    and no plain version (``quant.conv3x3_same``'s im2col)."""
    model = load_model(ARTIFACTS["lyr3-std"], "lyr3-std")
    eng = MeshEngine(model, make_mesh(devices=_card_positions(2)), backend="mega")
    staged = eng.stage_batch(rs.randint(0, 256, (BENCH_BATCH, 128, 128))
                             .astype(np.uint8))
    eng.detect_resolve(eng.detect_batch_async(staged))  # warm-up
    cuda = torch.autograd.DeviceType.CUDA
    act = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=act) as prof:
        eng.detect_resolve(eng.detect_batch_async(staged))
        torch.cuda.synchronize()
    names: dict[str, int] = {}
    for e in prof.events():
        if e.device_type == cuda:
            names[e.name] = names.get(e.name, 0) + 1
    n_mega = sum(n for name, n in names.items() if "mega_cnn_kernel" in name)
    plain = [name for name in names if "im2col" in name.lower()]
    check(n_mega == 2 and not plain,
          f"the 2-position mesh detect launched {n_mega} megakernels, plain "
          f"kernels {plain}: {names}")
    phase("7 times", f"MeshEngine(mega) on 2 positions of cuda:0, one detect "
                     f"at batch {BENCH_BATCH} on {card}, torch.profiler: "
                     f"mega_cnn_kernel x{n_mega}, no im2col; "
                     f"{sum(names.values())} device kernels of {len(names)} "
                     f"kinds (the head's)")


REALPHOTO = os.path.join(ROOT, "artifacts", "realphoto")
TRAIN_BINS = os.path.join(REALPHOTO, "train_bins")
VAL_BINS = os.path.join(REALPHOTO, "val_bins")
RECIPE_DIR = os.path.join(ROOT, "build", "chip_smoke", "recipe")
PARITY_TILES = 256  # train parity: the first tiles of train_bins, lyr3-std
LOSS_RTOL = 1e-3  # per-epoch mean loss, card against CPU
PARAM_ATOL = 1e-4  # the CPU tests' two-level tolerance: within this, or
FAR_SHARE = 1e-3   # at most this share of elements off, each < 2 lr steps
RECIPE_FLOOR = 85.0  # held-out % of the retrained bins head (a TPU: 95.9)
RETRAIN_TOL = 1e-4  # retrain_classifier --optimizer ref, card against CPU
CAL_TOL = 1e-3  # calibrate_multi: F1s and heads, mega against --mode cpu
CAL_FLAGS = [(), ("--fit-head",), ("--fit-head", "--real")]
# the JAX trainer's lyr3-std initial parameters at --seed 0, raw f32 in the
# order conv0, conv1, conv2, fc_w, fc_b (tests/test_torch_train.py holds
# the file equal to tpu_cnn.train.train_cnn.init_params at PRNGKey(0))
JAX_DRAW = os.path.join(ROOT, "tests", "data", "jax_init_lyr3-std_seed0.f32")
_RECIPE: dict[str, str] = {}


def jax_seed0_draw() -> dict[str, np.ndarray]:
    """The JAX trainer's lyr3-std --seed 0 draw, as a parameter dict."""
    shapes = {f"conv{i}": (oc, ic, 3, 3)
              for i, (ic, oc, _) in enumerate(get_config("lyr3-std").layer_configs)}
    shapes.update(fc_w=(6, 64), fc_b=(6,))
    flat = np.fromfile(JAX_DRAW, "<f4")
    sizes = [int(np.prod(s)) for s in shapes.values()]
    check(flat.size == sum(sizes), f"{JAX_DRAW}: {flat.size} floats, not {sum(sizes)}")
    parts = np.split(flat, np.cumsum(sizes)[:-1])
    return {k: v.reshape(s) for (k, s), v in zip(shapes.items(), parts)}


def _phase1(imgs, labels, dev: torch.device, dtype: str):
    """The trainer's phase 1 for 2 epochs at batch 64 from one
    ``init_params`` draw (seed 0): its optimiser, step, permutation and
    staging on ``dev``. Returns (per-epoch mean losses, final parameters,
    optimiser updates)."""
    cfg = train_cnn.TrainConfig(epochs=2, batch_size=64)
    net = train_cnn.init_params(cfg, torch.Generator().manual_seed(0)).to(dev)
    steps = len(imgs) // cfg.batch_size
    opt = train_cnn.AdamCosine(cfg.lr, cfg.epochs * steps)
    state = opt.init(net.params())
    step = train_cnn.make_train_step(cfg, opt, compute_dtype=dtype)
    rng = np.random.RandomState(cfg.seed)
    means = []
    for _ in range(cfg.epochs):
        losses = [step(net, state, bi, bl)[0] for bi, bl in train_cnn._prefetch_to_device(
            batches(imgs, labels, cfg.batch_size, rng), dev)]
        means.append(float(np.mean(torch.stack(losses).cpu().numpy())))
    return np.asarray(means), train_cnn.params_to_numpy(net), state["count"]


def train_parity(dev: torch.device) -> None:
    """lyr3-std phase 1 on the card (f32, TF32 off) against the CPU from
    the same draw on the first PARITY_TILES real-photo tiles; bf16 on the
    card finite and falling; the TF32 flags as they were."""
    imgs, labels = BinFolderDataset(TRAIN_BINS).arrays()
    imgs, labels = imgs[:PARITY_TILES], labels[:PARITY_TILES]
    def float_flags():
        return (torch.backends.cudnn.allow_tf32,
                torch.backends.cuda.matmul.allow_tf32,
                torch.backends.cudnn.deterministic)

    flags = float_flags()
    t0 = time.perf_counter()
    card, card_p, updates = _phase1(imgs, labels, dev, "float32")
    t_card = time.perf_counter() - t0
    check(float_flags() == flags, f"the trainer left the TF32 and cuDNN "
                                  f"flags at {float_flags()}, not {flags}")
    host, host_p, _ = _phase1(imgs, labels, torch.device("cpu"), "float32")
    rel = float(np.abs(card - host).max() / np.abs(host).max())
    check(rel <= LOSS_RTOL, f"train parity: epoch losses {card} on the card, "
                            f"{host} on the CPU")
    far_limit = 2 * train_cnn.TrainConfig().lr * updates
    worst, far = 0.0, 0
    for k, want in host_p.items():
        diff = np.abs(card_p[k] - want)
        worst = max(worst, float(diff.max()))
        far += int((diff > PARAM_ATOL).sum())
        check((diff > PARAM_ATOL).mean() <= FAR_SHARE and diff.max() < far_limit,
              f"train parity: {k} off by up to {diff.max()!r}, "
              f"{int((diff > PARAM_ATOL).sum())} of {diff.size} elements past "
              f"{PARAM_ATOL}")
    bf16, _, _ = _phase1(imgs, labels, dev, "bfloat16")
    check(np.isfinite(bf16).all() and bf16[-1] < bf16[0],
          f"train parity: bf16 epoch losses {bf16}")
    phase("train", f"phase 1, lyr3-std, {PARITY_TILES} real-photo tiles, 2 "
                   f"epochs at batch 64: card f32 losses {card.tolist()} vs CPU "
                   f"{host.tolist()} (within {rel:.2e} relative, tolerance "
                   f"{LOSS_RTOL}); parameters within {worst!r} ({far} elements "
                   f"past {PARAM_ATOL}); TF32 and deterministic flags unchanged "
                   f"{flags}; bf16 "
                   f"losses {bf16.tolist()}; card f32 run {t_card:.2f} s")


def _percent(line: str) -> float:
    return float(line.rsplit("=", 1)[1].strip().rstrip("%"))


def recipe_path() -> None:
    """The README's real-photo recipe through the port's CLIs on the card:
    train_cnn --augment (30 epochs), dump_features --mode mega,
    retrain_classifier --optimizer adam, infer --mode mega on the held-out
    tiles (the GAP head before the retrain, the bins head after).

    Phase 1 starts from the JAX trainer's --seed 0 draw (carried across,
    as the CPU tests carry parameters), the one behind the reference's
    recorded result: the held-out accuracy depends on the initial draw
    (PERF.md §6, scripts/recipe_seeds.py), and the port's torch stream
    draws other numbers at the same seed."""
    shutil.rmtree(RECIPE_DIR, ignore_errors=True)
    walls = {}
    draw = jax_seed0_draw()
    own_init = train_cnn.init_params
    train_cnn.init_params = lambda cfg, generator: train_cnn.params_from_numpy(draw)
    t0 = time.perf_counter()
    try:
        bundle, text = _quiet(train_cnn.main, ["--bin-folder", TRAIN_BINS,
                                               "--val-bin-folder", VAL_BINS,
                                               "--augment", "--output-dir",
                                               RECIPE_DIR])
    finally:
        train_cnn.init_params = own_init
    walls["train_cnn"] = time.perf_counter() - t0
    check(bundle is not None, "train_cnn returned no bundle")
    best_line = next(ln.strip() for ln in text.splitlines() if "best val acc" in ln)
    decoded = art.load_bundle(RECIPE_DIR)
    check(decoded.fc_weight.shape == (6, 64) and decoded.shifts == [2, 4, 6]
          and [k.shape for k in decoded.kernels] == [k.shape for k in bundle.kernels],
          "the trained bundle does not decode to its own shapes")
    infer_argv = ["--mode", "mega", "--device", "cuda", "--artifacts", RECIPE_DIR,
                  "--image-dir", VAL_BINS, "--no-save"]
    t0 = time.perf_counter()
    gap_line = _accuracy_line(infer_argv)
    walls["infer (GAP)"] = time.perf_counter() - t0
    feats = os.path.join(RECIPE_DIR, "train_features.npz")
    t0 = time.perf_counter()
    _quiet(dump_features.main, ["--mode", "mega", "--device", "cuda",
                                "--artifacts", RECIPE_DIR, "--image-dir",
                                TRAIN_BINS, "--output", feats])
    walls["dump_features"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    (w, _, _), _ = _quiet(retrain_classifier.main, [
        "--features", feats, "--optimizer", "adam", "--device", "cuda",
        "--output-dir", RECIPE_DIR, "--classes",
        os.path.join(RECIPE_DIR, "classes.json")])
    walls["retrain_classifier"] = time.perf_counter() - t0
    check(w.shape == (6, 1024), f"the retrained head is {w.shape}")
    t0 = time.perf_counter()
    bins_line = _accuracy_line(infer_argv)
    walls["infer (bins)"] = time.perf_counter() - t0
    check(_percent(bins_line) >= RECIPE_FLOOR,
          f"recipe: the retrained bins head scores {bins_line} held out, "
          f"under {RECIPE_FLOOR}%")
    _RECIPE["features"] = feats
    phase("train", f"recipe (train_cnn --augment, 30 epochs, from the JAX "
                   f"trainer's seed-0 draw; dump_features "
                   f"--mode mega; retrain_classifier --optimizer adam; infer "
                   f"--mode mega): phase 1 {best_line}; held out, GAP head "
                   f"{gap_line}, retrained bins head {bins_line} (floor "
                   f"{RECIPE_FLOOR}%); walls "
                   + ", ".join(f"{k} {v:.2f} s" for k, v in walls.items()))


def retrain_ref_path() -> None:
    """retrain_classifier --optimizer ref on the recipe's dump, on the card
    against the CPU."""
    runs = {}
    for device in ("cuda", "cpu"):
        t0 = time.perf_counter()
        (w, b, acc), _ = _quiet(retrain_classifier.main, [
            "--features", _RECIPE["features"], "--device", device, "--output-dir",
            os.path.join(ROOT, "build", "chip_smoke", f"retrain_{device}"),
            "--classes", os.path.join(RECIPE_DIR, "classes.json")])
        runs[device] = (w, b, acc, time.perf_counter() - t0)
    (w, b, acc, t_card), (hw, hb, hacc, t_host) = runs["cuda"], runs["cpu"]
    err = max(float(np.abs(w - hw).max()), float(np.abs(b - hb).max()))
    check(err <= RETRAIN_TOL and acc == hacc,
          f"retrain --optimizer ref: weights off by {err}, accuracy {acc} vs {hacc}")
    phase("train", f"retrain_classifier --optimizer ref --device cuda vs cpu: "
                   f"weights within {err!r} (tolerance {RETRAIN_TOL}), "
                   f"accuracy {acc!r}% on both; {t_card:.2f} s vs {t_host:.2f} s")


_CHILD = r"""
import contextlib, importlib, io, pickle, sys, time
sys.path.insert(0, sys.argv[1])
main = importlib.import_module(sys.argv[2]).main
t0 = time.perf_counter()
with contextlib.redirect_stdout(io.StringIO()):
    result = main(sys.argv[4:])
with open(sys.argv[3], "wb") as f:
    pickle.dump((result, time.perf_counter() - t0), f)
"""
CHILD_THREADS = "2"  # OpenMP threads of each calibrate_multi child


def _start_child(module: str, argv, tag: str):
    """Run ``module.main(argv)`` in a child process beside this process's
    work, with CHILD_THREADS OpenMP threads (the host oracle's). Returns a
    function that waits for the child (killing it past its time) and gives
    main's result and the child's own wall time."""
    out = os.path.join(ROOT, "build", "chip_smoke", f"child_{tag}.pickle")
    os.makedirs(os.path.dirname(out), exist_ok=True)
    proc = subprocess.Popen([sys.executable, "-c", _CHILD, ROOT, module, out,
                             *argv], stdout=subprocess.DEVNULL,
                            stderr=subprocess.PIPE, text=True,
                            env=dict(os.environ, OMP_NUM_THREADS=CHILD_THREADS))

    def wait():
        try:
            _, err = proc.communicate(timeout=600)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
        check(proc.returncode == 0, f"{module} {' '.join(argv)}: exit "
                                    f"{proc.returncode}: {err[-2000:]}")
        with open(out, "rb") as f:  # written by the child above
            return pickle.load(f)

    return wait


def tune_path() -> None:
    """tune_shifts at its defaults (27 candidates) on --mode mega against
    --mode cpu: the same best candidate, each candidate's val accuracy
    within one image."""
    runs = {}
    for mode in ("mega", "cpu"):
        t0 = time.perf_counter()
        (best, results), _ = _quiet(tune_shifts.main, ["--mode", mode,
                                                       "--device", "cuda"])
        runs[mode] = (best, results, time.perf_counter() - t0)
    (best, results, t_mega), (hbest, hresults, t_cpu) = runs["mega"], runs["cpu"]
    got = {c: a for c, a, _ in results}
    want = {c: a for c, a, _ in hresults}
    one = 1 / 48  # 240 images, 48 held out per candidate
    worst = max(abs(got[c] - want[c]) for c in want)
    check(best == hbest and got.keys() == want.keys() and len(got) == 27
          and worst <= one + 1e-12,
          f"tune_shifts --mode mega: best {best} vs {hbest}, accuracies off by "
          f"up to {worst}")
    phase("train", f"tune_shifts --mode mega vs --mode cpu (27 candidates): "
                   f"best {best} at {got[best]:.4f} on both, accuracies within "
                   f"{worst!r}; {t_mega:.2f} s vs {t_cpu:.2f} s")


def calibrate_paths() -> None:
    """calibrate_multi plain, --fit-head and --fit-head --real on --mode
    mega against --mode cpu (the three in child processes, at the same
    time): the floors equal, the F1s and the fitted head within CAL_TOL."""
    waits = [_start_child("tpu_cnn_torch.apps.calibrate_multi",
                          ["--mode", "cpu", "--device", "cuda", *flags], str(i))
             for i, flags in enumerate(CAL_FLAGS)]
    got = []
    try:
        for flags in CAL_FLAGS:
            t0 = time.perf_counter()
            res, _ = _quiet(calibrate_multi.main, ["--mode", "mega", "--device",
                                                   "cuda", *flags])
            got.append((res, time.perf_counter() - t0))
    finally:
        wanted = [wait() for wait in waits]
    for flags, (res, t_mega), (want, t_cpu) in zip(CAL_FLAGS, got, wanted):
        _same_calibration(flags, res, want, t_mega, t_cpu)


def _same_calibration(flags, got, want, t_mega, t_cpu) -> None:
    tag = " ".join(("calibrate_multi --mode mega", *flags))
    check(np.array_equal(got[0], want[0]),
          f"{tag}: floors {got[0]} vs --mode cpu {want[0]}")
    f1s = {k: (v[2], want[1][k][2]) for k, v in got[1].items()
           if isinstance(v, tuple)}
    if "val_f1" in got[1]:  # --fit-head: the selection too
        f1s["val_f1"] = (got[1]["val_f1"], want[1]["val_f1"])
        check((got[1]["init"], got[1]["wd"]) == (want[1]["init"], want[1]["wd"]),
              f"{tag}: selected {got[1]['init']} wd {got[1]['wd']}, --mode cpu "
              f"{want[1]['init']} wd {want[1]['wd']}")
    f1_err = max(abs(a - b) for a, b in f1s.values())
    head_err = 0.0
    if len(got) == 3:
        head_err = max(float(np.abs(a - b).max()) for a, b in zip(got[2], want[2]))
    check(f1_err <= CAL_TOL and head_err <= CAL_TOL,
          f"{tag}: F1s off by {f1_err}, head by {head_err}")
    held = f1s["eval_head" if len(got) == 3 else "calibrated_eval"][0]
    phase("train", f"{tag} vs --mode cpu: floors equal "
                   f"{[round(float(t), 2) for t in got[0]]}, F1s within "
                   f"{f1_err!r}, head within {head_err!r} (tolerance {CAL_TOL}); "
                   f"held-out F1 {held!r}; {t_mega:.2f} s vs {t_cpu:.2f} s "
                   f"(in a child, {CHILD_THREADS} OpenMP threads)")


TRAIN_MESH_BATCH = 256  # the training mesh paths: the first real-photo tiles
TRAIN_MESH_STEPS = 4  # one step held to the plain step, then 3 more: falling
# the training layouts on positions of cuda:0: (name, mesh, step options)
TRAIN_MESH_LAYOUTS = [
    ("dp 2", lambda: make_mesh(devices=_card_positions(2)), {}),
    ("dp x tp 2x2", lambda: make_mesh(model_axis=2, devices=_card_positions(4)), {}),
    ("zero1 4", lambda: make_mesh(devices=_card_positions(4)), {"zero1": True}),
    ("pipe 3", lambda: make_pipeline_mesh(3, devices=_card_positions(3)),
     {"microbatch": 32}),
    ("pipe 3 remat", lambda: make_pipeline_mesh(3, devices=_card_positions(3)),
     {"microbatch": 32, "remat": True}),
    ("pipe 2x3", lambda: make_pipeline_mesh(6, data_axis=2,
                                            devices=_card_positions(6)),
     {"microbatch": 32}),
    ("space 4", lambda: make_spatial_mesh(4, devices=_card_positions(4)), {}),
    ("space 2x4", lambda: make_spatial_mesh(8, data_axis=2,
                                            devices=_card_positions(8)), {}),
]


def _mesh_batch(dev: torch.device):
    imgs, labels = BinFolderDataset(TRAIN_BINS).arrays()
    return (torch.from_numpy(imgs[:TRAIN_MESH_BATCH]).to(dev),
            torch.from_numpy(labels[:TRAIN_MESH_BATCH].astype(np.int64)).to(dev))


def _mesh_steps(mesh, kw, bi, bl, n: int):
    """n train steps of lyr3-std from the JAX trainer's seed-0 draw with
    Adam at the trainer's lr: (losses, parameters after the first step,
    the optimiser state, the step)."""
    cfg = train_cnn.TrainConfig()
    net = train_cnn.params_from_numpy(jax_seed0_draw(), device=bi.device)
    opt = train_cnn.AdamCosine(cfg.lr)
    state = opt.init(net.params())
    step = train_cnn.make_train_step(cfg, opt, mesh, **kw)
    losses, first = [], None
    for i in range(n):
        losses.append(float(step(net, state, bi, bl)[0]))
        if i == 0:
            first = train_cnn.params_to_numpy(net)
    return losses, first, state, lambda: step(net, state, bi, bl)


def _held_to(tag: str, loss, params, want_loss, want_params) -> str:
    """train_parity's tolerance for one step against the plain step: the
    loss within LOSS_RTOL, the parameters within PARAM_ATOL or at most
    FAR_SHARE of them off, each by under 2 lr."""
    rel = abs(loss - want_loss) / abs(want_loss)
    check(rel <= LOSS_RTOL, f"{tag}: loss {loss!r}, the plain step's {want_loss!r}")
    limit = 2 * train_cnn.TrainConfig().lr
    worst, far = 0.0, 0
    for k, want in want_params.items():
        diff = np.abs(params[k] - want)
        off = diff > PARAM_ATOL
        check(off.mean() <= FAR_SHARE and diff.max() < limit,
              f"{tag}: {k} off by up to {diff.max()!r}, {int(off.sum())} of "
              f"{diff.size} elements past {PARAM_ATOL}")
        worst, far = max(worst, float(diff.max())), far + int(off.sum())
    return f"loss within {rel:.1e} rel, params within {worst:.1e} ({far} past {PARAM_ATOL})"


def train_mesh_path(dev: torch.device) -> None:
    """Every training layout on positions of cuda:0 at lyr3-std full width
    (128x128, 1->16->32->64), batch TRAIN_MESH_BATCH real-photo tiles,
    from the JAX trainer's seed-0 draw: its first step held to the plain
    step on the card (_held_to), then 3 more steps, the loss falling; the
    ZeRO-1 moments held as one block per data position."""
    bi, bl = _mesh_batch(dev)
    plain, plain_p, _, _ = _mesh_steps(None, {}, bi, bl, TRAIN_MESH_STEPS)
    check(plain[-1] < plain[0], f"the plain step's losses {plain} do not fall")
    lines = []
    for name, make, kw in TRAIN_MESH_LAYOUTS:
        mesh = make()
        losses, first, state, _ = _mesh_steps(mesh, kw, bi, bl, TRAIN_MESH_STEPS)
        line = _held_to(name, losses[0], first, plain[0], plain_p)
        check(losses[-1] < losses[0], f"{name}: losses {losses} do not fall")
        if kw.get("zero1"):
            mu = state["mu"]["conv0"]
            check(isinstance(mu, RowShards) and len(mu.parts) == 4,
                  f"{name}: conv0's moments are {type(mu).__name__}, not 4 blocks")
            line += "; moments in 4 blocks"
        lines.append(f"{name} {mesh.devices.shape}: {line}, losses "
                     f"{losses[0]:.5f} -> {losses[-1]:.5f}")
    phase("train mesh", f"lyr3-std batch {TRAIN_MESH_BATCH}, one step per layout "
                        f"on positions of cuda:0 against the plain step (losses "
                        f"{plain[0]:.5f} -> {plain[-1]:.5f}): " + "; ".join(lines))


def train_cli_sharded_path() -> None:
    """train_cnn --device cuda --mesh 1 --zero1 --checkpoint DIR on the
    real-photo tiles for 2 epochs, then --resume --epochs 3: the resume
    line says "(sharded) at epoch 2", steps 2 and 3 are kept, a bundle is
    exported."""
    out = os.path.join(ROOT, "build", "chip_smoke", "train_sharded")
    ck = os.path.join(out, "ckpt")
    shutil.rmtree(out, ignore_errors=True)
    argv = ["--device", "cuda", "--mesh", "1", "--zero1", "--checkpoint", ck,
            "--bin-folder", TRAIN_BINS, "--val-bin-folder", VAL_BINS,
            "--output-dir", out]
    t0 = time.perf_counter()
    _, text = _quiet(train_cnn.main, argv + ["--epochs", "2"])
    check("Mesh: 1 data x 1 model over 1 devices" in text, text[-2000:])
    bundle, text = _quiet(train_cnn.main, argv + ["--epochs", "3", "--resume"])
    wall = time.perf_counter() - t0
    resumed = next((ln for ln in text.splitlines() if "Resumed from" in ln), "")
    check("(sharded) at epoch 2" in resumed and bundle is not None
          and os.path.exists(os.path.join(out, "weights.bin")),
          f"the sharded resume: {text[-2000:]}")
    check(sorted(os.listdir(ck)) == ["2", "3"], f"kept steps {os.listdir(ck)}")
    phase("train mesh", f"train_cnn --mesh 1 --zero1 --checkpoint DIR, 2 epochs "
                        f"then --resume --epochs 3: '{resumed.strip()}', steps "
                        f"2 and 3 kept, bundle exported; {wall:.2f} s")


def infer_sharded_bundle_path() -> None:
    """infer --mode mega on the bundle of train_cli_sharded_path."""
    out = os.path.join(ROOT, "build", "chip_smoke", "train_sharded")
    acc = _accuracy_line(["--mode", "mega", "--device", "cuda", "--artifacts", out,
                          "--image-dir", VAL_BINS, "--no-save"])
    phase("train mesh", f"infer --mode mega on the sharded run's bundle: {acc}")


_TRAIN_CHILD = r"""
import json, sys
import numpy as np, torch, torch.distributed as dist
from tpu_cnn_torch.parallel import multihost as mh
from tpu_cnn_torch.parallel.mesh import make_mesh
from tpu_cnn_torch.train import train_cnn as T
from tpu_cnn_torch.train.checkpoint_sharded import ShardedCheckpointer
rank, world, port, data, out, ck = sys.argv[1:7]
rank, world = int(rank), int(world)
mh.init_multihost(f"127.0.0.1:{port}", world, rank)
d = np.load(data)
dev = torch.device("cuda", 0)
mesh = make_mesh(devices=[dev])
cfg = T.TrainConfig()
res = {}
for tag, zero1 in (("dp", False), ("zero1", True)):
    net = T.params_from_numpy({k: d[k] for k in ("conv0", "conv1", "conv2",
                                                 "fc_w", "fc_b")}, device=dev)
    opt = T.AdamCosine(cfg.lr)
    state = opt.init(net.params())
    (bi, bl), = mh.global_batches(mesh, [(d["images"], d["labels"])])
    loss, _ = T.make_train_step(cfg, opt, mesh, zero1=zero1)(
        net, state, torch.from_numpy(bi).to(dev), torch.from_numpy(bl).to(dev))
    res[tag + "_loss"] = float(loss)
    res.update({f"{tag}_{k}": v for k, v in T.params_to_numpy(net).items()})
blocks = {k: (v.first, len(v.parts)) for k, v in state["mu"].items()}
with ShardedCheckpointer(ck) as c:
    c.save(1, net.params(), state, 0.5, net.params())
dist.barrier()  # every piece in place before anyone restores
like = T.AdamCosine(cfg.lr).init(net.params())
T.zero1_constrain(like, mesh)
p, o, epoch, acc, _ = ShardedCheckpointer(ck).restore(net.params(), like)
same = (epoch, acc) == (1, 0.5) and all(
    torch.equal(a, b) for g in ("mu", "nu") for k in o[g]
    for a, b in zip(o[g][k].parts, state[g][k].parts)) and all(
    torch.equal(p[k], v) for k, v in net.params().items())
np.savez(out, **res)
mh.shutdown_multihost()
print(json.dumps({"blocks": blocks, "restored": bool(same)}))
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_ranks(argvs, tag: str, timeout: float = 600) -> list[str]:
    """One process per argv, each with a time limit and killed on failure;
    returns their standard outputs."""
    procs = []
    try:
        for argv in argvs:
            procs.append(subprocess.Popen(
                [sys.executable, *argv], cwd=ROOT,
                env=dict(os.environ, PYTHONPATH=ROOT), stdout=subprocess.PIPE,
                stderr=subprocess.PIPE, text=True))
        outs = [p.communicate(timeout=timeout) for p in procs]
    finally:
        for p in procs:  # a wedged rank must not outlive the phase
            if p.poll() is None:
                p.kill()
                p.communicate()
    for rank, (p, (_, err)) in enumerate(zip(procs, outs)):
        check(p.returncode == 0, f"{tag} rank {rank}: exit {p.returncode}: "
                                 f"{err[-3000:]}")
    return [o for o, _ in outs]


def multihost_train_path(dev: torch.device) -> None:
    """Two gloo processes on cuda:0, one position each: one global step
    through global_batches (dp, then ZeRO-1 with the moments' blocks split
    across the processes), the parameters bit-equal across ranks and held
    to the single-process plain step (_held_to); a ShardedCheckpointer
    round trip of the ZeRO-1 state under both ranks; then the train_cnn
    CLI with --num-processes 2 for one epoch, both ranks exiting 0 and
    only the primary writing its bundle."""
    d = os.path.join(ROOT, "build", "chip_smoke", "multihost_train")
    shutil.rmtree(d, ignore_errors=True)
    os.makedirs(d)
    bi, bl = _mesh_batch(dev)
    draw = jax_seed0_draw()
    data = os.path.join(d, "data.npz")
    np.savez(data, images=bi.cpu().numpy(), labels=bl.cpu().numpy(), **draw)
    port = _free_port()
    t0 = time.perf_counter()
    outs = _run_ranks([["-c", _TRAIN_CHILD, str(r), "2", str(port), data,
                        os.path.join(d, f"step{r}.npz"), os.path.join(d, "ckpt")]
                       for r in range(2)], "multi-process step")
    infos = [json.loads(o.splitlines()[-1]) for o in outs]
    plain, plain_p, _, _ = _mesh_steps(None, {}, bi, bl, 1)
    got = [np.load(os.path.join(d, f"step{r}.npz")) for r in range(2)]
    lines = []
    for tag in ("dp", "zero1"):
        p0 = {k: got[0][f"{tag}_{k}"] for k in plain_p}
        check(all(np.array_equal(p0[k], got[1][f"{tag}_{k}"]) for k in p0),
              f"multi-process {tag} step: the ranks' parameters differ")
        lines.append(f"{tag} " + _held_to(f"multi-process {tag}",
                                         float(got[0][f"{tag}_loss"]), p0,
                                         plain[0], plain_p))
    check([i["blocks"]["conv0"] for i in infos] == [[0, 1], [1, 1]]
          and all(i["restored"] for i in infos),
          f"multi-process ZeRO-1 blocks or restore: {infos}")
    t_step = time.perf_counter() - t0
    port = _free_port()
    t0 = time.perf_counter()
    _run_ranks([["-m", "tpu_cnn_torch.train.train_cnn", "--device", "cuda",
                 "--num-processes", "2", "--coordinator", f"127.0.0.1:{port}",
                 "--process-id", str(r), "--epochs", "1", "--bin-folder",
                 TRAIN_BINS, "--val-bin-folder", VAL_BINS, "--output-dir",
                 os.path.join(d, f"bundle{r}")] for r in range(2)],
               "train_cnn --num-processes 2")
    check(os.path.exists(os.path.join(d, "bundle0", "weights.bin"))
          and not os.path.exists(os.path.join(d, "bundle1")),
          "train_cnn --num-processes 2: the bundle was not written by the "
          "primary alone")
    phase("train mesh", f"2 gloo processes on cuda:0, batch {TRAIN_MESH_BATCH} "
                        f"split by global_batches: ranks bit-equal; "
                        + "; ".join(lines) + f"; ZeRO-1 blocks "
                        f"{[i['blocks']['conv0'] for i in infos]} restored by "
                        f"both ({t_step:.2f} s); train_cnn --num-processes 2 "
                        f"--epochs 1: both exit 0, the primary alone exported "
                        f"({time.perf_counter() - t0:.2f} s)")


def dryrun_train_path() -> None:
    done = dryrun_train(4, _card_positions(4))
    phase("train mesh", "dryrun_train on 4 positions of cuda:0: " + "; ".join(
        f"{k} {v}" for k, v in done.items()))


def train_mesh_times(card: str) -> None:
    """ms per train step at batch TRAIN_MESH_BATCH (lyr3-std, 128x128) of
    each layout against the plain step, in turns plain, layout, layout,
    plain (3 steps each after one warm-up, host clock around
    synchronised steps), on positions of cuda:0: one card, so the mesh's
    overhead, not scaling."""
    dev = torch.device("cuda", 0)
    bi, bl = _mesh_batch(dev)
    plain_step = _mesh_steps(None, {}, bi, bl, 1)[3]

    def ms(step, n: int = 3) -> float:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            step()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / n * 1e3

    rows = []
    for name, make, kw in TRAIN_MESH_LAYOUTS:
        step = _mesh_steps(make(), kw, bi, bl, 1)[3]
        t = {"plain": [], name: []}
        for k in ("plain", name, name, "plain"):
            t[k].append(ms(plain_step if k == "plain" else step))
        rows.append(f"{name} {statistics.median(t[name]):.2f} ms (plain "
                    f"{statistics.median(t['plain']):.2f} ms)")
    phase("7 times", f"train step, lyr3-std batch {TRAIN_MESH_BATCH} on {card}, "
                     f"positions of cuda:0 (one card: the mesh's overhead, not "
                     f"scaling): " + "; ".join(rows))


def per_layer_agreement(phase7: dict[int, float]) -> None:
    """The benchmark's ``--per-layer --modes pallas`` rows against phase 7's
    pooled conv_act medians on the same lyr3-std layers at the same batch."""
    rows = [r for r in _BENCH["per_layer"] if r["layer"] != "head"]
    text = []
    for r in rows:
        ref = phase7[r["layer"]]
        rel = abs(r["ms"] - ref) / ref
        check(rel <= PER_LAYER_TOL,
              f"benchmark --per-layer L{r['layer']} {r['ms']!r} ms vs phase 7 "
              f"{ref!r} ms: {rel:.1%} apart")
        text.append(f"L{r['layer']} {r['ms']!r} vs {ref!r} ms ({rel:.1%})")
    phase("7 times", f"benchmark --per-layer --modes pallas rows against phase "
                     f"7's pooled conv_act, batch {BENCH_BATCH}: "
                     + "; ".join(text) + f" (within {PER_LAYER_TOL:.0%})")


def preprocess_times(dev: torch.device, card: str, rs) -> None:
    """``preprocess_frames`` at batch PREPROCESS_BATCH on 640x480 BGR and
    packed frames on the card: CUDA events, median, with the byte bound
    (the frames read once, the 128^2 outputs written once)."""
    b, h, w = PREPROCESS_BATCH, 480, 640
    f4 = rs.randint(0, 256, (b, h, w, 4)).astype(np.uint8)
    for form, x in (("BGR", torch.from_numpy(np.ascontiguousarray(f4[..., :3]))),
                    ("packed", torch.from_numpy(pack_bgrx(f4).view(np.int32)))):
        x = x.to(dev)

        def run():
            return dev_preprocess.preprocess_frames(x, 128)

        run()
        torch.cuda.synchronize()
        runs = _event_ms(run, 20) + _event_ms(run, 20)
        ms = statistics.median(runs)
        b_ms, b_by = bound(0, x.numel() * x.element_size() + b * 128 * 128)
        phase("7 times", f"preprocess_frames {form} {w}x{h} -> 128^2 batch {b} "
                         f"on {card}: median {ms!r} ms (n={len(runs)}), "
                         f"{ms * 1e3 / b!r} us/frame; bound {b_ms!r} ms by "
                         f"{b_by}, {b_ms / ms:.2%} of it")


def realtime_times(card: str) -> None:
    """The realtime loop's EMA FPS and median engine ms on lyr3-std mega,
    fused and on the host-head protocol, REALTIME_TIMED_FRAMES synthetic
    frames each; then the same loop's stages timed one by one (the
    synthetic source, the host preprocess, the detect, the overlay). Both
    are host-bound per-frame loops, as in the reference."""
    for flags in (("--mode", "mega", "--fused"), ("--mode", "mega")):
        _, stats = _run_realtime(_realtime_argv("lyr3-std", flags,
                                                REALTIME_TIMED_FRAMES))
        check(stats["frames"] == REALTIME_TIMED_FRAMES, f"realtime {flags}: {stats}")
        phase("7 times", f"realtime lyr3-std {' '.join(flags)} --device cuda, "
                         f"{REALTIME_TIMED_FRAMES} synthetic 640x480 frames on "
                         f"{card}: EMA {stats['fps']!r} FPS, median conv_ms "
                         f"{stats['conv_ms']!r}")
    model = load_model(ARTIFACTS["lyr3-std"], "lyr3-std")
    engine = infer.make_engine(model, "mega", "cuda")
    engine.warmup()
    pre_fn, pre_name = realtime.resolve_preprocess()
    src = realtime.SyntheticSource(640, 480)
    timer = StageTimer()
    for _ in range(REALTIME_TIMED_FRAMES):
        with timer.stage("source"):
            frame = src.read()
        with timer.stage(f"preprocess ({pre_name})"):
            small = pre_fn(frame, 128)
        with timer.stage("detect (fused)"):
            r = realtime.detect_frame(engine, model, small, fused=True)
        with timer.stage("overlay"):
            realtime.draw_overlay(frame, r.idx, r.name, r.conf, r.probs, r.bbox,
                                  0.0, r.conv_ms, r.read_ms, "mega", model.class_names)
    phase("7 times", f"realtime lyr3-std --mode mega --fused loop stages, "
                     f"{REALTIME_TIMED_FRAMES} frames on {card}, mean host ms: "
                     + "; ".join(f"{k} {timer.mean_ms(k)!r}" for k in timer.totals))


def _event_ms(fn, n: int) -> list[float]:
    out = []
    for _ in range(n):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        out.append(start.elapsed_time(end))
    return out


def _queued_ms(fn, n: int = 50) -> float:
    """Device ms per call of ``fn`` for calls far shorter than their host
    cost: a device-side spin holds the stream while the host queues ``n``
    calls between two events, so the events time the device's work back
    to back and not the host's launches. The spin doubles until the start
    event is still pending when the last call is queued."""
    cycles = 1 << 22
    while True:
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(n):
            fn()
        end.record()
        held = not start.query()
        end.synchronize()
        if held:
            return start.elapsed_time(end) / n
        check(cycles < 1 << 32, "the device spin never outlasted the host")
        cycles *= 2


def _kernel_and_plain_ms(kernel, plain, n_kernel: int = 20,
                         n_plain: int = 5) -> tuple[float, float, int, int]:
    """Medians of CUDA-event times, in turns plain, kernel, kernel, plain,
    so both see the same card state."""
    for fn in (kernel, plain):  # warm-up
        fn()
    torch.cuda.synchronize()
    p_ms = _event_ms(plain, n_plain)
    k_ms = _event_ms(kernel, n_kernel) + _event_ms(kernel, n_kernel)
    p_ms += _event_ms(plain, n_plain)
    return statistics.median(k_ms), statistics.median(p_ms), len(k_ms), len(p_ms)


def _queued_and_plain_ms(kernel, plain, n_kernel: int = 5,
                         n_plain: int = 3) -> tuple[float, float, int, int]:
    """For kernels of a few hundred microseconds: the kernel's median device
    time per call with the calls queued (``_queued_ms``; a window around
    one call would also time the host's launch of it), the plain version's
    median CUDA-event time per call, in turns plain, kernel, plain."""
    for fn in (kernel, plain):  # warm-up
        fn()
    torch.cuda.synchronize()
    p_ms = _event_ms(plain, n_plain)
    k_ms = [_queued_ms(kernel) for _ in range(n_kernel)]
    p_ms += _event_ms(plain, n_plain)
    return statistics.median(k_ms), statistics.median(p_ms), len(k_ms), len(p_ms)


def _staged_pools(engine, rs) -> list:
    """The bench's 4 pools of BENCH_BATCH frames (``bench.draw_pools``),
    each staged by the engine (``stage_batch``)."""
    return [engine.stage_batch(a) for a in
            bench.draw_pools(rs, BENCH_BATCH, img_size=engine.model.config.img_size)]


def _pipelined_fps(dispatch, resolve, pools) -> float:
    """One warm-up call, then one pass of the bench's async pipeline
    (``bench.measure``: 52 rounds over the pools, all dispatched, then
    all resolved)."""
    resolve(dispatch(pools[0]))
    fps, results = bench.measure(dispatch, resolve, pools, BENCH_BATCH)
    check(len(results) == bench.ROUNDS and results[0].pred.shape == (BENCH_BATCH,),
          "pipelined detect returned the wrong shapes")
    return fps


def deploy_times(card: str, rs) -> None:
    """The deployable's detect (the lyr3-std and lyr4-wide ``mega``
    containers of the deploy paths: numpy in, numpy out) against
    ``CUDAEngine(mega).detect_batch``, the live engine's sync call, at
    each exported bucket; host clock, in turns deployable, engine, engine,
    deployable, 10 calls each, median per call."""
    for variant in MEGA_KERNELS:
        model = load_model(ARTIFACTS[variant], variant)
        if not os.path.exists(deploy_file(variant)):  # times() on its own
            os.makedirs(DEPLOY_DIR, exist_ok=True)
            _quiet(export_model.main, ["--variant", variant, "--output",
                                       deploy_file(variant), "--batch",
                                       DEPLOY_BATCHES])
        det = DeployedDetector.load(deploy_file(variant), "cuda")
        engine = CUDAEngine(model, device="cuda", backend="mega")
        s = model.config.img_size
        for b in (int(v) for v in DEPLOY_BATCHES.split(",")):
            imgs = rs.randint(0, 256, (b, s, s)).astype(np.uint8)
            calls = {"deployable": lambda: det.detect(imgs),
                     "engine": lambda: engine.detect_batch(imgs)}
            ms = {k: [] for k in calls}
            for k in calls:  # warm-up
                calls[k]()
            for k in ("deployable", "engine", "engine", "deployable"):
                for _ in range(10):
                    t0 = time.perf_counter()
                    calls[k]()
                    ms[k].append((time.perf_counter() - t0) * 1e3)
            d_ms, e_ms = (statistics.median(ms[k]) for k in calls)
            phase("7 times", f"{variant} mega deployable detect batch {b} on "
                             f"{card}: median {d_ms!r} ms per sync call (n=20) "
                             f"vs CUDAEngine.detect_batch {e_ms!r} ms (n=20), "
                             f"ratio {d_ms / e_ms:.3f}")
        del det, engine
        torch.cuda.empty_cache()


def engine_fps(variant: str, backend: str, rs) -> list[float]:
    """The bench's async pipeline on the engine's ``detect_batch_async``:
    52 rounds over 4 staged pools, 3 passes."""
    engine = CUDAEngine(load_model(ARTIFACTS[variant], variant), device="cuda",
                        backend=backend)
    pools = _staged_pools(engine, rs)
    return [_pipelined_fps(engine.detect_batch_async, engine.detect_resolve,
                           pools) for _ in range(3)]


def multi_times(card: str, rs, profile_out: str | None) -> None:
    """lyr3-std on mega at batch 1536: single-box, multi and multi with two
    instances, async-pipelined FPS in turns on one engine; then a profile
    of the instance head."""
    engine = CUDAEngine(load_model(ARTIFACTS["lyr3-std"], "lyr3-std"),
                        device="cuda")
    pools = _staged_pools(engine, rs)
    modes = {
        "single-box": (engine.detect_batch_async, engine.detect_resolve),
        "multi, instances 1": (
            lambda h: engine.detect_multi_batch_async(h, instances=1),
            engine.detect_multi_resolve),
        "multi, instances 2": (
            lambda h: engine.detect_multi_batch_async(h, instances=2),
            engine.detect_multi_resolve),
    }
    fps = {m: [] for m in modes}
    for _ in range(3):
        for m, (dispatch, resolve) in modes.items():
            fps[m].append(_pipelined_fps(dispatch, resolve, pools))
    for m, v in fps.items():
        phase("7 times", f"lyr3-std engine (mega) {m} detect async-pipelined "
                         f"batch {BENCH_BATCH} on {card}: best {max(v)!r} FPS "
                         f"of {v!r}")

    n_batches = 4
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        handles = [engine.detect_multi_batch_async(pools[i % 4], instances=2)
                   for i in range(n_batches)]
        for h in handles:
            engine.detect_multi_resolve(h)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / n_batches
    events = prof.events()
    cuda = torch.autograd.DeviceType.CUDA
    spans = ("multi_cam_stack", "connected_labels", "grow_labels",
             "component_stats")  # record_function spans of ops.detect_head

    def kernel_us(e) -> float:
        """Device time of the kernels a host op and its callees launched."""
        return (sum(k.duration for k in e.kernels)
                + sum(kernel_us(c) for c in e.cpu_children))

    def per_batch(*names) -> tuple[float, float, float]:
        """(kernel ms, host ms, calls) per batch of the host ops named."""
        sel = [e for e in events if e.device_type != cuda and e.name in names]
        return (sum(kernel_us(e) for e in sel) / 1e3 / n_batches,
                sum(e.cpu_time_total for e in sel) / 1e3 / n_batches,
                len(sel) / n_batches)

    def device_ms(pred) -> float:
        return sum(e.time_range.elapsed_us() for e in events
                   if e.device_type == cuda and e.name not in spans
                   and pred(e.name)) / 1e3 / n_batches

    split = {
        **{f"span {r}": per_batch(r) for r in spans},
        "CAM bmm (aten::bmm)": per_batch("aten::bmm"),
        "topk (aten::topk)": per_batch("aten::topk"),
        "sort + cummax/cummin": per_batch("aten::sort", "aten::cummax",
                                          "aten::cummin"),
        "label-loop syncs (aten::equal)": per_batch("aten::equal"),
        "stream syncs (cudaStreamSynchronize)": per_batch("cudaStreamSynchronize"),
    }
    text = "; ".join(f"{k}: kernels {d:.3f} ms, host {c:.3f} ms, {n:g} calls"
                     for k, (d, c, n) in split.items())
    # each label loop syncs once (torch.equal) per block of LABEL_BLOCK steps
    steps = {r: sum(c.name == "aten::equal" for e in events if e.name == r
                    for c in e.cpu_children) * detect_head.LABEL_BLOCK / n_batches
             for r in ("connected_labels", "grow_labels")}
    phase("7 times", f"lyr3-std multi --instances 2 profile, {n_batches} "
                     f"batches of {BENCH_BATCH} on {card}, per batch: device "
                     f"kernels {device_ms(lambda n: True):.3f} ms (megakernel "
                     f"{device_ms(lambda n: 'mega_cnn_kernel' in n):.3f} ms) in "
                     f"a profiled host wall of {wall_ms:.3f} ms; {text}; label "
                     f"steps connected {steps['connected_labels']:g}, grow "
                     f"{steps['grow_labels']:g}")
    if profile_out is None:
        return
    rows = prof.key_averages()
    sort_key = ("self_device_time_total"
                if hasattr(rows[0], "self_device_time_total")
                else "self_cuda_time_total")
    with open(profile_out, "w") as f:
        f.write(rows.table(sort_by=sort_key, row_limit=60))
        f.write(rows.table(sort_by="cpu_time_total", row_limit=60))


def bitcast_times(dev: torch.device, card: str, rs) -> tuple[float, float]:
    """The bitcast kernel's three functions against their plain versions at
    (4096, 4096), 64 MiB of words in and 64 MiB out per call, so that the
    queued calls read and write HBM and not the 50 MB L2: device time per
    call, queued (each call takes tens of microseconds of device time and
    more on the host), medians of 10 runs each, in turns plain, kernel,
    plain. Returns the summed (kernel, plain) ms."""
    r, l = BITCAST_SHAPES[-1]
    x = torch.from_numpy(rs.randint(-2**31, 2**31, (r, l), dtype=np.int64)
                         .astype(np.int32)).to(dev)
    x8 = torch.from_numpy(rs.randint(0, 256, (4 * r, l)).astype(np.uint8)).to(dev)
    total = [0.0, 0.0]
    for name, kernel, plain in (
            ("narrow", lambda: bitcast.narrow_i32_to_i8(x),
             lambda: bitcast.narrow_i32_to_i8_reference(x)),
            ("widen", lambda: bitcast.widen_u8_to_i32(x8),
             lambda: bitcast.widen_u8_to_i32_reference(x8)),
            ("roll 3", lambda: bitcast.packed_roll(x, 3),
             lambda: bitcast.packed_roll_reference(x, 3))):
        p_runs = [_queued_ms(plain) for _ in range(5)]
        k_runs = [_queued_ms(kernel) for _ in range(10)]
        p_runs += [_queued_ms(plain) for _ in range(5)]
        k_ms, p_ms = statistics.median(k_runs), statistics.median(p_runs)
        gbs = 2 * r * l * 4 / (k_ms * 1e-3) / 1e9
        phase("7 times", f"bitcast {name} ({r}, {l}) on {card}, device time "
                         f"per call, 50 calls queued: kernel median {k_ms!r} ms "
                         f"(n={len(k_runs)}, {gbs:.0f} GB/s in+out), plain "
                         f"median {p_ms!r} ms (n={len(p_runs)})")
        total[0] += k_ms
        total[1] += p_ms
    return total[0], total[1]


def pallas_profile(card: str, rs) -> None:
    """torch.profiler over the lyr3-std ``pallas`` pass (the features of
    ``CUDAEngine(backend="pallas")``) at batch 1536: the device kernels it
    launches, by name. It must launch the conv kernel once per layer and
    no torch pool (``quant.maxpool2x2``'s ``aten::amax`` reduction, whose
    kernel names are read from one profiled call of it first)."""
    engine = CUDAEngine(load_model(ARTIFACTS["lyr3-std"], "lyr3-std"),
                        device="cuda", backend="pallas")
    x = engine._to_device(rs.randint(0, 256, (BENCH_BATCH, 128, 128))
                          .astype(np.uint8))[0]
    cuda = torch.autograd.DeviceType.CUDA
    act = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    probe = torch.zeros((2, 16, 8, 8), dtype=torch.uint8, device=x.device)
    with torch.profiler.profile(activities=act) as prof:
        quant.maxpool2x2(probe)
        torch.cuda.synchronize()
    pool_kernels = {e.name for e in prof.events() if e.device_type == cuda}
    engine.features_device(x)  # warm-up
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=act) as prof:
        engine.features_device(x)
        torch.cuda.synchronize()
    events = prof.events()
    names: dict[str, int] = {}
    for e in events:
        if e.device_type == cuda:
            names[e.name] = names.get(e.name, 0) + 1
    amax = sum(e.name == "aten::amax" for e in events if e.device_type != cuda)
    conv = sum(n for name, n in names.items() if "conv_layer_kernel" in name)
    check(pool_kernels and not pool_kernels & set(names) and amax == 0,
          f"the lyr3-std pallas pass ran a torch pool: {names}, aten::amax {amax}")
    check(conv == len(engine.net.kernels),
          f"the lyr3-std pallas pass launched {conv} conv kernels: {names}")
    phase("7 times", f"lyr3-std pallas pass (batch {BENCH_BATCH}) on {card}, "
                     f"torch.profiler: device kernels {names}; torch pool "
                     f"kernels {sorted(pool_kernels)} launched 0 times, "
                     f"aten::amax {amax}")


_PROFILE_CHILD = r"""
import sys
import numpy as np
import chip_smoke as cs
cs.pallas_profile(sys.argv[1], np.random.RandomState(7))
cs.mesh_profile(sys.argv[1], np.random.RandomState(7))
"""


def bench_profile(card: str) -> None:
    """torch.profiler over one extra, untimed pass of the bench's loop
    (``bench.pipelined`` and ``bench.measure`` on the bench's timed path,
    lyr3-std at batch 1536, 52 rounds over the bench's 4 pools): the
    device's busy share of the pass's host wall (the union of its device
    events' spans) and the three device operations that take most of it,
    to show whether the loop is host-paced."""
    dev = torch.device("cuda", 0)
    engine = CUDAEngine(load_model(ARTIFACTS["lyr3-std"]), dev, backend="mega")
    detect = bench.timed_path(engine)
    pools = [torch.from_numpy(a).to(dev)
             for a in bench.draw_pools(np.random.RandomState(0))]
    like = detect(pools[0])  # the warm-up
    torch.cuda.synchronize()
    dispatch = bench.pipelined(detect, like, bench.ROUNDS)
    cuda = torch.autograd.DeviceType.CUDA
    act = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=act) as prof:
        fps, _ = bench.measure(dispatch, bench.wait_copies, pools, bench.BATCH)
    wall_ms = bench.ROUNDS * bench.BATCH / fps * 1e3
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == cuda)
    if not spans:
        phase("7 times", f"the bench's loop under torch.profiler on {card}: no "
                         f"device events recorded: busy share not measured")
        return
    busy_us, end = 0.0, spans[0][0]
    for a, b in spans:  # the union of the spans
        busy_us += max(0.0, b - max(a, end))
        end = max(end, b)
    by_name: dict[str, list] = {}
    for e in prof.events():
        if e.device_type == cuda:
            t = by_name.setdefault(e.name, [0.0, 0])
            t[0] += e.time_range.elapsed_us() / 1e3
            t[1] += 1
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:3]
    phase("7 times", f"the bench's loop, one untimed pass under torch.profiler "
                     f"on {card} (lyr3-std batch {bench.BATCH}, {bench.ROUNDS} "
                     f"rounds): {fps!r} FPS under the profiler; device busy "
                     f"{busy_us / 1e3!r} ms of a {wall_ms!r} ms host wall "
                     f"({busy_us / 1e3 / wall_ms:.2%}); top device operations: "
                     + "; ".join(f"{_kernel_name(name)} {ms!r} ms, "
                                 f"{ms * 1e3 / busy_us:.1%} of busy ({n} calls)"
                                 for name, (ms, n) in top))


def _kernel_name(name: str) -> str:
    """A device operation's name, a kernel's without its return type and
    parameter list."""
    name = name.replace("(anonymous namespace)::", "")
    if name.startswith("void "):
        name = name[5:].split("(", 1)[0]
    return name[:100]


def cam_head_times(dev: torch.device, card: str, rs) -> tuple:
    """The CAM head kernel at each family's offline round (lyr3-std 16,384
    frames, lyr4-wide 4,096: the benchmark's), on K1's bins and twin of
    noise frames, against the plain head (``detect_with_pooled``, "ref")
    and the HBM floor: the twin and the bins read once, the outputs
    written once. Returns lyr3-std's (kernel ms, plain ms, bound ms, bound
    by, None)."""
    out = None
    for variant, batch in kc.CAM_BATCHES.items():
        model = load_model(ARTIFACTS[variant], variant)
        engine = CUDAEngine(model, device=dev)
        size = model.config.img_size
        x = torch.from_numpy(rs.randint(0, 256, (batch, size, size))
                             .astype(np.uint8)).to(dev)
        pooled, twin = engine._mega(x, with_feats=False, with_bins=True,
                                    with_twin=True)
        del x
        w, b = engine.net.fc_weight, engine.net.fc_bias
        k_ms, p_ms, nk, np_ = _queued_and_plain_ms(
            lambda: cam_head.detect_pooled_fused(pooled, twin, w, b, size),
            lambda: detect_head.detect_with_pooled(
                None, pooled, w, b, size, features_twin=twin, box_mode="ref"))
        k = w.shape[0]
        nbytes = twin.numel() * 2 + pooled.numel() * 4 + batch * (4 + 4 + 4 * k + 16)
        b_ms, b_by = bound(0, nbytes)
        phase("7 times", f"{variant} cam_head batch {batch} on {card}: kernel "
                         f"median {k_ms!r} ms (n={nk}, queued); bound {b_ms!r} "
                         f"ms by {b_by}, {b_ms / k_ms:.2%} of it; plain median "
                         f"{p_ms!r} ms (n={np_})")
        if out is None:
            out = (k_ms, p_ms, b_ms, b_by, None)
        del pooled, twin
        torch.cuda.empty_cache()
    return out


def times(dev: torch.device, card: str,
          profile_out: str | None) -> dict[str, tuple]:
    """Returns {kernel name: (kernel ms, plain ms, bound ms, bound by,
    library ms or None)} at batch 1536: the megakernel on lyr3-std's whole
    net, the layer kernel on lyr4-wide's L0, the conv kernel on lyr3-std's
    three layers summed (and under "conv_act pooled" its pooled entry on
    them), the bitcast kernel's three functions summed."""
    rs = np.random.RandomState(0)
    # lyr3-std: the whole net in the megakernel
    bundle = art.load_bundle(ARTIFACTS["lyr3-std"])
    imgs = torch.from_numpy(
        rs.randint(0, 256, (BENCH_BATCH, 128, 128)).astype(np.uint8)).to(dev)
    ks = [torch.from_numpy(k).to(dev) for k in bundle.kernels]
    pk = mega.pack_plan(ks, 128)  # once, as CUDAEngine does
    shifts = torch.tensor((2, 4, 6), dtype=torch.int32, device=dev)
    kernel_ms, plain_ms, nk, np_ = _kernel_and_plain_ms(
        lambda: mega.cnn_forward_mega(imgs, ks, shifts, with_feats=False,
                                      with_bins=True, with_twin=True,
                                      packed=pk),
        lambda: mega.mega_reference(imgs, ks, shifts))
    cfgs3 = get_config("lyr3-std").layer_configs
    tops = macs_per_image(cfgs3) * BENCH_BATCH / (kernel_ms * 1e-3) / 1e12
    bound_ms, bound_by = layers_bound(cfgs3, BENCH_BATCH, detect_out_bytes(cfgs3))
    phase("7 times", f"lyr3-std batch {BENCH_BATCH} detect outputs on {card}: "
                     f"mega_cnn median {kernel_ms!r} ms (n={nk}, {tops:.2f} int "
                     f"TMAC/s; bound {bound_ms!r} ms by {bound_by}, "
                     f"{bound_ms / kernel_ms:.2%} of it), plain median "
                     f"{plain_ms!r} ms (n={np_})")
    out = {"mega_cnn": (kernel_ms, plain_ms, bound_ms, bound_by, None)}

    # the megakernel on the first layer alone: its one-channel input path
    def l0() -> torch.Tensor:
        return mega.cnn_forward_mega(imgs, ks[:1], shifts[:1], packed=pk[:1])

    l0()
    torch.cuda.synchronize()
    l0_runs = _event_ms(l0, 20) + _event_ms(l0, 20)
    l0_ms = statistics.median(l0_runs)
    l0_bound, l0_by = layers_bound(cfgs3[:1], BENCH_BATCH,
                                   cfgs3[0][1] * (cfgs3[0][2] // 2) ** 2)
    phase("7 times", f"lyr3-std L0 alone (1 -> 16 at 128^2, feats out) batch "
                     f"{BENCH_BATCH} on {card}: mega_cnn median {l0_ms!r} ms "
                     f"(n={len(l0_runs)}; bound {l0_bound!r} ms by {l0_by}, "
                     f"{l0_bound / l0_ms:.2%} of it)")

    # ... and on its first two layers: L1's time by difference
    def l01() -> torch.Tensor:
        return mega.cnn_forward_mega(imgs, ks[:2], shifts[:2], packed=pk[:2])

    l01()
    torch.cuda.synchronize()
    l01_runs = _event_ms(l01, 20) + _event_ms(l01, 20)
    l01_ms = statistics.median(l01_runs)
    l01_bound, l01_by = layers_bound(cfgs3[:2], BENCH_BATCH,
                                     cfgs3[1][1] * (cfgs3[1][2] // 2) ** 2)
    phase("7 times", f"lyr3-std L0+L1 (1 -> 16 -> 32 at 128^2, feats out) batch "
                     f"{BENCH_BATCH} on {card}: mega_cnn median {l01_ms!r} ms "
                     f"(n={len(l01_runs)}; bound {l01_bound!r} ms by {l01_by}, "
                     f"{l01_bound / l01_ms:.2%} of it); L1 by difference "
                     f"{l01_ms - l0_ms!r} ms, L2 and the detect outputs "
                     f"{kernel_ms - l01_ms!r} ms")
    del imgs

    # lyr4-wide: the layer kernel (L0), the megakernel (L1-L3), the chain
    cfgs = get_config("lyr4-wide").layer_configs
    bundle = bundle_of("lyr4-wide")
    imgs = torch.from_numpy(
        rs.randint(0, 256, (BENCH_BATCH, 256, 256)).astype(np.uint8)).to(dev)
    x = imgs[:, None]
    ks = [torch.from_numpy(k).to(dev) for k in bundle.kernels]
    pk = mega.pack_plan(ks, 256)  # the layer kernel's L0, K1's L1-L3
    shifts = torch.tensor((3, 5, 5, 7), dtype=torch.int32, device=dev)
    x16 = conv_pool.conv_pool_layer(x, ks[0], shifts, 0, packed=pk[0])
    detect = dict(with_feats=False, with_bins=True, with_twin=True)
    stages = {
        "layer kernel L0": (
            lambda: conv_pool.conv_pool_layer(x, ks[0], shifts, 0, packed=pk[0]),
            lambda: conv_pool.conv_pool_reference(x, ks[0], shifts, 0),
            cfgs[:1]),
        "megakernel tail L1-L3": (
            lambda: mega.cnn_forward_mega(x16, ks[1:], shifts[1:],
                                          packed=pk[1:], **detect),
            lambda: mega.mega_reference(x16, ks[1:], shifts[1:]),
            cfgs[1:]),
        "chain": (
            lambda: mega.cnn_forward_mega(imgs, ks, shifts, packed=pk,
                                          **detect),
            lambda: mega.mega_reference(imgs, ks, shifts),
            cfgs),
    }
    for stage, (kernel, plain, stage_cfgs) in stages.items():
        k_ms, p_ms, nk, np_ = _kernel_and_plain_ms(kernel, plain, 5, 3)
        tops = macs_per_image(stage_cfgs) * BENCH_BATCH / (k_ms * 1e-3) / 1e12
        _, oc, s = stage_cfgs[-1]
        b_ms, b_by = layers_bound(
            stage_cfgs, BENCH_BATCH, oc * (s // 2) ** 2 if stage == "layer kernel L0"
            else detect_out_bytes(stage_cfgs))
        phase("7 times", f"lyr4-wide {stage} batch {BENCH_BATCH} on {card}: "
                         f"kernel median {k_ms!r} ms (n={nk}, {tops:.2f} int "
                         f"TMAC/s, {k_ms * 1e3 / BENCH_BATCH!r} us/image; bound "
                         f"{b_ms!r} ms by {b_by}, {b_ms / k_ms:.2%} of it), "
                         f"plain median {p_ms!r} ms (n={np_}, "
                         f"{p_ms * 1e3 / BENCH_BATCH!r} us/image)")
        if stage == "layer kernel L0":
            out["conv_pool_layer"] = (k_ms, p_ms, b_ms, b_by, None)
    del imgs, x, x16
    torch.cuda.empty_cache()

    # the conv kernel: each lyr3-std layer and lyr4-wide's L0, unpooled
    # (conv_act) and pooled (fused_conv_layer, what `pallas` and `hybrid`
    # run); the weights packed once, as CUDAEngine does
    act_ms, pool_ms = [0.0, 0.0], [0.0, 0.0]
    for variant, layers in (("lyr3-std", (0, 1, 2)), ("lyr4-wide", (0,))):
        model = load_model(ARTIFACTS[variant], variant)
        shifts = torch.from_numpy(model.shifts).to(dev)
        for li in layers:
            ic, oc, s = model.config.layer_configs[li]
            x = torch.from_numpy(rs.randint(
                0, 256, (BENCH_BATCH, ic, s, s)).astype(np.uint8)).to(dev)
            k = torch.from_numpy(model.kernels[li]).to(dev)
            pk = mega.pack_layer(k)
            for entry, kernel, plain, out_px in (
                    ("no pool", lambda: int8.conv_act(x, k, shifts, li, packed=pk),
                     lambda: int8.conv_act_reference(x, k, shifts, li), s * s),
                    ("pooled", lambda: int8.fused_conv_layer(x, k, shifts, li, packed=pk),
                     lambda: quant.maxpool2x2(int8.conv_act_reference(x, k, shifts, li)),
                     s * s // 4)):
                k_ms, p_ms, nk, np_ = _queued_and_plain_ms(kernel, plain)
                # one call per event window, as the other kernels are timed:
                # it also times the host's launch of the call
                window_ms = statistics.median(_event_ms(kernel, 20))
                tops = oc * ic * 9 * s * s * BENCH_BATCH / (k_ms * 1e-3) / 1e12
                gbs = (ic * s * s + oc * out_px) * BENCH_BATCH / (k_ms * 1e-3) / 1e9
                b_ms, _ = layers_bound(((ic, oc, s),), BENCH_BATCH, 0,
                                       calls="unpooled" if entry == "no pool" else "pooled")
                phase("7 times", f"{variant} conv_act L{li} ({ic}->{oc} at {s}^2, "
                                 f"{entry}) batch {BENCH_BATCH} on {card}: kernel "
                                 f"median {k_ms!r} ms (device time per call, "
                                 f"50 queued; n={nk}, {tops:.2f} int "
                                 f"TMAC/s, {gbs:.0f} GB/s of u8 in+out; bound "
                                 f"{b_ms!r} ms, {b_ms / k_ms:.2%} of it; one call "
                                 f"per event window {window_ms!r} ms), plain "
                                 f"median {p_ms!r} ms (n={np_})")
                if variant == "lyr3-std":
                    tot = act_ms if entry == "no pool" else pool_ms
                    tot[0] += k_ms
                    tot[1] += p_ms
                    if entry == "pooled":
                        out.setdefault("conv_act pooled layers", {})[li] = k_ms
            del x
    a_bound, a_by = layers_bound(cfgs3, BENCH_BATCH, 0, calls="unpooled")
    p_bound, p_by = layers_bound(cfgs3, BENCH_BATCH, 0, calls="pooled")
    out["conv_act"] = (*act_ms, a_bound, a_by, None)
    out["conv_act pooled"] = (*pool_ms, p_bound, p_by, None)
    phase("7 times", f"lyr3-std conv_act L0+L1+L2 on {card}: no pool: kernel "
                     f"{act_ms[0]!r} ms, plain {act_ms[1]!r} ms; bound "
                     f"{a_bound!r} ms by {a_by}, {a_bound / act_ms[0]:.2%} of it. "
                     f"Pooled: kernel {pool_ms[0]!r} ms, plain {pool_ms[1]!r} ms; "
                     f"bound {p_bound!r} ms by {p_by}, {p_bound / pool_ms[0]:.2%} "
                     f"of it")
    torch.cuda.empty_cache()

    for variant, backend in (("lyr4-wide", "mega"), ("lyr3-std", "pallas"),
                             ("lyr3-std", "hybrid")):
        fps = engine_fps(variant, backend, rs)
        phase("7 times", f"{variant} engine ({backend}) detect async-pipelined "
                         f"batch {BENCH_BATCH} on {card}: best {max(fps)!r} "
                         f"FPS of {fps!r}")
        torch.cuda.empty_cache()
    deploy_times(card, rs)
    mesh_times(card, rs)
    multi_times(card, rs, profile_out)  # lyr3-std on mega: single-box and multi
    torch.cuda.empty_cache()
    # after every host-bound FPS: a finished torch.profiler run leaves
    # CUPTI's launch overhead behind it; in a child process: late in this
    # one, profiles on an H100 have come back without device operations
    proc = subprocess.run([sys.executable, "-c", _PROFILE_CHILD, card], cwd=ROOT,
                          env={**os.environ, "PYTHONPATH": ROOT}, capture_output=True,
                          text=True, timeout=600)
    sys.stdout.write(proc.stdout)
    check(proc.returncode == 0, f"the profiles' child: exit {proc.returncode}: "
                                f"{proc.stderr[-3000:]}")
    bench_profile(card)
    torch.cuda.empty_cache()
    r, l = BITCAST_SHAPES[-1]
    k_ms, p_ms = bitcast_times(dev, card, rs)
    b_ms, b_by = bound(0, 3 * 2 * r * l * 4)  # three calls, in + out
    phase("7 times", f"bitcast narrow + widen + roll ({r}, {l}) on {card}: "
                     f"kernel {k_ms!r} ms; bound {b_ms!r} ms by {b_by}, "
                     f"{b_ms / k_ms:.2%} of it; plain {p_ms!r} ms")
    # each plain version is one PyTorch call (torch.roll, or the copy that
    # reshape makes of a permuted byte view): its time is the library's
    out["bitcast"] = (k_ms, p_ms, b_ms, b_by, p_ms)
    torch.cuda.empty_cache()
    # no single PyTorch call computes the head: library_ms is null
    out["cam_head"] = cam_head_times(dev, card, rs)
    out.update(yolo_times(dev, card, rs))
    torch.cuda.empty_cache()
    # last: run before the pallas profile, these left its torch.profiler
    # session with no events in one run on the card
    preprocess_times(dev, card, rs)
    realtime_times(card)
    return out


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--profile-out", default=None,
                   help="also write the instance head's torch.profiler "
                        "tables (phase 7) to this file")
    args = p.parse_args(argv)
    t_start = time.perf_counter()
    card = header()
    dev = torch.device("cuda", 0)
    build()
    max_err = kernel_vs_plain(dev)
    sanitizer = sanitize_phase()

    launches = dict.fromkeys(KERNELS, 0)

    def main_path(label: str, path_kernels, *steps) -> None:
        """Run one main path's steps between zeroed and read launch
        counters: its kernels and no others must launch."""
        for module in MODULES.values():
            module.launches = 0
        t0 = time.perf_counter()
        for step in steps:
            step()
        counts = {name: module.launches for name, module in MODULES.items()}
        for name, n in counts.items():
            check((n > 0) == (name in path_kernels),
                  f"{label} main path launched {name} {n} times")
            launches[name] += n
        phase("main path", f"{label} kernel launches: {counts} "
                           f"({time.perf_counter() - t0:.1f} s)")

    for variant, backend, alt_shifts, path_kernels in PATHS:
        main_path(f"{variant}/{backend} (phases 4-6)", path_kernels,
                  lambda: engine_gate(variant, backend, alt_shifts),
                  lambda: cli(variant, backend),
                  lambda: server(variant, backend))
    main_path("probe_bitcast", ("bitcast",), probe_path)
    main_path("yolov2-tiny-voc/pallas (seeded weights)",
              ("region_layer", "conv_stream", "region_head"), lambda: yolo_engine_path(dev))
    main_path("yolov3-416/pallas (the cell's seeded bundle)",
              ("region_layer", "conv_stream", "yolo_head"), lambda: yolo3_engine_path(dev))
    main_path("yolov7-640/pallas (the cell's seeded bundle)",
              ("region_layer", "conv_stream", "yolo_head", "maxpool"),
              lambda: yolo7_engine_path(dev))
    for variant, backend, instances, path_kernels in MULTI_PATHS:
        main_path(f"{variant}/{backend} --multi --instances {instances} "
                  f"(phases 4-6)", path_kernels,
                  lambda: multi_engine(variant, backend, instances),
                  lambda: multi_cli(variant, backend, instances),
                  lambda: multi_server(variant, backend, instances))
    child = {}  # the bench child's launches, counted in its own process
    main_path("bench (python -m tpu_cnn_torch.bench, the gate's negative "
              "check, graft_entry.entry())", ("mega_cnn", "cam_head"),
              lambda: child.update(bench_path(card)))
    for name, n in child.items():
        launches[name] += n
    for variant in ARTIFACTS:
        main_path(f"{variant} engine swap (cpu, auto, --dump-features)",
                  MEGA_KERNELS[variant], lambda: engine_swap(variant))
    main_path("lyr3-std serve --mode cpu", (), lambda: host_server("lyr3-std"))
    main_path("device preprocess", (), lambda: device_preprocess(dev))
    for variant, flags, path_kernels in REALTIME_PATHS:
        main_path(f"{variant} realtime {' '.join(flags)}", path_kernels,
                  lambda: realtime_path(variant, flags))
    main_path("lyr3-std realtime --mode mega --fused, MJPEG",
              ("mega_cnn", "cam_head"), realtime_stream)
    for variant, mode, path_kernels, flag_sets in EVAL_PATHS:
        main_path(f"{variant} eval_detection --mode {mode}", path_kernels,
                  *[lambda f=f: eval_path(variant, mode, f) for f in flag_sets])
    main_path("lyr3-std eval_tracking --mode mega", ("mega_cnn",),
              *[lambda f=f: tracking_path(f) for f in TRACKING_FLAGS])
    for variant in ARTIFACTS:
        main_path(f"{variant} dump_features --mode mega", MEGA_KERNELS[variant],
                  lambda: dump_path(variant))
    main_path("lyr3-std train_bbox --mode mega", ("mega_cnn",), train_bbox_path)
    main_path("train parity (card vs CPU, f32 and bf16)", (),
              lambda: train_parity(dev))
    main_path("train recipe (train_cnn, dump_features, retrain_classifier, "
              "infer)", ("mega_cnn",), recipe_path)
    main_path("retrain_classifier --optimizer ref (card vs CPU)", (),
              retrain_ref_path)
    main_path("tune_shifts --mode mega", ("mega_cnn",), tune_path)
    main_path("calibrate_multi --mode mega", ("mega_cnn",), calibrate_paths)
    main_path("benchmark --train", (),
              *[lambda d=d: benchmark_run(("--train", "--train-dtype", d))
                for d in ("float32", "bfloat16")])
    for flags, path_kernels in BENCH_RUNS:
        main_path(f"benchmark {' '.join(flags)}", path_kernels,
                  lambda: benchmark_run(flags))
    for variant, path_kernels in MEGA_DETECT_KERNELS.items():
        main_path(f"{variant} serve_native --mode mega", path_kernels,
                  lambda: native_front_path(variant),
                  *([lambda: native_front_path(variant, 2)]
                    if variant == "lyr3-std" else []))
    for variant, path_kernels in MEGA_KERNELS.items():
        main_path(f"{variant} export_model --backend mega, the deployable "
                  f"(its kernels: {', '.join(path_kernels)}; it keeps the "
                  f"plain head, and cam_head's launches are the engine's it "
                  f"is held to), serve --deployable", MEGA_DETECT_KERNELS[variant],
                  lambda: deploy_path(variant, path_kernels,
                                      2 if variant == "lyr3-std" else 1))
    main_path("serving load (scripts/bench_serving_torch.py)",
              ("mega_cnn", "cam_head"),
              lambda: serving_load_path(card))
    main_path("benchmark --host-ingest", (), lambda: host_ingest_path(card))
    main_path("doctor", (), doctor_path)
    main_path("lyr3-std mesh (MeshEngine mega on 1 and 2 positions, xla on "
              "4)", ("mega_cnn", "cam_head"), lambda: mesh_engine_path("lyr3-std"),
              mesh_xla_path)
    main_path("lyr4-wide mesh (MeshEngine mega on 1 and 2 positions)",
              MEGA_DETECT_KERNELS["lyr4-wide"], lambda: mesh_engine_path("lyr4-wide"))
    main_path("lyr3-std infer and serve --mode mesh", ("mega_cnn", "cam_head"),
              lambda: cli("lyr3-std", "mesh"), lambda: server("lyr3-std", "mesh"))
    main_path("dryrun_mesh (4 positions of cuda:0)", ("mega_cnn", "cam_head"),
              dryrun_path)
    main_path("MultiHostEngine (2 gloo processes)", (), multihost_path)
    main_path("the deployable with nvcc hidden (in its child: K1; in this "
              "process, the engine it is held to: K1 and the CAM head)",
              ("mega_cnn", "cam_head"),
              nvcc_free_deploy_path)
    main_path("training mesh (every layout on positions of cuda:0)", (),
              lambda: train_mesh_path(dev))
    main_path("train_cnn --mesh 1 --zero1 --checkpoint DIR, --resume", (),
              train_cli_sharded_path)
    main_path("infer --mode mega on that bundle", ("mega_cnn",),
              infer_sharded_bundle_path)
    main_path("multi-process training (2 gloo processes)", (),
              lambda: multihost_train_path(dev))
    main_path("dryrun_train (4 positions of cuda:0)", (), dryrun_train_path)

    for variant in ARTIFACTS:
        verify_cli(variant)

    ms = times(dev, card, args.profile_out)
    per_layer_agreement(ms["conv_act pooled layers"])
    train_mesh_times(card)
    loaded = [m for m in sys.modules
              if m.split(".")[0] in ("jax", "tpu_cnn")]
    check(not loaded, f"the JAX package or jax was imported: {loaded[:5]}")
    # no single PyTorch call computes a convolution kernel's function (no
    # u8 x s8 convolution with the shift, clip and pool; torch._int_mm is
    # s8 x s8 after an im2col): library_ms is null for those
    rows = [{
        "name": name, "route": "cuda", "source": src, "replaces": replaces,
        "launches": launches[name], "max_abs_err": max_err[name],
        "ms": ms[name][0], "plain_ms": ms[name][1], "bound_ms": ms[name][2],
        "bound_by": ms[name][3], "library_ms": ms[name][4],
        "sanitizer": sanitizer.get(name)}
        for name, (src, replaces) in KERNELS.items()]
    # the conv kernel's pooled entry, what the pallas and hybrid paths run
    act = next(r for r in rows if r["name"] == "conv_act")
    act["pooled_ms"], act["pooled_bound_ms"] = (ms["conv_act pooled"][0],
                                                ms["conv_act pooled"][2])
    phase("wall", f"chip_smoke.py took {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
