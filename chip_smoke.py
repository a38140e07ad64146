#!/usr/bin/env python3
"""Smoke run of the PyTorch/H100 port (video_dqn_tpu_torch) on one card.

    python3 chip_smoke.py

Phases, each of which raises on failure (the run then exits non-zero and
prints no result line):
  1. environment: the card's name and power limit, torch and CUDA versions;
  2. build: nvcc compiles every kernel from the sources in the checkout;
  3. each kernel against its plain torch version on the card, at the
     shapes the serving path gives it, in float32 and bfloat16 output, with
     its profiled device time, its bound and the wrapper's host cost; and
     the NMS kernels (csrc/nms.cu: the IoU bitmask, then the scan) against
     nms_reference at the detector's shapes (B*5 RPN groups of up to 1,000
     -> 1,000, B final groups of 1,000 -> 100, B = 4 and 12), one group of
     MAX_GROUP = 12,288 -> 300, 3 groups of 5,000 -> 300, identical boxes
     (1 kept), disjoint boxes (all kept), the RPN's groups cut to 100 kept,
     and tied, -inf and one-candidate groups: keep lists and valid flags
     equal, with the two kernels' device time, the plain twin's, the bound
     from this data's IoUs and the mask workspace's bytes; unsorted groups
     keep nothing and set their status, which check_nms_status raises on;
  4. the serving path at full width: the published extra_capacity
     single-frame Q-net (configs/experiments/real_data/config.yml, 224 px,
     5 classes x 3 actions) with seeded random weights, loaded through
     load_eval_model from a .torch checkpoint, answers 12/24/48/96-view
     requests of 224x224 renders and 256x342 frames through the multiclass
     scorer's dispatch/gather with 2 requests in flight. Every request must
     go through the kernel once with bf16 output, every answer must match a
     float32 card forward of its own views within 0.05 and the same model
     under autocast fed by the kernel's float32 output within 1e-3, and the
     bf16 scores of the 12-view stops must track the port's own float32
     CPU forward;
  5. the training path at full width: the same published configuration
     (B = 256, bf16) trains through run_train on 4,096 seeded 224x224
     frames of a synthetic video (8,192 rows) in both data modes, the
     device-resident table and the host-fed pinned prefetch, with
     TARGET_UPDATE_INTERVAL, CHECKPOINT_INTERVAL and NUM_STEPS cut to 8, 10
     and 30. Every step must launch the identity kernel exactly twice with
     bf16 output and nothing else, every logged loss must be finite, the
     target must equal the online net from before the update bit for bit
     after each sync, sample10/20/30.ckpt must exist, a resume from 20
     must draw the same rows and end within 1e-3 of the first run's EMA
     loss, bf16 steps must track float32 card steps, and float32 card
     steps at 96 px must match the port's CPU steps within 1e-4. Prints
     ms/step and frames/s per mode, a profiled step with its phase split,
     and peak memory;
  6. the real-data training path on the committed fixture
     (tests/data/torch_qdata, tests/torch_qdata.py): its data.feather (512
     rows, 32 JPEG frames at 1280x720 and 640x360) read by the port's
     feather reader must give the JAX batcher's labels, index stream and
     device-table index maps in expected.npz exactly, and the port's JPEG
     stage must decode each frame within a mean |difference| of 3.0 of
     PIL's there. Then the training CLI
     (video_dqn_tpu_torch.train_q_network.main) trains the published config
     with DATASET on the fixture's wide.feather (4,096 rows over 4,320 frame
     files, links to the committed frames, so that a batch of 256 rows names
     about 496 distinct frames, as a batch of the published ~10^5-row
     dataset names up to 512), at B = 256, 224 px, bf16, cut as in phase 5,
     in both data modes, and resumes with -r from sample20 in device mode:
     the same rows and the same EMA loss. Prints the feather reads, decode
     frames/s, the device table's build time and ms/step per mode;
  7. the inverse model's training path at full width: its CLI
     (video_dqn_tpu_torch.train_inverse_model.main) trains the published
     geometry (224 px, B = 128, bf16) for 30 steps, validating every 10
     over 2 batches, on a pairs npy of 2,048 rows over 512 state folders
     (links to the committed frames, made at run time), once decoding every
     batch and once with --cache-images. Every step must launch the
     identity kernel once with bf16 output and nothing else, every scalar
     must be finite, sample10/20/30.ckpt must exist, the frozen trunk must
     be bit-unchanged after 30 Adam steps, bf16 steps must track float32
     card steps, and float32 card steps at 192 px must match the port's CPU
     steps within 1e-4. Prints ms/step and pairs/s per mode, a profiled
     step with its phase split (prologue, trunk, head, backward, Adam) and
     peak memory;
  8. the labelling path: phase 7's checkpoint labels wide.feather's 4,096
     rows through the decode-once TableInverseLabeler in bf16 (rows/s,
     decode and device time); its labels must equal float32 card labels
     where the float32 margin is at least 0.05, and float32 card labels the
     CPU's on data.feather where it is at least 1e-3. Then the
     process_episodes CLI writes a data.feather from an episode fixture
     (tests/torch_qdata.py make_episodes) with those labels, which the
     port's reader and QLearningBatcher read back, its other columns equal
     to the CPU's;
  9. evaluation: the host library (csrc/host: the FMM solver and the fake
     env's raycaster among its sources) built in phase 2; (a) a 12-view
     224x224 stop of fake-env renders mapped on the card (TF32 on and
     off) must bin its points as the CPU port does, at most 1e-4 of them
     in another cell, with the device, copy-back and host ms of a stop's
     and an agent step's mapping; (b) 4 geodesic-scored episodes at 224 px
     (make_episode_set) on the card must give the CPU port's step logs and
     SPL exactly; (c) the evaluate CLI's batched path
     (video_dqn_tpu_torch.evaluate.main) runs the published Q-net (seed
     4, a .torch file and an eval config with SCORE: model and SLAM
     written at run time) over 16 fake-env episodes at 224 px, 8 in
     flight, pipeline depth 2: every fused score call must launch the
     identity kernel once with bf16 output, every served score must lie
     within 0.05 of a float32 card forward of its own views, and the 16
     SPLs must land on disk. Prints episodes/s, ms per reasoning stop
     (median and p80) split into render, mapping (device and copy back),
     traversible, FMM, other host work and the scorer, ms per agent step,
     peak memory, and the device's idle share over a profiled run of 4
     episodes;
  10. evaluation on meshes, in the furnished two-floor house
     (make_furnished_house: rooms, doors, furniture of every target class
     on both floors, a ramp) through the mesh simulator and the host
     library's BVH raycaster (csrc/host/mesh.cc): (a) a 12-view 224x224
     stop rendered by the host library must match the numpy twin
     (TwinMesh), depth within 1e-4 and RGB within +-1 on more than 99.9% of
     the pixels, where a pixel on two coplanar faces may show either face;
     prints the render's ms for 12 views and for one; (b) 2 geodesic-scored
     episodes at 224 px, one on each floor, mapped on the card must give
     the CPU port's step logs and SPL exactly; (c) the evaluate CLI's
     batched path with --furnished-env runs the published Q-net (as in
     phase 9) over 4 episodes, 4 in flight, pipeline depth 2, with the
     checks and prints of phase 9 (c) and the idle share of a profiled run
     of 2 episodes; (d) --mesh-scene on the house written as a PLY file at
     run time runs one geodesic episode to an SPL on disk;
  11. the detector at full width (maskrcnn_resnet50_fpn, seeded
     torchvision-named weights saved as a .pth and loaded through
     load_detector, 224 px, bf16): (a) a 12-view forward with no host
     synchronize (sync debug mode "error"); a 12-view fake-env stop and 4
     fixture frames, one identity launch and two NMS launches a call;
     bf16 against float32 on the card and float32 card against the CPU,
     stage by stage on the same proposals (FPN maps, class probabilities,
     boxes) with the end-to-end twins counted; ms a 12-view call, images/s
     at B = 4 and 32, the busy share and peak memory; (b) the detection
     CLI over the fixture frames, then process_episodes on its output;
     (c) the evaluate CLI with COMBINE_DETECTOR, the seeded detector and
     the published Q-net, 4 fake-env episodes, 4 in flight: one detector
     call a stop, bumped views, episodes/s and the detector's share of a
     stop;
  12. the dataset front end: (a) the Places365 AlexNet at full width
     (seeded torchvision-named weights, the indoor classes' fc8 biases
     centring the fixture frames' indoor probabilities on 0.5, saved as a
     .pth and loaded through load_alexnet_places) behind the indoor
     classifier on 32 and 256 fixture frames at 224 px: one bf16 identity
     launch a call; bf16 against float32 on the card within 0.02 over the
     top-10 classes bf16 took, the logits within 0.15, a frame moved
     further than 0.02 only at a near tie of its 10th and 11th classes,
     the largest move no larger than the JAX package's own bf16 model's
     on these weights (tests/torch_frontend_util.py, pinned by
     tests/test_torch_filters.py) and the swapped frames at most twice its
     share; float32 card within 1e-4 of the CPU; ms a call, frames/s and
     the busy share; (b) the filter CLI (video_dqn_tpu_torch.extract_frames)
     over 40 fixture frames in 2 videos with (a)'s weights and phase 11's
     seeded detector, the person's class bias centred on the card so that
     half the fixture frames flag a person (random weights flag every
     frame or none at a fixed bias), the videos made of frames clear of
     that edge: two identity and two NMS launches a batch, resume writes
     nothing, indoor_locs equal to a CPU run's wherever the CPU's smoothed
     probability lies further than 0.02 from 0.5, every frame's person
     flag and person_locs (float32 card) equal to the CPU's, both mixed;
     then the CLI's rate in bf16 over 8 videos of 200 fixture frames
     (full batches of 32): frames/s with decode, the decode, indoor and
     detector shares, start-up apart; (c)
     generate_sim_dataset (8 videos x 100 steps) and generate_inverse_pairs
     (8 walks x 64 steps) in the furnished house at 224 px, every frame
     written by save_images read back by the port's decoder within a mean
     |difference| of 3.0 of its render; frames written/s and the encoder's
     ms a 224^2 frame; then the training and inverse CLIs take 10 steps
     each on what was written (published geometry, bf16), their losses
     finite and their launches counted;
  13. visualisation: (a) render_grid over the fake env at 224 px
     (resolution 16, 169 navigable cells; views written/s), value maps of
     the published Q-net (phase 4's seeded .torch file through
     load_eval_model) in bf16 at resolution 1500, one bf16 identity launch
     a batch of 64 cells (cells/s), within 0.05 of float32 card forwards
     of the same cells, float32 card within 1e-4 of the CPU port on 8
     cells, a panorama net over the grid once (the roll), and save_png's
     ms for a rendered and an uncropped map, read back by the port's
     reader; (b) make_allclass_scorer on a stop's 12 views of 256^2 (one
     banded launch) and 224^2 (one identity launch), within 0.05 of
     float32 card forwards; (c) the evaluate CLI with -v, one geodesic
     fake-env episode at 224 px with SLAM in STOP mode on the card and on
     the CPU: the same strip file, pixel-equal, and step logs equal the
     CPU's and the card's without -v; the same episode through run_policy
     with visualize_every 0 and 1 (the visualisation's host ms a logged
     frame); (d) the training CLI with VISUALIZATION_DATA_ROOT at (a)'s
     grid, B = 256, bf16, 10 steps on the fixture's device table: the
     steps' launches counted before the hook, 5 PNGs at the checkpoint,
     the online net's parameters, buffers and Adam's state bit-unchanged
     across the hook, train mode restored, the hook's seconds;
  14. frame extraction (tests/torch_video_fixture.py: small.mp4 160x120,
     its fragmented copy, hd720.mp4 1280x720, coding-tool clips): (a) the
     host library's demuxer and H.264 decoder give every frame's pts and
     the kept frames of libavcodec and the JAX package, each kept frame's
     NV12 planes bit-equal to libavcodec's, the plain and fragmented files
     the same frames, every frame of the coding-tool clips bit-equal, and
     CAVLC, interlaced and lossless clips refused; (b) the NV12 -> RGB
     kernel (csrc/nv12_rgb.cu) bit-equal to its twin on every kept frame in
     the CLI's batches, on planes off 16 bytes (which the wrapper copies
     first) and on seeded batches of 16 at 1280x720, 1920x1080 and
     854x480, one 1280x720 and one 1920x1080 frame and an 18x2 frame (a
     2-column tail), small.mp4's RGB equal to the JAX package's frames, and
     its device time at each of those seeded shapes against its bound
     (L2-cold too where the call fits the L2); (c) the -d CLI
     (video_dqn_tpu_torch.extract_frames) over small.mp4 and hd720.mp4, one
     kernel launch a batch of up to 16 kept frames (2), every JPEG equal to
     the JAX package's file byte for byte, a second run writing nothing,
     then the filter pass over the dumped frames; (d) hd720.mp4 at fps
     0.5 and 0: frames decoded/s, written/s and the host split (demux, decode, conversion with its
     copies, JPEG write); (e) decode_frames(fps=0.5, target=) (swscale's
     scaled bilinear path, csrc/nv12_scale_rgb.cu) on hd720.mp4 to 224x224,
     342x256 and 223x167 (odd width: full-width chroma) and on small.mp4 to
     320x240, the launches counted from 0: one scaled launch a kept frame,
     each frame bit-equal to the twin on (a)'s kept planes; small.mp4 to its
     native size launching the NV12 kernel instead, JAX's frames; the
     scaled kernel bit-equal to its twin on seeded 16 x 720p and 1 x 720p
     -> 224x224, timed against its bound;
  15. what is left of the port: (a) captions: join_images with values
     pixel-equal to the committed golden (drawn by cv2; this machine has
     none), panorama_strip captioned by the published Q-net's scores at
     224^2 (one identity launch) and 256^2 (one banded launch), a -v
     geodesic episode's current_pan at every stop equal on the card and
     the CPU; (b) TPU.REMAT: the published config, 10 steps with it off
     and 10 on, peak memory and ms/step of each, losses within phase 5's
     bf16 rule, and basic's BatchNorm statistics after 2 float32 steps
     equal with it on and off; (c) TPU.DECODE_WORKERS: the training CLI on
     wide.feather, host-fed, 30 steps with 4 workers (in a process of its
     own) and with 0, ms/step over steps 11-30 of each, the worker run's
     labels those of the rows np.random.default_rng(SEED) draws, no worker
     alive after it; (d) make_synthetic_dataset at its defaults, then 10
     steps of the training CLI on it, losses finite;
  16. the fleet path (the card's machine has one H100; semantics across
     ranks are held on the CPU by tests/test_torch_parallel*.py): (a) the
     training CLI's fleet form (--coordinator 127.0.0.1:<free port>
     --num-processes 1 --process-id 0 --multihost-platform native), one
     NCCL rank in this process, the published config with TPU.MESH_DATA
     -1 and TPU.SHARD_DATASET true on phase 5's synthetic tables in device
     mode, B = 256, bf16, 30 steps and a checkpoint at 30: each step's
     loss within twice the spread of phase 5's two device-mode runs (plus
     1e-5 of the loss) of phase 5's, two identity launches a step, the
     checkpoint written once and loading into a plain TrainState equal to
     the run's, the process group gone after; every other CLI call of
     the script names cuda:0, since with no device the train, inverse and
     evaluate CLIs take every card of a machine of several; (b) step 5 profiled:
     the host's NCCL ops (at least the gradients' all-reduce, an in-place
     sum that enqueues nothing on the card at one rank), and the
     checkpoint's gather profiled: at least one device-side nccl range
     with the kernels or copies NCCL ran in it; ms/step over steps 11-30
     against phase 5's; (c) the basic arch, float32, B = 32, 2 steps, through the fleet
     form (BatchNorm synced over a data group of one) and plainly, the
     running statistics within 1e-5 + 1e-4·|x|; (d) with two cards or
     more only, the CLI spawning N x 1 and (N/2) x 2 fleets against one
     card (tools/fleet_cards.py: each step's loss and the step-30 update
     within twice a float32 one-card run's distance from the bf16 one;
     then the inverse CLI with no device, one NCCL rank a card, against
     cuda:0 alone: 12 steps at 224 px, B = 128, bf16, each scalar and the
     final accuracy within 5% + 1e-3, one final line, the checkpoints;
     printed as not run on one card);
  17. a JSON line of every ported kernel, then the result line.
Phase 1 also prints the libav* and NVDEC libraries `ldconfig -p` lists and
whether libnvcuvid.so.1 loads (it does, but the card's NVDEC engines are
not exposed there, which is why the port decodes on the host).
"""

from __future__ import annotations

import contextlib
import copy
import ctypes
import gc
import io
import json
from concurrent.futures import ThreadPoolExecutor
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import torch
import torch.nn.functional as F

from video_dqn_tpu_torch import (_build, detect_real_videos, extract_frames, process_episodes,
                                 train_inverse_model, train_q_network)
from video_dqn_tpu_torch import evaluate as evaluate_cli
from video_dqn_tpu_torch.core.checkpoint import restore_checkpoint
from video_dqn_tpu_torch.core.config import load_yaml
from video_dqn_tpu_torch.core.defaults import get_cfg_defaults
from video_dqn_tpu_torch.core.disk_logger import DiskReader
from video_dqn_tpu_torch.core.experiment import ExperimentConfig
from video_dqn_tpu_torch.core.metrics import read_metrics
from video_dqn_tpu_torch.data.detect import COCO_TARGET_IDS
from video_dqn_tpu_torch.data.device_dataset import DeviceDataset
from video_dqn_tpu_torch.data.episodes import make_inverse_labeler
from video_dqn_tpu_torch.data import filters as filters_mod
from video_dqn_tpu_torch.data import sim_dataset
from video_dqn_tpu_torch.data.feather import read_feather
from video_dqn_tpu_torch.data.filters import (PERSON_CLASS, make_indoor_classifier,
                                              person_in_top5)
from video_dqn_tpu_torch.data.gibson_pairs import GibsonPairBatcher
from video_dqn_tpu_torch.data import video as video_mod
from video_dqn_tpu_torch.data.h264 import decoded_frames
from video_dqn_tpu_torch.data.mp4 import Mp4Video
from video_dqn_tpu_torch.data.jpeg import decode_threads, load_images, save_images
from video_dqn_tpu_torch.data.png import read_png, save_png
from video_dqn_tpu_torch.data.qlearning import QLearningBatcher
from video_dqn_tpu_torch.data.synthetic import make_synthetic_dataset
from video_dqn_tpu_torch.data.tables import TableSource, synthetic_video_tables
from video_dqn_tpu_torch.eval import batched_runner
from video_dqn_tpu_torch.eval import evaluate as evaluate_mod
from video_dqn_tpu_torch.eval.evaluate import make_geodesic_scorer
from video_dqn_tpu_torch.eval.fixtures import make_episode_set, make_furnished_house
from video_dqn_tpu_torch.eval.load import load_eval_model
from video_dqn_tpu_torch.eval.policy_config import get_eval_defaults, load_file, name_from_config
from video_dqn_tpu_torch.eval.runner import run_policy
from video_dqn_tpu_torch.eval.scorer import make_multiclass_scorer
from video_dqn_tpu_torch.models.alexnet_places import load_alexnet_places
from video_dqn_tpu_torch.models.bridge import flax_from_qnet_state_dict, layout
from video_dqn_tpu_torch.models.detector import boxes as det_boxes
from video_dqn_tpu_torch.models.detector.convert import convert_maskrcnn
from video_dqn_tpu_torch.models.detector.inference import TorchDetector, load_detector
from video_dqn_tpu_torch.models.detector.maskrcnn import BOX_WEIGHTS, STRIDES, MaskRCNN
from video_dqn_tpu_torch.models.detector.roi_align import multilevel_roi_align
from video_dqn_tpu_torch.models.qnet import build_qnet, init_qnet
from video_dqn_tpu_torch.models.resnet import BatchNorm2d
from video_dqn_tpu_torch.ops import nv12 as nv12_mod
from video_dqn_tpu_torch.ops import nv12_scale as nv12_scale_mod
from video_dqn_tpu_torch.ops import resize_normalize as rn
from video_dqn_tpu_torch.ops.binning import observations_to_map_delta
from video_dqn_tpu_torch.ops.geometry import get_camera_matrix
from video_dqn_tpu_torch.parallel import multihost
from video_dqn_tpu_torch.tools import fleet_cards
from video_dqn_tpu_torch.plan import mapper as mapper_mod
from video_dqn_tpu_torch.plan.mapper import DepthMapperAndPlanner
from video_dqn_tpu_torch.sim import meshgen
from video_dqn_tpu_torch.sim.fake_env import FakeNavEnv
from video_dqn_tpu_torch.sim.gibson import CLASS_LABELS, relevant_locations
from video_dqn_tpu_torch.sim.mesh_env import MeshNavEnv
from video_dqn_tpu_torch.sim.mesh_twin import TwinMesh
from video_dqn_tpu_torch.sim.native_mesh import NativeMesh
from video_dqn_tpu_torch.sim.ply import write_ply
from video_dqn_tpu_torch.train import dqn, inverse
from video_dqn_tpu_torch.viz.panorama import join_images, make_allclass_scorer, panorama_strip
from video_dqn_tpu_torch.viz.render_grid import render_grid
from video_dqn_tpu_torch.viz.value_map import (VisualizationGrid, build_value_maps,
                                               orientation_views, render_value_map)

sys.path.append(str(Path(__file__).resolve().parent / "tests"))
import torch_qdata  # noqa: E402  (the fixture of phase 6 and its oracle check)
from torch_detector_util import (  # noqa: E402  (phase 3's box layouts, phase 11's weights
    disjoint_boxes, identical_boxes, seeded_maskrcnn_state_dict,  # and matching)
    unmatched_detections)
from torch_frontend_util import (  # noqa: E402  (phase 12's AlexNet weights and its
    BF16_LOGIT_ATOL, FRONT_SEED, INDOOR_BF16_ATOL, JAX_BF16_MAX_MOVE,  # bf16 rule)
    JAX_BF16_SWAP_SHARE, bf16_against_f32, centred_alexnet_state_dict, front_batch)
import torch_video_fixture as vfix  # noqa: E402  (phase 14's videos and their oracle)

SEED = 4
IMAGE_SIZE = 224
# the card of every CLI call that expects one rank: named, since with no
# device the train and evaluate CLIs take every card of a machine of several
ONE_CARD = fleet_cards.ONE_CARD
# H100 SXM data sheet: HBM rate and float32 rate outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12
KERNEL_ATOL = 1e-5
# bf16 output against the float32 plain version: half a bf16 ulp, relative
KERNEL_BF16_RTOL = 2.0 ** -8
OUT_DTYPES = (torch.float32, torch.bfloat16)
# bf16 card forward against the float32 CPU forward (tests/test_models.py
# test_qnet_bf16_matches_fp32_coarsely)
SCORE_ATOL, SCORE_RTOL = 0.15, 0.1
# every served score against a float32 card forward of the same views and
# weights through the plain resize twin: about 3x the bf16 gap measured
# at a 12-view stop (0.0142), and below the score gap between the rows
# of a request, so scores of the wrong rows or request fail it
SERVE_ATOL = 0.05
# served scores (kernel writes bf16) against the same model under autocast
# fed by the kernel's float32 output: autocast's cast rounds to nearest
# even as the kernel does, so the two should agree exactly
ROUTE_ATOL = 1e-3
# (input shape, output side): the dataset's frames and the renders at the
# largest serving bucket (8 episodes x 12 views), and a 96 px stop
# and the train step's before and after frames at B = 256
KERNEL_SHAPES = [((96, 256, 342, 3), 224), ((96, 224, 224, 3), 224),
                 ((12, 96, 96, 3), 96), ((256, 224, 224, 3), 224)]
REQUEST_VIEWS = (12, 24, 48, 96)
RENDERS = ((224, 224), (256, 342))
ROOT = Path(__file__).resolve().parent
PUBLISHED_CONFIG = ROOT / "configs/experiments/real_data/config.yml"
# the training phase: cuts of the published config to fit the time limit
TRAIN_CUTS = {"TARGET_UPDATE_INTERVAL": 8, "CHECKPOINT_INTERVAL": 10, "NUM_STEPS": 30}
TRAIN_FRAMES, TRAIN_ROWS, TRAIN_LOG_EVERY = 4096, 8192, 10
RESUME_FROM = 20
EMA_RTOL = 1e-3            # resumed run's final EMA loss against the first run's
BF16_LOSS_RTOL, BF16_LOSS_ATOL = 0.05, 1e-3   # bf16 steps against float32 steps
CPU_ATOL = 1e-4            # float32 card steps against float32 CPU steps, 96 px
# An element whose gradient lies below the float32 noise of its sum can
# take Adam's ~lr step the other way on the other device: 222 and 280 of
# the 23.3M params and target params did, up to 1.48e-4 apart. A few such
# are allowed; a skipped or wrong update moves millions.
CPU_BEYOND_MAX, CPU_CAP_LR = 1000, 2
# the real-data phase: the committed fixture, its frame paths relative to ROOT
DECODE_BATCH = 512         # paths per timed decode call, as a B = 256 step asks


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of fn() over `iters` back-to-back calls."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def device_profile(fn, calls: int) -> dict:
    """Run fn() `calls` times under torch.profiler after one warm call.
    Returns the host wall time, the summed device time of every kernel and
    copy, and the device time per kernel name."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    by_name: dict = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            n, us = by_name.get(e.name, (0, 0.0))
            by_name[e.name] = (n + 1, us + e.time_range.elapsed_us())
    device_us = sum(us for _, us in by_name.values())
    return {"calls": calls, "wall_ms": wall_us / 1e3 / calls,
            "device_ms": device_us / 1e3 / calls,
            "busy_share": device_us / wall_us if wall_us else 0.0,
            "by_name": by_name}


def log_profile(label: str, prof: dict, top: int = 12) -> None:
    if not prof["by_name"]:
        log(f"[profile] {label}: device time not measured (the profiler saw "
            f"no device events)")
        return
    log(f"[profile] {label}: wall {prof['wall_ms']:.4f} ms/call, device "
        f"{prof['device_ms']:.4f} ms/call, device busy share "
        f"{prof['busy_share']:.4f}, idle share {1 - prof['busy_share']:.4f}")
    ranked = sorted(prof["by_name"].items(), key=lambda kv: -kv[1][1])
    total = sum(us for _, us in prof["by_name"].values())
    for name, (n, us) in ranked[:top]:
        log(f"    {us / prof['calls'] / 1e3:9.4f} ms/call {us / total:7.2%} "
            f"x{n // prof['calls']:<4d} {name[:110]}")


def environment() -> None:
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device; this smoke runs on the card only")
    smi = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]} device {torch.cuda.get_device_name(0)} "
        f"count {torch.cuda.device_count()}")
    video_decode_probe()


def video_decode_probe() -> None:
    """What frame extraction could decode with on this machine: the libav*
    and NVDEC libraries the loader knows, whether NVDEC's libnvcuvid.so.1
    loads, whether its engines take H.264 (cuvidGetDecoderCaps: the status,
    bIsSupported and nNumNVDECs of Video Codec SDK 12's CUVIDDECODECAPS),
    and what nvidia-smi -q says of the encoder and decoder. Prints; never
    fails."""
    try:
        listed = subprocess.run(["ldconfig", "-p"], capture_output=True, text=True,
                                timeout=60).stdout
        found = sorted({line.split()[0] for line in listed.splitlines()
                        if re.search(r"avcodec|avformat|swscale|nvcuvid|nvidia-encode", line)})
    except (OSError, subprocess.SubprocessError) as e:
        found = [f"ldconfig failed: {e}"]
    try:
        cuvid = ctypes.CDLL("libnvcuvid.so.1")
        torch.zeros(1, device="cuda")  # the primary context, current on this thread
        cuda = ctypes.CDLL("libcuda.so.1")
        ctx = ctypes.c_void_p()
        cuda.cuDevicePrimaryCtxRetain(ctypes.byref(ctx), 0)
        cuda.cuCtxPushCurrent_v2(ctx)
        caps = (ctypes.c_ubyte * 128)()
        caps[0] = 4   # eCodecType cudaVideoCodec_H264
        caps[4] = 1   # eChromaFormat 4:2:0; nBitDepthMinus8 0
        status = cuvid.cuvidGetDecoderCaps(caps)
        cuda.cuCtxPopCurrent_v2(ctypes.byref(ctx))
        cuda.cuDevicePrimaryCtxRelease_v2(0)
        nvcuvid = (f"loads; cuvidGetDecoderCaps(H.264 4:2:0 8-bit) status {status}, "
                   f"bIsSupported {caps[24]}, nNumNVDECs {caps[25]}")
    except (OSError, AttributeError) as e:
        nvcuvid = f"does not load ({e})"
    try:
        smi = subprocess.run(["nvidia-smi", "-q"], capture_output=True, text=True,
                             timeout=60).stdout
        coder = "; ".join(" ".join(line.split()) for line in smi.splitlines()
                          if re.search(r"^\s*(Encoder|Decoder|Active Sessions)\s*:", line))
    except (OSError, subprocess.SubprocessError) as e:
        coder = f"nvidia-smi -q failed: {e}"
    log(f"[probe] ldconfig -p lists for avcodec|avformat|swscale|nvcuvid|nvidia-encode: "
        f"{found or 'nothing'}; libnvcuvid.so.1 {nvcuvid}; nvidia-smi -q: {coder}; "
        f"NVIDIA_DRIVER_CAPABILITIES={os.environ.get('NVIDIA_DRIVER_CAPABILITIES')}")


def build() -> None:
    """Both native libraries from the checkout's sources, built at once:
    nvcc for the kernels, the C++ compiler for the host library."""
    t0 = time.perf_counter()
    with ThreadPoolExecutor(2) as pool:
        kernels, host = pool.submit(_build.build), pool.submit(_build.build_host)
        compiler_out = kernels.result()
        host.result()
    seconds = time.perf_counter() - t0
    _build.load()
    _build.load_host()
    for line in compiler_out.splitlines():
        if "ptxas" in line:
            log(f"  {line.strip()}")
    log(f"[build] {_build.LIB.name} and {_build.HOST_LIB.name} in {seconds:.2f} s")
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([cuobjdump, "-sass", str(_build.LIB)], capture_output=True,
                          text=True, check=True, timeout=120).stdout
    for body in sass.split("Function : ")[1:]:
        name = body.split()[0]
        short = re.search(r"(resize_normalize_(?:identity|banded)_kernel)I(f|13__nv_bfloat16)",
                          name)
        if short:
            name = f"{short[1]}<{'float' if short[2] == 'f' else '__nv_bfloat16'}>"
        n = len(re.findall(r"^\s+/\*[0-9a-f]{4}\*/", body, re.MULTILINE))
        log(f"  SASS {name}: {n} instructions, {body.count('CALL')} subroutine calls")


def kernel_flops(shape, out: int) -> int:
    """Floating-point operations of the kernel's path: the normalize (2 a
    value) at identity size; else the vertical pass (2*K_h per input
    column of each output row), the horizontal pass (2*K_w a value) and
    the normalize."""
    b, h, w, _ = shape
    if rn.kernel_plan(h, w, out).identity:
        return b * out * out * 3 * 2
    k_h = rn.band_table(rn.resize_matrix(h, out))[1].shape[1]
    k_w = rn.band_table(rn.resize_matrix(w, out))[1].shape[1]
    return b * (out * w * 3 * 2 * k_h + out * out * 3 * (2 * k_w + 2))


def kernel_device_ms(fn, calls: int = 20, kernels=("resize_normalize",), split=None):
    """Profiled device time per call of fn of every `__global__` function
    whose name holds one of `kernels`, where each call launches each of
    them once; None where the profiler missed some of the launches twice
    (its first profiling run can drop events). `split`, a dict, gets each
    of `kernels`' own ms per call."""
    for _ in range(2):
        prof = device_profile(fn, calls=calls)
        seen = {k: [(n, us) for name, (n, us) in prof["by_name"].items() if k in name]
                for k in kernels}
        if all(sum(n for n, _ in v) == calls for v in seen.values()):
            if split is not None:
                split.update({k: sum(us for _, us in v) / calls / 1e3 for k, v in seen.items()})
            return sum(us for v in seen.values() for _, us in v) / calls / 1e3
    return None


def queued_ms(fn, iters: int = 50) -> float:
    """Device time per call of fn from CUDA events around `iters` calls
    queued behind a sleep kernel, so that the card runs them back to back
    however long the host takes to issue them (for kernels shorter than
    their wrapper's host cost, where cuda_ms measures the host)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(50_000_000)  # ~25 ms of cycles: longer than issuing the calls
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def host_us(fn, calls: int = 200) -> float:
    """Host time per call of fn, without a synchronize: what the wrapper
    costs the host, with the card's queue far from full."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    us = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    return us


def kernel_vs_plain() -> list[dict]:
    """Every KERNEL_SHAPES entry in both output types: identity paths
    bit-equal to the plain version, banded ones within KERNEL_ATOL (plus
    KERNEL_BF16_RTOL relative for bf16). The kernel's time is its profiled
    device time, back to back and with the 50 MB L2 flushed before each
    launch."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device="cuda").manual_seed(SEED)
    flush = torch.empty(2 ** 27, dtype=torch.uint8, device="cuda")
    rows = []
    for shape, out in KERNEL_SHAPES:
        x = torch.randint(0, 256, shape, dtype=torch.uint8, device="cuda", generator=g)
        path = "identity" if rn.kernel_plan(shape[1], shape[2], out).identity else "banded"
        want = rn.resize_normalize_reference(x, out)
        xf = x.permute(0, 3, 1, 2).float()
        interp_ms = cuda_ms(lambda: F.interpolate(
            xf, size=(out, out), mode="bilinear", antialias=True))
        for dtype in OUT_DTYPES:
            dname = str(dtype)[6:]
            got = rn.resize_normalize(x, out, dtype)
            torch.cuda.synchronize()
            if got.dtype != dtype or not got.is_contiguous(memory_format=torch.channels_last):
                raise AssertionError(f"kernel output is not {dtype} NCHW channels_last")
            err = (got.float() - want).abs()
            if path == "identity":
                ok, tol = torch.equal(got, want.to(dtype)), "bit-equal"
            else:
                bound = KERNEL_ATOL + (KERNEL_BF16_RTOL * want.abs() if dtype == torch.bfloat16 else 0)
                ok = bool((err <= bound).all())
                tol = f"<= {KERNEL_ATOL}" + (" + 2^-8 |ref|" if dtype == torch.bfloat16 else "")
            max_err = err.max().item()
            if not ok:
                raise AssertionError(f"resize_normalize {path} {shape}->{out} {dname}: "
                                     f"max abs err {max_err}, not {tol}")
            call = lambda: rn.resize_normalize(x, out, dtype)  # noqa: E731
            event_ms = cuda_ms(call)
            plain_ms = cuda_ms(lambda: rn.resize_normalize_reference(x, out).to(dtype))
            device_ms = kernel_device_ms(call)
            cold_ms = kernel_device_ms(lambda: (flush.zero_(), call()))
            wrapper_us = host_us(call)
            ms = device_ms if device_ms is not None else event_ms
            n_bytes = x.numel() + got.numel() * got.element_size()
            bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
            ops_ms = kernel_flops(shape, out) / FP32_FLOPS * 1e3
            bound_ms = max(bytes_ms, ops_ms)
            row = {"path": path, "shape": list(shape), "out": out, "dtype": dname,
                   "max_abs_err": max_err, "tolerance": tol, "ms": ms,
                   "ms_source": "profiler" if device_ms is not None else "queued events",
                   "event_ms": event_ms, "cold_l2_device_ms": cold_ms,
                   "host_us_per_call": wrapper_us, "plain_ms": plain_ms,
                   "bound_ms": bound_ms,
                   "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
                   "share_of_bound": bound_ms / ms, "bytes": n_bytes,
                   "gb_per_s": n_bytes / ms / 1e6, "library_ms": None,
                   "approx_interpolate_ms": interp_ms}
            log(f"[kernel] resize_normalize_{path} {tuple(shape)}->{out} {dname}: "
                f"err {max_err:.3g} ({tol}); device {ms:.4f} ms ({row['ms_source']}; "
                f"L2 flushed before each: {cold_ms if cold_ms is None else f'{cold_ms:.4f}'} "
                f"ms), events {event_ms:.4f} ms, wrapper host {wrapper_us:.1f} us/call; "
                f"plain {plain_ms:.4f} ms; bound {bound_ms:.4f} ms ({row['bound_by']}), "
                f"{row['share_of_bound']:.1%} of it, {row['gb_per_s']:.1f} GB/s; "
                f"approximate yardstick only, F.interpolate(bilinear, antialias) on "
                f"float NCHW (other borders, no normalize, f32): {interp_ms:.4f} ms")
            rows.append(row)
    del flush
    return rows


# -- phase 3: the NMS kernel -----------------------------------------------------

# the RPN's candidates a level at 224 px (top 1,000 of 56²·3, 28²·3 anchors,
# all 14²·3, 7²·3, 4²·3) and the final class NMS's 1,000 -> 100
RPN_LEVELS, RPN_THRESH = (1000, 1000, 588, 147, 48), 0.7
FINAL_CANDIDATES, FINAL_KEEP, FINAL_THRESH = 1000, 100, 0.5
DETECTOR_BATCHES = (4, 12)
# float operations of one IoU and its comparison (csrc/nms.cu `iou_terms`, the
# division and the compare)
NMS_PAIR_FLOPS = 17
# the __global__ functions of one nms_groups call (csrc/nms.cu)
NMS_KERNELS = ("nms_mask_kernel", "nms_scan_kernel")


def nms_inputs(groups: int, n: int, lengths, span: float, classes: int, seed: int):
    """Groups of n boxes in descending score order as the detector feeds
    them: boxes of anchor sizes 16-256 px in a `span` image (each group's
    `classes` classes offset apart as batched_class_nms does), a third of
    the scores tied in runs, near-duplicates of earlier boxes, and -inf
    past each group's length."""
    rng = np.random.default_rng(seed)
    xy = rng.uniform(0, span, (groups, n, 2))
    wh = np.exp(rng.uniform(np.log(16), np.log(256), (groups, n, 2)))
    boxes = np.clip(np.concatenate([xy, xy + wh], -1), 0, span)
    dup = rng.random((groups, n)) < 0.3
    src = np.maximum(np.arange(n) - rng.integers(1, 20, (groups, n)), 0)
    near = np.take_along_axis(boxes, src[..., None].repeat(4, -1), 1) + rng.normal(
        0, 3, (groups, n, 4))
    boxes = np.where(dup[..., None], near, boxes)
    boxes += rng.integers(0, classes, (groups, n, 1)) * (span + 1)
    scores = -np.sort(-np.round(rng.random((groups, n)), 2), axis=1)  # ties in runs
    for g, m in enumerate(lengths):
        scores[g, m:] = -np.inf
    return (torch.from_numpy(boxes.astype(np.float32)).cuda(),
            torch.from_numpy(scores.astype(np.float32)).cuda())


def nms_pairs(boxes, scores, thr: float, keep, valid) -> int:
    """IoUs the walk computes on this data: for each kept candidate, the
    later candidates still alive then (csrc/nms.cu computes one IoU each)."""
    iou = det_boxes.box_iou(boxes, boxes)
    g, n = scores.shape
    later = torch.arange(n, device=scores.device)
    alive = torch.isfinite(scores)
    rows = torch.arange(g, device=scores.device)
    pairs = 0
    for t in range(keep.shape[1]):
        k, ok = keep[:, t].long(), valid[:, t]
        after = (later[None, :] > k[:, None]) & ok[:, None]
        pairs += int((alive & after).sum())
        suppress = (iou[rows, k] > thr) | (later[None, :] == k[:, None])
        alive = torch.where(ok[:, None], alive & ~suppress, alive)
    return pairs


def nms_cases() -> list[tuple]:
    """(name, boxes, scores, IoU threshold, max_out, kept a group or None)
    of phase 3: the detector's shapes (B*5 RPN groups of up to 1,000 ->
    1,000 kept, B final groups of 1,000 -> 100, B = 4 and 12), one group
    at MAX_GROUP, the card test's n = 5,000, identical and disjoint boxes,
    and the RPN's groups at B = 12 cut to 100 kept."""
    cases = []
    for b in DETECTOR_BATCHES:
        cases.append((f"rpn_b{b}", *nms_inputs(b * 5, max(RPN_LEVELS), RPN_LEVELS * b,
                                               IMAGE_SIZE, 1, SEED + len(cases)),
                      RPN_THRESH, max(RPN_LEVELS), None))
        cases.append((f"final_b{b}", *nms_inputs(b, FINAL_CANDIDATES, [FINAL_CANDIDATES] * b,
                                                 IMAGE_SIZE, 90, SEED + len(cases)),
                      FINAL_THRESH, FINAL_KEEP, None))
    big = det_boxes.MAX_GROUP
    cases.append(("max_group", *nms_inputs(1, big, [big], IMAGE_SIZE, 1, SEED + 4),
                  RPN_THRESH, 300, None))
    cases.append(("n5000", *nms_inputs(3, 5000, [5000, 3100, 1], IMAGE_SIZE, 1, SEED + 5),
                  RPN_THRESH, 300, None))
    for name, boxes, thr, kept in (("identical", identical_boxes(4, 1000), RPN_THRESH, 1),
                                   ("disjoint", disjoint_boxes(4, 1000, SEED + 7),
                                    FINAL_THRESH, 1000)):
        _, scores = nms_inputs(4, 1000, [1000] * 4, IMAGE_SIZE, 1, SEED + len(cases))
        cases.append((name, torch.from_numpy(boxes).cuda(), scores, thr, 1000, kept))
    b = max(DETECTOR_BATCHES)
    cases.append(("cut", *nms_inputs(b * 5, max(RPN_LEVELS), RPN_LEVELS * b, IMAGE_SIZE, 1,
                                     SEED + 2), RPN_THRESH, 100, None))
    return cases


def nms_vs_plain() -> list[dict]:
    """The NMS kernels against nms_reference on the card on nms_cases:
    keep lists and valid flags equal (and the kept counts that identical
    and disjoint boxes force), then on edge inputs (all-tied scores, -inf
    rows, one-candidate groups) at IoU 0, 0.5 and 1. Times: the mask and
    scan kernels' profiled device ms together, the plain twin's ms, and the
    bound from the bytes and this data's IoUs; each row logs the mask
    workspace's bytes."""
    rows = []
    for name, boxes, scores, thr, max_out, kept_each in nms_cases():
        g, n = scores.shape
        keep, valid, status = det_boxes.nms_groups(boxes, scores, thr, max_out)
        want_keep, want_valid = det_boxes.nms_reference(boxes, scores, thr, max_out)
        det_boxes.check_nms_status(status)
        if not (torch.equal(keep, want_keep) and torch.equal(valid, want_valid)):
            raise AssertionError(f"nms {name}: the kernel's keep/valid differ from the plain "
                                 f"version's ({int((keep != want_keep).sum())} indices, "
                                 f"{int((valid != want_valid).sum())} flags)")
        kept = valid.sum(1)
        if kept_each is not None and not bool((kept == kept_each).all()):
            raise AssertionError(f"nms {name}: kept {kept.tolist()} a group, not {kept_each}")
        if name == "cut":
            uncut = det_boxes.nms_reference(boxes, scores, thr, n)[1].sum(1)
            if not bool((uncut > max_out).any()):
                raise AssertionError(f"nms cut: no group would keep more than {max_out}")
        call = lambda: det_boxes.nms_groups(boxes, scores, thr, max_out)  # noqa: E731
        event_ms = cuda_ms(call, iters=10)
        split = {}
        device_ms = kernel_device_ms(call, calls=10, kernels=NMS_KERNELS, split=split)
        ms = device_ms if device_ms is not None else event_ms
        plain_ms = cuda_ms(lambda: det_boxes.nms_reference(boxes, scores, thr, max_out),
                           iters=2, warmup=1)
        pairs = nms_pairs(boxes, scores, thr, keep, valid)
        n_bytes = g * n * 20 + g * max_out * 5 + g * 4
        bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
        ops_ms = pairs * NMS_PAIR_FLOPS / FP32_FLOPS * 1e3
        row = {"case": name, "groups": g, "n": n, "max_out": max_out, "threshold": thr,
               "kept": int(kept.sum()), "max_abs_err": 0.0, "tolerance": "equal",
               "ms": ms, "ms_source": "profiler" if device_ms is not None else "events",
               "event_ms": event_ms, "plain_ms": plain_ms, "pairs": pairs, "bytes": n_bytes,
               "workspace_bytes": det_boxes.workspace_bytes(g, n),
               "kernel_ms": split,
               "bound_ms": max(bytes_ms, ops_ms),
               "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
               "library_ms": None}
        log(f"[kernel] nms {name}: {g} groups x {n} -> {max_out} (IoU > {thr}): keep and valid "
            f"equal to the plain version ({row['kept']} kept); device {ms:.4f} ms "
            f"({row['ms_source']}; " + ", ".join(f"{k} {v:.4f}" for k, v in split.items())
            + f"), events {event_ms:.4f} ms (back to "
            f"back, status unread); plain {plain_ms:.4f} ms; {pairs} IoUs, bound "
            f"{row['bound_ms']:.6f} ms ({row['bound_by']}), {row['bound_ms'] / ms:.2%} of it; "
            f"workspace {row['workspace_bytes']} bytes")
        rows.append(row)
    # edge inputs: every score tied, whole -inf groups, single candidates
    boxes, scores = nms_inputs(6, 64, [64, 0, 1, 64, 33, 2], 96.0, 1, SEED)
    scores[0] = 0.5
    scores[3, :40] = 0.25
    for thr in (0.0, 0.5, 1.0):
        keep, valid, status = det_boxes.nms_groups(boxes, scores, thr, 64)
        det_boxes.check_nms_status(status)
        want_keep, want_valid = det_boxes.nms_reference(boxes, scores, thr, 64)
        if not (torch.equal(keep, want_keep) and torch.equal(valid, want_valid)):
            raise AssertionError(f"nms edge inputs at IoU {thr}: keep/valid differ")
    flipped = scores.flip(1)
    _, valid, status = det_boxes.nms_groups(boxes, flipped, 0.5, 8)
    want = (~(flipped[:, 1:] <= flipped[:, :-1]).all(1) | flipped[:, 0].isnan()).int()
    if not torch.equal(status, want) or int(want.sum()) in (0, len(want)):
        raise AssertionError(f"nms statuses of flipped groups {status.tolist()}, not "
                             f"{want.tolist()}")
    if bool(valid[want.bool()].any()):
        raise AssertionError("nms kept candidates of a group out of score order")
    try:
        det_boxes.check_nms_status(status)
    except ValueError:
        pass
    else:
        raise AssertionError("check_nms_status accepted groups out of score order")
    log("[kernel] nms edge inputs (all tied, -inf groups, one candidate, IoU 0 / 0.5 / 1): "
        "equal; unsorted groups keep nothing and set their status, which raises")
    return rows


def published_config():
    """The published config.yml over the port's defaults (core/defaults.py)."""
    config = get_cfg_defaults()
    config.merge_from_file(str(PUBLISHED_CONFIG))
    return config


def seeded_checkpoint(path: Path, model_config) -> dict:
    """Seeded port init saved in the reference's .torch format, with the
    unused torchvision classifier the reference trunk carries."""
    g = torch.Generator().manual_seed(SEED)
    model = init_qnet(build_qnet(model_config, IMAGE_SIZE, device="cpu"), g)
    sd = dict(model.state_dict())
    sd["resnet.fc.weight"] = torch.randn((1000, 512), generator=g) / 512 ** 0.5
    sd["resnet.fc.bias"] = torch.zeros(1000)
    torch.save({"model_state_dict": sd}, path)
    return sd


def fp32_card_scores(model, views: np.ndarray, cls: np.ndarray) -> np.ndarray:
    """The scorer's function in float32 on the card, built apart from it:
    the plain resize twin, the model outside autocast, no padding."""
    x = torch.from_numpy(views).cuda()
    b, f = x.shape[:2]
    xn = rn.resize_normalize_reference(x.reshape((b * f,) + x.shape[2:]), IMAGE_SIZE)
    xn = xn.permute(0, 2, 3, 1).reshape(b, f, IMAGE_SIZE, IMAGE_SIZE, 3)
    with torch.no_grad():
        q = model(xn)
    rows = torch.arange(b, device=q.device)
    return q[rows, torch.from_numpy(cls).to(q.device)].amax(dim=-1).cpu().numpy()


def f32_route_scores(model, views: np.ndarray, cls: np.ndarray) -> np.ndarray:
    """The scorer's forward with the kernel's float32 output in place of
    its bf16 output: autocast then casts the input to bf16 itself."""
    x = torch.from_numpy(views).cuda()
    b, f = x.shape[:2]
    xn = rn.resize_normalize(x.reshape((b * f,) + x.shape[2:]), IMAGE_SIZE, torch.float32)
    xn = xn.permute(0, 2, 3, 1).reshape(b, f, IMAGE_SIZE, IMAGE_SIZE, 3)
    with torch.no_grad(), torch.autocast("cuda", dtype=torch.bfloat16):
        q = model(xn)
    rows = torch.arange(b, device=q.device)
    return q[rows, torch.from_numpy(cls).to(q.device)].amax(dim=-1).cpu().numpy()


def serving_path() -> dict:
    _build.BUILD_DIR.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as tmp:
        ckpt = Path(tmp) / "qnet.torch"
        model_config = published_config()
        seeded_checkpoint(ckpt, model_config)
        t0 = time.perf_counter()
        model = load_eval_model(SimpleNamespace(PRETRAINED_MODEL_LOCATION=str(ckpt)),
                                model_config, image_size=IMAGE_SIZE)
        cpu_model = load_eval_model(
            SimpleNamespace(PRETRAINED_MODEL_LOCATION=str(ckpt)), model_config,
            image_size=IMAGE_SIZE, device="cpu")
    log(f"[serve] loaded {sum(p.numel() for p in model.parameters())} params "
        f"in {time.perf_counter() - t0:.2f} s on {next(model.parameters()).device}")
    scorer = make_multiclass_scorer(model, image_size=IMAGE_SIZE)

    # each view is noise over a colour of its own, so views score apart
    rng = np.random.default_rng(SEED)
    requests = []
    for hw in RENDERS:
        for b in REQUEST_VIEWS:
            tint = rng.integers(0, 128, (b, 1, 1, 1, 3), np.uint8)
            requests.append((tint + rng.integers(0, 128, (b, 1, *hw, 3), np.uint8),
                             rng.integers(0, 5, b)))

    # the main path: counts from 0, 2 requests in flight
    torch.cuda.reset_peak_memory_stats()
    rn.LAUNCHES.clear()
    t0 = time.perf_counter()
    inflight, answers, steps = [], [], []
    for views, cls in requests:
        before = rn.LAUNCHES.copy()
        inflight.append((views, cls, scorer.dispatch(views, cls)))
        steps.append(dict(rn.LAUNCHES - before))
        if len(inflight) == 2:
            v, c, h = inflight.pop(0)
            answers.append((v, c, scorer.gather(h)))
    while inflight:
        v, c, h = inflight.pop(0)
        answers.append((v, c, scorer.gather(h)))
    wall = time.perf_counter() - t0
    launches = {path: rn.LAUNCHES[path, "bfloat16"] for path in ("identity", "banded")}
    log(f"[serve] {len(requests)} requests ({sum(len(v) for v, _ in requests)} views) "
        f"cold in {wall:.3f} s; kernel launches {dict(rn.LAUNCHES)}")
    for (views, _), step in zip(requests, steps):
        path = "identity" if views.shape[2:4] == (IMAGE_SIZE, IMAGE_SIZE) else "banded"
        if step != {(path, "bfloat16"): 1}:
            raise AssertionError(f"a {views.shape} request launched {step}, not one "
                                 f"{path} kernel with bf16 output")
    if sum(rn.LAUNCHES.values()) != len(requests):
        raise AssertionError(f"{dict(rn.LAUNCHES)} launches for {len(requests)} calls")
    for views, _, scores in answers:
        if scores.shape != (len(views),) or not np.all(np.isfinite(scores)):
            raise AssertionError(f"bad scores {scores.shape} for {len(views)} views")

    # every answer against a float32 card forward of its own views; the
    # score gap between neighbouring rows shows the check tells rows apart
    serve_diff, row_gap = 0.0, np.inf
    for views, cls, scores in answers:
        want = fp32_card_scores(model, views, cls)
        diff = float(np.abs(scores - want).max())
        gap = float(np.median(np.abs(want - np.roll(want, 1))))
        log(f"[serve] {len(views)} views {views.shape[2]}x{views.shape[3]}: served "
            f"bf16 vs card fp32 max abs diff {diff:.4g}; median gap between "
            f"neighbouring rows {gap:.4g}")
        if not diff <= SERVE_ATOL:
            raise AssertionError(f"served scores differ from the fp32 card forward "
                                 f"by {diff} > {SERVE_ATOL}")
        if not gap > SERVE_ATOL:
            raise AssertionError(f"rows score within {gap} of each other: the "
                                 f"{SERVE_ATOL} check cannot tell them apart")
        serve_diff, row_gap = max(serve_diff, diff), min(row_gap, gap)

    # the bf16 route against the float32 route under autocast: the kernel's
    # bf16 output must be what autocast's cast of its float32 output gives
    route_diff = 0.0
    for views, cls, scores in answers:
        diff = float(np.abs(scores - f32_route_scores(model, views, cls)).max())
        log(f"[serve] {len(views)} views {views.shape[2]}x{views.shape[3]}: bf16 route "
            f"vs float32 route under autocast max abs diff {diff:.4g}")
        if not diff <= ROUTE_ATOL:
            raise AssertionError(f"bf16 kernel output changes the scores by {diff} > "
                                 f"{ROUTE_ATOL} against autocast's own cast")
        route_diff = max(route_diff, diff)

    # bf16 card scores against the port's float32 CPU forward, one 12-view
    # stop per render size
    cpu_scorer = make_multiclass_scorer(cpu_model, image_size=IMAGE_SIZE, device="cpu")
    worst = 0.0
    for views, cls, scores in answers:
        if len(views) != 12:
            continue
        want = cpu_scorer(views, cls)
        np.testing.assert_allclose(scores, want, atol=SCORE_ATOL, rtol=SCORE_RTOL)
        worst = max(worst, float(np.abs(scores - want).max()))
        log(f"[serve] 12-view stop {views.shape[2]}x{views.shape[3]}: card bf16 "
            f"vs cpu fp32 max abs diff {np.abs(scores - want).max():.4g} "
            f"(scores {np.round(scores[:4], 4).tolist()}...)")

    # timings, after the counted run: 50 synchronous stops (median and p80,
    # which leaves 10 samples above it), 5 repeats of 10 pipelined B=96 calls
    stop = requests[0]
    scorer(*stop)
    per_stop = []
    for _ in range(50):
        t0 = time.perf_counter()
        scorer(*stop)
        per_stop.append((time.perf_counter() - t0) * 1e3)
    rates = {}
    for (views, cls) in (r for r in requests if len(r[0]) == 96):
        scorer(views, cls)
        runs = []
        for _ in range(5):
            t0 = time.perf_counter()
            h = scorer.dispatch(views, cls)
            for _ in range(9):
                h2 = scorer.dispatch(views, cls)
                scorer.gather(h)
                h = h2
            scorer.gather(h)
            runs.append(96 * 10 / (time.perf_counter() - t0))
        rates[f"{views.shape[2]}x{views.shape[3]}"] = {
            "median": float(np.median(runs)), "min": min(runs), "max": max(runs)}
    # autocast casts each convolution and linear weight and bias to bf16 on
    # every call; the input is no longer cast, since the kernel writes bf16
    weight_casts = sum(p is not None for m in model.modules()
                       if isinstance(m, (torch.nn.Conv2d, torch.nn.Linear))
                       for p in (m.weight, m.bias))
    profiles = {}
    for views, cls in (r for r in requests if len(r[0]) in (12, 96)):
        label = f"scorer call, {len(views)} views {views.shape[2]}x{views.shape[3]}"
        profiles[label] = device_profile(lambda: scorer(views, cls), calls=10)
        log_profile(label, profiles[label])
        copies = sum(n for name, (n, _) in profiles[label]["by_name"].items()
                     if "bfloat16_copy" in name) / 10
        log(f"[profile] {label}: {copies:g} bfloat16_copy launches per call, "
            f"{weight_casts} of them weight and bias casts")
        if len(views) == 96 and copies > weight_casts:
            raise AssertionError(f"{copies:g} bfloat16_copy launches per call, more than "
                                 f"the {weight_casts} weight and bias casts: the "
                                 f"input is cast again")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    ms_stop = float(np.median(per_stop))
    p80_stop = float(np.percentile(per_stop, 80))
    log(f"[serve] ms per 12-view stop (224x224 renders, 50 calls): median "
        f"{ms_stop:.4f} p80 {p80_stop:.4f}; views/s at B=96 (5 x 10 calls): "
        + ", ".join(f"{k} median {v['median']:.1f} [{v['min']:.1f}, {v['max']:.1f}]"
                    for k, v in rates.items())
        + f"; peak device memory {peak:.2f} GiB")
    return {"launches": launches, "ms_per_12_view_stop": ms_stop,
            "ms_per_12_view_stop_p80": p80_stop,
            "views_per_s_b96": rates, "bf16_max_abs_diff": worst,
            "served_vs_fp32_card_max_abs_diff": serve_diff,
            "bf16_route_vs_f32_route_max_abs_diff": route_diff,
            "min_median_row_gap": row_gap,
            "device_busy_share": {k: v["busy_share"] for k, v in profiles.items()}}


def _yaml(tree: dict, indent: str = "") -> list:
    lines = []
    for k, v in tree.items():
        if isinstance(v, dict):
            lines += [f"{indent}{k}:"] + _yaml(v, indent + "  ")
        elif isinstance(v, float) and "e" in repr(v) and "." not in repr(v):
            # YAML reads 1e-07 as a string; 1.0e-07 is a float
            lines.append(f"{indent}{k}: " + repr(v).replace("e", ".0e"))
        else:
            lines.append(f"{indent}{k}: " + (f"'{v}'" if isinstance(v, str) else repr(v)))
    return lines


def write_experiment(folder: Path, **over) -> str:
    """A new experiment folder whose config.yml is the published config
    with `over` merged in (a dict value merges into its section)."""
    tree = load_yaml(PUBLISHED_CONFIG.read_text())
    for k, v in over.items():
        tree[k] = {**tree.get(k, {}), **v} if isinstance(v, dict) else v
    folder.mkdir(parents=True)
    (folder / "config.yml").write_text("\n".join(_yaml(tree)) + "\n")
    return str(folder)


def experiment(folder: Path, **over) -> ExperimentConfig:
    return ExperimentConfig(write_experiment(folder, **over))


class LossTrace:
    """Keeps each step's loss (a device tensor, read after the run) of the
    run_train calls inside it, without a synchronize."""

    def __enter__(self):
        self.losses = []
        self._saved = dqn.make_train_step
        make = self._saved

        def make_traced(model, config):
            step_fn = make(model, config)

            def traced(state, batch, mark=None):
                out = step_fn(state, batch, mark)
                self.losses.append(out["loss"])
                return out
            return traced

        dqn.make_train_step = make_traced
        return self

    def __exit__(self, *exc):
        dqn.make_train_step = self._saved

    def values(self) -> list:
        return torch.stack(self.losses).tolist() if self.losses else []


class TrainSpy:
    """Watches one run_train without changing it: the kernel launches and
    the loss of each step, the rows DeviceDataset draws for each step, and
    a copy of the online net's state dict at each target sync (taken
    before the sync, so it is the online net before that step's update)."""

    def __enter__(self):
        self.steps, self.rows, self.syncs, self.losses = [], {}, [], []
        self._saved = dqn.make_train_step, dqn.sync_target, DeviceDataset.rows
        make, sync, rows = self._saved

        def make_spied(model, config):
            step_fn = make(model, config)

            def spied(state, batch, mark=None):
                before = rn.LAUNCHES.copy()
                out = step_fn(state, batch, mark)
                self.steps.append(dict(rn.LAUNCHES - before))
                self.losses.append(out["loss"])
                return out
            return spied

        def sync_spied(state):
            self.syncs.append((state.step + 1, {k: v.detach().clone()
                                                for k, v in state.model.state_dict().items()}))
            sync(state)

        def rows_spied(dds, step):
            out = rows(dds, step)
            self.rows[int(step)] = out.clone()
            return out

        dqn.make_train_step, dqn.sync_target, DeviceDataset.rows = (
            make_spied, sync_spied, rows_spied)
        return self

    def __exit__(self, *exc):
        dqn.make_train_step, dqn.sync_target, DeviceDataset.rows = self._saved


def steady_rate(config) -> dict:
    """ms/step and frames/s (B / step time) over the 20 steps after the
    first 10, from run_train's own frames_per_sec/train at steps 20, 30."""
    rates = [r["value"] for r in read_metrics(config.run_dir, "frames_per_sec/train")
             if r["step"] > TRAIN_LOG_EVERY]
    b = int(config.TPU.BATCH_SIZE)
    seconds = sum(TRAIN_LOG_EVERY * b / r for r in rates)
    steps = TRAIN_LOG_EVERY * len(rates)
    return {"ms_per_step": seconds / steps * 1e3, "frames_per_s": steps * b / seconds,
            "windows_frames_per_s": rates}


def check_counted_run(name: str, spy: "TrainSpy", config: ExperimentConfig):
    """A counted 30-step run of the main path: two identity bf16 launches
    every step and nothing else, a finite EMA loss at every log point, and
    a checkpoint at every interval. Returns the logged losses and the
    checkpoint names."""
    steps = TRAIN_CUTS["NUM_STEPS"]
    want = {("identity", "bfloat16"): 2}
    if len(spy.steps) != steps or any(d != want for d in spy.steps):
        raise AssertionError(f"{name}: launches per step {spy.steps}, not {want} each")
    losses = [r["value"] for r in read_metrics(config.run_dir, "avg_q_loss/train")]
    if len(losses) != steps // TRAIN_LOG_EVERY or not np.all(np.isfinite(losses)):
        raise AssertionError(f"{name}: logged losses {losses}")
    every = TRAIN_CUTS["CHECKPOINT_INTERVAL"]
    names = sorted(os.listdir(config.models_dir))
    if names != sorted(f"sample{k}.ckpt" for k in range(every, steps + 1, every)):
        raise AssertionError(f"{name}: checkpoints {names}")
    return losses, names


def check_resume(label: str, spy: "TrainSpy", first: dict, ema: float) -> dict:
    """A run resumed from sample20 against the first run: the same rows for
    steps 21-30 and the same final EMA loss, within EMA_RTOL."""
    steps = range(RESUME_FROM, TRAIN_CUTS["NUM_STEPS"])
    same_rows = sorted(spy.rows) == list(steps) and all(
        torch.equal(spy.rows[k], first["spy"].rows[k]) for k in steps)
    want = first["ema_loss"]
    log(f"{label} resume from sample{RESUME_FROM}: rows of steps {steps.start + 1}-{steps.stop} "
        f"{'equal' if same_rows else 'DIFFER'}; final EMA loss {ema:.6f} vs {want:.6f} "
        f"(relative {abs(ema - want) / abs(want):.3g})")
    if not same_rows:
        raise AssertionError("the resumed run drew other rows")
    if not abs(ema - want) <= EMA_RTOL * abs(want):
        raise AssertionError(f"resumed EMA loss {ema} vs {want}")
    return {"rows_equal": same_rows, "ema_loss": ema, "first_ema_loss": want}


def train_run(tmp: Path, name: str, tables, device_dataset: bool) -> dict:
    """The main path in one data mode: a timing run (no checkpoints, also
    the warm-up), then the counted run with the checks."""
    mode = {"TPU": {"DEVICE_DATASET": device_dataset}}
    timing = experiment(tmp / f"{name}_timing",
                        **{**TRAIN_CUTS, **mode, "CHECKPOINT_INTERVAL": 10 ** 6})
    with LossTrace() as timing_losses:
        dqn.run_train(timing, batcher=TableSource(tables, seed=SEED), log_every=TRAIN_LOG_EVERY)
    rate = steady_rate(timing)

    config = experiment(tmp / name, **TRAIN_CUTS, **mode)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    rn.LAUNCHES.clear()
    t0 = time.perf_counter()
    with TrainSpy() as spy:
        state, loss = dqn.run_train(config, batcher=TableSource(tables, seed=SEED),
                                    log_every=TRAIN_LOG_EVERY)
    wall = time.perf_counter() - t0
    launches = dict(rn.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    steps = TRAIN_CUTS["NUM_STEPS"]
    log(f"[train] {name}: {steps} steps in {wall:.2f} s (checkpoints included); "
        f"launches {launches}; final EMA loss {loss:.6f}; peak device memory {peak:.2f} GiB; "
        f"steady state {rate['ms_per_step']:.4f} ms/step, {rate['frames_per_s']:.1f} "
        f"frames/s (windows {[round(r, 1) for r in rate['windows_frames_per_s']]})")

    losses, names = check_counted_run(name, spy, config)
    log(f"[train] {name}: logged EMA losses {losses}")
    interval, every = TRAIN_CUTS["TARGET_UPDATE_INTERVAL"], TRAIN_CUTS["CHECKPOINT_INTERVAL"]
    if [k for k, _ in spy.syncs] != list(range(interval, steps + 1, interval)):
        raise AssertionError(f"{name}: target synced at steps {[k for k, _ in spy.syncs]}")
    for k, online in spy.syncs:
        # the first checkpoint after the sync, before the next sync
        ckpt = restore_checkpoint(config.models_dir, -(-k // every) * every)
        params, stats = flax_from_qnet_state_dict(online, *layout(state.model))
        for field, tree in (("target_params", params), ("target_batch_stats", stats)):
            for a, b in zip(_leaves(ckpt[field]), _leaves(tree)):
                if not np.array_equal(a, b):
                    raise AssertionError(f"{name}: {field} after the sync at step {k} is not "
                                         f"the online net before that step")
    log(f"[train] {name}: one identity bf16 launch pair per step; target == online "
        f"before the update after the syncs at {[k for k, _ in spy.syncs]}; {names}")
    return {"config": config, "state": state, "spy": spy, "launches": launches,
            "ema_loss": float(state.ema_loss), "rate": rate, "peak_gib": peak,
            "losses": losses, "step_losses": torch.stack(spy.losses).tolist(),
            "timing_step_losses": timing_losses.values()}


def _leaves(tree):
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in _leaves(tree[k])]
    return [np.asarray(tree)]


def resume_check(first: dict) -> dict:
    config = ExperimentConfig(first["config"].folder, resume=True)
    with TrainSpy() as spy:
        state, _ = dqn.run_train(config, resume_from=RESUME_FROM,
                                 batcher=TableSource(first["tables"], seed=SEED),
                                 log_every=TRAIN_LOG_EVERY)
    return check_resume("[train]", spy, first, float(state.ema_loss))


class no_tf32:
    def __enter__(self):
        self.saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False

    def __exit__(self, *exc):
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = self.saved


class plain_prologue:
    """The train step's prologue through the plain resize twin, on the
    card too, in place of the kernel."""

    def __enter__(self):
        self.saved = dqn.resize_normalize
        dqn.resize_normalize = lambda x, out, dtype: rn.resize_normalize_reference(x, out).to(dtype)

    def __exit__(self, *exc):
        dqn.resize_normalize = self.saved


def bf16_vs_f32(tmp: Path, dds: DeviceDataset) -> dict:
    """Three float32 steps (no autocast, no TF32, the plain resize twin in
    place of the kernel) from the seeded state, and before each a bf16 step
    from a copy of the same state on the same batch: their losses."""
    configs = {dtype: experiment(tmp / f"precision_{dtype}", **TRAIN_CUTS,
                                 TPU={"COMPUTE_DTYPE": dtype})
               for dtype in ("bfloat16", "float32")}
    state = dqn.create_train_state(configs["float32"])
    steps = {dtype: dqn.make_train_step(state.model, c) for dtype, c in configs.items()}
    out = {"bfloat16": [], "float32": []}
    launched = {"bfloat16": {("identity", "bfloat16"): 2}, "float32": {}}
    with no_tf32():
        for k in range(3):
            batch = dds.sample(k)
            for dtype, st, prologue in (
                    ("bfloat16", copy.deepcopy(state), contextlib.nullcontext()),
                    ("float32", state, plain_prologue())):
                before = rn.LAUNCHES.copy()
                with prologue:
                    out[dtype].append(float(steps[dtype](st, batch)["loss"]))
                if dict(rn.LAUNCHES - before) != launched[dtype]:
                    raise AssertionError(f"a {dtype} step launched {dict(rn.LAUNCHES - before)}")
    diff = [abs(a - b) for a, b in zip(out["bfloat16"], out["float32"])]
    log(f"[train] bf16 losses {out['bfloat16']} vs float32 {out['float32']}: abs diff {diff}")
    for a, b in zip(out["bfloat16"], out["float32"]):
        if not abs(a - b) <= BF16_LOSS_RTOL * abs(b) + BF16_LOSS_ATOL:
            raise AssertionError(f"bf16 loss {a} vs float32 {b}")
    return {"bf16_losses": out["bfloat16"], "f32_losses": out["float32"], "abs_diff": diff}


def card_vs_cpu(tmp: Path) -> dict:
    """Three float32 steps at 96 px, B = 8, across a sync (interval 2), on
    the card and on the CPU from the same seeded state and batches:
    losses and every parameter within CPU_ATOL."""
    tables = synthetic_video_tables(64, 128, 96, seed=SEED)
    rng = np.random.default_rng(SEED)
    host = [TableSource(tables).get_batch(rng.integers(0, 128, 8)) for _ in range(3)]
    config = experiment(tmp / "card_vs_cpu", **{
        **TRAIN_CUTS, "TARGET_UPDATE_INTERVAL": 2,
        "TPU": {"IMAGE_SIZE": 96, "BATCH_SIZE": 8, "COMPUTE_DTYPE": "float32"}})
    results = {}
    with no_tf32():
        for device in ("cuda", "cpu"):
            state = dqn.create_train_state(config, device=device)
            step_fn = dqn.make_train_step(state.model, config)
            losses = [float(step_fn(state, {k: torch.from_numpy(v).to(device)
                                            for k, v in b.items()})["loss"]) for b in host]
            results[device] = (losses, dqn.flax_state_dict(state))
    loss_diff = max(abs(a - b) for a, b in zip(results["cuda"][0], results["cpu"][0]))
    diffs = [np.abs(a - b) for field in ("params", "target_params")
             for a, b in zip(_leaves(results["cuda"][1][field]), _leaves(results["cpu"][1][field]))]
    param_diff = max(float(d.max()) for d in diffs)
    beyond = sum(int((d > CPU_ATOL).sum()) for d in diffs)
    size = sum(d.size for d in diffs)
    cap = CPU_CAP_LR * float(config.LEARNING_RATE)
    log(f"[train] 96 px float32, card vs cpu: losses {results['cuda'][0]} vs "
        f"{results['cpu'][0]}; max abs diff loss {loss_diff:.3g}, params {param_diff:.3g} "
        f"({beyond} of {size} values beyond {CPU_ATOL}; allowed {CPU_BEYOND_MAX}, "
        f"none beyond {cap:.3g})")
    if not (loss_diff <= CPU_ATOL and beyond <= CPU_BEYOND_MAX and param_diff <= cap):
        raise AssertionError(f"card vs cpu: loss {loss_diff} > {CPU_ATOL}, or {beyond} "
                             f"params > {CPU_BEYOND_MAX} beyond {CPU_ATOL}, or the largest "
                             f"{param_diff} > {cap}")
    return {"loss_max_abs_diff": loss_diff, "param_max_abs_diff": param_diff,
            "params_beyond_1e-4": beyond, "params_beyond_1e-4_allowed": CPU_BEYOND_MAX,
            "params": size}


def step_breakdown(tmp: Path, dds: DeviceDataset) -> dict:
    """One bf16 step, device mode: torch.profiler over 3 steps (top
    kernels, the identity kernel's share, busy and idle share), and the
    device time of each phase from CUDA events at the phase boundaries
    (the step's `mark` hook), the mean over 5 steps."""
    config = experiment(tmp / "breakdown", **TRAIN_CUTS)
    state = dqn.create_train_state(config)
    step_fn = dqn.make_train_step(state.model, config)
    k = iter(range(10 ** 6))
    for _ in range(3):
        step_fn(state, dds.sample(next(k)))
    prof = device_profile(lambda: step_fn(state, dds.sample(next(k))), calls=3)
    log_profile("train step, B=256 bf16, device dataset", prof, top=15)
    ident = sum(us for name, (_, us) in prof["by_name"].items()
                if "resize_normalize_identity" in name) / prof["calls"] / 1e3
    if prof["device_ms"]:
        log(f"[profile] train step: identity kernel {ident:.4f} ms/step, "
            f"{ident / prof['device_ms']:.2%} of the step's device time")
    marks = []

    def mark(name):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        marks.append((name, ev))
    # no synchronize between the 5 steps: the host runs ahead as in the
    # loop, so an interval between marks is the device's time for that
    # phase ("end" runs from Adam's last kernel to the next step's sampler)
    for _ in range(5):
        mark("sample")
        batch = dds.sample(next(k))
        step_fn(state, batch, mark)
    torch.cuda.synchronize()
    split, count = {}, {}
    for (name, a), (_, b) in zip(marks, marks[1:]):
        split[name] = split.get(name, 0.0) + a.elapsed_time(b)
        count[name] = count.get(name, 0) + 1
    split = {name: ms / count[name] for name, ms in split.items()}
    total = sum(split.values())
    log("[profile] train step phases (device ms, CUDA events, mean of 5): " + ", ".join(
        f"{n} {ms:.4f} ({ms / total:.1%})" for n, ms in split.items()) + f"; total {total:.4f}")
    return {"device_ms": prof["device_ms"], "wall_ms": prof["wall_ms"],
            "busy_share": prof["busy_share"], "identity_ms": ident, "phases_ms": split}


def train_path() -> dict:
    log(f"[train] published config {PUBLISHED_CONFIG.name} at 224 px, B = 256, bf16, cut: "
        f"{TRAIN_CUTS}; data: {TRAIN_FRAMES} frames, {TRAIN_ROWS} rows")
    t0 = time.perf_counter()
    tables = synthetic_video_tables(TRAIN_FRAMES, TRAIN_ROWS, 224, seed=SEED)
    log(f"[train] made {tables['frames'].nbytes / 1e9:.2f} GB of frames in "
        f"{time.perf_counter() - t0:.2f} s; reward rate {tables['reward'].mean():.4f}")
    _build.BUILD_DIR.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as tmp:
        tmp = Path(tmp)
        device = train_run(tmp, "device_dataset", tables, True)
        device["tables"] = tables
        resume = resume_check(device)
        host = train_run(tmp, "host_fed", tables, False)
        dds = DeviceDataset(tables, int(device["config"].TPU.BATCH_SIZE), seed=SEED)
        precision = bf16_vs_f32(tmp, dds)
        breakdown = step_breakdown(tmp, dds)
        cpu = card_vs_cpu(tmp)
    launches = {path: device["launches"].get((path, "bfloat16"), 0)
                + host["launches"].get((path, "bfloat16"), 0) for path in ("identity", "banded")}
    return {"launches": launches,
            "modes": {m["config"].folder.rsplit("/", 1)[-1]: {
                "ms_per_step": m["rate"]["ms_per_step"], "frames_per_s": m["rate"]["frames_per_s"],
                "peak_gib": m["peak_gib"], "ema_loss": m["ema_loss"], "logged": m["losses"],
                "step_losses": m["step_losses"], "timing_step_losses": m["timing_step_losses"]}
                for m in (device, host)},
            "resume": resume, "precision": precision, "breakdown": breakdown,
            "card_vs_cpu": cpu}


def real_data_checks() -> dict:
    """The fixture against its oracle (expected.npz: the JAX batcher's
    labels, stream and index maps, PIL's frames); the feather reads, the
    decode rates, the wide feather's distinct frames a batch and its device
    table's build."""
    oracle = torch_qdata.check_oracle()
    log(f"[real] {torch_qdata.FEATHER}: {oracle['rows']} rows; labels "
        f"({', '.join(torch_qdata.LABELS)}), reward ratio, index stream and tables() index "
        f"maps equal to expected.npz; decode of {oracle['frames']} frames vs PIL: mean "
        f"|diff| per frame max {oracle['frame_mean_abs_diff_max']:.4f}, overall "
        f"{oracle['mean_abs_diff']:.4f}; largest |diff| {oracle['max_abs_diff']}")
    read_ms = {}
    for feather in (torch_qdata.FEATHER, torch_qdata.WIDE_FEATHER):
        t0 = time.perf_counter()
        cols = read_feather(feather)
        read_ms[feather] = (time.perf_counter() - t0) * 1e3
        log(f"[real] {feather}: {len(cols['before_image'])} rows, {len(cols)} columns read "
            f"in {read_ms[feather]:.3f} ms")

    paths = [str(p) for p in torch_qdata.expected()["paths"]]
    threads = decode_threads() or os.cpu_count()
    rates = {}
    for label, videos in (("1280x720", ("vid000", "vid001")), ("640x360", ("vid002",))):
        mine = [p for p in paths if any(f"/{v}/" in p for v in videos)]
        batch = (mine * (DECODE_BATCH // len(mine) + 1))[:DECODE_BATCH]
        load_images(batch[:64], IMAGE_SIZE)
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            load_images(batch, IMAGE_SIZE)
            times.append(time.perf_counter() - t0)
        rates[label] = DECODE_BATCH / float(np.median(times))
        log(f"[real] decode {label} -> {IMAGE_SIZE}: {rates[label]:.1f} frames/s "
            f"({DECODE_BATCH} per call, {threads} threads, median of 3)")

    t0 = time.perf_counter()
    files = torch_qdata.link_wide_frames()
    link_s = time.perf_counter() - t0
    batcher = QLearningBatcher(torch_qdata.WIDE_FEATHER, image_size=IMAGE_SIZE,
                               **torch_qdata.PUBLISHED)
    stream = batcher.index_stream(int(get_cfg_defaults().TPU.BATCH_SIZE))
    distinct = [len(set(batcher.cols["before_image"][rows])
                    | set(batcher.cols["after_image"][rows]))
                for rows in (next(stream) for _ in range(8))]
    log(f"[real] {torch_qdata.WIDE_FEATHER}: {len(batcher)} rows over {files} frame files "
        f"(linked in {link_s:.2f} s); distinct frames in the first 8 batches: {distinct}")
    if min(distinct) < 480:
        raise AssertionError(f"a wide batch names only {min(distinct)} distinct frames")
    t0 = time.perf_counter()
    tables = batcher.tables(torch.cuda.mem_get_info()[1])
    decode_s = time.perf_counter() - t0
    dds = DeviceDataset(tables, 256, seed=SEED)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    log(f"[real] device table of {torch_qdata.WIDE_FEATHER}: {len(tables['frames'])} frames, "
        f"{dds.bytes / 1e6:.2f} MB, built in {build_s:.4f} s (decode {decode_s:.4f} s, "
        f"{len(tables['frames']) / decode_s:.1f} frames/s)")
    del dds, tables
    return {"feather_read_ms": read_ms, "wide_rows": len(batcher), "wide_files": files,
            "wide_distinct_frames_per_batch": distinct, "oracle": oracle,
            "decode_frames_per_s": rates, "decode_threads": threads,
            "table_build_s": build_s, "table_decode_s": decode_s}


def real_data_run(tmp: Path, name: str, device_dataset: bool) -> dict:
    """The CLI on the fixture in one data mode: a timing run (no
    checkpoints, also the warm-up), then the counted run with the checks."""
    cuts = {**TRAIN_CUTS, "DATASET": torch_qdata.WIDE_FEATHER,
            "TPU": {"DEVICE_DATASET": device_dataset}}
    every = ["--log-every", str(TRAIN_LOG_EVERY)]
    timing = write_experiment(tmp / f"{name}_timing", **{**cuts, "CHECKPOINT_INTERVAL": 10 ** 6})
    train_q_network.main([timing, *every], device=ONE_CARD)
    rate = steady_rate(ExperimentConfig(timing, resume=True))

    folder = write_experiment(tmp / name, **cuts)
    torch.cuda.synchronize()
    rn.LAUNCHES.clear()
    t0 = time.perf_counter()
    with TrainSpy() as spy:
        state, loss = train_q_network.main([folder, *every], device=ONE_CARD)
    wall = time.perf_counter() - t0
    launches = dict(rn.LAUNCHES)
    steps = TRAIN_CUTS["NUM_STEPS"]
    config = ExperimentConfig(folder, resume=True)
    losses = [r["value"] for r in read_metrics(config.run_dir, "avg_q_loss/train")]
    log(f"[real] {name}: {steps} steps in {wall:.2f} s (start-up and checkpoints included); "
        f"launches {launches}; logged EMA losses {losses}; steady state "
        f"{rate['ms_per_step']:.4f} ms/step, {rate['frames_per_s']:.1f} frames/s (windows "
        f"{[round(r, 1) for r in rate['windows_frames_per_s']]})")
    check_counted_run(name, spy, config)
    return {"folder": folder, "spy": spy, "launches": launches, "rate": rate,
            "ema_loss": float(state.ema_loss), "losses": losses}


def real_data_resume(first: dict) -> dict:
    """-r from sample20 (the later checkpoint taken away): the rows of steps
    21-30 and the final EMA loss of the first run."""
    os.remove(Path(first["folder"]) / "models" / f"sample{TRAIN_CUTS['NUM_STEPS']}.ckpt")
    with TrainSpy() as spy:
        state, _ = train_q_network.main(["-r", first["folder"], "--log-every",
                                         str(TRAIN_LOG_EVERY)], device=ONE_CARD)
    return check_resume("[real] -r:", spy, first, float(state.ema_loss))


def real_data_path() -> dict:
    os.chdir(ROOT)  # the fixture's DATASET and frame paths are relative to the repo root
    checks = real_data_checks()
    _build.BUILD_DIR.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as tmp:
        tmp = Path(tmp)
        device = real_data_run(tmp, "real_device_dataset", True)
        resume = real_data_resume(device)
        host = real_data_run(tmp, "real_host_fed", False)
    gap = host["rate"]["ms_per_step"] / device["rate"]["ms_per_step"] - 1
    log(f"[real] host-fed {host['rate']['ms_per_step']:.4f} ms/step vs device table "
        f"{device['rate']['ms_per_step']:.4f} ms/step: host-fed {gap:.1%} slower with real "
        f"JPEG decode")
    launches = {path: device["launches"].get((path, "bfloat16"), 0)
                + host["launches"].get((path, "bfloat16"), 0) for path in ("identity", "banded")}
    return {"launches": launches, **checks, "resume": resume, "host_fed_gap": gap,
            "modes": {name: {"ms_per_step": m["rate"]["ms_per_step"],
                             "frames_per_s": m["rate"]["frames_per_s"],
                             "ema_loss": m["ema_loss"], "logged": m["losses"]}
                      for name, m in (("device_dataset", device), ("host_fed", host))}}


# -- phases 7 and 8: the inverse model ---------------------------------------
INV_BATCH = 128            # the inverse CLI's default batch
INV_STEPS, INV_VALIDATE, INV_VAL_BATCHES = 30, 10, 2
INV_PAIRS, INV_STATES = 2048, 512
INV_LR = 1e-3
INV_CPU_SIZE, INV_CPU_BATCH = 192, 8   # the VALID head, small enough for the CPU
# the float32 card labels against the CPU's and the bf16 ones against the
# float32 ones, compared where the float32 calibrated margin is this wide
LABEL_MARGIN, LABEL_BF16_MARGIN = 1e-3, 0.05
EPISODE_VIDEOS, EPISODE_FRAMES = 8, 64


class InverseSpy:
    """Watches the inverse trainer without changing it: the kernel launches
    of each step, and the host clock after a synchronize at the steps in
    `sync_at`."""

    def __init__(self, sync_at=()):
        self.sync_at = set(sync_at)

    def __enter__(self):
        self.steps, self.times = [], {}
        self._saved = inverse.make_inverse_step
        make = self._saved

        def make_spied(model, dtype=torch.bfloat16, mesh=None):
            step_fn = make(model, dtype, mesh)

            def spied(state, batch, dropout_mask=None, mark=None):
                before = rn.LAUNCHES.copy()
                out = step_fn(state, batch, dropout_mask, mark)
                self.steps.append(dict(rn.LAUNCHES - before))
                if len(self.steps) in self.sync_at:
                    torch.cuda.synchronize()
                    self.times[len(self.steps)] = time.perf_counter()
                return out
            return spied

        inverse.make_inverse_step = make_spied
        return self

    def __exit__(self, *exc):
        inverse.make_inverse_step = self._saved


def inverse_flags(pairs: dict, out_dir: Path, cache: bool) -> list:
    return ["--train_data", pairs["train"], "--val_data", pairs["val"],
            "--image_root", pairs["root"], "--image_size", str(IMAGE_SIZE),
            "--batch_size", str(INV_BATCH), "--num_steps", str(INV_STEPS),
            "--lr", str(INV_LR), "--seed", str(SEED), "--out_dir", str(out_dir)] \
        + (["--cache-images"] if cache else [])


def inverse_run(tmp: Path, pairs: dict, cache: bool) -> dict:
    """The CLI in one decode mode: a timing run (no validation, steps 11-30
    timed between two synchronizes; also the warm-up), then the counted run
    with validation every INV_VALIDATE steps and the checks."""
    name = "cached" if cache else "decoding"
    with InverseSpy(sync_at=(10, INV_STEPS)) as timing:
        train_inverse_model.main(inverse_flags(pairs, tmp / f"{name}_timing", cache),
                                 device=ONE_CARD, validate_every=10 ** 6, val_batches=0)
    ms = (timing.times[INV_STEPS] - timing.times[10]) / (INV_STEPS - 10) * 1e3

    out_dir = tmp / name
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    rn.LAUNCHES.clear()
    t0 = time.perf_counter()
    with InverseSpy() as spy:
        state, accuracy = train_inverse_model.main(
            inverse_flags(pairs, out_dir, cache), device=ONE_CARD, validate_every=INV_VALIDATE,
            val_batches=INV_VAL_BATCHES)
    wall = time.perf_counter() - t0
    launches = dict(rn.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    want = {("identity", "bfloat16"): 1}
    if len(spy.steps) != INV_STEPS or any(d != want for d in spy.steps):
        raise AssertionError(f"inverse {name}: launches per step {spy.steps}, not {want} each")
    evals = INV_STEPS // INV_VALIDATE * INV_VAL_BATCHES + 10  # validations, the final line's
    if launches != {("identity", "bfloat16"): INV_STEPS + evals}:
        raise AssertionError(f"inverse {name}: {launches} in the run, not "
                             f"{INV_STEPS + evals} bf16 identity launches")
    scalars = read_metrics(str(out_dir))
    tags = sorted({r["tag"] for r in scalars})
    if tags != ["Accuracy/train", "Accuracy/val", "Loss/train", "Loss/val"] or \
            len(scalars) != 4 * INV_STEPS // INV_VALIDATE or \
            not all(np.isfinite(r["value"]) for r in scalars):
        raise AssertionError(f"inverse {name}: scalars {scalars}")
    names = sorted(p.name for p in out_dir.glob("sample*.ckpt"))
    if names != sorted(f"sample{k}.ckpt" for k in range(INV_VALIDATE, INV_STEPS + 1,
                                                         INV_VALIDATE)):
        raise AssertionError(f"inverse {name}: checkpoints {names}")
    losses = [round(r["value"], 6) for r in scalars if r["tag"].startswith("Loss")]
    log(f"[inverse] {name}: {INV_STEPS} steps at B = {INV_BATCH} in {wall:.2f} s (start-up, "
        f"validation and checkpoints included); launches {launches}; losses (train, val at "
        f"10/20/30) {losses}; final val accuracy {accuracy:.4f}; peak device memory "
        f"{peak:.2f} GiB; steady state {ms:.4f} ms/step, {INV_BATCH / ms * 1e3:.1f} pairs/s")
    return {"state": state, "models_dir": str(out_dir), "launches": launches, "ms_per_step": ms,
            "pairs_per_s": INV_BATCH / ms * 1e3, "peak_gib": peak, "losses": losses,
            "final_val_accuracy": accuracy, "wall_s": wall}


def inverse_trunk_unchanged(state) -> None:
    """After 30 Adam steps the card's trunk equals the seeded init bit for bit."""
    with contextlib.redirect_stdout(io.StringIO()):
        init = inverse.create_inverse_state(image_size=IMAGE_SIZE, seed=SEED, device="cpu")
    for (name, a), b in zip(state.model.resnet18.state_dict().items(),
                            init.model.resnet18.state_dict().values()):
        if not torch.equal(a.cpu(), b):
            raise AssertionError(f"the frozen trunk moved: resnet18.{name}")


def inverse_batches(pairs: dict, size: int, batch: int, n: int, device) -> list:
    b = GibsonPairBatcher(pairs["train"], image_root=pairs["root"], image_size=size, seed=SEED)
    return [inverse.to_device(b.get_batch(batch_size=batch), device) for _ in range(n)]


def inverse_bf16_vs_f32(pairs: dict) -> dict:
    """Three steps at B = 128 from the same seeded state, batches and
    dropout masks in bf16 and in float32 (no TF32): their losses."""
    batches = inverse_batches(pairs, IMAGE_SIZE, INV_BATCH, 3, "cuda")
    g = torch.Generator(device="cuda").manual_seed(SEED)
    masks = [torch.rand((INV_BATCH, 128), device="cuda", generator=g) < 0.5 for _ in batches]
    out = {}
    with no_tf32(), contextlib.redirect_stdout(io.StringIO()):
        for dtype in (torch.bfloat16, torch.float32):
            state = inverse.create_inverse_state(INV_LR, seed=SEED, image_size=IMAGE_SIZE)
            step_fn = inverse.make_inverse_step(state.model, dtype)
            out[dtype] = [float(step_fn(state, b, m)["loss"]) for b, m in zip(batches, masks)]
    diff = [abs(a - b) for a, b in zip(out[torch.bfloat16], out[torch.float32])]
    log(f"[inverse] bf16 losses {out[torch.bfloat16]} vs float32 {out[torch.float32]}: "
        f"abs diff {diff}")
    for a, b in zip(out[torch.bfloat16], out[torch.float32]):
        if not abs(a - b) <= BF16_LOSS_RTOL * abs(b) + BF16_LOSS_ATOL:
            raise AssertionError(f"inverse bf16 loss {a} vs float32 {b}")
    return {"bf16_losses": out[torch.bfloat16], "f32_losses": out[torch.float32],
            "abs_diff": diff}


def inverse_card_vs_cpu(pairs: dict) -> dict:
    """Three float32 steps at 192 px (the VALID head), B = 8, the rate
    decaying after the second, from the same seeded state, batches and
    dropout masks on the card and on the CPU: losses within CPU_ATOL, the
    parameters within it but for CPU_BEYOND_MAX values, none beyond
    CPU_CAP_LR lr."""
    host = inverse_batches(pairs, INV_CPU_SIZE, INV_CPU_BATCH, 3, "cpu")
    g = torch.Generator().manual_seed(SEED)
    masks = [torch.rand((INV_CPU_BATCH, 128), generator=g) < 0.5 for _ in host]
    results = {}
    with no_tf32(), contextlib.redirect_stdout(io.StringIO()):
        for device in ("cuda", "cpu"):
            state = inverse.create_inverse_state(INV_LR, 0.9, 2, seed=SEED,
                                                 image_size=INV_CPU_SIZE, device=device)
            step_fn = inverse.make_inverse_step(state.model, torch.float32)
            losses = [float(step_fn(state, {k: v.to(device) for k, v in b.items()},
                                    m.to(device))["loss"]) for b, m in zip(host, masks)]
            results[device] = losses, inverse.flax_state_dict(state)
    loss_diff = max(abs(a - b) for a, b in zip(results["cuda"][0], results["cpu"][0]))
    diffs = [np.abs(a - b) for a, b in zip(_leaves(results["cuda"][1]["params"]),
                                           _leaves(results["cpu"][1]["params"]))]
    param_diff = max(float(d.max()) for d in diffs)
    beyond = sum(int((d > CPU_ATOL).sum()) for d in diffs)
    size = sum(d.size for d in diffs)
    cap = CPU_CAP_LR * INV_LR
    log(f"[inverse] {INV_CPU_SIZE} px float32, card vs cpu: losses {results['cuda'][0]} vs "
        f"{results['cpu'][0]}; max abs diff loss {loss_diff:.3g}, params {param_diff:.3g} "
        f"({beyond} of {size} values beyond {CPU_ATOL}; allowed {CPU_BEYOND_MAX}, none "
        f"beyond {cap:.3g})")
    if not (loss_diff <= CPU_ATOL and beyond <= CPU_BEYOND_MAX and param_diff <= cap):
        raise AssertionError(f"inverse card vs cpu: loss {loss_diff}, {beyond} params beyond "
                             f"{CPU_ATOL}, largest {param_diff}")
    return {"loss_max_abs_diff": loss_diff, "param_max_abs_diff": param_diff,
            "params_beyond_1e-4": beyond, "params": size}


def phase_split(run, marks_of: list, steps: int = 5) -> dict:
    """Device ms of each phase of `steps` unsynchronized calls of run(mark),
    from CUDA events recorded as each phase begins."""
    marks = []

    def mark(name):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        marks.append((name, ev))
    for _ in range(steps):
        run(mark)
    mark("done")
    torch.cuda.synchronize()
    split = {}
    for (name, a), (_, b) in zip(marks, marks[1:]):
        if name in marks_of:
            split[name] = split.get(name, 0.0) + a.elapsed_time(b) / steps
    return split


def inverse_breakdown(state, pairs: dict) -> dict:
    """One bf16 step at B = 128 on cached frames: torch.profiler over 3
    steps (busy and idle share, top kernels) and the device time of each
    phase (prologue, trunk, head, loss, backward, Adam) from CUDA events."""
    batches = inverse_batches(pairs, IMAGE_SIZE, INV_BATCH, 2, "cuda")
    step_fn = inverse.make_inverse_step(state.model, torch.bfloat16)
    k = iter(range(10 ** 6))
    prof = device_profile(lambda: step_fn(state, batches[next(k) % 2]), calls=3)
    log_profile(f"inverse step, B={INV_BATCH} bf16, batch on the card", prof, top=12)
    split = phase_split(lambda mark: step_fn(state, batches[next(k) % 2], mark=mark),
                        inverse.PHASES)
    total = sum(split.values())
    log("[profile] inverse step phases (device ms, CUDA events, mean of 5): " + ", ".join(
        f"{n} {ms:.4f} ({ms / total:.1%})" for n, ms in split.items()) + f"; total {total:.4f}")
    return {"device_ms": prof["device_ms"], "wall_ms": prof["wall_ms"],
            "busy_share": prof["busy_share"], "phases_ms": split}


def inverse_path() -> dict:
    """Phase 7: the inverse CLI at 224 px, B = 128, bf16, 30 steps, with and
    without the RAM cache of decoded states."""
    os.chdir(ROOT)
    t0 = time.perf_counter()
    train, root = torch_qdata.make_pairs(torch_qdata.PAIRS_ROOT, rows=INV_PAIRS,
                                         states=INV_STATES, seed=SEED)
    val, _ = torch_qdata.make_pairs(torch_qdata.PAIRS_ROOT, rows=INV_PAIRS // 4,
                                    states=INV_STATES, seed=SEED + 1, name="val.npy")
    pairs = {"train": train, "val": val, "root": root}
    log(f"[inverse] pairs: {INV_PAIRS} train and {INV_PAIRS // 4} val rows over {INV_STATES} "
        f"state folders (links to the committed frames), made in "
        f"{time.perf_counter() - t0:.2f} s; published geometry {IMAGE_SIZE} px, "
        f"B = {INV_BATCH}, bf16, lr {INV_LR}, {INV_STEPS} steps, validation every "
        f"{INV_VALIDATE} over {INV_VAL_BATCHES} batches")
    _build.BUILD_DIR.mkdir(exist_ok=True)
    tmp = Path(tempfile.mkdtemp(dir=_build.BUILD_DIR))
    decoding = inverse_run(tmp, pairs, cache=False)
    cached = inverse_run(tmp, pairs, cache=True)
    for run in (decoding, cached):
        inverse_trunk_unchanged(run["state"])
    log("[inverse] the frozen trunk is bit-unchanged after 30 Adam steps in both runs")
    precision = inverse_bf16_vs_f32(pairs)
    cpu = inverse_card_vs_cpu(pairs)
    breakdown = inverse_breakdown(cached["state"], pairs)
    log(f"[inverse] steady state: decoding {decoding['ms_per_step']:.4f} ms/step "
        f"({decoding['pairs_per_s']:.1f} pairs/s), cached {cached['ms_per_step']:.4f} ms/step "
        f"({cached['pairs_per_s']:.1f} pairs/s)")
    return {"tmp": tmp, "models_dir": cached["models_dir"],
            "launches": {path: decoding["launches"].get((path, "bfloat16"), 0)
                         + cached["launches"].get((path, "bfloat16"), 0)
                         for path in ("identity", "banded")},
            "modes": {name: {k: v for k, v in run.items()
                             if k not in ("state", "models_dir", "launches")}
                      for name, run in (("decoding", decoding), ("cached", cached))},
            "precision": precision, "card_vs_cpu": cpu, "breakdown": breakdown}


def margins(logits: np.ndarray) -> np.ndarray:
    top2 = np.sort(logits, axis=1)[:, -2:]
    return top2[:, 1] - top2[:, 0]


def label_path(phase7: dict) -> dict:
    """Phase 8: phase 7's checkpoint labels wide.feather's 4,096 rows in
    bf16 (the main path), against float32 card labels; float32 card labels
    against the CPU's on data.feather; process_episodes' CLI writes a
    data.feather that the port reads back."""
    os.chdir(ROOT)
    torch_qdata.link_wide_frames()
    wide = read_feather(torch_qdata.WIDE_FEATHER)
    before, after = list(wide["before_image"]), list(wide["after_image"])
    model = inverse.load_inverse_checkpoint(phase7["models_dir"], image_size=IMAGE_SIZE).model
    labeler = make_inverse_labeler(model)
    labeler.logits_rows(before[:512], after[:512], IMAGE_SIZE)  # warm-up
    labeler.timing.update(decode_s=0.0, device_s=0.0, rows=0)
    rn.LAUNCHES.clear()
    t0 = time.perf_counter()
    bf16 = labeler.logits_rows(before, after, IMAGE_SIZE)
    wall = time.perf_counter() - t0
    launches = rn.LAUNCHES[("identity", "bfloat16")]
    if dict(rn.LAUNCHES) != {("identity", "bfloat16"): launches} or launches == 0:
        raise AssertionError(f"the labeler launched {dict(rn.LAUNCHES)}")
    timing = dict(labeler.timing)
    log(f"[label] {torch_qdata.WIDE_FEATHER}: {len(before)} rows labelled in {wall:.3f} s, "
        f"{len(before) / wall:.1f} rows/s (decode {timing['decode_s']:.3f} s, device "
        f"{timing['device_s']:.3f} s); {launches} bf16 identity launches; label counts "
        f"{np.bincount(bf16.argmax(1), minlength=3).tolist()}")
    with no_tf32():
        f32 = make_inverse_labeler(model, dtype=torch.float32).logits_rows(before, after,
                                                                           IMAGE_SIZE)
    wide_rows = margins(f32) >= LABEL_BF16_MARGIN
    differ = int((bf16.argmax(1) != f32.argmax(1))[wide_rows].sum())
    log(f"[label] bf16 vs float32 card labels: {differ} differ of {int(wide_rows.sum())} rows "
        f"with a float32 margin of at least {LABEL_BF16_MARGIN} ({int((~wide_rows).sum())} "
        f"rows below it); calibrated logits max abs diff {float(np.abs(bf16 - f32).max()):.3g}")
    if differ:
        raise AssertionError(f"{differ} bf16 labels differ from float32 ones")

    data = read_feather(torch_qdata.FEATHER)
    rows = list(data["before_image"]), list(data["after_image"])
    with no_tf32():
        card = make_inverse_labeler(model, dtype=torch.float32).logits_rows(*rows, IMAGE_SIZE)
    cpu_model = inverse.load_inverse_checkpoint(phase7["models_dir"], image_size=IMAGE_SIZE,
                                                device="cpu").model
    cpu = make_inverse_labeler(cpu_model, batch_size=64, dtype=torch.float32,
                               device="cpu").logits_rows(*rows, IMAGE_SIZE)
    wide_rows = margins(cpu) >= LABEL_MARGIN
    differ = int((card.argmax(1) != cpu.argmax(1))[wide_rows].sum())
    log(f"[label] {torch_qdata.FEATHER}: float32 card vs cpu labels: {differ} differ of "
        f"{int(wide_rows.sum())} rows with a margin of at least {LABEL_MARGIN} "
        f"({int((~wide_rows).sum())} below); calibrated logits max abs diff "
        f"{float(np.abs(card - cpu).max()):.3g}")
    if differ:
        raise AssertionError(f"{differ} card labels differ from the CPU's")

    t0 = time.perf_counter()
    location = torch_qdata.make_episodes(torch_qdata.EPISODES_ROOT, videos=EPISODE_VIDEOS,
                                         frames=EPISODE_FRAMES, seed=SEED)
    with contextlib.redirect_stdout(io.StringIO()):
        cpu_cols = read_feather(process_episodes.main(["--location", location], device="cpu"))
    rn.LAUNCHES.clear()
    t1 = time.perf_counter()
    out = process_episodes.main(["--location", location, "--inverse-ckpt",
                                 phase7["models_dir"], "--image-size", str(IMAGE_SIZE)])
    episodes_s = time.perf_counter() - t1
    episode_launches = rn.LAUNCHES[("identity", "bfloat16")]
    episode_banded = rn.LAUNCHES[("banded", "bfloat16")]
    cols = read_feather(out)
    if list(cols) != list(cpu_cols) + ["inverse_actions"] or any(
            cols[k].dtype != v.dtype or not np.array_equal(cols[k], v) for k, v in cpu_cols.items()):
        raise AssertionError("process_episodes on the card wrote other columns than the CPU")
    batcher = QLearningBatcher(out, inverse_actions=True, seed=SEED, image_size=IMAGE_SIZE)
    if not np.array_equal(batcher.action, cols["inverse_actions"].astype(np.int32)) or \
            episode_launches == 0:
        raise AssertionError("the written feather's labels do not read back")
    log(f"[label] process_episodes: {len(cols['before_image'])} rows from {EPISODE_VIDEOS} "
        f"videos of {EPISODE_FRAMES} frames (fixture made in {t1 - t0:.2f} s) written in "
        f"{episodes_s:.3f} s with {episode_launches} bf16 identity launches; columns equal to "
        f"the CPU's but inverse_actions; read back by QLearningBatcher (reward ratio "
        f"{batcher.reward_percentage():.4f})")
    shutil.rmtree(phase7["tmp"], ignore_errors=True)
    # the labeler's run launched identity alone (checked above)
    return {"launches": {"identity": launches + episode_launches, "banded": episode_banded},
            "rows_per_s": len(before) / wall, "decode_s": timing["decode_s"],
            "device_s": timing["device_s"], "wall_s": wall,
            "bf16_rows_below_margin": int((margins(f32) < LABEL_BF16_MARGIN).sum()),
            "cpu_rows_below_margin": int((~wide_rows).sum()),
            "episode_rows": len(cols["before_image"]), "episodes_s": episodes_s}


# -- phase 9: evaluation ---------------------------------------------------------

# a reasoning stop's views and the fake env's map: int(max(10 m, 2.2 d) *
# 230) cm at 5 cm a cell, 461 cells a side for goals up to 4.5 m away
STOP_VIEWS, EVAL_MAP = 12, 461
CELL_SHARE = 1e-4          # card map delta points in another cell than the CPU's
GEODESIC_EPISODES = 4
EVAL_EPISODES, EVAL_IN_FLIGHT, EVAL_PIPELINE = 16, 8, 2
PROFILED_EPISODES = 4      # the profiled run that gives the device's idle share


def fake_env_stop(seed: int) -> tuple:
    """A reasoning stop's 12 left-turn renders of the fake env at 224 px,
    in cm and cleaned as the mapper cleans them, and their map poses."""
    env = FakeNavEnv(image_size=IMAGE_SIZE, seed=seed)
    pos, ang = env.sample_start_state()
    env.set_agent_state(pos, ang)
    depths, locs = [], []
    for k in range(STOP_VIEWS):
        obs, _, _, _ = env.step(1)
        depths.append(obs["depth"][..., 0] * 1000.0)
        locs.append([EVAL_MAP * 2.5 + 3 * k, EVAL_MAP * 2.5 - 2 * k, env.angle])
    d = np.stack(depths).astype(np.float32)
    d[d > 990] = np.nan
    d[d == 0] = np.nan
    return d, np.array(locs, np.float32)


def map_delta_check() -> dict:
    """Phase 9 (a): a 12-view stop's map delta on the card against the CPU
    port, with TF32 on and off, and what a stop's and an agent step's
    mapping cost: the profiled device ms of its kernels (and the interval
    between CUDA events around it), the delta's copy to the host, and the
    mapper's whole add_observations_batch on the host clock."""
    d, locs = fake_env_stop(SEED)
    cam = get_camera_matrix(IMAGE_SIZE, IMAGE_SIZE, 90)
    args = (cam, EVAL_MAP, 125.0, (20.0, 125.0), 5.0, 0.0)
    want = observations_to_map_delta(torch.from_numpy(d), torch.from_numpy(locs), *args).numpy()
    valid = int(want.sum())
    # the poses stay on the host, as the mapper passes them
    dc, lc = torch.from_numpy(d).cuda(), torch.from_numpy(locs)
    worst = 0
    for tf32 in (True, False):
        with no_tf32():
            torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = tf32
            got = observations_to_map_delta(dc, lc, *args).cpu().numpy()
        apart = int(np.abs(got - want).sum() // 2)
        log(f"[eval] map delta of a 12-view {IMAGE_SIZE}^2 stop, TF32 {'on' if tf32 else 'off'}: "
            f"card vs cpu {apart} of {valid} valid points in another cell "
            f"(allowed {CELL_SHARE:g} of them), totals {int(got.sum())} / {valid}")
        if valid == 0 or got.sum() != valid or apart > CELL_SHARE * valid:
            raise AssertionError(f"card map delta: {apart} points moved, totals "
                                 f"{got.sum()} vs {valid}")
        worst = max(worst, apart)
    out = {"valid_points": valid, "points_in_another_cell": worst}
    for views in (STOP_VIEWS, 1):
        dv, lv = dc[:views], lc[:views]
        delta = observations_to_map_delta(dv, lv, *args)
        prof = device_profile(lambda: observations_to_map_delta(dv, lv, *args), calls=10)
        log_profile(f"map delta, {views} view(s)", prof, top=6)
        planner = DepthMapperAndPlanner(map_size_cm=(EVAL_MAP - 1) * 5)
        planner._reset(1.0, start_pos=np.zeros(3), start_ang=0.0)
        for _ in range(3):
            planner.add_observations_batch(d[:views], locs[:views])
        host = []
        for _ in range(20):
            t0 = time.perf_counter()
            planner.add_observations_batch(d[:views], locs[:views])
            host.append((time.perf_counter() - t0) * 1e3)
        row = {"device_ms": prof["device_ms"], "events_ms": cuda_ms(
                   lambda: observations_to_map_delta(dv, lv, *args)),
               "wall_ms": prof["wall_ms"], "busy_share": prof["busy_share"],
               "kernels_per_call": sum(n for n, _ in prof["by_name"].values()) / 10,
               "copy_back_ms": cuda_ms(lambda: delta.cpu()),
               "add_observations_ms": float(np.median(host))}
        out[f"{views}_views"] = row
        log(f"[eval] mapping {views} view(s) at {IMAGE_SIZE}^2 into a {EVAL_MAP}^2 x 3 map: "
            f"device {row['device_ms']:.4f} ms in {row['kernels_per_call']:g} kernels and "
            f"copies (profiled), {row['events_ms']:.4f} ms between CUDA events, wall "
            f"{row['wall_ms']:.4f} ms; copy of the {delta.numel() * 4 / 1e6:.2f} MB delta to "
            f"the host {row['copy_back_ms']:.4f} ms; the mapper's add_observations_batch "
            f"{row['add_observations_ms']:.4f} ms (host clock, median of 20)")
    return out


def geodesic_run(tmp: Path, device, stop: bool) -> dict:
    cfg = get_eval_defaults()
    cfg.SLAM, cfg.SEED, cfg.STOP = True, SEED, stop
    cfg.RESULT_LOCATION = str(tmp / f"{device}_{stop}")
    episodes, env_factory, house_factory = make_episode_set(GEODESIC_EPISODES,
                                                            size=IMAGE_SIZE, seed=SEED)
    with contextlib.redirect_stdout(io.StringIO()):
        run_policy(cfg, episodes, env_factory=env_factory, house_factory=house_factory,
                   scorer_factory=lambda env, ci: make_geodesic_scorer(env),
                   visualize_every=0, device=device)
    return DiskReader(str(Path(cfg.RESULT_LOCATION) / name_from_config(cfg))).data()


def geodesic_check(tmp: Path) -> dict:
    """Phase 9 (b): 4 geodesic-scored episodes at 224 px on the card and on
    the CPU: equal step logs (STOP mode) and equal SPL."""
    t0 = time.perf_counter()
    logs = {d: geodesic_run(tmp, d, True) for d in ("cuda", "cpu")}
    spl = {d: geodesic_run(tmp, d, False) for d in ("cuda", "cpu")}
    steps = 0
    for k in range(GEODESIC_EPISODES):
        got, want = logs["cuda"].get(k), logs["cpu"].get(k)
        if got is None or want is None or len(got) != len(want) or any(
                not np.array_equal(g[0], w[0]) or list(g[1:]) != list(w[1:])
                for g, w in zip(got, want)):
            raise AssertionError(f"geodesic episode {k}: the card's step log differs from the CPU's")
        steps += len(got)
    if spl["cuda"] != spl["cpu"] or len(spl["cpu"]) != GEODESIC_EPISODES:
        raise AssertionError(f"geodesic SPL card {spl['cuda']} vs cpu {spl['cpu']}")
    seconds = time.perf_counter() - t0
    log(f"[eval] {GEODESIC_EPISODES} geodesic episodes at {IMAGE_SIZE} px, card vs cpu: "
        f"{steps} logged steps equal, SPL equal {[round(v, 4) for v in spl['cpu'].values()]} "
        f"({seconds:.1f} s for the four runs)")
    return {"logged_steps": steps, "spl": [float(v) for v in spl["cpu"].values()]}


class EvalClock:
    """Host time of one batched eval run, split per reasoning stop and per
    agent step, without changing what runs. Valid with host_workers 0 (the
    episodes advance one at a time on this thread): each episode's
    generator is wrapped, and the planner's, env's and FMM's calls are
    charged to the episode that runs. A stop runs from log_reasoning to its
    yield of the views, and from the scores' arrival to its 12th
    check_movement; the time between is the scorer's. Each fused score call
    is split evenly among the stops it serves."""

    CATS = ("render", "mapping", "traversible", "fmm")

    def __init__(self, env_cls=FakeNavEnv):
        self.env_cls = env_cls   # whose step (its render among it) is "render"

    def __enter__(self):
        self.stops, self.calls, self.agent_steps, self.walk = [], [], 0, dict.fromkeys(self.CATS, 0.0)
        self.walk_s, self.current, self.model = 0.0, None, None
        self._saved = (batched_runner.episode_generator, evaluate_mod.check_movement,
                       mapper_mod.fmm_distance, evaluate_cli.make_multiclass_scorer,
                       {n: getattr(DepthMapperAndPlanner, n) for n in (
                           "log_reasoning", "add_observations_batch", "get_traversible",
                           "log_act")},
                       self.env_cls.step)
        gen_fn, check, fmm_fn, make_scorer, methods, step = self._saved
        clock = self

        def charge(cat, fn):
            def timed(*a, **kw):
                t0 = time.perf_counter()
                try:
                    return fn(*a, **kw)
                finally:
                    ep = clock.current
                    if ep is not None:
                        (ep["stop"] if ep["stop"] is not None else clock.walk)[cat] += \
                            time.perf_counter() - t0
            return timed

        class Timed:
            def __init__(self, gen):
                self.gen = gen
                self.ep = {"stop": None, "open": None, "checks": 0, "pending": False}

            def _advance(self, fn):
                ep = self.ep
                t0 = time.perf_counter()
                clock.current = ep
                if ep["stop"] is not None:
                    ep["open"] = t0
                try:
                    return fn()
                finally:
                    t1 = time.perf_counter()
                    clock.current = None
                    inside = 0.0
                    if ep["stop"] is not None:      # yielded the stop's views
                        ep["stop"]["wall"] += t1 - ep["open"]
                        inside = t1 - ep["open"]
                    clock.walk_s += t1 - t0 - inside - ep.pop("closed", 0.0)

            def __next__(self):
                return self._advance(lambda: next(self.gen))

            def send(self, value):
                return self._advance(lambda: self.gen.send(value))

        def gen_timed(*a, **kw):
            return Timed(gen_fn(*a, **kw))

        def log_reasoning(planner):
            ep = clock.current
            ep["stop"] = {"wall": 0.0, **dict.fromkeys(clock.CATS, 0.0)}
            ep["open"], ep["checks"] = time.perf_counter(), 0
            return methods["log_reasoning"](planner)

        def check_timed(*a, **kw):
            out = check(*a, **kw)
            ep = clock.current
            ep["checks"] += 1
            if ep["checks"] == STOP_VIEWS:          # the stop's last check
                t = time.perf_counter()
                ep["stop"]["wall"] += t - ep["open"]
                ep["closed"] = t - ep["open"]
                clock.stops.append(ep["stop"])
                ep["stop"] = None
            return out

        def log_act(planner, *a, **kw):
            clock.agent_steps += 1
            return methods["log_act"](planner, *a, **kw)

        def make_scorer_timed(model, **kw):
            clock.model = model
            inner = make_scorer(model, **kw)

            def dispatch(images, cls):
                t0 = time.perf_counter()
                handle = inner.dispatch(images, cls)
                views = np.array(images)
                views = views[:, None] if views.ndim == 4 else views  # (B, F, H, W, 3)
                return handle, views, np.array(cls), time.perf_counter() - t0

            def gather(handle):
                h, images, cls, dispatch_s = handle
                t0 = time.perf_counter()
                scores = inner.gather(h)
                clock.calls.append({"views": images, "cls": cls, "scores": scores,
                                    "dispatch_s": dispatch_s,
                                    "gather_s": time.perf_counter() - t0})
                return scores

            scorer = lambda images, cls: gather(dispatch(images, cls))  # noqa: E731
            scorer.dispatch, scorer.gather = dispatch, gather
            return scorer

        batched_runner.episode_generator = gen_timed
        evaluate_mod.check_movement = check_timed
        mapper_mod.fmm_distance = charge("fmm", fmm_fn)
        evaluate_cli.make_multiclass_scorer = make_scorer_timed
        DepthMapperAndPlanner.log_reasoning = log_reasoning
        DepthMapperAndPlanner.add_observations_batch = charge(
            "mapping", methods["add_observations_batch"])
        DepthMapperAndPlanner.get_traversible = charge("traversible", methods["get_traversible"])
        DepthMapperAndPlanner.log_act = log_act
        self.env_cls.step = charge("render", step)
        return self

    def __exit__(self, *exc):
        gen_fn, check, fmm_fn, make_scorer, methods, step = self._saved
        batched_runner.episode_generator = gen_fn
        evaluate_mod.check_movement = check
        mapper_mod.fmm_distance = fmm_fn
        evaluate_cli.make_multiclass_scorer = make_scorer
        for name, fn in methods.items():
            setattr(DepthMapperAndPlanner, name, fn)
        self.env_cls.step = step

    def stop_table(self) -> dict:
        """ms per stop (median and p80) in total and per part; the scorer's
        part is its call's dispatch and gather time over the call's stops."""
        scorer = []
        for c in self.calls:
            n = len(c["views"]) // STOP_VIEWS
            scorer += [(c["dispatch_s"] + c["gather_s"]) / n] * n
        if len(scorer) != len(self.stops):
            raise AssertionError(f"{len(self.stops)} stops timed, {len(scorer)} served")
        parts = {cat: [s[cat] for s in self.stops] for cat in self.CATS}
        parts["other_host"] = [s["wall"] - sum(s[c] for c in self.CATS) for s in self.stops]
        parts["scorer"] = scorer
        parts["total"] = [s["wall"] + x for s, x in zip(self.stops, scorer)]
        return {k: {"median": float(np.median(v)) * 1e3,
                    "p80": float(np.percentile(v, 80)) * 1e3} for k, v in parts.items()}


def write_eval_config(tmp: Path, ckpt: Path, tag: str) -> str:
    """An eval config for the published Q-net: SCORE model, SLAM, the
    model's experiment folder (the published config.yml) and its .torch
    weights, results under `tmp`."""
    model_dir = tmp / "model"
    if not model_dir.exists():
        model_dir.mkdir()
        shutil.copy(PUBLISHED_CONFIG, model_dir / "config.yml")
    path = tmp / f"{tag}.yml"
    path.write_text("\n".join(_yaml({
        "SCORE": "model", "SLAM": True, "SEED": SEED,
        "MODEL_CONFIG_LOCATION": str(model_dir), "PRETRAINED_MODEL_LOCATION": str(ckpt),
        "RESULT_LOCATION": str(tmp / f"results_{tag}")})) + "\n")
    return str(path)


def eval_cli(config_path: str, episodes: int, in_flight: int, *flags: str) -> float:
    with contextlib.redirect_stdout(io.StringIO()) as out:
        mean = evaluate_cli.main([config_path, "--workload", str(episodes), "--batched",
                                  str(in_flight), "--pipeline-depth", str(EVAL_PIPELINE),
                                  *flags], device=ONE_CARD)
    if mean is None or not 0.0 <= mean <= 1.0:
        raise AssertionError(f"evaluate CLI: mean SPL {mean}\n{out.getvalue()[-2000:]}")
    return mean


def scored_cli_run(tmp: Path, ckpt: Path, tag: str, episodes: int, in_flight: int,
                   profiled: int, *flags: str, env_cls=FakeNavEnv) -> dict:
    """The published Q-net through the evaluate CLI's batched path
    (`--workload episodes --batched in_flight` and `flags`), the kernel's
    counts from 0: one bf16 identity launch per fused score call, every
    served score within SERVE_ATOL of a float32 card forward of its own
    views, every SPL on disk; ms per stop and per agent step (EvalClock),
    episodes/s, peak memory, and the device's idle share over a profiled
    run of `profiled` episodes."""
    cfg_path = write_eval_config(tmp, ckpt, tag)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    rn.LAUNCHES.clear()
    with EvalClock(env_cls) as clock:
        t0 = time.perf_counter()
        mean = eval_cli(cfg_path, episodes, in_flight, *flags)
        wall = time.perf_counter() - t0
    launches = dict(rn.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    results = DiskReader(str(tmp / f"results_{tag}" / name_from_config(
        load_file(cfg_path)))).data()
    n_calls = len(clock.calls)
    if launches != {("identity", "bfloat16"): n_calls} or n_calls == 0:
        raise AssertionError(f"{n_calls} score calls launched {launches}, not one bf16 "
                             f"identity kernel each")
    if sorted(results) != list(range(episodes)) or not all(
            0.0 <= float(v) <= 1.0 for v in results.values()):
        raise AssertionError(f"results on disk: {results}")

    # every served request against a float32 card forward of its views
    diff, views = 0.0, 0
    for c in clock.calls:
        if c["scores"].shape != (len(c["views"]),) or not np.all(np.isfinite(c["scores"])):
            raise AssertionError(f"bad scores {c['scores'].shape} for {len(c['views'])} views")
        want = fp32_card_scores(clock.model, c["views"], c["cls"])
        diff = max(diff, float(np.abs(c["scores"] - want).max()))
        views += len(c["views"])
    if not diff <= SERVE_ATOL:
        raise AssertionError(f"served eval scores differ from the fp32 card forward by "
                             f"{diff} > {SERVE_ATOL}")
    stops = clock.stop_table()
    step_ms = {k: v / max(clock.agent_steps, 1) * 1e3 for k, v in clock.walk.items()}
    step_ms["total"] = clock.walk_s / max(clock.agent_steps, 1) * 1e3
    where = " ".join(flags) or "the fake env"
    log(f"[{tag}] evaluate CLI ({where}), published Q-net (seed {SEED}) at {IMAGE_SIZE} px: "
        f"{episodes} episodes, {in_flight} in flight, pipeline depth {EVAL_PIPELINE}: "
        f"{wall:.2f} s, {episodes / wall:.4f} episodes/s, mean SPL {mean:.4f}; "
        f"{len(clock.stops)} stops, {clock.agent_steps} agent steps, {n_calls} fused score "
        f"calls ({views} views), {launches} kernel launches; served bf16 vs card fp32 max "
        f"abs diff {diff:.4g} (allowed {SERVE_ATOL}); peak device memory {peak:.2f} GiB")
    log(f"[{tag}] ms per reasoning stop (median / p80): " + ", ".join(
        f"{k} {v['median']:.4f} / {v['p80']:.4f}" for k, v in stops.items()))
    log(f"[{tag}] ms per agent step (host, mean): " + ", ".join(
        f"{k} {v:.4f}" for k, v in step_ms.items()))

    # the device's idle share over a shorter profiled run of the same path
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    prof_cfg = write_eval_config(tmp, ckpt, f"{tag}_profiled")
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eval_cli(prof_cfg, profiled, profiled, *flags)
        torch.cuda.synchronize()
        prof_wall = time.perf_counter() - t0
    device_s = sum(e.time_range.elapsed_us() for e in prof.events()
                   if e.device_type == DeviceType.CUDA) / 1e6
    busy = device_s / prof_wall
    log(f"[{tag}] profiled run of {profiled} episodes ({profiled} in flight): wall "
        f"{prof_wall:.2f} s, device {device_s:.3f} s, busy share {busy:.4f}, idle share "
        f"{1 - busy:.4f}" if device_s else
        f"[{tag}] device idle share not measured (the profiler saw no device events)")
    return {"launches": {path: launches.get((path, "bfloat16"), 0) for path in ("identity", "banded")},
            "episodes": episodes, "in_flight": in_flight,
            "pipeline_depth": EVAL_PIPELINE, "wall_s": wall,
            "episodes_per_s": episodes / wall, "mean_spl": mean,
            "stops": len(clock.stops), "agent_steps": clock.agent_steps,
            "score_calls": n_calls, "served_vs_fp32_card_max_abs_diff": diff,
            "ms_per_stop": stops, "ms_per_agent_step": step_ms, "peak_gib": peak,
            "profiled_busy_share": busy if device_s else None,
            "profiled_idle_share": 1 - busy if device_s else None}


def eval_path() -> dict:
    """Phase 9: (a) the map delta, (b) geodesic episodes card vs CPU, (c)
    the published Q-net through the evaluate CLI's batched path."""
    _build.BUILD_DIR.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as tmp_name:
        tmp = Path(tmp_name)
        out = {"map_delta": map_delta_check(), "geodesic": geodesic_check(tmp)}
        ckpt = tmp / "qnet.torch"
        seeded_checkpoint(ckpt, published_config())
        # the main path: counts from 0, 16 episodes, 8 in flight, 2 cohorts
        out.update(scored_cli_run(tmp, ckpt, "eval", EVAL_EPISODES, EVAL_IN_FLIGHT,
                                  PROFILED_EPISODES))
    return out


# -- phase 10: evaluation on meshes ----------------------------------------------

# the host library's render against the numpy twin: float32 against float64
MESH_DEPTH_ATOL, MESH_RGB_SHARE = 1e-4, 0.999
# two surfaces this close along a ray are coplanar faces (the furnished
# house's interior walls end on the perimeter walls and stand on the upper
# slab): the BVH's order picks the colour there, and either one is right
MESH_TIE_TOL = 1e-4
MESH_GEODESIC_EPISODES = ((0, "bed"), (1, "chair"))   # (floor, class): one a floor
MESH_EPISODES, MESH_IN_FLIGHT, MESH_PROFILED_EPISODES = 4, 4, 2


def furnished_stop_poses(env) -> np.ndarray:
    """The 12 views of a reasoning stop on the ground floor: (x, camera
    height, z, yaw) after each of 12 left turns."""
    pos, ang = env.sample_start_state(0)
    return np.array([[pos[0], pos[1] + env.camera_height, pos[2], ang + k * env.turn]
                     for k in range(1, STOP_VIEWS + 1)])


def mesh_render_check() -> dict:
    """Phase 10 (a): a 12-view 224x224 stop in the furnished house from the
    host library against the numpy twin (depth within MESH_DEPTH_ATOL,
    RGB within +-1 on MESH_RGB_SHARE of the pixels, where a pixel on two
    coplanar faces may show either), and the render's ms for 12 views and
    for one, and the house's build."""
    t0 = time.perf_counter()
    env, _ = make_furnished_house(size_px=IMAGE_SIZE, seed=SEED)
    build_s = time.perf_counter() - t0
    if not isinstance(env.mesh, NativeMesh):
        raise AssertionError(f"the env renders with {type(env.mesh).__name__}")
    poses = furnished_stop_poses(env)
    render = lambda p: env.mesh.render(p, IMAGE_SIZE, env.cam, env.max_depth)  # noqa: E731
    depth, rgb = render(poses)
    ms = {}
    for views, calls in ((STOP_VIEWS, 10), (1, 40)):
        times = []
        for _ in range(calls):
            t1 = time.perf_counter()
            render(poses[:views])
            times.append((time.perf_counter() - t1) * 1e3)
        ms[views] = float(np.median(times))
    twin = TwinMesh(*meshgen.furnished_house_mesh()[:3])
    t1 = time.perf_counter()
    with ThreadPoolExecutor(os.cpu_count() or 1) as pool:
        parts = list(pool.map(lambda i: twin.render(poses[i:i + 1], IMAGE_SIZE, env.cam,
                                                    env.max_depth, tie_tol=MESH_TIE_TOL),
                              range(STOP_VIEWS)))
    twin_s = time.perf_counter() - t1
    t_depth, t_rgb, t_rgb2 = (np.concatenate([p[k] for p in parts]) for k in range(3))
    depth_diff = float(np.abs(depth - t_depth).max())
    near = np.abs(rgb.astype(int) - t_rgb).max(-1) <= 1
    share_plain = float(near.mean())
    share = float((near | (np.abs(rgb.astype(int) - t_rgb2).max(-1) <= 1)).mean())
    tied = float((t_rgb2 != t_rgb).any(-1).mean())
    log(f"[eval_mesh] furnished house at {IMAGE_SIZE} px: built in {build_s:.3f} s "
        f"({len(env.mesh._f)} triangles, floors {env.floor_heights}); host-library render "
        f"{ms[STOP_VIEWS]:.4f} ms for {STOP_VIEWS} views, {ms[1]:.4f} ms for one (median; "
        f"{os.cpu_count()} host cores); numpy twin {twin_s:.2f} s for the {STOP_VIEWS} views")
    log(f"[eval_mesh] host library vs twin over {depth.size} pixels: depth max abs diff "
        f"{depth_diff:.3g} (allowed {MESH_DEPTH_ATOL:g}); RGB within +-1 on {share:.6f} of "
        f"them (allowed {MESH_RGB_SHARE}), {share_plain:.6f} against the nearest face alone; "
        f"{tied:.6f} of them on coplanar faces")
    if not depth_diff <= MESH_DEPTH_ATOL or not share > MESH_RGB_SHARE:
        raise AssertionError(f"mesh render: depth {depth_diff}, RGB share {share}")
    return {"build_s": build_s, "render_ms_12_views": ms[STOP_VIEWS], "render_ms_1_view": ms[1],
            "twin_s": twin_s, "depth_max_abs_diff": depth_diff, "rgb_share_within_1": share,
            "rgb_share_nearest_face_only": share_plain, "coplanar_share": tied}


def mesh_geodesic_check(tmp: Path) -> dict:
    """Phase 10 (b): 2 geodesic-scored episodes in the furnished house at
    224 px, one on each floor, mapped on the card and on the CPU: equal
    step logs (STOP mode) and equal SPL."""
    t0 = time.perf_counter()
    template, house = make_furnished_house(size_px=IMAGE_SIZE, seed=SEED)
    episodes = []
    for floor, cls in MESH_GEODESIC_EPISODES:
        start, ang = template.sample_start_state(floor)
        goals = relevant_locations(start, house.object_locations_for_habitat_dest[cls])
        gd = min(template.geodesic_distance(start, g) for g in goals)
        episodes.append(("FurnishedHouse", floor, cls, gd, start, ang))
    episodes = np.array(episodes, dtype=object)
    out = {}
    for stop in (True, False):
        for device in ("cuda", "cpu"):
            cfg = get_eval_defaults()
            cfg.SLAM, cfg.SEED, cfg.STOP = True, SEED, stop
            cfg.RESULT_LOCATION = str(tmp / f"mesh_{device}_{stop}")
            with contextlib.redirect_stdout(io.StringIO()):
                run_policy(cfg, episodes, env_factory=lambda h, mc, c: template.clone(seed=SEED),
                           house_factory=lambda name: house, device=device,
                           scorer_factory=lambda env, ci: make_geodesic_scorer(env),
                           visualize_every=0)
            out[device, stop] = DiskReader(str(Path(cfg.RESULT_LOCATION)
                                               / name_from_config(cfg))).data()
    n = len(MESH_GEODESIC_EPISODES)
    steps = 0
    for k in range(n):
        got, want = out["cuda", True].get(k), out["cpu", True].get(k)
        if got is None or want is None or len(got) != len(want) or any(
                not np.array_equal(g[0], w[0]) or list(g[1:]) != list(w[1:])
                for g, w in zip(got, want)):
            raise AssertionError(f"furnished episode {k}: the card's step log differs from "
                                 f"the CPU's")
        steps += len(got)
    spl = out["cpu", False]
    if out["cuda", False] != spl or len(spl) != n:
        raise AssertionError(f"furnished SPL card {out['cuda', False]} vs cpu {spl}")
    seconds = time.perf_counter() - t0
    log(f"[eval_mesh] {n} geodesic furnished-house episodes at {IMAGE_SIZE} px (floors "
        f"{[f for f, _ in MESH_GEODESIC_EPISODES]}), card vs cpu: {steps} logged steps equal, "
        f"SPL equal {[round(v, 4) for v in spl.values()]} ({seconds:.1f} s for the four runs)")
    return {"logged_steps": steps, "spl": [float(v) for v in spl.values()], "seconds": seconds}


def mesh_scene_check(tmp: Path) -> dict:
    """Phase 10 (d): the evaluate CLI's --mesh-scene on the furnished house
    written as a PLY file at run time: one geodesic episode, mapped on the
    card, its SPL on disk."""
    scene = tmp / "furnished.ply"
    write_ply(str(scene), *meshgen.furnished_house_mesh()[:3])
    cfg_path = tmp / "scene.yml"
    # the CLI visualises episode 0 (every 100th, as JAX's does): its strip goes under tmp
    cfg_path.write_text("\n".join(_yaml({"SCORE": "geodesic", "SLAM": True, "SEED": SEED,
                                          "RESULT_LOCATION": str(tmp / "results_scene"),
                                          "VIDEO_LOCATION": str(tmp / "videos_scene")})) + "\n")
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()) as text:
        mean = evaluate_cli.main(["--mesh-scene", str(scene), str(cfg_path)], device=ONE_CARD)
    seconds = time.perf_counter() - t0
    results = DiskReader(str(tmp / "results_scene" / name_from_config(
        load_file(str(cfg_path))))).data()
    if mean is None or sorted(results) != [0] or not 0.0 <= float(results[0]) <= 1.0:
        raise AssertionError(f"--mesh-scene: results {results}\n{text.getvalue()[-2000:]}")
    log(f"[eval_mesh] evaluate CLI --mesh-scene on a {scene.stat().st_size / 1e3:.1f} kB PLY "
        f"written at run time: 1 episode, SPL {float(results[0]):.4f} ({seconds:.1f} s)")
    return {"spl": float(results[0]), "seconds": seconds}


def mesh_eval_path() -> dict:
    """Phase 10: (a) the render against the twin, (b) geodesic episodes
    card vs CPU, (c) the published Q-net through the evaluate CLI's
    batched path in the furnished house, (d) --mesh-scene."""
    t0 = time.perf_counter()
    _build.BUILD_DIR.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as tmp_name:
        tmp = Path(tmp_name)
        out = {"render": mesh_render_check(), "geodesic": mesh_geodesic_check(tmp)}
        ckpt = tmp / "qnet.torch"
        seeded_checkpoint(ckpt, published_config())
        # the main path: counts from 0, 4 episodes, 4 in flight, 2 cohorts
        out.update(scored_cli_run(tmp, ckpt, "eval_mesh", MESH_EPISODES, MESH_IN_FLIGHT,
                                  MESH_PROFILED_EPISODES, "--furnished-env",
                                  env_cls=MeshNavEnv))
        out["mesh_scene"] = mesh_scene_check(tmp)
    out["seconds"] = time.perf_counter() - t0
    stop = out["ms_per_stop"]
    out["render_share_of_stop"] = stop["render"]["median"] / stop["total"]["median"]
    log(f"[eval_mesh] phase 10 in {out['seconds']:.1f} s; a stop's render (median) "
        f"{stop['render']['median']:.4f} of {stop['total']['median']:.4f} ms, a share of "
        f"{out['render_share_of_stop']:.4f}")
    return out


# -- phase 11: the detector --------------------------------------------------------

DETECTOR_VIEWS, DETECTOR_FRAMES = 12, 4
# The detector is compared stage by stage on the same proposals (the CPU
# run's): the FPN maps (relative L2), class probabilities, and each
# proposal's decoded box for the reference run's top class. On renders two
# runs may select other candidates: random weights and flat renders tie
# objectness across thousands of anchors (a fake-env render's top 1,000 P2
# logits hold ~670 distinct values on the CPU), and a tie that float noise
# breaks on one device and not the other picks another anchor. So there
# the detections that find a twin end to end are counted, not held.
# bf16 card against float32 card: maps within 5% (bf16 keeps 8 bits, ~0.4%
# a rounding, over ~60 layers), probabilities within 0.02, boxes at IoU >=
# 0.9; end to end, twins of the detections above 0.3: same class, scores
# within 0.02, IoU >= 0.9.
BF16_FEATURE_RTOL, BF16_MIN_SCORE, BF16_SCORE_ATOL, BF16_MIN_IOU = 0.05, 0.3, 0.02, 0.9
# float32 card (no TF32) against the float32 CPU, sums in another order:
# maps within 1e-4, probabilities within 1e-4, boxes within 1e-2 px, the
# same top class wherever the CPU's two best are 1e-4 apart or more.
CPU_FEATURE_RTOL, CPU_SCORE_ATOL, CPU_BOX_ATOL = 1e-4, 1e-4, 1e-2
# On noise frames the card's selection is held exactly to the CPU's on the
# same head outputs: every detection has a twin of the same class, its
# score within 1e-6 and its box within 1e-3 px (the two devices' float32
# softmax and exp differ in the last bits). The entry point end to end,
# float32 card against the CPU, each with its own heads: at least 99% of
# the detections twinned by CPU_SCORE_ATOL and CPU_BOX_ATOL. A head output
# that differs in the 6th digit can still move a candidate across a cut
# (1,000 of 9,408 P2 anchors; 1,000 of 90,000 class candidates) or an NMS
# threshold, and one such move changes a chain of suppressions: 3 of 1,200
# detections in one image at 224 px on the H100. Where an image holds
# max_detections, the detections within 2e-4 of the CPU's lowest, which
# may trade places at the cut, are left out.
SELECT_SCORE_ATOL, SELECT_BOX_ATOL = 1e-6, 1e-3
E2E_MIN_TWINNED = 0.99
# the target classes' mean logits over the best other class's
# (detector_weights)
TARGET_LOGIT_MARGIN = 3.0
DETECTOR_RATE_BATCHES = (4, 32)
DETECTOR_EPISODES = 4
FUSION_THRESHOLD = 0.3


def detector_weights(path: Path, levelled=tuple(COCO_TARGET_IDS.values())) -> dict:
    """Seeded torchvision-named maskrcnn_resnet50_fpn weights (seed 4,
    tests/torch_detector_util.py), saved to `path` as a .pth. Random
    weights score every class about alike and give every ROI nearly the
    same features, so one class would win everywhere. The class logits are
    spread (cls_score's kernel x6) and the `levelled` classes' biases (the
    5 target classes; phase 12 adds the person) set so that their mean
    logits over a noise frame's proposals (a float32 CPU run) stand level,
    TARGET_LOGIT_MARGIN above the best other class: each ROI's own
    features then pick among them, detections above the fusion threshold
    occur, and the class NMS's offsets separate several classes."""
    sd = seeded_maskrcnn_state_dict(seed=SEED, with_masks=False)
    sd["roi_heads.box_predictor.cls_score.weight"] *= 6.0
    model = MaskRCNN().eval()
    model.load_state_dict(sd, strict=True)
    frame = noise_frames(1, SEED)
    with torch.no_grad():
        feats = model.features(rn.normalize_u8(torch.from_numpy(frame), torch.float32))
        rois, _ = model.proposals(feats, IMAGE_SIZE, IMAGE_SIZE)
        logits, _ = model.roi_heads.box_scores(multilevel_roi_align(feats[:4], rois,
                                                                    STRIDES[:4], 7))
    mean = logits.mean(0)
    targets = list(levelled)
    others = [c for c in range(1, len(mean)) if c not in targets]
    sd["roi_heads.box_predictor.cls_score.bias"][targets] += (
        mean[others].max() + TARGET_LOGIT_MARGIN - mean[targets])
    torch.save(sd, path)
    return sd


def noise_frames(n: int, seed: int) -> np.ndarray:
    """n uint8 frames of uniform noise at IMAGE_SIZE: no flat region, so
    objectness and class scores do not tie across anchors."""
    return np.random.default_rng(seed).integers(0, 256, (n, IMAGE_SIZE, IMAGE_SIZE, 3),
                                                dtype=np.uint8)


def box_iou_np(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    return det_boxes.box_iou(torch.from_numpy(a), torch.from_numpy(b)).numpy()


def bf16_unmatched(got: dict, want: dict) -> list:
    """Detections of either side above BF16_MIN_SCORE + BF16_SCORE_ATOL
    with no twin on the other above BF16_MIN_SCORE - BF16_SCORE_ATOL: same
    class, score within BF16_SCORE_ATOL, box IoU at least BF16_MIN_IOU."""
    missing = []
    for a, b, side in ((got, want, "bf16"), (want, got, "f32")):
        pool = [j for j in range(len(b["scores"]))
                if b["scores"][j] > BF16_MIN_SCORE - BF16_SCORE_ATOL]
        iou = box_iou_np(a["boxes"], b["boxes"]) if len(a["boxes"]) and len(b["boxes"]) else None
        for i in range(len(a["scores"])):
            if a["scores"][i] <= BF16_MIN_SCORE + BF16_SCORE_ATOL:
                continue
            match = [j for j in pool if b["classes"][j] == a["classes"][i]
                     and abs(b["scores"][j] - a["scores"][i]) <= BF16_SCORE_ATOL
                     and iou[i, j] >= BF16_MIN_IOU]
            if match:
                pool.remove(match[0])
            else:
                missing.append((side, int(a["classes"][i]), float(a["scores"][i])))
    return missing


@torch.no_grad()
def detector_stages(model: MaskRCNN, images: np.ndarray, device, dtype,
                    proposals=None) -> dict:
    """One run of the detector's stages on `device` in `dtype` (bf16 under
    autocast, float32 without TF32): the FPN maps, its own proposals and
    detections, and on `proposals` (default its own) the box head's class
    probabilities, top classes and box deltas."""
    x = torch.from_numpy(images).to(device)
    h, w = images.shape[1:3]
    with no_tf32(), torch.autocast(device, dtype=torch.bfloat16,
                                   enabled=dtype == torch.bfloat16):
        feats = model.features(rn.normalize_u8(x, dtype))
        own, _ = model.proposals(feats, h, w)
        dets = model.detect(feats, own, h, w)
        props = own if proposals is None else proposals.to(device)
        logits, deltas = model.roi_heads.box_scores(
            multilevel_roi_align(feats[:4], props, STRIDES[:4], 7))
    probs = torch.softmax(logits.float(), -1)
    rois = props.reshape(-1, 4)
    keep = dets["valid"] & (dets["scores"] > 0.05)
    per_image = [{k: dets[k][i][keep[i]].cpu().numpy() for k in ("boxes", "scores", "classes")}
                 for i in range(len(images))]
    return {"feats": [f.float().cpu() for f in feats], "proposals": own, "probs": probs.cpu(),
            "top": probs[:, 1:].argmax(-1).cpu() + 1,
            "deltas": deltas.float().view(len(rois), -1, 4).cpu(), "rois": rois.cpu(),
            "dets": per_image}


def compare_stages(a: dict, b: dict) -> dict:
    """a's stages against b's on the same proposals (b's); each proposal's
    box decoded for b's top class in both."""
    real = (b["rois"][:, 2] > b["rois"][:, 0]) & (b["rois"][:, 3] > b["rois"][:, 1])
    top2 = b["probs"][:, 1:].topk(2, -1).values
    clear = real & (top2[:, 0] - top2[:, 1] >= CPU_SCORE_ATOL)
    rows = torch.arange(len(b["rois"]))
    boxes_a, boxes_b = (det_boxes.decode_boxes(b["rois"], r["deltas"][rows, b["top"]],
                                               BOX_WEIGHTS)[real] for r in (a, b))
    iou = det_boxes.box_iou(boxes_a[:, None], boxes_b[:, None])[:, 0, 0]
    return {"feature_rel_err": max(float((x - y).norm() / y.norm())
                                   for x, y in zip(a["feats"], b["feats"])),
            "prob_max_abs_diff": float((a["probs"] - b["probs"]).abs().max()),
            "box_max_abs_diff": float((boxes_a - boxes_b).abs().max()),
            "box_min_iou": float(iou.min()), "proposals": int(real.sum()),
            "top_class_differs": int((a["top"][clear] != b["top"][clear]).sum()),
            "top_class_compared": int(clear.sum())}


def detector_images() -> np.ndarray:
    """A 12-view stop of fake-env renders at 224 px and 4 committed fixture
    frames decoded to 224 px: (16, 224, 224, 3) uint8."""
    env = FakeNavEnv(image_size=IMAGE_SIZE, seed=SEED)
    env.set_agent_state(*env.sample_start_state())
    views = [env.step(1)[0]["rgb"] for _ in range(DETECTOR_VIEWS)]
    files = sorted(str(p) for p in (ROOT / "tests/data/torch_qdata/frames").rglob("*.jpg"))
    frames = load_images(files[::len(files) // DETECTOR_FRAMES][:DETECTOR_FRAMES], IMAGE_SIZE)
    return np.concatenate([np.stack(views), frames])


@contextlib.contextmanager
def forward_hooks(modules, hooks):
    handles = [m.register_forward_hook(h) for m, h in zip(modules, hooks)]
    try:
        yield
    finally:
        for h in handles:
            h.remove()


def _on_cpu(out):
    return [_on_cpu(t) for t in out] if isinstance(out, (list, tuple)) else out.cpu()


def noise_checks(pth: Path, detector: TorchDetector) -> dict:
    """Phase 11 (a) on DETECTOR_VIEWS noise frames, through load_detector.
    (1) The card's selection held exactly: `detector` (the main path's,
    bf16) records its RPN head's and box predictor's outputs, and a CPU
    TorchDetector runs the same frames with those in place of its own, so
    both selections (top-k, decode, the RPN NMS over packed levels and
    -inf pads, the class offsets, the class NMS, the gathers) start from
    the same values; the overlapping pairs (IoU > the box NMS's threshold)
    of other classes that both survive count the class offsets' work.
    (2) The entry point end to end: float32 on the card (no TF32) and on
    the CPU, each with its own heads."""
    frames = noise_frames(DETECTOR_VIEWS, SEED + 1)
    cpu = load_detector(str(pth), device="cpu")
    heads = lambda d: (d.model.rpn.head, d.model.roi_heads.box_predictor)  # noqa: E731
    recorded = ([], [])
    with forward_hooks(heads(detector), [lambda m, i, o, r=r: r.append(_on_cpu(o))
                                         for r in recorded]):
        got = detector(frames)
    t0 = time.perf_counter()
    with forward_hooks(heads(cpu), [lambda m, i, o, r=r: r.pop() for r in recorded]):
        want = cpu(frames)
    cpu_s = time.perf_counter() - t0
    select_missing, cross = [], 0
    for g, w in zip(got, want):
        select_missing += unmatched_detections(g, w, SELECT_SCORE_ATOL, SELECT_BOX_ATOL)
        iou = box_iou_np(w["boxes"], w["boxes"])
        cross += int(((iou > cpu.model.box_nms_thresh)
                      & (w["classes"][:, None] < w["classes"][None])).sum())
    classes = sorted({int(c) for d in want for c in d["classes"]})
    n_select = sum(len(d["scores"]) for d in want)
    log(f"[detector] the card's bf16 selection vs the CPU's on the card's head outputs, "
        f"{len(frames)} noise frames at {IMAGE_SIZE} px: {n_select} detections, "
        f"{len(select_missing)} without a twin; classes {classes}; {cross} overlapping "
        f"pairs of other classes kept (CPU {cpu_s:.2f} s)")
    if select_missing or n_select == 0:
        raise AssertionError(f"the card's selection vs the CPU's on the same head outputs: "
                             f"{n_select} detections, without a twin {select_missing[:10]}")
    if len(classes) < 2 or cross == 0:
        raise AssertionError(f"the class NMS's offsets had no work: classes {classes}, "
                             f"{cross} overlapping pairs of other classes")

    card = load_detector(str(pth))
    card.dtype = torch.float32  # the card's bf16 default, off for this comparison
    with no_tf32():
        got = card(frames)
    want = cpu(frames)
    cap = cpu.model.max_detections
    missing, held = [], 0
    for g, w in zip(got, want):
        floor = float(w["scores"].min()) + 2 * CPU_SCORE_ATOL if len(w["scores"]) == cap else 0.0
        missing += unmatched_detections(g, w, CPU_SCORE_ATOL, CPU_BOX_ATOL, floor)
        held += int((w["scores"] > floor).sum())
    twinned = 1 - len(missing) / max(1, held)
    log(f"[detector] end to end through load_detector, float32 card vs CPU on the same "
        f"frames: {held} detections held, {len(missing)} without a twin ({twinned:.4%} "
        f"twinned): {missing[:4]}")
    if held == 0 or twinned < E2E_MIN_TWINNED:
        raise AssertionError(f"float32 card vs CPU end to end on noise frames: {held} held, "
                             f"without a twin {missing[:10]}")
    return {"frames": len(frames), "selection_detections": n_select,
            "selection_unmatched": len(select_missing), "classes": classes,
            "cross_class_overlaps": cross, "e2e_held": held, "e2e_unmatched": len(missing),
            "e2e_twinned": twinned, "cpu_seconds": cpu_s}


def detector_counts() -> dict:
    return {"identity": rn.LAUNCHES["identity", "bfloat16"],
            "banded": rn.LAUNCHES["banded", "bfloat16"], "nms": det_boxes.LAUNCHES["nms"]}


def clear_counts() -> None:
    rn.LAUNCHES.clear()
    det_boxes.LAUNCHES.clear()


def forward_without_sync(detector: TorchDetector, views: np.ndarray) -> None:
    """The detector's forward of a 12-view stop, bf16 as a call runs it,
    under the sync debug mode "error": a host synchronize inside it raises.
    Its NMS statuses are read after."""
    x = rn.normalize_u8(torch.from_numpy(views).cuda(), detector.dtype)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        with torch.no_grad(), torch.autocast("cuda", dtype=torch.bfloat16):
            out = detector.model(x)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    det_boxes.check_nms_status(out["nms_status"])
    log(f"[detector] a {len(views)}-view forward ran under the sync debug mode \"error\": no "
        f"host synchronize in it; NMS statuses {tuple(out['nms_status'].shape)} all zero")


def detector_calls(pth: Path, images: np.ndarray) -> dict:
    """Phase 11 (a): the detector at full width loaded through
    load_detector, on a 12-view stop and 4 frames; bf16 against float32 on
    the card, float32 card against the CPU; ms a 12-view call, images/s at
    B = 4 and 32, the profiled busy share and peak memory."""
    detector = load_detector(str(pth))
    views, frames = images[:DETECTOR_VIEWS], images[DETECTOR_VIEWS:]
    detector(views)  # the first call's cuDNN plans and kernel loads
    torch.cuda.synchronize()
    forward_without_sync(detector, views)
    # the main path: counts from 0, one 12-view call and one of 4 frames
    clear_counts()
    got = detector(views) + detector(frames)
    launches = detector_counts()
    if launches != {"identity": 2, "banded": 0, "nms": 4}:
        raise AssertionError(f"2 detector calls launched {launches}, not one bf16 identity "
                             f"kernel and two NMS kernels each")

    sd = convert_maskrcnn(torch.load(pth, weights_only=True))
    models = [MaskRCNN(), MaskRCNN()]
    for m in models:
        m.load_state_dict(sd, strict=True)
    f32_model = models[0].cuda().eval().to(memory_format=torch.channels_last)
    t0 = time.perf_counter()
    cpu = detector_stages(models[1].eval(), images, "cpu", torch.float32)
    cpu_s = time.perf_counter() - t0
    card32 = detector_stages(f32_model, images, "cuda", torch.float32, cpu["proposals"])
    card16 = detector_stages(detector.model, images, "cuda", torch.bfloat16, cpu["proposals"])
    vs_cpu, vs_f32 = compare_stages(card32, cpu), compare_stages(card16, card32)
    if not (vs_cpu["feature_rel_err"] <= CPU_FEATURE_RTOL
            and vs_cpu["prob_max_abs_diff"] <= CPU_SCORE_ATOL
            and vs_cpu["box_max_abs_diff"] <= CPU_BOX_ATOL
            and vs_cpu["top_class_differs"] == 0):
        raise AssertionError(f"float32 card vs CPU, stage by stage: {vs_cpu}")
    if not (vs_f32["feature_rel_err"] <= BF16_FEATURE_RTOL
            and vs_f32["prob_max_abs_diff"] <= BF16_SCORE_ATOL
            and vs_f32["box_min_iou"] >= BF16_MIN_IOU):
        raise AssertionError(f"bf16 vs float32 card, stage by stage: {vs_f32}")
    n_bf16 = sum(int((d["scores"] > BF16_MIN_SCORE).sum()) for d in got)
    if n_bf16 == 0:
        raise AssertionError(f"no bf16 detection above {BF16_MIN_SCORE}")
    noise = noise_checks(pth, detector)
    # end to end on the renders and frames, counted: detections with a
    # twin in the other run
    cpu_missing = [m for g, w in zip(card32["dets"], cpu["dets"]) for m in unmatched_detections(
        g, w, CPU_SCORE_ATOL, CPU_BOX_ATOL)]
    n_f32 = sum(len(d["scores"]) for d in card32["dets"])
    cpu_matched = 1 - len(cpu_missing) / max(1, n_f32 + sum(len(d["scores"])
                                                             for d in cpu["dets"]))
    bf16_missing = [m for g, w in zip(got, card32["dets"]) for m in bf16_unmatched(g, w)]
    bf16_matched = 1 - len(bf16_missing) / max(1, sum(
        int((d["scores"] > BF16_MIN_SCORE + BF16_SCORE_ATOL).sum())
        for d in got + card32["dets"]))
    classes = sorted({int(c) for d in got for c in d["classes"]})
    log(f"[detector] maskrcnn_resnet50_fpn ({sum(p.numel() for p in detector.model.parameters())}"
        f" params, seeded) at {IMAGE_SIZE} px through load_detector: a 12-view stop and "
        f"{DETECTOR_FRAMES} frames launched {launches}; {sum(len(d['scores']) for d in got)} bf16 "
        f"detections (classes {classes}), {n_bf16} above {BF16_MIN_SCORE}")
    log(f"[detector] float32 card vs CPU on the CPU's {vs_cpu['proposals']} proposals: FPN "
        f"maps {vs_cpu['feature_rel_err']:.3g} relative, probabilities within "
        f"{vs_cpu['prob_max_abs_diff']:.3g}, boxes within {vs_cpu['box_max_abs_diff']:.3g} px, "
        f"top classes equal on {vs_cpu['top_class_compared']}; end to end {cpu_matched:.2%} of "
        f"{n_f32} detections twinned (CPU stages {cpu_s:.2f} s)")
    log(f"[detector] bf16 vs float32 card on the same proposals: FPN maps "
        f"{vs_f32['feature_rel_err']:.3g} relative, probabilities within "
        f"{vs_f32['prob_max_abs_diff']:.3g}, boxes IoU >= {vs_f32['box_min_iou']:.4f}; end to "
        f"end {bf16_matched:.2%} of the detections above {BF16_MIN_SCORE} twinned")

    # timing on the host clock around synchronous calls (each ends in its
    # one device-to-host copy)
    def wall_ms(batch, reps):
        detector.run(batch)
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            detector.run(batch)
            times.append(time.perf_counter() - t0)
        return float(np.median(times)) * 1e3

    stop_ms = wall_ms(views, 10)
    rates = {}
    torch.cuda.reset_peak_memory_stats()
    for b in DETECTOR_RATE_BATCHES:
        batch = np.concatenate([images] * (b // len(images) + 1))[:b]
        rates[b] = b / wall_ms(batch, 5) * 1e3
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    prof = device_profile(lambda: detector.run(views), calls=5)
    log_profile("detector, a 12-view call (bf16)", prof)
    nms_ms = sum(us for name, (n, us) in prof["by_name"].items()
                 if any(k in name for k in NMS_KERNELS)) / prof["calls"] / 1e3
    per_call = sum(n for n, _ in prof["by_name"].values()) / prof["calls"]
    log(f"[detector] {stop_ms:.4f} ms a 12-view call (median of 10); images/s "
        + ", ".join(f"{v:.1f} at B = {b}" for b, v in rates.items())
        + f"; NMS kernels {nms_ms:.4f} ms of a 12-view call; {per_call:.0f} device "
          f"kernels and copies a call; peak device memory {peak:.2f} GiB (B = 32)")
    return {"launches": launches, "ms_per_12_view_call": stop_ms,
            "images_per_s": {str(b): v for b, v in rates.items()}, "peak_gib": peak,
            "busy_share": prof["busy_share"] if prof["by_name"] else None,
            "device_ms_per_call": prof["device_ms"], "nms_ms_per_call": nms_ms,
            "device_ops_per_call": per_call,
            "bf16_detections_above": n_bf16, "f32_detections": n_f32, "classes": classes,
            "f32_card_vs_cpu": vs_cpu, "bf16_vs_f32_card": vs_f32,
            "end_to_end_twinned": {"f32_card_vs_cpu": cpu_matched, "bf16_vs_f32": bf16_matched},
            "noise_frames": noise,
            "cpu_seconds": cpu_s}


def detection_cli_chain(tmp: Path, pth: Path) -> dict:
    """Phase 11 (b): the detection CLI over the committed fixture frames
    (an episode dataset of links to them, tests/torch_qdata.py
    make_episodes), then the process_episodes CLI on its output."""
    location = torch_qdata.make_episodes(tmp / "episodes", videos=3, frames=40, seed=SEED)
    (Path(location) / "frames" / "real_detections_raw.npy").unlink()
    clear_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        out = detect_real_videos.main(["--location", location, "--weights", str(pth)])
    seconds = time.perf_counter() - t0
    launches = detector_counts()
    dets = np.load(out, allow_pickle=True)[()]
    n_frames = sum(len(v) for v in dets.values())
    n_files = len(list((Path(location) / "frames").rglob("*.jpg")))
    calls = sum(-(-len(list((Path(location) / "frames" / v).glob("*.jpg"))) // 4) for v in dets)
    hits = sum(s is not None for v in dets.values() for a in v.values() for s in a[:, 1])
    if n_frames != n_files or hits == 0 or launches != {"identity": calls, "banded": 0, "nms": 2 * calls}:
        raise AssertionError(f"detection CLI: {n_frames} frames of {n_files} files, {hits} "
                             f"class hits, launches {launches} for {calls} calls")
    with contextlib.redirect_stdout(io.StringIO()):
        feather = process_episodes.main(["--location", location])
    table = read_feather(feather)
    rows = len(next(iter(table.values())))
    if rows == 0:
        raise AssertionError("process_episodes wrote no rows from the detections")
    log(f"[detector] detection CLI over {n_frames} fixture frames ({len(dets)} videos, batch "
        f"4): {seconds:.2f} s, {n_frames / seconds:.1f} frames/s with decode, {hits} "
        f"target-class hits, launches {launches}; process_episodes on its output: {rows} rows")
    return {"launches": launches, "frames": n_frames, "seconds": seconds,
            "frames_per_s": n_frames / seconds, "target_hits": hits, "feather_rows": rows}


def fused_eval_run(tmp: Path, pth: Path) -> dict:
    """Phase 11 (c): the evaluate CLI with COMBINE_DETECTOR and the seeded
    detector beside the published Q-net (--workload 4 --batched 4) on the
    fake env: one detector call a stop, bumps that happen, episodes/s and
    the detector's share of a stop."""
    ckpt = tmp / "qnet.torch"
    seeded_checkpoint(ckpt, published_config())
    cfg_path = write_eval_config(tmp, ckpt, "fused")
    text = Path(cfg_path).read_text() + "\n".join(_yaml({
        "COMBINE_DETECTOR": True, "CONFIDENCE_THRESHOLD": FUSION_THRESHOLD,
        "DETECTOR_WEIGHTS": str(pth)})) + "\n"
    Path(cfg_path).write_text(text)
    built, fusions = [], []
    build, fuse = evaluate_cli.build_detector_from_config, evaluate_mod.fuse_detector_scores

    def build_spy(*a, **kw):
        built.append(build(*a, **kw))
        return built[-1]

    def fuse_spy(scores, *a, **kw):
        t0 = time.perf_counter()
        out = fuse(scores, *a, **kw)
        fusions.append((time.perf_counter() - t0, int((out != scores).sum())))
        return out

    evaluate_cli.build_detector_from_config = build_spy
    evaluate_mod.fuse_detector_scores = fuse_spy
    try:
        clear_counts()
        with EvalClock(FakeNavEnv) as clock:
            t0 = time.perf_counter()
            mean = eval_cli(cfg_path, DETECTOR_EPISODES, DETECTOR_EPISODES)
            wall = time.perf_counter() - t0
        launches = detector_counts()
    finally:
        evaluate_cli.build_detector_from_config = build
        evaluate_mod.fuse_detector_scores = fuse
    detector = built[0]
    stops, calls = len(clock.stops), len(clock.calls)
    bumps = sum(b for _, b in fusions)
    if not isinstance(detector, TorchDetector) or detector.calls != stops or stops == 0:
        raise AssertionError(f"Detector calls {getattr(detector, 'calls', None)}, stops {stops}")
    if bumps == 0:
        raise AssertionError(f"{stops} fused stops and no score bumped")
    if launches != {"identity": calls + stops, "banded": 0, "nms": 2 * stops}:
        raise AssertionError(f"{calls} score calls and {stops} detector calls launched "
                             f"{launches}")
    table = clock.stop_table()
    detector_ms = float(np.median([s for s, _ in fusions])) * 1e3
    share = detector_ms / table["total"]["median"]
    log(f"[detector] evaluate CLI, COMBINE_DETECTOR (threshold {FUSION_THRESHOLD}) with the "
        f"published Q-net, {DETECTOR_EPISODES} fake-env episodes, {DETECTOR_EPISODES} in "
        f"flight: {wall:.2f} s, {DETECTOR_EPISODES / wall:.4f} episodes/s, mean SPL {mean:.4f}; "
        f"{stops} stops = Detector calls {detector.calls}, {bumps} views bumped; launches "
        f"{launches}; a stop (median) {table['total']['median']:.4f} ms, its detector call "
        f"{detector_ms:.4f} ms, a share of {share:.4f}")
    return {"launches": launches, "episodes": DETECTOR_EPISODES, "wall_s": wall,
            "episodes_per_s": DETECTOR_EPISODES / wall, "mean_spl": mean, "stops": stops,
            "detector_calls": detector.calls, "score_calls": calls, "bumped_views": bumps,
            "ms_per_stop": table, "detector_ms_per_stop": detector_ms,
            "detector_share_of_stop": share}


def detector_path() -> dict:
    """Phase 11: (a) the detector's calls, (b) the detection CLI into
    process_episodes, (c) a fused evaluation run. launches sums the three
    main-path runs, each counted from 0."""
    t0 = time.perf_counter()
    _build.BUILD_DIR.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as tmp_name:
        tmp = Path(tmp_name)
        pth = tmp / "maskrcnn_seeded.pth"
        detector_weights(pth)
        out = {"calls": detector_calls(pth, detector_images()),
               "cli": detection_cli_chain(tmp, pth), "fused_eval": fused_eval_run(tmp, pth)}
    out["launches"] = {k: sum(out[p]["launches"][k] for p in ("calls", "cli", "fused_eval"))
                       for k in ("identity", "banded", "nms")}
    out["seconds"] = time.perf_counter() - t0
    log(f"[detector] phase 11 in {out['seconds']:.1f} s; launches {out['launches']}")
    return out


# -- phase 12: the dataset front end -----------------------------------------------

FRONT_BATCHES = (32, 256)
INDOOR_F32_ATOL = 1e-4   # float32 card (no TF32) against the float32 CPU
# bf16 card indoor probabilities against float32 card ones: the rule of
# tests/torch_frontend_util.py bf16_against_f32 (INDOOR_BF16_ATOL over the
# classes bf16 took, BF16_LOGIT_ATOL, moves beyond INDOOR_BF16_ATOL only
# at near ties of the 10th and 11th classes), then no larger a move than
# the JAX package's own bf16 model makes on these weights and frames
# (JAX_BF16_MAX_MOVE) and at most this many times its share of frames
# whose top-10 swapped: torch's autocast rounds other tensors than JAX's
# bf16 model, so it may swap other near ties
SWAP_SHARE_FACTOR = 2.0
# the filter CLI's indoor_locs (bf16) are held to the CPU's wherever the
# CPU's float32 smoothed probability lies further than this from 0.5: a
# bf16 probability moves by up to INDOOR_BF16_ATOL, and so does its
# smoothed mean, which is then rounded at 0.5
FILTER_MARGIN = 0.02
# the comparison's videos: 24 frames (the Gaussian's radius) in runs of
# FILTER_RUN frames the seeded AlexNet scores indoor, then outdoor (the
# smoothed probability crosses 0.5), and 16 (reflected more than once) in
# runs of FILTER_RUN // 2 frames the detector flags, then does not
FILTER_VIDEOS, FILTER_RUN = (24, 16), 12
FILTER_BATCH = 32        # run_filter_pass's frames a call
# the person's score margin (person_margins) of every frame in those
# videos, on the card in float32, lies further than this from 0: ten
# times phase 11's float32 card-vs-CPU limit on probabilities
PERSON_MARGIN = 1e-3
PERSON_BISECTIONS = 20   # of the person's fc bias shift, in [0, 4] logits
# the filter pass's rate: a corpus of RATE_VIDEOS videos of RATE_FRAMES
# fixture frames (the simulator's video length), so that 6 of every 7
# calls are full batches
RATE_VIDEOS, RATE_FRAMES = 8, 200
SIM_VIDEOS, SIM_STEPS = 8, 100
SIM_WALKS, SIM_WALK_STEPS = 8, 64
SIM_TRAIN_STEPS = 10
ENCODE_FRAMES = 256      # rendered frames a timed save_images call


def front_frames() -> np.ndarray:
    """The 32 committed fixture frames decoded to IMAGE_SIZE (resize of the
    short edge, centre crop), in committed_frames' order."""
    return load_images([str(p) for p in torch_qdata.committed_frames()], IMAGE_SIZE)


def places_weights(path: Path, frames: np.ndarray) -> None:
    """Seeded AlexNet-Places365 weights under torchvision's names (seed
    FRONT_SEED), the indoor classes' fc8 biases shifted so that the
    fixture frames' indoor probabilities centre on 0.5
    (tests/torch_frontend_util.py centred_alexnet_state_dict), saved to
    `path` as a .pth."""
    torch.save(centred_alexnet_state_dict(FRONT_SEED, frames), path)


def person_margins(detections: list) -> np.ndarray:
    """Each frame's best person score less its 5th best other score (0
    where it has fewer than 5 others; the best person score -1 where it
    has none): person_in_top5 flags the frame where this is positive."""
    out = []
    for det in detections:
        scores, classes = det["scores"], det["classes"]
        person = scores[classes == PERSON_CLASS]
        others = np.sort(scores[classes != PERSON_CLASS])[::-1]
        out.append((person.max() if len(person) else -1.0)
                   - (others[4] if len(others) > 4 else 0.0))
    return np.asarray(out, np.float64)


def person_weights(path: Path, frames: np.ndarray) -> np.ndarray:
    """Phase 11's seeded detector with the person levelled with the 5
    targets, then its class bias shifted (bisection on the card in float32)
    until the median of the fixture frames' person_margins is 0, saved to
    `path`; returns the margins at that shift. Random weights rank the
    classes alike on every frame, so a fixed shift flags a person on every
    frame or on none: centred, the margins spread about 0 by a few 1e-3
    (PERSON_MARGIN keeps the comparison's frames clear of the edge)."""
    sd = detector_weights(path, levelled=(*COCO_TARGET_IDS.values(), PERSON_CLASS))
    detector = load_detector(str(path))
    detector.dtype = torch.float32
    bias = detector.model.roi_heads.box_predictor.cls_score.bias.data
    base = float(bias[PERSON_CLASS])

    def margins(shift: float) -> np.ndarray:
        with torch.no_grad():
            bias[PERSON_CLASS] = base + shift
        with no_tf32():
            return person_margins(detector(frames))

    lo, hi = 0.0, 4.0
    for _ in range(PERSON_BISECTIONS):
        mid = (lo + hi) / 2
        lo, hi = (mid, hi) if np.median(margins(mid)) < 0 else (lo, mid)
    shift = (lo + hi) / 2
    sd["roi_heads.box_predictor.cls_score.bias"][PERSON_CLASS] += shift
    torch.save(sd, path)
    out = margins(shift)
    log(f"[frontend] person: class bias +{shift:.6f} over the levelled targets; fixture "
        f"frames' margins (float32 card) in [{out.min():.6f}, {out.max():.6f}], "
        f"{int((out > PERSON_MARGIN).sum())} flagged and {int((out < -PERSON_MARGIN).sum())} "
        f"not further than {PERSON_MARGIN} from the edge")
    return out


def indoor_calls(pth: Path, frames: np.ndarray) -> dict:
    """Phase 12 (a): the indoor classifier at full width loaded through
    load_alexnet_places, on 32 and 256 frames (the fixture's 32 and their
    mirror images): one bf16 identity launch a call, bf16 against float32
    on the card, float32 card against the CPU, ms a call and frames/s."""
    clf = make_indoor_classifier(load_alexnet_places(str(pth)))
    cpu = make_indoor_classifier(load_alexnet_places(str(pth), "cpu"), device="cpu")
    out = {"launches": 0, "batches": {}}
    for b in FRONT_BATCHES:
        images = front_batch(frames, b)
        clf(images)  # warm-up: cuDNN's plans, the allocator
        torch.cuda.synchronize()
        rn.LAUNCHES.clear()
        bf16 = clf(images)
        launches = dict(rn.LAUNCHES)
        if launches != {("identity", "bfloat16"): 1}:
            raise AssertionError(f"indoor classifier at B = {b}: launches {launches}, not one "
                                 f"bf16 identity launch")
        out["launches"] += 1
        times = []
        for _ in range(10):
            t0 = time.perf_counter()
            clf(images)
            times.append(time.perf_counter() - t0)
        ms = float(np.median(times)) * 1e3
        with no_tf32():
            clf.dtype = torch.float32
            f32 = clf(images)
            l32 = clf.logits(images).cpu().numpy()
            clf.dtype = torch.bfloat16
        ref = cpu(images)
        d_cpu = float(np.abs(f32 - ref).max())
        if not (np.isfinite(bf16).all() and d_cpu <= INDOOR_F32_ATOL
                and ref.min() < 0.5 < ref.max()):
            raise AssertionError(f"indoor classifier at B = {b}: float32 card vs CPU "
                                 f"{d_cpu:.3e} (limit {INDOOR_F32_ATOL}), CPU range "
                                 f"[{ref.min():.4f}, {ref.max():.4f}]")
        d_bf16 = bf16_indoor_check(l32, clf.logits(images).cpu().numpy(), bf16,
                                   clf.mask.cpu().numpy())
        out["batches"][b] = {"ms": ms, "frames_per_s": b / ms * 1e3, "bf16_vs_f32": d_bf16,
                             "f32_vs_cpu_max": d_cpu,
                             "indoor_share_cpu": float((ref > 0.5).mean())}
        log(f"[frontend] indoor classifier B = {b}: {ms:.4f} ms a call (host clock, median of "
            f"10, copy in and out included), {b / ms * 1e3:.1f} frames/s; one bf16 identity "
            f"launch; bf16 vs float32 card: max {d_bf16['max']:.3e} over bf16's top-10 "
            f"classes, {d_bf16['max_with_swaps']:.3e} (limit {JAX_BF16_MAX_MOVE}) with the "
            f"{d_bf16['swapped_frames']} frames whose top-10 swapped a near-tied class, "
            f"{d_bf16['beyond_frames']} beyond {INDOOR_BF16_ATOL} (their float32 10th-11th "
            f"logit gaps at most {d_bf16['beyond_tie_gap_max']:.4f}), logits within "
            f"{d_bf16['logit_err_max']:.4f}; float32 card vs CPU max {d_cpu:.3e}; CPU "
            f"probabilities in [{ref.min():.4f}, {ref.max():.4f}], {(ref > 0.5).mean():.3f} "
            f"above 0.5")
        if b == FRONT_BATCHES[-1]:
            prof = device_profile(lambda: clf(images), 5)
            log_profile(f"indoor classifier B = {b}", prof, top=8)
            out["busy_share"] = prof["busy_share"]
            out["device_ms"] = prof["device_ms"]
    out["cpu_probs"] = cpu(frames)
    return out


def bf16_indoor_check(l32: np.ndarray, lbf: np.ndarray, bf16: np.ndarray,
                      mask: np.ndarray) -> dict:
    """bf16 indoor probabilities against float32 logits on the card, by
    bf16_against_f32's rule; the largest move no larger than the JAX
    package's own bf16 model's, and the frames whose top-10 swapped at
    most SWAP_SHARE_FACTOR times its share."""
    out = bf16_against_f32(l32, lbf, bf16, mask)
    swap_limit = SWAP_SHARE_FACTOR * JAX_BF16_SWAP_SHARE * len(bf16)
    if out["breaches"] or out["max_with_swaps"] > JAX_BF16_MAX_MOVE or \
            out["swapped_frames"] > swap_limit:
        raise AssertionError(f"indoor classifier bf16 vs float32 card: {out}; limits: logits "
                             f"{BF16_LOGIT_ATOL}, probabilities {INDOOR_BF16_ATOL}, near ties "
                             f"{2 * BF16_LOGIT_ATOL}, largest move {JAX_BF16_MAX_MOVE}, swapped "
                             f"frames {swap_limit:.1f}")
    return out


class TimedCalls:
    """A callable's wall seconds, summed over its calls (each ends in a
    copy to the host, so its wall time is its whole cost), and what it
    returned."""

    def __init__(self, fn):
        self.fn, self.seconds, self.outputs = fn, 0.0, []

    def __call__(self, *args, **kw):
        t0 = time.perf_counter()
        out = self.fn(*args, **kw)
        self.seconds += time.perf_counter() - t0
        self.outputs.append(out)
        return out


@contextlib.contextmanager
def filter_cli_spy(dtype=None):
    """The filter CLI's pass, indoor classifier, detector and the pass's
    decoder, each timed (what each returned kept); with `dtype`, both
    models compute in it. Yields {"pass", "indoor", "detector", "decode"}:
    TimedCalls."""
    saved = extract_frames.make_indoor_classifier, extract_frames.load_detector, \
        filters_mod.load_images, extract_frames.run_filter_pass
    spy = {}

    def make(model, device=None):
        clf = saved[0](model, device=device)
        clf.dtype = dtype or clf.dtype
        spy["indoor"] = TimedCalls(clf)
        return spy["indoor"]

    def load(path, device=None):
        detector = saved[1](path, device=device)
        detector.dtype = dtype or detector.dtype
        spy["detector"] = TimedCalls(detector)
        return spy["detector"]

    spy["decode"], spy["pass"] = TimedCalls(saved[2]), TimedCalls(saved[3])
    extract_frames.make_indoor_classifier, extract_frames.load_detector = make, load
    filters_mod.load_images, extract_frames.run_filter_pass = spy["decode"], spy["pass"]
    try:
        yield spy
    finally:
        extract_frames.make_indoor_classifier, extract_frames.load_detector, \
            filters_mod.load_images, extract_frames.run_filter_pass = saved


def run_filter_cli(root: Path, out: Path, places: Path, detector_pth: Path, device=None,
                   dtype=None):
    """The filter CLI over `root` into `out`, spied (filter_cli_spy);
    returns ({video: its npy dict}, spy), the CLI's wall seconds in
    spy["wall"]."""
    argv = ["--frames", str(root), "--out", str(out), "--places-weights", str(places),
            "--detector-weights", str(detector_pth)]
    with filter_cli_spy(dtype) as spy, contextlib.redirect_stdout(io.StringIO()):
        t0 = time.perf_counter()
        written = extract_frames.main(argv, device=device)
        spy["wall"] = time.perf_counter() - t0
    return {vid: np.load(p, allow_pickle=True)[()] for vid, p in written.items()}, spy


def filter_frames_dir(root: Path, probs: np.ndarray, margins: np.ndarray) -> None:
    """<root>/vid<k>/%04d.jpg: copies of the committed frames (1280x720 and
    640x360 JPEGs, decoded and resized by the pass) whose person margin
    lies further than PERSON_MARGIN from 0; vid00 in runs of FILTER_RUN
    frames of the half the AlexNet scores indoor, then of the other half;
    vid01 in runs of FILTER_RUN // 2 frames the detector flags, then of
    frames it does not."""
    sources = torch_qdata.committed_frames()
    clear = np.flatnonzero(np.abs(margins) > PERSON_MARGIN)
    by_prob = clear[np.argsort(probs[clear], kind="stable")]
    half = len(by_prob) // 2
    pools = [(by_prob[half:], by_prob[:half]),
             (clear[margins[clear] > 0], clear[margins[clear] < 0])]
    runs = (FILTER_RUN, FILTER_RUN // 2)
    if min(len(p) for pair in pools for p in pair) < 2:
        raise AssertionError(f"filter CLI: too few clear frames for its runs: indoor halves "
                             f"{half}, person {[len(p) for p in pools[1]]}")
    rng = np.random.default_rng(SEED)
    for v, (n, pair, run) in enumerate(zip(FILTER_VIDEOS, pools, runs)):
        (root / f"vid{v:02d}").mkdir(parents=True)
        for i in range(n):
            pool = pair[(i // run) % 2]
            shutil.copyfile(sources[pool[rng.integers(len(pool))]],
                            root / f"vid{v:02d}" / f"{i + 1:04d}.jpg")


def filter_flags(spy: dict) -> np.ndarray:
    """person_in_top5 of every frame the spied detector saw, as the CLI
    computes it."""
    return np.array([person_in_top5(d["classes"][np.argsort(-d["scores"])])
                     for call in spy["detector"].outputs for d in call])


def filter_cli(tmp: Path, places: Path, detector_pth: Path, probs: np.ndarray,
               margins: np.ndarray) -> dict:
    """Phase 12 (b): the filter CLI (video_dqn_tpu_torch.extract_frames)
    over two videos of fixture frames with (a)'s AlexNet and
    person_weights' detector: bf16 on the card (a warm-up run, then the
    counted run), resume, float32 on the card and float32 on the CPU.
    indoor_locs (bf16) equal the CPU's where the CPU's smoothed
    probability lies further than FILTER_MARGIN from 0.5; the person flag
    of every frame and person_locs (float32 card) equal the CPU's, both
    mixed."""
    root = tmp / "filter_frames"
    filter_frames_dir(root, probs, margins)

    def run(out: str, device=None, dtype=None):
        return run_filter_cli(root, tmp / out, places, detector_pth, device, dtype)

    run("filter_warm")
    clear_counts()
    bf16, _ = run("filter_bf16")
    launches = detector_counts()
    calls = sum(-(-n // FILTER_BATCH) for n in FILTER_VIDEOS)
    if launches != {"identity": 2 * calls, "banded": 0, "nms": 2 * calls}:
        raise AssertionError(f"filter CLI: launches {launches}, not {2 * calls} identity (the "
                             f"AlexNet's and the detector's) and {2 * calls} NMS")
    clear_counts()
    again, _ = run("filter_bf16")
    if again or detector_counts() != {"identity": 0, "banded": 0, "nms": 0}:
        raise AssertionError(f"filter CLI resume: wrote {sorted(again)}, launches "
                             f"{detector_counts()}")
    with no_tf32():
        card32, card32_spy = run("filter_f32", dtype=torch.float32)
    cpu, cpu_spy = run("filter_cpu", device="cpu")
    cpu_probs = np.concatenate(cpu_spy["indoor"].outputs)
    flags, cpu_flags = filter_flags(card32_spy), filter_flags(cpu_spy)
    frames = sum(FILTER_VIDEOS)
    if not np.array_equal(flags, cpu_flags) or not 0 < cpu_flags.sum() < frames:
        raise AssertionError(f"filter CLI: float32 card person flags {flags.astype(int)} vs "
                             f"the CPU's {cpu_flags.astype(int)}")
    held = mismatched = indoor = persons = 0
    start = 0
    for (vid, ref), n in zip(sorted(cpu.items()), FILTER_VIDEOS):
        smoothed = filters_mod.gaussian_filter1d(cpu_probs[start:start + n], 6.0)
        start += n
        keep = np.flatnonzero(np.abs(smoothed - 0.5) > FILTER_MARGIN)
        ours, theirs = set(bf16[vid]["indoor_locs"]), set(ref["indoor_locs"])
        held += len(keep)
        mismatched += sum((i in ours) != (i in theirs) for i in keep)
        indoor += len(ref["indoor_locs"])
        persons += len(ref["person_locs"])
        if not np.array_equal(card32[vid]["person_locs"], ref["person_locs"]):
            raise AssertionError(f"filter CLI {vid}: float32 card person_locs "
                                 f"{card32[vid]['person_locs']} vs the CPU's {ref['person_locs']}")
    if mismatched or sorted(bf16) != sorted(cpu) or not 0 < indoor < frames or \
            not 0 < persons < frames:
        raise AssertionError(f"filter CLI: {mismatched} of {held} held indoor flags differ "
                             f"from the CPU's; videos {sorted(bf16)} vs {sorted(cpu)}; "
                             f"{indoor} of {frames} frames indoor, {persons} with a person")
    log(f"[frontend] filter CLI over {len(FILTER_VIDEOS)} videos, {frames} fixture frames "
        f"(batch {FILTER_BATCH}): launches {launches}; resume wrote nothing; bf16 indoor_locs "
        f"equal the CPU's on the {held} frames further than {FILTER_MARGIN} from 0.5 ({indoor} "
        f"frames indoor on the CPU); float32 card person flags equal the CPU's on every frame "
        f"({int(cpu_flags.sum())} flagged) and its person_locs too ({persons} frames)")
    return {"launches": launches, "frames": frames, "held_indoor_flags": held,
            "indoor_frames": indoor, "person_flags": int(cpu_flags.sum()),
            "person_frames": persons}


def filter_rate(tmp: Path, places: Path, detector_pth: Path) -> dict:
    """Phase 12 (b): the filter CLI's rate in bf16 over RATE_VIDEOS videos
    of RATE_FRAMES fixture frames (hard links, cycling through the 32),
    after a warm-up run over one video of two full batches: frames/s of
    the pass with decode, the decode, indoor and detector shares of it,
    and the CLI's start-up (the two models' weights read and moved to the
    card) apart."""
    sources = torch_qdata.committed_frames()

    def corpus(name: str, videos: int, n: int) -> Path:
        root = tmp / name
        for v in range(videos):
            (root / f"vid{v:02d}").mkdir(parents=True)
            for i in range(n):
                os.link(sources[(v * n + i) % len(sources)], root / f"vid{v:02d}" / f"{i + 1:04d}.jpg")
        return root

    run_filter_cli(corpus("rate_warm", 1, 2 * FILTER_BATCH), tmp / "rate_warm_out", places,
                   detector_pth)
    root = corpus("rate_frames", RATE_VIDEOS, RATE_FRAMES)
    clear_counts()
    written, spy = run_filter_cli(root, tmp / "rate_out", places, detector_pth)
    launches = detector_counts()
    calls = RATE_VIDEOS * -(-RATE_FRAMES // FILTER_BATCH)
    if len(written) != RATE_VIDEOS or launches != {"identity": 2 * calls, "banded": 0, "nms": 2 * calls}:
        raise AssertionError(f"filter CLI rate run: {len(written)} videos, launches {launches}, "
                             f"not {2 * calls} identity and {2 * calls} NMS")
    frames = RATE_VIDEOS * RATE_FRAMES
    wall, seconds = spy["wall"], spy["pass"].seconds
    shares = {k: spy[k].seconds / seconds for k in ("decode", "indoor", "detector")}
    log(f"[frontend] filter CLI rate: {RATE_VIDEOS} videos x {RATE_FRAMES} fixture frames "
        f"(batch {FILTER_BATCH}, {calls} calls, bf16): the pass {seconds:.3f} s, "
        f"{frames / seconds:.1f} frames/s with decode; its shares: decode "
        f"{shares['decode']:.4f}, indoor {shares['indoor']:.4f}, detector "
        f"{shares['detector']:.4f}; start-up {wall - seconds:.3f} s of the CLI's {wall:.3f}; "
        f"launches {launches}")
    return {"launches": launches, "frames": frames, "calls": calls, "pass_seconds": seconds,
            "frames_per_s": frames / seconds, "shares": shares, "startup_s": wall - seconds,
            "wall_s": wall}


def sim_loop(tmp: Path) -> dict:
    """Phase 12 (c): generate_sim_dataset in the furnished house at 224 px
    and generate_inverse_pairs beside it, every frame written by save_images
    and read back by the port's decoder within a mean |difference| of
    MEAN_BOUND of its render; the encoder's ms a frame; then both training
    CLIs take SIM_TRAIN_STEPS steps on what was written (the published
    geometry, bf16)."""
    env, house = make_furnished_house(size_px=IMAGE_SIZE, seed=SEED)
    written = []
    saved = sim_dataset.save_images

    def recording(paths, frames, quality=75):
        written.append((list(paths), np.stack(frames)))
        saved(paths, frames, quality=quality)

    sim_dataset.save_images = recording
    try:
        t0 = time.perf_counter()
        feather = sim_dataset.generate_sim_dataset(
            env, house, str(tmp / "sim"), n_videos=SIM_VIDEOS, steps_per_video=SIM_STEPS,
            reward_dist=1.0, seed=SEED, floor=None)
        train_npy, val_npy, image_root = sim_dataset.generate_inverse_pairs(
            env, str(tmp / "sim_pairs"), n_walks=SIM_WALKS, steps_per_walk=SIM_WALK_STEPS,
            seed=SEED)
        gen_s = time.perf_counter() - t0
    finally:
        sim_dataset.save_images = saved
    n_frames = sum(len(p) for p, _ in written)
    worst = 0.0
    for paths, frames in written:
        back = load_images(paths, IMAGE_SIZE)
        worst = max(worst, float(np.abs(back.astype(np.int16) - frames).mean((1, 2, 3)).max()))
    if n_frames != SIM_VIDEOS * SIM_STEPS + SIM_WALKS * SIM_WALK_STEPS or \
            worst >= torch_qdata.MEAN_BOUND:
        raise AssertionError(f"sim loop: {n_frames} frames written; read back within a mean "
                             f"|difference| of {worst:.4f} (limit {torch_qdata.MEAN_BOUND})")
    batch = np.concatenate([f for _, f in written])[:ENCODE_FRAMES]
    enc_dir = tmp / "encode"
    enc_dir.mkdir()
    paths = [str(enc_dir / f"{i:04d}.jpg") for i in range(len(batch))]
    encode_ms = {}
    threads = os.environ.get("VDQN_JPEG_THREADS")
    try:
        for label, n in (("all_threads", "0"), ("one_thread", "1")):
            os.environ["VDQN_JPEG_THREADS"] = n
            save_images(paths, batch)
            t0 = time.perf_counter()
            save_images(paths, batch)
            encode_ms[label] = (time.perf_counter() - t0) / len(batch) * 1e3
    finally:
        if threads is None:
            os.environ.pop("VDQN_JPEG_THREADS", None)
        else:
            os.environ["VDQN_JPEG_THREADS"] = threads
    cols = read_feather(feather)
    rows = len(cols["before_image"])
    rewards = int(sum(cols[f"sparse_reward{k}"].sum() for k in range(5)))
    pairs = len(np.load(train_npy, allow_pickle=True)) + len(np.load(val_npy, allow_pickle=True))
    log(f"[frontend] sim loop: {SIM_VIDEOS} videos x {SIM_STEPS} steps and {SIM_WALKS} walks x "
        f"{SIM_WALK_STEPS} steps in the furnished house at {IMAGE_SIZE} px: {n_frames} frames "
        f"in {gen_s:.2f} s, {n_frames / gen_s:.1f} frames written/s (render, geodesics and "
        f"writes); {rows} feather rows, {rewards} sparse rewards, {pairs} pairs; read back "
        f"within a mean |difference| of {worst:.4f} of the renders; the encoder "
        f"{encode_ms['all_threads']:.4f} ms a {IMAGE_SIZE}^2 frame on all threads, "
        f"{encode_ms['one_thread']:.4f} on one ({ENCODE_FRAMES} renders a call)")

    folder = write_experiment(tmp / "sim_q", DATASET=feather, NUM_STEPS=SIM_TRAIN_STEPS,
                              CHECKPOINT_INTERVAL=SIM_TRAIN_STEPS, TARGET_UPDATE_INTERVAL=5,
                              TPU={"DEVICE_DATASET": True})
    rn.LAUNCHES.clear()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        state, _ = train_q_network.main([folder, "--log-every", "5"], device=ONE_CARD)
    q_s = time.perf_counter() - t0
    q_launches = dict(rn.LAUNCHES)
    losses = [r["value"] for r in read_metrics(ExperimentConfig(folder, resume=True).run_dir,
                                               "avg_q_loss/train")]
    if q_launches != {("identity", "bfloat16"): 2 * SIM_TRAIN_STEPS} or len(losses) != 2 or \
            not np.isfinite(losses).all() or \
            not (Path(folder) / "models" / f"sample{SIM_TRAIN_STEPS}.ckpt").exists():
        raise AssertionError(f"sim loop Q-net: launches {q_launches}, losses {losses}")

    inv_dir = tmp / "sim_inverse"
    rn.LAUNCHES.clear()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        _, accuracy = train_inverse_model.main(
            ["--train_data", train_npy, "--val_data", val_npy, "--image_root", image_root,
             "--image_size", str(IMAGE_SIZE), "--batch_size", str(INV_BATCH), "--num_steps",
             str(SIM_TRAIN_STEPS), "--lr", str(INV_LR), "--seed", str(SEED), "--out_dir",
             str(inv_dir), "--cache-images"], device=ONE_CARD, validate_every=SIM_TRAIN_STEPS,
            val_batches=1)
    inv_s = time.perf_counter() - t0
    inv_launches = dict(rn.LAUNCHES)
    scalars = read_metrics(str(inv_dir))
    if inv_launches != {("identity", "bfloat16"): SIM_TRAIN_STEPS + 1 + 10} or \
            len(scalars) != 4 or not all(np.isfinite(r["value"]) for r in scalars) or \
            not np.isfinite(accuracy):
        raise AssertionError(f"sim loop inverse: launches {inv_launches}, scalars {scalars}")
    log(f"[frontend] sim loop training: the Q-net CLI {SIM_TRAIN_STEPS} steps at B = 256 "
        f"(device table) in {q_s:.2f} s, EMA losses {losses}, launches {q_launches}; the "
        f"inverse CLI {SIM_TRAIN_STEPS} steps at B = {INV_BATCH} (--cache-images) in "
        f"{inv_s:.2f} s, scalars {[round(r['value'], 6) for r in scalars]}, final val accuracy "
        f"{accuracy:.4f}, launches {inv_launches}")
    return {"launches": q_launches[("identity", "bfloat16")]
            + inv_launches[("identity", "bfloat16")],
            "frames": n_frames, "generate_s": gen_s, "frames_per_s": n_frames / gen_s,
            "feather_rows": rows, "sparse_rewards": rewards, "pairs": pairs,
            "readback_mean_diff_max": worst, "encode_ms_per_frame": encode_ms,
            "q_losses": losses, "q_seconds": q_s, "inverse_seconds": inv_s,
            "inverse_final_val_accuracy": accuracy}


def frontend_path() -> dict:
    """Phase 12: (a) the indoor classifier's calls, (b) the filter CLI
    against the CPU and its rate, (c) the simulator loop. launches sums
    the four main-path runs, each counted from 0."""
    t0 = time.perf_counter()
    _build.BUILD_DIR.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as tmp_name:
        tmp = Path(tmp_name)
        frames = front_frames()
        places = tmp / "alexnet_places365_seeded.pth"
        places_weights(places, frames)
        detector_pth = tmp / "maskrcnn_person_seeded.pth"
        margins = person_weights(detector_pth, frames)
        calls = indoor_calls(places, frames)
        cli = filter_cli(tmp, places, detector_pth, calls.pop("cpu_probs"), margins)
        rate = filter_rate(tmp, places, detector_pth)
        sim = sim_loop(tmp)
    runs = (cli, rate)
    out = {"calls": calls, "cli": cli, "rate": rate, "sim": sim,
           # the classifier's calls and the simulator's trainers launched
           # identity alone (checked where they run)
           "launches": {"identity": calls["launches"] + sim["launches"]
                        + sum(r["launches"]["identity"] for r in runs),
                        "banded": sum(r["launches"]["banded"] for r in runs),
                        "nms": sum(r["launches"]["nms"] for r in runs)}}
    out["seconds"] = time.perf_counter() - t0
    log(f"[frontend] phase 12 in {out['seconds']:.1f} s; launches {out['launches']}")
    return out


# -- phase 13: visualisation -------------------------------------------------------

VIZ_RESOLUTION = 16        # render_grid's grid over the fake env: 169 navigable cells
VIZ_CELLS = (100, 200)     # the navigable cells that grid must hold
VIZ_MAP_RESOLUTION = 1500  # the value maps' grid (JAX's default, the training hook's)
VIZ_BATCH = 64             # cells a value-map forward: 4 x 64 views
VIZ_CPU_CELLS = 8          # cells whose float32 card scores are held to the CPU port's
VIZ_CPU_ATOL = 1e-4        # float32 card against the CPU port
VIZ_PNG_REPS = 10          # timed save_png calls a map


def allclass_f32(model, views: np.ndarray) -> np.ndarray:
    """The all-class scorer's function in float32 on the card, built apart
    from it: the plain resize twin, the model outside autocast."""
    x = torch.from_numpy(np.ascontiguousarray(views)).cuda()
    b, f = x.shape[:2]
    xn = rn.resize_normalize_reference(x.reshape((b * f,) + x.shape[2:]), IMAGE_SIZE)
    xn = xn.permute(0, 2, 3, 1).reshape(b, f, IMAGE_SIZE, IMAGE_SIZE, 3)
    with torch.no_grad():
        return model(xn).amax(dim=-1).cpu().numpy()


def map_values(maps: list, rows: np.ndarray, cols: np.ndarray) -> np.ndarray:
    """The cells' values in orientation-major order, as orientation_views
    lays out their views: (4 * cells, classes)."""
    return np.concatenate([m[rows, cols] for m in maps])


def png_ms(image: np.ndarray, path: Path) -> float:
    """Host ms of one save_png of `image` (mean of VIZ_PNG_REPS after a
    warm call); the file must read back as the image."""
    save_png(str(path), image)
    t0 = time.perf_counter()
    for _ in range(VIZ_PNG_REPS):
        save_png(str(path), image)
    ms = (time.perf_counter() - t0) / VIZ_PNG_REPS * 1e3
    if not np.array_equal(read_png(str(path)), image):
        raise AssertionError(f"{path}: read back unequal to the image written")
    return ms


def value_map_check(tmp: Path, ckpt: Path) -> dict:
    """Phase 13 (a): render_grid over the fake env at 224 px; value maps of
    the published Q-net in bf16 (one bf16 identity launch a batch of
    cells), held to float32 card forwards of the same cells within
    SERVE_ATOL and, on VIZ_CPU_CELLS cells, the float32 card to the CPU
    port within VIZ_CPU_ATOL; a panorama net over the grid once; the PNG
    writer's ms for a rendered map and an uncropped one."""
    root = tmp / "grids" / "fake_house"
    t0 = time.perf_counter()
    cells = render_grid(FakeNavEnv(image_size=IMAGE_SIZE, seed=SEED), str(root),
                        resolution=VIZ_RESOLUTION)
    grid_s = time.perf_counter() - t0
    if not VIZ_CELLS[0] <= cells <= VIZ_CELLS[1]:
        raise AssertionError(f"render_grid: {cells} navigable cells, not in {VIZ_CELLS}")
    source = SimpleNamespace(PRETRAINED_MODEL_LOCATION=str(ckpt))
    model = load_eval_model(source, published_config(), image_size=IMAGE_SIZE)
    build_value_maps(model, str(root), False, resolution=VIZ_RESOLUTION, batch_size=VIZ_BATCH,
                     image_size=IMAGE_SIZE)
    batches = -(-cells // VIZ_BATCH)
    rn.LAUNCHES.clear()
    t0 = time.perf_counter()
    maps, agg, free = build_value_maps(model, str(root), False, resolution=VIZ_MAP_RESOLUTION,
                                       batch_size=VIZ_BATCH, image_size=IMAGE_SIZE)
    maps_s = time.perf_counter() - t0
    launches = dict(rn.LAUNCHES)
    if launches != {("identity", "bfloat16"): batches} or free.sum() != cells:
        raise AssertionError(f"value maps: launches {launches}, not {batches} bf16 identity; "
                             f"{free.sum()} free cells of {cells}")
    grid = VisualizationGrid(str(root), IMAGE_SIZE)
    worst = 0.0
    for rows, cols, images in grid.batches(VIZ_BATCH):
        want = allclass_f32(model, orientation_views(images, False))
        worst = max(worst, float(np.abs(map_values(maps, rows, cols) - want).max()))
    rows, cols, images = next(grid.batches(VIZ_CPU_CELLS))
    views = orientation_views(images, False)
    with no_tf32():
        card32 = allclass_f32(model, views)
    cpu_model = load_eval_model(source, published_config(), image_size=IMAGE_SIZE, device="cpu")
    cpu = make_allclass_scorer(cpu_model, image_size=IMAGE_SIZE, device="cpu")(views)
    cpu_err = float(np.abs(card32 - cpu).max())
    if worst > SERVE_ATOL or cpu_err > VIZ_CPU_ATOL:
        raise AssertionError(f"value maps: bf16 vs float32 card {worst:.6f} (limit "
                             f"{SERVE_ATOL}), float32 card vs cpu {cpu_err:.3g} (limit "
                             f"{VIZ_CPU_ATOL})")
    rendered = render_value_map(agg[:, :, 0], free)
    full = render_value_map(agg[:, :, 0], free, crop=False)
    ms = {"rendered": png_ms(rendered, tmp / "rendered.png"),
          "uncropped": png_ms(full, tmp / "uncropped.png")}
    shapes = {"rendered": list(rendered.shape), "uncropped": list(full.shape)}
    del maps, agg, free, full

    pano_config = published_config()
    pano_config.PANORAMA = True
    pano = init_qnet(build_qnet(pano_config, IMAGE_SIZE, device="cpu"),
                     torch.Generator().manual_seed(SEED))
    rn.LAUNCHES.clear()
    t0 = time.perf_counter()
    pmaps, _, pfree = build_value_maps(pano, str(root), True, resolution=VIZ_RESOLUTION,
                                       batch_size=VIZ_BATCH, image_size=IMAGE_SIZE)
    pano_s = time.perf_counter() - t0
    pano_launches = dict(rn.LAUNCHES)
    rows, cols, images = next(grid.batches(VIZ_BATCH))
    pano_err = float(np.abs(map_values(pmaps, rows, cols)
                            - allclass_f32(pano, orientation_views(images, True))).max())
    if pano_launches != {("identity", "bfloat16"): batches} or pfree.sum() != cells or \
            pano_err > SERVE_ATOL:
        raise AssertionError(f"panorama value maps: launches {pano_launches}, bf16 vs float32 "
                             f"card {pano_err:.6f}")
    log(f"[viz] render_grid over the fake env at {IMAGE_SIZE} px, resolution {VIZ_RESOLUTION}: "
        f"{cells} cells, {4 * cells} views written in {grid_s:.3f} s, "
        f"{4 * cells / grid_s:.1f} views/s (render and JPEG writes)")
    log(f"[viz] value maps of the published Q-net (bf16), {cells} cells x 4 orientations at "
        f"resolution {VIZ_MAP_RESOLUTION}: {maps_s:.3f} s, {cells / maps_s:.1f} cells/s "
        f"(decode, forwards, maps); launches {launches}; bf16 vs float32 card max "
        f"{worst:.6f} (limit {SERVE_ATOL}); float32 card vs cpu on {VIZ_CPU_CELLS} cells "
        f"{cpu_err:.3g} (limit {VIZ_CPU_ATOL}); panorama net (4 frames rolled) {pano_s:.3f} s, "
        f"launches {pano_launches}, first batch bf16 vs float32 card {pano_err:.6f}")
    log(f"[viz] save_png: a rendered map {shapes['rendered']} {ms['rendered']:.4f} ms, an "
        f"uncropped map {shapes['uncropped']} {ms['uncropped']:.4f} ms (host, mean of "
        f"{VIZ_PNG_REPS})")
    return {"root": root, "cells": cells, "grid_s": grid_s, "views_per_s": 4 * cells / grid_s,
            "maps_s": maps_s, "cells_per_s": cells / maps_s, "bf16_vs_f32": worst,
            "f32_vs_cpu": cpu_err, "panorama_s": pano_s, "panorama_bf16_vs_f32": pano_err,
            "png_ms": ms, "png_shapes": shapes,
            "launches": {path: launches.get((path, "bfloat16"), 0)
                         + pano_launches.get((path, "bfloat16"), 0) for path in ("identity", "banded")}}


def allclass_check(ckpt: Path) -> dict:
    """Phase 13 (b): make_allclass_scorer on a stop's 12 fake-env views at
    256^2 (one banded bf16 launch) and 224^2 (one identity launch), within
    SERVE_ATOL of float32 card forwards; host ms a call (median of 10)."""
    model = load_eval_model(SimpleNamespace(PRETRAINED_MODEL_LOCATION=str(ckpt)),
                            published_config(), image_size=IMAGE_SIZE)
    scorer = make_allclass_scorer(model, image_size=IMAGE_SIZE)
    out = {"launches": {"identity": 0, "banded": 0}}
    for side, path in ((256, "banded"), (IMAGE_SIZE, "identity")):
        env = FakeNavEnv(image_size=side, seed=SEED)
        env.set_agent_state(*env.sample_start_state())
        views = np.stack([env.step(1)[0]["rgb"] for _ in range(STOP_VIEWS)])
        scorer(views)
        rn.LAUNCHES.clear()
        got = scorer(views)
        launches = dict(rn.LAUNCHES)
        err = float(np.abs(got - allclass_f32(model, views[:, None])).max())
        if launches != {(path, "bfloat16"): 1} or got.shape != (STOP_VIEWS, 5) or \
                err > SERVE_ATOL:
            raise AssertionError(f"all-class scorer at {side}^2: launches {launches}, shape "
                                 f"{got.shape}, bf16 vs float32 card {err:.6f}")
        times = []
        for _ in range(10):
            t0 = time.perf_counter()
            scorer(views)
            times.append((time.perf_counter() - t0) * 1e3)
        out[side] = {"bf16_vs_f32": err, "ms": float(np.median(times))}
        out["launches"][path] += launches[(path, "bfloat16")]
        log(f"[viz] make_allclass_scorer, {STOP_VIEWS} views of {side}^2 ({path} kernel): "
            f"{out[side]['ms']:.4f} ms a call (host clock with the copy back, median of 10), "
            f"bf16 vs float32 card max {err:.6f} (limit {SERVE_ATOL}), launches {launches}")
    return out


@contextlib.contextmanager
def fake_env_at(size: int):
    """The evaluate CLI's --fake-env episode rendered at `size` px (the CLI
    makes it at 32)."""
    saved = evaluate_cli.make_env_and_episode
    evaluate_cli.make_env_and_episode = lambda *a, **kw: saved(*a, size=size, **kw)
    try:
        yield
    finally:
        evaluate_cli.make_env_and_episode = saved


def strip_config(tmp: Path, tag: str):
    """The strips' evaluation config: geodesic, SLAM, STOP mode, its
    results and strips under `tmp`."""
    cfg = get_eval_defaults()
    cfg.SCORE, cfg.SLAM, cfg.SEED, cfg.STOP = "geodesic", True, SEED, True
    cfg.RESULT_LOCATION, cfg.VIDEO_LOCATION = str(tmp / f"results_{tag}"), str(tmp / f"videos_{tag}")
    return cfg


def strip_cli(tmp: Path, tag: str, device, visualize: bool) -> tuple:
    """One geodesic fake-env episode at 224 px with SLAM, STOP mode,
    through the evaluate CLI, with -v when `visualize`. Returns (step
    logs, the strip files)."""
    cfg = strip_config(tmp, tag)
    path = tmp / f"{tag}.yml"
    path.write_text("\n".join(_yaml({k: cfg[k] for k in (
        "SCORE", "SLAM", "SEED", "STOP", "RESULT_LOCATION", "VIDEO_LOCATION")})) + "\n")
    with fake_env_at(IMAGE_SIZE), contextlib.redirect_stdout(io.StringIO()):
        evaluate_cli.main(["--fake-env", *(["-v"] if visualize else []), str(path)],
                          device=device)
    logs = DiskReader(str(Path(cfg.RESULT_LOCATION) / name_from_config(cfg))).data()
    return logs, sorted(Path(cfg.VIDEO_LOCATION).rglob("*.png"))


def strip_seconds(tmp: Path, tag: str, visualize_every: int) -> tuple:
    """The CLI's episode through run_policy on the card with
    `visualize_every`, the env made before the clock starts. Returns
    (seconds, frames logged, seconds inside log_frame, step logs)."""
    cfg = strip_config(tmp, tag)
    with fake_env_at(IMAGE_SIZE):
        env, house, ep = evaluate_cli.make_env_and_episode()
    frames = [0, 0.0]
    log_frame = mapper_mod.log_frame

    def counted(planner, obs, action):
        t0 = time.perf_counter()
        log_frame(planner, obs, action)
        frames[0] += 1
        frames[1] += time.perf_counter() - t0

    mapper_mod.log_frame = counted
    try:
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            run_policy(cfg, np.array([ep], dtype=object), env_factory=lambda h, mc, c: env,
                       house_factory=lambda name: house, visualize_every=visualize_every)
        seconds = time.perf_counter() - t0
    finally:
        mapper_mod.log_frame = log_frame
    logs = DiskReader(str(Path(cfg.RESULT_LOCATION) / name_from_config(cfg))).data()
    return seconds, frames[0], frames[1], logs


def same_logs(a: dict, b: dict) -> bool:
    return a.keys() == b.keys() and all(
        len(a[k]) == len(b[k]) and all(np.array_equal(x[0], y[0]) and list(x[1:]) == list(y[1:])
                                       for x, y in zip(a[k], b[k])) for k in a)


def strip_check(tmp: Path) -> dict:
    """Phase 13 (c): the evaluate CLI with -v (sequential, one geodesic
    fake-env episode at 224 px, SLAM) on the card and on the CPU: the
    same strip file, pixel-equal read back by the port's reader, and the
    step logs of the same episode through run_policy without
    visualisation. The cost a logged frame: that episode through
    run_policy with visualize_every 0, 1, 0, 1, the faster run of each
    kind (the first may pay start-up)."""
    card, card_png = strip_cli(tmp, "card", None, True)
    cpu, cpu_png = strip_cli(tmp, "cpu", "cpu", True)
    names = [[p.relative_to(tmp / f"videos_{t}") for p in pngs]
             for t, pngs in (("card", card_png), ("cpu", cpu_png))]
    if len(card_png) != 1 or names[0] != names[1]:
        raise AssertionError(f"strips: card {names[0]}, cpu {names[1]}")
    runs = {0: [], 1: []}
    for i, every in enumerate((0, 1, 0, 1)):
        runs[every].append(strip_seconds(tmp, f"timed_{i}", every))
    frames = {n for _, n, _, _ in runs[1]}
    if any(n for _, n, _, _ in runs[0]) or len(frames) != 1 or \
            list((tmp / "videos_timed_0").rglob("*.png")):
        raise AssertionError(f"strips: frames logged {runs[0]} without visualisation, "
                             f"{frames} with")
    strip, cpu_strip = read_png(str(card_png[0])), read_png(str(cpu_png[0]))
    if not np.array_equal(strip, cpu_strip) or not same_logs(card, cpu) or \
            not all(same_logs(card, logs) for k in (0, 1) for _, _, _, logs in runs[k]):
        raise AssertionError("strips: the card's strip or step logs differ from the CPU's "
                             "or from the runs without visualisation")
    frames = frames.pop()
    in_log_frame = min(t for _, _, t, _ in runs[1]) / frames * 1e3
    runs = {k: [t for t, _, _, _ in v] for k, v in runs.items()}
    plain_s, visualised_s = min(runs[0]), min(runs[1])
    per_frame = (visualised_s - plain_s) / frames * 1e3
    log(f"[viz] evaluate CLI -v, 1 geodesic fake-env episode at {IMAGE_SIZE} px (STOP: "
        f"{len(card[0])} logged steps): the strip {names[0][0]} ({strip.shape[0]}x"
        f"{strip.shape[1]}) equals the CPU's; step logs equal the CPU's and run_policy's "
        f"without visualisation; run_policy on the card {visualised_s:.3f} s with "
        f"visualize_every=1, {plain_s:.3f} s with 0 (faster of 2 each; all {runs}): "
        f"{frames} frames logged, {per_frame:.4f} ms a frame; inside log_frame "
        f"{in_log_frame:.4f} ms a frame (the faster run), host")
    return {"steps": len(card[0]), "frames": frames, "strip_shape": list(strip.shape),
            "visualised_s": visualised_s, "plain_s": plain_s, "runs_s": runs,
            "ms_per_frame": per_frame, "log_frame_ms": in_log_frame}


def state_snapshot(state) -> list:
    """Copies of the online net's parameters and buffers and Adam's state."""
    tensors = list(state.model.state_dict().values())
    for group in state.optimizer.state.values():
        tensors += [v for v in group.values() if torch.is_tensor(v)]
    return [t.detach().clone() for t in tensors]


def hook_check(tmp: Path, root: Path) -> dict:
    """Phase 13 (d): the training CLI with VISUALIZATION_DATA_ROOT at (a)'s
    grid, the published config at B = 256, bf16, 10 steps on the fixture's
    device table, a checkpoint at 10: 5 PNGs under the run dir; the online
    net's parameters and buffers and Adam's state bit-unchanged across the
    hook; the net back in train mode; the hook's seconds."""
    folder = write_experiment(tmp / "viz_q", DATASET=torch_qdata.FEATHER,
                              NUM_STEPS=SIM_TRAIN_STEPS, CHECKPOINT_INTERVAL=SIM_TRAIN_STEPS,
                              TARGET_UPDATE_INTERVAL=5, TPU={"DEVICE_DATASET": True},
                              VISUALIZATION_DATA_ROOT=str(root.parent))
    saved = train_q_network.value_map_hook
    seen = {}

    def spy(config, device):
        hook = saved(config, device)

        def timed(model, state, step):
            before = state_snapshot(state)
            torch.cuda.synchronize()
            seen["train_launches"] = dict(rn.LAUNCHES)
            rn.LAUNCHES.clear()
            t0 = time.perf_counter()
            hook(model, state, step)
            torch.cuda.synchronize()
            seen["seconds"] = time.perf_counter() - t0
            seen["launches"] = dict(rn.LAUNCHES)
            rn.LAUNCHES.clear()
            after = state_snapshot(state)
            seen["unchanged"] = len(before) == len(after) and all(
                torch.equal(a, b) for a, b in zip(before, after))
            seen["train_mode"] = model.training and not model.resnet.training
            seen["step"] = step

        return timed

    train_q_network.value_map_hook = spy
    rn.LAUNCHES.clear()
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            train_q_network.main([folder, "--log-every", "5"], device=ONE_CARD)
    finally:
        train_q_network.value_map_hook = saved
    after = dict(rn.LAUNCHES)  # what ran after the hook: nothing
    run_dir = Path(ExperimentConfig(folder, resume=True).run_dir)
    pngs = sorted(p.name for p in run_dir.glob("*.png"))
    want = sorted(f"value_map_{root.name}_{c}_{SIM_TRAIN_STEPS}.png" for c in CLASS_LABELS)
    batches = -(-len(VisualizationGrid(str(root))) // VIZ_BATCH)
    train = seen.get("train_launches")
    if pngs != want or not seen.get("unchanged") or not seen.get("train_mode") or \
            seen.get("launches") != {("identity", "bfloat16"): batches} or \
            train != {("identity", "bfloat16"): 2 * SIM_TRAIN_STEPS} or after:
        raise AssertionError(f"checkpoint hook: PNGs {pngs}, state unchanged "
                             f"{seen.get('unchanged')}, train mode {seen.get('train_mode')}, "
                             f"launches {seen.get('launches')}, the steps' {train}, after "
                             f"the hook {after}")
    log(f"[viz] training CLI with VISUALIZATION_DATA_ROOT, B = 256, bf16, {SIM_TRAIN_STEPS} "
        f"steps: the hook at step {seen['step']} took {seen['seconds']:.3f} s ({batches} "
        f"bf16 identity launches, 5 maps at resolution {VIZ_MAP_RESOLUTION}; the steps "
        f"before it {train}); parameters, "
        f"buffers and Adam's state bit-unchanged across it, train mode restored; {pngs}")
    return {"hook_s": seen["seconds"], "pngs": len(pngs),
            "launches": {"identity": train[("identity", "bfloat16")]
                         + seen["launches"][("identity", "bfloat16")], "banded": 0}}


def viz_path() -> dict:
    """Phase 13: (a) value maps, (b) the all-class scorer, (c) episode
    strips, (d) the checkpoint hook. launches sums the main-path runs,
    each counted from 0."""
    t0 = time.perf_counter()
    _build.BUILD_DIR.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as tmp_name:
        tmp = Path(tmp_name)
        ckpt = tmp / "qnet.torch"
        seeded_checkpoint(ckpt, published_config())
        maps = value_map_check(tmp, ckpt)
        allclass = allclass_check(ckpt)
        strips = strip_check(tmp)
        hook = hook_check(tmp, maps.pop("root"))
    runs = (maps, allclass, hook)
    out = {"value_maps": maps, "allclass": allclass, "strips": strips, "hook": hook,
           "launches": {p: sum(r["launches"][p] for r in runs) for p in ("identity", "banded")}}
    out["seconds"] = time.perf_counter() - t0
    log(f"[viz] phase 13 in {out['seconds']:.1f} s; launches {out['launches']}")
    return out

# -- phase 14: frame extraction ----------------------------------------------------

# the NV12 -> RGB kernel's timed shapes (frames, height, width): first the
# main path's call, a full batch of the fixture's 720p; then YouTube's 1080p
# and 480p (854 wide: rows off 16 bytes, the kernel's flat path) batches,
# the single frames of the kernel's earlier, frame-a-launch design, and a
# 2-column tail (36 pixels: two 16-pixel runs, then the scalar path)
NV12_SHAPES = ((16, 720, 1280), (16, 1080, 1920), (16, 480, 854), (1, 720, 1280),
               (1, 1080, 1920), (1, 2, 18))
# bytes the kernel moves a pixel: 1.5 in (NV12), 3 out (RGB)
NV12_BYTES_PER_PIXEL = 4.5
# the card's L2: a call that moves less stays in it across back-to-back
# launches, so such a row is also timed with the L2 overwritten first
L2_BYTES = 50 * 2 ** 20
# decode_frames(target=) (swscale's scaled path): the Q-net's input and
# two other targets from 720p (the last an odd width: full-width chroma)
# and an upscale from small.mp4; the kernel timed at a batch of 16 and at
# decode_frames' one frame a launch
SCALE_TARGETS = (("hd720", (224, 224)), ("hd720", (342, 256)), ("hd720", (223, 167)),
                 ("small", (320, 240)))
SCALE_TIMED = ((16, 720, 1280, (224, 224)), (1, 720, 1280, (224, 224)))


def decode_check(name: str, exp: dict) -> dict:
    """Decode `name` through the port's decoder, sampling at 0.5 fps as the
    CLI does: every frame's pts equal to libavcodec's, the kept indices
    JAX's, each kept frame's NV12 planes libavcodec's bit for bit. Returns
    the kept planes on the card and the seconds it took."""
    t0 = time.perf_counter()
    sampler = video_mod.FrameSampler(0.5)
    times, keep, planes = [], [], []
    with Mp4Video(vfix.path(name)) as video:
        for i, (t, frame) in enumerate(decoded_frames(video)):
            times.append(t)
            if sampler.keep(t):
                keep.append(i)
                y, uv = frame.nv12()
                planes.append((torch.from_numpy(y).cuda(), torch.from_numpy(uv).cuda()))
    seconds = time.perf_counter() - t0
    hashes = [vfix.nv12_sha256(y.cpu().numpy(), uv.cpu().numpy()) for y, uv in planes]
    want_times = vfix.display_seconds(exp, name)
    if not np.array_equal(np.asarray(times), want_times):
        raise AssertionError(f"{name}: {len(times)} frame times, not libavcodec's {len(want_times)}")
    if keep != exp[f"{name}_keep"].tolist():
        raise AssertionError(f"{name}: kept frames {keep}, JAX keeps {exp[f'{name}_keep'].tolist()}")
    if hashes != exp[f"{name}_nv12_sha256"].tolist():
        bad = [k for k, (a, b) in enumerate(zip(hashes, exp[f"{name}_nv12_sha256"])) if a != b]
        raise AssertionError(f"{name}: kept frames {bad} differ from libavcodec's planes")
    log(f"[video] {name}: {len(times)} frames decoded in {seconds:.3f} s "
        f"({len(times) / seconds:.1f} frames/s, host decoder), pts and kept frames {keep} equal "
        f"libavcodec's and JAX's, {len(planes)} kept NV12 frames bit-equal to libavcodec's")
    return {"frames": len(times), "kept": keep, "seconds": seconds, "planes": planes,
            "hashes": hashes}


def feature_checks(exp: dict) -> dict:
    """Every frame of each coding-tool clip bit-equal to libavcodec's; the
    refused streams raise NotImplementedError."""
    for name in vfix.FEATURES:
        with Mp4Video(vfix.feature_path(name)) as video:
            got = [vfix.nv12_sha256(*f.nv12()) for _, f in decoded_frames(video)]
        if got != exp[f"feature_{name}_nv12_sha256"].tolist():
            raise AssertionError(f"coding-tool clip {name}: frames differ from libavcodec's")
    refused = {}
    for name, spec in vfix.REFUSED.items():
        with Mp4Video(vfix.feature_path(name)) as video:
            try:
                for _ in decoded_frames(video):
                    pass
            except NotImplementedError as e:
                if spec[-1] not in str(e):
                    raise
                refused[name] = str(e).split(": ", 1)[-1]
            else:
                raise AssertionError(f"the decoder took the {name} clip")
    log(f"[video] coding-tool clips {list(vfix.FEATURES)}: every frame bit-equal to "
        f"libavcodec's; refused as expected: {refused}")
    return {"clips": len(vfix.FEATURES), "refused": refused}


def nv12_inputs(n: int, h: int, w: int, seed: int, offset: int = 0):
    """Seeded (n, h, w) and (n, h/2, w) NV12 planes on the card, tight as the
    decoder hands them over, each starting `offset` bytes into its
    allocation."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    planes = []
    for rows in (h, h // 2):
        flat = torch.randint(0, 256, (offset + n * rows * w,), dtype=torch.uint8, device="cuda",
                             generator=g)
        planes.append(flat[offset:].view(n, rows, w))
    return planes


def nv12_kernel_rows(kept: list, exp: dict) -> list:
    """The kernel against its plain twin (exact: integer arithmetic) on every
    kept frame, in the batches the CLI forms (up to WRITE_BATCH a launch),
    small.mp4's RGB against JAX's frames (exact), and 720p planes off 16
    bytes (which the wrapper copies first); then on seeded batches at
    NV12_SHAPES, each timed against its bound: the profiler's device ms
    back to back, and with the L2 overwritten before each call where the
    call fits the L2."""
    batches = 0
    for name, planes in kept:
        for b in range(0, len(planes), video_mod.WRITE_BATCH):
            part = planes[b:b + video_mod.WRITE_BATCH]
            y, uv = torch.stack([p[0] for p in part]), torch.stack([p[1] for p in part])
            got, want = nv12_mod.nv12_to_rgb(y, uv), nv12_mod.nv12_to_rgb_reference(y, uv)
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                err = int((got.int() - want.int()).abs().max().item())
                raise AssertionError(f"nv12_rgb on {name} frames {b}..: max |kernel - twin| {err}")
            if name == "small" and not np.array_equal(got.cpu().numpy(),
                                                      exp["small_rgb"][b:b + len(part)]):
                raise AssertionError(f"nv12_rgb on small.mp4 frames {b}..: not JAX's RGB")
            batches += 1
    for offset in (1, 8):
        y, uv = nv12_inputs(2, 720, 1280, SEED + offset, offset)
        if not torch.equal(nv12_mod.nv12_to_rgb(y, uv), nv12_mod.nv12_to_rgb_reference(y, uv)):
            raise AssertionError(f"nv12_rgb on planes {offset} bytes off 16: differs from its twin")
    log(f"[kernel] nv12_rgb on {sum(len(p) for _, p in kept)} kept fixture frames in {batches} "
        f"batches: bit-equal to its twin; small.mp4's RGB equal to the JAX package's frames; "
        f"bit-equal on 2x720p planes 1 and 8 bytes off 16 (copied by the wrapper)")
    flush = torch.empty(2 ** 27, dtype=torch.uint8, device="cuda")
    rows = []
    for n, h, w in NV12_SHAPES:
        y, uv = nv12_inputs(n, h, w, SEED)
        got, want = nv12_mod.nv12_to_rgb(y, uv), nv12_mod.nv12_to_rgb_reference(y, uv)
        if not torch.equal(got, want):
            raise AssertionError(f"nv12_rgb {n}x{w}x{h}: kernel differs from its twin")
        call = lambda: nv12_mod.nv12_to_rgb(y, uv)  # noqa: E731
        event_ms = queued_ms(call)
        device_ms = kernel_device_ms(call, kernels=("nv12_rgb",))
        ms = device_ms if device_ms is not None else event_ms
        plain_ms = queued_ms(lambda: nv12_mod.nv12_to_rgb_reference(y, uv))
        n_bytes = int(NV12_BYTES_PER_PIXEL * n * w * h)
        warm = n_bytes < L2_BYTES
        cold_ms = (kernel_device_ms(lambda: (flush.zero_(), call()), kernels=("nv12_rgb",))
                   if warm else None)
        bound_ms = n_bytes / HBM_BYTES_PER_S * 1e3
        row = {"shape": [n, h, w], "max_abs_err": 0, "ms": ms,
               "ms_source": "profiler" if device_ms is not None else "queued events",
               "event_ms": event_ms, "l2_warm": warm, "cold_l2_device_ms": cold_ms,
               "plain_ms": plain_ms, "bound_ms": bound_ms,
               "bound_by": "bytes", "share_of_bound": bound_ms / ms, "bytes": n_bytes,
               "gb_per_s": n_bytes / ms / 1e6, "library_ms": None}
        log(f"[kernel] nv12_rgb {n}x{w}x{h}: bit-equal to its twin; device "
            f"{ms:.5f} ms ({row['ms_source']}{', L2-warm' if warm else ''}), queued events "
            f"{event_ms:.5f} ms" + (f", L2-cold {cold_ms:.5f} ms" if cold_ms is not None else "")
            + f"; plain {plain_ms:.4f} ms; bound {bound_ms:.5g} ms (bytes), "
            f"{row['share_of_bound']:.1%} of it, {row['gb_per_s']:.1f} GB/s")
        rows.append(row)
    return rows


def scale_bytes(n: int, h: int, w: int, target) -> int:
    """What the scaled conversion must move: the NV12 planes read once and
    the RGB written once."""
    return int(1.5 * n * w * h + 3 * n * target[0] * target[1])


def scale_checks(planes: dict, exp: dict) -> dict:
    """Phase 14 (e): decode_frames(fps=0.5, target=) on the card at
    SCALE_TARGETS (the main path, counts from 0: one scaled launch a kept
    frame, no NV12 launch; the 720p targets decoded side by side, one
    thread each), each frame bit-equal to the twin on the same kept
    planes (phase 14 (a)'s); the native size as a target launches the NV12
    kernel instead and gives JAX's frames; then the kernel against its
    twin on seeded batches at SCALE_TIMED, timed against its bound."""
    nv12_mod.LAUNCHES.clear()
    nv12_scale_mod.LAUNCHES.clear()
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(SCALE_TARGETS)) as pool:
        frames = dict(zip(SCALE_TARGETS, pool.map(
            lambda job: list(video_mod.decode_frames(str(vfix.path(job[0])), 0.5, job[1])),
            SCALE_TARGETS)))
    seconds = time.perf_counter() - t0
    launches = nv12_scale_mod.LAUNCHES["nv12_scale_rgb"]
    count = sum(len(f) for f in frames.values())
    if launches != count or nv12_mod.LAUNCHES["nv12_rgb"]:
        raise AssertionError(f"decode_frames(target=): {launches} scaled and "
                             f"{nv12_mod.LAUNCHES['nv12_rgb']} NV12 launches for {count} frames")
    for (name, target), got in frames.items():
        kept = planes[name]
        h, w = kept[0][0].shape
        tables = nv12_scale_mod.scale_tables(w, h, *target)
        if len(got) != len(kept):
            raise AssertionError(f"decode_frames({name}, target={target}): {len(got)} frames, "
                                 f"{len(kept)} kept")
        for k, ((y, uv), frame) in enumerate(zip(kept, got)):
            want = nv12_scale_mod.nv12_scale_rgb_reference(y, uv, tables).cpu().numpy()
            if frame.shape != (target[1], target[0], 3) or not np.array_equal(frame, want):
                raise AssertionError(f"decode_frames({name}, target={target}) frame {k}: not "
                                     "the twin's RGB of its planes")
    nv12_mod.LAUNCHES.clear()
    nv12_scale_mod.LAUNCHES.clear()
    native = list(video_mod.decode_frames(str(vfix.path("small")), 0.5, (160, 120)))
    if nv12_mod.LAUNCHES["nv12_rgb"] != len(native) or nv12_scale_mod.LAUNCHES or \
            not np.array_equal(np.stack(native), exp["small_rgb"]):
        raise AssertionError(f"decode_frames(small, target=(160, 120)): launches "
                             f"{dict(nv12_mod.LAUNCHES)} {dict(nv12_scale_mod.LAUNCHES)}, or "
                             "not JAX's frames")
    log(f"[video] decode_frames(fps=0.5, target=) at {[f'{n} -> {t[0]}x{t[1]}' for n, t in SCALE_TARGETS]}: "
        f"{count} frames, bit-equal to the scaled twin on the same kept planes, in {seconds:.3f} s "
        f"({len(SCALE_TARGETS)} threads); nv12_scale_rgb launches {launches} (one a frame); the "
        f"native size as a target launched nv12_rgb {len(native)} times, JAX's frames")
    rows = []
    for n, h, w, target in SCALE_TIMED:
        y, uv = nv12_inputs(n, h, w, SEED)
        tables = nv12_scale_mod.scale_tables(w, h, *target)
        got = nv12_scale_mod.nv12_scale_rgb(y, uv, tables)
        want = nv12_scale_mod.nv12_scale_rgb_reference(y, uv, tables)
        if not torch.equal(got, want):
            err = int((got.int() - want.int()).abs().max().item())
            raise AssertionError(f"nv12_scale_rgb {n}x{w}x{h} -> {target}: max |kernel - twin| "
                                 f"{err}")
        call = lambda: nv12_scale_mod.nv12_scale_rgb(y, uv, tables)  # noqa: E731
        event_ms = queued_ms(call)
        device_ms = kernel_device_ms(call, kernels=("nv12_scale_rgb",))
        ms = device_ms if device_ms is not None else event_ms
        plain_ms = queued_ms(lambda: nv12_scale_mod.nv12_scale_rgb_reference(y, uv, tables),
                             iters=10)
        n_bytes = scale_bytes(n, h, w, target)
        bound_ms = n_bytes / HBM_BYTES_PER_S * 1e3
        row = {"shape": [n, h, w], "target": list(target), "filter_sizes": list(tables.sizes),
               "max_abs_err": 0, "ms": ms,
               "ms_source": "profiler" if device_ms is not None else "queued events",
               "event_ms": event_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
               "bound_by": "bytes", "share_of_bound": bound_ms / ms, "bytes": n_bytes,
               "library_ms": None}
        log(f"[kernel] nv12_scale_rgb {n}x{w}x{h} -> {target[0]}x{target[1]} (filters "
            f"{tables.sizes}): bit-equal to its twin; device {ms:.5f} ms ({row['ms_source']}), "
            f"queued events {event_ms:.5f} ms; plain {plain_ms:.4f} ms; bound {bound_ms:.5g} ms "
            f"(bytes), {row['share_of_bound']:.1%} of it")
        rows.append(row)
    return {"launches": launches, "frames": count, "seconds": seconds, "rows": rows}


def dump_cli(tmp: Path, exp: dict) -> dict:
    """The -d CLI on small.mp4 and hd720.mp4 (the main path, launches
    counted from 0): JPEGs equal to the JAX package's files, a second run
    writing nothing, then the filter pass over the dumped frames."""
    videos, frames, filters = tmp / "videos", tmp / "frames", tmp / "filters"
    videos.mkdir()
    for name in vfix.DUMP_VIDEOS:
        (videos / f"{name}.mp4").symlink_to(vfix.path(name))
    nv12_mod.LAUNCHES.clear()
    clear_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()) as out:
        done = extract_frames.main(["-d", "--location", str(videos), "--frames", str(frames)])
    seconds = time.perf_counter() - t0
    launches = nv12_mod.LAUNCHES["nv12_rgb"]
    counts = {**detector_counts(), "nv12_rgb": launches}
    kept = sum(len(exp[f"{n}_keep"]) for n in vfix.DUMP_VIDEOS)
    # one launch a batch of up to WRITE_BATCH kept frames of a video
    batches = sum(-(-len(exp[f"{n}_keep"]) // video_mod.WRITE_BATCH) for n in vfix.DUMP_VIDEOS)
    if done != sorted(vfix.DUMP_VIDEOS) or f"extracted {len(done)} videos" not in out.getvalue():
        raise AssertionError(f"--dump extracted {done}: {out.getvalue()!r}")
    if launches != batches:
        raise AssertionError(f"--dump launched nv12_rgb {launches} times for {kept} kept frames "
                             f"in {batches} batches")
    for name in vfix.DUMP_VIDEOS:
        files = sorted((frames / name).iterdir())
        got = [vfix.file_sha256(f) for f in files]
        if got != exp[f"{name}_jpeg_sha256"].tolist():
            raise AssertionError(f"--dump {name}: JPEG files differ from the JAX package's")
    stamps = {p: p.stat().st_mtime_ns for p in frames.rglob("*.jpg")}
    with contextlib.redirect_stdout(io.StringIO()):
        again = extract_frames.main(["-d", "--location", str(videos), "--frames", str(frames)])
    if again != [] or {p: p.stat().st_mtime_ns for p in frames.rglob("*.jpg")} != stamps:
        raise AssertionError(f"a second --dump run extracted {again}")
    with contextlib.redirect_stdout(io.StringIO()):
        written = extract_frames.main(["--frames", str(frames), "--out", str(filters),
                                       "--stub-detector", "--allow-passthrough"])
    if sorted(written) != sorted(vfix.DUMP_VIDEOS) or not all(Path(p).exists() for p in written.values()):
        raise AssertionError(f"the filter pass over the dumped frames wrote {written}")
    log(f"[video] extract_frames -d over {list(vfix.DUMP_VIDEOS)}: {kept} JPEG files equal to the "
        f"JAX package's, byte for byte, in {seconds:.3f} s; launches {counts} ({batches} "
        f"batches); "
        f"a second run wrote nothing; the filter pass (stub detector, passthrough) read them")
    return {"seconds": seconds, "launches": counts, "jpegs": kept}


def extraction_rate(tmp: Path, fps: float, device: str = "cuda") -> dict:
    """hd720.mp4 through extract_frames at `fps` (0: every frame), the kept
    frames converted on `device` (the CPU: the plain twin on the host):
    decoded and written frames/s, the host split (demux, decode,
    conversion with its copies, JPEG write) and the conversion's ms a kept
    frame."""
    timings = {}
    dest = tmp / f"rate_{fps}_{device}"
    t0 = time.perf_counter()
    written = video_mod.extract_frames(str(vfix.path("hd720")), str(dest), fps=fps, device=device,
                                       timings=timings)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    frames = len(vfix.expected()["hd720_frame_pts"])
    split = {k: timings.get(k, 0.0) for k in ("demux", "decode", "convert", "write")}
    split["other"] = seconds - sum(split.values())
    convert_ms = split["convert"] / written * 1e3
    log(f"[video] hd720.mp4 (1280x720, {frames} frames) at fps {fps}, converted on {device}: "
        f"{seconds:.3f} s, {frames / seconds:.1f} frames decoded/s, {written} written "
        f"({written / seconds:.2f}/s); conversion with its copies {convert_ms:.4f} ms a kept "
        f"frame; host split " + ", ".join(f"{k} {v:.3f} s ({v / seconds:.1%})"
                                          for k, v in split.items()))
    shutil.rmtree(dest)
    return {"fps": fps, "device": device, "seconds": seconds, "decoded_per_s": frames / seconds,
            "written": written, "written_per_s": written / seconds,
            "convert_ms_per_frame": convert_ms, "split_s": split}


def video_path() -> dict:
    """Phase 14: (a) decoding, (b) the NV12 -> RGB kernel, (c) the -d CLI,
    (d) rates, (e) decode_frames(target=) and the scaled kernel. launches
    are the CLI run's, counted from 0, and (e)'s decode_frames runs'."""
    t0 = time.perf_counter()
    exp = vfix.expected()
    decoded = {name: decode_check(name, exp) for name in vfix.VIDEOS}
    if decoded["small"]["hashes"] != decoded["small_fragmented"]["hashes"]:
        raise AssertionError("small.mp4 and its fragmented copy decode to other frames")
    features = feature_checks(exp)
    planes = {n: d.pop("planes") for n, d in decoded.items()}
    kernel_rows = nv12_kernel_rows(list(planes.items()), exp)
    scale = scale_checks(planes, exp)
    del planes
    _build.BUILD_DIR.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as tmp_name:
        tmp = Path(tmp_name)
        cli = dump_cli(tmp, exp)
        # the card's round trip against the plain twin on the host, on the
        # same kept frames
        rates = [extraction_rate(tmp, 0.5), extraction_rate(tmp, 0), extraction_rate(tmp, 0.5, "cpu")]
    card, host = rates[0]["convert_ms_per_frame"], rates[2]["convert_ms_per_frame"]
    log(f"[video] the conversion a kept 720p frame: the card's round trip {card:.4f} ms, the plain "
        f"twin on the host {host:.4f} ms ({host / card:.1f}x)")
    out = {"decoded": {n: {k: v for k, v in d.items() if k != "hashes"} for n, d in decoded.items()},
           "features": features, "kernel": kernel_rows, "scale": scale, "cli": cli,
           "rates": rates,
           "launches": {**cli["launches"], "nv12_scale_rgb": scale["launches"]}}
    out["seconds"] = time.perf_counter() - t0
    log(f"[video] phase 14 in {out['seconds']:.1f} s; launches {out['launches']}")
    return out


# -- phase 15: captions, REMAT, decode workers, the synthetic dataset ------------

GOLDEN = ROOT / "tests" / "data" / "join_images_golden.npz"
REMAT_STEPS, REMAT_TIMED = 10, 8       # steps a run; the last REMAT_TIMED are timed
REMAT_FRAMES, REMAT_ROWS = 512, 1024   # the REMAT runs' synthetic table
BASIC_STEPS, BASIC_BATCH = 2, 32       # basic's REMAT check, float32
# basic's running statistics, REMAT on against off: the CPU tests' rule for
# running statistics against JAX's (tests/test_torch_train.py)
BN_RTOL, BN_ATOL = 1e-4, 1e-5
# REMAT on against off, published config: each loss and every parameter
# after the run. The recomputation runs the same kernels on the same
# inputs, so the two runs agree to rounding at most
REMAT_ATOL = 1e-6
WORKERS = 4
SYNTH_STEPS, SYNTH_BATCH = 10, 32      # make_synthetic_dataset's defaults give 42 rows
# the decode-worker run of the training CLI, in a process of its own: its
# workers must fork before CUDA starts there. It imports what it needs,
# prints "ready", and waits for the experiment's folder on its standard
# input, so that its imports overlap the parts before it. It records the
# labels and the time of every batch the stream hands the loop, then prints
# them against the rows that np.random.default_rng(SEED) draws from the
# stream's batcher, its launches, its live children and its start-up times.
WORKER_RUNNER = r"""
import time
t_start = time.perf_counter()
import json, multiprocessing, os, sys
import numpy as np
from video_dqn_tpu_torch import train_q_network
from video_dqn_tpu_torch.data.workers import LABEL_KEYS
from video_dqn_tpu_torch.ops import resize_normalize as rn
from video_dqn_tpu_torch.train import dqn

seen, times, streams = [], [], []
real = dqn.parallel_batches


class Spy:
    def __init__(self, stream):
        self.stream = stream

    def __iter__(self):
        return self

    def __next__(self):
        batch = next(self.stream)
        seen.append({k: batch[k] for k in LABEL_KEYS})
        times.append(time.perf_counter())
        return batch

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.stream.close()


def spied(batcher, batch_size, **kw):
    stream = real(batcher, batch_size, **kw)
    streams.append((batcher, batch_size, kw, stream))
    return Spy(stream)


dqn.parallel_batches = spied
t_ready = time.perf_counter()
print("ready", flush=True)
folder = sys.stdin.readline().strip()
t_go = time.perf_counter()
train_q_network.main([folder, "--log-every", sys.argv[1]], device="cuda:0")
t_end = time.perf_counter()
(batcher, batch_size, kw, stream), = streams
rng = np.random.default_rng(kw["seed"])
equal = True
for got in seen:
    rows = rng.integers(0, len(batcher), batch_size)
    want = {"action": batcher.action, "reward": batcher.reward, "terminal": batcher.terminal,
            "gt": batcher.gt, "valid_mask": batcher.valid_mask}
    equal &= all(np.array_equal(got[k], want[k][rows], equal_nan=True) for k in LABEL_KEYS)
pid = str(os.getpid())
children = [p for p in os.listdir("/proc") if p.isdigit() and os.path.exists(f"/proc/{p}/stat")
            and open(f"/proc/{p}/stat").read().rsplit(")", 1)[1].split()[1] == pid]
print(json.dumps({"batches": len(seen), "labels_equal": bool(equal), "workers": kw["num_workers"],
                  "seed": kw["seed"], "alive_workers": sum(p.is_alive() for p in stream.procs),
                  "children": len(children) + len(multiprocessing.active_children()),
                  "launches": {f"{p}/{d}": n for (p, d), n in rn.LAUNCHES.items()},
                  "import_s": t_ready - t_start, "go_to_first_batch_s": times[0] - t_go,
                  "first_batches_s": times[10] - times[0], "after_last_batch_s": t_end - times[-1],
                  "run_s": t_end - t_go}))
"""


class WorkerRunner:
    """WORKER_RUNNER started at once, importing in the background; `run`
    hands it an experiment folder and returns its JSON line. Closing it
    kills it if it is still running."""

    def __init__(self):
        self.ready = False
        self.proc = subprocess.Popen(
            [sys.executable, "-c", WORKER_RUNNER, str(TRAIN_LOG_EVERY)], cwd=ROOT,
            stdin=subprocess.PIPE, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)

    def wait_ready(self) -> None:
        if self.ready:
            return
        line = self.proc.stdout.readline()
        self.ready = line.strip() == "ready"
        if not self.ready:
            out, err = self.proc.communicate(timeout=60)
            raise AssertionError(f"the decode-worker runner did not start:\n{line}{out[-3000:]}"
                                 f"\n{err[-3000:]}")

    def run(self, folder: str) -> dict:
        self.wait_ready()
        out, err = self.proc.communicate(folder + "\n", timeout=300)
        if self.proc.returncode != 0:
            raise AssertionError(f"the decode-worker CLI failed:\n{out[-3000:]}\n{err[-3000:]}")
        return json.loads(out.strip().splitlines()[-1])

    def close(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
        self.proc.communicate()


def caption_check(tmp: Path, ckpt: Path) -> dict:
    """Phase 15 (a): join_images with captions pixel-equal to the committed
    golden (drawn by cv2 in the JAX package; this machine has no cv2);
    panorama_strip captioned by the published Q-net's scores at 224^2
    (identity) and 256^2 (banded), its scores within SERVE_ATOL of float32
    card forwards; a -v geodesic episode at 224 px: every stop's
    current_pan on the card equal to the CPU's, pixel for pixel, and no
    launch in the card's run (the geodesic scorer runs no network)."""
    g = np.load(GOLDEN)
    t0 = time.perf_counter()
    annotated = join_images(list(g["ims"]), g["vals"], br_text="bed", bl_text="step 7")
    golden_ms = (time.perf_counter() - t0) * 1e3
    if not np.array_equal(annotated, g["annotated"]):
        raise AssertionError(f"join_images: {(annotated != g['annotated']).sum()} values differ "
                             "from the golden")
    model = load_eval_model(SimpleNamespace(PRETRAINED_MODEL_LOCATION=str(ckpt)),
                            published_config(), image_size=IMAGE_SIZE)
    allclass = make_allclass_scorer(model, image_size=IMAGE_SIZE)
    out = {"golden_ms": golden_ms, "launches": {"identity": 0, "banded": 0}}
    for side, path in ((IMAGE_SIZE, "identity"), (256, "banded")):
        env = FakeNavEnv(image_size=side, seed=SEED)
        env.set_agent_state(*env.sample_start_state())
        start = env.agent_state()
        allclass(np.zeros((STOP_VIEWS, side, side, 3), np.uint8))  # the shape's first call
        rn.LAUNCHES.clear()
        t0 = time.perf_counter()
        strip, scores = panorama_strip(env, scorer=lambda v: allclass(v)[:, 0])
        ms = (time.perf_counter() - t0) * 1e3
        launches = dict(rn.LAUNCHES)
        env.set_agent_state(*start)
        views = np.stack([env.step(1)[0]["rgb"] for _ in range(STOP_VIEWS)])
        err = float(np.abs(scores - allclass_f32(model, views[:, None])[:, 0]).max())
        if launches != {(path, "bfloat16"): 1} or err > SERVE_ATOL or \
                not np.array_equal(strip, join_images(list(views), -scores)) or \
                strip.shape[0] != side + 50:
            raise AssertionError(f"panorama_strip at {side}^2: launches {launches}, bf16 vs "
                                 f"float32 card {err:.6f}, strip {strip.shape}")
        out["launches"][path] += 1
        out[side] = {"ms": ms, "bf16_vs_f32": err, "shape": list(strip.shape)}
        log(f"[rest] panorama_strip, published Q-net scorer, {STOP_VIEWS} views of {side}^2 "
            f"({path} kernel): {ms:.3f} ms (render, score, captions); strip {strip.shape}; "
            f"launches {launches}; bf16 vs float32 card {err:.6f} (limit {SERVE_ATOL})")

    pans = {}
    saved = evaluate_mod.join_images
    for device in ("cuda", "cpu"):
        made = pans.setdefault(device, [])

        def recording(*a, **kw):
            made.append(saved(*a, **kw))
            return made[-1]

        cfg = strip_config(tmp, f"pan_{device}")
        with fake_env_at(IMAGE_SIZE):
            env, house, ep = evaluate_cli.make_env_and_episode()
        evaluate_mod.join_images = recording
        rn.LAUNCHES.clear()
        try:
            with contextlib.redirect_stdout(io.StringIO()):
                run_policy(cfg, np.array([ep], dtype=object), env_factory=lambda h, mc, c: env,
                           house_factory=lambda name: house, visualize_every=1, device=device)
        finally:
            evaluate_mod.join_images = saved
        if device == "cuda":
            episode_launches = dict(rn.LAUNCHES)
    card, cpu = pans["cuda"], pans["cpu"]
    if episode_launches:
        raise AssertionError(f"the -v geodesic episode on the card launched {episode_launches}")
    if not card or len(card) != len(cpu) or \
            not all(np.array_equal(a, b) for a, b in zip(card, cpu)):
        raise AssertionError(f"current_pan: {len(card)} stops on the card, {len(cpu)} on the "
                             "CPU, or a strip differs")
    out["stops"], out["episode_launches"] = len(card), episode_launches
    log(f"[rest] join_images with captions equals the golden pixel for pixel ({golden_ms:.3f} "
        f"ms); a -v geodesic episode at {IMAGE_SIZE} px: {len(card)} stops, every current_pan "
        f"{card[0].shape} equal on the card and the CPU; the card's episode launched "
        f"{episode_launches or 'nothing'} (a geodesic scorer)")
    return out


def remat_runs(tmp: Path) -> dict:
    """Phase 15 (b): the published config (extra_capacity, 224 px, B = 256,
    bf16) from the seeded state, REMAT_STEPS steps with REMAT off, then on,
    on the same device-table batches: peak memory, ms/step over the last
    REMAT_TIMED steps, each step's loss against the other run's within
    phase 5's bf16 rule and within REMAT_ATOL, every parameter after the
    run within REMAT_ATOL, and the trunk moved from its init with REMAT on
    (its gradients reach it). Then BASIC_STEPS float32 steps of the basic
    architecture with REMAT off and on, with cuDNN's deterministic
    algorithms (without them the two runs' float32 steps are not
    bit-reproducible on the card): the running statistics equal within
    BN_RTOL, BN_ATOL, and every parameter and buffer within REMAT_ATOL."""
    tables = synthetic_video_tables(REMAT_FRAMES, REMAT_ROWS, IMAGE_SIZE, seed=SEED)
    dds = DeviceDataset(tables, 256, seed=SEED)
    runs, params, trunk_moved = {}, {}, {}
    rn.LAUNCHES.clear()
    for remat in (False, True):
        config = experiment(tmp / f"remat_{remat}", **TRAIN_CUTS, TPU={"REMAT": remat})
        gc_cuda()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        state = dqn.create_train_state(config)
        if state.model.remat != remat:
            raise AssertionError(f"REMAT {remat}: the model's remat is {state.model.remat}")
        step_fn = dqn.make_train_step(state.model, config)
        init = {k: v.detach().cpu().clone() for k, v in state.model.named_parameters()}
        losses = []
        for k in range(REMAT_STEPS):
            if k == REMAT_STEPS - REMAT_TIMED:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
            losses.append(step_fn(state, dds.sample(k))["loss"])
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) / REMAT_TIMED * 1e3
        runs[remat] = {"losses": [float(x) for x in losses], "ms_per_step": ms,
                       "peak_gib": (torch.cuda.max_memory_allocated() - base) / 2 ** 30}
        params[remat] = {k: v.detach().cpu() for k, v in state.model.named_parameters()}
        trunk_moved[remat] = max(float((params[remat][k] - init[k]).abs().max())
                                 for k in init if k.startswith("resnet."))
        del state, step_fn, losses, init
    launches = dict(rn.LAUNCHES)
    off, on = runs[False], runs[True]
    worst = max(abs(a - b) - (BF16_LOSS_RTOL * abs(b) + BF16_LOSS_ATOL)
                for a, b in zip(on["losses"], off["losses"]))
    diff = [abs(a - b) for a, b in zip(on["losses"], off["losses"])]
    param_diff = max(float((params[True][k] - params[False][k]).abs().max())
                     for k in params[False])
    if launches != {("identity", "bfloat16"): 4 * REMAT_STEPS} or worst > 0 or \
            not np.all(np.isfinite(on["losses"])) or max(diff) > REMAT_ATOL or \
            params[True].keys() != params[False].keys() or param_diff > REMAT_ATOL or \
            not trunk_moved[True] > 0:
        raise AssertionError(f"REMAT: launches {launches}, losses on {on['losses']} vs off "
                             f"{off['losses']}, parameters differ by {param_diff}, the trunk "
                             f"moved {trunk_moved}")
    log(f"[rest] REMAT, published config (B = 256, bf16), {REMAT_STEPS} steps each: off "
        f"{off['ms_per_step']:.4f} ms/step, peak {off['peak_gib']:.3f} GiB; on "
        f"{on['ms_per_step']:.4f} ms/step, peak {on['peak_gib']:.3f} GiB (peak over the state "
        f"and the steps, less what was allocated before); memory x"
        f"{on['peak_gib'] / off['peak_gib']:.3f}, time x{on['ms_per_step'] / off['ms_per_step']:.3f};"
        f" loss |on - off| max {max(diff):.3g} (limit {REMAT_ATOL}, and phase 5's bf16 rule); "
        f"parameters after {REMAT_STEPS} steps |on - off| max {param_diff:.3g} (limit "
        f"{REMAT_ATOL}); the trunk moved up to {trunk_moved[True]:.3g} from its init with "
        f"REMAT on; launches {launches}")

    stats, nets = {}, {}
    with no_tf32(), cudnn_deterministic():
        for remat in (False, True):
            config = experiment(tmp / f"basic_{remat}", **TRAIN_CUTS, ARCHITECTURE="basic",
                                TPU={"REMAT": remat, "COMPUTE_DTYPE": "float32",
                                     "BATCH_SIZE": BASIC_BATCH})
            state = dqn.create_train_state(config)
            step_fn = dqn.make_train_step(state.model, config)
            small = DeviceDataset(tables, BASIC_BATCH, seed=SEED)
            with plain_prologue():
                for k in range(BASIC_STEPS):
                    step_fn(state, small.sample(k))
            nets[remat] = {k: v.detach().clone() for k, v in state.model.state_dict().items()}
            stats[remat] = {k: v for k, v in nets[remat].items()
                            if "running" in k or "num_batches" in k}
            del state, step_fn
    worst_bn = max(float(((stats[True][k].double() - stats[False][k].double()).abs()
                          - BN_ATOL - BN_RTOL * stats[False][k].double().abs()).max())
                   for k in stats[False])
    moved = float((stats[True]["resnet.bn1.running_mean"].abs()).sum())
    basic_diff = max(float((nets[True][k].double() - nets[False][k].double()).abs().max())
                     for k in nets[False])
    if stats[True].keys() != stats[False].keys() or worst_bn > 0 or not moved > 0 or \
            nets[True].keys() != nets[False].keys() or basic_diff > REMAT_ATOL:
        raise AssertionError(f"basic REMAT: running statistics beyond {BN_RTOL}/{BN_ATOL} by "
                             f"{worst_bn}, or unmoved ({moved}); parameters and buffers "
                             f"|on - off| {basic_diff}")
    log(f"[rest] basic, {BASIC_STEPS} float32 steps at B = {BASIC_BATCH}, deterministic cuDNN, "
        f"REMAT on vs off: {len(stats[False])} BatchNorm buffers equal within rtol {BN_RTOL}, "
        f"atol {BN_ATOL} (worst margin {worst_bn:.3g}); statistics moved once a step; every "
        f"parameter and buffer |on - off| max {basic_diff:.3g} (limit {REMAT_ATOL})")
    return {"off": off, "on": on, "loss_abs_diff": diff, "param_abs_diff": param_diff,
            "trunk_moved": trunk_moved[True], "basic_bn_margin": worst_bn,
            "basic_abs_diff": basic_diff,
            "launches": {"identity": launches[("identity", "bfloat16")], "banded": 0}}


class cudnn_deterministic:
    """cuDNN's deterministic algorithms only, so that two runs of the same
    float32 steps can be held to each other near 0."""

    def __enter__(self):
        self.saved = torch.backends.cudnn.deterministic
        torch.backends.cudnn.deterministic = True

    def __exit__(self, *exc):
        torch.backends.cudnn.deterministic = self.saved


def gc_cuda() -> None:
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


def worker_runs(tmp: Path, runner: WorkerRunner) -> dict:
    """Phase 15 (c): the training CLI on wide.feather, host-fed, published
    config, 30 steps without checkpoints, with DECODE_WORKERS 4 (in
    `runner`'s process, WORKER_RUNNER) and 0 (here): ms/step over steps
    11-30 of each; the worker run's batch labels equal to the rows
    np.random.default_rng(SEED) draws, no worker or child alive after it,
    two identity launches a step; the worker process's start-up."""
    torch_qdata.link_wide_frames()
    steps = TRAIN_CUTS["NUM_STEPS"]
    out = {}
    for workers in (WORKERS, 0):
        folder = write_experiment(tmp / f"workers_{workers}",
                                  **{**TRAIN_CUTS, "CHECKPOINT_INTERVAL": 10 ** 6},
                                  DATASET=torch_qdata.WIDE_FEATHER,
                                  TPU={"DEVICE_DATASET": False, "DECODE_WORKERS": workers})
        t0 = time.perf_counter()
        if workers:
            seen = runner.run(folder)
            if seen["batches"] < steps or not seen["labels_equal"] or seen["alive_workers"] or \
                    seen["children"] or seen["workers"] != WORKERS or seen["seed"] != SEED or \
                    seen["launches"] != {"identity/bfloat16": 2 * steps}:
                raise AssertionError(f"decode workers: {seen}")
            launches = seen["launches"]["identity/bfloat16"]
        else:
            rn.LAUNCHES.clear()
            with contextlib.redirect_stdout(io.StringIO()):
                train_q_network.main([folder, "--log-every", str(TRAIN_LOG_EVERY)],
                                     device=ONE_CARD)
            launches = rn.LAUNCHES[("identity", "bfloat16")]
            if dict(rn.LAUNCHES) != {("identity", "bfloat16"): 2 * steps}:
                raise AssertionError(f"0 decode workers: launches {dict(rn.LAUNCHES)}")
            seen = {}
        wall = time.perf_counter() - t0
        rate = steady_rate(ExperimentConfig(folder, resume=True))
        out[workers] = {**rate, **seen, "wall_s": wall, "launches": launches}
        log(f"[rest] training CLI on wide.feather, host-fed, DECODE_WORKERS {workers}: "
            f"{rate['ms_per_step']:.4f} ms/step over steps 11-{steps} "
            f"({rate['frames_per_s']:.1f} frames/s), {wall:.2f} s with start-up"
            + (f" (its process: imports {seen['import_s']:.2f} s ahead of the run; folder "
               f"handed over to the first batch {seen['go_to_first_batch_s']:.2f} s, batches "
               f"1-11 {seen['first_batches_s']:.2f} s, after the last batch "
               f"{seen['after_last_batch_s']:.2f} s); {seen['batches']} batches drawn, their "
               f"labels equal the rows default_rng({SEED}) draws; workers alive after it "
               f"{seen['alive_workers']}, children {seen['children']}" if workers else ""))
    ratio = out[WORKERS]["ms_per_step"] / out[0]["ms_per_step"]
    log(f"[rest] {WORKERS} decode workers vs 0: x{ratio:.3f} ms/step")
    return {"ms_per_step": {w: out[w]["ms_per_step"] for w in out}, "ratio": ratio,
            "runs": out,
            "launches": {"identity": sum(out[w]["launches"] for w in out), "banded": 0}}


def synthetic_run(tmp: Path) -> dict:
    """Phase 15 (d): make_synthetic_dataset at its defaults, then the
    training CLI for SYNTH_STEPS steps on it (published config, bf16,
    host-fed, B = SYNTH_BATCH): finite losses, two identity launches a
    step."""
    t0 = time.perf_counter()
    feather = make_synthetic_dataset(str(tmp / "synthetic"))
    made_s = time.perf_counter() - t0
    rows = len(read_feather(feather)["before_image"])
    folder = write_experiment(tmp / "synthetic_q", **{**TRAIN_CUTS, "NUM_STEPS": SYNTH_STEPS,
                                                     "CHECKPOINT_INTERVAL": SYNTH_STEPS},
                              DATASET=feather, TPU={"BATCH_SIZE": SYNTH_BATCH, "DEVICE_DATASET": False})
    rn.LAUNCHES.clear()
    with contextlib.redirect_stdout(io.StringIO()):
        train_q_network.main([folder, "--log-every", "5"], device=ONE_CARD)
    launches = dict(rn.LAUNCHES)
    losses = [r["value"] for r in read_metrics(ExperimentConfig(folder, resume=True).run_dir,
                                               "avg_q_loss/train")]
    if len(losses) != SYNTH_STEPS // 5 or not np.all(np.isfinite(losses)) or \
            launches != {("identity", "bfloat16"): 2 * SYNTH_STEPS}:
        raise AssertionError(f"synthetic dataset: losses {losses}, launches {launches}")
    log(f"[rest] make_synthetic_dataset (defaults: {rows} rows) in {made_s:.3f} s, then the "
        f"training CLI {SYNTH_STEPS} steps at B = {SYNTH_BATCH}: EMA losses {losses}; "
        f"launches {launches}")
    return {"rows": rows, "made_s": made_s, "losses": losses,
            "launches": {"identity": launches[("identity", "bfloat16")], "banded": 0}}


def rest_path() -> dict:
    """Phase 15: (a) captions, (b) REMAT, (c) decode workers, (d) the
    synthetic dataset. launches sums the main-path runs, each counted
    from 0 (the worker run's in its own process, started first so that
    its imports overlap (a); (b) waits for them)."""
    t0 = time.perf_counter()
    _build.BUILD_DIR.mkdir(exist_ok=True)
    runner = WorkerRunner()
    try:
        with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as tmp_name:
            tmp = Path(tmp_name)
            ckpt = tmp / "qnet.torch"
            seeded_checkpoint(ckpt, published_config())
            parts, seconds = {}, {}
            for name, fn, args in (("captions", caption_check, (tmp, ckpt)),
                                   ("remat", remat_runs, (tmp,)),
                                   ("workers", worker_runs, (tmp, runner)),
                                   ("synthetic", synthetic_run, (tmp,))):
                if name == "remat":
                    runner.wait_ready()  # its imports stay out of the REMAT times
                t1 = time.perf_counter()
                parts[name] = fn(*args)
                seconds[name] = time.perf_counter() - t1
    finally:
        runner.close()
    out = {**parts, "launches": {p: sum(r["launches"][p] for r in parts.values())
                                 for p in ("identity", "banded")}, "part_seconds": seconds}
    out["seconds"] = time.perf_counter() - t0
    log(f"[rest] phase 15 in {out['seconds']:.1f} s (parts: "
        f"{', '.join(f'{k} {v:.1f} s' for k, v in seconds.items())}); launches {out['launches']}")
    return out


# ---------------------------------------------------------------- phase 16
# The fleet path on the card: the training CLI's fleet flags over NCCL. The
# card's machine has one H100, so the group has one rank: the collectives,
# the process group and the CLI run on the card, and the semantics across
# ranks are held on the CPU (tests/test_torch_parallel*.py).
PARALLEL_PROFILED_STEP = 5   # the profiled step, inside the first log window (not timed)
# the fleet run's per-step loss against phase 5's device-mode run: within
# this many times the largest spread of phase 5's two plain runs of the
# same config and seed (its timing run and its counted run), plus this
# share of the loss
PARALLEL_SPREAD_FACTOR, PARALLEL_LOSS_RTOL = 2.0, 1e-5
PARALLEL_BASIC_BATCH, PARALLEL_BASIC_STEPS = 32, 2
# (c)'s learning rate: Adam's first step moves a parameter by +-lr whatever
# its gradient's size, so where two runs' reductions differ in order a
# gradient below float32 noise moves it 2 lr apart, and the second forward's
# statistics part by ~1e-4 at the published 1e-4 (seen on the CPU at 96 px).
# At 1e-7 both second forwards see the same parameters up to rounding and
# the statistics compare the BatchNorm paths alone.
PARALLEL_BASIC_LR = 1e-7


def profiled(fn, path: Path, *args) -> tuple:
    """fn(*args) under torch.profiler, the card synchronized on both sides;
    (its result, the chrome trace's events, exported to `path` and read
    back)."""
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        out = fn(*args)
        torch.cuda.synchronize()
    prof.export_chrome_trace(str(path))
    return out, json.loads(path.read_text())["traceEvents"]


class FleetSpy:
    """Inside the CLI's run: each step's loss, the identity launches of
    every step, and torch.profiler traces of step PARALLEL_PROFILED_STEP
    and of the checkpoint's gather (flax_state_dict), read back by name
    and category."""

    def __init__(self, trace_path: Path):
        self.trace_path = trace_path

    def __enter__(self):
        self.losses, self.steps, self.trace, self.tree_trace = [], [], None, None
        self._saved = dqn.make_train_step, dqn.flax_state_dict
        make, tree_fn = self._saved

        def make_spied(model, config):
            step_fn = make(model, config)

            def spied(state, batch, mark=None):
                before = rn.LAUNCHES.copy()
                if len(self.losses) + 1 == PARALLEL_PROFILED_STEP:
                    out, self.trace = profiled(step_fn, self.trace_path, state, batch, mark)
                else:
                    out = step_fn(state, batch, mark)
                self.steps.append(dict(rn.LAUNCHES - before))
                self.losses.append(out["loss"])
                return out
            return spied

        def tree_spied(state):
            out, self.tree_trace = profiled(
                tree_fn, self.trace_path.with_name("fleet_checkpoint.json"), state)
            return out

        dqn.make_train_step, dqn.flax_state_dict = make_spied, tree_spied
        return self

    def __exit__(self, *exc):
        dqn.make_train_step, dqn.flax_state_dict = self._saved


class table_batcher:
    """The CLI's data source: `tables` for the config's DATASET."""

    def __init__(self, tables):
        self.tables = tables

    def __enter__(self):
        self.saved = dqn.batcher_from_config
        dqn.batcher_from_config = lambda config: TableSource(self.tables, seed=SEED)

    def __exit__(self, *exc):
        dqn.batcher_from_config = self.saved


def fleet_cli(folder: str, *flags: str):
    """The training CLI in its fleet form: one process of the fleet, its
    one rank on the card, NCCL over a free localhost port. The launcher
    leaves the process group when the run ends."""
    args = ["--coordinator", f"127.0.0.1:{multihost.free_port()}", "--num-processes", "1",
            "--process-id", "0", "--multihost-platform", "native", folder, *flags]
    out = train_q_network.main(args, device=ONE_CARD)
    if torch.distributed.is_initialized():
        raise AssertionError("the fleet run left its process group up")
    return out


def nccl_events(trace: list) -> dict:
    """A profile's collectives, from its chrome trace: the host's
    ProcessGroupNCCL ops (`nccl:<collective>`), the device-side ranges it
    records around the work a collective enqueues on the card, and that
    work: the kernels and copies on a range's stream inside its span (at
    one rank NCCL's own kernel is `oneRankReduce` and a gather is a copy,
    so no name test finds them)."""
    spans = [e for e in trace if e.get("ph") == "X"]

    def named(e):
        return str(e.get("name", "")).startswith("nccl")

    ranges = [e for e in spans if named(e) and e.get("cat") == "gpu_user_annotation"]
    work = [e for e in spans if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset") and
            any(e.get("pid") == r.get("pid") and e.get("tid") == r.get("tid") and
                r["ts"] - 1 <= e["ts"] and e["ts"] + e.get("dur", 0) <= r["ts"] + r["dur"] + 1
                for r in ranges)]
    return {"host_nccl_ops": sum(1 for e in spans if named(e) and e.get("cat") in
                                 ("cpu_op", "user_annotation")),
            "device_nccl_ranges": len(ranges),
            "device_nccl_work": len(work),
            "device_nccl_work_names": sorted({str(e["name"])[:60] for e in work}),
            "kernels": sum(1 for e in spans if e.get("cat") == "kernel"),
            "names": sorted({e["name"] for e in spans if named(e)})}


def fleet_run(tmp: Path, tables, phase5: dict) -> dict:
    """Phase 16 (a) and (b): the published config (B = 256, bf16) with
    TPU.MESH_DATA -1 and TPU.SHARD_DATASET true, 30 steps on phase 5's
    synthetic tables through the device table, a checkpoint at step 30,
    through the CLI's fleet form. Each step's loss against phase 5's
    device-mode run within the spread of phase 5's own two runs; two
    identity launches a step; the checkpoint written once, loaded into a
    plain TrainState equal to the run's; the profiled step's NCCL
    collectives (the step's in-place sum enqueues nothing on the card at
    one rank) and the checkpoint gather's, which must run on the card;
    ms/step over steps 11-30 against phase 5's."""
    steps = TRAIN_CUTS["NUM_STEPS"]
    folder = write_experiment(tmp / "fleet", **{**TRAIN_CUTS, "CHECKPOINT_INTERVAL": steps},
                              TPU={"DEVICE_DATASET": True, "SHARD_DATASET": True,
                                   "MESH_DATA": -1})
    rn.LAUNCHES.clear()
    t0 = time.perf_counter()
    with FleetSpy(tmp / "fleet_step.json") as spy, table_batcher(tables), \
            contextlib.redirect_stdout(io.StringIO()) as said:
        state, _ = fleet_cli(folder, "--log-every", str(TRAIN_LOG_EVERY))
    wall = time.perf_counter() - t0
    config = ExperimentConfig(folder, resume=True)
    rate = steady_rate(config)
    fleet = torch.stack(spy.losses).tolist()
    plain_a, plain_b = phase5["timing_step_losses"], phase5["step_losses"]
    spread = max(abs(a - b) for a, b in zip(plain_a, plain_b))
    worst = max(abs(f - b) - (PARALLEL_SPREAD_FACTOR * spread + PARALLEL_LOSS_RTOL * abs(b))
                for f, b in zip(fleet, plain_b))
    diff = max(abs(f - b) for f, b in zip(fleet, plain_b))
    names = sorted(os.listdir(config.models_dir))
    plain = dqn.create_train_state(config)
    dqn.load_flax_state_dict(plain, restore_checkpoint(config.models_dir, steps))
    loaded = all(torch.equal(a, b) for a, b in zip(plain.model.state_dict().values(),
                                                  state.model.state_dict().values()))
    want = {("identity", "bfloat16"): 2}
    nccl = nccl_events(spy.trace or [])
    gather = nccl_events(spy.tree_trace or [])
    mesh_line = [line for line in said.getvalue().splitlines() if "Device dataset" in line]
    log(f"[parallel] (a) the training CLI's fleet form (--coordinator 127.0.0.1:<port> "
        f"--num-processes 1 --process-id 0 --multihost-platform native), NCCL world size "
        f"{state.mesh.size}, mesh {state.mesh.data}x{state.mesh.model}; {mesh_line}; {steps} "
        f"steps in {wall:.2f} s; loss against phase 5's device-mode run: largest |diff| "
        f"{diff:.3g}; phase 5's two plain runs' spread {spread:.3g}; limit "
        f"{PARALLEL_SPREAD_FACTOR} x spread + {PARALLEL_LOSS_RTOL} x |loss| (worst margin "
        f"{worst:.3g}); checkpoints {names}, sample{steps} loads into a plain TrainState "
        f"{'equal to' if loaded else 'UNLIKE'} the run's")
    log(f"[parallel] (b) step {PARALLEL_PROFILED_STEP}, profiled: host NCCL ops "
        f"{nccl['host_nccl_ops']} ({nccl['names']}), device-side nccl ranges "
        f"{nccl['device_nccl_ranges']}, work in them {nccl['device_nccl_work']} (an in-place "
        f"sum over one rank enqueues nothing on the card), {nccl['kernels']} kernels; the "
        f"checkpoint's gather at step {steps}, profiled: host NCCL ops "
        f"{gather['host_nccl_ops']}, device-side nccl ranges {gather['device_nccl_ranges']} "
        f"({gather['names']}), kernels and copies in them {gather['device_nccl_work']} "
        f"({gather['device_nccl_work_names']}); fleet {rate['ms_per_step']:.4f} ms/step over "
        f"steps 11-30 against phase 5's {phase5['ms_per_step']:.4f} "
        f"(x{rate['ms_per_step'] / phase5['ms_per_step']:.4f})")
    if len(fleet) != steps or worst > 0 or not np.all(np.isfinite(fleet)) or \
            any(d != want for d in spy.steps) or names != [f"sample{steps}.ckpt"] or \
            not loaded or spy.trace is None or nccl["host_nccl_ops"] < 1 or \
            gather["device_nccl_ranges"] < 1 or gather["device_nccl_work"] < 1 or \
            state.mesh.data_group is None:
        raise AssertionError(f"fleet run: losses {fleet} vs {plain_b} (spread {spread}), "
                             f"launches {spy.steps}, checkpoints {names}, loaded {loaded}, "
                             f"NCCL {nccl}, the gather's {gather}, mesh {state.mesh}")
    return {"steps": steps, "wall_s": wall, "ms_per_step": rate["ms_per_step"],
            "frames_per_s": rate["frames_per_s"], "plain_ms_per_step": phase5["ms_per_step"],
            "loss_max_abs_diff": diff, "plain_spread": spread, "nccl": nccl,
            "checkpoint_nccl": gather,
            "world_size": state.mesh.size, "identity": 2 * steps}


def fleet_basic(tmp: Path, tables) -> dict:
    """Phase 16 (c): the basic arch, float32, B = 32, 2 steps, deterministic
    cuDNN without TF32, through the CLI's fleet form (its BatchNorm's
    all-reduce over a data group of one) and plainly: the running
    statistics within BN_RTOL, BN_ATOL of each other."""
    runs = {}
    with no_tf32(), cudnn_deterministic(), table_batcher(tables), \
            contextlib.redirect_stdout(io.StringIO()):
        for fleet in (True, False):
            folder = write_experiment(
                tmp / f"basic_{'fleet' if fleet else 'plain'}",
                **{**TRAIN_CUTS, "NUM_STEPS": PARALLEL_BASIC_STEPS, "CHECKPOINT_INTERVAL": 10 ** 6},
                ARCHITECTURE="basic", LEARNING_RATE=PARALLEL_BASIC_LR,
                TPU={"DEVICE_DATASET": True, "COMPUTE_DTYPE": "float32",
                     "BATCH_SIZE": PARALLEL_BASIC_BATCH})
            rn.LAUNCHES.clear()
            args = [folder, "--log-every", "1"]
            state, _ = fleet_cli(*args) if fleet else train_q_network.main(args,
                                                                           device=ONE_CARD)
            synced = [m.sync is not None for m in state.model.modules()
                      if isinstance(m, BatchNorm2d)]
            runs[fleet] = ({k: v.detach().clone() for k, v in state.model.state_dict().items()
                            if "running" in k}, dict(rn.LAUNCHES), synced)
            del state
    stats = {f: r[0] for f, r in runs.items()}
    worst = max(float(((stats[True][k].double() - stats[False][k].double()).abs()
                       - BN_ATOL - BN_RTOL * stats[False][k].double().abs()).max())
                for k in stats[False])
    moved = float(stats[True]["resnet.bn1.running_mean"].abs().sum())
    log(f"[parallel] (c) basic, float32, B = {PARALLEL_BASIC_BATCH}, {PARALLEL_BASIC_STEPS} "
        f"steps: the fleet form's BatchNorm synced over a data group of 1 in "
        f"{sum(runs[True][2])} of {len(runs[True][2])} layers; its {len(stats[True])} running "
        f"statistics against the plain CLI's: worst margin {worst:.3g} (rtol {BN_RTOL}, atol "
        f"{BN_ATOL}); launches {runs[True][1]}")
    if not all(runs[True][2]) or any(runs[False][2]) or worst > 0 or not moved > 0 or \
            stats[True].keys() != stats[False].keys():
        raise AssertionError(f"basic fleet: synced {runs[True][2]} / plain {runs[False][2]}, "
                             f"statistics beyond the rule by {worst}, moved {moved}")
    return {"bn_margin": worst,
            "launches": {f"{path}/{dtype}": n for (path, dtype), n in runs[True][1].items()},
            "identity": sum(n for (path, _), n in runs[True][1].items() if path == "identity")}


# phase 16 (d)'s inverse fleet: the CLI at 224 px and B = INV_BATCH, bf16,
# against one card of the same flags. The bf16 step rounds another way on
# each rank's rows; so does a float32 run on one card. Each scalar within
# 5% + 1e-3 of one card's, or within twice the float32 run's largest
# distance from one card's over the scalars of its kind (losses,
# accuracies), as tools/fleet_cards.py bounds the Q-net's fleet, where
# that is wider: 12 steps leave the 3 actions' logits near a tie, and
# bf16's rounding flips predictions (on 4 cards 19 of 256 at step 12,
# where the losses stayed within 5%)
INV_FLEET_STEPS, INV_FLEET_EVERY, INV_FLEET_VAL = 12, 6, 2
INV_FLEET_RTOL, INV_FLEET_ATOL, INV_FLEET_SPREAD = 0.05, 1e-3, 2.0
# the CLI with no device, in a process of its own (its ranks print to its
# standard output, which the phase reads)
INVERSE_FLEET = """
import json, sys
from video_dqn_tpu_torch import train_inverse_model
if train_inverse_model.main(json.loads(sys.argv[1]), validate_every=int(sys.argv[2]),
                            val_batches=int(sys.argv[3])) is not None:
    raise SystemExit("the inverse CLI ran one rank on a machine of several cards")
"""


def inverse_fleet(tmp: Path) -> dict:
    """Phase 16 (d), with two cards or more: the inverse CLI with no device
    spawns one NCCL rank a card; its scalars and final accuracy against a
    one-card run of the same flags, within INV_FLEET_RTOL and
    INV_FLEET_ATOL or INV_FLEET_SPREAD times a float32 one-card run's
    largest distance over its kind; each scalar logged once, the
    checkpoints of the cadence, one final line."""
    n = torch.cuda.device_count()
    npy, root = torch_qdata.make_pairs(tmp / "inv_fleet_pairs", rows=INV_PAIRS,
                                       states=INV_STATES, seed=SEED)

    def flags(out: Path) -> list:
        return ["--train_data", npy, "--val_data", npy, "--image_root", root, "--image_size",
                str(IMAGE_SIZE), "--batch_size", str(INV_BATCH), "--num_steps",
                str(INV_FLEET_STEPS), "--lr", str(INV_LR), "--seed", str(SEED), "--out_dir",
                str(out), "--cache-images"]

    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", INVERSE_FLEET, json.dumps(flags(tmp / "inv_n")),
                           str(INV_FLEET_EVERY), str(INV_FLEET_VAL)], cwd=ROOT,
                          capture_output=True, text=True, timeout=600)
    fleet_s = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"the inverse CLI's fleet failed:\n{proc.stdout[-3000:]}"
                             f"{proc.stderr[-6000:]}")
    finals = [line for line in proc.stdout.splitlines()
              if line.startswith("Final val accuracy: ")]
    accuracy, one_s = {}, 0.0
    for run, dtype in (("inv_1", torch.bfloat16), ("inv_f32", torch.float32)):
        t0 = time.perf_counter()
        saved, train_inverse_model.COMPUTE_DTYPE = train_inverse_model.COMPUTE_DTYPE, dtype
        try:
            with contextlib.redirect_stdout(io.StringIO()):
                _, accuracy[run] = train_inverse_model.main(
                    flags(tmp / run), device=ONE_CARD, validate_every=INV_FLEET_EVERY,
                    val_batches=INV_FLEET_VAL)
        finally:
            train_inverse_model.COMPUTE_DTYPE = saved
        one_s = one_s or time.perf_counter() - t0
    if len(finals) != 1:
        raise AssertionError(f"the inverse fleet printed {len(finals)} final lines")
    # (fleet, one card, float32 one card) of each scalar; the final line's
    # accuracy has 4 decimals
    rows = {"final": ([float(finals[0].split()[-1])], [accuracy["inv_1"]],
                      [accuracy["inv_f32"]])}
    steps = list(range(INV_FLEET_EVERY, INV_FLEET_STEPS + 1, INV_FLEET_EVERY))
    for tag in ("Loss/train", "Loss/val", "Accuracy/train", "Accuracy/val"):
        runs = [read_metrics(str(tmp / run), tag) for run in ("inv_n", "inv_1", "inv_f32")]
        if any([r["step"] for r in got] != steps for got in runs):
            raise AssertionError(f"inverse fleet {tag}: fleet, one card, float32 {runs}")
        rows[tag] = tuple([r["value"] for r in got] for got in runs)
    spread = {kind: max(abs(c - b) for k, (_, one, f32) in rows.items()
                        if k.startswith("Loss") == (kind == "loss") for b, c in zip(one, f32))
              for kind in ("loss", "accuracy")}
    bad = {k: v for k, v in rows.items() if any(
        abs(a - b) > max(INV_FLEET_RTOL * abs(b) + INV_FLEET_ATOL,
                         INV_FLEET_SPREAD * spread["loss" if k.startswith("Loss") else "accuracy"])
        for a, b in zip(v[0], v[1]))}
    names = sorted(p.name for p in (tmp / "inv_n").glob("sample*.ckpt"))
    want_names = sorted(f"sample{k}.ckpt" for k in steps)
    if bad or names != want_names:
        raise AssertionError(f"inverse fleet on {n} cards: beyond {INV_FLEET_RTOL:.0%} + "
                             f"{INV_FLEET_ATOL} and {INV_FLEET_SPREAD} x the float32 run's "
                             f"distance {spread} of one card's {list(bad)}, or checkpoints "
                             f"{names}; (fleet, one card, float32) {json.dumps(rows)}")
    log(f"[parallel] (d) the inverse CLI on {n} cards (one NCCL rank a card, spawned) against "
        f"one card, {INV_FLEET_STEPS} steps at B = {INV_BATCH}, {IMAGE_SIZE} px, bf16: "
        f"(fleet, one card, one card float32) {json.dumps(rows)}, the float32 run's largest "
        f"distances {spread}; checkpoints {names}, one final line; {fleet_s:.1f} s (its "
        f"processes' start-up included) and {one_s:.1f} s")
    return {"cards": n, "scalars": rows, "spread": spread, "fleet_s": fleet_s,
            "one_card_s": one_s}


def multi_card(tmp: Path) -> dict:
    """Phase 16 (d), with two cards or more only: the training CLI without
    --coordinator spawns one rank a card, N x 1 and (N/2) x 2, against one
    card on the committed fixture's data.feather
    (video_dqn_tpu_torch/tools/fleet_cards.py: each step's loss and the
    step-30 update within twice the distance of a float32 one-card run from
    the bf16 one, ms/step of each); then the inverse CLI's fleet
    (inverse_fleet)."""
    n = torch.cuda.device_count()
    if n < 2:
        log(f"[parallel] (d) not run: {n} card on this machine; the N x 1 and (N/2) x 2 "
            "fleets of the training CLI and the inverse CLI's fleet need two cards or more")
        return {"run": False, "cards": n}
    with contextlib.redirect_stdout(io.StringIO()) as said:
        out = fleet_cards.compare(tmp / "cards", torch_qdata.FEATHER)
    for line in said.getvalue().splitlines():
        if line.startswith("[fleet]"):
            log(f"[parallel] (d) {line}")
    return {"run": True, **out, "inverse": inverse_fleet(tmp)}


def parallel_path(phase5: dict) -> dict:
    """Phase 16: the training CLI's fleet form over NCCL on the card, (a)
    the published config against phase 5, (b) its NCCL collectives and
    ms/step, (c) basic's synced BatchNorm, (d) more cards where there are
    any. launches: the identity launches of (a) and of (c)'s fleet run."""
    t0 = time.perf_counter()
    tables = synthetic_video_tables(TRAIN_FRAMES, TRAIN_ROWS, IMAGE_SIZE, seed=SEED)
    _build.BUILD_DIR.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as tmp_name:
        tmp = Path(tmp_name)
        out = {"fleet": fleet_run(tmp, tables, phase5["modes"]["device_dataset"]),
               "basic": fleet_basic(tmp, tables)}
        del tables
        gc_cuda()
        out["multi_card"] = multi_card(tmp)
    out["launches"] = {"identity": out["fleet"]["identity"] + out["basic"]["identity"],
                       "banded": 0}
    out["seconds"] = time.perf_counter() - t0
    log(f"[parallel] phase 16 in {out['seconds']:.1f} s")
    return out


PHASES = ("serve", "train", "real_data", "inverse", "label", "eval", "eval_mesh", "detector",
          "frontend", "viz", "video", "rest", "parallel")


def counted_phase(fn, *args) -> tuple:
    """Runs one phase with the NMS and the two NV12 -> RGB counters at 0
    and returns its result and those counters over the whole phase: the
    launches of a phase whose main path runs none of those kernels (the
    phases that run one read its count on their main path themselves)."""
    det_boxes.LAUNCHES.clear()
    nv12_mod.LAUNCHES.clear()
    nv12_scale_mod.LAUNCHES.clear()
    out = fn(*args)
    return out, {"nms": det_boxes.LAUNCHES["nms"], "nv12_rgb": nv12_mod.LAUNCHES["nv12_rgb"],
                 "nv12_scale_rgb": nv12_scale_mod.LAUNCHES["nv12_scale_rgb"]}


def main() -> None:
    environment()
    build()
    rows = kernel_vs_plain()
    nms_rows = nms_vs_plain()
    res, whole = {}, {}
    res["serve"], whole["serve"] = counted_phase(serving_path)
    res["train"], whole["train"] = counted_phase(train_path)
    res["real_data"], whole["real_data"] = counted_phase(real_data_path)
    res["inverse"], whole["inverse"] = counted_phase(inverse_path)
    res["label"], whole["label"] = counted_phase(label_path, res["inverse"])
    res["inverse"].pop("tmp")
    res["eval"], whole["eval"] = counted_phase(eval_path)
    res["eval_mesh"], whole["eval_mesh"] = counted_phase(mesh_eval_path)
    res["detector"], whole["detector"] = counted_phase(detector_path)
    res["frontend"], whole["frontend"] = counted_phase(frontend_path)
    res["viz"], whole["viz"] = counted_phase(viz_path)
    res["video"], whole["video"] = counted_phase(video_path)
    res["rest"], whole["rest"] = counted_phase(rest_path)
    res["parallel"], whole["parallel"] = counted_phase(parallel_path, res["train"])
    # each phase's main-path launches: its own count where it reads one
    # (every phase the resize kernel's; the detector, the front end and
    # video the NMS's; video the two NV12 kernels'), else the whole phase's
    launches = {p: {**whole[p], **res[p]["launches"]} for p in PHASES}

    def per_phase(key: str) -> dict:
        got = {f"launches_{p}": launches[p][key] for p in PHASES}
        return {"launches": sum(got.values()), **got}

    kernels = []
    for path in ("identity", "banded"):
        mine = [r for r in rows if r["path"] == path]
        # the main path's call: the largest batch, in the bf16 it serves
        main_row = max((r for r in mine if r["dtype"] == "bfloat16"),
                       key=lambda r: r["shape"][0])
        kernels.append({
            "name": f"resize_normalize_{path}",
            "route": "cuda",
            "source": "video_dqn_tpu_torch/csrc/resize_normalize.cu",
            "replaces": "video_dqn_tpu/ops/pallas_image.py:86",
            **per_phase(path),
            "max_abs_err": max(r["max_abs_err"] for r in mine),
            "ms": main_row["ms"],
            "plain_ms": main_row["plain_ms"],
            "bound_ms": main_row["bound_ms"],
            "bound_by": main_row["bound_by"],
            "library_ms": None,
            "shapes": mine,
        })
    # the main path's call: the RPN's NMS of a 12-view stop
    main_row = next(r for r in nms_rows if r["case"] == f"rpn_b{max(DETECTOR_BATCHES)}")
    kernels.append({
        "name": "nms",
        "route": "cuda",
        "source": "video_dqn_tpu_torch/csrc/nms.cu",
        "replaces": "video_dqn_tpu/models/detector/boxes.py:115",
        **per_phase("nms"),
        # each counted launch is one nms_groups call: its mask and scan kernels
        "kernels_per_launch": len(NMS_KERNELS),
        "max_abs_err": 0.0,
        "ms": main_row["ms"],
        "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"],
        "bound_by": main_row["bound_by"],
        "library_ms": None,
        "shapes": nms_rows,
    })
    # the main path's call: a full batch of 16 720p frames of the -d CLI
    main_row = res["video"]["kernel"][0]
    kernels.append({
        "name": "nv12_rgb",
        "route": "cuda",
        "source": "video_dqn_tpu_torch/csrc/nv12_rgb.cu",
        "replaces": "native/decode/decode.cc:111 (emit: swscale yuv420p -> RGB24; not a TPU kernel)",
        **per_phase("nv12_rgb"),
        "max_abs_err": 0.0,
        "ms": main_row["ms"],
        "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"],
        "bound_by": main_row["bound_by"],
        "library_ms": None,
        "shapes": res["video"]["kernel"],
    })
    # the main path's call: decode_frames' one 720p frame to the Q-net's 224^2
    main_row = next(r for r in res["video"]["scale"]["rows"] if r["shape"][0] == 1)
    kernels.append({
        "name": "nv12_scale_rgb",
        "route": "cuda",
        "source": "video_dqn_tpu_torch/csrc/nv12_scale_rgb.cu",
        "replaces": "native/decode/decode.cc:111 (emit: swscale's scaled bilinear path to "
                    "RGB24; not a TPU kernel)",
        **per_phase("nv12_scale_rgb"),
        "max_abs_err": 0.0,
        "ms": main_row["ms"],
        "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"],
        "bound_by": main_row["bound_by"],
        "library_ms": None,
        "shapes": res["video"]["scale"]["rows"],
    })
    for p in PHASES:
        log(json.dumps({p: res[p]}))
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
