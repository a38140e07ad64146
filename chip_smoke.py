#!/usr/bin/env python3
"""Smoke run of the PyTorch/H100 port (video_dqn_tpu_torch) on one card.

    python3 chip_smoke.py

Phases, each of which raises on failure (the run then exits non-zero and
prints no result line):
  1. environment: the card's name and power limit, torch and CUDA versions;
  2. build: nvcc compiles every kernel from the sources in the checkout;
  3. each kernel against its plain torch version on the card, at the
     shapes the serving path gives it, in float32 and bfloat16 output, with
     its profiled device time, its bound and the wrapper's host cost;
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
  9. a JSON line of every ported kernel, then the result line.
"""

from __future__ import annotations

import contextlib
import copy
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

from video_dqn_tpu_torch import _build, process_episodes, train_inverse_model, train_q_network
from video_dqn_tpu_torch.core.checkpoint import restore_checkpoint
from video_dqn_tpu_torch.core.config import load_yaml
from video_dqn_tpu_torch.core.defaults import get_cfg_defaults
from video_dqn_tpu_torch.core.experiment import ExperimentConfig
from video_dqn_tpu_torch.core.metrics import read_metrics
from video_dqn_tpu_torch.data.device_dataset import DeviceDataset
from video_dqn_tpu_torch.data.episodes import make_inverse_labeler
from video_dqn_tpu_torch.data.feather import read_feather
from video_dqn_tpu_torch.data.gibson_pairs import GibsonPairBatcher
from video_dqn_tpu_torch.data.jpeg import decode_threads, load_images
from video_dqn_tpu_torch.data.qlearning import QLearningBatcher
from video_dqn_tpu_torch.data.tables import TableSource, synthetic_video_tables
from video_dqn_tpu_torch.eval.load import load_eval_model
from video_dqn_tpu_torch.eval.scorer import make_multiclass_scorer
from video_dqn_tpu_torch.models.bridge import flax_from_qnet_state_dict, layout
from video_dqn_tpu_torch.models.qnet import build_qnet, init_qnet
from video_dqn_tpu_torch.ops import resize_normalize as rn
from video_dqn_tpu_torch.train import dqn, inverse

sys.path.append(str(Path(__file__).resolve().parent / "tests"))
import torch_qdata  # noqa: E402  (the fixture of phase 6 and its oracle check)

SEED = 4
IMAGE_SIZE = 224
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


def kernel_device_ms(fn, calls: int = 20):
    """Profiled device time of the resize_normalize kernel per call of fn,
    or None where the profiler missed some of its launches twice (its
    first profiling run can drop events)."""
    for _ in range(2):
        prof = device_profile(fn, calls=calls)
        seen = [(n, us) for name, (n, us) in prof["by_name"].items()
                if "resize_normalize" in name]
        if sum(n for n, _ in seen) == calls:
            return sum(us for _, us in seen) / calls / 1e3
    return None


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
                   "ms_source": "profiler" if device_ms is not None else "events",
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


class TrainSpy:
    """Watches one run_train without changing it: the kernel launches of
    each step, the rows DeviceDataset draws for each step, and a copy of
    the online net's state dict at each target sync (taken before the
    sync, so it is the online net before that step's update)."""

    def __enter__(self):
        self.steps, self.rows, self.syncs = [], {}, []
        self._saved = dqn.make_train_step, dqn.sync_target, DeviceDataset.rows
        make, sync, rows = self._saved

        def make_spied(model, config):
            step_fn = make(model, config)

            def spied(state, batch, mark=None):
                before = rn.LAUNCHES.copy()
                out = step_fn(state, batch, mark)
                self.steps.append(dict(rn.LAUNCHES - before))
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
            "losses": losses}


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
                "peak_gib": m["peak_gib"], "ema_loss": m["ema_loss"], "logged": m["losses"]}
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
    train_q_network.main([timing, *every])
    rate = steady_rate(ExperimentConfig(timing, resume=True))

    folder = write_experiment(tmp / name, **cuts)
    torch.cuda.synchronize()
    rn.LAUNCHES.clear()
    t0 = time.perf_counter()
    with TrainSpy() as spy:
        state, loss = train_q_network.main([folder, *every])
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
                                         str(TRAIN_LOG_EVERY)])
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

        def make_spied(model, dtype=torch.bfloat16):
            step_fn = make(model, dtype)

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
                                 validate_every=10 ** 6, val_batches=0)
    ms = (timing.times[INV_STEPS] - timing.times[10]) / (INV_STEPS - 10) * 1e3

    out_dir = tmp / name
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    rn.LAUNCHES.clear()
    t0 = time.perf_counter()
    with InverseSpy() as spy:
        state, accuracy = train_inverse_model.main(
            inverse_flags(pairs, out_dir, cache), validate_every=INV_VALIDATE,
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
            "launches": {"identity": decoding["launches"].get(("identity", "bfloat16"), 0)
                         + cached["launches"].get(("identity", "bfloat16"), 0), "banded": 0},
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
    return {"launches": {"identity": launches + episode_launches, "banded": 0},
            "rows_per_s": len(before) / wall, "decode_s": timing["decode_s"],
            "device_s": timing["device_s"], "wall_s": wall,
            "bf16_rows_below_margin": int((margins(f32) < LABEL_BF16_MARGIN).sum()),
            "cpu_rows_below_margin": int((~wide_rows).sum()),
            "episode_rows": len(cols["before_image"]), "episodes_s": episodes_s}


def main() -> None:
    environment()
    build()
    rows = kernel_vs_plain()
    serve = serving_path()
    train = train_path()
    real = real_data_path()
    inv = inverse_path()
    label = label_path(inv)
    inv.pop("tmp")
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
            "launches": (serve["launches"][path] + train["launches"][path]
                         + real["launches"][path] + inv["launches"][path]
                         + label["launches"][path]),
            "launches_serve": serve["launches"][path],
            "launches_train": train["launches"][path],
            "launches_real_data": real["launches"][path],
            "launches_inverse": inv["launches"][path],
            "launches_label": label["launches"][path],
            "max_abs_err": max(r["max_abs_err"] for r in mine),
            "ms": main_row["ms"],
            "plain_ms": main_row["plain_ms"],
            "bound_ms": main_row["bound_ms"],
            "bound_by": main_row["bound_by"],
            "library_ms": None,
            "shapes": mine,
        })
    log(json.dumps({"serve": serve}))
    log(json.dumps({"train": train}))
    log(json.dumps({"real_data": real}))
    log(json.dumps({"inverse": inv}))
    log(json.dumps({"label": label}))
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
