#!/usr/bin/env python3
"""Smoke run of the PyTorch/H100 port (video_dqn_tpu_torch) on one card.

    python3 chip_smoke.py

Phases, each of which raises on failure (the run then exits non-zero and
prints no result line):
  1. environment: the card's name and power limit, torch and CUDA versions;
  2. build: nvcc compiles every kernel from the sources in the checkout;
  3. each kernel against its plain torch version on the card, at the
     shapes the serving path gives it, with its time and its bound;
  4. the serving path at full width: the published extra_capacity
     single-frame Q-net (configs/experiments/real_data/config.yml, 224 px,
     5 classes x 3 actions) with seeded random weights, loaded through
     load_eval_model from a .torch checkpoint, answers 12/24/48/96-view
     requests of 224x224 renders and 256x342 frames through the multiclass
     scorer's dispatch/gather with 2 requests in flight. Every request must
     go through the kernel, every answer must match a float32 card forward
     of its own views within 0.05, and the bf16 scores of the 12-view
     stops must track the port's own float32 CPU forward;
  5. a JSON line of every ported kernel, then the result line.
"""

from __future__ import annotations

import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import torch
import torch.nn.functional as F

from video_dqn_tpu_torch import _build
from video_dqn_tpu_torch.eval.load import load_eval_model
from video_dqn_tpu_torch.eval.scorer import make_multiclass_scorer
from video_dqn_tpu_torch.models.qnet import build_qnet, init_qnet
from video_dqn_tpu_torch.ops import resize_normalize as rn

SEED = 4
IMAGE_SIZE = 224
# H100 SXM data sheet: HBM rate and float32 rate outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12
KERNEL_ATOL = 1e-5
# bf16 card forward against the float32 CPU forward (tests/test_models.py
# test_qnet_bf16_matches_fp32_coarsely)
BF16_ATOL, BF16_RTOL = 0.15, 0.1
# every served score against a float32 card forward of the same views and
# weights through the plain resize twin: about 3x the bf16 gap measured
# at a 12-view stop (0.0142), and below the score gap between the rows
# of a request, so scores of the wrong rows or request fail it
SERVE_ATOL = 0.05
# (input shape, output side): the dataset's frames and the renders at the
# largest serving bucket (8 episodes x 12 views), and a 96 px stop
KERNEL_SHAPES = [((96, 256, 342, 3), 224), ((96, 224, 224, 3), 224),
                 ((12, 96, 96, 3), 96)]
REQUEST_VIEWS = (12, 24, 48, 96)
RENDERS = ((224, 224), (256, 342))
# published config plus the JAX package's defaults (core/defaults.py)
MODEL_CONFIG = SimpleNamespace(ARCHITECTURE="extra_capacity", PANORAMA=False,
                               PREVIOUS_IMAGES=False, VALUE_LEARNING=False,
                               ONE_ACTION=False)


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
    t0 = time.perf_counter()
    compiler_out = _build.build()
    seconds = time.perf_counter() - t0
    _build.load()
    for line in compiler_out.splitlines():
        if "ptxas" in line:
            log(f"  {line.strip()}")
    log(f"[build] {_build.LIB.name} in {seconds:.2f} s")


def band_flops(shape, out: int) -> int:
    """Floating-point operations of the banded resample + normalize."""
    b, h, w, _ = shape
    k_h = rn.band_table(rn.resize_matrix(h, out))[1].shape[1]
    k_w = rn.band_table(rn.resize_matrix(w, out))[1].shape[1]
    return b * out * out * 3 * (2 * k_h * k_w + 2 * k_h + 2)


def kernel_vs_plain() -> list[dict]:
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device="cuda").manual_seed(SEED)
    rows = []
    for shape, out in KERNEL_SHAPES:
        x = torch.randint(0, 256, shape, dtype=torch.uint8, device="cuda", generator=g)
        got = rn.resize_normalize(x, out)
        want = rn.resize_normalize_reference(x, out)
        torch.cuda.synchronize()
        if not got.is_contiguous(memory_format=torch.channels_last):
            raise AssertionError("kernel output is not NCHW channels_last")
        err = (got - want).abs().max().item()
        if not err <= KERNEL_ATOL:
            raise AssertionError(f"resize_normalize {shape}->{out}: max abs err "
                                 f"{err} > {KERNEL_ATOL}")
        ms = cuda_ms(lambda: rn.resize_normalize(x, out))
        plain_ms = cuda_ms(lambda: rn.resize_normalize_reference(x, out))
        xf = x.permute(0, 3, 1, 2).float()
        interp_ms = cuda_ms(lambda: F.interpolate(
            xf, size=(out, out), mode="bilinear", antialias=True))
        prof = device_profile(lambda: rn.resize_normalize(x, out), calls=20)
        kernel_us = [us for name, (_, us) in prof["by_name"].items()
                     if "resize_normalize" in name]
        device_ms = kernel_us[0] / 20 / 1e3 if kernel_us else None
        n_bytes = x.numel() + got.numel() * 4
        bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
        ops_ms = band_flops(shape, out) / FP32_FLOPS * 1e3
        row = {"shape": list(shape), "out": out, "max_abs_err": err, "ms": ms,
               "plain_ms": plain_ms, "bound_ms": max(bytes_ms, ops_ms),
               "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
               "bytes": n_bytes, "gb_per_s": n_bytes / ms / 1e6,
               "approx_interpolate_ms": interp_ms, "profiled_device_ms": device_ms}
        log(f"[kernel] resize_normalize {tuple(shape)}->{out}: err {err:.3g} "
            f"kernel {ms:.4f} ms plain {plain_ms:.4f} ms bound {row['bound_ms']:.4f} ms "
            f"({row['bound_by']}, {row['gb_per_s']:.1f} GB/s); approximate "
            f"yardstick only, F.interpolate(bilinear, antialias) on float NCHW "
            f"(other borders, no normalize): {interp_ms:.4f} ms; profiled kernel "
            f"device time {device_ms if device_ms is None else f'{device_ms:.4f}'} ms")
        rows.append(row)
    return rows


def seeded_checkpoint(path: Path) -> dict:
    """Seeded port init saved in the reference's .torch format, with the
    unused torchvision classifier the reference trunk carries."""
    g = torch.Generator().manual_seed(SEED)
    model = init_qnet(build_qnet(MODEL_CONFIG, IMAGE_SIZE, device="cpu"), g)
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


def serving_path() -> dict:
    _build.BUILD_DIR.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as tmp:
        ckpt = Path(tmp) / "qnet.torch"
        seeded_checkpoint(ckpt)
        t0 = time.perf_counter()
        model = load_eval_model(SimpleNamespace(PRETRAINED_MODEL_LOCATION=str(ckpt)),
                                MODEL_CONFIG, image_size=IMAGE_SIZE)
        cpu_model = load_eval_model(
            SimpleNamespace(PRETRAINED_MODEL_LOCATION=str(ckpt)), MODEL_CONFIG,
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
    rn.LAUNCHES = 0
    t0 = time.perf_counter()
    inflight, answers, steps = [], [], []
    for views, cls in requests:
        before = rn.LAUNCHES
        inflight.append((views, cls, scorer.dispatch(views, cls)))
        steps.append(rn.LAUNCHES - before)
        if len(inflight) == 2:
            v, c, h = inflight.pop(0)
            answers.append((v, c, scorer.gather(h)))
    while inflight:
        v, c, h = inflight.pop(0)
        answers.append((v, c, scorer.gather(h)))
    wall = time.perf_counter() - t0
    launches = rn.LAUNCHES
    log(f"[serve] {len(requests)} requests ({sum(len(v) for v, _ in requests)} views) "
        f"cold in {wall:.3f} s; kernel launches {launches}, per call {steps}")
    if launches != len(requests) or steps != [1] * len(requests):
        raise AssertionError(f"resize_normalize launched {launches} times for "
                             f"{len(requests)} scorer calls ({steps})")
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

    # bf16 card scores against the port's float32 CPU forward, one 12-view
    # stop per render size
    cpu_scorer = make_multiclass_scorer(cpu_model, image_size=IMAGE_SIZE, device="cpu")
    worst = 0.0
    for views, cls, scores in answers:
        if len(views) != 12:
            continue
        want = cpu_scorer(views, cls)
        np.testing.assert_allclose(scores, want, atol=BF16_ATOL, rtol=BF16_RTOL)
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
    profiles = {}
    for views, cls in (r for r in requests if len(r[0]) in (12, 96)):
        label = f"scorer call, {len(views)} views {views.shape[2]}x{views.shape[3]}"
        profiles[label] = device_profile(lambda: scorer(views, cls), calls=10)
        log_profile(label, profiles[label])
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
            "min_median_row_gap": row_gap,
            "device_busy_share": {k: v["busy_share"] for k, v in profiles.items()}}


def main() -> None:
    environment()
    build()
    rows = kernel_vs_plain()
    serve = serving_path()
    main_row = rows[0]
    kernels = [{
        "name": "resize_normalize",
        "route": "cuda",
        "source": "video_dqn_tpu_torch/csrc/resize_normalize.cu",
        "replaces": "video_dqn_tpu/ops/pallas_image.py:86",
        "launches": serve["launches"],
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        "ms": main_row["ms"],
        "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"],
        "bound_by": main_row["bound_by"],
        "library_ms": None,
        "shapes": rows,
    }]
    log(json.dumps({"serve": serve}))
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
