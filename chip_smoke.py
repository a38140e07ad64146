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
  5. a JSON line of every ported kernel, then the result line.
"""

from __future__ import annotations

import json
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


def main() -> None:
    environment()
    build()
    rows = kernel_vs_plain()
    serve = serving_path()
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
            "launches": serve["launches"][path],
            "max_abs_err": max(r["max_abs_err"] for r in mine),
            "ms": main_row["ms"],
            "plain_ms": main_row["plain_ms"],
            "bound_ms": main_row["bound_ms"],
            "bound_by": main_row["bound_by"],
            "library_ms": None,
            "shapes": mine,
        })
    log(json.dumps({"serve": serve}))
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
