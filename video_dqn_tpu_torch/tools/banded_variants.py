"""Times the banded resize+normalize kernel at other tile shapes: threads
per CTA (128, 256, 512) x output rows per tile (2, 4, 8, 16), at the
serving path's 96x256x342 -> 224, in float32 and bfloat16 output, on one
card. The kernel ships with 256 threads and 8 rows.

    python -m video_dqn_tpu_torch.tools.banded_variants [--rounds 7]

Each thread count is csrc/resize_normalize.cu with its `kBandThreads`
replaced, built by nvcc into a library of its own under _build/ (the
three builds run at once); the rows per tile go in the launch's argument
struct with the shared memory that `banded_smem_bytes` gives them. Every
variant is first held against the plain version at the card tests'
tolerance. Each round then times every variant in turn with CUDA events
over back-to-back launches, so that all see the same state of the card;
the script prints each variant's median and range over the rounds, and
the card's name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess

import numpy as np
import torch

from .. import _build
from ..ops import resize_normalize as rn

SHAPE, OUT = (96, 256, 342, 3), 224
THREADS = (128, 256, 512)
ROWS = (2, 4, 8, 16)
DTYPES = (torch.float32, torch.bfloat16)
ATOL, BF16_RTOL = 1e-5, 2.0 ** -8   # as tests/test_torch_cuda_kernels.py
THREADS_LINE = re.compile(r"constexpr int kBandThreads = \d+;")


def build_variants() -> dict:
    """{threads: the variant's banded C entry}, built in parallel."""
    src = (_build.CSRC / "resize_normalize.cu").read_text()
    if not THREADS_LINE.search(src):
        raise RuntimeError("resize_normalize.cu no longer defines kBandThreads")
    _build.BUILD_DIR.mkdir(exist_ok=True)
    procs = {}
    for t in THREADS:
        cu = _build.BUILD_DIR / f"banded_t{t}.cu"
        cu.write_text(THREADS_LINE.sub(f"constexpr int kBandThreads = {t};", src))
        lib = _build.BUILD_DIR / f"libbanded_t{t}.so"
        procs[t] = (lib, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", str(lib), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    entries = {}
    for t, (lib, proc) in procs.items():
        out = proc.communicate(timeout=600)[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {t} threads:\n{out}")
        regs = re.findall(r"Used (\d+) registers", out)
        print(f"[build] {t} threads: ptxas registers per kernel {regs}", flush=True)
        fn = ctypes.CDLL(str(lib)).vdqn_resize_normalize_banded
        fn.argtypes, fn.restype = [ctypes.c_void_p], ctypes.c_int
        entries[t] = fn
    return entries


def launcher(entry, x: torch.Tensor, out: torch.Tensor, rows: int):
    """A no-argument launch of `entry` on x -> out with `rows` rows a tile,
    and the tile's shared-memory bytes."""
    b, h, w, _ = x.shape
    prepared = rn._prepared(h, w, OUT, out.dtype, x.device)
    args = type(prepared.args).from_buffer_copy(prepared.args)
    args.rows_per_tile = rows
    args.smem_bytes = rn.banded_smem_bytes(rows, rn.staged_span(h, OUT, rows), w, OUT,
                                           out.element_size())
    args.x, args.out, args.batch = x.data_ptr(), out.data_ptr(), b
    args.stream = torch.cuda.current_stream().cuda_stream

    def launch():
        err = entry(ctypes.byref(args))
        if err != 0:
            raise RuntimeError(f"banded variant launch failed: CUDA error {err}")
    return launch, args.smem_bytes


def event_ms(fn, iters: int = 50, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=7)
    rounds = ap.parse_args().rounds
    if not torch.cuda.is_available():
        raise SystemExit("banded_variants: needs a CUDA device")
    print(subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip(), flush=True)
    entries = build_variants()
    g = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randint(0, 256, SHAPE, dtype=torch.uint8, device="cuda", generator=g)
    want = rn.resize_normalize_reference(x, OUT).permute(0, 2, 3, 1)
    variants = {}
    for dtype in DTYPES:
        out = torch.empty((SHAPE[0], OUT, OUT, 3), dtype=dtype, device="cuda")
        for t, entry in entries.items():
            for rows in ROWS:
                launch, smem = launcher(entry, x, out, rows)
                out.zero_()
                launch()
                err = (out.float() - want).abs()
                tol = ATOL + (BF16_RTOL * want.abs() if dtype == torch.bfloat16 else 0.0)
                if not bool((err <= tol).all()):
                    raise AssertionError(f"{t} threads, {rows} rows, {dtype}: max abs err "
                                         f"{err.max().item()}")
                variants[str(dtype)[6:], t, rows] = (launch, smem, [])
    for _ in range(rounds):
        for launch, _, times in variants.values():
            times.append(event_ms(launch))
    rows_out = []
    for (dname, t, rows), (_, smem, times) in variants.items():
        base = variants[dname, 256, 8][2]
        med = float(np.median(times))
        rel = med / float(np.median(base)) - 1
        print(f"[variant] {dname} {t} threads {rows:2d} rows: median {med:.4f} ms "
              f"[{min(times):.4f}, {max(times):.4f}] over {rounds} rounds, "
              f"{rel:+.1%} against 256 threads 8 rows; {smem} B shared memory", flush=True)
        rows_out.append({"dtype": dname, "threads": t, "rows_per_tile": rows,
                         "smem_bytes": smem, "median_ms": med, "ms": times})
    print(json.dumps({"shape": list(SHAPE), "out": OUT, "variants": rows_out}), flush=True)


if __name__ == "__main__":
    main()
