"""Fast-marching distances on masked grids (counterpart of
video_dqn_tpu/ops/fmm.py `fmm_distance`).

The solver is the port's C++ (csrc/host/fmm.cc, a heap-based first-order
eikonal solver), built into the host library at first use by _build.py. A
failed build or load raises: there is no fallback to Python. The numpy +
heapq form of the same algorithm (`_fmm_python`) stays as the test oracle
and runs only when asked for by name (`engine="python"`).

Distances are in grid units; masked and unreached cells are +inf.
"""

from __future__ import annotations

import heapq
from typing import Optional, Sequence, Tuple

import numpy as np

from .. import _build


def fmm_distance(
    traversible: np.ndarray,
    goals: Sequence[Tuple[int, int]],
    engine: Optional[str] = None,
    early_stop: Optional[Tuple[int, int]] = None,
    margin: float = 0.0,
    max_dist: Optional[float] = None,
) -> np.ndarray:
    """traversible: (H, W) bool; goals: list of (y, x) seed cells. Returns
    float64 (H, W) distances (+inf where masked or unreached). `engine`:
    None or "native" (the C++ solver), or "python" (the oracle).

    Bounded solves (either knob; values inside the bound are exact):
      early_stop=(y, x): stop once that cell is accepted plus `margin`
        extra wavefront distance — the planner's "distance to the agent +
        neighbourhood" query explores a band instead of the whole map;
      max_dist: stop the wavefront at this distance (cells beyond: +inf).
    """
    if engine not in (None, "native", "python"):
        raise ValueError(f"engine must be 'native' or 'python', got {engine!r}")
    # bool -> uint8 is a free reinterpret. The solver flips goal cells in
    # this buffer and restores them before it returns, so sharing the
    # caller's memory is safe for one thread and skips a copy per solve.
    # NOT reentrant: concurrent solves over the SAME grid would see each
    # other's goal flips (each episode owns its planner and grids).
    if (
        traversible.dtype == np.bool_
        and traversible.flags.c_contiguous
        and traversible.flags.writeable
    ):
        mask = traversible.view(np.uint8)
    else:
        mask = np.ascontiguousarray(traversible.astype(np.uint8))
    h, w = mask.shape
    gy = np.ascontiguousarray([g[0] for g in goals], np.int32)
    gx = np.ascontiguousarray([g[1] for g in goals], np.int32)
    if engine == "python":
        return _fmm_python(mask, list(zip(gy.tolist(), gx.tolist())),
                           early_stop=early_stop, margin=margin, max_dist=max_dist)
    lib = _build.load_host()
    out = np.empty(h * w, np.float64)
    if early_stop is not None or max_dist is not None:
        ey, ex = early_stop if early_stop is not None else (-1, -1)
        lib.vdqn_fmm_distance_bounded(
            mask.ctypes.data, h, w, gy.ctypes.data, gx.ctypes.data, len(goals),
            int(ey), int(ex), float(margin),
            float(max_dist if max_dist is not None else -1.0), out.ctypes.data)
    else:
        lib.vdqn_fmm_distance(mask.ctypes.data, h, w, gy.ctypes.data, gx.ctypes.data,
                              len(goals), out.ctypes.data)
    return out.reshape(h, w)


def _solve_eikonal(tx: float, ty: float) -> float:
    tmin, tmax = (tx, ty) if tx < ty else (ty, tx)
    if tmax == np.inf:
        return tmin + 1.0
    diff = tmax - tmin
    if diff >= 1.0:
        return tmin + 1.0
    s = tx + ty
    disc = s * s - 2.0 * (tx * tx + ty * ty - 1.0)
    return 0.5 * (s + np.sqrt(disc))


def _fmm_python(mask: np.ndarray, goals, early_stop=None, margin: float = 0.0,
                max_dist=None) -> np.ndarray:
    """The solver's algorithm in numpy + heapq: the tests' oracle."""
    h, w = mask.shape
    out = np.full((h, w), np.inf)
    accepted = np.zeros((h, w), bool)
    heap = []
    # goal cells are forced traversible, as the reference planner unmasks
    # its goal: a goal mapped as an obstacle still gets a distance field
    mask = mask.copy()
    for y, x in goals:
        if 0 <= y < h and 0 <= x < w:
            mask[y, x] = 1
            out[y, x] = 0.0
            heapq.heappush(heap, (0.0, y, x))
    stop_at = max_dist if max_dist is not None else np.inf
    while heap:
        if heap[0][0] > stop_at:
            break
        t, cy, cx = heapq.heappop(heap)
        if accepted[cy, cx]:
            continue
        accepted[cy, cx] = True
        if early_stop is not None and (cy, cx) == tuple(early_stop):
            stop_at = min(stop_at, t + margin)
        for dy, dx in ((-1, 0), (1, 0), (0, -1), (0, 1)):
            ny, nx = cy + dy, cx + dx
            if not (0 <= ny < h and 0 <= nx < w):
                continue
            if not mask[ny, nx] or accepted[ny, nx]:
                continue
            tx = min(
                out[ny, nx - 1] if nx > 0 and mask[ny, nx - 1] else np.inf,
                out[ny, nx + 1] if nx < w - 1 and mask[ny, nx + 1] else np.inf,
            )
            ty = min(
                out[ny - 1, nx] if ny > 0 and mask[ny - 1, nx] else np.inf,
                out[ny + 1, nx] if ny < h - 1 and mask[ny + 1, nx] else np.inf,
            )
            tt = _solve_eikonal(tx, ty)
            if tt < out[ny, nx]:
                out[ny, nx] = tt
                heapq.heappush(heap, (tt, ny, nx))
    out[~accepted] = np.inf  # tentative values outside the bound are not final
    return out
