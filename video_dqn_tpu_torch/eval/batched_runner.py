"""Cross-episode batched evaluation (counterpart of
video_dqn_tpu/eval/batched_runner.py `run_policy_batched`).

K episodes run at once as coroutines (eval/evaluate.py
episode_generator); whenever several wait at a reasoning stop, their view
batches are scored in ONE fused call over the concatenated (sum_V, F, H,
W, 3) stack. Each episode's env stepping, mapping and planning stay
sequential inside its coroutine. Each episode's results equal the
sequential runner's: the same generator makes the same requests, and
scoring is per row, so only the batching of score calls changes.
"""

from __future__ import annotations

import os
import queue
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Callable

import numpy as np

from .._device import resolve_device
from ..core.disk_logger import DiskLogger, DiskReader
from ..sim.gibson import CLASS_LABELS, relevant_locations
from .evaluate import episode_generator
from .policy_config import name_from_config
from .runner import build_detector_from_config


def run_policy_batched(
    config,
    episodes,
    env_factory: Callable,
    house_factory: Callable,
    scorer: Callable,
    class_index_of=None,
    max_concurrent: int = 8,
    pipeline_depth: int = 1,
    host_workers: int = 0,
    resume: bool = False,
    gather_timeout: float = 0.0,
    progress_every: float = 0.0,
    debug: bool = False,
    device=None,
):
    """Run all episodes with up to `max_concurrent` in flight.

    env_factory(house, config) -> a FRESH env per episode (concurrent
    episodes cannot share an env); scorer scores a (V, ...) uint8 batch
    for a given class via scorer(images, class_index) OR a plain
    per-batch scorer when class_index_of is None. Each episode maps on
    `device` (None: the card).

    `pipeline_depth` > 1 splits the in-flight episodes into that many
    cohorts and software-pipelines them: while one cohort's fused view
    batch is being scored on the device (the dispatch is asynchronous),
    the other cohorts' episodes do their host work (env stepping,
    mapping, FMM planning). This hides the score call. Scorers built by
    eval/scorer.py `make_multiclass_scorer` expose non-blocking
    `.dispatch`/`.gather`; plain callables degrade to synchronous scoring
    (pipelining then only reorders, never overlaps).
    Per-episode results are bit-identical for any depth/cohort split:
    scoring is per-row, so batch composition cannot change values.

    `host_workers` > 1 advances the episodes of a cohort in a thread
    pool: the per-episode host work (numpy, the C++ FMM and raycasts,
    which release the GIL) runs across cores. Safe because every episode
    owns its env, mapper and FMM/opened-grid caches (plan/mapper.py keeps
    them per instance; the FMM's in-place goal flip is not reentrant
    over one grid); the threads share the card's default stream, and
    results and DiskLogger writes stay on the calling thread.

    `gather_timeout` > 0 is the device-stall watchdog: a gather that
    blocks past the timeout raises instead of hanging the workload. The
    first gather is exempt (its start-up work, the first call's kernel
    loads and cuDNN's plans, may be long); steady-state fused scoring is
    sub-second, so a generous timeout has no false positives. Finished
    episodes are already in the DiskLogger shards, so the failure
    composes with `resume=True` into a restart that loses little.

    `progress_every` > 0 prints done/total, rate, and ETA at most every
    that many seconds (long workloads otherwise emit nothing until the
    final summary).
    """
    device = resolve_device(device)
    build_detector_from_config(config)
    log_folder = os.path.join(config.RESULT_LOCATION, name_from_config(config))
    logger = DiskLogger(log_folder, checkpoint_time=60 * 30)

    results = {}
    if resume:
        # skip episodes whose results already exist in the shards (the
        # sequential runner's contract). Safe for the generated workloads:
        # episode content is fixed when the set is made, and the env seed
        # counter only feeds start-state sampling, which eval never calls
        # mid-episode.
        results = dict(DiskReader(log_folder).data())
        if results:
            print(f"Resuming: {len(results)} episodes already on disk")
    pending = [(i, ep) for i, ep in enumerate(episodes) if i not in results]

    def launch_into(cohort):
        if not pending:
            return False
        epind, ep = pending.pop(0)
        hn, floor, class_label, goal_dist, pos, rot = ep
        house = house_factory(hn)
        env = env_factory(house, config)
        loc = env.sample_start_state(int(floor))[0]
        env.goals = relevant_locations(
            loc, house.object_locations_for_habitat_dest[class_label]
        )
        env.set_agent_state(pos, rot)
        gen = episode_generator(
            config, env, ep, house, epind, visualize=False, device=device,
        )
        ci = CLASS_LABELS.index(class_label)
        try:
            req = next(gen)
            cohort[epind] = (gen, ci, req)
        except StopIteration as stop:
            results[epind] = stop.value
            if not debug:
                logger.write(epind, stop.value)
        return True

    t_start = time.time()
    done_initial = len(results)
    total = len(results) + len(pending)
    last_report = [t_start]

    def maybe_report():
        if not progress_every:
            return
        now = time.time()
        if now - last_report[0] < progress_every:
            return
        done = len(results) - done_initial
        rate = done / max(now - t_start, 1e-9)
        left = total - len(results)
        eta = left / rate / 60 if rate > 0 else float("inf")
        print(f"[batched] {len(results)}/{total} episodes "
              f"({rate:.3f} ep/s, ETA {eta:.1f} min)", flush=True)
        last_report[0] = now

    if hasattr(scorer, "dispatch") and hasattr(scorer, "gather"):
        do_dispatch, do_gather = scorer.dispatch, scorer.gather
    else:
        def do_dispatch(stacked, cls):
            return scorer(stacked, cls) if cls is not None else scorer(stacked)

        def do_gather(handle):
            return handle

    if gather_timeout and gather_timeout > 0:
        # daemon worker (NOT a ThreadPoolExecutor: its non-daemon threads
        # would block interpreter exit while parked inside the very hung
        # gather the watchdog just reported)
        req_q, res_q = queue.Queue(), queue.Queue()
        inner_gather = do_gather

        def _gather_worker():
            while True:
                h = req_q.get()
                try:
                    res_q.put((inner_gather(h), None))
                except BaseException as e:  # surface scorer errors too
                    res_q.put((None, e))

        threading.Thread(target=_gather_worker, daemon=True).start()
        first_gather_done = [False]

        def do_gather(handle):  # noqa: F811 — watchdog wrapper
            req_q.put(handle)
            try:
                out, err = res_q.get(
                    timeout=None if not first_gather_done[0] else gather_timeout)
            except queue.Empty:
                raise RuntimeError(
                    f"device gather stalled past {gather_timeout:.0f}s in "
                    "steady state (normal fused scoring is sub-second) — "
                    "device failure suspected. Finished episodes "
                    "are on disk; rerun with -r/--resume to continue."
                ) from None
            if err is not None:
                raise err
            first_gather_done[0] = True
            return out

    def fuse_and_dispatch(cohort):
        # fuse the cohort's pending requests into ONE score call (a
        # class_index-aware scorer batches across classes too)
        if not cohort:
            return None
        items = list(cohort.items())
        batches = [req for _, (_, _, req) in items]
        sizes = [len(b) for b in batches]
        stacked = np.concatenate(batches, axis=0)
        cls = None
        if class_index_of is not None:
            cls = np.concatenate(
                [np.full(n, ci) for n, (_, (_, ci, _)) in zip(sizes, items)]
            )
        return items, sizes, do_dispatch(stacked, cls)

    pool = None
    if host_workers and host_workers > 1:
        pool = ThreadPoolExecutor(max_workers=int(host_workers))

    def _send(gen, part):
        try:
            return gen.send(part), None, False
        except StopIteration as stop:
            return None, stop.value, True

    def advance(cohort, items, sizes, scores):
        # distribute scores + advance each episode to its next request
        # (all the per-episode host work happens inside gen.send)
        parts, offset = [], 0
        for n in sizes:
            parts.append(np.asarray(scores[offset : offset + n]))
            offset += n
        if pool is not None:
            outs = list(pool.map(
                _send, [gen for _, (gen, _, _) in items], parts))
        else:
            outs = [_send(gen, part)
                    for (_, (gen, _, _)), part in zip(items, parts)]
        for (epind, (gen, ci, _)), (req, value, done) in zip(items, outs):
            if done:
                del cohort[epind]
                results[epind] = value
                if not debug:
                    logger.write(epind, value)
            else:
                cohort[epind] = (gen, ci, req)

    depth = max(1, int(pipeline_depth))
    per_cohort = max(1, -(-max_concurrent // depth))
    cohorts = [dict() for _ in range(depth)]
    inflight = [None] * depth
    for i, c in enumerate(cohorts):
        while len(c) < per_cohort and launch_into(c):
            pass
        inflight[i] = fuse_and_dispatch(c)

    while any(f is not None for f in inflight):
        for i, c in enumerate(cohorts):
            if inflight[i] is not None:
                items, sizes, handle = inflight[i]
                advance(c, items, sizes, do_gather(handle))
            while len(c) < per_cohort and launch_into(c):
                pass
            inflight[i] = fuse_and_dispatch(c)
        maybe_report()
    if pool is not None:
        pool.shutdown()
    return results
