"""Object-goal evaluation policy: semantic-reasoning stops over an
occupancy map, value-scored waypoints, FMM navigation, SPL accounting
(counterpart of video_dqn_tpu/eval/evaluate.py `check_movement`,
`make_geodesic_scorer`, `ours_evaluate`, `episode_generator`).

  * success_distance 1 m, MAX_STEPS 500, NUM_ROTATIONS 12, 50 macro steps
    with SLAM (30 without)
  * a stop: 12 left turns; the views' depths map into the occupancy grid
    in one call on the planner's device; per view a candidate waypoint
    0.9-2 m ahead within +/-7 degrees that is FMM-reachable (< 3 m), pushed
    with the view's score
  * waypoint selection: optional backtrack rejection, argmax of
    score + CONSISTENCY_WEIGHT * max(10 - dist, 0) / 10, skipping waypoints
    the planner cannot act toward
  * navigation: a step budget of ceil(2 * (d / 0.25) + 6), replan on a
    +0.1 m FMM jump, stop ends the leg, only forward steps count as
    travel, success when the geodesic distance is < 1 m: SPL =
    min(goal_dist / dist_traveled, 1); STOP mode returns the step log
  * per-episode numpy rng seeded from config.SEED
  * with COMBINE_DETECTOR and a detector, a stop's views are detected in
    one call and a view whose target-class detection clears
    CONFIDENCE_THRESHOLD gains (confidence + 1) on its score
    (`fuse_detector_scores`)
"""

from __future__ import annotations

import inspect
import math
import os
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from ..data.detect import COCO_TARGET_IDS
from ..plan.mapper import DepthMapperAndPlanner
from ..plan.visualize import write_combined
from ..sim.gibson import relevant_objects
from ..viz.panorama import join_images
from .policy_config import name_from_config

SUCCESS_DISTANCE = 1.0
MAX_STEPS = 500
NUM_ROTATIONS = 12


def _detector_batch_contract(detector, frames) -> Optional[List[Dict]]:
    """Whether `detector` speaks the pipeline's batch contract,
    `detector(batch) -> [{boxes, scores, classes}]`, resolved once per
    detector object, and if so this stop's detections:
      1. a callable with two or more required positional arguments is the
         per-image contract `detector(im, class_label)` and never gets a
         batch;
      2. otherwise the first batch call catches only TypeError (a
         signature mismatch) and checks the result's structure; the
         verdict is cached on the detector;
      3. every later call is unguarded, so that a real failure (out of
         memory, a shape fault, bad weights) propagates instead of falling
         back to per-image calls."""
    cached = getattr(detector, "_vdqn_batch_contract", None)
    if cached is False:
        return None
    if cached is True:
        return detector(np.stack(frames))

    batch_capable = True
    try:
        required = [p for p in inspect.signature(detector).parameters.values()
                    if p.default is inspect.Parameter.empty
                    and p.kind in (inspect.Parameter.POSITIONAL_ONLY,
                                   inspect.Parameter.POSITIONAL_OR_KEYWORD)]
        batch_capable = len(required) <= 1
    except (TypeError, ValueError):
        pass  # no signature (a builtin): the probe decides

    dets = None
    if batch_capable:
        try:
            cand = detector(np.stack(frames))
        except TypeError:
            batch_capable = False
        else:
            if (isinstance(cand, list) and len(cand) == len(frames)
                    and all(isinstance(d, dict) for d in cand)):
                dets = cand
            else:
                raise TypeError(
                    "detector accepted a batch but returned "
                    f"{type(cand).__name__}, not a list of per-image dicts "
                    "({boxes, scores, classes}); fix the detector's batch "
                    "contract or give it a (im, class_label) signature")
    try:
        detector._vdqn_batch_contract = batch_capable
    except (AttributeError, TypeError):
        pass  # a callable that takes no attribute: probe again next stop
    return dets


def fuse_detector_scores(scores: np.ndarray, rgbs, detector, class_label: str,
                         confidence_threshold: float) -> np.ndarray:
    """Detector fusion: where the detector's best detection of the target
    class in a view clears the threshold and its box reaches the centre
    third (x1 <= 2/3 width or x2 >= 1/3 width), the view's score gains
    (confidence + 1). A stop's views go to the detector in one batch call
    where it takes batches, else one (im, class_label) call a view; the
    result is the same either way."""
    out = scores.copy()
    frames = [np.asarray(im) for im in rgbs]
    frames = [im[0] if im.ndim == 4 else im for im in frames]
    dets = _detector_batch_contract(detector, frames)
    if dets is not None:
        cid = COCO_TARGET_IDS[class_label]
    for i, frame in enumerate(frames):
        size = frame.shape[1]
        left_lim, right_lim = size // 3, (size * 2) // 3
        if dets is not None:
            mask = dets[i]["classes"] == cid
            boxes, dscores = dets[i]["boxes"][mask], dets[i]["scores"][mask]
        else:
            boxes, dscores = detector(frame, class_label)
        if len(dscores) > 0 and dscores.max() > confidence_threshold:
            box = boxes[int(np.argmax(dscores))]
            if box[0] <= right_lim or box[2] >= left_lim:
                out[i] += dscores.max() + 1.0
    return out


def check_movement(env, start_ang: float, planner, rng) -> Optional[np.ndarray]:
    """Sample 100 points 0.9-2 m ahead within +/-7 degrees; return the
    first FMM-reachable one."""
    points = []
    for _ in range(100):
        dist = rng.uniform(0.9, 2.0)
        ang = rng.uniform(-math.radians(7), math.radians(7)) + start_ang
        translation = np.array([-math.sin(ang), 0.0, -math.cos(ang)]) * dist
        points.append(translation + env.pos)
    idx = planner.reachable_nearby(points)
    return points[idx] if idx is not None else None


def make_geodesic_scorer(env) -> Callable:
    """Oracle baseline. View scores are the negative geodesic
    distance-to-goal from the agent's current position; the scorer also
    exposes `score_dest`, with which the policy ranks candidate WAYPOINTS
    by the oracle value of the waypoint itself."""

    def scorer(images_uint8) -> np.ndarray:
        v = len(images_uint8)
        d = env.distance_to_goal()
        d = 0.0 if not np.isfinite(d) else d
        return np.full(v, -d, np.float64)

    def score_dest(point) -> float:
        d = env._dist_to_goal(np.asarray(point, np.float64))
        return -d if np.isfinite(d) else -1e6

    scorer.score_dest = score_dest
    return scorer


def ours_evaluate(
    config,
    env,
    ep,
    house,
    epind: int,
    scorer: Callable,
    visualize: bool = False,
    model_config=None,
    detector=None,
    planner: Optional[DepthMapperAndPlanner] = None,
    map_max_dim: Optional[float] = None,
    device=None,
):
    """Run one episode; returns SPL (or the step log in STOP mode). A
    synchronous loop over episode_generator; the batched runner
    (eval/batched_runner.py) drives the same generator with fused score
    calls across episodes."""
    gen = episode_generator(
        config, env, ep, house, epind, visualize, model_config, detector, planner,
        map_max_dim, score_dest=getattr(scorer, "score_dest", None), device=device,
    )
    try:
        request = next(gen)
        while True:
            request = gen.send(scorer(request))
    except StopIteration as stop:
        return stop.value


def episode_generator(
    config,
    env,
    ep,
    house,
    epind: int,
    visualize: bool = False,
    model_config=None,
    detector=None,
    planner: Optional[DepthMapperAndPlanner] = None,
    map_max_dim: Optional[float] = None,
    score_dest=None,
    device=None,
):
    """An episode as a coroutine: yields uint8 view batches to be scored,
    receives (V,) scores, returns SPL (STOP mode: the step log). Env
    stepping, mapping and planning happen inside; only Q scoring crosses
    the boundary, which is what lets a batched runner fuse the score calls
    of many episodes. Without a `planner`, one is made that maps on
    `device` (None: the card). With `visualize` and SLAM the planner logs
    every step's frames and the episode's last rgb | depth | map strip is
    written under VIDEO_LOCATION/<name_from_config> as JAX names it; the
    planner's `current_pan` holds the captioned strip of the latest stop
    (its views, their negated scores, "Predicted Values" and the object
    class), overwritten at each stop and written to no file, as in JAX.
    With COMBINE_DETECTOR, `detector` fuses into each stop's scores."""
    hn, floor, class_label, goal_dist, pos, rot = ep

    rng = np.random.default_rng(config.SEED)

    if goal_dist == float("inf"):
        return np.array([]) if config.STOP else 0

    if map_max_dim is None:
        if hasattr(env, "topdown_extent"):
            # the reference sizes the map from the cropped top-down
            # navigable extent; envs with a navigability grid expose it
            map_max_dim = float(env.topdown_extent())
        else:
            map_max_dim = max(10.0, float(goal_dist) * 2.2)

    if planner is None:
        planner = DepthMapperAndPlanner(
            dt=30,
            map_size_cm=int(map_max_dim * 230),
            mark_locs=True,
            close_small_openings=True,
            log_visualization=visualize,
            device=device,
        )
    polygons = relevant_objects(env.pos, house.objects[class_label])
    planner._reset(
        float(goal_dist), global_goals=polygons, start_pos=env.pos,
        start_ang=env.angle,
        camera_attrs=getattr(env, "camera_attrs", None),
    )

    openlist: List[Tuple[float, np.ndarray]] = []
    visited: List[np.ndarray] = []
    dist_traveled = 0.0
    log: List = []
    spl = 0.0
    agent_steps_taken = 0

    def output():
        if visualize and config.SLAM and planner.log_visualization:
            write_combined(
                planner, os.path.join(config.VIDEO_LOCATION, name_from_config(config)),
                name="%04d_%s-%dm-spl%.2f-steps%d"
                % (epind, class_label, int(goal_dist), spl, agent_steps_taken))
        return np.array(log, dtype=object) if config.STOP else spl

    # score_dest (the geodesic oracle has one): openlist entries carry the
    # oracle value of the candidate WAYPOINT rather than the view score.
    # Model scorers have none and keep the reference semantics.

    def semantic_reasoning():
        planner.log_reasoning()
        views = []
        locs = []
        for _ in range(NUM_ROTATIONS):
            ims, _, _, _ = env.step(1)
            views.append(ims)
            locs.append([*planner.pos_to_loc(env.pos), env.angle])
        all_scores = []
        batched = bool(config.BATCHED_REASONING) if "BATCHED_REASONING" in config else True
        if batched:
            # one mapping call and one score call for the stop
            depths = np.stack(
                [np.asarray(v["depth"])[..., 0] * 1000.0 for v in views]
            )
            planner.add_observations_batch(depths, np.array(locs, np.float32))
            scores = yield np.stack([v["rgb"] for v in views])
            if detector is not None and config.COMBINE_DETECTOR:
                scores = fuse_detector_scores(
                    scores, [v["rgb"] for v in views], detector, class_label,
                    config.CONFIDENCE_THRESHOLD,
                )
            all_scores = list(map(float, scores))
            for k in range(NUM_ROTATIONS):
                ang = locs[k][2]
                dest = check_movement(env, ang, planner, rng)
                if dest is not None:
                    sc_k = float(scores[k])
                    if score_dest is not None:
                        sc_k = float(score_dest(dest))
                    openlist.append((sc_k, dest))
        else:
            # the reference's order: observe, check, score per view
            for ims, loc in zip(views, locs):
                planner.add_observation(
                    np.asarray(ims["depth"]) * 1000.0, loc
                )
                dest = check_movement(env, loc[2], planner, rng)
                sc = (yield np.asarray(ims["rgb"])[None])[0]
                if detector is not None and config.COMBINE_DETECTOR:
                    sc = fuse_detector_scores(
                        np.array([sc]), [ims["rgb"]], detector, class_label,
                        config.CONFIDENCE_THRESHOLD,
                    )[0]
                all_scores.append(float(sc))
                if dest is not None:
                    sc_k = float(sc)
                    if score_dest is not None:
                        sc_k = float(score_dest(dest))
                    openlist.append((sc_k, dest))

        if visualize and config.SLAM and planner.log_visualization:
            strips = [np.asarray(v["rgb"])[0] if np.asarray(v["rgb"]).ndim == 4
                      else np.asarray(v["rgb"]) for v in views]
            planner.current_pan = join_images(
                strips, -np.array(all_scores), bl_text="Predicted Values",
                br_text=f"Object Class: {class_label.title()}")

    macro_steps = 50 if config.SLAM else 30

    yield from semantic_reasoning()
    agent_steps_taken += NUM_ROTATIONS

    for _macro in range(macro_steps):
        if config.BACKTRACK_REJECTION and visited:
            vis = np.stack(visited)

            def reject(point):
                d = np.linalg.norm((vis - point)[:, [0, 2]], axis=1)
                return (d < (SUCCESS_DISTANCE - 0.1)).sum() > 0

            openlist[:] = [e for e in openlist if not reject(e[1])]

        def selection_score(entry):
            s, d = entry
            dist = np.linalg.norm(env.pos - d)
            return s + config.CONSISTENCY_WEIGHT * max(10 - dist, 0) / 10

        if not openlist:
            return output()
        ind = int(np.argmax([selection_score(e) for e in openlist]))
        sc, next_pos = openlist.pop(ind)

        dist_est = planner.fmm_distance_m(next_pos)
        # skip waypoints the planner cannot act toward OR whose FMM
        # distance is infinite (a cell cut off in the current map: the step
        # budget below would overflow on inf)
        while not np.isfinite(dist_est) or not planner.action_toward(next_pos):
            if not openlist:
                return output()
            ind = int(np.argmax([selection_score(e) for e in openlist]))
            sc, next_pos = openlist.pop(ind)
            dist_est = planner.fmm_distance_m(next_pos)

        planner.goal_loc = planner.pos_to_loc(next_pos)

        step_estimate = math.ceil(2 * (dist_est / 0.25) + 6)
        cur_dist_est = dist_est
        for step in range(step_estimate):
            new_dist_est = planner.fmm_distance_m(next_pos)
            if new_dist_est > cur_dist_est + 0.1:
                break  # replan: FMM estimate jumped
            cur_dist_est = new_dist_est
            action = planner.get_action_toward(next_pos)
            if action == 3:
                break  # subgoal reached
            obs, _, _, _ = env.step(action)
            if action == 0:
                dist_traveled += 0.25
            planner.log_act(obs, env.pos, env.angle, action)
            visited.append(env.pos)
            log.append(
                [env.pos, getattr(env, "rot", env.angle), dist_traveled,
                 env.distance_to_goal(), step == 0]
            )
            agent_steps_taken += 1

            if env._dist_to_goal(env.pos) < SUCCESS_DISTANCE and not config.STOP:
                spl = min(goal_dist / (dist_traveled + 1e-5), 1)
                return output()
            if agent_steps_taken >= MAX_STEPS:
                return output()
        yield from semantic_reasoning()
        agent_steps_taken += NUM_ROTATIONS
        if agent_steps_taken >= MAX_STEPS:
            return output()
    return output()
