"""Simulator-generated datasets (counterpart of
video_dqn_tpu/data/sim_dataset.py `random_walk`, `generate_sim_dataset`,
`generate_inverse_pairs`): random walks in a nav env (the port's
FakeNavEnv, MeshNavEnv or the furnished house) written as the Q-learning
quadruplet feather with the true actions and proximity rewards, and as the
inverse model's 22-column pairs npy.

The walks, the proximity "detections", the filter npy and the columns are
the JAX package's, draw for draw; the frames are written by the port's own
JPEG writer (data/jpeg.py save_images, quality 75, which writes PIL's
file) one walk at a time. This is host code, like the simulators: it has
no device.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np

from ..sim.gibson import CLASS_LABELS, relevant_locations
from .episodes import assemble_episodes
from .jpeg import save_images
from .schema import write_feather

JPEG_QUALITY = 75  # PIL's default, which the JAX package's frames are written at


def random_walk(env, steps: int, rng, forward_bias: float = 0.7):
    """Forward-biased random walk; turns away after collisions.
    Yields (obs, action_taken) pairs — action taken AFTER the frame."""
    turn_streak = 0
    for _ in range(steps):
        obs = env.get_observation()
        if turn_streak > 0:
            action = 1  # keep turning left until the streak ends
            turn_streak -= 1
        elif rng.random() < forward_bias:
            action = 0
        else:
            action = 1 if rng.random() < 0.5 else 2
        pos_before = env.pos
        yield obs, action
        env.step(action)
        if action == 0 and np.allclose(env.pos, pos_before):
            turn_streak = int(rng.integers(2, 5))  # collided: rotate away


def _frame(obs) -> np.ndarray:
    return np.array(obs["rgb"], np.uint8)  # a copy: the env may reuse its buffer


def generate_sim_dataset(
    env,
    house,
    out_root: str,
    n_videos: int = 10,
    steps_per_video: int = 200,
    reward_dist: float = 1.0,
    seed: int = 0,
    floor: Optional[int] = 0,
    stride: int = 3,
) -> str:
    """Returns the path of the written data.feather. Frames land under
    out_root/frames/<vid>/%04d.jpg; the feather carries the exact schema
    the trainer consumes, with:
      detector_score[c] = 0.99 when the frame's position is within
      `reward_dist` geodesic meters of an object of class c (above every
      per-class threshold — the proximity stand-in for a detection), and
      inverse_actions = the action actually taken after each before-frame.
    floor=None alternates walks across the env's floors so every class
    (objects live on one specific floor each) gets reward coverage."""
    rng = np.random.default_rng(seed)
    frames_root = os.path.join(out_root, "frames")
    filters_dir = os.path.join(out_root, "filter_out")
    os.makedirs(frames_root, exist_ok=True)
    os.makedirs(filters_dir, exist_ok=True)

    dests = {c: house.object_locations_for_habitat_dest.get(c, []) for c in CLASS_LABELS}

    detections: Dict[str, Dict[int, np.ndarray]] = {}
    actions_by_path: Dict[str, int] = {}
    for v in range(n_videos):
        vid = f"sim{v:08d}"
        vdir = os.path.join(frames_root, vid)
        os.makedirs(vdir, exist_ok=True)
        v_floor = v % getattr(env, "num_floors", 1) if floor is None else floor
        pos, ang = env.sample_start_state(v_floor)
        env.set_agent_state(pos, ang)
        det: Dict[int, np.ndarray] = {}
        paths, frames = [], []
        for i, (obs, action) in enumerate(random_walk(env, steps_per_video, rng), start=1):
            path = os.path.join(vdir, f"{i:04d}.jpg")
            paths.append(path)
            frames.append(_frame(obs))
            actions_by_path[path] = action
            # per-class proximity "detections": (5, 2) object array of
            # (boxes (N,4), scores (N,)) like data/detect.py emits
            arr = np.empty((5, 2), object)
            for k, cls in enumerate(CLASS_LABELS):
                goals = relevant_locations(env.pos, dests[cls])
                d = min((env.geodesic_distance(env.pos, g) for g in goals),
                        default=float("inf"))
                if d < reward_dist:
                    arr[k, 0] = np.array([[0.0, 0.0, 10.0, 10.0]], np.float32)
                    arr[k, 1] = np.array([0.99], np.float32)
                else:
                    arr[k, 0] = np.zeros((0, 4), np.float32)
                    arr[k, 1] = np.zeros((0,), np.float32)
            det[i] = arr
        save_images(paths, frames, quality=JPEG_QUALITY)
        detections[vid] = det
        np.save(
            os.path.join(filters_dir, f"{vid}_filters.npy"),
            {"indoor_locs": np.arange(1, steps_per_video + 1),
             "person_locs": np.array([], np.int64)},
            allow_pickle=True,
        )

    cols = assemble_episodes(detections, filters_dir, frames_root, stride=stride)
    cols["inverse_actions"] = np.array([actions_by_path[p] for p in cols["before_image"]],
                                       np.int64)
    out = os.path.join(out_root, "data.feather")
    write_feather(cols, out)
    return out


def generate_inverse_pairs(
    env,
    out_root: str,
    n_walks: int = 6,
    steps_per_walk: int = 120,
    seed: int = 0,
    val_fraction: float = 0.2,
):
    """Single-step (before, after, action) state pairs from simulator
    walks, in the exact 22-column object-npy format GibsonPairBatcher
    consumes (the reference ships this data only as opaque artifacts).

    State images land at <out_root>/states/<loc>/0.jpg (the batcher's
    non-panorama layout); angles are stored as y-axis quaternions; the
    min_dists columns are +inf (inverse training consumes only the action
    label — reward columns exist for schema parity).

    Returns (train_npy_path, val_npy_path, image_root)."""
    rng = np.random.default_rng(seed)
    image_root = os.path.join(out_root, "states")
    os.makedirs(image_root, exist_ok=True)

    def quat(a: float):
        return [np.cos(a / 2), 0.0, np.sin(a / 2), 0.0]

    rows = []
    for w in range(n_walks):
        floor = w % getattr(env, "num_floors", 1)
        pos, ang = env.sample_start_state(floor)
        env.set_agent_state(pos, ang)
        prev = None  # (loc, pos, ang, action-taken-after)
        paths, frames = [], []
        for i, (obs, action) in enumerate(random_walk(env, steps_per_walk, rng), start=1):
            loc = f"w{w:03d}_{i:04d}"
            d = os.path.join(image_root, loc)
            os.makedirs(d, exist_ok=True)
            paths.append(os.path.join(d, "0.jpg"))
            frames.append(_frame(obs))
            if prev is not None:
                ploc, ppos, pang, pact = prev
                # drop collided forwards: a 'forward' label over two
                # identical frames is unlearnable label noise
                if not (pact == 0 and np.allclose(ppos, env.pos)):
                    rows.append([ploc, *ppos, *quat(pang), loc, *env.pos,
                                 *quat(env.angle), pact + 1, *([float("inf")] * 5)])
            prev = (loc, np.array(env.pos, np.float64), float(env.angle), int(action))
        save_images(paths, frames, quality=JPEG_QUALITY)

    arr = np.array(rows, dtype=object)
    if arr.ndim != 2 or arr.shape[1] != 22:
        raise ValueError(f"the walks gave no 22-column pairs (shape {arr.shape})")
    perm = rng.permutation(len(arr))
    n_val = max(1, int(len(arr) * val_fraction))
    train_p = os.path.join(out_root, "inverse_train_data.npy")
    val_p = os.path.join(out_root, "inverse_val_data.npy")
    np.save(train_p, arr[perm[n_val:]], allow_pickle=True)
    np.save(val_p, arr[perm[:n_val]], allow_pickle=True)
    return train_p, val_p, image_root
