"""Evaluation CLI of the port (counterpart of the root evaluation/run.py,
with the same flags):

    python -m video_dqn_tpu_torch.evaluate <config.yml>
        [--fake-env | --mesh-env | --mesh-scene FILE | --furnished-env]
        [--workload N [--batched K [--pipeline-depth D] [--host-workers W]
         [--gather-timeout S] [--progress-every S]]] [-r] [-d] [-s I]
        [--episodes i,j,...] [-p]

Runs episodes on the card: each reasoning stop's depths map on the card,
FMM runs in the port's C++, and with SCORE: model the Q-net of
MODEL_CONFIG_LOCATION scores the views through the resize+normalize
kernel. Results land in RESULT_LOCATION/<name_from_config> and are printed
at the end. Without evaluation/val_episodes.npy (it needs the licensed
Gibson scenes) or with --fake-env, one episode runs on the fake env.
--mesh-env runs one episode on the mesh simulator over the extruded
default maze, --mesh-scene FILE over a PLY/OBJ/GLB scene (STAIRS sets
allow_stairs). --workload N generates N episodes: on the furnished
two-floor house with --furnished-env, on the mesh simulator with
--mesh-env or --mesh-scene, else on the fake env; a model-scored workload
renders at the model's TPU.IMAGE_SIZE. With --batched on a machine of
several cards the scorer is data parallel over all of them, as the JAX
CLI builds its mesh over every device (`main(device=...)` names one card
instead). -p writes a torch.profiler trace to
RESULT_LOCATION/<name_from_config>_trace.json.

A sequential run visualises every 100th episode, from episode 0, and with
-v every episode, as the JAX CLI does: with SLAM the episode's last rgb |
depth | map strip is written to VIDEO_LOCATION/<name_from_config>/
<episode>_<class>-<dist>m-spl<spl>-steps<steps>.png (neither machine can
write the JAX package's mp4). The batched path visualises nothing, as in
the JAX package.
"""

from __future__ import annotations

import argparse
import contextlib
import os
from typing import List, Optional

import numpy as np
import torch

from ._device import resolve_device
from .core.profiling import trace
from .eval.batched_runner import run_policy_batched
from .eval.fixtures import make_env_and_episode, make_episode_set, make_mesh_env_and_episode
from .eval.policy_config import load_file, name_from_config
from .eval.results import display_results
from .eval.runner import build_detector_from_config, load_scoring_model, run_policy
from .eval.scorer import make_multiclass_scorer


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="simulate policy (PyTorch port)")
    p.add_argument("-g", "--gpu", default="0", help="ignored (compat)")
    p.add_argument("-p", "--profile", action="store_true",
                   help="write a torch.profiler trace of the run")
    p.add_argument("-d", "--debug", action="store_true",
                   help="debug mode, no writing to results files")
    p.add_argument("-s", "--start", default=0, type=int,
                   help="episode index to start at")
    p.add_argument("-r", "--resume", action="store_true",
                   help="skip episodes with results already on disk")
    p.add_argument("--episodes", dest="episodes_to_run", default=None,
                   help="comma-separated episode indices")
    p.add_argument("-v", "--visualize", action="store_true",
                   help="visualise every episode (default: every 100th)")
    p.add_argument("--fake-env", action="store_true",
                   help="run against the built-in fake environment")
    p.add_argument("--mesh-env", action="store_true",
                   help="run against the mesh simulator (extruded maze)")
    p.add_argument("--mesh-scene", default=None,
                   help="PLY/OBJ/GLB scene file for the mesh simulator")
    p.add_argument("--furnished-env", action="store_true",
                   help="workload runs on the furnished two-floor house with "
                        "real class-object goals")
    p.add_argument("--workload", default=None,
                   help="run N generated episodes (product workload)")
    p.add_argument("--batched", default=None, type=int, metavar="N",
                   help="model-scored runs only: keep N episodes in flight "
                        "with cross-episode fused scoring")
    p.add_argument("--pipeline-depth", default=1, type=int, metavar="D",
                   help="with --batched: split the in-flight episodes into D "
                        "cohorts and overlap one cohort's scoring with the "
                        "others' host work (results are identical for any D)")
    p.add_argument("--host-workers", default=0, type=int, metavar="W",
                   help="with --batched: advance episodes' host work in W "
                        "threads; results are identical")
    p.add_argument("--gather-timeout", default=900.0, type=float, metavar="S",
                   help="with --batched: a score gather blocking past S seconds "
                        "in steady state raises (the first is exempt); 0 disables")
    p.add_argument("--progress-every", default=300.0, type=float, metavar="S",
                   help="with --batched: print done/total, rate and ETA at most "
                        "every S seconds; 0 disables")
    p.add_argument("config", help="eval config yml")
    return p


def main(argv: Optional[List[str]] = None, device=None):
    """Run the evaluation that `argv` (sys.argv when None) asks for on
    `device` (None: the card, and for --batched every card where there
    are several; raises without CUDA). Returns the mean SPL
    of the run's results folder (None when it is empty)."""
    args = parser().parse_args(argv)
    every_card = device is None
    device = resolve_device(device)

    config = load_file(args.config)

    episodes = None
    if os.path.exists("evaluation/val_episodes.npy"):
        episodes = np.load("evaluation/val_episodes.npy", allow_pickle=True)
    if episodes is not None and args.episodes_to_run:
        idx = [int(i) for i in args.episodes_to_run.split(",")]
        episodes = episodes[idx]

    kwargs = {}
    if args.workload:
        backend = ("furnished" if args.furnished_env
                   else "mesh" if (args.mesh_env or args.mesh_scene)
                   else "fake")
        size = 48
        if config.SCORE == "model" and config.MODEL_CONFIG_LOCATION:
            # render at the model's training resolution
            size = int(config.MODEL_CONFIG.TPU.IMAGE_SIZE)
        episodes, env_factory, house_factory = make_episode_set(
            int(args.workload), backend=backend, size=size,
            mesh_path=args.mesh_scene, fresh_envs=bool(args.batched))
        kwargs = {"env_factory": env_factory, "house_factory": house_factory}
    elif args.mesh_env or args.mesh_scene:
        # the mesh simulator: a scene file, or the extruded maze without one
        env, house, ep = make_mesh_env_and_episode(
            mesh_path=args.mesh_scene, allow_stairs=bool(config.STAIRS))
        episodes = np.array([ep], dtype=object)
        kwargs = {
            "env_factory": lambda h, mc, c: env,
            "house_factory": lambda name: house,
        }
    elif args.fake_env or episodes is None:
        # no licensed Gibson assets: the full loop on the fake env
        env, house, ep = make_env_and_episode()
        episodes = np.array([ep], dtype=object)
        kwargs = {
            "env_factory": lambda h, mc, c: make_env_and_episode()[0],
            "house_factory": lambda name: house,
        }

    path = os.path.join(config.RESULT_LOCATION, f"{name_from_config(config)}_trace.json")
    with trace(path, device) if args.profile else contextlib.nullcontext():
        if args.batched and config.SCORE == "model" and "env_factory" in kwargs:
            model, mc = load_scoring_model(config, device)
            # with no device named, every card when there are several, as
            # JAX's CLI builds its mesh over every device
            cards = torch.cuda.device_count() if every_card else 1
            scorer = make_multiclass_scorer(
                model, image_size=int(mc.TPU.IMAGE_SIZE),
                devices=[torch.device("cuda", i) for i in range(cards)] if cards > 1
                else [device])
            run_policy_batched(
                config, episodes,
                env_factory=lambda h, c: kwargs["env_factory"](h, mc, c),
                house_factory=kwargs["house_factory"],
                scorer=scorer, class_index_of=True,
                detector=build_detector_from_config(config, device),
                max_concurrent=int(args.batched),
                pipeline_depth=int(args.pipeline_depth),
                host_workers=int(args.host_workers),
                resume=args.resume,
                gather_timeout=float(args.gather_timeout),
                progress_every=float(args.progress_every),
                debug=args.debug,
                device=device,
            )
        else:
            if args.batched:
                print("--batched needs SCORE: model and a generated-episode "
                      "mode (--fake-env/--mesh-env/--workload); running sequentially")
            run_policy(config, episodes=episodes, debug=args.debug,
                       visualize_every=1 if args.visualize else 100,
                       resume=args.resume, start=args.start, device=device, **kwargs)
    if args.profile:
        print(f"profiler trace: {path}")

    return display_results(config)


if __name__ == "__main__":
    main()
