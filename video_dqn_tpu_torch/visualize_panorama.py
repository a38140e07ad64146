"""Panorama CLI of the port (counterpart of the root visualize_panorama.py,
with the same flags):

    python -m video_dqn_tpu_torch.visualize_panorama [--out panorama.png]
        [--size 224] [--rotations 12] [--analysis corr.png [--model-config <folder>]]

Without --analysis, writes the strip of a full in-place rotation of the
fake env. With --analysis, runs the value/distance analysis
(viz/panorama.py vis_panorama) at the fake env's start, each class given
one sampled reachable goal, scoring with the Q-net of --model-config (its
latest checkpoint) or else a seeded extra_capacity net, prints
`corr[<class>] = ...` for each class and writes the figure (the strip
over one Wistia value row a class, each cell's value in it, each row's
`<class> r=...` label in a left margin).
"""

from __future__ import annotations

import argparse
from typing import List, Optional

import torch

from ._device import resolve_device
from .core.checkpoint import latest_checkpoint_step
from .core.defaults import get_cfg_defaults
from .core.experiment import ExperimentConfig
from .data.png import save_png
from .eval.load import load_eval_model
from .eval.policy_config import get_eval_defaults
from .models.qnet import build_qnet, init_qnet
from .sim.fake_env import FakeNavEnv
from .sim.gibson import CLASS_LABELS
from .viz.panorama import make_allclass_scorer, panorama_strip, vis_panorama

MODEL_SEED = 0


def main(argv: Optional[List[str]] = None, device=None):
    """Write what `argv` (sys.argv when None) asks for, scoring on `device`
    (None: the card; raises without CUDA). Returns the strip, or with
    --analysis the per-class correlations."""
    parser = argparse.ArgumentParser(description="render a panorama strip (PyTorch port)")
    parser.add_argument("--out", default="panorama.png")
    parser.add_argument("--size", type=int, default=224)
    parser.add_argument("--rotations", type=int, default=12)
    parser.add_argument("--analysis", default="",
                        help="write the value/distance correlation figure here instead of "
                             "a plain strip; scores come from a seeded extra_capacity "
                             "Q-net unless --model-config is given")
    parser.add_argument("--model-config", default="",
                        help="experiment folder of a trained model to score the analysis "
                             "views (latest checkpoint)")
    args = parser.parse_args(argv)
    device = resolve_device(device)

    env = FakeNavEnv(image_size=args.size)
    env.reset(reachable=False)
    if not args.analysis:
        strip, _ = panorama_strip(env, num_rotations=args.rotations)
        save_png(args.out, strip)
        print(f"wrote {args.out} ({strip.shape})")
        return strip

    if args.model_config:
        mc = ExperimentConfig(args.model_config, resume=True)
        ec = get_eval_defaults()
        ec.MODEL_NUMBER = latest_checkpoint_step(mc.models_dir)
        model = load_eval_model(ec, mc, image_size=args.size, device=device)
    else:
        cfg = get_cfg_defaults()
        cfg.PANORAMA = False
        cfg.ARCHITECTURE = "extra_capacity"
        model = init_qnet(build_qnet(cfg, args.size, device="cpu"),
                          torch.Generator().manual_seed(MODEL_SEED))
    scorer = make_allclass_scorer(model, image_size=args.size, device=device)
    # each class gets a sampled reachable goal in the maze
    goals_by_class = [[env.sample_reachable_goal()] for _ in CLASS_LABELS]
    _, corrs = vis_panorama(env, scorer, goals_by_class, num=args.rotations,
                            class_names=CLASS_LABELS, out_path=args.analysis, probe_steps=4)
    for name, corr in zip(CLASS_LABELS, corrs):
        print(f"corr[{name}] = {corr:.3f}")
    print(f"wrote {args.analysis}")
    return corrs


if __name__ == "__main__":
    main()
