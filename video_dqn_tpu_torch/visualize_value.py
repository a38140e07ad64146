"""Value-map CLI of the port (counterpart of the root visualize_value.py,
with the same flags):

    python -m video_dqn_tpu_torch.visualize_value <experiment folder>
        --data-root <grid folder> [--model-number N] [--out value_maps]
        [--resolution 1500] [--image-size 224]

Loads the experiment's Q-net from models/sample<N>.ckpt (the latest
without --model-number; written by either package), scores every cell of
the grid folder (`<row>-<col>-<orientation>.jpg`, viz/render_grid.py) on
the card and writes one viridis map a class and direction (0-3 and max)
as `<out>/<class>_<direction>.png`.
"""

from __future__ import annotations

import argparse
import os
from typing import List, Optional

from ._device import resolve_device
from .core.checkpoint import latest_checkpoint_step
from .core.experiment import ExperimentConfig
from .data.png import save_png
from .eval.load import load_eval_model
from .eval.policy_config import get_eval_defaults
from .sim.gibson import CLASS_LABELS
from .viz.value_map import build_value_maps, render_value_map


def main(argv: Optional[List[str]] = None, device=None) -> List[str]:
    """Render the maps that `argv` (sys.argv when None) asks for, scoring
    on `device` (None: the card; raises without CUDA). Returns the paths
    written."""
    parser = argparse.ArgumentParser(description="render value maps (PyTorch port)")
    parser.add_argument("config", help="experiment folder with config.yml")
    parser.add_argument("--data-root", required=True,
                        help="grid folder of row-col-orientation.jpg")
    parser.add_argument("--model-number", type=int, default=None)
    parser.add_argument("--out", default="value_maps")
    parser.add_argument("--resolution", type=int, default=1500)
    parser.add_argument("--image-size", type=int, default=224)
    args = parser.parse_args(argv)
    device = resolve_device(device)

    config = ExperimentConfig(args.config, resume=True)
    ecfg = get_eval_defaults()
    ecfg.MODEL_NUMBER = int(args.model_number or latest_checkpoint_step(config.models_dir))
    model = load_eval_model(ecfg, config, image_size=args.image_size, device=device)
    maps, agg, free = build_value_maps(
        model, args.data_root, panorama=bool(config.PANORAMA or config.PREVIOUS_IMAGES),
        resolution=args.resolution, image_size=args.image_size, device=device)
    os.makedirs(args.out, exist_ok=True)
    written = []
    for direct in [0, 1, 2, 3, "max"]:
        for i, label in enumerate(CLASS_LABELS):
            cur = agg[:, :, i] if direct == "max" else maps[direct][:, :, i]
            written.append(os.path.join(args.out, f"{label}_{direct}.png"))
            save_png(written[-1], render_value_map(cur, free))
    print(f"wrote {len(written)} maps to {args.out}")
    return written


if __name__ == "__main__":
    main()
