"""Reward-detection CLI of the port (counterpart of the root
dataset/detect_real_videos.py, with its flags): the detector over every
frame under <location>/frames -> <location>/frames/real_detections_raw.npy,
which process_episodes reads.

    python -m video_dqn_tpu_torch.detect_real_videos --location <dataset> \\
        (--weights <maskrcnn .pth> | --stub) [--batch 4] [--image-size 224]

--weights is a torchvision maskrcnn_resnet50_fpn checkpoint (either naming),
run on the card in bf16; --stub runs the deterministic stub detector.
Unlike the JAX CLI, which falls back to the stub with a warning, it
raises when given neither.
"""

from __future__ import annotations

import argparse
import os
from typing import List, Optional

from ._device import resolve_device
from .data.detect import StubDetector, run_detection_pass
from .models.detector.inference import load_detector


def main(argv: Optional[List[str]] = None, device=None) -> str:
    """Run the pass on `device` (None: the card; raises without CUDA) and
    return the path of the .npy it wrote."""
    parser = argparse.ArgumentParser(description="detect target objects (PyTorch port)")
    parser.add_argument("-g", "--gpu", default="0", help="ignored (compat)")
    parser.add_argument("--location", default="dataset")
    parser.add_argument("--batch", type=int, default=4)
    parser.add_argument("--stub", action="store_true",
                        help="use the synthetic stub detector")
    parser.add_argument("--weights", default="",
                        help="torchvision maskrcnn_resnet50_fpn checkpoint")
    parser.add_argument("--image-size", type=int, default=224,
                        help="detector input resolution")
    args = parser.parse_args(argv)
    device = resolve_device(device)
    if args.stub:
        detector = StubDetector()
    elif args.weights:
        detector = load_detector(args.weights, device=device)
    else:
        raise ValueError("detect_real_videos needs --weights (a torchvision "
                         "maskrcnn_resnet50_fpn checkpoint) or --stub")
    out = os.path.join(args.location, "frames", "real_detections_raw.npy")
    results = run_detection_pass(os.path.join(args.location, "frames"), detector,
                                 out_path=out, batch_size=args.batch,
                                 image_size=args.image_size)
    print(f"detected over {len(results)} videos -> {out}")
    return out


if __name__ == "__main__":
    main()
