"""Frame-filter CLI of the port (counterpart of the root
dataset/extract_frames.py, with its flags): the Places365 AlexNet's indoor
probability and the detector's person flag over every frame under
--frames, smoothed into --out/<vid>_filters.npy, which process_episodes
reads. A video whose output exists is skipped (resume).

    python -m video_dqn_tpu_torch.extract_frames --frames <frames dir> \\
        --out <filter dir> --places-weights <alexnet_places365 .pth.tar> \\
        (--detector-weights <maskrcnn .pth> | --stub-detector)

Both models run on the card in bf16 (`main([...], device="cpu")` runs them
in float32 on the CPU). Without weights the pass would keep every frame,
so it refuses to run unless --allow-passthrough is given. -d/--dump, the
extraction of frames from video files, is not ported: it raises.
"""

from __future__ import annotations

import argparse
import sys
from typing import Dict, List, Optional

import numpy as np

from ._device import resolve_device
from .data.detect import StubDetector
from .data.filters import make_indoor_classifier, run_filter_pass
from .models.alexnet_places import load_alexnet_places
from .models.detector.inference import load_detector


def main(argv: Optional[List[str]] = None, device=None) -> Dict[str, str]:
    """Run the filter pass on `device` (None: the card; raises without
    CUDA) and return {video: filter npy written}."""
    parser = argparse.ArgumentParser(description="filter frames (PyTorch port)")
    parser.add_argument("-g", "--gpu", default="0", help="ignored (compat)")
    parser.add_argument("-d", "--dump", action="store_true",
                        help="dump frames from video files (not ported: raises)")
    parser.add_argument("--location", default="dataset/videos")
    parser.add_argument("--frames", default="dataset/frames")
    parser.add_argument("--out", default="dataset/filter_out")
    parser.add_argument("--places-weights", default="",
                        help="alexnet_places365 checkpoint (torchvision names)")
    parser.add_argument("--detector-weights", default="",
                        help="torchvision maskrcnn_resnet50_fpn checkpoint for the person filter")
    parser.add_argument("--stub-detector", action="store_true",
                        help="use the synthetic stub person detector (tests)")
    parser.add_argument("--allow-passthrough", action="store_true",
                        help="explicitly allow running WITHOUT filter weights "
                             "(marks every frame indoor/person-free)")
    args = parser.parse_args(argv)
    if args.dump:
        raise NotImplementedError(
            "--dump (frames from video files) is not ported to video_dqn_tpu_torch: it "
            "needs libavformat, libavcodec and libswscale (ROADMAP queue 1, item 9, "
            "frame extraction); extract the frames to <frames>/<vid>/%04d.jpg first")
    device = resolve_device(device)

    have_indoor = bool(args.places_weights)
    have_person = bool(args.detector_weights or args.stub_detector)
    if not (have_indoor and have_person) and not args.allow_passthrough:
        missing = []
        if not have_indoor:
            missing.append("--places-weights")
        if not have_person:
            missing.append("--detector-weights")
        sys.exit(
            "ERROR: filtering without " + " and ".join(missing) + " would "
            "silently keep every frame (no-op filter). Provide the weights "
            "(the Places365 release's alexnet_places365.pth.tar and a torchvision "
            "maskrcnn_resnet50_fpn checkpoint) or pass --allow-passthrough to run "
            "unfiltered on purpose.")

    if have_indoor:
        indoor = make_indoor_classifier(load_alexnet_places(args.places_weights, device),
                                        device=device)
    else:
        print("WARNING: --allow-passthrough and no --places-weights; "
              "treating all frames as indoor")
        indoor = lambda images: np.ones(len(images))  # noqa: E731

    if have_person:
        # person filter = the port's Mask R-CNN (score-sorted labels per
        # image feed filters.person_in_top5, reference :144-148)
        detector = (StubDetector() if args.stub_detector
                    else load_detector(args.detector_weights, device=device))

        def person(images):
            return [d["classes"][np.argsort(-d["scores"])] for d in detector(images)]
    else:
        print("WARNING: --allow-passthrough and no person detector; "
              "treating all frames as person-free")
        person = lambda images: [[] for _ in images]  # noqa: E731

    written = run_filter_pass(args.frames, args.out, indoor, person)
    print(f"filtered {len(written)} videos")
    return written


if __name__ == "__main__":
    main()
