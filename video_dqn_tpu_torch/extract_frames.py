"""Frame CLI of the port (counterpart of the root dataset/extract_frames.py,
with its flags), in two modes.

-d/--dump extracts frames: every <id>.mp4 under --location, in sorted
order, demuxed and decoded by the host library and sampled at 0.5 fps, the
kept frames converted to RGB by the card's NV12 -> RGB kernel
(data/video.py), into --frames/<id>/%04d.jpg; an id whose frame folder
exists is skipped (resume). It prints `extracted N videos` and returns
without filtering, as the JAX CLI does.

    python -m video_dqn_tpu_torch.extract_frames -d --location <videos dir> \\
        --frames <frames dir>

`main(["-d", ...], device="cpu")` converts on the CPU.

Without -d it is the filter pass: the Places365 AlexNet's indoor
probability and the detector's person flag over every frame under
--frames, smoothed into --out/<vid>_filters.npy, which process_episodes
reads. A video whose output exists is skipped (resume).

    python -m video_dqn_tpu_torch.extract_frames --frames <frames dir> \\
        --out <filter dir> --places-weights <alexnet_places365 .pth.tar> \\
        (--detector-weights <maskrcnn .pth> | --stub-detector)

Both models run on the card in bf16 (`main([...], device="cpu")` runs them
in float32 on the CPU). Without weights the pass would keep every frame,
so it refuses to run unless --allow-passthrough is given.
"""

from __future__ import annotations

import argparse
import sys
from typing import Dict, List, Optional, Union

import numpy as np

from ._device import resolve_device
from .data.detect import StubDetector
from .data.filters import make_indoor_classifier, run_filter_pass
from .data.video import extract_all_frames
from .models.alexnet_places import load_alexnet_places
from .models.detector.inference import load_detector


def main(argv: Optional[List[str]] = None, device=None) -> Union[Dict[str, str], List[str]]:
    """On `device` (None: the card; raises without CUDA): with -d, extract
    the videos' frames and return the ids extracted; else run the filter
    pass and return {video: filter npy written}."""
    parser = argparse.ArgumentParser(description="filter frames (PyTorch port)")
    parser.add_argument("-g", "--gpu", default="0", help="ignored (compat)")
    parser.add_argument("-d", "--dump", action="store_true",
                        help="dump frames from the videos under --location (on the card) and stop")
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
        done = extract_all_frames(args.location, args.frames, 0.5, resolve_device(device))
        print(f"extracted {len(done)} videos")
        return done
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
