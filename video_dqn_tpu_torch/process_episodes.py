"""Episode assembly CLI of the port (counterpart of the root
dataset/process_episodes_real.py:15-53): filters and detections under
--location -> <location>/data.feather.

    python -m video_dqn_tpu_torch.process_episodes --location <dataset> \\
        [--inverse-flax <models dir> | --inverse-model <.torch>] [--image-size 224]

The inverse-action labels come from `sample<N>.ckpt` files of either
package's inverse trainer (--inverse-flax, the JAX CLI's name, or its
alias --inverse-ckpt; the latest one is read) or from the reference's
`.torch` state dict
(--inverse-model); without either the feather has no inverse_actions
column. The labeler runs on the card in bf16 (the JAX CLI's model dtype);
on the CPU, which only a caller's device="cpu" selects, in float32.
"""

from __future__ import annotations

import argparse
from typing import List, Optional

import torch

from ._device import resolve_device
from .data.episodes import make_inverse_labeler, process_episodes
from .models.bridge import load_torch_state_dict
from .models.inverse import InverseActionModel
from .train.inverse import load_inverse_checkpoint


def main(argv: Optional[List[str]] = None, device=None) -> str:
    """Assemble the feather named by the flags in `argv` (sys.argv when
    None), labelling on `device` (None: the card; raises without CUDA).
    Returns the feather's path."""
    parser = argparse.ArgumentParser(description="process episodes (PyTorch port)")
    parser.add_argument("-g", "--gpu", default="0", help="ignored (compat)")
    parser.add_argument("--location", default="dataset")
    parser.add_argument("--inverse-model", default="",
                        help="the reference's inverse_model.torch state dict")
    parser.add_argument("--inverse-flax", "--inverse-ckpt", dest="inverse_ckpt", default="",
                        help="models dir of an inverse model trained by either package "
                             "(sample<N>.ckpt files; the latest is read)")
    parser.add_argument("--image-size", type=int, default=224,
                        help="inverse-labeler input resolution")
    args = parser.parse_args(argv)
    device = resolve_device(device)
    dtype = torch.bfloat16 if device.type == "cuda" else torch.float32

    model = None
    if args.inverse_ckpt:
        model = load_inverse_checkpoint(args.inverse_ckpt, image_size=args.image_size,
                                        device=device).model
    elif args.inverse_model:
        model = InverseActionModel(args.image_size)
        model.load_state_dict(load_torch_state_dict(args.inverse_model), strict=True)
    else:
        print("WARNING: no --inverse-model; feather will lack inverse_actions")
    labeler = None if model is None else make_inverse_labeler(model, dtype=dtype, device=device)
    out = process_episodes(args.location, inverse_labeler=labeler, image_size=args.image_size)
    print(f"wrote {out}")
    return out


if __name__ == "__main__":
    main()
