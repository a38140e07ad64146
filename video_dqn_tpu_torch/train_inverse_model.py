"""Inverse-action model training CLI of the port (counterpart of the root
train_inverse_model.py:10-71):

    python -m video_dqn_tpu_torch.train_inverse_model --train_data <npy> \\
        --val_data <npy> --image_root <dir> [--cache-images] ...

The flags are the JAX CLI's; --gpu is accepted and ignored. Checkpoints
(`sample<N>.ckpt`, read by either package) and `metrics.jsonl` go to
--out_dir, or inverse_model_runs/<logdir>. The last line is the JAX CLI's
`Final val accuracy: ...`, the mean accuracy of 10 validation batches.

As JAX's CLI takes every local device, on more than one card the CLI
spawns one NCCL rank a card over a localhost store (parallel/multihost.py)
and trains data-parallel (train/inverse.py run_inverse_train); a device
named, one card or the CPU runs one rank in this process. Every rank draws
the same rows from the same seeds; the final validation batches are split
over the ranks as run_inverse_train's are. Only rank 0 makes --out_dir,
writes the metrics and the checkpoints, and prints the final accuracy.
"""

from __future__ import annotations

import argparse
from typing import List, Optional

import numpy as np
import torch

from ._device import resolve_device
from .core.metrics import MetricsWriter
from .data.gibson_pairs import GibsonPairBatcher
from .parallel import multihost
from .parallel.mesh import make_mesh, shard_batch
from .train.inverse import make_inverse_eval, run_inverse_train, to_device

COMPUTE_DTYPE = torch.bfloat16  # the JAX CLI's model dtype


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    """The JAX CLI's flags (sys.argv when `argv` is None)."""
    parser = argparse.ArgumentParser(description="train inverse-action model (PyTorch port)")
    parser.add_argument("--train_data", default="data/inverse_model/medium_inverse_train_data.npy")
    parser.add_argument("--backbone-weights", default="",
                        help="torchvision resnet18 state dict for the frozen trunk")
    parser.add_argument("--val_data", default="data/inverse_model/medium_inverse_val_data.npy")
    parser.add_argument("--image_root", default="", help="root for state image folders")
    parser.add_argument("--lr", type=float, default=0.001)
    parser.add_argument("--lr_decay", type=float, default=0.9)
    parser.add_argument("--lr_decay_every", type=float, default=1.0,
                        help="decay interval in epochs")
    parser.add_argument("--weight_decay", type=float, default=0.0)
    parser.add_argument("--batch_size", type=int, default=128)
    parser.add_argument("--num_steps", type=int, default=20000)
    parser.add_argument("--gpu", type=int, default=0, help="ignored (compat)")
    parser.add_argument("--logdir", default="runs_gibson_wd=0")
    parser.add_argument("--out_dir", default="",
                        help="checkpoint/metrics dir (overrides "
                             "inverse_model_runs/<logdir>)")
    parser.add_argument("--image_size", type=int, default=224)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--cache-images", action="store_true",
                        help="keep decoded state images in RAM across epochs")
    return parser.parse_args(argv)


def main(argv: Optional[List[str]] = None, device=None, validate_every: int = 100,
         val_batches: int = 25):
    """Train with the flags in `argv` (sys.argv when None) on `device`
    (None: the card, or every card where there are several; raises
    without CUDA), validating every `validate_every` steps over
    `val_batches` batches (run_inverse_train's defaults, which the JAX CLI
    does not expose). Returns (the state, the final validation accuracy)
    where this process runs the one rank, None where it spawned its
    ranks."""
    args = parse_args(argv)
    if device is None and torch.cuda.device_count() > 1:
        return multihost.initialize(f"127.0.0.1:{multihost.free_port()}", 1, 0, "native",
                                    torch.cuda.device_count(), _rank_fn,
                                    (args, validate_every, val_batches))
    return _rank_fn(resolve_device(device), args, validate_every, val_batches)


def _rank_fn(device, args, validate_every: int, val_batches: int):
    """One rank's run: the batchers, run_inverse_train (the metrics writer
    on rank 0 only) and the final accuracy over 10 validation batches.
    Returns (the state, that accuracy)."""
    primary = multihost.is_primary()
    pair_kwargs = dict(image_root=args.image_root, image_size=args.image_size,
                       seed=args.seed, cache_images=args.cache_images)
    train_b = GibsonPairBatcher(args.train_data, **pair_kwargs)
    val_b = GibsonPairBatcher(args.val_data, **pair_kwargs)
    steps_per_epoch = max(1, len(train_b) // args.batch_size)
    out_dir = args.out_dir or f"inverse_model_runs/{args.logdir}"
    writer = MetricsWriter(out_dir) if primary else None
    try:
        state = run_inverse_train(
            train_b, val_b, out_dir=out_dir, writer=writer, batch_size=args.batch_size,
            num_steps=args.num_steps, validate_every=validate_every, val_batches=val_batches,
            lr=args.lr, lr_decay=args.lr_decay,
            decay_every_steps=int(args.lr_decay_every * steps_per_epoch),
            weight_decay=args.weight_decay, image_size=args.image_size, dtype=COMPUTE_DTYPE,
            seed=args.seed, backbone_weights=args.backbone_weights, device=device)
    finally:
        if writer is not None:
            writer.close()
    eval_fn = make_inverse_eval(COMPUTE_DTYPE)
    mesh = make_mesh()
    accs = []
    for _ in range(10):
        batch = shard_batch(mesh, val_b.get_batch(batch_size=min(args.batch_size, len(val_b))))
        accuracy = eval_fn(state.model, to_device(batch, device))[1].reshape(1)
        mesh.mean_over_data([accuracy])
        accs.append(float(accuracy))
    accuracy = float(np.mean(accs))
    if primary:
        print(f"Final val accuracy: {accuracy:.4f}")
    return state, accuracy


if __name__ == "__main__":
    main()
