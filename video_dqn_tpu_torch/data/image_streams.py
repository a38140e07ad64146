"""Image-pair stream (counterpart of video_dqn_tpu/data/image_streams.py
`ImageStream`): an (N, K) array of image paths read row by row, or in
batches of uint8 (B, S, S, 3) stacks, one a column, through the port's
JPEG stage (data/jpeg.py `load_images`, the same transform for an item
and a batch)."""

from __future__ import annotations

from typing import Iterator, Tuple

import numpy as np

from .jpeg import load_images


class ImageStream:
    def __init__(self, path_pairs, image_size: int = 224):
        self.pairs = np.asarray(path_pairs)
        self.image_size = image_size

    def __len__(self) -> int:
        return len(self.pairs)

    def __getitem__(self, i: int) -> Tuple[np.ndarray, ...]:
        return tuple(load_images(self.pairs[i], self.image_size))

    def batches(self, batch_size: int = 8) -> Iterator[Tuple[np.ndarray, ...]]:
        """Tuples of (B, S, S, 3) uint8 stacks, one a column."""
        for i in range(0, len(self.pairs), batch_size):
            chunk = self.pairs[i:i + batch_size]
            yield tuple(load_images(chunk[:, c], self.image_size)
                        for c in range(self.pairs.shape[1]))
