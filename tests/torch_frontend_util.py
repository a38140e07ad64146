"""The dataset front end's test helpers, shared by the CPU parity tests,
the card tests and chip_smoke.py: seeded weights under the Places365
AlexNet's torchvision names and the ones chip_smoke.py phase 12 centres
on the fixture frames, the indoor probability in numpy, and the rule that
holds bf16 indoor probabilities against float32 ones (the card's in
phase 12, the JAX package's own in tests/test_torch_filters.py). Imports
torch, numpy and the port only (no jax, no JAX package), so that it also
runs where only the port is installed."""

import numpy as np
import torch

from video_dqn_tpu_torch.data.filters import indoor_mask_vector
from video_dqn_tpu_torch.models.alexnet_places import AlexNetPlaces365
from video_dqn_tpu_torch.ops.resize_normalize import resize_normalize

FC8 = "classifier.6"
TOP_K = 10
FRONT_SEED = 4  # the seed of chip_smoke.py phase 12's AlexNet weights

# bf16 indoor probabilities against float32 ones on the same weights and
# frames. The top-10 is a cut: where a frame's 10th and 11th classes lie
# within bf16's logit error, bf16 may take the 11th, and the indoor mass
# then moves by that class's probability (one indoor, the other not).
INDOOR_BF16_ATOL = 0.02  # every frame, over the classes bf16 took
# bf16 logits against float32's: about twice the largest error of the
# JAX package's bf16 model (0.0742) and of the card's (0.070-0.078)
BF16_LOGIT_ATOL = 0.15
# what the JAX package's own bf16 model does against its float32 model
# on phase 12's weights and front_batch(frames, 64) (held by
# tests/test_torch_filters.py test_jax_bf16_moves_near_ties): its largest
# move with the swaps, and its share of frames whose top-10 swapped
JAX_BF16_MAX_MOVE = 0.0323
JAX_BF16_SWAP_SHARE = 7 / 64


def seeded_alexnet_state_dict(seed: int = 0) -> dict:
    """Seeded weights under torchvision's AlexNet names: He-scaled kernels
    (so activations keep their scale through the ReLUs: the logits of a
    frame spread with a std of ~2.7 over the classes) and small biases.
    Float32 CPU tensors."""
    rng = np.random.default_rng(seed)
    sd = {}
    for name, v in AlexNetPlaces365().state_dict().items():
        shape = tuple(v.shape)
        if len(shape) >= 2:
            a = rng.standard_normal(shape) * np.sqrt(2.0 / np.prod(shape[1:]))
        else:
            a = 0.01 * rng.standard_normal(shape)
        sd[name] = torch.from_numpy(a.astype(np.float32))
    return sd


def softmax64(logits: np.ndarray) -> np.ndarray:
    """Softmax over the last axis, in float64."""
    z = np.asarray(logits, np.float64)
    p = np.exp(z - z.max(-1, keepdims=True))
    return p / p.sum(-1, keepdims=True)


def top_classes(scores: np.ndarray, k: int = TOP_K) -> np.ndarray:
    """Each row's k largest, by a stable descending sort (lax.top_k's
    order)."""
    return np.argsort(-np.asarray(scores), axis=-1, kind="stable")[:, :k]


def indoor_mass(probs: np.ndarray, top: np.ndarray, mask: np.ndarray) -> np.ndarray:
    """The indoor probability mass over the classes `top` names."""
    return (np.take_along_axis(probs, top, -1) * mask[top]).sum(-1)


def indoor_probabilities(logits: np.ndarray, mask: np.ndarray, k: int = TOP_K) -> np.ndarray:
    """The indoor classifier's function on (B, 365) logits, in float64:
    softmax, the top k by a stable descending sort, their indoor mass."""
    p = softmax64(logits)
    return indoor_mass(p, top_classes(p, k), mask)


def bf16_against_f32(l32: np.ndarray, lbf: np.ndarray, probs: np.ndarray,
                     mask: np.ndarray) -> dict:
    """bf16 indoor probabilities `probs` (from the bf16 logits `lbf`)
    against the float32 logits `l32` of the same frames, and the rule's
    breaches: the logits within BF16_LOGIT_ATOL; every frame within
    INDOOR_BF16_ATOL of the float32 mass over the top-10 classes bf16
    took; every frame that moves further than that from the float32
    probability one whose float32 10th and 11th logits lie within
    2 * BF16_LOGIT_ATOL (a near tie that bf16 may swap)."""
    l32 = np.asarray(l32, np.float64)
    p32 = softmax64(l32)
    top_bf, top_32 = top_classes(lbf), top_classes(l32)
    moved = np.abs(probs - indoor_probabilities(l32, mask))
    ranked = -np.sort(-l32, axis=-1)
    tie_gap = ranked[:, TOP_K - 1] - ranked[:, TOP_K]
    beyond = moved > INDOOR_BF16_ATOL
    out = {"logit_err_max": float(np.abs(lbf - l32).max()),
           "max": float(np.abs(probs - indoor_mass(p32, top_bf, mask)).max()),
           "max_with_swaps": float(moved.max()),
           "swapped_frames": int(sum(set(a) != set(b) for a, b in zip(top_bf, top_32))),
           "beyond_frames": int(beyond.sum()),
           "beyond_tie_gap_max": float(tie_gap[beyond].max()) if beyond.any() else 0.0}
    out["breaches"] = [name for name, ok in (
        ("logits", out["logit_err_max"] <= BF16_LOGIT_ATOL),
        ("probabilities", out["max"] <= INDOOR_BF16_ATOL),
        ("near_ties", out["beyond_tie_gap_max"] <= 2 * BF16_LOGIT_ATOL)) if not ok]
    return out


def indoor_bias(logits: np.ndarray, mask: np.ndarray, target: float = 0.5) -> float:
    """The shift of the indoor classes' logits (fc8's bias on them) that
    puts the median indoor probability of these logits at `target`, by
    bisection: random weights rank classes nearly alike for every frame,
    and without it most frames land on one side of 0.5."""
    lo, hi = -30.0, 30.0
    for _ in range(60):
        mid = (lo + hi) / 2
        if np.median(indoor_probabilities(logits + mid * mask, mask)) < target:
            lo = mid
        else:
            hi = mid
    return (lo + hi) / 2


def centred_state_dict(sd: dict, logits: np.ndarray, mask: np.ndarray) -> dict:
    """`sd` with fc8's indoor biases shifted by indoor_bias(logits, mask)."""
    out = dict(sd)
    out[f"{FC8}.bias"] = sd[f"{FC8}.bias"] + torch.from_numpy(
        (indoor_bias(logits, mask) * mask).astype(np.float32))
    return out


def centred_alexnet_state_dict(seed: int, frames: np.ndarray) -> dict:
    """seeded_alexnet_state_dict(seed) with fc8's indoor biases shifted so
    that the indoor probabilities of `frames` (uint8 (N, 224, 224, 3), a
    float32 CPU run) centre on 0.5: random weights rank the classes nearly
    alike for every frame, and without the shift every frame would fall on
    one side."""
    model = AlexNetPlaces365().eval()
    model.load_state_dict(seeded_alexnet_state_dict(seed))
    with torch.no_grad():
        logits = model(resize_normalize(torch.from_numpy(frames), 224)).numpy()
    return centred_state_dict(model.state_dict(), logits, indoor_mask_vector())


def front_batch(frames: np.ndarray, batch: int) -> np.ndarray:
    """`batch` frames: `frames`, then their mirror images, repeated."""
    return np.ascontiguousarray(np.resize(np.concatenate([frames, frames[:, :, ::-1]]),
                                          (batch,) + frames.shape[1:]))
