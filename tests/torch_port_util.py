"""Shared set-up of the port's tests, imported by every
tests/test_torch_*.py file (the card-only ones too, so it imports no jax at
module level).

Importing it caps torch's intra-op threads at the host's cores over the
number of pytest-xdist workers, so that the workers of a parallel run do
not each start a thread per core.

`qnet_pair` gives Q-nets with the same seeded weights in the JAX package
and in video_dqn_tpu_torch: the Flax trees come from the JAX package's
init_qnet, are filled with seeded numpy values (so that the BatchNorm and
bias mappings are exercised, not just identity stats), and reach the port
through its bridge. Only tests compose the two packages."""

import os

import numpy as np
import torch

from video_dqn_tpu_torch.models.bridge import qnet_state_dict_from_flax
from video_dqn_tpu_torch.models.qnet import HabitatDQN, head_hw

torch.set_num_threads(max(1, (os.cpu_count() or 1)
                          // int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))))


def randomize_tree(tree, rng):
    """Seeded values for a Flax (params or batch_stats) tree of numpy
    leaves: fan-in-scaled kernels, small biases, scales near 1 and
    positive variances."""
    out = {}
    for name, leaf in tree.items():
        if isinstance(leaf, dict):
            out[name] = randomize_tree(leaf, rng)
            continue
        shape = np.shape(leaf)
        if name == "kernel":
            v = rng.standard_normal(shape) / np.sqrt(np.prod(shape[:-1]))
        elif name == "scale":
            v = 1.0 + 0.1 * rng.standard_normal(shape)
        elif name == "var":
            v = rng.uniform(0.5, 1.0, shape)
        else:  # bias, mean
            v = 0.1 * rng.standard_normal(shape)
        out[name] = v.astype(np.float32)
    return out


def qnet_pair(extra_capacity, panorama, image_size, action_dim=3, seed=0):
    """(jax_model, params, batch_stats, port_model): float32 Q-nets with
    the same seeded weights; the port's on the CPU in eval mode."""
    import jax
    import jax.numpy as jnp

    from video_dqn_tpu.models.qnet import HabitatDQN as JaxHabitatDQN
    from video_dqn_tpu.models.qnet import init_qnet as jax_init_qnet

    jm = JaxHabitatDQN(action_dim=action_dim, extra_capacity=extra_capacity,
                       panorama=panorama, dtype=jnp.float32)
    params, stats = jax.device_get(
        jax_init_qnet(jm, jax.random.key(seed), image_size))
    rng = np.random.default_rng(seed)
    params, stats = randomize_tree(params, rng), randomize_tree(stats, rng)
    side = head_hw(image_size)
    sd = qnet_state_dict_from_flax(params, stats, extra_capacity,
                                   jm.num_frames, (side, side))
    pm = HabitatDQN(action_dim=action_dim, extra_capacity=extra_capacity,
                    panorama=panorama, image_size=image_size)
    pm.load_state_dict(sd, strict=True)
    return jm, params, stats, pm.eval()
