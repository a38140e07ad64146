"""Shared set-up of the port's tests, imported by every
tests/test_torch_*.py file (the card-only ones too, so it imports no jax at
module level).

Importing it caps torch's intra-op threads at the host's cores over the
number of pytest-xdist workers, so that the workers of a parallel run do
not each start a thread per core.

`jax_native_libs` builds and loads the JAX package's native FMM and
raycaster for the parity tests that compare with them.

`qnet_pair` gives Q-nets with the same seeded weights in the JAX package
and in video_dqn_tpu_torch: the Flax trees come from the JAX package's
init_qnet, are filled with seeded numpy values (so that the BatchNorm and
bias mappings are exercised, not just identity stats), and reach the port
through its bridge. Only tests compose the two packages.

`free_passed_tmp_path` is an autouse fixture for the files whose tests
write checkpoints of a full-width trunk (about 180 MB each): imported into
such a file, it removes a passed test's tmp_path at teardown. pytest
otherwise keeps every tmp_path of a run, and of the two runs before it, so
that a whole run of the suite held over 8 GB of disk at its end. A test
that failed keeps its folder for inspection."""

import fcntl
import os
import shutil
import subprocess
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from video_dqn_tpu_torch.models.bridge import qnet_state_dict_from_flax
from video_dqn_tpu_torch.models.qnet import HabitatDQN, head_hw

torch.set_num_threads(max(1, (os.cpu_count() or 1)
                          // int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))))


@pytest.fixture(autouse=True)
def free_passed_tmp_path(request):
    failed_before = request.session.testsfailed
    yield
    # Teardown runs after the call's report, so a failure has been counted.
    path = (request.node.funcargs or {}).get("tmp_path")
    if path is not None and request.session.testsfailed == failed_before:
        shutil.rmtree(path, ignore_errors=True)


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


def jax_native_libs() -> None:
    """Build the JAX package's native FMM (native/fmm) and raycaster
    (native/simcore) once, under a lock the test workers share, and load
    them in this process. The JAX package builds them at first use without
    a lock and falls back to Python when a load fails, which in a fresh
    checkout can happen while another worker is still linking: its Python
    FMM then differs from the native one in the last bits, and the parity
    tests would compare against the fallback. Raises if a library will not
    load."""
    from video_dqn_tpu.ops import fmm
    from video_dqn_tpu.sim import native_render

    root = Path(__file__).resolve().parents[1]
    lock_dir = root / "video_dqn_tpu_torch" / "_build"
    lock_dir.mkdir(exist_ok=True)
    with open(lock_dir / "jax_native.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        for sub in ("fmm", "simcore"):
            subprocess.run(["make", "-s"], cwd=root / "native" / sub, check=True,
                           capture_output=True)
    for _ in range(20):  # a worker outside the lock may still be linking
        if fmm._lib is None:
            fmm._lib_tried = False
        if native_render._lib is None:
            native_render._tried = False
        if fmm._load_native() is not None and native_render.available():
            return
        time.sleep(0.5)
    raise RuntimeError("the JAX package's native FMM or raycaster did not load")
