"""The port's simulator datasets (data/sim_dataset.py) against the JAX
package's: the same walks in the furnished two-floor house (size_px 32)
and the fake env, 2 videos x 60 steps as tests/test_sim_dataset.py runs
them, give the same feather columns exactly (frame paths relative to the
output root) and the same 22-column pairs npy rows and split; every frame
the port writes equals PIL's file of the same render byte for byte (the
writer's stated bound is zero), so PIL decodes both to the same pixels;
and the written data feeds the port's batchers."""

import glob
import os

import numpy as np
import pytest

from video_dqn_tpu.data.schema import read_feather as jax_read_feather
from video_dqn_tpu.data.sim_dataset import generate_inverse_pairs as jax_pairs
from video_dqn_tpu.data.sim_dataset import generate_sim_dataset as jax_generate
from video_dqn_tpu.eval.fixtures import FakeHouse as JaxFakeHouse
from video_dqn_tpu.eval.fixtures import make_furnished_house as jax_house
from video_dqn_tpu.sim.fake_env import FakeNavEnv as JaxFakeNavEnv
from video_dqn_tpu_torch.data import sim_dataset
from video_dqn_tpu_torch.data.feather import read_feather
from video_dqn_tpu_torch.data.gibson_pairs import GibsonPairBatcher
from video_dqn_tpu_torch.data.qlearning import QLearningBatcher
from video_dqn_tpu_torch.data.schema import validate_schema
from video_dqn_tpu_torch.eval.fixtures import FakeHouse, make_furnished_house
from video_dqn_tpu_torch.sim.fake_env import FakeNavEnv
from tests import torch_port_util  # noqa: F401  (caps torch threads per worker)
from tests.torch_port_util import free_passed_tmp_path  # noqa: F401  (frees a passed test's tmp_path)

GOAL = (4.25, 0.0, 6.75)  # a free cell of the default maze, on the first walk


def envs(kind: str):
    """(jax env, jax house, port env, port house) of one kind, one seed."""
    if kind == "furnished":
        return (*jax_house(size_px=32, seed=0), *make_furnished_house(size_px=32, seed=0))
    return (JaxFakeNavEnv(image_size=32, seed=0), JaxFakeHouse(np.array(GOAL)),
            FakeNavEnv(image_size=32, seed=0), FakeHouse(np.array(GOAL)))


@pytest.fixture(scope="module", params=["furnished", "fake"])
def datasets(request, tmp_path_factory):
    root = tmp_path_factory.mktemp(f"simds_{request.param}")
    jenv, jhouse, env, house = envs(request.param)
    kw = dict(n_videos=2, steps_per_video=60, reward_dist=2.0, seed=0,
              floor=None if request.param == "furnished" else 0)
    want = jax_generate(jenv, jhouse, str(root / "jax"), **kw)
    got = sim_dataset.generate_sim_dataset(env, house, str(root / "port"), **kw)
    return root, want, got


def relative(values, root):
    return np.array([os.path.relpath(v, root) for v in values], object)


def test_feather_columns_equal_jax(datasets):
    root, want, got = datasets
    jax_df, cols = jax_read_feather(want), read_feather(got)
    validate_schema(cols)
    assert list(cols) == list(jax_df.columns)
    assert len(cols["before_image"]) > 50
    for name in jax_df.columns:
        a, b = jax_df[name].to_numpy(), cols[name]
        if name.endswith("_image"):
            a, b = relative(a, root / "jax"), relative(b, root / "port")
        elif a.dtype != object:
            assert a.dtype == b.dtype, name
        assert np.array_equal(a, b), name
    assert set(np.unique(cols["inverse_actions"])) <= {0, 1, 2}
    assert sum(cols[f"sparse_reward{k}"].sum() for k in range(5)) > 0


def test_frames_and_filters_equal_jax(datasets):
    root, _, _ = datasets
    want = sorted(glob.glob(str(root / "jax" / "frames" / "*" / "*.jpg")))
    got = sorted(glob.glob(str(root / "port" / "frames" / "*" / "*.jpg")))
    assert [os.path.relpath(p, root / "port") for p in got] == \
        [os.path.relpath(p, root / "jax") for p in want]
    assert len(got) == 120
    for a, b in zip(want, got):
        assert open(a, "rb").read() == open(b, "rb").read(), b
    for a in sorted(glob.glob(str(root / "jax" / "filter_out" / "*.npy"))):
        f = np.load(a, allow_pickle=True)[()]
        g = np.load(root / "port" / "filter_out" / os.path.basename(a), allow_pickle=True)[()]
        assert f.keys() == g.keys()
        for k in f:
            assert f[k].dtype == g[k].dtype and np.array_equal(f[k], g[k]), k


def test_feather_feeds_the_port_batcher(datasets, monkeypatch):
    root, _, got = datasets
    monkeypatch.chdir(root / "port")  # frame paths as written
    b = QLearningBatcher(got, one_action=True, value_learning=True, image_size=32, gamma=0.9)
    batch = b.get_batch(batch_size=8)
    assert batch["before"].shape == (8, 1, 32, 32, 3)


@pytest.mark.parametrize("kind", ["furnished", "fake"])
def test_inverse_pairs_equal_jax(tmp_path, kind):
    jenv, _, env, _ = envs(kind)
    want = jax_pairs(jenv, str(tmp_path / "jax"), n_walks=2, steps_per_walk=25, seed=0)
    got = sim_dataset.generate_inverse_pairs(env, str(tmp_path / "port"), n_walks=2,
                                             steps_per_walk=25, seed=0)
    assert os.path.relpath(got[2], tmp_path / "port") == os.path.relpath(want[2], tmp_path / "jax")
    for a, b in zip(want[:2], got[:2]):
        rows_a, rows_b = np.load(a, allow_pickle=True), np.load(b, allow_pickle=True)
        assert rows_a.shape == rows_b.shape and rows_a.shape[1] == 22
        for ra, rb in zip(rows_a, rows_b):
            assert [type(v) for v in ra] == [type(v) for v in rb]
            assert list(ra) == list(rb)
    states = sorted(glob.glob(os.path.join(want[2], "*", "0.jpg")))
    assert len(states) == 50
    for a in states:
        b = os.path.join(got[2], os.path.relpath(a, want[2]))
        assert open(a, "rb").read() == open(b, "rb").read(), b
    batcher = GibsonPairBatcher(got[0], image_root=got[2], image_size=32)
    assert set(np.unique(batcher.action)) <= {0, 1, 2}
    assert batcher.get_batch(batch_size=4)["before"].shape == (4, 1, 32, 32, 3)


def test_walk_without_pairs_raises(tmp_path):
    """Walks of one step give no pair: the port raises where the JAX
    package's assert would."""
    env, _ = make_furnished_house(size_px=16, seed=0)
    with pytest.raises(ValueError, match="22-column"):
        sim_dataset.generate_inverse_pairs(env, str(tmp_path), n_walks=1, steps_per_walk=1)
