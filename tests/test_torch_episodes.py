"""The port's dataset assembly against the JAX package's on the CPU: the
reward scans, valid-frame ranges, the feather writer, and process_episodes
with inverse-action labels, on the episode fixture of tests/torch_qdata.py
(links to the committed frames, seeded detections and filters)."""

import numpy as np
import pandas as pd
import pytest
import torch

import jax.numpy as jnp

from video_dqn_tpu.data import episodes as jax_episodes
from video_dqn_tpu.data import qlearning as jax_qlearning
from video_dqn_tpu.data.detect import score_vals as jax_score_vals
from video_dqn_tpu.data.qlearning import QLearningBatcher as JaxBatcher
from video_dqn_tpu.models.inverse import InverseActionModel as JaxInverse
from video_dqn_tpu.ops.scans import label_video_host as jax_label_video_host
from video_dqn_tpu_torch import process_episodes as process_cli
from video_dqn_tpu_torch.data import jpeg
from video_dqn_tpu_torch.data.detect import score_vals
from video_dqn_tpu_torch.data.episodes import (assemble_episodes, make_inverse_labeler,
                                               process_episodes, valid_frame_ranges)
from video_dqn_tpu_torch.data.feather import read_feather, write_feather
from video_dqn_tpu_torch.data.qlearning import QLearningBatcher
from video_dqn_tpu_torch.models.bridge import inverse_state_dict_from_flax
from video_dqn_tpu_torch.ops.scans import label_video_host
from video_dqn_tpu_torch.train.inverse import create_inverse_state, flax_state_dict
from video_dqn_tpu_torch.core.checkpoint import save_checkpoint
from tests import torch_qdata
from tests.test_torch_inverse import flax_vars, port_model

SIZE = 128
MARGIN = 1e-3  # labels are compared where the float32 calibrated margin is this wide
LABELS = ("action", "reward", "terminal", "gt", "valid_mask")

pytestmark = pytest.mark.filterwarnings("ignore::FutureWarning")


def reward_matrices():
    """200 seeded (N, 5) reward matrices of a few lengths: sparse, dense,
    all zero, all one, and a single hit."""
    rng = np.random.default_rng(0)
    out = []
    for k in range(200):
        n = (1, 2, 9, 33)[k % 4]
        kind = k // 4 % 5
        if kind == 0:
            r = np.zeros((n, 5), np.int64)
        elif kind == 1:
            r = np.ones((n, 5), np.int64)
        elif kind == 2:
            r = np.zeros((n, 5), np.int64)
            r[rng.integers(n), rng.integers(5)] = 1
        else:
            r = (rng.random((n, 5)) < (0.1 if kind == 3 else 0.5)).astype(np.int64)
        out.append(r)
    return out


def test_scans_are_bit_equal_to_jax():
    for r in reward_matrices():
        got, want = label_video_host(r), jax_label_video_host(r)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype == np.float32 and g.shape == r.shape
            np.testing.assert_array_equal(g, w)
    fwd, neg = label_video_host(np.array([[0], [1], [0], [0], [1], [0]]))
    np.testing.assert_array_equal(fwd[:, 0], [1, 0, 2, 1, 0, np.inf])
    np.testing.assert_array_equal(neg[:, 0], [1, 0, -1, 1, 0, -1])  # a tie goes earlier


def test_score_vals_and_ranges_match_jax():
    rng = np.random.default_rng(1)
    for _ in range(20):
        arr = torch_qdata._detections(rng)
        np.testing.assert_array_equal(score_vals(arr), jax_score_vals(arr))
    indoor, person = [1, 2, 3, 5, 6, 7, 8, 9, 12], [7]
    exists = lambda i: i != 3  # noqa: E731
    assert valid_frame_ranges(12, indoor, person, exists) == \
        jax_episodes.valid_frame_ranges(12, indoor, person, exists) == [(1, 3), (5, 7), (8, 10),
                                                                        (12, 13)]


@pytest.fixture(scope="module")
def episodes(tmp_path_factory):
    return torch_qdata.make_episodes(tmp_path_factory.mktemp("episodes"), videos=3, frames=40)


def test_process_episodes_matches_jax(episodes, monkeypatch, tmp_path):
    """data.feather with inverse-action labels from the same float32 model,
    both labellers decoding with the port's JPEG stage: pandas reads the
    port's file as JAX's frame (dtypes too), labels equal where the margin
    is at least MARGIN, and the port's reader and batcher read it as they
    read JAX's."""
    params, stats = flax_vars(SIZE)
    monkeypatch.setattr(jax_qlearning, "load_images", jpeg.load_images)
    jax_out = jax_episodes.process_episodes(
        episodes, inverse_labeler=jax_episodes.make_inverse_labeler(
            JaxInverse(dtype=jnp.float32), params, stats, batch_size=16), image_size=SIZE)
    want = pd.read_feather(jax_out)
    jax_file = tmp_path / "jax.feather"
    want.to_feather(jax_file)

    labeler = make_inverse_labeler(port_model(SIZE, params, stats), batch_size=16,
                                   dtype=torch.float32, device="cpu")
    out = process_episodes(episodes, inverse_labeler=labeler, image_size=SIZE)
    got = pd.read_feather(out)
    assert len(got) > 60 and got["ep_id"].nunique() == 3
    assert list(got.columns)[-1] == "inverse_actions" and got.columns.equals(want.columns)
    pd.testing.assert_frame_equal(got.drop(columns="inverse_actions"),
                                  want.drop(columns="inverse_actions"))
    assert got["inverse_actions"].dtype == want["inverse_actions"].dtype == np.int64

    logits = labeler.logits_rows(list(got["before_image"]), list(got["after_image"]), SIZE)
    top2 = np.sort(logits, axis=1)[:, -2:]
    wide = top2[:, 1] - top2[:, 0] >= MARGIN
    print(f"{int((~wide).sum())} of {len(wide)} rows within {MARGIN} of a tie")
    assert wide.mean() > 0.9
    np.testing.assert_array_equal(got["inverse_actions"][wide], want["inverse_actions"][wide])
    assert len(set(got["inverse_actions"])) > 1

    mine, theirs = read_feather(out), read_feather(str(jax_file))
    assert list(mine) == list(theirs)
    for name in mine:
        if name != "inverse_actions":
            assert mine[name].dtype == theirs[name].dtype
            np.testing.assert_array_equal(mine[name], theirs[name])
    port_b = QLearningBatcher(out, inverse_actions=True, seed=4)
    ref_b = JaxBatcher(out, inverse_actions=True, seed=4)
    for k in LABELS:
        np.testing.assert_array_equal(getattr(port_b, k), getattr(ref_b, k), err_msg=k)
    assert port_b.reward_percentage() == ref_b.reward_percentage()
    mine, theirs = port_b.index_stream(8), ref_b.index_stream(8)
    for _ in range(2 * len(ref_b) // 8 + 1):
        np.testing.assert_array_equal(next(mine), next(theirs))


def test_assemble_callable_labeler_and_empty(episodes, tmp_path):
    """A plain (before, after) callable labels each decoded pair as the
    table path does; a dataset without ranges writes an empty feather."""
    labeler = make_inverse_labeler(port_model(64, *flax_vars(64)), batch_size=32,
                                   dtype=torch.float32, device="cpu")
    kwargs = dict(filters_dir=f"{episodes}/filter_out", frames_root=f"{episodes}/frames",
                  image_size=64)
    detections = np.load(f"{episodes}/frames/real_detections_raw.npy", allow_pickle=True)[()]
    detections = {vid: detections[vid] for vid in ("vid00", "vid03")}
    table = assemble_episodes(detections, inverse_labeler=labeler, **kwargs)
    pairwise = assemble_episodes(detections, inverse_labeler=labeler.__call__, inverse_batch=7,
                                 **kwargs)
    np.testing.assert_array_equal(table["inverse_actions"], pairwise["inverse_actions"])
    assert assemble_episodes({"vid03": {}}, **kwargs) == {}
    write_feather({}, str(tmp_path / "empty.feather"))
    assert pd.read_feather(tmp_path / "empty.feather").shape == (0, 0)


def test_cli_labels_from_either_checkpoint_kind(episodes, tmp_path, capsys):
    """--inverse-ckpt (a sample<N>.ckpt) and --inverse-model (a reference
    .torch state dict) of the same weights write the same feather; without
    either, the JAX CLI's warning and no inverse_actions."""
    state = create_inverse_state(image_size=64, device="cpu")
    state.model.load_state_dict(inverse_state_dict_from_flax(*flax_vars(64), 64))
    save_checkpoint(str(tmp_path / "models"), 3, flax_state_dict(state))
    torch.save(state.model.state_dict(), tmp_path / "inverse_model.torch")
    base = ["--location", episodes, "--image-size", "64"]
    out = process_cli.main([*base, "--inverse-ckpt", str(tmp_path / "models")], device="cpu")
    from_ckpt = read_feather(out)
    out = process_cli.main([*base, "--inverse-model", str(tmp_path / "inverse_model.torch")],
                           device="cpu")
    from_torch = read_feather(out)
    np.testing.assert_array_equal(from_ckpt["inverse_actions"], from_torch["inverse_actions"])
    process_cli.main(base, device="cpu")
    assert "WARNING: no --inverse-model" in capsys.readouterr().out
    assert "inverse_actions" not in read_feather(out)


def test_cli_takes_the_jax_clis_inverse_flax_flag(episodes, tmp_path, monkeypatch):
    """The JAX CLI's command line, flag for flag: --inverse-flax names the
    models dir there (its parse and what it hands on are recorded, the
    labelling stubbed) and here, where it writes the feather that its
    alias --inverse-ckpt writes."""
    import importlib.util
    import sys
    from pathlib import Path
    from types import SimpleNamespace

    from video_dqn_tpu.data import episodes as jax_episodes_mod
    from video_dqn_tpu.train import inverse as jax_inverse

    state = create_inverse_state(image_size=64, device="cpu")
    state.model.load_state_dict(inverse_state_dict_from_flax(*flax_vars(64), 64))
    save_checkpoint(str(tmp_path / "models"), 3, flax_state_dict(state))
    argv = ["--location", episodes, "--inverse-flax", str(tmp_path / "models"),
            "--image-size", "64"]
    seen = []
    monkeypatch.setattr(jax_inverse, "load_inverse_checkpoint",
                        lambda path, image_size: seen.append((path, image_size)) or
                        (None, SimpleNamespace(params=None, batch_stats=None)))
    monkeypatch.setattr(jax_episodes_mod, "make_inverse_labeler", lambda *a: "labeler")
    monkeypatch.setattr(jax_episodes_mod, "process_episodes",
                        lambda location, inverse_labeler, image_size:
                        seen.append((location, inverse_labeler, image_size)) or "stub")
    path = Path(__file__).resolve().parents[1] / "dataset" / "process_episodes_real.py"
    spec = importlib.util.spec_from_file_location("jax_process_episodes_cli", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    monkeypatch.setattr(sys, "argv", ["process_episodes_real.py", *argv])
    module.main()
    assert seen == [(str(tmp_path / "models"), 64), (episodes, "labeler", 64)]
    flax = read_feather(process_cli.main(argv, device="cpu"))
    alias = read_feather(process_cli.main(
        [a if a != "--inverse-flax" else "--inverse-ckpt" for a in argv], device="cpu"))
    assert "inverse_actions" in flax and flax.keys() == alias.keys()
    for k in flax:
        np.testing.assert_array_equal(flax[k], alias[k])
