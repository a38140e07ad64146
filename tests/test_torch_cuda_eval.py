"""The port's evaluation on the card, held to the same code on the CPU: a
reasoning stop's map delta, geodesic episodes step for step, the batched
runner's bf16 scores against a float32 forward of the same views, and in
the furnished house the host library's render against the numpy twin and
the evaluate CLI's served scores.

Marked `cuda`: without a CUDA device each test skips. This file imports
neither jax nor the JAX package, so it also runs where only the port is
installed:

    python -m pytest --noconftest -q tests/test_torch_cuda_eval.py
"""

import numpy as np
import pytest
import torch

from video_dqn_tpu_torch.core.disk_logger import DiskReader
from video_dqn_tpu_torch.eval.batched_runner import run_policy_batched
from video_dqn_tpu_torch.eval.evaluate import make_geodesic_scorer
from video_dqn_tpu_torch.eval.fixtures import make_episode_set, make_furnished_house
from video_dqn_tpu_torch.eval.policy_config import get_eval_defaults, name_from_config
from video_dqn_tpu_torch.eval.runner import run_policy
from video_dqn_tpu_torch.eval.scorer import make_multiclass_scorer
from video_dqn_tpu_torch.models.qnet import HabitatDQN, init_qnet
from video_dqn_tpu_torch.ops import resize_normalize as rn
from video_dqn_tpu_torch.ops.binning import observations_to_map_delta
from video_dqn_tpu_torch.ops.geometry import get_camera_matrix
from video_dqn_tpu_torch.sim.fake_env import FakeNavEnv
from video_dqn_tpu_torch.sim.mesh_twin import TwinMesh
from video_dqn_tpu_torch.sim.meshgen import furnished_house_mesh
# pytest puts tests/ on the path; `from tests import` could find another
# installed `tests` package on the card's machine
import torch_port_util  # noqa: F401  (caps torch threads per worker)

CELL_SHARE = 1e-4  # valid points allowed in another cell (expected 0)
SERVE_ATOL = 0.05  # bf16 served scores against a float32 card forward
MAP = 461


@pytest.fixture(autouse=True)
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: evaluation's default device is the card")


def panorama_stop(size=224, seed=0):
    """12 left-turn renders of the fake env at one pose, in cm, cleaned as
    the mapper cleans them, with some depths zeroed and pushed past 990 cm
    first, and their map poses."""
    env = FakeNavEnv(image_size=size, seed=seed)
    pos, ang = env.sample_start_state()
    env.set_agent_state(pos, ang)
    depths, locs = [], []
    for k in range(12):
        obs, _, _, _ = env.step(1)
        depths.append(obs["depth"][..., 0] * 1000.0)
        locs.append([MAP * 2.5 + k, MAP * 2.5 - k, env.angle])
    d = np.stack(depths).astype(np.float32)
    rng = np.random.default_rng(seed)
    d[rng.random(d.shape) < 0.02] = 0.0
    d[rng.random(d.shape) < 0.02] = 995.0
    d[d > 990] = np.nan
    d[d == 0] = np.nan
    return d, np.array(locs, np.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("tf32", [False, True])
def test_map_delta_on_the_card_matches_the_cpu(tf32):
    d, locs = panorama_stop()
    cam = get_camera_matrix(224, 224, 90)
    args = (cam, MAP, 125.0, (20.0, 125.0), 5.0, 0.0)
    want = observations_to_map_delta(torch.from_numpy(d), torch.from_numpy(locs), *args)
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = tf32
    try:
        # the poses stay on the host, as the mapper passes them
        got = observations_to_map_delta(torch.from_numpy(d).cuda(), torch.from_numpy(locs),
                                        *args)
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved
    assert got.device.type == "cuda" and got.dtype == torch.float32
    got, want = got.cpu().numpy(), want.numpy()
    valid = int(want.sum())
    assert valid > 0 and got.sum() == valid
    apart = int(np.abs(got - want).sum() // 2)
    print(f"{apart} of {valid} valid points in another cell")
    assert apart <= CELL_SHARE * valid


def geodesic_results(tmp_path, device, stop):
    cfg = get_eval_defaults()
    cfg.SLAM, cfg.SEED, cfg.STOP = True, 1, stop
    cfg.RESULT_LOCATION = str(tmp_path / str(device))
    episodes, env_factory, house_factory = make_episode_set(2, size=64, seed=4)
    run_policy(cfg, episodes, env_factory=env_factory, house_factory=house_factory,
               scorer_factory=lambda env, ci: make_geodesic_scorer(env), visualize_every=0,
               device=device)
    return DiskReader(str(tmp_path / str(device) / name_from_config(cfg))).data()


@pytest.mark.cuda
@pytest.mark.parametrize("stop", [True, False], ids=["step_logs", "spl"])
def test_geodesic_episodes_on_the_card_match_the_cpu(tmp_path, stop):
    want = geodesic_results(tmp_path, "cpu", stop)
    got = geodesic_results(tmp_path, None, stop)
    assert set(got) == set(want) == {0, 1}
    for k in want:
        if not stop:
            assert got[k] == want[k]
            continue
        assert len(got[k]) == len(want[k]) > 0
        for g, w in zip(got[k], want[k]):
            np.testing.assert_array_equal(g[0], w[0])
            assert list(g[1:]) == list(w[1:])


def fp32_scores(model, views, cls, size):
    """The scorer's function in float32 on the card: the plain resize
    twin, no autocast, no TF32."""
    x = torch.from_numpy(views).cuda()
    b, f = x.shape[:2]
    xn = rn.resize_normalize_reference(x.reshape((b * f,) + x.shape[2:]), size)
    xn = xn.permute(0, 2, 3, 1).reshape(b, f, size, size, 3)
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.no_grad():
            q = model(xn)
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved
    return q[torch.arange(b), torch.from_numpy(cls).cuda()].amax(-1).cpu().numpy()


@pytest.mark.cuda
def test_batched_runner_serves_bf16_scores_of_its_own_views(tmp_path):
    size = 224
    model = init_qnet(HabitatDQN(action_dim=3, extra_capacity=True, panorama=False,
                                 image_size=size), torch.Generator().manual_seed(4))
    scorer = make_multiclass_scorer(model, image_size=size)
    calls = []

    class Recorder:
        def dispatch(self, images, cls):
            views = np.array(images)[:, None]  # (B, F, H, W, 3)
            return views, np.array(cls), scorer.dispatch(images, cls)

        def gather(self, handle):
            images, cls, inner = handle
            scores = scorer.gather(inner)
            calls.append((images, cls, scores))
            return scores

        def __call__(self, images, cls):
            return self.gather(self.dispatch(images, cls))

    cfg = get_eval_defaults()
    cfg.SCORE, cfg.SLAM, cfg.SEED, cfg.RESULT_LOCATION = "model", True, 1, str(tmp_path)
    episodes, env_factory, house_factory = make_episode_set(3, size=size, seed=2,
                                                            fresh_envs=True)
    rn.LAUNCHES.clear()
    results = run_policy_batched(
        cfg, episodes, env_factory=lambda h, c: env_factory(h, None, c),
        house_factory=house_factory, scorer=Recorder(), class_index_of=True,
        max_concurrent=3, pipeline_depth=2)
    assert set(results) == {0, 1, 2}
    assert dict(rn.LAUNCHES) == {("identity", "bfloat16"): len(calls)} and len(calls) > 2
    for images, cls, scores in calls:
        assert scores.shape == (len(images),) and np.isfinite(scores).all()
        want = fp32_scores(model, images, cls, size)
        np.testing.assert_allclose(scores, want, rtol=0, atol=SERVE_ATOL)


@pytest.mark.cuda
def test_furnished_stop_renders_as_the_twin():
    """The host library's render of a 12-view stop in the furnished house
    against the numpy twin (chip_smoke.py phase 10 (a), at 48 px): depth
    within 1e-4, RGB within +-1 on more than 99.9% of the pixels, where a
    pixel on two coplanar faces may show either face."""
    env, _ = make_furnished_house(size_px=48, seed=4)
    pos, ang = env.sample_start_state(0)
    poses = np.array([[pos[0], pos[1] + env.camera_height, pos[2], ang + k * env.turn]
                      for k in range(1, 13)])
    depth, rgb = env.mesh.render(poses, 48, env.cam, env.max_depth)
    twin = TwinMesh(*furnished_house_mesh()[:3])
    t_depth, t_rgb, t_rgb2 = twin.render(poses, 48, env.cam, env.max_depth, tie_tol=1e-4)
    np.testing.assert_allclose(depth, t_depth, rtol=0, atol=1e-4)
    near = (np.abs(rgb.astype(int) - t_rgb).max(-1) <= 1) | \
        (np.abs(rgb.astype(int) - t_rgb2).max(-1) <= 1)
    assert near.mean() > 0.999


@pytest.mark.cuda
def test_furnished_cli_serves_bf16_scores_of_its_own_views(tmp_path, monkeypatch):
    """The evaluate CLI's batched path in the furnished house (phase 10 (c)
    at 64 px): one bf16 identity launch per fused score call, every served
    score within SERVE_ATOL of a float32 card forward of its own views, the
    SPLs on disk."""
    from video_dqn_tpu_torch import evaluate as evaluate_cli
    from video_dqn_tpu_torch.eval.policy_config import load_file

    size = 64
    monkeypatch.chdir(tmp_path)  # no evaluation/val_episodes.npy here
    model_dir = tmp_path / "model"
    model_dir.mkdir()
    (model_dir / "config.yml").write_text(
        f"ARCHITECTURE: 'basic'\nPANORAMA: False\nTPU:\n  IMAGE_SIZE: {size}\n")
    model = init_qnet(HabitatDQN(action_dim=3, extra_capacity=False, panorama=False,
                                 image_size=size), torch.Generator().manual_seed(4))
    torch.save({"model_state_dict": model.state_dict()}, tmp_path / "qnet.torch")
    (tmp_path / "e.yml").write_text(
        f"SCORE: 'model'\nSLAM: True\nSEED: 1\nMODEL_CONFIG_LOCATION: '{model_dir}'\n"
        f"PRETRAINED_MODEL_LOCATION: '{tmp_path / 'qnet.torch'}'\n"
        f"RESULT_LOCATION: '{tmp_path / 'results'}'\n")
    calls, models = [], []
    make_scorer = evaluate_cli.make_multiclass_scorer

    def recording(model, **kw):
        models.append(model)
        inner = make_scorer(model, **kw)

        class Recorder:
            def dispatch(self, images, cls):
                return np.array(images)[:, None], np.array(cls), inner.dispatch(images, cls)

            def gather(self, handle):
                views, cls, h = handle
                scores = inner.gather(h)
                calls.append((views, cls, scores))
                return scores

            def __call__(self, images, cls):
                return self.gather(self.dispatch(images, cls))

        return Recorder()

    monkeypatch.setattr(evaluate_cli, "make_multiclass_scorer", recording)
    rn.LAUNCHES.clear()
    mean = evaluate_cli.main([str(tmp_path / "e.yml"), "--furnished-env", "--workload", "2",
                              "--batched", "2", "--pipeline-depth", "2"])
    assert mean is not None and 0.0 <= mean <= 1.0
    cfg = load_file(str(tmp_path / "e.yml"))
    results = DiskReader(str(tmp_path / "results" / name_from_config(cfg))).data()
    assert sorted(results) == [0, 1]
    assert dict(rn.LAUNCHES) == {("identity", "bfloat16"): len(calls)} and len(calls) > 1
    for views, cls, scores in calls:
        assert scores.shape == (len(views),) and np.isfinite(scores).all()
        np.testing.assert_allclose(scores, fp32_scores(models[0], views, cls, size),
                                   rtol=0, atol=SERVE_ATOL)
