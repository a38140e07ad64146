"""The port stands alone: it imports neither jax, flax, optax, scipy nor the
JAX package, nor PIL, cv2, matplotlib, imageio or tensorboardX (the card's
machine has none of them), and its entry points run on the card unless the
caller asks for the CPU."""

import pkgutil
import re
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

from video_dqn_tpu_torch.core.defaults import get_cfg_defaults
from video_dqn_tpu_torch.data.device_dataset import DeviceDataset
from video_dqn_tpu_torch.data.tables import synthetic_video_tables
from video_dqn_tpu_torch.eval.load import load_eval_model
from video_dqn_tpu_torch.eval.scorer import make_model_scorer, make_multiclass_scorer
from video_dqn_tpu_torch.models.qnet import HabitatDQN, build_qnet
from video_dqn_tpu_torch.data.episodes import make_inverse_labeler
from video_dqn_tpu_torch.models.inverse import InverseActionModel
from video_dqn_tpu_torch.process_episodes import main as process_episodes_cli
from video_dqn_tpu_torch.train.dqn import create_train_state, run_train
from video_dqn_tpu_torch.train.inverse import create_inverse_state, run_inverse_train
from video_dqn_tpu_torch.train_inverse_model import main as train_inverse_cli
from video_dqn_tpu_torch.train_q_network import main as train_cli
from video_dqn_tpu_torch.evaluate import main as evaluate_cli
from video_dqn_tpu_torch.results import main as results_cli
from video_dqn_tpu_torch.eval.batched_runner import run_policy_batched
from video_dqn_tpu_torch.eval.policy_config import get_eval_defaults
from video_dqn_tpu_torch.eval.runner import run_policy
from video_dqn_tpu_torch.plan.mapper import DepthMapperAndPlanner
from video_dqn_tpu_torch.models.detector.inference import load_detector
from video_dqn_tpu_torch.detect_real_videos import main as detect_cli
from video_dqn_tpu_torch.data.filters import make_indoor_classifier
from video_dqn_tpu_torch.extract_frames import main as extract_frames_cli
from video_dqn_tpu_torch.data.video import decode_frames, extract_all_frames
from video_dqn_tpu_torch.models.alexnet_places import AlexNetPlaces365, load_alexnet_places
from video_dqn_tpu_torch.viz.panorama import make_allclass_scorer
from video_dqn_tpu_torch.viz.value_map import build_value_maps
from video_dqn_tpu_torch.visualize_value import main as visualize_value_cli
from video_dqn_tpu_torch.visualize_panorama import main as visualize_panorama_cli
from tests import torch_port_util  # noqa: F401  (caps torch threads per worker)

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "video_dqn_tpu_torch"
MODULES = sorted(
    m.name for m in pkgutil.walk_packages([str(PORT)], "video_dqn_tpu_torch."))
BLOCKED = ("jax", "flax", "optax", "scipy", "PIL", "cv2", "matplotlib", "imageio",
           "tensorboardX")
FORBIDDEN = re.compile(
    rf"^\s*(import|from)\s+({'|'.join(BLOCKED)})\b|\bvideo_dqn_tpu\.", re.MULTILINE)
# the card's machine has no libav*: the port's C++ and CUDA sources include
# none of their headers (frame extraction demuxes and decodes on its own)
LIBAV_INCLUDE = re.compile(r'^\s*#\s*include\s*[<"](libav\w*|libswscale|libpostproc)/',
                           re.MULTILINE)


def test_every_module_imports_with_jax_blocked():
    for name in ("eval.scorer", "train.dqn", "data.device_dataset", "core.msgpack",
                 "core.checkpoint", "core.prefetch", "data.feather", "data.jpeg",
                 "data.qlearning", "data.schema", "train_q_network", "models.inverse",
                 "train.inverse", "data.gibson_pairs", "data.episodes", "data.detect",
                 "ops.scans", "train_inverse_model", "process_episodes", "core.watchdog",
                 "core.disk_logger", "ops.geometry", "ops.binning", "ops.morphology",
                 "ops.fmm", "plan.mapper", "plan.fmm_planner", "sim.interface",
                 "sim.gibson", "sim.native_render", "sim.fake_env", "eval.policy_config",
                 "eval.evaluate", "eval.runner", "eval.batched_runner", "eval.fixtures",
                 "eval.results", "evaluate", "results", "sim.config", "sim.ply",
                 "sim.meshgen", "sim.native_mesh", "sim.mesh_twin", "sim.mesh_env",
                 "models.detector.boxes", "models.detector.roi_align",
                 "models.detector.maskrcnn", "models.detector.convert",
                 "models.detector.inference", "detect_real_videos", "data.filters",
                 "data.sim_dataset", "models.alexnet_places", "extract_frames",
                 "data.png", "core.metrics", "viz", "viz.colormaps", "viz.value_map",
                 "viz.panorama", "viz.render_grid", "plan.visualize", "visualize_value",
                 "visualize_panorama", "data.mp4", "data.h264", "data.video", "ops.nv12"):
        assert f"video_dqn_tpu_torch.{name}" in MODULES
    code = (
        "import importlib, sys\n"
        f"for name in {BLOCKED + ('video_dqn_tpu',)!r}:\n"
        "    sys.modules[name] = None\n"
        f"for m in {MODULES!r}:\n"
        "    importlib.import_module(m)\n"
        "print('ok')\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def test_sources_name_no_jax():
    native = [*PORT.rglob("*.cu"), *PORT.rglob("*.cc"), *PORT.rglob("*.h")]
    files = [*PORT.rglob("*.py"), *native,
             ROOT / "chip_smoke.py", ROOT / "tests/torch_qdata.py",
             ROOT / "tests/torch_detector_util.py", ROOT / "tests/torch_frontend_util.py",
             ROOT / "tests/torch_video_fixture.py"]
    assert {"jpeg_decode.cc", "jpeg_encode.cc", "lz4_frame.cc", "fmm.cc", "raycast.cc",
            "mesh.cc", "resize_normalize.cu", "nms.cu", "nv12_rgb.cu", "mp4_demux.cc",
            "h264_decode.cc", "h264_tables.h", "mp4.py", "h264.py", "video.py",
            "nv12.py"} <= {f.name for f in files}
    assert len(files) > 10
    bad = [f"{f.relative_to(ROOT)}: {m.group(0).strip()}"
           for f in files for m in FORBIDDEN.finditer(f.read_text())]
    bad += [f"{f.relative_to(ROOT)}: {m.group(0).strip()}"
            for f in native for m in LIBAV_INCLUDE.finditer(f.read_text())]
    assert bad == []


def test_forbidden_pattern_spares_the_port_name():
    assert not FORBIDDEN.search("from video_dqn_tpu_torch.ops import image")
    assert FORBIDDEN.search("from video_dqn_tpu.ops import image")
    assert FORBIDDEN.search("import jax.numpy as jnp")
    assert FORBIDDEN.search("    from scipy.ndimage import gaussian_filter1d")
    for name in ("PIL", "cv2", "matplotlib", "imageio", "tensorboardX"):
        assert FORBIDDEN.search(f"    from {name} import x") and FORBIDDEN.search(f"import {name}")
    assert not FORBIDDEN.search("from .data.png import save_png  # PIL's pixels")
    assert LIBAV_INCLUDE.search("#include <libavcodec/avcodec.h>")
    assert LIBAV_INCLUDE.search('  # include "libswscale/swscale.h"')
    assert not LIBAV_INCLUDE.search('#include "h264_tables.h"')


CFG = SimpleNamespace(VALUE_LEARNING=False, ONE_ACTION=False,
                      ARCHITECTURE="basic", PANORAMA=False, PREVIOUS_IMAGES=False,
                      PRETRAINED_MODEL_LOCATION="unused.torch")
TRAIN_CFG = get_cfg_defaults()
TABLES = synthetic_video_tables(4, 4, 8)
EVAL_CFG = get_eval_defaults()


@pytest.mark.parametrize("entry", [
    lambda: build_qnet(CFG),
    lambda: load_eval_model(CFG, CFG),
    lambda: make_model_scorer(HabitatDQN(panorama=False, image_size=64), 0),
    lambda: make_multiclass_scorer(HabitatDQN(panorama=False, image_size=64)),
    lambda: create_train_state(TRAIN_CFG),
    lambda: DeviceDataset(TABLES, 2),
    lambda: run_train(TRAIN_CFG, batcher=object()),
    lambda: run_train(TRAIN_CFG),
    lambda: train_cli(["no_such_folder"]),
    lambda: create_inverse_state(image_size=64),
    lambda: run_inverse_train(object(), object(), "no_such_folder"),
    lambda: train_inverse_cli(["--train_data", "no_such.npy"]),
    lambda: make_inverse_labeler(InverseActionModel(64)),
    lambda: process_episodes_cli(["--location", "no_such_folder"]),
    lambda: DepthMapperAndPlanner(),
    lambda: run_policy(EVAL_CFG, episodes=[]),
    lambda: run_policy_batched(EVAL_CFG, [], None, None, None),
    lambda: evaluate_cli(["--fake-env", "no_such.yml"]),
    lambda: evaluate_cli(["--furnished-env", "--workload", "1", "no_such.yml"]),
    lambda: results_cli(["no_such.yml"]),
    lambda: load_detector("no_such.pth"),
    lambda: detect_cli(["--stub", "--location", "no_such_folder"]),
    lambda: make_indoor_classifier(AlexNetPlaces365()),
    lambda: load_alexnet_places("no_such.pth"),
    lambda: extract_frames_cli(["--frames", "no_such_folder", "--allow-passthrough"]),
    lambda: extract_frames_cli(["-d", "--location", "no_such_folder"]),
    lambda: decode_frames("no_such.mp4"),
    lambda: extract_all_frames("no_such_folder", "no_such_folder"),
    lambda: make_allclass_scorer(HabitatDQN(panorama=False, image_size=64)),
    lambda: build_value_maps(HabitatDQN(panorama=False, image_size=64), "no_such_folder",
                             False),
    lambda: visualize_value_cli(["no_such_folder", "--data-root", "no_such_folder"]),
    lambda: visualize_panorama_cli(["--size", "32"]),
], ids=["build_qnet", "load_eval_model", "make_model_scorer",
        "make_multiclass_scorer", "create_train_state", "DeviceDataset", "run_train",
        "run_train_from_config", "train_q_network_main", "create_inverse_state",
        "run_inverse_train", "train_inverse_model_main", "make_inverse_labeler",
        "process_episodes_main", "DepthMapperAndPlanner", "run_policy",
        "run_policy_batched", "evaluate_main", "evaluate_main_furnished", "results_main",
        "load_detector", "detect_real_videos_main", "make_indoor_classifier",
        "load_alexnet_places", "extract_frames_main", "extract_frames_dump", "decode_frames",
        "extract_all_frames", "make_allclass_scorer",
        "build_value_maps", "visualize_value_main", "visualize_panorama_main"])
def test_entry_points_need_cuda_by_default(monkeypatch, entry):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        entry()
