"""The port stands alone: it imports neither jax, flax nor the JAX package,
and its entry points run on the card unless the caller asks for the CPU."""

import pkgutil
import re
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

from video_dqn_tpu_torch.eval.load import load_eval_model
from video_dqn_tpu_torch.eval.scorer import make_model_scorer, make_multiclass_scorer
from video_dqn_tpu_torch.models.qnet import HabitatDQN, build_qnet

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "video_dqn_tpu_torch"
MODULES = sorted(
    m.name for m in pkgutil.walk_packages([str(PORT)], "video_dqn_tpu_torch."))
FORBIDDEN = re.compile(
    r"^\s*(import|from)\s+(jax|flax|optax)\b|\bvideo_dqn_tpu\.", re.MULTILINE)


def test_every_module_imports_with_jax_blocked():
    assert "video_dqn_tpu_torch.eval.scorer" in MODULES
    code = (
        "import importlib, sys\n"
        "for name in ('jax', 'flax', 'optax', 'video_dqn_tpu'):\n"
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
    files = [*PORT.rglob("*.py"), *PORT.rglob("*.cu"), ROOT / "chip_smoke.py"]
    assert len(files) > 10
    bad = [f"{f.relative_to(ROOT)}: {m.group(0).strip()}"
           for f in files for m in FORBIDDEN.finditer(f.read_text())]
    assert bad == []


def test_forbidden_pattern_spares_the_port_name():
    assert not FORBIDDEN.search("from video_dqn_tpu_torch.ops import image")
    assert FORBIDDEN.search("from video_dqn_tpu.ops import image")
    assert FORBIDDEN.search("import jax.numpy as jnp")


CFG = SimpleNamespace(VALUE_LEARNING=False, ONE_ACTION=False,
                      ARCHITECTURE="basic", PANORAMA=False, PREVIOUS_IMAGES=False,
                      PRETRAINED_MODEL_LOCATION="unused.torch")


@pytest.mark.parametrize("entry", [
    lambda: build_qnet(CFG),
    lambda: load_eval_model(CFG, CFG),
    lambda: make_model_scorer(HabitatDQN(panorama=False, image_size=64), 0),
    lambda: make_multiclass_scorer(HabitatDQN(panorama=False, image_size=64)),
], ids=["build_qnet", "load_eval_model", "make_model_scorer",
        "make_multiclass_scorer"])
def test_entry_points_need_cuda_by_default(monkeypatch, entry):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        entry()
