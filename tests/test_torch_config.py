"""The port's config reader against the JAX package's: the YAML subset
against PyYAML, the defaults key for key, and an experiment folder."""

import glob

import pytest
import yaml

from video_dqn_tpu.core import ExperimentConfig as JaxExperimentConfig
from video_dqn_tpu.core import get_cfg_defaults as jax_cfg_defaults
from video_dqn_tpu_torch.core.config import ConfigError, load_yaml
from video_dqn_tpu_torch.core.defaults import get_cfg_defaults
from video_dqn_tpu_torch.core.experiment import ExperimentConfig
from tests import torch_port_util  # noqa: F401  (caps torch threads per worker)

EXPERIMENTS = sorted(glob.glob("configs/experiments/*/config.yml"))


@pytest.mark.parametrize("path", EXPERIMENTS + ["configs/tasks/pointnav_rgbd.yml"])
def test_reads_the_repo_configs_as_pyyaml_does(path):
    text = open(path).read()
    assert load_yaml(text) == (yaml.safe_load(text) or {})


def test_reads_safe_dump_of_a_config_as_pyyaml_does():
    tree = {"DATASET": "/data/x.feather", "PANORAMA": False, "LEARNING_RATE": 0.0001,
            "TINY": 1e-10, "NUM_STEPS": 300000, "SEED": -1, "NOTE": "1e-4",
            "EMPTY": "", "QUOTE": "it's # here", "NONE": None, "WORD": "yes",
            "TPU": {"BATCH_SIZE": 8, "COMPUTE_DTYPE": "float32", "MESH_DATA": -1}}
    text = yaml.safe_dump(tree)
    assert load_yaml(text) == yaml.safe_load(text) == tree


@pytest.mark.parametrize("text", ["K: [1, 2]\n", "K: {A: 1}\n", "K:\n  - 1\n", "K: 0755\n",
                                  "K: &a 1\n", "K: a: b\n", "  K: 1\nL: 2\n"])
def test_refuses_what_is_outside_the_subset(text):
    with pytest.raises(ValueError):
        load_yaml(text)


def test_defaults_equal_the_jax_packages():
    assert get_cfg_defaults().to_dict() == jax_cfg_defaults().to_dict()


def test_experiment_folder_matches_the_jax_package(tmp_path):
    (tmp_path / "config.yml").write_text(open(EXPERIMENTS[0]).read() + "TPU:\n  BATCH_SIZE: 16\n")
    ours = ExperimentConfig(str(tmp_path))
    theirs = JaxExperimentConfig(str(tmp_path), tensorboard=False)
    assert ours.cfg.to_dict() == theirs.cfg.to_dict()
    assert ours.run_dir == theirs.run_dir.replace("run2", "run1")  # each made its own run
    assert ours.TPU.BATCH_SIZE == 16 and ours.models_dir == theirs.models_dir
    with pytest.raises(ConfigError):
        ours.cfg.SEED = 1


def test_merge_checks_keys_types_and_values(tmp_path):
    cfg = get_cfg_defaults()
    with pytest.raises(ConfigError, match="unknown"):
        cfg.merge_from_dict({"NO_SUCH_KEY": 1})
    with pytest.raises(ConfigError, match="type mismatch"):
        cfg.merge_from_dict({"LEARNING_RATE": "1e-4"})
    (tmp_path / "config.yml").write_text("LOSS_CLIP: 'bogus'\n")
    with pytest.raises(ConfigError, match="LOSS_CLIP"):
        ExperimentConfig(str(tmp_path))
