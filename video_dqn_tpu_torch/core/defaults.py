"""Training-config defaults, key for key and value for value those of
video_dqn_tpu/core/defaults.py, TPU section included, so that the same
`config.yml` means the same run in both packages. The TPU section's name
and keys stay: they are the config's interface. Keys whose behaviour the
port does not have yet are refused by train/dqn.py `run_train`."""

from .config import ConfigNode

# Allowed values, checked at experiment load
VALID_VALUES = {"LOSS_CLIP": ["sigmoid", "rect", "none"]}


def get_cfg_defaults() -> ConfigNode:
    return ConfigNode(
        {
            "PANORAMA": True,
            "SEED": 0,
            "TRAIN_ON_GROUND_TRUTH": False,
            "DATASET": "none",
            "SUB_DATASET": "none",
            "CLASS_LABEL": "toilet",
            # 'rect' clamps Bellman targets to [0, 1]; 'sigmoid' is
            # accepted and, as in the reference, leaves the loss as it is
            "LOSS_CLIP": "none",
            "ARCHITECTURE": "basic",  # 'basic' | 'extra_capacity'
            "RANDOM_ACTIONS": False,
            "ONE_ACTION": False,
            "SEMANTIC_REWARDS": False,
            "DETECTION_REWARDS": False,
            "REMOVE_BEFORE_REWARD": False,
            "USE_INVERSE_ACTIONS": False,
            "VALUE_LEARNING": False,
            "PREVIOUS_IMAGES": False,
            "GAMMA": 0.9,
            "BOOTSTRAP": False,
            "BOOTSTRAP_LOCATION": "",
            "LINEAR": False,
            "LEARNING_RATE": 1e-3,
            "NUM_STEPS": int(1e5),
            "TARGET_UPDATE_INTERVAL": int(8e3),
            "CHECKPOINT_INTERVAL": int(2e3),
            "ACTION_HIDDEN_LAYERS": 1,
            "GUMBEL_TEMP": 0.1,
            "CONFIDENCE_REWARD": False,
            "DISTRIBUTIONAL": False,
            "KL_BACKWARDS": False,
            "LOG_SIGMA": False,
            "VISUALIZATION_DATA_ROOT": "",
            # torchvision resnet18 state dict for the trunk; empty: random
            "BACKBONE_WEIGHTS": "",
            "TPU": ConfigNode(
                {
                    "BATCH_SIZE": 256,
                    "COMPUTE_DTYPE": "bfloat16",  # params stay float32
                    "MESH_DATA": -1,
                    "MESH_MODEL": 1,
                    "REMAT": False,
                    "PREFETCH_DEPTH": 2,         # host-fed batches in flight
                    "IMAGE_SIZE": 224,
                    "DECODE_WORKERS": 0,
                    "DECODE_CACHE_MB": 0,
                    "DEVICE_DATASET": False,     # the frame table in device memory
                    "DEVICE_SAMPLING": "epoch",  # 'epoch' | 'uniform'
                    "SHARD_DATASET": False,
                    "SCAN_CHUNK": 0,
                    "STALL_TIMEOUT_S": 0,
                    "STALL_FIRST_TIMEOUT_S": 0,
                }
            ),
        }
    )
