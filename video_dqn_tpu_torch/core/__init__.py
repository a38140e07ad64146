"""Config trees, experiment folders, metrics, checkpoints and the host
prefetch of the port's trainer (counterpart of video_dqn_tpu/core)."""
