"""The double-DQN trainer (counterpart of video_dqn_tpu/train)."""
