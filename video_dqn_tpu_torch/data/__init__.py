"""Batch sources of the trainer: the device-resident table and its host
twin (counterpart of video_dqn_tpu/data)."""
