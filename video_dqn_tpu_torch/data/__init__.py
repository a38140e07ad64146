"""Batch sources of the trainer (counterpart of video_dqn_tpu/data): the
quadruplet feather's reader and schema, the JPEG stage, QLearningBatcher,
the device-resident table and its host twin over in-memory tables."""
