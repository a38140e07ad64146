"""Data and tensor parallelism over torch.distributed (counterpart of
video_dqn_tpu/parallel): the (data, model) mesh (mesh.py), the
parameters' partition rule (sharding.py) and the fleet launcher
(multihost.py)."""
