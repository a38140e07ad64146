"""video_dqn_tpu_torch — the PyTorch/CUDA port of video_dqn_tpu for an
NVIDIA H100.

The port imports torch and numpy only; it never imports jax or the JAX
package, which stays beside it as the reference. Public boundaries keep
the JAX package's layouts (uint8 NHWC views, (B, classes, actions) float32
Q-values) so that tests compare like with like; inside, tensors are NCHW
in channels_last memory format.

Layout:
  _device.py  resolve_device: CUDA unless the caller asks for the CPU
  _build.py   builds of csrc/ (nvcc) and csrc/host/ (c++) into shared
              libraries, loaded by ctypes
  csrc/       hand-written CUDA kernels for sm_90a; csrc/host/ the host
              library: the baseline JPEG decoder, the LZ4 frame decoder,
              the FMM solver and the fake env's raycaster
  ops/        ImageNet normalize; the fused uint8 resize+normalize kernel;
              depth geometry and binning into the map, morphology, FMM
  models/     ResNet18, the HabitatDQN Q-net, the weight and Adam-state
              bridge to and from the JAX package's Flax layout
  core/       config trees and the YAML subset, experiment folders,
              metrics.jsonl, sample<N>.ckpt in Flax's msgpack, host prefetch
  data/       the feather (Arrow IPC) reader, the JPEG stage, the
              QLearningBatcher, the device-resident dataset and its host twin
  train/      the double-DQN and inverse-model train steps and loops
  train_q_network.py, train_inverse_model.py, process_episodes.py  CLIs
  plan/       the occupancy mapper and the FMM planners
  sim/        the fake raycasting env and the Gibson house metadata
  eval/       panorama scorers, the eval model loader, the episode policy,
              its sequential and batched runners, fixtures and results
  evaluate.py, results.py  the eval CLIs
"""

__version__ = "0.1.0"
