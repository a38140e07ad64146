"""video_dqn_tpu_torch — the PyTorch/CUDA port of video_dqn_tpu for an
NVIDIA H100.

The port imports torch and numpy only; it never imports jax or the JAX
package, which stays beside it as the reference. Public boundaries keep
the JAX package's layouts (uint8 NHWC views, (B, classes, actions) float32
Q-values) so that tests compare like with like; inside, tensors are NCHW
in channels_last memory format.

Layout:
  _device.py  resolve_device: CUDA unless the caller asks for the CPU
  _build.py   nvcc build of csrc/ into a shared library, loaded by ctypes
  csrc/       hand-written CUDA kernels for sm_90a
  ops/        ImageNet normalize; the fused uint8 resize+normalize kernel
  models/     ResNet18, the HabitatDQN Q-net, the Flax->torch weight bridge
  eval/       panorama scorers and the eval model loader
"""

__version__ = "0.1.0"
