"""Tensor ops of the port: ImageNet normalize and the fused resize+normalize kernel."""
