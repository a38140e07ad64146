"""The Mask R-CNN detector (ResNet-50 FPN) of the port: box ops with the
NMS kernel, ROIAlign, the model, torchvision checkpoints and the
detector behind the pipeline's and the eval fusion's contracts."""
