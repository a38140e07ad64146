"""Evaluation side of the port: panorama scorers and the eval model loader."""
