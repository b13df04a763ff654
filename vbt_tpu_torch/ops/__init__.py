"""Preprocess, postprocess and the CUDA NMS kernel's wrapper."""
