"""Detector evaluation (COCO AP on VOC ground truth); training is a later
slice."""
