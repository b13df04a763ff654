"""Checkpoint loading and the detection pipeline."""
