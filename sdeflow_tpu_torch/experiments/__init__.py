"""Experiment presets and the model factory."""
