"""Evaluation: the ELBO."""
