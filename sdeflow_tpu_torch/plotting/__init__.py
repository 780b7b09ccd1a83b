"""Figures (port of sdeflow_tpu/plotting/): ``plots`` (a sweep's figures
and the numbers behind them) and ``lowrank`` (the block-rotation latent
dynamics). Importing them loads no matplotlib; the calls that draw do."""
