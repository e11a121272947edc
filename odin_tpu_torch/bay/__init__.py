"""Bayesian layer of the port: distributions, heads and the VAE."""
