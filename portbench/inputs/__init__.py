"""Inputs made from the seed: each cell's model weights and traffic."""
