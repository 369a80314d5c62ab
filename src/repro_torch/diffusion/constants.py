"""Leaf constants of the diffusion model zoo."""

#: the default model everywhere: the historical weighted-cascade sampling
DEFAULT_MODEL = "wc"
