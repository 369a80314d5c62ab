"""Diffusion model zoo of the port (ic / wc / lt / dic)."""
from repro_torch.diffusion.models import (DEFAULT_MODEL, DiffusionModel, EdgeParams,
                                          available_models, register_model, resolve)

__all__ = ["DEFAULT_MODEL", "DiffusionModel", "EdgeParams", "available_models",
           "register_model", "resolve"]
