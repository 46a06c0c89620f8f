"""Model families of the port: llama and moe."""
from .registry import ModelBundle, family_module, get_model, list_models

__all__ = ["ModelBundle", "family_module", "get_model", "list_models"]
