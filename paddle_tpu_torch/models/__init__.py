"""Model families of the port (paddle_tpu/models counterparts)."""
from .gpt import GPTConfig, GPTForPretraining, GPTModel

__all__ = ["GPTConfig", "GPTForPretraining", "GPTModel"]
