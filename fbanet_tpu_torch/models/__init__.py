from torch import nn

from fbanet_tpu_torch.config import ModelConfig
from fbanet_tpu_torch.models.fbanet import FBANet, create_model, init_parameters


def count_parameters(model: nn.Module) -> int:
    """Total parameter count."""
    return sum(p.numel() for p in model.parameters())


# Arch registry with the reference's naming ("BaseModel" -> FBANet)
ARCHS = {"BaseModel": create_model}

__all__ = ["ModelConfig", "FBANet", "create_model", "init_parameters", "ARCHS",
           "count_parameters"]
