from openviic_tpu_torch.config.node import ConfigNode
from openviic_tpu_torch.config.loader import get_config

__all__ = ["ConfigNode", "get_config"]
