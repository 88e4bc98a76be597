from openviic_tpu_torch.data.instance import Instance, InstanceList
from openviic_tpu_torch.data.vocab import Vocab

__all__ = ["Instance", "InstanceList", "Vocab"]
