from openviic_tpu_torch.data.instance import Instance, InstanceList
from openviic_tpu_torch.data.vocab import Vocab, load_vocab

__all__ = ["Instance", "InstanceList", "Vocab", "load_vocab"]
