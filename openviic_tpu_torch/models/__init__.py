"""Model zoo of the port; importing it registers every class."""

from openviic_tpu_torch.models import (  # noqa: F401
    architectures,
    attention,
    decoders,
    encoders,
    text_embedding,
    vision_embedding,
)
