"""Model families of the port (this slice: the dense decoder LM)."""
from repro_torch.models.model import LM, DecodeCache  # noqa: F401
