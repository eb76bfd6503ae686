"""Model families of the port (so far: the dense decoder LM and the
attention-free ssm family, Mamba-1; ``ssm`` also holds the Mamba-2 block)."""
from repro_torch.models.model import LM, DecodeCache  # noqa: F401
