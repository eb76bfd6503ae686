"""Model families of the port: the dense decoder LM with its vlm and audio
forms (embedding inputs), the MoE family (``moe``), the attention-free ssm
family (Mamba-1) and the hybrid family (Mamba-2 with a shared attention
block; ``ssm`` holds both blocks)."""
from repro_torch.models.model import LM, DecodeCache  # noqa: F401
