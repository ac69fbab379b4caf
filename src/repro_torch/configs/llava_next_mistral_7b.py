"""llava-next-mistral-7b [vlm] — mistral backbone + anyres patch stub.
[hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified]

The modality frontend is a STUB per the assignment: input_specs provides
precomputed patch embeddings [B, 2880, 1024] (5 anyres tiles x 576 patches)
projected by a 2-layer MLP and prepended to the token sequence.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="llava-next-mistral-7b", family="vlm", num_layers=32, d_model=4096,
    num_heads=32, num_kv_heads=8, d_ff=14336, vocab_size=32000,
    tie_embeddings=False, frontend="vision_patches", frontend_dim=1024,
    num_patches=2880, sharding="tp")
