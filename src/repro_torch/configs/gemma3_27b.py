"""gemma3-27b [dense] — 5:1 local:global attention, 128k context.
[hf:google/gemma-3-1b-pt family; unverified]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="gemma3-27b", family="dense", num_layers=62, d_model=5376,
    num_heads=32, num_kv_heads=16, d_ff=21504, vocab_size=262144,
    head_dim=128, rope_theta=1_000_000.0, local_window=1024,
    pattern_local=5, pattern_global=1, tie_embeddings=True, sharding="fsdp_tp")
