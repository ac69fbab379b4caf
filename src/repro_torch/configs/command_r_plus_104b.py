"""command-r-plus-104b [dense] — GQA kv=8, no bias.
[hf:CohereForAI/c4ai-command-r-v01 family; unverified]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="command-r-plus-104b", family="dense", num_layers=64, d_model=12288,
    num_heads=96, num_kv_heads=8, d_ff=33792, vocab_size=256000,
    tie_embeddings=True, sharding="fsdp_tp")
