"""llama4-scout-17b-a16e [moe] — 16 routed experts top-1 + 1 shared, every
layer MoE.  [hf:meta-llama/Llama-4-Scout-17B-16E; unverified]"""
from repro_torch.configs.base import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="llama4-scout-17b-a16e", family="moe", num_layers=48, d_model=5120,
    num_heads=40, num_kv_heads=8, d_ff=8192, vocab_size=202048,
    tie_embeddings=False, sharding="fsdp_tp",
    moe=MoEConfig(num_experts=16, top_k=1, num_shared=1, d_expert=8192,
                  capacity_factor=1.25))
