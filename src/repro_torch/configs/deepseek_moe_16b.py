"""deepseek-moe-16b [moe] — fine-grained: 2 shared + 64 routed top-6,
expert dim 1408.  [arXiv:2401.06066; hf]

Deviation note (DESIGN.md): the reference model keeps layer 0 dense; here
every layer is MoE for a homogeneous scan stack — parameter count differs
by < 1%.
"""
from repro_torch.configs.base import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="deepseek-moe-16b", family="moe", num_layers=28, d_model=2048,
    num_heads=16, num_kv_heads=16, d_ff=1408, vocab_size=102400,
    tie_embeddings=False, sharding="tp",
    moe=MoEConfig(num_experts=64, top_k=6, num_shared=2, d_expert=1408,
                  capacity_factor=1.25))
