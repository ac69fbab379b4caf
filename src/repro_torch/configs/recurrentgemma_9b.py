"""recurrentgemma-9b [hybrid] — RG-LRU + local attention, 2:1 pattern,
MQA kv=1, window 2048.  [arXiv:2402.19427; unverified]

Runs the long_500k shape: recurrent state is O(1), attention KV is a
2048-slot ring buffer.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="recurrentgemma-9b", family="hybrid", num_layers=38, d_model=4096,
    num_heads=16, num_kv_heads=1, d_ff=12288, vocab_size=256000,
    block_kind="rglru", local_window=2048, tie_embeddings=True,
    sharding="fsdp_tp")
