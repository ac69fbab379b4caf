"""xlstm-350m [ssm] — alternating mLSTM (chunkwise-parallel matrix memory)
and sLSTM (recurrent scan) blocks.  [arXiv:2405.04517; unverified]

d_ff = 0: xLSTM blocks carry their own projections; no separate MLP.
Runs the long_500k shape (O(1) recurrent state, no KV growth).
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="xlstm-350m", family="ssm", num_layers=24, d_model=1024,
    num_heads=4, num_kv_heads=4, d_ff=0, vocab_size=50304,
    block_kind="xlstm", mlstm_chunk=256, tie_embeddings=True, sharding="tp")
