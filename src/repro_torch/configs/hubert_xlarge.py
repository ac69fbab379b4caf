"""hubert-xlarge [audio] — encoder-only; masked-prediction over 504 cluster
ids.  [arXiv:2106.07447; unverified]

Modality frontend is a STUB: input_specs provides precomputed conv-feature
frames [B, S, 512]; decode shapes are skipped (no autoregressive step).
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="hubert-xlarge", family="audio", num_layers=48, d_model=1280,
    num_heads=16, num_kv_heads=16, d_ff=5120, vocab_size=504,
    encoder_only=True, frontend="audio_frames", frontend_dim=512,
    tie_embeddings=False, sharding="tp")
