"""Architecture + shape configuration system (a copy of the reference's
``repro.configs.base``: the same names and the same field values).

Every assigned architecture is an ``ArchConfig`` in its own module under
``repro_torch.configs``; ``repro_torch.configs.registry`` exposes them by
id for the ``--arch`` flag of every launcher.  Each config also provides a
``smoke()`` reduction (same family, tiny dims) used by the CPU tests.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    num_shared: int = 0
    d_expert: int = 0              # 0 => use arch d_ff
    capacity_factor: float = 1.25


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                    # dense | moe | ssm | hybrid | audio | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0              # 0 => d_model // num_heads
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    norm_eps: float = 1e-6
    tie_embeddings: bool = True
    # attention pattern: a period of layers with `local` sliding-window
    # layers followed by `global` full-attention layers (gemma3: 5:1)
    local_window: int = 0          # 0 => all layers global
    pattern_local: int = 0
    pattern_global: int = 1
    # recurrent/hybrid block pattern (recurrentgemma: 2 recurrent : 1 attn)
    block_kind: str = "attn"       # attn | xlstm | rglru
    pattern_recurrent: int = 0
    # ssm/xlstm
    mlstm_chunk: int = 256
    conv_width: int = 4
    # moe
    moe: MoEConfig | None = None
    # modality frontend stub (audio frames / vision patches)
    frontend: str = "none"         # none | audio_frames | vision_patches
    frontend_dim: int = 0
    num_patches: int = 0           # vlm: patches prepended to the sequence
    encoder_only: bool = False
    # distribution policy
    sharding: str = "tp"           # tp | fsdp_tp
    remat: bool = True
    use_flash_attention: bool = False

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    def smoke(self) -> "ArchConfig":
        """Tiny same-family variant for CPU smoke tests."""
        moe = None
        if self.moe is not None:
            moe = MoEConfig(num_experts=min(4, self.moe.num_experts),
                            top_k=min(2, self.moe.top_k),
                            num_shared=min(1, self.moe.num_shared),
                            d_expert=32, capacity_factor=2.0)
        period = max(1, self.pattern_local + self.pattern_global,
                     self.pattern_recurrent + (1 if self.pattern_recurrent
                                               else 0))
        layers = max(2, 2 * period)
        return dataclasses.replace(
            self, num_layers=layers, d_model=64,
            num_heads=4, num_kv_heads=max(1, min(self.num_kv_heads, 2)),
            d_ff=128, vocab_size=256, head_dim=16,
            local_window=min(self.local_window, 16) if self.local_window
            else 0,
            mlstm_chunk=16, moe=moe, frontend_dim=32 if self.frontend != "none"
            else 0, num_patches=8 if self.frontend == "vision_patches" else 0,
            sharding="tp", remat=False)


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                      # train | prefill | decode


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


def shape_skip_reason(arch: ArchConfig, shape: ShapeConfig) -> str | None:
    """None if the (arch, shape) cell runs; otherwise the documented skip."""
    if arch.encoder_only and shape.kind == "decode":
        return "encoder-only architecture has no autoregressive decode step"
    if shape.name == "long_500k":
        sub_quadratic = arch.family in ("ssm", "hybrid")
        if not sub_quadratic:
            return ("500k decode needs sub-quadratic attention; this arch "
                    "carries full/periodically-global attention (see "
                    "DESIGN.md §Arch-applicability)")
    return None


def live_cells(archs) -> list[tuple[ArchConfig, ShapeConfig]]:
    cells = []
    for a in archs:
        for s in SHAPES.values():
            if shape_skip_reason(a, s) is None:
                cells.append((a, s))
    return cells
