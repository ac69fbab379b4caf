"""Architecture registry: --arch <id> resolution for every launcher."""

from repro_torch.configs.base import ArchConfig

from repro_torch.configs.command_r_plus_104b import CONFIG as _command_r
from repro_torch.configs.deepseek_moe_16b import CONFIG as _deepseek
from repro_torch.configs.gemma3_27b import CONFIG as _gemma3
from repro_torch.configs.hubert_xlarge import CONFIG as _hubert
from repro_torch.configs.llama4_scout_17b_a16e import CONFIG as _llama4
from repro_torch.configs.llava_next_mistral_7b import CONFIG as _llava
from repro_torch.configs.phi3_mini_38b import CONFIG as _phi3
from repro_torch.configs.qwen15_32b import CONFIG as _qwen
from repro_torch.configs.recurrentgemma_9b import CONFIG as _rg
from repro_torch.configs.xlstm_350m import CONFIG as _xlstm

ARCHS: dict[str, ArchConfig] = {c.name: c for c in [
    _gemma3, _qwen, _command_r, _phi3, _llava, _llama4, _deepseek, _xlstm,
    _hubert, _rg,
]}


def get_arch(name: str) -> ArchConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS)}")
    return ARCHS[name]
