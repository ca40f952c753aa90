"""Architecture registry: --arch <id> resolves here (a copy of repro.configs)."""

from repro_torch.configs.base import SHAPES, ArchConfig, ShapeSpec, cell_runnable, smoke_config

from repro_torch.configs.deepseek_v3_671b import CONFIG as _deepseek
from repro_torch.configs.moonshot_v1_16b_a3b import CONFIG as _moonshot
from repro_torch.configs.starcoder2_3b import CONFIG as _starcoder2
from repro_torch.configs.qwen3_4b import CONFIG as _qwen3_4b
from repro_torch.configs.qwen2_72b import CONFIG as _qwen2_72b
from repro_torch.configs.qwen3_1_7b import CONFIG as _qwen3_1_7b
from repro_torch.configs.llama32_vision_90b import CONFIG as _llama_vision
from repro_torch.configs.zamba2_2_7b import CONFIG as _zamba2
from repro_torch.configs.hubert_xlarge import CONFIG as _hubert
from repro_torch.configs.mamba2_2_7b import CONFIG as _mamba2

ARCHS = {c.name: c for c in [
    _deepseek, _moonshot, _starcoder2, _qwen3_4b, _qwen2_72b,
    _qwen3_1_7b, _llama_vision, _zamba2, _hubert, _mamba2,
]}

def get_arch(name: str) -> ArchConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS)}")
    return ARCHS[name]

__all__ = ["ARCHS", "SHAPES", "ArchConfig", "ShapeSpec", "cell_runnable",
           "get_arch", "smoke_config"]
