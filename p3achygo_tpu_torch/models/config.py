"""Named model configurations (mirror of p3achygo_tpu/models/config.py,
reference python/model_config.py:3-197). tests/test_torch_model.py holds
every entry equal to the JAX package's table."""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    blocks: int = 16
    conv_size: int = 3
    broadcast_interval: int = 8
    inner_bottleneck_layers: int = 2
    channels: int = 128
    bottleneck_channels: int = 64
    head_channels: int = 32
    c_val: int = 64
    trunk_block_type: str = "btl"  # classic | btl | nbt | transformer
    embed_dim: int = 96
    num_heads: int = 3
    is_transformer: bool = False
    c_l2: float = 1e-4

    @property
    def bottleneck_length(self) -> int:
        return self.inner_bottleneck_layers + 2


_CONFIGS = {
    "tiny": ModelConfig(blocks=6, broadcast_interval=4, inner_bottleneck_layers=1,
                        channels=16, bottleneck_channels=8, head_channels=8,
                        c_val=16),
    "small": ModelConfig(),
    "b10c128btl3": ModelConfig(blocks=10, broadcast_interval=4,
                               inner_bottleneck_layers=3, channels=128,
                               bottleneck_channels=64),
    "b5c256btl3": ModelConfig(blocks=5, broadcast_interval=2,
                              inner_bottleneck_layers=3, channels=256,
                              bottleneck_channels=128),
    "b12c256btl3": ModelConfig(blocks=12, broadcast_interval=5,
                               inner_bottleneck_layers=3, channels=256,
                               bottleneck_channels=128),
    "b14c384btl3": ModelConfig(blocks=14, broadcast_interval=6,
                               inner_bottleneck_layers=3, channels=384,
                               bottleneck_channels=192, head_channels=32,
                               c_val=80),
    "b15c192_classic": ModelConfig(blocks=15, broadcast_interval=6, channels=192,
                                   head_channels=32, c_val=80,
                                   trunk_block_type="classic"),
    "b8c128nbt": ModelConfig(blocks=8, broadcast_interval=3, channels=128,
                             bottleneck_channels=64, head_channels=32,
                             trunk_block_type="nbt"),
    "b12c256nbt": ModelConfig(blocks=12, broadcast_interval=3, channels=256,
                              bottleneck_channels=128, head_channels=32,
                              c_val=80, trunk_block_type="nbt"),
    "b10c384nbt": ModelConfig(blocks=10, broadcast_interval=4, channels=384,
                              bottleneck_channels=192, head_channels=32,
                              c_val=80, trunk_block_type="nbt"),
    "b14d96h3_transformer": ModelConfig(blocks=14, channels=96, embed_dim=96,
                                        num_heads=3, is_transformer=True,
                                        trunk_block_type="transformer",
                                        c_l2=0.0),
    "b12c128btl3": ModelConfig(blocks=12, broadcast_interval=4,
                               inner_bottleneck_layers=3, channels=128,
                               bottleneck_channels=64),
    "b8c64": ModelConfig(blocks=8, broadcast_interval=4,
                         inner_bottleneck_layers=2, channels=64,
                         bottleneck_channels=32, head_channels=16, c_val=32),
}

CONFIG_OPTIONS = sorted(_CONFIGS.keys())


def get_config(name: str) -> ModelConfig:
    if name not in _CONFIGS:
        raise ValueError(f"unknown model config {name!r}; options: {CONFIG_OPTIONS}")
    return _CONFIGS[name]
