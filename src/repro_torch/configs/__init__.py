"""Assigned architecture registry: one module per --arch id."""
from . import (llama3_2_3b, qwen3_0_6b, gemma_2b, granite_3_8b,
               deepseek_v3_671b, moonshot_v1_16b_a3b, paligemma_3b,
               musicgen_large, xlstm_125m, zamba2_2_7b)

ALL_ARCHS = [
    "llama3.2-3b", "qwen3-0.6b", "gemma-2b", "granite-3-8b",
    "deepseek-v3-671b", "moonshot-v1-16b-a3b", "paligemma-3b",
    "musicgen-large", "xlstm-125m", "zamba2-2.7b",
]

from .base import SHAPES, ModelConfig, ShapeConfig, get_config, list_archs, supports_shape  # noqa: F401,E402
