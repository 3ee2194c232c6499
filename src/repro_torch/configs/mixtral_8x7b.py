"""mixtral-8x7b [moe]: 32L d4096 32H GQA(kv=8) ff14336 v32000,
8 experts top-2, sliding-window attention 4096. [arXiv:2401.04088; hf]
"""
from repro_torch.models.layers import ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x7b", family="moe",
    num_layers=32, d_model=4096, num_heads=32, num_kv_heads=8,
    d_ff=14336, vocab_size=32000, head_dim=128,
    num_experts=8, top_k=2, sliding_window=4096,
    w1a8_body=True,
)


def reduced() -> ModelConfig:
    import dataclasses
    return dataclasses.replace(
        CONFIG, num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
        head_dim=16, d_ff=96, vocab_size=128, num_experts=4, top_k=2,
        sliding_window=8, capacity_factor=4.0)
