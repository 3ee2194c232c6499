"""chatglm3-6b [dense]: 28L d4096 32H GQA(kv=2) ff13696 v65024,
2D RoPE (rotary on half the head dim). [arXiv:2406.12793; hf]
"""
from repro_torch.models.layers import ModelConfig

CONFIG = ModelConfig(
    name="chatglm3-6b", family="dense",
    num_layers=28, d_model=4096, num_heads=32, num_kv_heads=2,
    d_ff=13696, vocab_size=65024, head_dim=128,
    rope_fraction=0.5,
    w1a8_body=True,
)


def reduced() -> ModelConfig:
    import dataclasses
    return dataclasses.replace(
        CONFIG, num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
        head_dim=16, d_ff=128, vocab_size=128)
