"""qwen2.5-14b [dense]: 48L d5120 40H GQA(kv=8) ff13824 v152064, QKV bias.
[hf:Qwen/Qwen2.5-0.5B scaled family config; hf]
"""
from repro_torch.models.layers import ModelConfig

CONFIG = ModelConfig(
    name="qwen2.5-14b", family="dense",
    num_layers=48, d_model=5120, num_heads=40, num_kv_heads=8,
    d_ff=13824, vocab_size=152064, head_dim=128,
    qkv_bias=True,
    w1a8_body=True,
)


def reduced() -> ModelConfig:
    import dataclasses
    return dataclasses.replace(
        CONFIG, num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
        head_dim=16, d_ff=128, vocab_size=128)
