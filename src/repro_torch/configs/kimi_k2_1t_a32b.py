"""kimi-k2-1t-a32b [moe]: 61L d7168 64H GQA(kv=8) per-expert ff2048
v163840, 384 routed experts top-8 + 1 shared — ~1.04T params, ~32B active.

1-bit expert weights (W1A8) pack the 1T to ~134 GB — the headline capacity
result (DESIGN.md §5). [arXiv:2501.kimi2; unverified]
"""
from repro_torch.models.layers import ModelConfig

CONFIG = ModelConfig(
    name="kimi-k2-1t-a32b", family="moe",
    num_layers=61, d_model=7168, num_heads=64, num_kv_heads=8,
    d_ff=2048, vocab_size=163840, head_dim=128,
    num_experts=384, top_k=8, shared_experts=1,
    w1a8_body=True,
)


def reduced() -> ModelConfig:
    import dataclasses
    return dataclasses.replace(
        CONFIG, num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
        head_dim=16, d_ff=32, vocab_size=128, num_experts=8, top_k=2, capacity_factor=8.0)
