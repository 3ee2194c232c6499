"""internvl2-76b [vlm]: 80L d8192 64H GQA(kv=8) ff28672 v128256
(InternLM2-based LM backbone). The InternViT frontend is a stub:
input_specs() provides 256 precomputed patch embeddings per image.
[arXiv:2404.16821; unverified]
"""
from repro_torch.models.layers import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-76b", family="vlm",
    num_layers=80, d_model=8192, num_heads=64, num_kv_heads=8,
    d_ff=28672, vocab_size=128256, head_dim=128,
    frontend="vision", prefix_len=256,
    w1a8_body=True,
)


def reduced() -> ModelConfig:
    import dataclasses
    return dataclasses.replace(
        CONFIG, num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
        head_dim=16, d_ff=128, vocab_size=128, prefix_len=4)
