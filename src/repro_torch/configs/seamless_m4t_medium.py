"""seamless-m4t-medium [audio enc-dec]: 12L d1024 16H (MHA) ff4096 v256206.

Backbone only — the audio frontend is a stub: input_specs() provides
precomputed frame embeddings (B, S, 1024). RoPE replaces the original
relative positions (TPU adaptation note, DESIGN.md §8).
[arXiv:2308.11596; hf]
"""
from repro_torch.models.layers import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-medium", family="encdec",
    num_layers=12, d_model=1024, num_heads=16, num_kv_heads=16,
    d_ff=4096, vocab_size=256206, head_dim=64,
    encoder_layers=12, frontend="audio",
    norm_kind="layer", act_fn="gelu", gated_mlp=False,
    w1a8_body=True,
)


def reduced() -> ModelConfig:
    import dataclasses
    return dataclasses.replace(
        CONFIG, num_layers=2, encoder_layers=2, d_model=64, num_heads=4,
        num_kv_heads=4, head_dim=16, d_ff=128, vocab_size=128)
