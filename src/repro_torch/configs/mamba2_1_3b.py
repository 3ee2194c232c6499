"""mamba2-1.3b [ssm]: 48L d2048, attention-free SSD (state-space duality),
d_state 128, expand 2, headdim 64, v50280 — O(1)-state decode, runs
long_500k. [arXiv:2405.21060; unverified]
"""
from repro_torch.models.layers import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-1.3b", family="ssm",
    num_layers=48, d_model=2048, num_heads=1, num_kv_heads=1,
    d_ff=0, vocab_size=50280,
    ssm_state=128, ssm_kind="mamba2", ssm_expand=2, ssm_headdim=64,
    w1a8_body=True,
)


def reduced() -> ModelConfig:
    import dataclasses
    return dataclasses.replace(
        CONFIG, num_layers=2, d_model=64, vocab_size=128, ssm_state=16,
        ssm_headdim=16)
