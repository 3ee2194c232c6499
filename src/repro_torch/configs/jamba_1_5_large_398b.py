"""jamba-1.5-large-398b [hybrid]: 72L d8192 64H GQA(kv=8) ff24576 v65536,
Mamba-1(state 16) : attention 7:1 interleave, MoE 16e top-2 every other
layer — ≈398B total params. [arXiv:2403.19887; hf]
"""
from repro_torch.models.layers import ModelConfig

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b", family="hybrid",
    num_layers=72, d_model=8192, num_heads=64, num_kv_heads=8,
    d_ff=24576, vocab_size=65536, head_dim=128,
    num_experts=16, top_k=2, moe_every=2,
    ssm_state=16, ssm_kind="mamba1", attn_every=8,
    w1a8_body=True,
)


def reduced() -> ModelConfig:
    import dataclasses
    return dataclasses.replace(
        CONFIG, num_layers=8, d_model=64, num_heads=4, num_kv_heads=2,
        head_dim=16, d_ff=64, vocab_size=128, num_experts=4, top_k=2,
        ssm_state=8, capacity_factor=4.0)
