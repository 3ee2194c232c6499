"""gemma2-27b [dense]: 46L d4608 32H GQA(kv=16) ff36864 v256000,
alternating local(SWA-4096)/global attention, logit softcaps (50 attn /
30 final), post-norms. [arXiv:2408.00118; hf]
"""
from repro_torch.models.layers import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-27b", family="dense",
    num_layers=46, d_model=4608, num_heads=32, num_kv_heads=16,
    d_ff=36864, vocab_size=256000, head_dim=128,
    local_global=True, sliding_window=4096,
    attn_softcap=50.0, final_softcap=30.0, post_norms=True,
    act_fn="gelu",
    w1a8_body=True,
)


def reduced() -> ModelConfig:
    import dataclasses
    return dataclasses.replace(
        CONFIG, num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
        head_dim=16, d_ff=128, vocab_size=128, sliding_window=8)
