"""granite-20b [dense/code]: 52L d6144 48H MQA(kv=1) ff24576 v49152,
non-gated GELU MLP (gpt-bigcode lineage). [arXiv:2405.04324; hf]
"""
from repro_torch.models.layers import ModelConfig

CONFIG = ModelConfig(
    name="granite-20b", family="dense",
    num_layers=52, d_model=6144, num_heads=48, num_kv_heads=1,
    d_ff=24576, vocab_size=49152, head_dim=128,
    act_fn="gelu", gated_mlp=False,
    w1a8_body=True,
)


def reduced() -> ModelConfig:
    import dataclasses
    return dataclasses.replace(
        CONFIG, num_layers=2, d_model=64, num_heads=4, num_kv_heads=1,
        head_dim=16, d_ff=128, vocab_size=128)
