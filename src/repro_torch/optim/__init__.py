"""Optimizers (plain PyTorch, no torch.optim): AdamW, Adafactor, SGD-M and
schedules, with the reference's (init, update) convention on nested dicts
of tensors. Counterpart of ``repro/optim``."""
from repro_torch.optim.optimizers import (adafactor, adamw,  # noqa: F401
                                          apply_updates, clip_by_global_norm,
                                          sgdm, tree_leaves, tree_map)
from repro_torch.optim.schedules import (cosine_schedule,  # noqa: F401
                                         linear_warmup)
