"""Fault-tolerant checkpoints: atomic manifests, async writes, restore
onto a chosen device. Counterpart of ``repro/ckpt``; its on-disk format is
the reference's, so a checkpoint written by either package restores in
the other."""
from repro_torch.ckpt.checkpoint import (latest_step,  # noqa: F401
                                         restore_checkpoint,
                                         save_checkpoint, wait_for_async)
