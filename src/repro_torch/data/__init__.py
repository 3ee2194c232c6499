"""Synthetic datasets, deterministic in (seed, step, shard): the detection
sampler and the YOLO target. Counterpart of ``repro/data``."""
