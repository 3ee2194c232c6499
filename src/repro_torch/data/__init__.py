"""Synthetic datasets, deterministic in (seed, step, shard): the LM token
streams, the detection sampler and the YOLO target. Counterpart of
``repro/data``."""
