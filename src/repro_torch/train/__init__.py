"""Training: the detector's QAT (the paper's §3.2 recipe). Counterpart of
``repro/train``; the LM training loop is not ported yet."""
