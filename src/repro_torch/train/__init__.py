"""Training: the detector's QAT (the paper's §3.2 recipe) and the LM train
step and loop. Counterpart of ``repro/train``; the pipelined LM step waits
for the distribution layer."""
