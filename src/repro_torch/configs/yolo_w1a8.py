"""The paper's own model: W1A8 YOLOv3-tiny-like detector (Table 1).

320×320×3 → 10×10×75; Conv1/Conv11 fixed-point standard conv, Conv2–10
W1A8. Structure lives in repro_torch.models.yolo (YOLO_LAYERS); this config
file exists so ``--arch yolo-w1a8`` is selectable next to the LM archs
(counterpart of ``repro/configs/yolo_w1a8.py``).
"""
from repro_torch.models.yolo import (GRID, INPUT_SIZE,  # noqa: F401
                                     NUM_ANCHORS, NUM_CLASSES, YOLO_LAYERS,
                                     count_gflops, count_params)

NAME = "yolo-w1a8"
LAYERS = YOLO_LAYERS
