"""Training: the YOLOv5 loss, the optimizer and its schedule, the train
step with its EMA; counterpart of heltondetection_tpu/train/."""
