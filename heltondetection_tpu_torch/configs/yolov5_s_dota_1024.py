"""YOLOv5s DOTAv1.0-h 1024² (README.md:153: AP50 64.349 / mAP 39.500) —
horizontal-box DOTA via the DOTA reader."""

from heltondetection_tpu_torch.configs.base import (DataConfig, EvalConfig,
                                              ExperimentConfig, ModelConfig,
                                              TestConfig, TrainConfig)

DOTA_CLASSES = [
    "plane", "baseball-diamond", "bridge", "ground-track-field",
    "small-vehicle", "large-vehicle", "ship", "tennis-court",
    "basketball-court", "storage-tank", "soccer-ball-field", "roundabout",
    "harbor", "swimming-pool", "helicopter"]

config = ExperimentConfig(
    name="yolov5_s_dota_1024",
    data=DataConfig(
        format="dota",
        train_ann="datasets/dota_h/train/labelTxt",   # label dir
        train_imgs="datasets/dota_h/train/images",
        val_ann="datasets/dota_h/val/labelTxt",
        val_imgs="datasets/dota_h/val/images",
        class_names=DOTA_CLASSES,
    ),
    model=ModelConfig(family="yolov5", variant="s", num_classes=15,
                      img_size=1024, dtype="bfloat16"),
    train=TrainConfig(epochs=48, batch_size=16, lr=1e-3, mosaic_p=0.5),
    eval=EvalConfig(batch_size=8),
    test=TestConfig(),
)
