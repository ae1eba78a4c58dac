"""YOLOv5s COCO2017 640² — the reference's headline config (README.md:130:
mosaic p=0.5, adamw 1e-3, 48 epochs, bs 16 → AP50 52.476 / mAP 32.645).
Point the data paths at a COCO2017 layout."""

from heltondetection_tpu_torch.configs.base import (DataConfig, EvalConfig,
                                              ExperimentConfig, ModelConfig,
                                              TestConfig, TrainConfig)

config = ExperimentConfig(
    name="yolov5_s_coco_640",
    data=DataConfig(
        format="coco",
        train_ann="datasets/coco2017/annotations/instances_train2017.json",
        train_imgs="datasets/coco2017/train2017",
        val_ann="datasets/coco2017/annotations/instances_val2017.json",
        val_imgs="datasets/coco2017/val2017",
    ),
    model=ModelConfig(family="yolov5", variant="s", num_classes=80,
                      img_size=640, dtype="bfloat16"),
    train=TrainConfig(epochs=48, batch_size=16, lr=1e-3, mosaic_p=0.5),
    eval=EvalConfig(batch_size=32),
    test=TestConfig(),
)
