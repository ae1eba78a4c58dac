"""YOLOv5s VOC0712 640² — the reference's VOC mosaic-ablation series
(README.md:115-119: × / p=0.5 / p=1.0; best p=0.5 → AP50 71.852 /
mAP 46.374). Set train.mosaic_p to 0.0 or 1.0 for the ablation rows."""

from heltondetection_tpu_torch.configs.base import (DataConfig, EvalConfig,
                                              ExperimentConfig, ModelConfig,
                                              TestConfig, TrainConfig)
from heltondetection_tpu_torch.configs.faster_rcnn_voc_832_cocopretrain import \
    VOC_CLASSES

config = ExperimentConfig(
    name="yolov5_s_voc_640",
    data=DataConfig(
        format="coco",
        train_ann="datasets/voc0712/annotations/trainval.json",
        train_imgs="datasets/voc0712/images",
        val_ann="datasets/voc0712/annotations/test2007.json",
        val_imgs="datasets/voc0712/images",
        class_names=VOC_CLASSES,
    ),
    model=ModelConfig(family="yolov5", variant="s", num_classes=20,
                      img_size=640, dtype="bfloat16"),
    train=TrainConfig(epochs=48, batch_size=16, lr=1e-3, mosaic_p=0.5),
    eval=EvalConfig(batch_size=32),
    test=TestConfig(),
)
