"""YOLOv5l VOC0712 640² with a registry-swapped backbone — the
reference's timm-backbone row (README.md:120: YOLOv5l-timm_cspdarknet,
p=0.5 → AP50 73.305 / mAP 49.557). timm is torch-only; the same swap
capability goes through models/backbones.py here."""

from heltondetection_tpu_torch.configs.base import (DataConfig, EvalConfig,
                                              ExperimentConfig, ModelConfig,
                                              TestConfig, TrainConfig)
from heltondetection_tpu_torch.configs.faster_rcnn_voc_832_cocopretrain import \
    VOC_CLASSES

config = ExperimentConfig(
    name="yolov5_l_voc_640_backbone_swap",
    data=DataConfig(
        format="coco",
        train_ann="datasets/voc0712/annotations/trainval.json",
        train_imgs="datasets/voc0712/images",
        val_ann="datasets/voc0712/annotations/test2007.json",
        val_imgs="datasets/voc0712/images",
        class_names=VOC_CLASSES,
    ),
    model=ModelConfig(family="yolov5", variant="l",
                      backbone="cspdarknet_l", num_classes=20,
                      img_size=640, dtype="bfloat16"),
    train=TrainConfig(epochs=48, batch_size=16, lr=1e-3, mosaic_p=0.5),
    eval=EvalConfig(batch_size=16),
    test=TestConfig(),
)
