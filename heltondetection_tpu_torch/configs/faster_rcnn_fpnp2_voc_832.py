"""FasterRCNN-FPNP2 VOC0712 832² — the reference's P2-only-head + RoIAlign
row (README.md:74: AP50 78.383 / mAP 49.662); flip roi_method to "pool" for
the RoIPooling ablation row (README.md:73, −2.1 mAP)."""

from heltondetection_tpu_torch.configs.base import (DataConfig, EvalConfig,
                                              ExperimentConfig, ModelConfig,
                                              TestConfig, TrainConfig)
from heltondetection_tpu_torch.configs.faster_rcnn_voc_832_cocopretrain import \
    VOC_CLASSES

config = ExperimentConfig(
    name="faster_rcnn_fpnp2_voc_832",
    data=DataConfig(
        format="coco",
        train_ann="datasets/voc0712/annotations/trainval.json",
        train_imgs="datasets/voc0712/images",
        val_ann="datasets/voc0712/annotations/test2007.json",
        val_imgs="datasets/voc0712/images",
        class_names=VOC_CLASSES,
    ),
    model=ModelConfig(family="faster_rcnn", num_classes=20, img_size=832,
                      neck="fpn", head="coupled", roi_levels=1,
                      dtype="bfloat16"),
    train=TrainConfig(epochs=36, batch_size=16, lr=2e-4, mosaic_p=0.0),
    eval=EvalConfig(batch_size=8, conf_thres=0.05, iou_thres=0.5,
                    max_det=100, multi_label=False),
    test=TestConfig(),
)
