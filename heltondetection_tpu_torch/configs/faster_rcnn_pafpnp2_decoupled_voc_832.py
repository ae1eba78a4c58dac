"""FasterRCNN-PAFPNP2-DecoupledHead VOC0712 832² — the reference's
P2-only PAFPN + decoupled-head rows (README.md:76-77: × → 55.152 mAP;
mosaic p=0.5 → 58.116 mAP)."""

from heltondetection_tpu_torch.configs.base import (DataConfig, EvalConfig,
                                              ExperimentConfig, ModelConfig,
                                              TestConfig, TrainConfig)
from heltondetection_tpu_torch.configs.faster_rcnn_voc_832_cocopretrain import \
    VOC_CLASSES

config = ExperimentConfig(
    name="faster_rcnn_pafpnp2_decoupled_voc_832",
    data=DataConfig(
        format="coco",
        train_ann="datasets/voc0712/annotations/trainval.json",
        train_imgs="datasets/voc0712/images",
        val_ann="datasets/voc0712/annotations/test2007.json",
        val_imgs="datasets/voc0712/images",
        class_names=VOC_CLASSES,
    ),
    model=ModelConfig(family="faster_rcnn", num_classes=20, img_size=832,
                      neck="pafpn_v8", head="decoupled", roi_levels=1,
                      dtype="bfloat16"),
    train=TrainConfig(epochs=36, batch_size=16, lr=2e-4, mosaic_p=0.5),
    eval=EvalConfig(batch_size=8, conf_thres=0.05, iou_thres=0.5,
                    max_det=100, multi_label=False),
    test=TestConfig(),
)
