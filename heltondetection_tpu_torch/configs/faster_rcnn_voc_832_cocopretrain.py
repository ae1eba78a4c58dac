"""FasterRCNN-PAFPN-DecoupledHead-COCOPretrain VOC0712 832² — the
reference's best VOC row (README.md:79: AP50 85.204 / mAP 63.817; transfer
from a COCO-trained checkpoint)."""

from heltondetection_tpu_torch.configs.base import (DataConfig, EvalConfig,
                                              ExperimentConfig, ModelConfig,
                                              TestConfig, TrainConfig)

VOC_CLASSES = [
    "aeroplane", "bicycle", "bird", "boat", "bottle", "bus", "car", "cat",
    "chair", "cow", "diningtable", "dog", "horse", "motorbike", "person",
    "pottedplant", "sheep", "sofa", "train", "tvmonitor"]

config = ExperimentConfig(
    name="faster_rcnn_voc_832_cocopretrain",
    data=DataConfig(
        format="coco",  # VOC converted to COCO-json layout
        train_ann="datasets/voc0712/annotations/trainval.json",
        train_imgs="datasets/voc0712/images",
        val_ann="datasets/voc0712/annotations/test2007.json",
        val_imgs="datasets/voc0712/images",
        class_names=VOC_CLASSES,
    ),
    model=ModelConfig(family="faster_rcnn", num_classes=20, img_size=832,
                      neck="pafpn_v8", head="decoupled", dtype="bfloat16"),
    train=TrainConfig(epochs=36, batch_size=16, lr=2e-4, mosaic_p=0.5,
                      pretrain_ckpt="runs/faster_rcnn_pafpn_decoupled_coco_832/ckpt"),
    eval=EvalConfig(batch_size=8, conf_thres=0.05, iou_thres=0.5,
                    max_det=100, multi_label=False),
    test=TestConfig(),
)
