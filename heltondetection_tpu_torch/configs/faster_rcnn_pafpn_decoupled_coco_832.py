"""FasterRCNN-PAFPN-DecoupledHead COCO2017 832² — the reference's best
FasterRCNN row (README.md:88: mosaic p=0.5, adamw 2e-4, 36 ep, bs 16 →
AP50 62.182 / mAP 42.513)."""

from heltondetection_tpu_torch.configs.base import (DataConfig, EvalConfig,
                                              ExperimentConfig, ModelConfig,
                                              TestConfig, TrainConfig)

config = ExperimentConfig(
    name="faster_rcnn_pafpn_decoupled_coco_832",
    data=DataConfig(
        format="coco",
        train_ann="datasets/coco2017/annotations/instances_train2017.json",
        train_imgs="datasets/coco2017/train2017",
        val_ann="datasets/coco2017/annotations/instances_val2017.json",
        val_imgs="datasets/coco2017/val2017",
    ),
    model=ModelConfig(family="faster_rcnn", num_classes=80, img_size=832,
                      neck="pafpn_v8", head="decoupled", dtype="bfloat16"),
    train=TrainConfig(epochs=36, batch_size=16, lr=2e-4, mosaic_p=0.5),
    eval=EvalConfig(batch_size=8, conf_thres=0.05, iou_thres=0.5,
                    max_det=100, multi_label=False),
    test=TestConfig(),
)
