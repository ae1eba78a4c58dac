"""FasterRCNN with a CSPDarknet backbone, COCO2017 832² — exercises the
reference's swappable-backbone capability (README.md:8-9; its
timm-backbone demo row is YOLOv5l-timm_cspdarknet, README.md:120). timm is
torch-only; the TPU rebuild swaps via the models/backbones.py registry."""

from heltondetection_tpu_torch.configs.base import (DataConfig, EvalConfig,
                                              ExperimentConfig, ModelConfig,
                                              TestConfig, TrainConfig)

config = ExperimentConfig(
    name="faster_rcnn_cspdarknet_coco_832",
    data=DataConfig(
        format="coco",
        train_ann="datasets/coco2017/annotations/instances_train2017.json",
        train_imgs="datasets/coco2017/train2017",
        val_ann="datasets/coco2017/annotations/instances_val2017.json",
        val_imgs="datasets/coco2017/val2017",
    ),
    model=ModelConfig(family="faster_rcnn", backbone="cspdarknet_l",
                      num_classes=80, img_size=832, neck="pafpn_v8",
                      head="decoupled", dtype="bfloat16",
                      # from-scratch semantics: no pretrained CSPDarknet
                      # ingestion exists (convert_resnet is torchvision-
                      # ResNet only), so the pretrained-fine-tune defaults
                      # (FrozenBN + frozen stem) would freeze a RANDOM
                      # stage — train the whole backbone instead
                      backbone_norm_eval=False, backbone_frozen_stages=0),
    train=TrainConfig(epochs=36, batch_size=16, lr=2e-4, mosaic_p=0.5),
    eval=EvalConfig(batch_size=8, conf_thres=0.05, iou_thres=0.5,
                    max_det=100, multi_label=False),
    test=TestConfig(),
)
