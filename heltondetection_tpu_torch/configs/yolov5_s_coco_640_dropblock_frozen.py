"""YOLOv5s COCO2017 640² + DropBlock(0.5) + frozen backbone — the
reference's regularization ablation rows (README.md:131-132:
dropBlock0.5 → 31.227 mAP; +frozeBackbone → 32.785 mAP)."""

from heltondetection_tpu_torch.configs.base import (DataConfig, EvalConfig,
                                              ExperimentConfig, ModelConfig,
                                              TestConfig, TrainConfig)

config = ExperimentConfig(
    name="yolov5_s_coco_640_dropblock_frozen",
    data=DataConfig(
        format="coco",
        train_ann="datasets/coco2017/annotations/instances_train2017.json",
        train_imgs="datasets/coco2017/train2017",
        val_ann="datasets/coco2017/annotations/instances_val2017.json",
        val_imgs="datasets/coco2017/val2017",
    ),
    model=ModelConfig(family="yolov5", variant="s", num_classes=80,
                      img_size=640, dtype="bfloat16", dropblock_p=0.5,
                      freeze_backbone=True),
    train=TrainConfig(epochs=48, batch_size=16, lr=1e-3, mosaic_p=0.5,
                      pretrain_ckpt="work/yolov5_s_coco_640/ckpt"),
    eval=EvalConfig(batch_size=32),
    test=TestConfig(),
)
