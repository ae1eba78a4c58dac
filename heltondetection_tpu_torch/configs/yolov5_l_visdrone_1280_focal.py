"""YOLOv5l-focalloss(root) VisDrone2019 1280² — the reference's best
VisDrone row (README.md:145: AP50 39.029 / mAP 22.589; focal 'root'
variant per README.md:143-145). Reads the native VisDrone annotation
format directly (data/readers.py:VisDroneDataset) — no offline
VisDrone→COCO conversion needed."""

from heltondetection_tpu_torch.configs.base import (DataConfig, EvalConfig,
                                              ExperimentConfig, ModelConfig,
                                              TestConfig, TrainConfig)

config = ExperimentConfig(
    name="yolov5_l_visdrone_1280_focal_root",
    data=DataConfig(
        format="visdrone",
        train_ann="datasets/VisDrone2019-DET-train/annotations",
        train_imgs="datasets/VisDrone2019-DET-train/images",
        val_ann="datasets/VisDrone2019-DET-val/annotations",
        val_imgs="datasets/VisDrone2019-DET-val/images",
    ),
    model=ModelConfig(family="yolov5", variant="l", num_classes=10,
                      img_size=1280, dtype="bfloat16"),
    train=TrainConfig(epochs=48, batch_size=8, lr=1e-3, mosaic_p=0.5,
                      focal="root"),
    eval=EvalConfig(batch_size=8),
    test=TestConfig(),
)
