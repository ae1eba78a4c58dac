"""FasterRCNN-PAFPN-DecoupledHead VisDrone2019 1280² — the reference's
VisDrone two-stage row (README.md:105: p=0.5, adamw 1e-4, 36 ep, bs 8 →
AP50 37.175 / mAP 21.164)."""

from heltondetection_tpu_torch.configs.base import (DataConfig, EvalConfig,
                                              ExperimentConfig, ModelConfig,
                                              TestConfig, TrainConfig)
config = ExperimentConfig(
    name="faster_rcnn_visdrone_1280",
    data=DataConfig(
        format="visdrone",
        train_ann="datasets/VisDrone2019-DET-train/annotations",
        train_imgs="datasets/VisDrone2019-DET-train/images",
        val_ann="datasets/VisDrone2019-DET-val/annotations",
        val_imgs="datasets/VisDrone2019-DET-val/images",
    ),
    model=ModelConfig(family="faster_rcnn", num_classes=10, img_size=1280,
                      neck="pafpn_v8", head="decoupled", dtype="bfloat16"),
    train=TrainConfig(epochs=36, batch_size=8, lr=1e-4, mosaic_p=0.5),
    eval=EvalConfig(batch_size=4, conf_thres=0.05, iou_thres=0.5,
                    max_det=100, multi_label=False),
    test=TestConfig(),
)
