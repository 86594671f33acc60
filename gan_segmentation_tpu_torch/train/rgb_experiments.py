"""The hair DeepLabV3+ experiments on the port: the counterpart of
``experiments/rgb_segmentation/common.py`` and its two ``main.py`` specs.

    python -m gan_segmentation_tpu_torch.train.rgb_experiments EXP train \\
        --input-path DATASET [--no-cuda] [...]
    python -m gan_segmentation_tpu_torch.train.rgb_experiments EXP test \\
        RUN_DIR --input-path DATASET [--no-cuda] [...]

``EXP`` is ``00_hair_deeplabv3_ffhq_pretrain_no_gan`` (real annotated
training data) or ``01_hair_deeplabv3_ffhq_pretrain_gan`` (the generated
dataset).  DATASET holds ``train_generated/`` or ``train_real/`` and
``val/`` (``img_*.jpg`` / ``mask_*.png`` pairs, as ``generate`` writes
them).  Runs go to ``experiments/rgb_segmentation/EXP/runs/``.  The model
cfg is the reference's (nclass 2, crop 480, base 512, aux weight 0.5,
ImageNet normalisation); the two experiments differ in their training
subdir, rotation limit, rate, weight decay and test threshold
(`01:80-116,130-139` vs `00`).
"""

import dataclasses
import sys
from pathlib import Path

import torch

from ..core import distributed as dist_
from ..data.augment import (CenterCrop, HorizontalFlip, PadIfNeeded,
                            RandomCrop, RGBSegmentationAug, ShiftScaleRotate)
from ..data.segmentation import FFHQHairSegmentation, imagenet_transform
from ..models.deeplab import DeepLabV3Plus
from ..utils.log import logger
from .deeplab_trainer import SegmentationTester, SegmentationTrainer
from .experiments import init_exp, spawn_world

EXPERIMENTS_DIR = (Path(__file__).resolve().parents[2] / "experiments"
                   / "rgb_segmentation")


@dataclasses.dataclass
class ExpSpec:
    name: str
    train_subdir: str        # 'train_generated' (01) vs 'train_real' (00)
    rotate_limit: float      # 15 (01) vs 0 (00)
    lr: float                # 0.005 (01) vs 0.01 (00)
    weight_decay: float      # 2e-4 (01) vs 1e-4 (00)
    test_threshold: float    # 1e-15 (01) vs 0.5 (00)
    num_epochs: int = 20
    crop_size: int = 480
    base_size: int = 512
    train_epoch_len: int = 10000
    scale_factor: float = 0.5


SPECS = {spec.name: spec for spec in (
    ExpSpec("00_hair_deeplabv3_ffhq_pretrain_no_gan",
            train_subdir="train_real", rotate_limit=0, lr=0.01,
            weight_decay=1e-4, test_threshold=0.5),
    ExpSpec("01_hair_deeplabv3_ffhq_pretrain_gan",
            train_subdir="train_generated", rotate_limit=15, lr=0.005,
            weight_decay=2e-4, test_threshold=1e-15))}


def init_model(spec: ExpSpec, seed: int = 0):
    model_cfg = {
        "num_classes": 2,
        "crop_size": spec.crop_size,
        "base_size": spec.base_size,
        "syncbn": True,
        "aux": True,
        "aux_weight": 0.5,
    }
    model = DeepLabV3Plus(nclass=2, backbone="resnet50", aux=True,
                          crop_size=spec.crop_size,
                          generator=torch.Generator().manual_seed(seed))
    return model, model_cfg


def datasets(args, spec: ExpSpec):
    """-> (trainset, valset) of ``args.input_path``: uint8 images
    (normalised on the device) through the reference's augmentations."""
    crop_size = spec.crop_size
    train_augmentator = RGBSegmentationAug([
        HorizontalFlip(),
        ShiftScaleRotate(scale_limit=(-0.25, 0.25),
                         rotate_limit=spec.rotate_limit, p=1),
        PadIfNeeded(min_height=crop_size, min_width=crop_size),
        RandomCrop(crop_size, crop_size),
    ], ignore_class=-1)
    val_augmentator = RGBSegmentationAug([
        PadIfNeeded(min_height=crop_size, min_width=crop_size),
        CenterCrop(crop_size, crop_size),
    ], ignore_class=-1)
    native_reader = getattr(args, "reader", "cv2") == "native"
    trainset = FFHQHairSegmentation(
        args.input_path, scale_factor=spec.scale_factor,
        train_epoch_len=spec.train_epoch_len, split="train",
        subdir=spec.train_subdir, transform=None,
        augmentator=train_augmentator, native_reader=native_reader)
    valset = FFHQHairSegmentation(
        args.input_path, scale_factor=spec.scale_factor, split="val",
        transform=None, augmentator=val_augmentator,
        native_reader=native_reader)
    return trainset, valset


def train(args, spec: ExpSpec) -> SegmentationTrainer:
    logger.info("start training..")
    model, model_cfg = init_model(spec, getattr(args, "seed", 0))
    trainset, valset = datasets(args, spec)
    optimizer_params = {"mode": "poly", "baselr": spec.lr,
                        "nepochs": spec.num_epochs,
                        "wd": spec.weight_decay, "momentum": 0.9}
    trainer = SegmentationTrainer(args, model, model_cfg, trainset, valset,
                                  optimizer_params, image_dump_interval=50)
    # SIGTERM -> step-granular resume bundle; a restart with --resume in
    # the same run dir picks up mid-epoch
    start_epoch, start_iter = args.start_epoch, 0
    if getattr(args, "auto_resume", True):
        pos = trainer.try_resume()
        if pos is not None:
            start_epoch, start_iter = pos
    if getattr(args, "preempt_save", True):
        trainer.install_preemption_handler()
    logger.info("Starting Epoch: %d", start_epoch)
    logger.info("Total Epochs: %d", spec.num_epochs)
    for epoch in range(start_epoch, spec.num_epochs):
        trainer.training(epoch,
                         start_iter=start_iter if epoch == start_epoch else 0)
        if trainer.preempted:
            logger.info("training preempted; continue with "
                        "`train --resume %s` (same flags) to pick up "
                        "mid-epoch from the saved bundle", args.run_path)
            return trainer
        trainer.validation(epoch)
        # the epoch's checkpoint is newer than any bundle of an earlier
        # preemption: drop the bundle now, so that a later crash without a
        # bundle of its own does not roll a --resume back to it
        trainer.clear_resume_bundle()
    return trainer


def test(args, spec: ExpSpec):
    model, model_cfg = init_model(spec)
    tester = SegmentationTester(model, args,
                                num_classes=model_cfg["num_classes"],
                                use_flip=True, scales=[1.0],
                                threshold=spec.test_threshold,
                                base_size=spec.base_size,
                                crop_size=spec.crop_size)
    testset = FFHQHairSegmentation(
        args.input_path, scale_factor=spec.scale_factor, split="val",
        transform=imagenet_transform, augmentator=None,
        return_path=args.vizualization,
        native_reader=getattr(args, "reader", "cv2") == "native")
    if args.vizualization:
        tester.vizualizate(testset, args.viz_path, suffix="_rgb", save_gt=True)
        return tester
    tester.test(testset)
    return tester


def add_exp_args(parser):
    parser.add_argument("--input-path", type=str, help="Path to dataset",
                        default="../../../experiments/ffhq-hair/dataset")
    parser.add_argument("--backbone-weights", type=str, default=None,
                        help="gluoncv resnet50_v1s .params file (ImageNet "
                             "pretrained backbone, converted on load)")
    parser.add_argument("--reader", choices=["cv2", "native"], default="cv2",
                        help="host decode path: cv2, or the native C++ "
                             "reader with the scale factor fused into the "
                             "JPEG decode (cv2 where the native library is "
                             "unavailable)")
    parser.add_argument("--no-auto-resume", dest="auto_resume",
                        action="store_false", default=True,
                        help="ignore a mid-epoch resume bundle left by a "
                             "preempted run")
    parser.add_argument("--no-preempt-save", dest="preempt_save",
                        action="store_false", default=True,
                        help="do not install the SIGTERM checkpoint-and-"
                             "stop handler")
    # smoke-scale overrides (not in the reference CLI)
    parser.add_argument("--crop-size", type=int, default=None)
    parser.add_argument("--base-size", type=int, default=None)
    parser.add_argument("--epochs", type=int, default=None)
    parser.add_argument("--epoch-len", type=int, default=None)
    parser.add_argument("--scale-factor", type=float, default=None)
    return parser


def apply_overrides(spec: ExpSpec, args) -> ExpSpec:
    updates = {}
    if getattr(args, "crop_size", None):
        updates["crop_size"] = args.crop_size
    if getattr(args, "base_size", None):
        updates["base_size"] = args.base_size
    if getattr(args, "epochs", None):
        updates["num_epochs"] = args.epochs
    if getattr(args, "epoch_len", None):
        updates["train_epoch_len"] = args.epoch_len
    if getattr(args, "scale_factor", None):
        updates["scale_factor"] = args.scale_factor
    return dataclasses.replace(spec, **updates) if updates else spec


def run(spec: ExpSpec, argv=None, exp_path=None):
    """Train or test ``spec`` as the command line ``argv`` says; runs go
    under ``exp_path`` (default ``experiments/rgb_segmentation/<name>``).
    -> the ``SegmentationTrainer`` or ``SegmentationTester``; None where
    ``--gpus`` / ``--ngpus`` named several cards, which spawns one training
    process per card, each running this with the same command line."""
    exp_path = EXPERIMENTS_DIR / spec.name if exp_path is None else exp_path
    args = init_exp(exp_path, add_exp_args, argv, run_file=__file__)
    if args.spawn_devices:
        spawn_world(args.spawn_devices, run, (
            spec, sys.argv[1:] if argv is None else list(argv), exp_path))
        return None
    spec = apply_overrides(spec, args)
    if args.mode == "train":
        return train(args, spec)
    return test(args, spec)


def main(argv=None):
    argv = sys.argv[1:] if argv is None else list(argv)
    if not argv or argv[0] not in SPECS:
        sys.exit("usage: python -m gan_segmentation_tpu_torch.train."
                 "rgb_experiments {" + ",".join(SPECS) + "} {train|test} "
                 "[options]")
    try:
        run(SPECS[argv[0]], argv[1:])
    finally:  # under a launcher: the trainer and its graphs are gone
        dist_.shutdown()


if __name__ == "__main__":
    main()
