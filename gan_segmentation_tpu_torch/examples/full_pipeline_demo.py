"""End-to-end pipeline demo at toy scale, steps 1-5 in one process (the
port's counterpart of the JAX package's ``examples/full_pipeline_demo.py``):

1. fabricate ``--n-annotations`` 'human' annotations from the seeded random
   bedrooms generator (annotate by fixture: the mask is the sign of channel
   0 of the last feature);
2. train the decoder on them (``main train``) and evaluate it on them: the
   mean IoU must pass 0.5;
3. emit a synthetic (image, mask) dataset with the fused z -> (image, mask)
   pipeline (``main generate``), written as JPEG / PNG by cv2;
4. train DeepLabV3+ (resnet50) at crop = the resolution on it, each train
   step a replay of one CUDA graph on the card, and validate on held-out
   pairs after each epoch.

Runs on the card; ``--cpu`` runs it on the CPU instead:

    python -m gan_segmentation_tpu_torch.examples.full_pipeline_demo \\
        [--workdir DIR] [--max-res-log2 6] [--cpu]

``main(argv)`` returns each stage's seconds, the decoder's evaluation and
DeepLab's last validation.
"""

import argparse
import time
import types
from pathlib import Path

import numpy as np


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workdir", default="ganseg_demo")
    ap.add_argument("--max-res-log2", type=int, default=6)  # 64 px
    ap.add_argument("--n-annotations", type=int, default=12)
    ap.add_argument("--n-generate", type=int, default=96)
    ap.add_argument("--decoder-epochs", type=int, default=10)
    ap.add_argument("--deeplab-epochs", type=int, default=2)
    ap.add_argument("--deeplab-epoch-len", type=int, default=64)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU instead of the card")
    return ap.parse_args(argv)


def mask_rule(feats):
    """A rule the decoder can learn: the sign of the last feature's
    channel 0."""
    return (feats[-1][..., 0] > 0).astype(np.int32)


def annotate(gen, dst: Path, n: int) -> int:
    from ..data.collection import save_annotation_sample

    made = 0
    for img, feats in gen.get_images(n):
        save_annotation_sample(str(dst), made, img, mask_rule(feats), feats)
        made += 1
    return made


def train_decoder(args, device, work: Path):
    from ..core.config import SolverConfig
    from ..train.solver import SegSolver

    cfg = SolverConfig(max_res_log2=args.max_res_log2,
                       train_epochs=args.decoder_epochs)
    solver = SegSolver(args.max_res_log2, str(work / "data"),
                       str(work / "checkpoints"), cfg=cfg,
                       keep_weights=False, device=device)
    solver.fit()
    return solver, dict(solver.evaluate(str(work / "data")))


def emit_dataset(pipe, work: Path, n_train: int, n_val: int) -> None:
    import cv2

    for i, (img, mask) in enumerate(pipe.generate_pairs(n_train + n_val)):
        sub = "train_generated" if i < n_train else "val"
        j = i if i < n_train else i - n_train
        cv2.imwrite(str(work / "dataset" / sub / f"img_{j:06d}.jpg"),
                    img[:, :, ::-1])
        cv2.imwrite(str(work / "dataset" / sub / f"mask_{j:06d}.png"), mask)


def train_deeplab(args, device, work: Path) -> dict:
    """DeepLabV3+ on the emitted pairs; -> the last validation."""
    from ..data.augment import (CenterCrop, HorizontalFlip, PadIfNeeded,
                                RandomCrop, RGBSegmentationAug)
    from ..data.segmentation import FFHQHairSegmentation
    from ..models.deeplab import DeepLabV3Plus
    from ..train.deeplab_trainer import SegmentationTrainer

    res = 2 ** args.max_res_log2
    crop = res
    targs = types.SimpleNamespace(
        batch_size=8, test_batch_size=8, workers=0, weights=None,
        logs_path=None, checkpoints_path=work / "runs" / "checkpoints",
        seed=0, device=device)
    model = DeepLabV3Plus(nclass=2, aux=True, crop_size=crop)
    model_cfg = {"num_classes": 2, "crop_size": crop, "base_size": res,
                 "aux": True, "aux_weight": 0.5}
    aug = RGBSegmentationAug([HorizontalFlip(), PadIfNeeded(crop, crop),
                              RandomCrop(crop, crop)], ignore_class=-1)
    vaug = RGBSegmentationAug([PadIfNeeded(crop, crop),
                               CenterCrop(crop, crop)], ignore_class=-1)
    # transform=None: uint8 images, normalised on the device
    trainset = FFHQHairSegmentation(
        str(work / "dataset"), split="train", subdir="train_generated",
        train_epoch_len=args.deeplab_epoch_len, transform=None,
        augmentator=aug, rng_seed=0)
    valset = FFHQHairSegmentation(str(work / "dataset"), split="val",
                                  transform=None, augmentator=vaug)
    trainer = SegmentationTrainer(
        targs, model, model_cfg, trainset, valset,
        {"mode": "poly", "baselr": 0.005, "nepochs": args.deeplab_epochs,
         "wd": 2e-4, "momentum": 0.9}, image_dump_interval=0)
    metrics = {}
    for epoch in range(args.deeplab_epochs):
        trainer.training(epoch)
        metrics = trainer.validation(epoch)
    return dict(metrics, graphed=trainer.graphed)


def main(argv=None) -> dict:
    args = parse_args(argv)
    import torch

    from ..core import dtypes
    from ..train.generator import FusedPipeline, ImageGenerator

    device = torch.device("cpu") if args.cpu else dtypes.cuda_device()
    work = Path(args.workdir)
    for sub in ("data", "checkpoints", "dataset/train_generated",
                "dataset/val", "runs"):
        (work / sub).mkdir(parents=True, exist_ok=True)
    print(f"== device: {device}", flush=True)
    seconds = {}

    # ---- 1. annotate by fixture -----------------------------------------
    t0 = time.time()
    gen = ImageGenerator(gan="bedrooms", gan_dir=str(work / "no-models"),
                         batch_size=8, max_res_log2=args.max_res_log2,
                         dtype="bf16", device=device)
    made = annotate(gen, work / "data", args.n_annotations)
    seconds["annotate"] = time.time() - t0
    print(f"== wrote {made} annotation triples in "
          f"{seconds['annotate']:.1f}s", flush=True)

    # ---- 2. decoder training ---------------------------------------------
    t0 = time.time()
    solver, decoder = train_decoder(args, device, work)
    seconds["decoder"] = time.time() - t0
    print(f"== decoder trained in {seconds['decoder']:.1f}s; train-set "
          f"eval: acc={decoder['accuracy']:.3f} "
          f"mIoU={decoder['mean-iou']:.3f}", flush=True)
    if not decoder["mean-iou"] > 0.5:
        raise RuntimeError(f"the decoder failed to learn the rule: "
                           f"mean-iou {decoder['mean-iou']:.3f}")

    # ---- 3. synthetic dataset emission (fused) ---------------------------
    t0 = time.time()
    n_train = args.n_generate
    n_val = max(8, n_train // 8)
    emit_dataset(FusedPipeline(gen, solver), work, n_train, n_val)
    seconds["generate"] = time.time() - t0
    print(f"== emitted {n_train + n_val} pairs in {seconds['generate']:.1f}s "
          f"({(n_train + n_val) / seconds['generate']:.1f} pairs/s incl. "
          f"JPEG encode)", flush=True)

    # ---- 4. DeepLabV3+ on the synthetic data -----------------------------
    t0 = time.time()
    deeplab = train_deeplab(args, device, work)
    seconds["deeplab"] = time.time() - t0
    print(f"== deeplab trained in {seconds['deeplab']:.1f}s "
          f"({'graphed' if deeplab['graphed'] else 'eager'} steps); val "
          f"pixAcc={deeplab.get('accuracy', 0):.3f} "
          f"mIoU={deeplab.get('mean-iou', 0):.3f}", flush=True)
    print("== full pipeline OK", flush=True)
    return dict(seconds=seconds, decoder=decoder, deeplab=deeplab,
                pairs=n_train + n_val, annotations=made)


if __name__ == "__main__":
    main()
