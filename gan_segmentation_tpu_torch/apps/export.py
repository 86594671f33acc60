"""Serving-export CLI: freeze trained inference programs into artifacts that
a process with no model code serves (``core/export.py``), on the CUDA
device they will serve on.

    # z -> (image, mask) generate pipeline (weights inside):
    python -m gan_segmentation_tpu_torch.apps.export generate \\
        --config config.yml -o generate.pt2 --batch 8
    # the same as a program + weights bundle directory:
    python -m gan_segmentation_tpu_torch.apps.export generate \\
        --config config.yml -o generate.bundle --bundle

    # DeepLab multi-scale + flip eval protocol at a fixed input shape
    # (the artifact emits per-class SCORES; thresholding stays in the
    # consumer's label map):
    python -m gan_segmentation_tpu_torch.apps.export deeplab \\
        --weights runs/train_x/checkpoints/last_checkpoint.pt \\
        -o deeplab_eval.pt2 --shape 1,512,512,3

``--platforms`` (the JAX package's cross-platform lowering) is accepted
only at its default: an artifact serves on the device type it was exported
on.
"""

import argparse
import logging

log = logging.getLogger(__name__)


def parse_args(argv=None):
    parser = argparse.ArgumentParser(
        description="freeze trained inference programs into serving "
                    "artifacts")
    sub = parser.add_subparsers(dest="what", required=True)

    g = sub.add_parser("generate", help="fused z -> (image, mask) pipeline")
    g.add_argument("--config", default="config.yml")
    g.add_argument("-o", "--output", default="generate.pt2")
    g.add_argument("--batch", type=int, default=0,
                   help="serving batch (default: config batch)")
    g.add_argument("--bundle", action="store_true",
                   help="write a program+weights bundle DIRECTORY instead "
                        "of a single hermetic file (weights in weights.pt, "
                        "swappable without re-export)")
    g.add_argument("--platforms", default=None,
                   help="cross-device lowering (not ported; only the "
                        "default is accepted)")

    d = sub.add_parser("deeplab", help="multi-scale+flip eval protocol")
    d.add_argument("--weights", required=True,
                   help="a DeepLab checkpoint as load_checkpoint reads it "
                        "(the port's *.pt, the JAX package's msgpack, an "
                        "mxnet DeepLabV3+ file)")
    d.add_argument("-o", "--output", default="deeplab_eval.pt2")
    d.add_argument("--shape", default="1,512,512,3",
                   help="B,H,W,C of the (normalized f32) serving input")
    d.add_argument("--nclass", type=int, default=2)
    d.add_argument("--backbone", default="resnet50")
    d.add_argument("--crop-size", type=int, default=480)
    d.add_argument("--base-size", type=int, default=512)
    d.add_argument("--no-flip", action="store_true")
    d.add_argument("--scales", default="1.0")
    d.add_argument("--platforms", default=None,
                   help="cross-device lowering (not ported; only the "
                        "default is accepted)")
    return parser.parse_args(argv)


def export_generate(args):
    from ..core.export import (export_fused_pipeline,
                               export_fused_pipeline_bundle)
    from ..core.config import load_config_file
    from ..train.generator import FusedPipeline, ImageGenerator
    from .main import build_solver

    cfg = load_config_file(args.config)
    solver = build_solver(cfg, keep_weights=False)
    if not solver.is_trained:
        raise SystemExit("train Decoder first!")
    batch = args.batch or (cfg.GAN_BATCH_SIZE_PER_GPU
                           * max(1, len(cfg.GAN_GPU_IDS)))
    netG = ImageGenerator(gan=cfg.GAN, gan_dir=cfg.GAN_DIR, batch_size=batch,
                          max_res_log2=cfg.MAX_RES_LOG2, seed=0)
    pipeline = FusedPipeline(netG, solver)
    if args.bundle:
        export_fused_pipeline_bundle(pipeline, batch, args.output)
    else:
        export_fused_pipeline(pipeline, batch, args.output)


def export_deeplab(args):
    from ..core import dtypes
    from ..core.export import export_eval_model
    from ..models.deeplab import DeepLabV3Plus
    from ..train.deeplab_trainer import MultiEvalModel, load_checkpoint

    b, h, w, c = (int(x) for x in args.shape.split(","))
    model = DeepLabV3Plus(nclass=args.nclass, backbone=args.backbone,
                          aux=True, crop_size=args.crop_size, in_channels=c)
    load_checkpoint(args.weights, model)
    evaluator = MultiEvalModel(
        model.to(dtypes.cuda_device()), args.nclass,
        base_size=args.base_size, crop_size=args.crop_size,
        flip=not args.no_flip,
        scales=tuple(float(s) for s in args.scales.split(",")))
    export_eval_model(evaluator, b, h, w, c, args.output)


def main(argv=None):
    logging.basicConfig(level=logging.INFO,
                        format="%(levelname)s:%(name)s:%(message)s")
    args = parse_args(argv)
    if args.platforms is not None:
        raise SystemExit("--platforms (cross-device lowering) is not ported:"
                         " an artifact serves on the device it was exported "
                         "on; drop the flag")
    if args.what == "generate":
        export_generate(args)
    else:
        export_deeplab(args)


if __name__ == "__main__":
    main()
