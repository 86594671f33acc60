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

Pass ``--platforms cpu,cuda`` for one artifact that serves on either
device type (the JAX package's cross-platform lowering): it is traced on
the card where there is one, else on the CPU, so no card is needed at
export time; the loader moves it to the device it serves on.  Without the
flag an artifact serves on the device type it was exported on.
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
                   help="comma-separated device types the artifact serves "
                        "on, e.g. cpu,cuda")

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
                   help="comma-separated device types the artifact serves "
                        "on, e.g. cpu,cuda")
    return parser.parse_args(argv)


def _platforms(arg):
    return tuple(p.strip() for p in arg.split(",")) if arg else None


def export_device(platforms):
    """The device to trace on: the card, unless the listed platforms leave
    it out, or name the CPU on a host without a card."""
    import torch

    from ..core import dtypes
    if platforms and "cpu" in platforms and (
            "cuda" not in platforms or not torch.cuda.is_available()):
        return torch.device("cpu")
    return dtypes.cuda_device()


def export_generate(args):
    from os.path import join

    from ..core.config import load_config_file
    from ..core.export import (export_fused_pipeline,
                               export_fused_pipeline_bundle)
    from ..train.generator import FusedPipeline, ImageGenerator
    from ..train.solver import SegSolver

    platforms = _platforms(args.platforms)
    dev = export_device(platforms)
    cfg = load_config_file(args.config)
    solver = SegSolver(cfg.max_res_log2, join(cfg.BASE_DIR, "data"),
                       join(cfg.BASE_DIR, "checkpoints"),
                       keep_weights=False, cfg=cfg.solver_config(),
                       device=dev)
    if not solver.is_trained:
        raise SystemExit("train Decoder first!")
    batch = args.batch or (cfg.GAN_BATCH_SIZE_PER_GPU
                           * max(1, len(cfg.GAN_GPU_IDS)))
    netG = ImageGenerator(gan=cfg.GAN, gan_dir=cfg.GAN_DIR, batch_size=batch,
                          max_res_log2=cfg.MAX_RES_LOG2, seed=0, device=dev)
    pipeline = FusedPipeline(netG, solver)
    if args.bundle:
        export_fused_pipeline_bundle(pipeline, batch, args.output, platforms)
    else:
        export_fused_pipeline(pipeline, batch, args.output, platforms)


def export_deeplab(args):
    from ..core.export import export_eval_model
    from ..models.deeplab import DeepLabV3Plus
    from ..train.deeplab_trainer import MultiEvalModel, load_checkpoint

    b, h, w, c = (int(x) for x in args.shape.split(","))
    model = DeepLabV3Plus(nclass=args.nclass, backbone=args.backbone,
                          aux=True, crop_size=args.crop_size, in_channels=c)
    load_checkpoint(args.weights, model)
    platforms = _platforms(args.platforms)
    evaluator = MultiEvalModel(
        model.to(export_device(platforms)), args.nclass,
        base_size=args.base_size, crop_size=args.crop_size,
        flip=not args.no_flip,
        scales=tuple(float(s) for s in args.scales.split(",")))
    export_eval_model(evaluator, b, h, w, c, args.output, platforms)


def main(argv=None):
    logging.basicConfig(level=logging.INFO,
                        format="%(levelname)s:%(name)s:%(message)s")
    args = parse_args(argv)
    from ..core.export import PLATFORMS
    bad = set(_platforms(args.platforms) or ()) - set(PLATFORMS)
    if bad:
        raise SystemExit(f"--platforms {args.platforms}: the port serves on "
                         f"{', '.join(PLATFORMS)}, not on "
                         f"{', '.join(sorted(bad))}")
    if args.what == "generate":
        export_generate(args)
    else:
        export_deeplab(args)


if __name__ == "__main__":
    main()
