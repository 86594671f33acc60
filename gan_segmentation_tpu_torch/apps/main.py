"""CLI entry point of the PyTorch port:

    python -m gan_segmentation_tpu_torch.apps.main \
        [annotation|train|evaluate|generate] --config config.yml

reads ``config.yml`` (keys at reference `main.py:33-43`), seeds numpy with
0, and runs on the CUDA card:
- ``annotation`` (the default) the tkinter annotator over GAN samples
  (``apps/annotator.py``): brush strokes to trimaps, Retrain, Generate;
- ``train``    decoder training on ``BASE_DIR/data`` (checkpoint to
  ``BASE_DIR/checkpoints``);
- ``evaluate`` the trained decoder on ``BASE_DIR/eval``: prints accuracy,
  mean-iou and total-loss;
- ``generate`` the synthetic-dataset emitter: z -> image and mask in one
  device pass, only uint8 crossing to the host; ``--dp D`` splits each
  batch over D cards of this process (0: every card), ``--spatial N``
  each image's height over N cards (a D x N grid with ``--dp``).

Under a launcher (``torchrun --nproc-per-node N -m
gan_segmentation_tpu_torch.apps.main train|evaluate|generate``) each
process joins the NCCL group on ``cuda:LOCAL_RANK`` (``core/
distributed.py``): ``train`` fits data-parallel (the solver's
``train_batch_size`` is the global batch), ``evaluate`` runs on the
primary, and ``generate`` gives each process its own z stream (seed =
rank) and the disjoint index slice ``rank * ceil(N / P)`` onward.
"""

import argparse
import logging
import os
import sys
from os import makedirs
from os.path import isfile, join
from typing import Optional

import numpy as np

from ..core import distributed as dist_
from ..core.config import load_config_file
from ..core.mesh import generate_devices
from ..train.generator import FusedPipeline, ImageGenerator
from ..train.solver import SegSolver

log = logging.getLogger(__name__)


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("action", nargs="?",
                        choices=("annotation", "train", "evaluate", "generate"),
                        default="annotation")
    parser.add_argument("--config", default="config.yml")
    parser.add_argument(
        "--spatial", type=int, default=1, metavar="N",
        help="generate: split each image's height into N row bands over N "
             "cards of this process (spatial parallelism; the cards/N rows "
             "of the grid run data-parallel, or --dp D of them).  Without "
             "--dp, N must divide the card count.  For a lower per-sample "
             "latency or images larger than one card holds; for throughput "
             "use --dp.  The pairs match --spatial 1 up to the rounding of "
             "the split sums; not with --quant")
    parser.add_argument(
        "--dp", type=int, default=1, metavar="D",
        help="generate: split each batch over D cards of this process "
             "(0: every card); composes with --quant.  The pairs match "
             "--dp 1 up to bf16 rounding, as the JAX package's do: each "
             "card computes its part at batch B/D, and kernels 1 and 2 "
             "split their float sums by the batch size (their s8 bodies' "
             "integer sums are exact in any split)")
    parser.add_argument(
        "--resume", action="store_true", default=False,
        help="generate: continue an interrupted emission — keep the "
             "contiguous (image, mask) pairs already on disk, fast-forward "
             "the seeded z stream past them, and write only the remainder "
             "(the pairs produced are identical to an uninterrupted run)")
    parser.add_argument(
        "--quant", choices=("none", "int8", "int8-full"), default="none",
        help="generate: post-training int8 quantization.  'int8': the "
             "decoder's convs in s8 (the s8 bodies of kernels 1 and 2), "
             "activation scales calibrated on two fixed generator batches "
             "disjoint from the emission stream, so --resume stays "
             "byte-identical; 'int8-full': the generator's synthesis convs "
             "too.  Masks agree with 'none' on most pixels; validate on "
             "trained weights before production emission")
    parser.add_argument(
        "--writer", choices=("auto", "native", "cv2"), default="auto",
        help="generate: host-side pair writer. 'native' is the C++ threaded "
             "JPEG/PNG encoder (gan_segmentation_tpu_torch.native); 'cv2' the "
             "sequential loop; 'auto' picks native when it builds.")
    return parser.parse_args(argv)


def build_solver(cfg, keep_weights=False):
    return SegSolver(cfg.max_res_log2, join(cfg.BASE_DIR, "data"),
                     join(cfg.BASE_DIR, "checkpoints"),
                     keep_weights=keep_weights, cfg=cfg.solver_config())


def run_train(cfg):
    solver = build_solver(cfg, keep_weights=False)
    solver.fit()


def run_evaluate(cfg):
    if not dist_.is_primary():  # the primary evaluates
        return
    solver = build_solver(cfg, keep_weights=False)
    if not solver.is_trained:
        print("train Decoder first!")
        sys.exit(-1)
    result = solver.evaluate(join(cfg.BASE_DIR, "eval"))
    print(", ".join(f"{name}: {value:.4f}" for name, value in result))


def _write_pairs_native(pipeline, n_local: int, dst_dir: str, start: int,
                        progress) -> None:
    """The C++ threaded writer: masks stay bit-packed into the PNG encoder,
    images are encoded as RGB, and encoding overlaps device compute."""
    from ..native import PairWriter
    with PairWriter() as writer:
        index = start
        for imgs, masks, packed in pipeline.generate_batches(n_local):
            width = imgs.shape[2]
            for i in range(imgs.shape[0]):
                writer.submit(join(dst_dir, f"img_{index:06d}.jpg"),
                              join(dst_dir, f"mask_{index:06d}.png"),
                              img=imgs[i], mask=masks[i], mask_packed=packed,
                              mask_width=width)
                index += 1
                if progress is not None:
                    progress.update()


def _write_pairs_cv2(pipeline, n_local: int, dst_dir: str, start: int,
                     progress) -> None:
    """Sequential writer loop (reference `main.py:96-104`).  Writes are
    atomic (tmp + rename), the invariant `resume_offset` relies on."""
    import cv2

    def atomic_write(name: str, arr) -> None:
        tmp = join(dst_dir, ".tmp_" + name)
        if not cv2.imwrite(tmp, arr):
            raise RuntimeError(f"cv2.imwrite failed for {name}")
        os.replace(tmp, join(dst_dir, name))

    for index, (img, mask) in enumerate(pipeline.generate_pairs(n_local)):
        atomic_write(f"img_{start + index:06d}.jpg", img[:, :, ::-1])
        atomic_write(f"mask_{start + index:06d}.png", mask)
        if progress is not None:
            progress.update()


def resume_offset(dst_dir: str, start: int, n_local: int,
                  batch_size: int) -> int:
    """How many of this process's pairs an interrupted `generate` already
    wrote, rounded DOWN to a batch boundary.

    A copy of ``gan_segmentation_tpu/apps/main.py::resume_offset`` (that
    module imports jax); ``tests/test_torch_app.py`` pins the two together.
    Counts the contiguous run of complete (img, mask) pairs from ``start``
    (both writers are atomic), backs off one pair for files written by other
    tools, and rounds down to a multiple of ``batch_size`` so the resumed z
    stream stays batch-aligned."""
    done = 0
    while done < n_local:
        idx = start + done
        if not (isfile(join(dst_dir, f"img_{idx:06d}.jpg"))
                and isfile(join(dst_dir, f"mask_{idx:06d}.png"))):
            break
        done += 1
    return (max(0, done - 1) // batch_size) * batch_size


def run_generate(cfg, spatial: int = 1, writer: str = "auto",
                 resume: bool = False, quant: Optional[str] = None,
                 dp: int = 1):
    """Emit ``GENERATE_NUM`` pairs; under a launcher this process's slice
    of them, from its own z stream.  ``dp``: the cards of this process over
    which each batch is split, ``spatial``: the cards over which each image's
    height is split (``core/mesh.py::generate_devices``)."""
    if quant not in (None, "int8", "int8-full"):
        raise SystemExit(f"--quant: unknown mode {quant!r}")
    pc, pi = dist_.process_count(), dist_.process_index()
    if spatial > 1 and pc > 1:
        # the grid's bands live in one process: a band exchange across
        # processes is not there, and each process draws its own z stream
        raise SystemExit(
            "--spatial > 1 is a single-process capability; run spatial "
            "generation in one process (it already uses every local "
            "card), or drop --spatial for generation over several "
            "processes")
    try:
        mesh = generate_devices(spatial, dp=None if dp == 1 else dp)
    except ValueError as exc:
        raise SystemExit(str(exc))
    if mesh is not None and pc > 1:
        raise SystemExit("--dp splits the batches of one process over its "
                         "cards; under a launcher each process generates "
                         "on its own card: drop --dp")
    solver = build_solver(cfg)
    if not solver.is_trained:
        print("train Decoder first!")
        sys.exit(-1)

    # several processes: each its own z stream (seed = rank) and a disjoint
    # contiguous slice of the global index range
    n_total = cfg.GENERATE_NUM
    share = (n_total + pc - 1) // pc
    start = pi * share
    n_local = max(0, min(share, n_total - start))
    batch_size = cfg.GAN_BATCH_SIZE_PER_GPU * max(1, len(cfg.GAN_GPU_IDS))
    netG = ImageGenerator(gan=cfg.GAN, gan_dir=cfg.GAN_DIR,
                          batch_size=batch_size,
                          max_res_log2=cfg.MAX_RES_LOG2, seed=pi)
    if mesh is not None and spatial > 1:
        log.info("generation grid (data=%d, space=%d): each batch of %d "
                 "split over the rows, each image's height into %d row "
                 "bands over a row's cards", len(mesh), spatial, batch_size,
                 spatial)
    elif mesh is not None:
        log.info("generate over %d cards: each batch of %d split over them",
                 len(mesh), batch_size)
    if quant is not None:
        log.info("int8 generation: %s", quant)
    try:
        pipeline = FusedPipeline(netG, solver, mesh=mesh, quant=quant)
    except ValueError as exc:  # --quant with --spatial, too few rows
        raise SystemExit(str(exc))

    dst_dir = join(cfg.BASE_DIR, "dataset", "train_generated")
    makedirs(dst_dir, exist_ok=True)

    skip = 0
    if resume:
        skip = resume_offset(dst_dir, start, n_local, batch_size)
        if skip:
            netG.skip_batches(skip // batch_size)
            log.info("resume: %d pairs already on disk, fast-forwarded the "
                     "z stream %d batches; writing indices %d..%d",
                     skip, skip // batch_size, start + skip,
                     start + n_local - 1)
    n_todo = n_local - skip

    progress = None
    try:
        from tqdm import tqdm
        progress = tqdm(total=n_todo)
    except ImportError:
        pass
    if writer == "auto":
        from ..native import native_available
        writer = "native" if native_available() else "cv2"
    log.info("pair writer: %s", writer)
    write = _write_pairs_native if writer == "native" else _write_pairs_cv2
    write(pipeline, n_todo, dst_dir, start + skip, progress)
    if progress is not None:
        progress.close()
    log.info("wrote %d (image, mask) pairs to %s (indices %d..%d)",
             n_todo, dst_dir, start + skip, start + n_local - 1)


def run_annotation(cfg):
    import tkinter as tk

    from .annotator import SegmentationAnnotator

    root = tk.Tk()
    if cfg.ANNOTATION == "segmentation":
        SegmentationAnnotator(
            root, cfg.BASE_DIR, gan_dir=cfg.GAN_DIR, gan=cfg.GAN,
            n_generate=cfg.GENERATE_NUM,
            gan_batch_size=(cfg.GAN_BATCH_SIZE_PER_GPU
                            * max(1, len(cfg.GAN_GPU_IDS))),
        ).pack(fill="both", expand=True)
    else:
        print(f"uknown annotation type: {cfg.ANNOTATION}")
        return
    root.mainloop()


def main(argv=None):
    logging.basicConfig(level=logging.INFO,
                        format="%(levelname)s:%(name)s:%(message)s")
    args = parse_args(argv)
    np.random.seed(0)  # `main.py:29-31`
    dist_.initialize()  # under a launcher: this process's card and group
    cfg = load_config_file(args.config)
    try:
        if args.action == "train":
            run_train(cfg)
        elif args.action == "evaluate":
            run_evaluate(cfg)
        elif args.action == "generate":
            run_generate(cfg, spatial=args.spatial, writer=args.writer,
                         resume=args.resume,
                         quant=None if args.quant == "none" else args.quant,
                         dp=args.dp)
        else:
            run_annotation(cfg)
    finally:
        dist_.shutdown()


if __name__ == "__main__":
    main()
