"""Serving demo at toy scale: train -> export -> serve with no model code
(the port's counterpart of the JAX package's ``examples/serving_demo.py``).

1. fabricate annotations with the port's seeded random generator (the mask
   is the sign of channel 0 of the last feature, the top two rows left
   unannotated) and train the decoder on them;
2. export the fused z -> (image, mask) pipeline as a program + weights
   BUNDLE (``core/export.py::export_fused_pipeline_bundle``);
3. serve it from a fresh interpreter that imports only ``core.export`` and
   ``native`` (no model code): draw each batch's inputs from a seed, run the
   bundle, and write the pairs through the port's native ``PairWriter``
   (cv2 where the native writer is unavailable).

Runs on the card; ``--cpu`` runs it on the CPU instead:

    python -m gan_segmentation_tpu_torch.examples.serving_demo \\
        [--workdir DIR] [--cpu]
"""

import argparse
import os
import subprocess
import sys
import time
from os.path import join

import numpy as np


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workdir", default="ganseg_serving_demo")
    ap.add_argument("--max-res-log2", type=int, default=6)  # 64 px
    ap.add_argument("--n-annotations", type=int, default=8)
    ap.add_argument("--n-serve", type=int, default=32)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--decoder-epochs", type=int, default=6)
    ap.add_argument("--seed", type=int, default=42,
                    help="seed of the served batches' z and noise")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU instead of the card")
    ap.add_argument("--serve", metavar="BUNDLE", default=None,
                    help="step 3 alone: serve BUNDLE into --workdir/served "
                         "(what the fresh interpreter runs)")
    return ap.parse_args(argv)


def make_annotations(gen, dst: str, n: int) -> None:
    """Write the next ``n`` samples of ``gen`` as annotated triples."""
    from ..data.collection import save_annotation_sample

    os.makedirs(dst, exist_ok=True)
    done = 0
    while done < n:
        imgs, feats, _ = gen.sample_batch()
        imgs = imgs.cpu().numpy()
        for i in range(min(imgs.shape[0], n - done)):
            fs = [f[i].float().cpu().numpy() for f in feats]
            trimap = (fs[-1][..., 0] > 0).astype(np.int32)
            trimap[:2] = -1
            save_annotation_sample(dst, done, imgs[i], trimap, fs)
            done += 1


def train_and_export(args, bundle_dir: str) -> None:
    import torch

    from ..core import dtypes
    from ..core.config import SolverConfig
    from ..core.export import export_fused_pipeline_bundle
    from ..train.generator import FusedPipeline, ImageGenerator
    from ..train.solver import SegSolver

    device = torch.device("cpu") if args.cpu else dtypes.cuda_device()
    res = 2 ** args.max_res_log2
    data_dir = join(args.workdir, "data")
    print(f"[1/3] training the decoder at {res}px on {args.n_annotations} "
          f"fabricated annotations ({device.type}) ...", flush=True)
    gen = ImageGenerator(gan="bedrooms", batch_size=args.batch,
                         max_res_log2=args.max_res_log2, seed=0,
                         gan_dir=join(args.workdir, "no-models"),
                         device=device)
    make_annotations(gen, data_dir, args.n_annotations)
    cfg = SolverConfig(max_res_log2=args.max_res_log2,
                       train_epochs=args.decoder_epochs)
    solver = SegSolver(args.max_res_log2, data_dir,
                       join(args.workdir, "checkpoints"), cfg=cfg,
                       device=device)
    solver.fit()

    print("[2/3] exporting the fused pipeline as a serving bundle ...",
          flush=True)
    export_fused_pipeline_bundle(FusedPipeline(gen, solver), args.batch,
                                 bundle_dir)
    sizes = {f: os.path.getsize(join(bundle_dir, f))
             for f in sorted(os.listdir(bundle_dir))}
    print(f"      bundle: {sizes}", flush=True)


def serve(bundle_dir: str, out_dir: str, n: int, seed: int) -> None:
    """Step 3: only ``core.export`` and ``native`` are imported here."""
    import torch

    from ..core.export import draw_inputs, load_bundle

    serve_fn = load_bundle(bundle_dir)
    meta = serve_fn.meta
    os.makedirs(out_dir, exist_ok=True)
    try:
        from ..native import PairWriter
        writer = PairWriter()
    except RuntimeError:
        writer = None
        import cv2
    t0 = time.perf_counter()
    index = batch_index = 0
    gen = torch.Generator(device=serve_fn.device)
    while index < n:
        gen.manual_seed(seed * 2 ** 32 + batch_index)
        imgs, masks = serve_fn(*draw_inputs(meta, gen))
        imgs, masks = imgs.cpu().numpy(), masks.cpu().numpy()
        packed = meta["masks_packed"]
        for i in range(min(meta["batch"], n - index)):
            ip = join(out_dir, f"img_{index:06d}.jpg")
            mp = join(out_dir, f"mask_{index:06d}.png")
            if writer is not None:
                writer.submit(ip, mp, img=imgs[i], mask=masks[i],
                              mask_packed=packed, mask_width=imgs.shape[2])
            else:
                m = np.unpackbits(masks[i], axis=-1) if packed else masks[i]
                cv2.imwrite(ip, imgs[i][:, :, ::-1])
                cv2.imwrite(mp, m)
            index += 1
        batch_index += 1
    if writer is not None:
        writer.finish()
    dt = time.perf_counter() - t0
    models = [m for m in sys.modules
              if m.startswith("gan_segmentation_tpu_torch.models")]
    if models:
        raise RuntimeError(f"the serving process imported model code: "
                           f"{models}")
    print(f"      wrote {index} pairs to {out_dir} ({index / dt:.1f} "
          f"pairs/s on {serve_fn.device.type}, writer="
          f"{'native' if writer is not None else 'cv2'}; no model code "
          f"imported)", flush=True)


def main(argv=None):
    args = parse_args(argv)
    out_dir = join(args.workdir, "served")
    if args.serve is not None:
        serve(args.serve, out_dir, args.n_serve, args.seed)
        return
    bundle_dir = join(args.workdir, "generate.bundle")
    train_and_export(args, bundle_dir)
    print(f"[3/3] serving {args.n_serve} pairs from the bundle in a fresh "
          f"interpreter ...", flush=True)
    subprocess.run([sys.executable, "-m", __spec__.name, "--serve",
                    bundle_dir, "--workdir", args.workdir, "--n-serve",
                    str(args.n_serve), "--seed", str(args.seed)], check=True)


if __name__ == "__main__":
    main()
