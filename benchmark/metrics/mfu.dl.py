"""mfu.dl: the train step's share of one card's TF32 peak (495 TFLOP/s;
the convs run in TF32), %: DeepLabV3+'s model FLOP a sample (every conv's
forward and weight gradient, and the input gradient of every conv whose
input needs one, a multiply-add as 2, counted from the shapes, no
recompute) times rank 0's samples a second of the profiled stretch."""

from gsbench import deeplab


def read(run):
    model = run.cell.config["model"]
    return deeplab.mfu_pct(
        run.stretch,
        deeplab.train_flop_per_sample(model, model["crop_size"]),
        run.counters["samples_per_unit"])
