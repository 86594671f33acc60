"""mfu.fit: the whole train step's share of the card's f32 peak as 3xTF32
(495 / 3 TFLOP/s), %: the decoder's model FLOP a sample (every conv's
forward and weight gradient, and the input gradient of every conv whose
input needs one, a multiply-add as 2, counted from its shapes, no
recompute) times the samples a second of the profiled stretch (traffic
``trace_epochs`` epochs)."""

from gsbench import counts, readers


def read(run):
    cfg = run.cell.config
    return readers.mfu_pct(run.stretch, counts.train_flop_per_sample(cfg),
                           run.counters["samples_per_unit"],
                           cfg["precision"])
