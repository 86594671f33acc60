"""mfu.gen: the whole batch's share of the card's bf16 peak (989 TFLOP/s),
%: the configuration's model FLOP a pair (every conv, transposed conv,
blur and dense layer of the generator and the decoder, a multiply-add as
2, counted from its shapes) times the pairs a second of the profiled
stretch (traffic ``trace_batches``)."""

from gsbench import counts, readers


def read(run):
    cfg = run.cell.config
    return readers.mfu_pct(run.stretch, counts.generate_flop_per_sample(cfg),
                           run.counters["samples_per_unit"],
                           cfg["precision"])
