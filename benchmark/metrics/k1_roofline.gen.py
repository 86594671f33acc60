"""k1_roofline.gen: kernel 1's share of its roofline, %, in the profiled
stretch (traffic ``trace_batches``): Σ over its calls (the conv_2 of every
synthesis block, bf16) of the call's bound (bytes once at 3.35 TB/s, FLOP
at 989 TFLOP/s), over the device time of its bodies and split-K finish."""

from gsbench import counts, readers


def read(run):
    cfg, tr = run.cell.config, run.cell.traffic
    calls = counts.kernel1_calls(cfg["gan"], tr["batch"])
    bound = counts.kernel1_bound_ms(cfg["gan"], tr["batch"],
                                    cfg["precision"])
    return readers.roofline_pct(run.stretch, "k1", bound, len(calls))
