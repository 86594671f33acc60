"""k2_roofline.gen: kernel 2's share of its roofline, %, in the profiled
stretch (traffic ``trace_batches``): Σ over its calls (every 3x3 conv of
the eval decoder, BN folded, bf16) of the call's bound, over the device
time of its bodies and split-K finish."""

from gsbench import counts, readers


def read(run):
    cfg, tr = run.cell.config, run.cell.traffic
    base = cfg["gan"]["base"]
    calls = counts.kernel2_calls(cfg["decoder"], base, tr["batch"])
    bound = counts.kernel2_bound_ms(cfg["decoder"], base, tr["batch"],
                                    cfg["precision"])
    return readers.roofline_pct(run.stretch, "k2", bound, len(calls))
