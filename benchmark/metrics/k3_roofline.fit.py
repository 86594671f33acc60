"""k3_roofline.fit: kernel 3's share of its roofline, %, in the profiled
stretch (traffic ``trace_epochs`` epochs): Σ over a step's calls (the
forward 3x3 convs inside its contract and every input gradient) of the
call's bound in f32 as 3xTF32 (3 x FLOP at 495 TFLOP/s, or bytes once at
3.35 TB/s), over the device time of its bodies and split-K finish."""

from gsbench import counts, readers


def read(run):
    cfg = run.cell.config
    base = cfg["pyramid"]["base"]
    batch = cfg["solver"]["train_batch_size"]
    calls = counts.kernel3_calls(cfg["decoder"], base, batch)
    bound = counts.kernel3_bound_ms(cfg["decoder"], base, batch,
                                    cfg["precision"])
    return readers.roofline_pct(run.stretch, "k3", bound, len(calls))
