"""enqueue_ms.gen: host ms per batch inside ``FusedPipeline._enqueue`` (the
batch's inputs drawn, the graph replayed, the copies to pinned memory
enqueued), the mean over the traced run's window outside its profiled
stretch; the benchmark's span around the call."""


def read(run):
    spans = run.spans.get("enqueue")
    return 1e3 * sum(spans) / len(spans) if spans else None
