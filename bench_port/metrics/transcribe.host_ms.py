"""Host milliseconds per batch in the Transcriber's own host stages: the
walls of the program's transcribe/prepare and transcribe/postprocess
spans, over the profiled batches."""

from bench_port.harness import program as G, readers as R


def read(run):
    recs, units = G.records(run), R.profiled(run)
    if not recs or not units:
        return None
    host = (G.spans(recs, "transcribe/prepare")
            + G.spans(recs, "transcribe/postprocess"))
    return 1e3 * G.wall_s(host) / len(units) if host else None
