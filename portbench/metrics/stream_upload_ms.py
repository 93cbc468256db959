"""Host milliseconds per MSM inside the program's span `msm.stream.upload`:
the stream engine's host-to-card copies of the GLV sign row and of each
chunk's index tables (`spans.host_ms_per_call`). The copies are from
pageable memory, so the host waits for each: the span holds the transfers."""
import spans


def read(view):
    return spans.host_ms_per_call(view, "msm.stream.upload")
