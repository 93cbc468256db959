"""Milliseconds per MSM that the card is idle while the program's span
`msm.stream.device` is open: the card waiting on the host's uploads,
Python and launches while the stream engine's records, gathers, scans and
reduce are enqueued (`spans.idle_ms_per_call`)."""
import spans


def read(view):
    return spans.idle_ms_per_call(view, "msm.stream.device")
