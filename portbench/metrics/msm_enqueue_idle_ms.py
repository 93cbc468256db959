"""Milliseconds per MSM that the card is idle while the program's span
`msm.pippenger.windows` is open: the card waiting on the host's Python and
launches while every chunk's device work is enqueued
(`spans.idle_ms_per_call`)."""
import spans


def read(view):
    return spans.idle_ms_per_call(view, "msm.pippenger.windows")
