"""Milliseconds per MSM that the card is idle while the program's span
`msm.pippenger.prep` is open: the pad, the digits and the records enqueued
at the start of a call (`spans.idle_ms_per_call`)."""
import spans


def read(view):
    return spans.idle_ms_per_call(view, "msm.pippenger.prep")
