"""Milliseconds per MSM that the card is idle while the program's span
`msm.stream.host_prep` is open: the stream engine's host prep (the pad, the
GLV split, the digits, the counting sort, the boundary ranks and the
selection schedule) before any of the call's work is queued
(`spans.idle_ms_per_call`)."""
import spans


def read(view):
    return spans.idle_ms_per_call(view, "msm.stream.host_prep")
