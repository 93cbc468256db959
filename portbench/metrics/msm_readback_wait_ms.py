"""Host milliseconds per MSM inside the program's span `msm.readback`: the
host waiting for the card's queue to drain, then the copy home. Near 0 means
the host paced the call; large means the card did (`spans.host_ms_per_call`)."""
import spans


def read(view):
    return spans.host_ms_per_call(view, "msm.readback")
