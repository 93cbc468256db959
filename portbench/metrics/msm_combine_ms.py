"""Host milliseconds per MSM inside the program's span `msm.combine`: the
points made host G1 and the windows combined in Python, the card idle
(`spans.host_ms_per_call`)."""
import spans


def read(view):
    return spans.host_ms_per_call(view, "msm.combine")
