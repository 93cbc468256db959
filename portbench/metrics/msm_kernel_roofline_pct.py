"""The canonical work of the MSMs completed in the traced window
(`yardstick.canonical_mul32`: W * n mixed adds and 2 * W * 2^c complete adds)
against what the card could multiply in the seconds it was busy."""
import yardstick


def read(view):
    if view.busy_ns <= 0:
        return None
    work = view.calls * yardstick.canonical_mul32(view.cell.n, view.cell.c)
    return 100.0 * work / (view.busy_ns / 1e9 * yardstick.PEAK_MUL32_PER_S)
