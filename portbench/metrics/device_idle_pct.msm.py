"""Share of the traced window in which no kernel or copy ran on the card
(the union of the profiler's CUDA intervals, `yardstick.busy_union`)."""


def read(view):
    if not view.device or view.window_ns <= 0:
        return None
    return 100.0 * (1.0 - view.busy_ns / view.window_ns)
