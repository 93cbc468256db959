"""Per call, from the end of its last device event to its return on the
host (the readback's wait, `_combine_packed`, `jpoints_to_host`), as a mean
over the calls of the traced window."""


def read(view):
    if not view.host_tail_ns:
        return None
    return sum(view.host_tail_ns) / len(view.host_tail_ns) / 1e6
