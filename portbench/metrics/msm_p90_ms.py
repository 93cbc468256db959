"""The 90th percentile of the host latency of every call in the window."""


def read(view):
    return view.quantile(view.latencies_s, 0.9) * 1e3
