"""Process start to the first timed call: CUDA start, the kernels' build or
load, inputs made on the card, the cell's shapes warmed up."""


def read(view):
    return view.setup_s
