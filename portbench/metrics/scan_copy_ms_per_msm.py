"""Device ms per MSM of everything on the card that is not one of the port's
`curdle::` kernels: the scan's splits, rolls, cats and stacks, the sort,
the fills and the copies."""


def read(view):
    if not any("curdle::" not in n for n, _, _ in view.device):
        return None
    return view.device_ms(lambda n: "curdle::" not in n) / view.calls
