"""Device ms of the point kernel (K4, `curdle::point_kernel`) per MSM."""


def read(view):
    if not any("point_kernel" in n for n, _, _ in view.device):
        return None
    return view.device_ms(lambda n: "point_kernel" in n) / view.calls
