"""The selection scan's share of its roofline: the mixed adds the GLV-split
stream engine's scan needs for the MSMs of the traced window, against what
the card could multiply in the device seconds of the scan kernel.

The work is counted here, frozen with the benchmark, so that no change to
the program can move it: per MSM ceil(130 / c) windows (the GLV halves are
below 2^130) over 2n lanes (each base and its endomorphism image), one
mixed add of 3,036 32-bit multiplies each (`yardstick.MUL32_PER_MIXED_ADD`),
with n the real bases and c the cell's window bits. The kernel is the
selection instance of the port's scan template, `scan_kernel<false>`
(the complete scan is `scan_kernel<true>`)."""
import yardstick

GLV_BITS = 130
KERNEL = "scan_kernel<false>"


def mul32(n: int, c: int) -> int:
    return -(-GLV_BITS // c) * 2 * n * yardstick.MUL32_PER_MIXED_ADD


def read(view):
    if not any(KERNEL in n for n, _, _ in view.device):
        return None
    seconds = view.device_ms(lambda n: KERNEL in n) / 1e3
    return 100.0 * view.calls * mul32(view.cell.n, view.cell.c) / (seconds * yardstick.PEAK_MUL32_PER_S)
