"""The card's idle share of the traced window, in %: 1 - (union of the
intervals in which it ran a kernel, copy or fill) / the window's wall
time."""


def read(w):
    return 100.0 * (1.0 - w.busy_s() / w.wall_s)
