"""Bases of all MSMs completed in the window, over the window's host time."""


def read(view):
    return view.calls * view.items_per_call / view.window_s
