"""Share of the traced window in which no device operation ran."""


def read(view):
    if view.busy_s <= 0 or view.window_s <= 0:
        return None
    return 1.0 - view.busy_s / view.window_s
