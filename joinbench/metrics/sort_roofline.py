"""The sorts' share of their memory roofline, in %: each (key, payload) row
of both sides read once and written once, 16 B a row, at the card's
data-sheet memory rate, over the device ms a query in `sort_by_key`."""


def read(view):
    ms = view.span_ms("sort_by_key")
    bound = view.bytes_ms(16 * (view.n_r + view.n_s))
    return 100.0 * bound / ms if ms and bound else None
