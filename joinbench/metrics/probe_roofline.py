"""The probe's share of its memory roofline, in %: sorted R and S read once,
8 B a row (key and payload), at the card's data-sheet memory rate, over the
device ms a query in the `banded_probe` spans. The same work whatever
implements the probe."""


def read(view):
    ms = view.span_ms("banded_probe")
    bound = view.bytes_ms(8 * (view.n_r + view.n_s))
    return 100.0 * bound / ms if ms and bound else None
