"""Device-idle ms a query in the gaps that fall while the host is inside
the program's `tpujoin.probe` span (its read-back in `tpujoin.sync`
included): the probe's host loop as the card sees it."""

from joinbench import program_spans


def read(view):
    return program_spans.idle_ms(__file__, view, "tpujoin.probe")
