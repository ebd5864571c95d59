"""Device ms a query launched inside the program's `tpujoin.colsums` spans:
a late aggregate's extra columns summed per row on both sides and gathered
at the row ids."""

from joinbench import program_spans


def read(view):
    return program_spans.device_ms(__file__, view, "tpujoin.colsums")
