"""Device ms a query launched inside the program's `tpujoin.sort` spans:
both sides' sorts, their payload gathers included."""

from joinbench import program_spans


def read(view):
    return program_spans.device_ms(__file__, view, "tpujoin.sort")
