"""Device ms a query launched inside the program's `tpujoin.probe` spans:
the banded probe's schedule, its windows (`tpujoin.windows`), its read-back
and its round loop."""

from joinbench import program_spans


def read(view):
    return program_spans.device_ms(__file__, view, "tpujoin.probe")
