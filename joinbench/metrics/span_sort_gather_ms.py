"""Device ms a query launched inside the program's `tpujoin.sort.gather`
spans: the payload gathers of both sides' sorts (`sort_impl="lax"`)."""

from joinbench import program_spans


def read(view):
    return program_spans.device_ms(__file__, view, "tpujoin.sort.gather")
