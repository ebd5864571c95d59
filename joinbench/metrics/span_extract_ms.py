"""Device ms a query launched inside the program's `tpujoin.extract` span:
materialize's offsets, its total's read, its span check and either
extraction path, after the descriptors."""

from joinbench import program_spans


def read(view):
    return program_spans.device_ms(__file__, view, "tpujoin.extract")
