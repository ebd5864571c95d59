"""Device ms a query inside the banded probe's spans: `banded_probe` (the
aggregate) and `banded_match_descriptors` (materialize's counting), each
with its `block_windows`."""


def read(view):
    return view.span_ms("banded_probe", "banded_match_descriptors") or None
