"""Device ms a query inside the `sort_by_key` spans: both sides' sorts."""


def read(view):
    return view.span_ms("sort_by_key") or None
