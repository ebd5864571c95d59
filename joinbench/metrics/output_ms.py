"""Device ms a query inside `banded_materialize` and outside its sorts and
its descriptors: the extraction of the pairs. Spans added inside the
extraction leave it as it is."""


def read(view):
    return view.span_ms("banded_materialize",
                        outside=("sort_by_key", "banded_match_descriptors")) or None
