"""Launches of the banded probe's windowed kernels a query: the port's
`band_compare.LAUNCHES` entries `banded_window_*` over its `queries`
(`ops/_launches.EVENTS`), in this process. The count includes the two
warm-up queries, which run on the same two input pairs that the window
alternates, so the mean moves by less than 1/(n + 2) of the difference
between the two pairs. None where no launch was counted: on the CPU the
kernels' plain versions run."""

from joinbench import program_spans


def read(view):
    return program_spans.per_query(
        program_spans.port_table("ops.band_compare", "LAUNCHES"),
        "banded_window_") or None
