"""Launches of the column-sum kernel a query: the port's
`row_colsums.LAUNCHES["row_colsums"]` (one a side of a late aggregate with
columns) over its `queries` (`ops/_launches.EVENTS`), in this process, the
two warm-up queries included. None where no launch was counted: on the CPU
the plain version runs, and a program without the kernel has no such
table."""

from joinbench import program_spans


def read(view):
    return program_spans.per_query(
        program_spans.port_table("ops.row_colsums", "LAUNCHES"),
        "row_colsums") or None
