"""Rounds the banded probe's schedule walked a query: the port's
`probe_rounds` over its `queries` (`ops/_launches.EVENTS`), in this
process. The count includes the two warm-up queries, which run on the same
two input pairs that the window alternates, so the mean moves by less than
1/(n + 2) of the difference between the two pairs."""

from joinbench import program_spans


def read(view):
    return program_spans.per_query(
        program_spans.port_table("ops._launches", "EVENTS"), "probe_rounds")
