"""Launches of the radix pair sort's kernels a query: the port's
`radix_pairs.LAUNCHES` entries `radix_*` (one histogram and four passes a
sort, two sorts a query) over its `queries` (`ops/_launches.EVENTS`), in
this process, the two warm-up queries included. None where no launch was
counted: on the CPU the plain version runs, and a program without the
kernel has no such table."""

from joinbench import program_spans


def read(view):
    return program_spans.per_query(
        program_spans.port_table("ops.radix_pairs", "LAUNCHES"),
        "radix_") or None
