"""Launches of the extraction kernel a query: the port's
`extract_pairs.LAUNCHES["extract_pairs"]` (one a materialize on the card)
over its `queries` (`ops/_launches.EVENTS`), in this process, the two
warm-up queries included. None where no launch was counted: on the CPU the
plain version runs, and a program without the kernel has no such table."""

from joinbench import program_spans


def read(view):
    return program_spans.per_query(
        program_spans.port_table("ops.extract_pairs", "LAUNCHES"),
        "extract_pairs") or None
