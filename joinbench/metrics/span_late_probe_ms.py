"""Device ms a query launched inside the program's `tpujoin.probe` and
`tpujoin.reduce` spans together: the late aggregate's per-S probe (its
schedule, windows and kernel 2) and the sum of its per-S counts and sums
after it, however a later program splits the two. None where the trace has
no `tpujoin.reduce` span, as in a program that does not mark the sum: the
probe alone would read as the whole."""

from joinbench import program_spans

SPANS = {"tpujoin.probe", "tpujoin.reduce"}


def read(view):
    program = program_spans.load(program_spans.trace_path(__file__))
    if (program is None or not view.queries
            or not program.spans["tpujoin.reduce"]):
        return None
    us = sum(t for names, t in program.device.items() if names & SPANS)
    return us / 1e3 / view.queries or None
