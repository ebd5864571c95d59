"""The late aggregate's probe and sum's share of their memory roofline, in
%: sorted R (key, row sum) and sorted S (key, row sum) read once, 8 B a
row, at the card's data-sheet memory rate, over `span_late_probe_ms`. The
least any design of the add-mode probe needs."""

import os

from joinbench import harness


def read(view):
    bench_dir = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    ms = harness._load(bench_dir, "metrics", "span_late_probe_ms").read(view)
    bound = view.bytes_ms(8 * (view.n_r + view.n_s))
    return 100.0 * bound / ms if ms and bound else None
