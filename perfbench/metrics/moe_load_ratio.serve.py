"""The median over the window's ``moe`` scopes of the most picks on one
expert over the mean picks an expert (``max_load`` / (``picks`` /
``experts``)): 1 is an even load; the dropless path pads every expert's
rows to the call's largest load."""
import statistics

from perfbench.program_spans import window_scopes


def read(record):
    ratios = [sc.attrs["max_load"] * sc.attrs["experts"] / sc.attrs["picks"]
              for sc in window_scopes(record, "moe") or ()]
    return statistics.median(ratios) if ratios else None
