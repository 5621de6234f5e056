"""Kernels: device ms an update from each ``count`` phase mark of the program's captured graphs to the
next mark, over the traced epochs' updates: each member's counting once its inputs are formatted (the
``confusion_matrix`` kernel, the stat-score reductions) and its state adds. A program without marks
gives nothing."""
from portbench.layers.format_marked_ms import phase_ms


def read(reading):
    return phase_ms(reading, "count")
