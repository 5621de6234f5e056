"""The published memory rate of one NVIDIA H100 SXM (80 GB HBM3), NVIDIA's data sheet.

It assumes the card's full 700 W power limit; a run prints the card's name beside its numbers.
"""
HBM_BYTES_PER_S = 3.35e12


def least_seconds(nbytes: float) -> float:
    """The least time the card could take to move ``nbytes`` once."""
    return nbytes / HBM_BYTES_PER_S
