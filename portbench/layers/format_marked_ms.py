"""Input formatting: device ms an update from each ``format`` phase mark of the program's captured
graphs to the next mark, over the traced epochs' updates: each member's formatting of the batch,
split off by the program itself. A mark is a no-op kernel named ``phase_mark_<phase>``; a captured
graph replays in order, so a phase's time runs from the end of its mark to the start of the next one.
A program without marks gives nothing."""

PREFIX = "phase_mark_"


def phase_of(name):
    """The phase a device operation marks, or None. The profiler gives a kernel's demangled signature,
    its namespace in front (``(anonymous namespace)::phase_mark_format()``)."""
    bare = name.replace("(anonymous namespace)::", "")
    bare = bare[5:] if bare.startswith("void ") else bare
    symbol = bare.split("(", 1)[0].split("<", 1)[0].rsplit("::", 1)[-1]
    return symbol[len(PREFIX):] if symbol.startswith(PREFIX) else None


def phase_ms(reading, phase):
    """Device ms an update from each ``phase`` mark's end to the next mark's start, or None."""
    if not reading.updates:
        return None
    marks = sorted((a, b, phase_of(name)) for name, a, b in reading.ops if phase_of(name))
    if not any(p == phase for _, _, p in marks):
        return None
    us = sum(nxt[0] - end for (_, end, p), nxt in zip(marks, marks[1:]) if p == phase)
    return us / 1e3 / reading.updates


def read(reading):
    return phase_ms(reading, "format")
