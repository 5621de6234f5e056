"""Punkt-free English sentence splitter for rougeLsum.

Port of ``metrics_tpu/functional/text/sentence_split.py``: its rules, word
lists and regexes copied unchanged. nltk's trained punkt model splits
rougeLsum inputs where nltk and its ``punkt_tab`` data are installed; this
splitter takes its place elsewhere, with explicit rules instead of learned
statistics:

* a run of sentence-terminal punctuation (``.``, ``!``, ``?``, ellipses),
  optionally followed by closing quotes/brackets, then whitespace, then a
  capital/digit starter (optionally behind opening quotes/brackets) ends
  a sentence;
* a single ``.`` does NOT end a sentence after a known abbreviation
  (punkt's English model learns these; the list below covers the common
  ones), after a single-letter initial (``J. K. Rowling``), or inside a
  number (no whitespace follows, so the boundary regex never fires).

``tests/text/punkt_goldens.json`` holds trained punkt's output on a fixture
corpus; ``tests/test_torch_text_summ.py`` holds this splitter to the JAX
package's on every case.
"""
import re
from typing import List

# common abbreviations the trained punkt English model treats as
# non-terminal (titles, corporate suffixes, months, latinisms, dotted
# acronyms are matched with their internal dots stripped last). Tokens
# that are ALSO ordinary English words ("sat", "mar", weekday forms) are
# deliberately absent: without punkt's statistical context a blanket
# suppression would glue together every sentence ending in that word,
# which skews rougeLsum far more often than an abbreviation use appears
# directly before a capitalized word.
_ABBREVIATIONS = frozenset(
    """
    mr mrs ms dr prof rev fr gen sen rep gov pres hon st jr sr messrs mmes
    co corp inc ltd llc dept univ assn bros est
    vs etc al eg ie cf ca approx ibid
    jan feb apr jun jul aug sep sept oct nov dec
    u.s u.k u.n e.g i.e a.m p.m a.d b.c ph.d b.a m.a m.d d.c u.s.a
    trans
    """.split()
)

# citation-style abbreviations ("No. 44", "Fig. 3", "Vol. 2", "Sec. 7"):
# suppress the break only when a digit follows — sentence-final uses of
# the same spellings ("The answer was no.") must still split
_ABBREVIATIONS_BEFORE_DIGIT = frozenset("no vol fig sec op pp ed eds art ch col".split())

# terminal punctuation + optional closers + whitespace, looking at a
# capital/digit starter (possibly behind openers) — the punkt-style
# orthographic condition for a sentence boundary
_BOUNDARY = re.compile(r"([.!?]+)([\"'”’)\]]*)(\s+)(?=[\"'“‘(\[]*[A-Z0-9])")

_LAST_TOKEN = re.compile(r"(\S+)$")


def _suppresses_break(prev_token: str, digit_follows: bool) -> bool:
    """Would trained punkt treat ``prev_token`` + '.' as non-terminal?"""
    token = prev_token.strip("\"'“”‘’()[]").rstrip(".")
    if not token:
        return False
    if len(token) == 1 and token.isalpha() and token.isupper():
        return True  # single-letter initial
    low = token.lower()
    if low in _ABBREVIATIONS or low.replace(".", "") in _ABBREVIATIONS:
        return True
    return digit_follows and low in _ABBREVIATIONS_BEFORE_DIGIT


def split_sentences(text: str) -> List[str]:
    """Split ``text`` into sentences (punkt-compatible on standard prose)."""
    sentences: List[str] = []
    start = 0
    for match in _BOUNDARY.finditer(text):
        punct = match.group(1)
        if punct == ".":
            before = _LAST_TOKEN.search(text[: match.end(1)])
            next_chunk = text[match.end() :].lstrip("\"'“‘([")
            digit_follows = bool(next_chunk) and next_chunk[0].isdigit()
            if before is not None and _suppresses_break(before.group(1), digit_follows):
                continue
        sentences.append(text[start : match.end(2)])
        start = match.end()
    tail = text[start:]
    if tail.strip():
        sentences.append(tail)
    return [s.strip() for s in sentences if s.strip()]
