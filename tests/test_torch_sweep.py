"""The sweep's source edits (chip_sweep.py): each pattern of
TRACE_EDITS and BLOOM_EDITS matches exactly once in the shipped csrc/ file,
so a later edit of those lines fails here and not on the card."""

import re

import pytest

import chip_sweep as sweep

EDITS = [("trace.cu", e) for e in sweep.TRACE_EDITS] + [("bloom.cu", e) for e in sweep.BLOOM_EDITS]


@pytest.mark.parametrize("source, edit", EDITS, ids=[f"{s}: {e[0]}" for s, e in EDITS])
def test_edit_matches_once(source, edit):
    label, pattern, replacement = edit
    text = sweep.edited_source(source, pattern, replacement)
    assert text.count(replacement) >= 1 and not re.search(pattern, text.replace(replacement, ""))


def test_edit_that_misses_raises():
    with pytest.raises(RuntimeError, match="0 times, not once"):
        sweep.edited_source("bloom.cu", re.escape("constexpr int kNoSuchConstant = 1;"), "")
