"""Regenerate the roofline table in ``PERF.md`` from the port's dry-run
records: the twin of ``benchmarks/embed_tables.py``, whose target
(``EXPERIMENTS.md``) this repository does not have.  The block between
the reference's markers, ``### Final roofline table`` and ``Reading the
table:``, is rewritten with ``roofline_torch.table("single")``.  Where
either marker is missing it raises (the reference's ``re.sub`` would
write the file back unchanged).

    PYTHONPATH=src python benchmarks/embed_tables_torch.py
"""

from __future__ import annotations

import os
import re
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from roofline_torch import table  # noqa: E402

MARK_A = "### Final roofline table"
MARK_B = "Reading the table:"
TARGET = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                      "PERF.md")
PATTERN = re.compile(re.escape(MARK_A) + r".*?" + re.escape(MARK_B),
                     re.DOTALL)


def embed(path: str = TARGET) -> str:
    """Rewrite the block between the markers in ``path`` with the
    single-pod mesh's table; returns the table."""
    tbl = table("single")
    with open(path) as f:
        text = f.read()
    if not PATTERN.search(text):
        raise ValueError(f"{path}: no block between {MARK_A!r} and "
                         f"{MARK_B!r} to rewrite")
    block = (f"{MARK_A}\n\n(regenerate: `PYTHONPATH=src python "
             f"benchmarks/embed_tables_torch.py`)\n\n```\n{tbl}\n```\n\n")
    text = PATTERN.sub(lambda _: block + MARK_B, text, count=1)
    with open(path, "w") as f:
        f.write(text)
    return tbl


def main() -> None:
    print(embed())


if __name__ == "__main__":
    main()
