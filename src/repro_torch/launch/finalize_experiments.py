"""Fill the dry-run and roofline tables into a markdown file, in place of
its ``<!-- DRYRUN_TABLE -->`` and ``<!-- ROOFLINE_TABLE -->`` markers.

    PYTHONPATH=src python -m repro_torch.launch.finalize_experiments --path FILE [--out DIR]

Counterpart of ``repro.launch.finalize_experiments``, whose target file
(the reference's ``EXPERIMENTS.md``) is named by ``--path`` here.
"""

from __future__ import annotations

import argparse
import sys
from typing import List, Optional

from repro_torch.launch.dryrun import RESULTS_DIR
from repro_torch.launch.report import fmt_dryrun_table, fmt_roofline_table, load

DRYRUN_MARKER = "<!-- DRYRUN_TABLE -->"
ROOFLINE_MARKER = "<!-- ROOFLINE_TABLE -->"


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--path", required=True)
    ap.add_argument("--out", default=RESULTS_DIR)
    args = ap.parse_args(argv)
    with open(args.path) as f:
        text = f.read()
    rows = load(args.out)
    dry = ("### One H100 — per-card dry run\n\n" + fmt_dryrun_table(rows))
    text = text.replace(DRYRUN_MARKER, dry).replace(ROOFLINE_MARKER, fmt_roofline_table(rows))
    with open(args.path, "w") as f:
        f.write(text)
    print(f"{args.path} updated")
    return 0


if __name__ == "__main__":
    sys.exit(main())
