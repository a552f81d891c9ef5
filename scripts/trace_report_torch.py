#!/usr/bin/env python3
"""Sum a --profile-dir trace of shark_tpu_torch by kernel, copy and host
thread (the port's counterpart of bench/trace_report.py).

    python3 scripts/trace_report_torch.py PROFILE_DIR [--json]

Reads the newest *.pt.trace.json under PROFILE_DIR (what
`python -m shark_tpu_torch ... --profile-dir PROFILE_DIR` writes) through
shark_tpu_torch/utils/trace.py and prints the card's busy time over the
window from the first kernel to the last, each kernel's total, the copies
by kind (pageable or pinned where the trace says) and memsets, for each
host thread its time in torch operators, in each CUDA runtime call and
outside both, the program's spans (shark::<name>) by thread with their
counts and totals, and the card's idle time in the window by the span the
dispatch thread was in (or outside any span). --json prints the summary
as one JSON line instead.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from shark_tpu_torch.utils import trace  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("profile_dir")
    ap.add_argument("--json", action="store_true",
                    help="print the summary as one JSON line")
    args = ap.parse_args(argv)
    try:
        path = trace.newest_trace(args.profile_dir)
    except FileNotFoundError as e:
        print(e, file=sys.stderr)
        return 1
    s = trace.summarize(path)
    if args.json:
        print(json.dumps(s))
    else:
        print("\n".join(trace.report(s)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
