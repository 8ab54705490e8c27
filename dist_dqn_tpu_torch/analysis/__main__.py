"""dqnlint over the port: the one runner for every static check (twin of
``scripts/dqnlint.py``)::

    python -m dist_dqn_tpu_torch.analysis --all          # human report
    python -m dist_dqn_tpu_torch.analysis --all --json   # CI artifact
    python -m dist_dqn_tpu_torch.analysis --check threads --check mesh-axis
    python -m dist_dqn_tpu_torch.analysis --list         # registered checks

Exit code 0 iff no unsuppressed findings (baselined findings and their
reasons are reported, never silently dropped; a STALE baseline entry is
itself a failure), 1 on findings, 2 on an invalid baseline or an
unknown check. Suppression surfaces, in triage order: fix the code; own
it with the check's rationale comment at the site (``# lock:`` /
``# donation:`` / ``# socket:`` / ``# mesh-axis:`` / ``# devtime:``); or
add a reasoned entry to ``dist_dqn_tpu_torch/analysis/
dqnlint_baseline.json``. ``python -m dist_dqn_tpu_torch.analysis.check
<name>`` runs one check with the verdict line of JAX's
``scripts/check_*.py``.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]


def main(argv=None) -> int:
    from dist_dqn_tpu_torch.analysis import (BaselineError, get_checks,
                                             render_json, render_text,
                                             run_checks)

    parser = argparse.ArgumentParser(
        prog="dqnlint", description="unified static analysis runner")
    parser.add_argument("--all", action="store_true",
                        help="run every registered check (default when "
                             "no --check is given)")
    parser.add_argument("--check", action="append", default=[],
                        metavar="NAME",
                        help="run one named check (repeatable)")
    parser.add_argument("--json", action="store_true",
                        help="emit the machine-readable findings "
                             "artifact on stdout instead of the human "
                             "report")
    parser.add_argument("--list", action="store_true",
                        help="list registered checks and exit")
    parser.add_argument("--baseline", metavar="PATH", default=None,
                        help="baseline file (default: "
                             "dist_dqn_tpu_torch/analysis/"
                             "dqnlint_baseline.json)")
    parser.add_argument("--root", metavar="DIR", default=str(REPO),
                        help="repo root to analyze (default: this repo)")
    parser.add_argument("--verbose", action="store_true",
                        help="also report baselined findings with their "
                             "reasons")
    args = parser.parse_args(argv)

    if args.list:
        for check in get_checks():
            tag = f"  [suppress: '# {check.rationale_tag} <reason>']" \
                if check.rationale_tag else ""
            print(f"{check.name}: {check.description}{tag}")
        return 0

    names = args.check or None
    if args.all:
        names = None
    try:
        results = run_checks(
            Path(args.root), names=names,
            baseline_path=Path(args.baseline) if args.baseline else None)
    except BaselineError as e:
        print(f"dqnlint: invalid baseline — {e}", file=sys.stderr)
        return 2
    except KeyError as e:
        print(f"dqnlint: {e.args[0]}", file=sys.stderr)
        return 2

    ok = all(r.ok for r in results)
    if args.json:
        print(json.dumps(render_json(results), indent=1, sort_keys=True))
    else:
        out = render_text(results, verbose=args.verbose)
        print(out, file=sys.stdout if ok else sys.stderr)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
