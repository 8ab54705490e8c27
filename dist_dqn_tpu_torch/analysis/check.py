"""One dqnlint check with the verdict contract of JAX's seven
``scripts/check_*.py`` entry points::

    python -m dist_dqn_tpu_torch.analysis.check threads

prints ``check_threads: OK`` (exit 0) or ``check_threads: FAIL`` with
one stderr line per finding (exit 1). The label is ``check_`` plus the
check's name with ``-`` spelled ``_`` (``ckpt-schema`` ->
``check_ckpt_schema``). An unknown name exits 2 with the registered
set.
"""
from __future__ import annotations

import sys


def main(argv=None) -> int:
    from dist_dqn_tpu_torch.analysis.registry import check_names
    from dist_dqn_tpu_torch.analysis.runner import legacy_main

    args = sys.argv[1:] if argv is None else list(argv)
    if len(args) != 1 or args[0] not in check_names():
        print(f"usage: python -m dist_dqn_tpu_torch.analysis.check NAME "
              f"(one of {', '.join(check_names())})", file=sys.stderr)
        return 2
    name = args[0]
    return legacy_main(name, "check_" + name.replace("-", "_"))


if __name__ == "__main__":
    sys.exit(main())
