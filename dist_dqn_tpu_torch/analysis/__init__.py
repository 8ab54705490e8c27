"""dqnlint for the port: the static-analysis framework over
``dist_dqn_tpu_torch/`` (twin of ``dist_dqn_tpu/analysis/``).

One substrate (``core``: repo-file discovery, cached AST walks, the
Finding dataclass, rationale-comment parsing), one suppression story
(``baseline``: reasoned entries only, stale entries fail), two
reporters (``report``: text + versioned JSON), one registry
(``registry``: a plugin per file under ``plugins/``) and one runner
(``python -m dist_dqn_tpu_torch.analysis`` -> ``runner.run_checks``).

The eleven checks: eight framework-free ones kept as the JAX package
has them (threads, sockets, wire, ckpt-schema, metrics,
heartbeat-stages, chaos-seams, lock-discipline), and the torch
counterparts of donation, mesh-axis and program_registry, whose JAX
versions police ``jax.jit``/``shard_map`` call sites the port does not
have. Stdlib only: the package imports neither torch nor jax, and
nothing of ``dist_dqn_tpu``; only the wire and ckpt-schema checks import
the port's framework-free ``ingest/codec.py`` and
``utils/ckpt_schema.py``.
"""
from dist_dqn_tpu_torch.analysis.baseline import (  # noqa: F401
    DEFAULT_BASELINE, BaselineError, apply_baseline, load_baseline,
    save_baseline)
from dist_dqn_tpu_torch.analysis.core import (AnalysisContext,  # noqa: F401
                                              Check, Finding, has_rationale)
from dist_dqn_tpu_torch.analysis.registry import (check_names,  # noqa: F401
                                                  discover, get_checks,
                                                  register)
from dist_dqn_tpu_torch.analysis.report import (CheckResult,  # noqa: F401
                                                render_json, render_text)
from dist_dqn_tpu_torch.analysis.runner import (legacy_main,  # noqa: F401
                                                run_checks)
