"""Metric family names of the port (twin of the serving part of
``dist_dqn_tpu/telemetry/collectors.py``).

Only the families the serving tier records are here; the learner, replay,
transport, watchdog and device-time families arrive with the rest of the
telemetry (ROADMAP.md A10). Each name is the JAX package's text, so a
``/metrics`` scrape of either package reads the same series.
"""
from __future__ import annotations

# Serving tier (dist_dqn_tpu_torch/serving/). REQUESTS/LATENCY are per
# accepted request (LATENCY spans admission -> response split, the
# client-visible service time minus transport); BATCH_FANIN observes real
# (unpadded) ROWS per dispatched act program, a count histogram with
# FANIN_BUCKETS; SHED counts admissions refused by the bounded queue (HTTP
# 429 + retry-after); RELOADS/POLICY_VERSION track the ModelStore's
# checkpoint hot-reload per {policy}; SLO_BREACHES counts /healthz flips
# per {slo="p99_latency"|"queue_depth"}.
SERVING_REQUESTS = "dqn_serving_requests_total"
SERVING_SHED = "dqn_serving_shed_total"
SERVING_QUEUE_DEPTH = "dqn_serving_queue_depth"
SERVING_LATENCY = "dqn_serving_latency_seconds"
SERVING_BATCH_FANIN = "dqn_serving_batch_fanin_rows"
SERVING_DISPATCHES = "dqn_serving_dispatches_total"
SERVING_RELOADS = "dqn_serving_reloads_total"
SERVING_POLICY_VERSION = "dqn_serving_policy_version"
SERVING_SLO_BREACHES = "dqn_serving_slo_breaches_total"

#: Fan-in histogram buckets: powers of two from a single row up to the
#: largest plausible burst.
FANIN_BUCKETS = (1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0, 128.0, 256.0,
                 512.0, 1024.0, 2048.0, 4096.0, 8192.0)
