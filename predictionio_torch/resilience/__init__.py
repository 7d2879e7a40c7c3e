"""Resilience subsystem: surviving failure, not just observing it.

Copy of ``predictionio_tpu/resilience/``. The port has no REST storage
backend and no metrics pusher yet (ROADMAP.md, queue 1 items 13 and
10): its outbound calls under a policy are the alert webhook and the
fleet's restart backoff. What follows is the JAX package's account.

The obs stack (PRs 2-5) can *see* a wedged backend or a latency
collapse — burn-rate alerts fire, watchdogs dump stacks — but nothing
in the serving or storage path *survives* it. The reference leaned on
Spark task retry and HBase client resilience for that; this package is
the rebuilt substrate, in four parts:

  policy     deadlines, retry budgets with exponential backoff + full
             jitter, and per-target circuit breakers with half-open
             probing — applied to every outbound network call
             (data/backends/rest.py, obs/push.py, the alert webhook)
  admission  load shedding for the engine server: answer 429 +
             Retry-After from queue depth / in-flight / SLO burn-rate
             signals BEFORE latency collapses and the watchdog fires
  chaos      fault injection (env- and admin-driven) at the storage,
             batcher-dispatch and train-step seams — what lets tier-1
             tests prove the breaker opens, shedding engages, and
             degraded mode serves
  alerts     the SLO alert delivery sink: webhook POSTs on burn-rate
             alert transitions, sent through the retry policy

Degraded-mode serving (engine server): a circuit-broken storage
backend flips serving into explicit degraded mode — the last-loaded
model keeps answering, responses carry ``X-PIO-Degraded``, and
``/readyz`` reports DEGRADED (still 200) instead of FAILED.
"""

from predictionio_torch.resilience.policy import (  # noqa: F401
    CircuitBreaker,
    CircuitOpenError,
    Policy,
    RetryBudgetExceeded,
    breaker_for,
)
from predictionio_torch.resilience.chaos import (  # noqa: F401
    ChaosError,
    inject,
)
from predictionio_torch.resilience.admission import (  # noqa: F401
    AdmissionController,
    ShedDecision,
)
