"""Set-up and window of one model family each, found by the ``runner``
that a configuration names. A runner's ``run(cell, seed, seconds,
trace, device)`` returns a ``lib.outcome.Outcome``."""
