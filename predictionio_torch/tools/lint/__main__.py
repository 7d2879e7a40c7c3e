"""``python -m predictionio_torch.tools.lint`` entry point.

Per-file rules (JT01-JT17) by default; ``--project`` adds the
whole-program concurrency pass (JT18-JT21) over the same parse.
``bin/lint`` wraps this with ``--project`` preset — the CI gate."""

import sys

from predictionio_torch.tools.lint.engine import main

if __name__ == "__main__":
    sys.exit(main())
