"""``python -m nns`` runs the benchmark harness (the ./main analog)."""

import sys

from nns.harness import main

sys.exit(main())
