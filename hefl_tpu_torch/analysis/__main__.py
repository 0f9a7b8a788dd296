"""`python -m hefl_tpu_torch.analysis`: the port's `hefl-lint` gate."""

from hefl_tpu_torch.analysis.cli import main

raise SystemExit(main())
