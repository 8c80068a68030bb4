"""``python -m repro_torch.analysis`` — the lint CLI (see ``runner``)."""
from repro_torch.analysis.runner import main

raise SystemExit(main())
