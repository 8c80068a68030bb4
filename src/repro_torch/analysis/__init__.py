"""Static security and schedule linter over the port's traced programs.

The counterpart of ``repro.analysis``.  The passes:

* :mod:`repro_torch.analysis.walkers` — node walkers: host transfers,
  party-axis boundaries, the ``repro_torch.vfl_grad`` census, a target
  histogram;
* :mod:`repro_torch.analysis.taint` — leakage taint: every party-private
  value crossing a party boundary carries a per-party mask draw, and
  (membership entries) no draw serves two aggregations;
* :mod:`repro_torch.analysis.schedule` — the ring-buffer staleness proof
  and the storage-identity check of chained epochs;
* :mod:`repro_torch.analysis.volume` — bytes a party sends through the
  boundaries of one step.

``python -m repro_torch.analysis`` lints the whole entry-point matrix
against the committed manifest ``analysis/INVARIANTS_torch.json``; see
:mod:`repro_torch.analysis.runner`.  This ``__init__`` imports the passes
only: the entry-point registry imports the engines.
"""
from repro_torch.analysis.schedule import (RingAudit,  # noqa: F401
                                           StorageAudit, ring_audit,
                                           storage_audit)
from repro_torch.analysis.taint import (EQUAL_SEEDED,  # noqa: F401
                                        MASK_REUSED, UNMASKED,
                                        TaintFinding, analyze_program,
                                        boundaries, finding_codes)
from repro_torch.analysis.walkers import (HOST_TRANSFER_OPS,  # noqa: F401
                                          VFL_GRAD_OP, count_cross_party,
                                          count_host_transfers, count_op,
                                          target_histogram, vfl_grad_census)
