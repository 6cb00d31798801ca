"""Precision-flow verifier of the port's steps (counterpart of
``repro.analysis``).

Three passes over one recorded run of a step
(:class:`~repro_torch.analysis.trace.Trace`) and over the kernels' launch
geometry prove the wire contracts the dist, kernels and core layers promise
each other:

* :mod:`repro_torch.analysis.flow` — taint propagation from the landmarks
  the pipeline declares (:mod:`repro_torch.core.tagging`): fp32 on the
  wire, dequant→requant round trips, wire stats routed to compute
  controllers, stochastic rounding without a generator, bucket coverage,
  guard signals, KV page dtypes;
* :mod:`repro_torch.analysis.trace_audit` — the collectives' payload dtypes
  and bytes per domain, the fp32 residual, the two-leg ratio, the
  zero-fp32-concat pipeline, the paged-KV pool's dtype;
* :mod:`repro_torch.analysis.kernel_checks` — the Hopper kernels' launch
  geometry: entry arity, format-table and shared-memory bounds, vector and
  warp tiling, group-aligned layouts.

``python -m repro_torch.analysis.lint`` runs all three over the config
grid; ``src/repro_torch/analysis/README.md`` is the rule catalogue.
"""

from repro_torch.analysis.report import Report, Violation  # noqa: F401
