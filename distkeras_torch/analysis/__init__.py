"""``distkeras_torch.analysis`` — the project-aware static-analysis suite
behind ``distkeras-torch-lint``: the port's concurrency and wire contract.

Seven project-specific passes plus the consolidated F401 sweep:

- :mod:`~distkeras_torch.analysis.lock_order` — lock-acquisition graph
  over ``runtime/`` + ``observability/`` checked against the declared
  :mod:`~distkeras_torch.analysis.lock_manifest`;
- :mod:`~distkeras_torch.analysis.blocking` — blocking calls
  (``send*``/``recv*``/``time.sleep``/``Thread.join``/``subprocess``/
  ``.result()``) lexically inside held-lock regions;
- :mod:`~distkeras_torch.analysis.guarded_by` — which lock protects which
  attribute: thread-root discovery, shared-state detection, and
  held-region checking against ``lock_manifest.GUARDED_BY``, and the
  staleness of ``lock_manifest.CONFINED`` (the card client's
  thread-confined state);
- :mod:`~distkeras_torch.analysis.lockset` — Eraser-style DYNAMIC
  validation of the same tables under a stress harness (opt-in,
  ``DKT_LOCKSET=1``; ``chip_smoke.py`` runs it over an async leg on the
  card);
- :mod:`~distkeras_torch.analysis.protocol_model` — the declared
  client<->hub transition table cross-checked against the hub dispatch
  plus bounded exhaustive interleaving/standby model checking;
- :mod:`~distkeras_torch.analysis.wire_parity` — ``ACTION_*`` registry vs
  the char-literal dispatch of the port's C++ hub
  (``distkeras_torch/native/ps_server.cpp``: this pass keeps the port's
  copy in step with its registry), plus NotImplementedError knob
  staleness;
- :mod:`~distkeras_torch.analysis.telemetry` — every metric/span name
  literal checked against
  :mod:`~distkeras_torch.analysis.telemetry_registry`;
- :mod:`~distkeras_torch.analysis.unused_imports` — the one F401
  implementation the per-package test cells delegate to.

``tests/test_torch_analysis.py`` runs the full suite over the port as a
tier-1 gate (plus slow-marked lockset-stress and TSAN cells); the console
script is ``distkeras-torch-lint`` (see :mod:`~distkeras_torch.analysis.cli`,
including ``--baseline`` for incremental adoption).
"""

from distkeras_torch.analysis.core import Finding  # noqa: F401  (re-export)
