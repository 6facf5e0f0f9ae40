"""Data layer of the port.

* :mod:`repro_torch.data.pipeline` — the deterministic synthetic LM token
  stream the trainer reads (``DataConfig``, ``SyntheticTokens``);
* :mod:`repro_torch.data.ingest` — offline loaders for real exogenous series
  (ENTSO-E day-ahead prices, PVGIS hourly solar) feeding the scenario DSL.
"""
