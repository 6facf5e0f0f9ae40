"""Data layer of the port: real-data ingest.

* :mod:`repro_torch.data.ingest` — offline loaders for real exogenous series
  (ENTSO-E day-ahead prices, PVGIS hourly solar) feeding the scenario DSL.
"""
