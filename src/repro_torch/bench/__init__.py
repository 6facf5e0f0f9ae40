"""The JAX package's benchmark harness on the port: one module per table,
figure or claim of ``benchmarks/`` (``speed_table`` for Table 2 / Fig. 1
against the pure-Python env of ``python_ref_env``, ``ppo_shopping`` for
Fig. 4a, ``satisfaction_sweep`` for Fig. 4b/c, ``price_shift`` for Fig. 5,
``fleet_throughput``, ``fleet_sharded``, ``v2g``, ``grid``, ``serve`` and
``roofline_report``).

Each module's ``run(quick=True, ..., device=None)`` returns the JAX module's
``(name, value, derived)`` rows and leaves a ``LAST_SUMMARY`` dict (the
figures' claims as booleans).  Every env is built with
``EnvConfig(fused_step=True)`` but the staged side of ``speed``'s fused
comparison, so every table and figure steps through ``chargax_step``; the
budgets are the JAX module's, as module constants.

    python -m repro_torch.bench.run [--only speed,ppo,...] [--full] [--device cpu] [--list]
"""
