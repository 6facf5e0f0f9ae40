"""The paper's results on the port: one module per figure or claim of the
JAX package's ``benchmarks/`` (``grid``, ``v2g``, ``ppo_shopping`` for Fig.
4a, ``satisfaction_sweep`` for Fig. 4b/c, ``price_shift`` for Fig. 5).

Each module's ``run(quick=True, ..., device=None)`` returns the JAX module's
``(name, value, derived)`` rows and leaves a ``LAST_SUMMARY`` dict stating
each claim of its docstring as a boolean.  Every env is built with
``EnvConfig(fused_step=True)``, so every figure steps through
``chargax_step``; the budgets are the JAX module's, as module constants.

    python -m repro_torch.bench.run --only grid,v2g,ppo,satisfaction,shift [--full] [--device cpu]
"""
