"""One step's arrival draws for a batch of envs in one launch (CUDA, sm_90a)."""
