"""The fused request -> allocate -> deliver station step (CUDA, sm_90a)."""
