"""The fused transition's share of its roofline: :func:`chipbench.trace.transition_roofline`."""
from chipbench.trace import transition_roofline as read  # noqa: F401
