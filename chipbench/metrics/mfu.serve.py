"""The whole step's model-FLOP share of the fp32 peak: :func:`chipbench.trace.mfu`."""
from chipbench.trace import mfu as read  # noqa: F401
