"""The device's idle share in the traced window: :func:`chipbench.trace.idle_share`."""
from chipbench.trace import idle_share as read  # noqa: F401
