"""Operation and byte counts of the measured work, from shapes alone.

Each count is of what the computation needs, whatever implements it: each
input byte read once, each output byte written once, and the
floating-point operations of the algorithm.  `peaks` holds the chip's
published peaks that the shares are taken against.
"""
